"""``grad.device_ops``: device operations in the traced window over the
value+grad calls traced."""


def read(ctx):
    if not ctx.get("calls") or not ctx["trace"].device:
        return None
    return ctx["trace"].count() / ctx["calls"]
