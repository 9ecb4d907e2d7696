"""``step.device_ms``: device time in the traced window, each device event
counted once, over the steps traced."""


def read(ctx):
    if not ctx.get("steps") or not ctx["trace"].device:
        return None
    return ctx["trace"].device_s() * 1e3 / ctx["steps"]
