"""``step.device_ops``: device operations (kernels, copies, sets) in the
traced window over the steps traced, from the torch.profiler trace."""


def read(ctx):
    if not ctx.get("steps") or not ctx["trace"].device:
        return None
    return ctx["trace"].count() / ctx["steps"]
