"""``sweep.k4_roofline_pct``: the quadrupole sweep (``quad_sweep_kernel``
and its fixed-order ``quad_fold``) in the traced window, its least time over
its traced time, in %. The least time is the pairs that the reference's
plan of each traced step gives its live targets from its live columns (a
nonzero mass or second moment), at the quadrupole law's FP32 operations and
MUFU per pair (``roofline.law_ops("quad", "newton")``), over the published
FP32 rate, or the MUFU rate or the bytes where those bound it."""

from portbench.lib import roofline

KERNELS = ("quad_sweep_kernel", "quad_fold")


def read(ctx):
    t = ctx["trace"].device_s(*KERNELS)
    if t <= 0 or not ctx.get("steps"):
        return None
    rcp = ctx["sim"].get("rcp") or "newton"
    least = sum(roofline.least_s("quad", rcp, pairs,
                                 roofline.sweep_bytes(cols, tgts, True))[0]
                for pairs, cols, tgts in ctx["work"]())
    return 100.0 * least / t
