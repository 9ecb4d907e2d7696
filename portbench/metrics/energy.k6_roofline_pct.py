"""``energy.k6_roofline_pct``: the potential kernel K6 of
``csrc/allpairs.cu`` (``potential_kernel`` and its fold
``potential_fold``) in the traced window, its least time over its traced
time, in %. The least time is the pairs each energy sample in the window
needs, n²/2 over the n live rows (U = Σ over pairs i < j; K6 sums every
target against every source, so it does twice that work), at the
potential's FP32 operations and MUFU per pair
(``roofline.law_ops("pot", ...)``), over the published FP32 rate, or the
MUFU rate or the bytes (each row read once, its potential written once)
where those bound it."""

from portbench.lib import roofline

KERNELS = ("potential_kernel", "potential_fold")


def read(ctx):
    t = ctx["trace"].device_s(*KERNELS)
    if t <= 0 or not ctx.get("samples"):
        return None
    n = ctx["n"]
    least = roofline.least_s("pot", "newton", n * n / 2.0, 16.0 * n)[0]
    return 100.0 * ctx["samples"] * least / t
