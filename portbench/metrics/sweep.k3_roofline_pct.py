"""``sweep.k3_roofline_pct``: the monopole sweep (``grouped_sweep_kernel``
of ``csrc/grouped_sweep.cu``) in the traced window, its least time over its
traced time, in %. The least time is the pairs that the reference's plan of
each traced step gives its live targets from its live columns
(``reference.batch_work``), at the law's FP32 operations and MUFU per pair
(``roofline.law_ops("sweep", rcp)``), over the published FP32 rate, or the
MUFU rate or the bytes where those bound it."""

from portbench.lib import reference, roofline

KERNELS = ("grouped_sweep_kernel",)


def read(ctx):
    t = ctx["trace"].device_s(*KERNELS)
    if t <= 0 or not ctx.get("steps"):
        return None
    work = ctx["work"]()
    rcp = ctx["sim"].get("rcp") or (
        "approx" if reference.resolve_bh(ctx["sim"]).theta >= 2 else "newton")
    least = sum(roofline.least_s("sweep", rcp, pairs,
                                 roofline.sweep_bytes(cols, tgts, False))[0]
                for pairs, cols, tgts in work)
    return 100.0 * least / t
