"""``allpairs.k2_roofline_pct``: the symmetric all-pairs kernel K2 of
``csrc/allpairs.cu`` (its round kernel ``allpairs_sym_rounds``, ``sym_fold``
and ``sym_finish``) in the traced window, its least time over its traced
time, in %. The least time is the pairs the law needs each traced step,
n²/2 over the n live rows (the kernel table of PERF.md counts K2 so, at the
padded N), at the symmetric law's FP32 operations and MUFU per pair
(``roofline.law_ops("sym", rcp)``), over the published FP32 rate, or the
MUFU rate or the bytes (each row's position and mass read and its
acceleration written once) where those bound it."""

from portbench.lib import roofline

KERNELS = ("allpairs_sym_rounds", "sym_fold", "sym_finish")


def read(ctx):
    t = ctx["trace"].device_s(*KERNELS)
    if t <= 0 or not ctx.get("steps"):
        return None
    n = ctx["n"]
    rcp = ctx["sim"].get("rcp") or "newton"
    least = roofline.least_s("sym", rcp, n * n / 2.0, 20.0 * n)[0]
    return 100.0 * ctx["steps"] * least / t
