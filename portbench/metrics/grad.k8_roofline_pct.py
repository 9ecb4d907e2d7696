"""``grad.k8_roofline_pct``: the backward sweeps (``grouped_bwd_tgt``, K8a,
and ``grouped_bwd_src``, K8b, of ``csrc/force_grad.cu``) in the traced
window, their least time over their traced time, in %. The least time is
chip_smoke's count of their work: G·S·C pairs a launch for the plan shape
of the call's rows (``roofline.k8_shape``), at the backward law's FP32
operations and MUFU per pair, over the published FP32 rate, or the bytes
where they bound it."""

from portbench.lib import roofline

TGT, SRC = "grouped_bwd_tgt", "grouped_bwd_src"


def read(ctx):
    tr = ctx["trace"]
    t = tr.device_s(TGT, SRC)
    if t <= 0 or not ctx.get("calls"):
        return None
    sim = ctx["sim"]
    g, s, c = roofline.k8_shape(ctx["n"], int(sim.get("leaf_size", 64)),
                                frontier_cap=32, leaf_cap=16)
    return 100.0 * roofline.k8_least_s(g, s, c, tr.count(TGT),
                                       tr.count(SRC)) / t
