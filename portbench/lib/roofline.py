"""Peaks of the card and the work a kernel's inputs need.

``law_ops`` and ``law_mufu`` are frozen copies of ``chip_smoke.py``'s at
commit c4ece55 (the FP32 operations and MUFU operations per pair of each
form of the pair law in ``csrc/pair_law.cuh``), and ``k8_shape`` gives the
(G, S, C) of the monopole plan whose pairs chip_smoke counts for the
backward sweeps K8a and K8b. A later change to the program moves none of
them.

Peaks, NVIDIA H100 SXM data sheet (dense, no sparsity): 67 TFLOP/s in FP32
outside the tensor cores, where an FMA counts as two FLOP, and 3.35 TB/s of
HBM3. The pair law's operations are not contracted into FMAs (each multiply,
add, compare and select issues on its own), so each takes one FP32 issue
slot, and the published rate gives 67e12 / 2 of them a second. The MUFU
rate (reciprocals, rsqrt) is not in the data sheet: 16 results per SM and
clock (CUDA C++ Programming Guide, arithmetic instruction throughput for
compute capability 9.0) × 132 SMs × the 1980 MHz boost clock is derived,
not published.
"""

from __future__ import annotations

FP32_FLOP_PER_S = 67e12
FP32_OPS_PER_S = FP32_FLOP_PER_S / 2
MUFU_PER_S = 16 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def law_ops(form: str, rcp: str) -> int:
    """FP32 operations per pair that the pair law needs besides its MUFU
    operations: "sweep", a pair of K3 (where the tile's coordinate bound
    holds, as on every input here); "quad", a pair of K4; "grad_i" and
    "grad_j", a pair of the target-side (K8a) and source-side (K8b)
    backward, always newton. Sums into the accumulators count; loads and
    loop control do not."""
    base, _, guard = rcp.partition("+")
    if form in ("grad_i", "grad_j"):
        return 43 if form == "grad_i" else 45
    if form == "quad":
        return 91 + {"newton": 6, "approx": 0}[base]
    ops = 8
    if form == "pot":
        return ops + 2
    ops += {"newton": 3, "approx": 0}[base]
    if form == "sweep":
        return ops + 1 + 5
    ops += 1 if guard == "clamp" else 3
    return ops + (5 if form == "mono" else 10)


def law_mufu(form: str) -> int:
    """MUFU operations per pair: K4 takes 1/|d|₁ and 1/d² apart, the
    others one reciprocal."""
    return 2 if form == "quad" else 1


def least_s(form: str, rcp: str, pairs: float, nbytes: float):
    """(seconds, bound) the card needs at its peaks: the larger of the pair
    work over the FP32 and MUFU rates and the bytes over the HBM rate;
    ``bound`` names which."""
    t_ops = pairs * law_ops(form, rcp) / FP32_OPS_PER_S
    t_mufu = pairs * law_mufu(form) / MUFU_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    best = max((t_ops, "fp32"), (t_mufu, "mufu"), (t_bytes, "bytes"))
    return best


def sweep_bytes(live_cols: float, live_targets: float, quad: bool) -> float:
    """Bytes a sweep must move: each live source column read once (x, y, m
    and, for K4, three second moments) and each target read and its
    acceleration written once, f32."""
    return 4.0 * ((6 if quad else 3) * live_cols + 4 * live_targets)


def k8_shape(n: int, leaf_size: int, frontier_cap: int, leaf_cap: int,
             plan_leaves: int = 1) -> tuple[int, int, int]:
    """(G, S, C) of a monopole plan over ``n`` rows walked two children at a
    time: G rows of S targets, and C columns, 2·F candidates for each level
    below the first walked one plus the leaf list's leaf_cap·leaf_size
    rows."""
    n_leaves = 1 << max(0, (-(-n // leaf_size) - 1).bit_length())
    depth = n_leaves.bit_length() - 1
    pl = max(1, min(plan_leaves, n_leaves))
    k0 = min(max(frontier_cap.bit_length() - 1, 0), depth - 1)
    c = (depth - k0) * 2 * frontier_cap + leaf_cap * leaf_size
    return n_leaves // pl, pl * leaf_size, c


def k8_least_s(g: int, s: int, c: int, launches_a: int,
               launches_b: int) -> float:
    """The least time of the K8a and K8b launches of a plan of shape
    (G, S, C), chip_smoke's count: G·S·C pairs a launch, the targets and
    columns read once, K8a's target cotangents and K8b's column cotangents
    written once."""
    pairs = float(g) * s * c
    in_bytes = 4.0 * (4 * g * s + 3 * g * c)
    ta = least_s("grad_i", "newton", pairs, in_bytes + 8.0 * g * s)[0]
    tb = least_s("grad_j", "newton", pairs, in_bytes + 12.0 * g * c)[0]
    return launches_a * ta + launches_b * tb
