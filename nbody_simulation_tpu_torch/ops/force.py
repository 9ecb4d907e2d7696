"""The reference force law on torch tensors.

The reference's pairwise interaction (reference src/main.rs:234-253):

    diff = p2 - p1
    sum  = |diff.x| + |diff.y|                  # L1 norm
    if !sum.is_normal(): return                 # self/NaN/inf/subnormal
    dist = max(diff.square_length(), 1e-3)      # squared-L2, clamped
    accel += (diff * m2) / (sum * dist)         # numerator FIRST

Every operation is its own eager torch op, in this order, so the result is
bitwise the JAX package's ``pair_accel`` and ``oracle.pair_accel_oracle``
(tests/test_torch_force.py). ``direct_accel`` is the exact O(N²) path; it
is plain torch in both packages.
"""

from __future__ import annotations

import torch

# Smallest positive normal f32 — the threshold of Rust's f32::is_normal.
FLT_MIN_NORMAL = 1.17549435e-38
# Largest finite f32: ``s <= FLT_MAX`` is false for inf and NaN.
FLT_MAX = 3.4028235e38


def pair_accel(dx: torch.Tensor, dy: torch.Tensor, mass_j: torch.Tensor,
               softening2: float = 1e-3):
    """Acceleration contribution of source(s) j on target(s) i.

    ``dx, dy`` are components of ``p_j - p_i`` (broadcastable), ``mass_j``
    the source mass. Returns ``(ax, ay)``; masked pairs contribute 0. The
    arithmetic runs in the inputs' dtype (f32 on the main path, f64 for a
    reference sum).
    """
    s = dx.abs() + dy.abs()
    normal = torch.isfinite(s) & (s >= FLT_MIN_NORMAL)
    d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
    den = s * d2
    # Dead lanes get a denominator of 1 so no NaN/inf leaks through.
    den = torch.where(normal, den, torch.ones((), dtype=den.dtype,
                                              device=den.device))
    zero = torch.zeros((), dtype=den.dtype, device=den.device)
    ax = torch.where(normal, (dx * mass_j) / den, zero)
    ay = torch.where(normal, (dy * mass_j) / den, zero)
    return ax, ay


def direct_accel_at(tpos: torch.Tensor, pos: torch.Tensor, mass: torch.Tensor,
                    softening2: float = 1e-3,
                    row_chunk: int = 1024) -> torch.Tensor:
    """Direct acceleration at target positions ``tpos`` (M, 2) from all
    sources ``pos``/``mass`` (N rows), ``row_chunk`` targets at a time. A
    target that coincides with a source skips that pair (the is_normal
    guard), so rows of ``pos`` as targets reproduce ``direct_accel``."""
    x, y = pos[:, 0], pos[:, 1]
    out = torch.empty_like(tpos)
    for start in range(0, tpos.shape[0], row_chunk):
        t = tpos[start:start + row_chunk]
        dx = x[None, :] - t[:, 0:1]
        dy = y[None, :] - t[:, 1:2]
        ax, ay = pair_accel(dx, dy, mass[None, :], softening2)
        out[start:start + row_chunk, 0] = ax.sum(dim=1)
        out[start:start + row_chunk, 1] = ay.sum(dim=1)
    return out


def direct_accel(pos: torch.Tensor, mass: torch.Tensor,
                 softening2: float = 1e-3,
                 row_chunk: int = 1024) -> torch.Tensor:
    """Direct O(N²) acceleration — the exact-summation path (the reference's
    leaf loop, src/main.rs:355-362, over every pair). Self-pairs are masked
    by the is_normal guard."""
    return direct_accel_at(pos, pos, mass, softening2, row_chunk)
