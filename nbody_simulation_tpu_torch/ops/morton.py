"""Morton (Z-order) keys and the spatial sort.

The port of ``nbody_simulation_tpu/ops/morton.py``: positions are quantized
to ``bits`` per axis and interleaved. ``bits <= 15`` gives one int32 key;
``bits <= 24`` two words (hi, lo) sorted lexicographically. Padding
(mass <= 0) gets key INT32_MAX and sorts last. The stable sort gives the
same permutation as the JAX package's stable multi-payload ``lax.sort``
(tests/test_torch_tree.py).
"""

from __future__ import annotations

import numpy as np
import torch

MORTON_BITS = 15
PAD_KEY = 2**31 - 1


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Insert a 0 bit between each of the low 16 bits of v (int32)."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _interleave2(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    return (_spread_bits(qy) << 1) | _spread_bits(qx)


def morton_keys(pos: torch.Tensor, mass: torch.Tensor, world_size: float,
                bits: int = MORTON_BITS):
    """(hi, lo) int32 Morton key words; padding (mass<=0) sorts last.

    For ``bits <= 15`` the low word is all zeros.
    """
    if not 1 <= bits <= 24:
        raise ValueError(f"bits must be in [1, 24], got {bits}")
    scale = float(np.float32((1 << bits) / world_size))
    top = (1 << bits) - 1
    # XLA's f32→int32 convert saturates and maps NaN to 0; clamping in float
    # first gives the same integers for every input.
    qf = torch.nan_to_num(pos * scale, nan=0.0)
    q = torch.clamp(qf, 0.0, float(top)).to(torch.int32)
    pad = mass <= 0
    pad_key = torch.full_like(q[:, 0], PAD_KEY)
    if bits <= 15:
        hi = _interleave2(q[:, 0], q[:, 1])
        lo = torch.zeros_like(hi)
    else:
        low_bits = bits // 2
        mask = (1 << low_bits) - 1
        hi = _interleave2(q[:, 0] >> low_bits, q[:, 1] >> low_bits)
        lo = _interleave2(q[:, 0] & mask, q[:, 1] & mask)
        lo = torch.where(pad, pad_key, lo)
    return torch.where(pad, pad_key, hi), lo



def morton_encode(pos: torch.Tensor, mass: torch.Tensor, world_size: float,
                  bits: int = MORTON_BITS) -> torch.Tensor:
    """One int32 Morton key per particle: the high word of ``morton_keys``
    (the whole key for ``bits <= 15``)."""
    return morton_keys(pos, mass, world_size, bits)[0]


def morton_order(pos: torch.Tensor, mass: torch.Tensor, world_size: float,
                 bits: int = MORTON_BITS) -> torch.Tensor:
    """Stable permutation that sorts particles in Z-order, padding last.

    bits > 15: stable sort by the low word, then stably by the high word —
    the lexicographic (hi, lo) order.
    """
    hi, lo = morton_keys(pos, mass, world_size, bits)
    if bits <= 15:
        return torch.sort(hi, stable=True).indices
    p1 = torch.sort(lo, stable=True).indices
    p2 = torch.sort(hi[p1], stable=True).indices
    return p1[p2]


def morton_sort_state(pos: torch.Tensor, vel: torch.Tensor,
                      mass: torch.Tensor, world_size: float,
                      bits: int = MORTON_BITS):
    """``(pos, vel, mass)`` sorted in Z-order, padding (mass<=0) last."""
    order = morton_order(pos, mass, world_size, bits)
    return (pos.index_select(0, order), vel.index_select(0, order),
            mass.index_select(0, order))
