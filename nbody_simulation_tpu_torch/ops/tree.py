"""Flat BVH over Morton-sorted particles: dense level arrays, no pointers.

The port of ``nbody_simulation_tpu/ops/tree.py``. Sorted particles are
grouped into ``leaf_size``-particle leaves, the leaf count is padded to a
power of two, level ``l`` holds ``2^l`` nodes and node ``k``'s children
are ``2k, 2k+1``. The bottom-up summarize pass (reference
src/bvh_tree.rs:133-158) is one reshape-reduction per level.

Kept exactly: masses are cast f32→int32 and summed in int32 (the reference's
u32 ``total_mass``), a leaf's COM is the unweighted mean of its positions
(the reference quirk, src/bvh_tree.rs:98-116) unless turned off, internal
COMs divide by ``max(mass, 1)``, and empty nodes sit at ``EMPTY_POS`` with
zero size and zero mass.

With ``quad=True`` every level also carries its second moments about the
stored COM, which the ``multipole=2`` planner emits for the quadrupole
sweep. The JAX package always computes them and lets ``jit`` drop them
where they go unused; torch runs eagerly, so the monopole paths skip them
(their ~10 extra launches per level) and ``Level.quad`` is then None.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nbody_simulation_tpu_torch.ops.morton import morton_order

BIG = 3.0e38
EMPTY_POS = 2.0e5


class Level(NamedTuple):
    aabb_min: torch.Tensor   # (2^l, 2)
    aabb_max: torch.Tensor   # (2^l, 2)
    com: torch.Tensor        # (2^l, 2)
    mass_i: torch.Tensor     # (2^l,) int32 — exact integer mass sum
    count: torch.Tensor      # (2^l,) int32 — real (non-padding) members
    # (2^l, 3) f32 — Σ w·(δxδx, δxδy, δyδy) about the stored COM, with float
    # masses w; None when the tree was built without ``quad``.
    quad: torch.Tensor | None = None

    @property
    def packed(self) -> torch.Tensor:
        """(2^l, 8) f32 record [min_x,min_y,max_x,max_y,com_x,com_y,mass,
        count], so the planner fetches a node in one gather."""
        return torch.cat([
            self.aabb_min, self.aabb_max, self.com,
            self.mass_i.to(torch.float32)[:, None],
            self.count.to(torch.float32)[:, None]], dim=1)

    @property
    def packed_quad(self) -> torch.Tensor:
        """(2^l, 11) f32 record: ``packed`` + [qxx, qxy, qyy]."""
        if self.quad is None:
            raise ValueError("this tree has no second moments: build it "
                             "with quad=True for the multipole=2 planner")
        return torch.cat([self.packed, self.quad], dim=1)


class FlatTree(NamedTuple):
    """levels[0] = root ... levels[depth] = leaves; leaf data is the sorted
    particle arrays reshaped to (n_leaves, leaf_size)."""
    levels: list[Level]
    leaf_pos: torch.Tensor    # (n_leaves, leaf_size, 2)
    leaf_mass: torch.Tensor   # (n_leaves, leaf_size)

    @property
    def depth(self) -> int:
        return len(self.levels) - 1


def _fill(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _leaf_level(pos3, mass2, unweighted_leaf_com: bool,
                quad: bool = False) -> Level:
    """pos3: (L, S, 2) sorted positions; mass2: (L, S)."""
    real = mass2 > 0
    real3 = real[..., None]
    aabb_min = torch.where(real3, pos3, _fill(pos3, BIG)).amin(dim=1)
    aabb_max = torch.where(real3, pos3, _fill(pos3, -BIG)).amax(dim=1)
    count = real.sum(dim=1, dtype=torch.int32)
    w = torch.where(real, mass2, _fill(mass2, 0.0))
    mass_i = w.to(torch.int32).sum(dim=1, dtype=torch.int32)
    if unweighted_leaf_com:
        num = torch.where(real3, pos3, _fill(pos3, 0.0)).sum(dim=1)
        den = torch.clamp_min(count, 1).to(torch.float32)[:, None]
    else:
        num = (pos3 * w[..., None]).sum(dim=1)
        den = torch.clamp_min(w.sum(dim=1), 1e-30)[:, None]
    com = num / den
    empty = (count == 0)[:, None]
    e = _fill(pos3, EMPTY_POS)
    q = None
    if quad:
        # About the COM as stored, whichever convention made it.
        d = pos3 - com[:, None, :]
        q = torch.where(empty, _fill(pos3, 0.0), torch.stack(
            [(w * d[..., 0] * d[..., 0]).sum(dim=1),
             (w * d[..., 0] * d[..., 1]).sum(dim=1),
             (w * d[..., 1] * d[..., 1]).sum(dim=1)], dim=1))
    return Level(aabb_min=torch.where(empty, e, aabb_min),
                 aabb_max=torch.where(empty, e, aabb_max),
                 com=torch.where(empty, e, com),
                 mass_i=mass_i, count=count, quad=q)


def _combine(child: Level) -> Level:
    """Pairwise-combine level l+1 (2m nodes) into level l (m nodes)."""
    m = child.aabb_min.shape[0] // 2

    def pair(x):
        return x.reshape(m, 2, *x.shape[1:])

    cmin, cmax = pair(child.aabb_min), pair(child.aabb_max)
    ccom, cmass, ccount = pair(child.com), pair(child.mass_i), pair(child.count)
    count = ccount.sum(dim=1, dtype=torch.int32)
    mass_i = cmass.sum(dim=1, dtype=torch.int32)
    massf = cmass.to(torch.float32)
    num = (ccom * massf[..., None]).sum(dim=1)
    den = torch.clamp_min(mass_i.to(torch.float32), 1.0)[:, None]
    com = num / den
    # Empty children sit at EMPTY_POS with zero size: mask them out of the
    # parent's AABB.
    cempty = (ccount == 0)[..., None]
    aabb_min = torch.where(cempty, _fill(cmin, BIG), cmin).amin(dim=1)
    aabb_max = torch.where(cempty, _fill(cmax, -BIG), cmax).amax(dim=1)
    empty = (count == 0)[:, None]
    e = _fill(com, EMPTY_POS)
    q = None
    if child.quad is not None:
        # Parallel axis: Q_p = Σ_c Q_c + m_c·(com_c − com_p)⊗(com_c − com_p),
        # m_c the children's int32 masses as f32; empty children add 0.
        d = ccom - com[:, None, :]
        shift = torch.stack([d[..., 0] * d[..., 0], d[..., 0] * d[..., 1],
                             d[..., 1] * d[..., 1]], dim=-1)
        q = torch.where(empty, _fill(com, 0.0),
                        (pair(child.quad) + massf[..., None] * shift
                         ).sum(dim=1))
    return Level(aabb_min=torch.where(empty, e, aabb_min),
                 aabb_max=torch.where(empty, e, aabb_max),
                 com=torch.where(empty, e, com),
                 mass_i=mass_i, count=count, quad=q)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def summarize_sorted(spos: torch.Tensor, smass: torch.Tensor,
                     leaf_size: int = 64, unweighted_leaf_com: bool = True,
                     quad: bool = False) -> FlatTree:
    """Build the flat BVH over already spatially-ordered particles, with
    each level's second moments when ``quad``.

    AABBs, masses and COMs come from the current positions, so a stale
    Morton order only loosens AABBs (the conservative planner opens a bit
    more); forces stay Barnes-Hut.
    """
    n = spos.shape[0]
    n_leaves = _next_pow2(-(-n // leaf_size))
    n_pad = n_leaves * leaf_size
    if n_pad != n:
        extra = n_pad - n
        spos = torch.cat([spos, torch.full((extra, 2), EMPTY_POS,
                                           dtype=torch.float32,
                                           device=spos.device)])
        smass = torch.cat([smass, torch.zeros(extra, dtype=torch.float32,
                                              device=smass.device)])
    pos3 = spos.reshape(n_leaves, leaf_size, 2)
    mass2 = smass.reshape(n_leaves, leaf_size)

    levels = [_leaf_level(pos3, mass2, unweighted_leaf_com, quad)]
    while levels[0].aabb_min.shape[0] > 1:
        levels.insert(0, _combine(levels[0]))
    return FlatTree(levels=levels, leaf_pos=pos3, leaf_mass=mass2)


def build_tree(pos: torch.Tensor, mass: torch.Tensor, leaf_size: int = 64,
               world_size: float = 100_000.0,
               unweighted_leaf_com: bool = True, morton_bits: int = 15,
               quad: bool = False):
    """Morton-sort the particles and build the flat BVH. Returns
    ``(tree, order)`` with ``sorted_x = x[order]``."""
    order = morton_order(pos, mass, world_size, bits=morton_bits)
    tree = summarize_sorted(pos[order], mass[order], leaf_size=leaf_size,
                            unweighted_leaf_com=unweighted_leaf_com,
                            quad=quad)
    return tree, order


def tree_from_numpy(levels, leaf_pos, leaf_mass,
                    device: str | torch.device = "cpu") -> FlatTree:
    """A tree from host arrays. ``levels`` is a sequence, root first, of
    ``(aabb_min, aabb_max, com, mass_i, count[, quad])`` per level — the
    JAX package's ``Level`` fields in order. A level without ``quad`` (or
    with None there) gets none."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    lv = [Level(t(l[0], torch.float32), t(l[1], torch.float32),
                t(l[2], torch.float32), t(l[3], torch.int32),
                t(l[4], torch.int32),
                None if len(l) < 6 or l[5] is None
                else t(l[5], torch.float32)) for l in levels]
    return FlatTree(levels=lv, leaf_pos=t(leaf_pos, torch.float32),
                    leaf_mass=t(leaf_mass, torch.float32))


def tree_to_numpy(tree: FlatTree):
    """``(levels, leaf_pos, leaf_mass)`` as host arrays, levels as tuples of
    ``(aabb_min, aabb_max, com, mass_i, count, quad)`` (quad None when the
    tree has none)."""
    levels = [tuple(None if a is None else a.cpu().numpy() for a in l)
              for l in tree.levels]
    return levels, tree.leaf_pos.cpu().numpy(), tree.leaf_mass.cpu().numpy()
