"""Total-energy diagnostics: pairwise potential plus kinetic, exact and BH.

The port of ``nbody_simulation_tpu/ops/energy.py``, which explains why the
energy is that of the reference law's conservative isotropic counterpart:
the reference's ``m_j·d/(‖d‖₁·‖d‖₂²)`` has a nonzero curl, so no potential
reproduces it. The pair potential is

    u(i, j) = − m_i·m_j / sqrt(max(r², ε))          (ε = softening2)

with pairs masked by the force law's own is_normal guard on ‖d‖₁.

``allpairs_potential`` (K6) launches the hand-written kernel of
``csrc/allpairs.cu`` (``potential_cuda``: chunks of sources across the
grid, ``potential_plan``, then a fold in chunk order) on CUDA tensors and
runs the plain version ``allpairs_potential_ref`` on CPU tensors. The
Barnes-Hut potential is plain torch, as it is plain XLA in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_simulation_tpu_torch.ops import split
from nbody_simulation_tpu_torch.ops.allpairs import (_load_lib,
                                                     check_cuda_inputs,
                                                     pair_sums)
from nbody_simulation_tpu_torch.ops.force import FLT_MAX, FLT_MIN_NORMAL

# Operations per pair of the potential sweep (root, mask, multiply-add), as
# the JAX package counts them for its rates.
POT_FLOPS_PER_PAIR = 10


def pot_tile(dx: torch.Tensor, dy: torch.Tensor, mj: torch.Tensor,
             softening2: float = 1e-3) -> torch.Tensor:
    """Pair potential contributions −m_j/sqrt(max(r², ε)); 0 where ‖d‖₁ is
    zero, subnormal or not finite (self-pairs, coincident points)."""
    s = dx.abs() + dy.abs()
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
    phi = -mj * torch.rsqrt(d2)
    return torch.where(normal, phi, torch.zeros((), dtype=phi.dtype,
                                                device=phi.device))


def allpairs_potential_ref(pos: torch.Tensor, mass: torch.Tensor,
                           src_pos: torch.Tensor | None = None,
                           src_mass: torch.Tensor | None = None,
                           softening2: float = 1e-3) -> torch.Tensor:
    """K6's plain version: φ_i = Σ_j pot_tile, f32[Ni]."""
    if src_pos is None:
        src_pos, src_mass = pos, mass
    return pair_sums(pos, src_pos, src_mass,
                     lambda dx, dy, mj, e: (pot_tile(dx, dy, mj, e),),
                     softening2)[:, 0]


# -- K6's work split ----------------------------------------------------------

class PotentialPlan(NamedTuple):
    """K6's grid (``potential_plan``): ``target_blocks`` blocks of
    ``targets_per_block`` targets, and the sources cut into ``chunks``
    chunks of ``chunk`` sources (a multiple of ``split.RUN``). Block (target
    block b, chunk k) sums sources [k·chunk, (k+1)·chunk) for targets
    [b·targets_per_block, (b+1)·targets_per_block) into slot (k, target);
    the fold adds a target's slots in chunk order."""
    targets_per_block: int
    target_blocks: int
    chunk: int
    chunks: int


def potential_plan(ni: int, nj: int, targets_per_block: int,
                   resident_blocks: int) -> PotentialPlan:
    """K6's grid for Ni targets and Nj sources: ``split.chunk_plan`` over
    the target blocks, with Ni f64 slots per chunk."""
    if targets_per_block <= 0 or ni < 0:
        raise ValueError(f"potential_plan: bad shape Ni={ni} Nj={nj}, "
                         f"{targets_per_block} targets per block")
    tb = max(1, -(-ni // targets_per_block))
    plan = split.chunk_plan(tb, -(-nj // split.RUN), resident_blocks,
                            8 * max(ni, 1), bounded=False)
    return PotentialPlan(targets_per_block, tb, *plan)


def potential_launch_plan(ni: int, nj: int, device: torch.device,
                          softening2: float) -> PotentialPlan:
    """``potential_plan`` on a CUDA ``device`` for the kernel form that
    ``softening2`` picks, its block read from the built kernel
    (``split.launch_shape``)."""
    shape = split.launch_shape(_load_lib().potential_shape, device,
                               float(softening2))
    return potential_plan(ni, nj, shape.threads * shape.targets,
                          shape.resident_blocks)


def potential_chunked(lib, pos, src_pos, src_mass, softening2: float,
                      chunk: int):
    """Launch K6 and its fold from ``lib`` with the sources cut into chunks
    of ``chunk``, on checked inputs; returns the CUDA error and the output.
    The slots are allocated here, uninitialised: the kernel writes every
    slot the fold reads."""
    ni, nj = pos.shape[0], src_pos.shape[0]
    out = torch.empty(ni, dtype=torch.float32, device=pos.device)
    slots = torch.empty((-(-nj // chunk), ni), dtype=torch.float64,
                        device=pos.device)
    err = lib.potential_launch(
        pos.data_ptr(), src_pos.data_ptr(), src_mass.data_ptr(),
        slots.data_ptr() if slots.numel() else None, out.data_ptr(), ni, nj,
        chunk, float(softening2), pos.device.index or 0,
        torch.cuda.current_stream(pos.device).cuda_stream)
    return err, out


def potential_cuda(pos: torch.Tensor, src_pos: torch.Tensor,
                   src_mass: torch.Tensor,
                   softening2: float = 1e-3) -> torch.Tensor:
    """Launch K6 (``csrc/allpairs.cu``) and its fold on the grid of
    ``potential_launch_plan``: targets f32 (Ni, 2) against sources f32 (Nj,
    2) with masses f32 (Nj,), contiguous on one CUDA device; returns f32
    (Ni,). Anything else raises; there is no fallback.
    ``potential_cuda.launches`` counts the calls."""
    ni, nj = pos.shape[0], src_pos.shape[0]
    check_cuda_inputs("potential_cuda", [(pos, (ni, 2)), (src_pos, (nj, 2)),
                                         (src_mass, (nj,))])
    plan = potential_launch_plan(ni, nj, pos.device, softening2)
    err, out = potential_chunked(_load_lib(), pos, src_pos, src_mass,
                                 softening2, plan.chunk)
    if err != 0:
        raise RuntimeError(f"potential kernel launch failed: CUDA error "
                           f"{err} at Ni={ni}, Nj={nj}")
    potential_cuda.launches += 1
    return out


potential_cuda.launches = 0


def allpairs_potential(pos: torch.Tensor, mass: torch.Tensor,
                       src_pos: torch.Tensor | None = None,
                       src_mass: torch.Tensor | None = None,
                       softening2: float = 1e-3, tile_i: int = 512,
                       tile_j: int = 2048) -> torch.Tensor:
    """Per-target potential φ_i = −Σ_j m_j/sqrt(max(r², ε)), f32[Ni], for
    any Ni and Nj. ``tile_i`` and ``tile_j`` are accepted for parity with
    the JAX package, whose kernel pads both axes to them, and ignored:
    neither the kernel nor the plain version needs tile multiples."""
    if src_pos is None:
        src_pos = pos
    if src_mass is None:
        src_mass = mass
    if pos.device.type == "cuda":
        return potential_cuda(pos, src_pos, src_mass, softening2)
    if pos.device.type == "cpu":
        return allpairs_potential_ref(pos, None, src_pos, src_mass,
                                      softening2)
    raise ValueError(f"no potential kernel for device {pos.device}")


def potential_energy(pos: torch.Tensor, mass: torch.Tensor,
                     softening2: float = 1e-3) -> torch.Tensor:
    """Total pair potential U = ½·Σ_i m_i·φ_i (each pair counted once)."""
    phi = allpairs_potential(pos, mass, softening2=softening2)
    return 0.5 * (mass * phi).sum()


def kinetic_energy(vel: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    return (0.5 * mass * (vel * vel).sum(dim=-1)).sum()


def total_energy(state, softening2: float = 1e-3) -> torch.Tensor:
    """E = KE + U of a ParticleState; padding is inert."""
    return (kinetic_energy(state.vel, state.mass)
            + potential_energy(state.pos, state.mass, softening2=softening2))


def bh_total_energy(state, config) -> torch.Tensor:
    """Approximate E = KE + U, U from ``bh_potential_energy``."""
    u = bh_potential_energy(state, config)
    return kinetic_energy(state.vel, state.mass) + u


def bh_potential_energy(state, config) -> torch.Tensor:
    """Approximate U from the Barnes-Hut planned source columns: O(N·C)
    instead of the exact sweep's O(N²/2), with the same sort, build and plan
    as the force path, the planned columns fed to the counterpart potential
    (monopole) instead of the force law."""
    from nbody_simulation_tpu_torch.ops.traversal import bh_plan_sources
    from nbody_simulation_tpu_torch.ops.tree import build_tree

    cfg = config
    tree, _ = build_tree(state.pos, state.mass, leaf_size=cfg.leaf_size,
                         world_size=cfg.world_size,
                         unweighted_leaf_com=cfg.unweighted_leaf_com,
                         morton_bits=cfg.resolved_morton_bits())
    f, l = cfg.resolved_caps()
    n_leaves, s, _ = tree.leaf_pos.shape
    pl_ = max(1, min(cfg.plan_leaves, n_leaves))
    while n_leaves % pl_:
        pl_ //= 2
    src_x, src_y, src_m = bh_plan_sources(tree, cfg.theta, f, l,
                                          plan_leaves=pl_, multipole=1)
    g = n_leaves // pl_
    return bh_potential_from_columns(tree.leaf_mass.reshape(g, pl_ * s),
                                     tree.leaf_pos.reshape(g, pl_ * s, 2),
                                     src_x, src_y, src_m,
                                     softening2=cfg.softening2)


def bh_potential_from_columns(tgt_mass: torch.Tensor, tgt_pos: torch.Tensor,
                              src_x: torch.Tensor, src_y: torch.Tensor,
                              src_m: torch.Tensor,
                              softening2: float = 1e-3) -> torch.Tensor:
    """U from already planned BH source columns: ``tgt_pos`` (G, S, 2)
    group targets, ``tgt_mass`` (G, S), ``src_*`` (G, C). Each (target,
    source) pair appears once per direction, so the ½ applies. The (G, S, C)
    pair terms are summed in chunks of ``gb`` groups (the largest power of
    two ≤ 256 dividing G, the JAX package's chunks), so the temporaries stay
    bounded; the chunk sums are added at the end."""
    g = tgt_pos.shape[0]
    gb = min(256, g)
    while g % gb:
        gb //= 2
    parts = []
    for g0 in range(0, g, gb):
        sl = slice(g0, g0 + gb)
        tp = tgt_pos[sl]
        c = pot_tile(src_x[sl, None, :] - tp[..., 0:1],
                     src_y[sl, None, :] - tp[..., 1:2],
                     src_m[sl, None, :], softening2)
        parts.append((tgt_mass[sl] * c.sum(dim=-1)).sum())
    return 0.5 * torch.stack(parts).sum()
