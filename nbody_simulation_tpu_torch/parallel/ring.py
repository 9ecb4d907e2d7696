"""The ring all-pairs force exchange: the multi-device exact force path.

The port of ``nbody_simulation_tpu/parallel/ring.py``. Each of P shards
holds L particles. In the ordered ring the (position, mass) blocks travel
P−1 hops around the ring while every shard adds its local targets'
acceleration from the visiting sources: the self stage is the symmetric
kernel (K2) where L is a multiple of ``min(sym_tile, L)``, else the ordered
one (K1), and each visiting stage is K1 with ``src_pos``. The symmetric
ring carries a partial acceleration with the visiting block and evaluates
each cross-shard pair once (K9, ``allpairs_accel_sym_pair``), in ⌊P/2⌋
rounds and one closing hop. The dispatch between them, and every kernel
choice, are the JAX package's, so the port runs the same kernel family at
every P and N.

The functions take and return the mesh's local arrays (``parallel.mesh``):
on a ``LocalMesh`` every shard's rows, on a ``ProcessGroupMesh`` the rank's.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.ops.allpairs import (allpairs_accel,
                                                     allpairs_accel_sym,
                                                     allpairs_accel_sym_pair)
from nbody_simulation_tpu_torch.parallel.mesh import Mesh, map_shards


def symring_profitable(n_dev: int) -> bool:
    """Whether the JAX package takes the symmetric ring at ``n_dev`` shards
    under ``sym_ring="auto"``: odd P ≥ 3, or P ≥ 6. Its crossover was
    measured on a TPU, where one symmetric cross-shard block cost ~1.57×
    an ordered one and covers two shards' outputs; it is kept unchanged so
    that both packages dispatch alike."""
    return n_dev >= 3 and (n_dev % 2 == 1 or n_dev >= 6)


def ring_allpairs_accel(pos: torch.Tensor, mass: torch.Tensor, mesh: Mesh,
                        softening2: float = 1e-3, tile_i: int = 512,
                        tile_j: int = 2048, rcp: str = "newton",
                        sym: bool = True, sym_tile: int = 1024,
                        sym_ring: bool | str = "auto") -> torch.Tensor:
    """All-pairs acceleration of particles sharded over ``mesh``.

    ``pos`` f32[S·L, 2] and ``mass`` f32[S·L] are the mesh's local shards;
    the result is f32[S·L, 2] likewise. L must be a multiple of the clipped
    tiles, as in the JAX package (``shard_state`` pads to such an L).
    ``sym``: the self stage by the symmetric kernel (K2). ``sym_ring``:
    the symmetric ring (``ring_allpairs_accel_symring``) for the visiting
    stages too; ``"auto"`` takes it where ``symring_profitable``, and
    ``True``/``False`` force it. Same physics either way; f32 summation
    order differs."""
    n_dev = mesh.n_shards
    n_l = pos.shape[0] // mesh.n_local
    use_symring = (symring_profitable(n_dev) if sym_ring == "auto"
                   else bool(sym_ring))
    use_symring = use_symring and n_l % min(sym_tile, n_l) == 0
    if use_symring and sym and n_dev > 1:
        return ring_allpairs_accel_symring(pos, mass, mesh,
                                           softening2=softening2, rcp=rcp,
                                           sym_tile=sym_tile)

    def self_stage(p, m):
        if sym and n_l % min(sym_tile, n_l) == 0:
            return allpairs_accel_sym(p, m, softening2=softening2,
                                      tile=sym_tile, rcp=rcp)
        return allpairs_accel(p, m, softening2=softening2, tile_i=tile_i,
                              tile_j=tile_j, rcp=rcp)

    def visit(p, m, vp, vm):
        return allpairs_accel(p, m, src_pos=vp, src_mass=vm,
                              softening2=softening2, tile_i=tile_i,
                              tile_j=tile_j, rcp=rcp)

    acc = map_shards(mesh, self_stage, pos, mass)
    vis_pos, vis_mass = pos, mass
    for _ in range(1, n_dev):
        vis_pos = mesh.ppermute(vis_pos, 1)
        vis_mass = mesh.ppermute(vis_mass, 1)
        acc = acc + map_shards(mesh, visit, pos, mass, vis_pos, vis_mass)
    return acc


def ring_allpairs_accel_symring(pos: torch.Tensor, mass: torch.Tensor,
                                mesh: Mesh, softening2: float = 1e-3,
                                rcp: str = "newton",
                                sym_tile: int = 1024) -> torch.Tensor:
    """The fully symmetric ring: Newton's third law across shards.

    After the self stage (K2), K = ⌊P/2⌋ rounds: the (pos, mass, partial
    acceleration) tuple arrives from shard i−k, and K9 evaluates each
    (local, visiting) pair once, adding the local side to the shard's own
    sum and the visiting side to the tuple's. For even P the last round is
    a half round: pairs (i, i+P/2) would otherwise be counted twice, so
    shards with index ≥ K multiply their round-K contributions by 0 (the
    kernel runs on every shard, as in the JAX package's SPMD program). One
    closing hop of distance K brings every partial home. Each shard
    evaluates ⌈(P−1)/2⌉ cross blocks where the ordered ring takes P−1."""
    n_dev = mesh.n_shards
    if n_dev == 1:
        return ring_allpairs_accel(pos, mass, mesh, softening2=softening2,
                                   rcp=rcp, sym_tile=sym_tile)
    k_rounds = n_dev // 2
    half_last = n_dev % 2 == 0

    def pair(p, m, vp, vm):
        return allpairs_accel_sym_pair(p, m, vp, vm, softening2=softening2,
                                       tile=sym_tile, rcp=rcp)

    acc = map_shards(
        mesh, lambda p, m: allpairs_accel_sym(p, m, softening2=softening2,
                                              tile=sym_tile, rcp=rcp),
        pos, mass)
    vis_pos, vis_mass = pos, mass
    vis_acc = pos * 0.0
    for k in range(1, k_rounds + 1):
        vis_pos = mesh.ppermute(vis_pos, 1)
        vis_mass = mesh.ppermute(vis_mass, 1)
        vis_acc = mesh.ppermute(vis_acc, 1)
        ai, aj = map_shards(mesh, pair, pos, mass, vis_pos, vis_mass)
        if half_last and k == k_rounds:
            gate = (mesh.axis_index() < k_rounds).to(torch.float32)
            gate = gate.repeat_interleave(pos.shape[0] // mesh.n_local)
            ai = ai * gate[:, None]
            aj = aj * gate[:, None]
        acc = acc + ai
        vis_acc = vis_acc + aj
    return acc + mesh.ppermute(vis_acc, -k_rounds)
