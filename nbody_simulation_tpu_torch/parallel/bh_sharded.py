"""Multi-device Barnes-Hut: a replicated tree, the leaf groups sharded.

The port of ``nbody_simulation_tpu/parallel/bh_sharded.py``. Every shard
gathers the whole system (``all_gather``), builds the same Morton order and
tree, plans and sweeps its own 1/P of the leaf groups (the planner, then the
sweep kernel K3, or K4 where ``multipole=2``), and the acceleration slices
are gathered back and returned in the original particle order. The walk is
the single-device ``ops.traversal.bh_accel``'s with ``plan_leaves=1``, so
the two differ only where a group's sums run in another order.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.integrate import euler_step
from nbody_simulation_tpu_torch.ops.morton import morton_order
from nbody_simulation_tpu_torch.ops.traversal import (grouped_force,
                                                      last_nonzero_columns,
                                                      plan_rows)
from nbody_simulation_tpu_torch.ops.tree import Level, summarize_sorted
from nbody_simulation_tpu_torch.parallel.mesh import Mesh
from nbody_simulation_tpu_torch.state import ParticleState


def bh_sharded_accel(pos: torch.Tensor, mass: torch.Tensor, mesh: Mesh,
                     config: SimConfig | None = None) -> torch.Tensor:
    """Barnes-Hut acceleration f32[S·L, 2] of the mesh's local shards, in
    their order. The tree's leaf count (a power of two) must be a multiple
    of P."""
    cfg = config or SimConfig(force_path="bh")
    n_dev = mesh.n_shards
    fcap, lcap = cfg.resolved_caps()
    mp = cfg.resolved_multipole()
    pos_all = mesh.all_gather(pos)
    mass_all = mesh.all_gather(mass)
    n = pos_all.shape[0]
    order = morton_order(pos_all, mass_all, cfg.world_size,
                         bits=cfg.resolved_morton_bits())
    tree = summarize_sorted(pos_all[order], mass_all[order],
                            leaf_size=cfg.leaf_size,
                            unweighted_leaf_com=cfg.unweighted_leaf_com,
                            quad=mp == 2)
    n_leaves, leaf_size, _ = tree.leaf_pos.shape
    if n_leaves % n_dev:
        raise ValueError(f"{n_leaves} tree leaves do not split over "
                         f"{n_dev} shards")
    my_leaves = n_leaves // n_dev
    lv = tree.levels[-1]
    slices = []
    for shard in mesh.shard_ids:
        sl = slice(shard * my_leaves, (shard + 1) * my_leaves)
        own = Level(aabb_min=lv.aabb_min[sl], aabb_max=lv.aabb_max[sl],
                    com=lv.com[sl], mass_i=lv.mass_i[sl],
                    count=lv.count[sl],
                    quad=None if lv.quad is None else lv.quad[sl])
        planned = plan_rows(tree, own, cfg.theta, fcap, lcap,
                            cfg.tree_arity, multipole=mp)
        src_q = planned[3:] or None
        slices.append(grouped_force(
            tree.leaf_pos[sl], *planned[:3], softening2=cfg.softening2,
            rcp=cfg.resolved_rcp(bh=True),
            col_limit=last_nonzero_columns(planned[2], src_q),
            src_q=src_q).reshape(my_leaves * leaf_size, 2))
    acc_sorted = mesh.all_gather(torch.cat(slices))
    acc = torch.zeros((n, 2), dtype=torch.float32, device=pos.device)
    acc[order] = acc_sorted[:n]
    return mesh.local_rows(acc)


def make_sharded_bh_step(mesh: Mesh, config: SimConfig):
    """A ``state -> state`` multi-device Barnes-Hut step: the sharded force
    and semi-implicit Euler in f32."""

    def step(state: ParticleState) -> ParticleState:
        acc = bh_sharded_accel(state.pos, state.mass, mesh, config=config)
        return euler_step(state, acc, config.dt)

    return step
