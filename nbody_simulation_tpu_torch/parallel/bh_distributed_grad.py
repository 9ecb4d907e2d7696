"""Differentiable distributed Barnes-Hut.

The port of ``nbody_simulation_tpu/parallel/bh_distributed_grad.py``:
``bh_distributed_accel`` with the differentiable sweep
(``ops.traversal_grad.grouped_force_diff``, whose backward is the
hand-written K8 on a card) in place of ``grouped_force``, and ``multipole``
pinned to 1 (the quadrupole sweep has no backward). Everything else
differentiates by autograd: the tree summaries are reductions, the
planner's decisions are integer and boolean and its gathers are linear,
and the mesh's permutations and gathers carry their own backward (the
inverse permutation, a reduce-scatter; ``parallel.mesh``).
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.traversal_grad import grouped_force_diff
from nbody_simulation_tpu_torch.parallel.bh_distributed import (
    bh_distributed_accel)
from nbody_simulation_tpu_torch.parallel.mesh import Mesh


def bh_distributed_accel_diff(pos: torch.Tensor, mass: torch.Tensor,
                              mesh: Mesh, config: SimConfig | None = None,
                              extra_pairs=()) -> torch.Tensor:
    """Differentiable distributed Barnes-Hut acceleration f32[S·L, 2] of
    the mesh's local shards, with respect to ``pos`` and ``mass``. Same
    stages and arguments as ``bh_distributed_accel``; its value is bitwise
    that of ``bh_distributed_accel`` at ``multipole=1``. Mass gradients flow
    through the leaf tiles only: node masses are int32 sums."""
    cfg = (config or SimConfig(force_path="bh")).replace(multipole=1)
    return bh_distributed_accel(pos, mass, mesh, config=cfg,
                                extra_pairs=extra_pairs,
                                force=grouped_force_diff)
