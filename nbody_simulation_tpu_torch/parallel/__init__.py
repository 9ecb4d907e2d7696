"""Multi-device paths on a mesh of P shards held in one process
(``LocalMesh``) or one per ``torch.distributed`` rank
(``ProcessGroupMesh``): the ring all-pairs force (with the cross-shard
symmetric kernel K9), its gradient, the sharded step, diagnostics, energy
and frame, the replicated-tree Barnes-Hut, and the fully distributed
Barnes-Hut with its gradient, energy, step and collective rebalance."""

from nbody_simulation_tpu_torch.parallel.bh_distributed import (
    adjacency_stages, bh_distributed_accel, bh_distributed_total_energy,
    distribute_state, make_distributed_bh_step, rebalance_state,
    resolved_seam_stages)
from nbody_simulation_tpu_torch.parallel.bh_distributed_grad import (
    bh_distributed_accel_diff)
from nbody_simulation_tpu_torch.parallel.bh_sharded import (
    bh_sharded_accel, make_sharded_bh_step)
from nbody_simulation_tpu_torch.parallel.mesh import (AXIS, LocalMesh,
                                                      ProcessGroupMesh,
                                                      make_1d_mesh,
                                                      shard_state)
from nbody_simulation_tpu_torch.parallel.multihost import init_distributed
from nbody_simulation_tpu_torch.parallel.raster import (
    sharded_render_frame, simulate_distributed)
from nbody_simulation_tpu_torch.parallel.repartition import (
    collective_rebalance, make_collective_rebalance)
from nbody_simulation_tpu_torch.parallel.ring import (
    ring_allpairs_accel, ring_allpairs_accel_symring)
from nbody_simulation_tpu_torch.parallel.ring_grad import (
    ring_allpairs_accel_diff)
from nbody_simulation_tpu_torch.parallel.sharded_step import (
    make_sharded_step, sharded_diagnostics, sharded_total_energy)

__all__ = ["AXIS", "LocalMesh", "ProcessGroupMesh", "init_distributed",
           "make_1d_mesh", "shard_state", "ring_allpairs_accel",
           "ring_allpairs_accel_symring", "ring_allpairs_accel_diff",
           "make_sharded_step", "sharded_diagnostics",
           "sharded_total_energy", "bh_sharded_accel",
           "make_sharded_bh_step", "adjacency_stages",
           "bh_distributed_accel", "bh_distributed_accel_diff",
           "bh_distributed_total_energy", "distribute_state",
           "make_distributed_bh_step", "rebalance_state",
           "resolved_seam_stages", "sharded_render_frame",
           "simulate_distributed", "collective_rebalance",
           "make_collective_rebalance"]
