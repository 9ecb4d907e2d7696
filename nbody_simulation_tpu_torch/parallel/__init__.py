"""Multi-device paths: the ring all-pairs force (with the cross-shard
symmetric kernel K9), its gradient, the sharded step, diagnostics, energy
and frame, and the replicated-tree Barnes-Hut, on a mesh of P shards held
in one process (``LocalMesh``) or one per ``torch.distributed`` rank
(``ProcessGroupMesh``)."""

from nbody_simulation_tpu_torch.parallel.bh_sharded import (
    bh_sharded_accel, make_sharded_bh_step)
from nbody_simulation_tpu_torch.parallel.mesh import (LocalMesh,
                                                      ProcessGroupMesh,
                                                      make_1d_mesh,
                                                      shard_state)
from nbody_simulation_tpu_torch.parallel.multihost import init_distributed
from nbody_simulation_tpu_torch.parallel.raster import sharded_render_frame
from nbody_simulation_tpu_torch.parallel.ring import (
    ring_allpairs_accel, ring_allpairs_accel_symring)
from nbody_simulation_tpu_torch.parallel.ring_grad import (
    ring_allpairs_accel_diff)
from nbody_simulation_tpu_torch.parallel.sharded_step import (
    make_sharded_step, sharded_diagnostics, sharded_total_energy)

__all__ = ["LocalMesh", "ProcessGroupMesh", "init_distributed",
           "make_1d_mesh", "shard_state", "ring_allpairs_accel",
           "ring_allpairs_accel_symring", "ring_allpairs_accel_diff",
           "make_sharded_step", "sharded_diagnostics",
           "sharded_total_energy", "bh_sharded_accel",
           "make_sharded_bh_step", "sharded_render_frame"]
