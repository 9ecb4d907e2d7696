from nbody_simulation_tpu_torch.ops.allpairs import (allpairs_accel,
                                                     allpairs_accel_sym)
from nbody_simulation_tpu_torch.ops.allpairs_grad import allpairs_accel_diff
from nbody_simulation_tpu_torch.ops.energy import (allpairs_potential,
                                                   bh_total_energy,
                                                   kinetic_energy,
                                                   potential_energy,
                                                   total_energy)
from nbody_simulation_tpu_torch.ops.force import (FLT_MIN_NORMAL, direct_accel,
                                                  direct_accel_at, pair_accel)
from nbody_simulation_tpu_torch.ops.integrate import euler_step, leapfrog_step
from nbody_simulation_tpu_torch.ops.morton import (morton_order,
                                                   morton_sort_state)
from nbody_simulation_tpu_torch.ops.raster import (render_frame,
                                                   render_frame_sparse)
from nbody_simulation_tpu_torch.ops.traversal import (bh_accel,
                                                      bh_accel_sorted,
                                                      grouped_force)
from nbody_simulation_tpu_torch.ops.tree import build_tree, summarize_sorted

__all__ = [
    "FLT_MIN_NORMAL",
    "pair_accel",
    "direct_accel",
    "direct_accel_at",
    "allpairs_accel",
    "allpairs_accel_sym",
    "allpairs_accel_diff",
    "allpairs_potential",
    "bh_total_energy",
    "kinetic_energy",
    "potential_energy",
    "total_energy",
    "euler_step",
    "leapfrog_step",
    "morton_order",
    "morton_sort_state",
    "build_tree",
    "summarize_sorted",
    "bh_accel",
    "bh_accel_sorted",
    "grouped_force",
    "render_frame",
    "render_frame_sparse",
]
