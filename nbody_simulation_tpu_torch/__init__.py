"""nbody_simulation_tpu_torch — the N-body engine on PyTorch and CUDA.

A port of ``nbody_simulation_tpu`` (JAX on a TPU) to one NVIDIA H100. The
JAX package stays the reference; this package imports neither JAX nor it.
The Barnes-Hut galaxy path runs here: Morton sort, tree summaries and the
planner in plain PyTorch, the grouped force sweep in a hand-written CUDA
kernel (``csrc/grouped_sweep.cu``), the splat raster, the engine and the
CLI (``python -m nbody_simulation_tpu_torch.run``). So do the exact
all-pairs path (``csrc/allpairs.cu``: ordered and symmetric kernels), the
energy diagnostic (K6, also in ``csrc/allpairs.cu``), the differentiable
forces, and the sharded paths of ``parallel/`` (the ring with the
cross-shard symmetric kernel K9, on P shards in one process or one per
``torch.distributed`` rank).
"""

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.state import (ParticleState, state_from_numpy,
                                              state_to_numpy)

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "state_from_numpy",
           "state_to_numpy", "__version__"]
