from nbody_simulation_tpu_torch.runtime.engine import Engine
from nbody_simulation_tpu_torch.runtime.queue import SnapshotQueue

__all__ = ["SnapshotQueue", "Engine"]
