from nbody_simulation_tpu_torch.viz.server import ViewerServer

__all__ = ["ViewerServer"]
