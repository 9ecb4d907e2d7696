from nbody_simulation_tpu_torch.models.scenarios import (collision, galaxy,
                                                         plummer, uniform_disc)
from nbody_simulation_tpu_torch.models.world import World

__all__ = ["galaxy", "uniform_disc", "plummer", "collision", "World"]
