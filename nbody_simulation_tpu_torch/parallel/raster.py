"""The frame of a sharded state: per-shard pixel reductions, one merge.

The port of ``sharded_render_frame`` from ``nbody_simulation_tpu/parallel/
raster.py``. The splat raster (``ops/raster.py``) reduces the reference's
sequential draw to per-pixel quantities that merge across shards: whether
a heavy particle hit (``pmax``), how many light ones did (``psum``), and
the last light hit in the order of the concatenated global array, found by
offsetting each shard's local index by ``shard·L`` and taking the
``pmax``; the winner's tint is a masked ``psum``, since global indices are
unique. The frame is pixel for pixel the single-device frame of the
concatenated arrays (tests/test_torch_ring.py).

``simulate_distributed`` is the plain loop over a distributed run: steps,
a frame every so many, and the collective rebalance on its cadence.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.ops.raster import (accumulate_pixels,
                                                   colorize_pixels)
from nbody_simulation_tpu_torch.parallel.mesh import Mesh, split_shards


def sharded_render_frame(pos: torch.Tensor, vel: torch.Tensor,
                         mass: torch.Tensor, mesh: Mesh,
                         world_size: float = 100_000.0,
                         render_size: int = 1250,
                         heavy_weight: float = 10.0) -> torch.Tensor:
    """RGBA u8 frame (render_size, render_size, 4) of a sharded state, the
    same on every rank. Zero-mass padding sits outside the world and
    renders nowhere."""
    n_l = pos.shape[0] // mesh.n_local
    parts = [accumulate_pixels(p, v, m, world_size, render_size,
                               heavy_weight)
             for p, v, m in zip(*(split_shards(mesh, a)
                                  for a in (pos, vel, mass)))]
    green_l, count_l, last_l, vlast_l = (torch.stack(x) for x in zip(*parts))
    offset = (mesh.axis_index().to(torch.int32) * n_l)[:, None]
    glast_l = torch.where(last_l >= 0, last_l + offset,
                          torch.full((), -1, dtype=torch.int32,
                                     device=pos.device))
    green = mesh.pmax(green_l)
    count = mesh.psum(count_l)
    glast = mesh.pmax(glast_l)
    mine = (glast >= 0) & (glast_l == glast)
    vlast = mesh.psum(torch.where(mine, vlast_l, torch.zeros_like(vlast_l)))
    return colorize_pixels(green, count, vlast, render_size)


def simulate_distributed(state, mesh: Mesh, config, steps: int,
                         snapshot_every: int = 0, on_frame=None,
                         rebalance_every: int = 0):
    """Step a distributed ``state`` ``steps`` times in a
    ``runtime.distributed.DistributedWorld`` (its rebalance cadence and
    seam stages included), calling ``on_frame(step, rgba numpy)`` with the
    sharded frame every ``snapshot_every`` steps. For the whole runtime
    (queue, telemetry, viewer) use ``runtime.distributed.DistributedEngine``.
    Returns the final state."""
    from nbody_simulation_tpu_torch.runtime.distributed import (
        DistributedWorld)

    world = DistributedWorld(state, mesh, config,
                             rebalance_every=rebalance_every)
    for i in range(1, steps + 1):
        world.step()
        if snapshot_every and on_frame and i % snapshot_every == 0:
            frame = sharded_render_frame(
                world.state.pos, world.state.vel, world.state.mass, mesh,
                world_size=config.world_size,
                render_size=config.render_size,
                heavy_weight=config.heavy_weight)
            on_frame(i, frame.cpu().numpy())
    return world.state
