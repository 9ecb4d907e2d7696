"""The engine over a distributed state.

The port of ``nbody_simulation_tpu/runtime/distributed.py``:

- ``DistributedWorld``: the World-shaped driver of the distributed
  Barnes-Hut step (step, run, step_timed, reconfigure, assert_finite,
  diagnostics), plus the collective rebalance on its cadence and the
  seam stages rescheduled when a rebalance changes them.
- ``DistributedEngine``: the Engine whose snapshots are the sharded raster
  merge (``parallel.sharded_render_frame``): only the finished frame
  leaves the mesh.
- ``save_distributed_checkpoint`` / ``load_distributed_checkpoint``: the
  live rows in global Morton order, in the single-device file format, so a
  run resumes on any mesh.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import _sync
from nbody_simulation_tpu_torch.parallel.bh_distributed import (
    adjacency_stages, distribute_state, live_rows, make_distributed_bh_step,
    resolved_seam_stages)
from nbody_simulation_tpu_torch.parallel.mesh import (Mesh, ProcessGroupMesh,
                                                      split_shards)
from nbody_simulation_tpu_torch.parallel.raster import sharded_render_frame
from nbody_simulation_tpu_torch.parallel.repartition import (
    make_collective_rebalance)
from nbody_simulation_tpu_torch.parallel.sharded_step import (
    sharded_diagnostics)
from nbody_simulation_tpu_torch.runtime.engine import Engine, Snapshot
from nbody_simulation_tpu_torch.state import ParticleState
from nbody_simulation_tpu_torch.utils.telemetry import Counting, PhaseTimer


class DistributedWorld:
    """World-shaped driver of a distributed state on a mesh."""

    def __init__(self, state: ParticleState, mesh: Mesh, config: SimConfig,
                 rebalance_every: int = 0):
        if not state.distributed:
            raise ValueError("DistributedWorld expects a distribute_state "
                             "layout")
        self.mesh = mesh
        self.config = config
        self.state = state
        self.updates = 0
        self.rebalance_every = rebalance_every
        self._rebalance = (make_collective_rebalance(mesh, config)
                           if rebalance_every else None)
        self._build_step()

    def _build_step(self) -> None:
        self._extra = (adjacency_stages(self.state, self.mesh, self.config)
                       if resolved_seam_stages(self.config) else ())
        self._step = make_distributed_bh_step(self.mesh, self.config,
                                              extra_pairs=self._extra)

    def step(self) -> None:
        self.state = self._step(self.state)
        self.updates += 1
        if self.rebalance_every and self.updates % self.rebalance_every == 0:
            self.state = self._rebalance(self.state)
            if resolved_seam_stages(self.config):
                extra = adjacency_stages(self.state, self.mesh, self.config)
                if extra != self._extra:
                    # The seams moved: a step with the new matchings, whose
                    # cadence starts at a re-sort.
                    self._extra = extra
                    self._step = make_distributed_bh_step(
                        self.mesh, self.config, extra_pairs=extra)
                    return
            self._step.reset()

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()

    def step_timed(self, counting: Counting) -> None:
        """One synchronised, timed step. The distributed step has no
        separate phases to time without extra synchronisation, so the
        whole step lands in ``sum_gravity``."""
        _sync(self.state.device)
        with PhaseTimer(counting, "sum_gravity"):
            self.step()
            _sync(self.state.device)

    def reconfigure(self, **changes) -> None:
        self.config = self.config.replace(**changes)
        if self.rebalance_every:
            self._rebalance = make_collective_rebalance(self.mesh,
                                                        self.config)
        self._build_step()

    def assert_finite(self) -> None:
        """Raise on non-finite positions on any shard (every rank agrees)."""
        bad = self.mesh.psum(torch.stack([
            (~torch.isfinite(p)).sum(dtype=torch.int64)
            for p in split_shards(self.mesh, self.state.pos)]))
        if bool(bad):
            raise FloatingPointError(
                f"non-finite positions at step {self.updates}")

    def diagnostics(self) -> dict:
        return sharded_diagnostics(self.state, self.mesh)


class DistributedEngine(Engine):
    """Engine whose snapshots come from the sharded raster merge."""

    def __init__(self, world: DistributedWorld, **kw):
        if kw.get("include_particles"):
            raise ValueError(
                "include_particles would ship every particle through each "
                "snapshot; a distributed run records per process instead")
        super().__init__(world, **kw)
        # The render is a collective: on a mesh of several processes every
        # rank must render at the same batches.
        self._multiprocess = isinstance(world.mesh, ProcessGroupMesh)

    def _snapshot_due(self, now: float, paused: bool) -> bool:
        # The default gate (queue room, wall clock) is local to a process;
        # several processes render at every batch boundary instead.
        if self._multiprocess:
            return not paused
        return super()._snapshot_due(now, paused)

    def _snapshot(self) -> None:
        # Synchronous, with nothing left in flight: the render is a
        # collective that every rank enters at the same batch.
        self.queue.try_push(self._render_snapshot())

    def _render_snapshot(self) -> bytes:
        w: DistributedWorld = self.world
        cfg = w.config
        frame = sharded_render_frame(
            w.state.pos, w.state.vel, w.state.mass, w.mesh,
            world_size=cfg.world_size, render_size=cfg.render_size,
            heavy_weight=cfg.heavy_weight).cpu().numpy()
        return Snapshot(w.updates, self.counting.copy(), frame, None).pack()


def save_distributed_checkpoint(path, world: DistributedWorld) -> None:
    """Save the live rows in global Morton order in the single-device
    checkpoint format (``utils.checkpoint``); on several processes rank 0
    writes."""
    from nbody_simulation_tpu_torch.utils.checkpoint import save_checkpoint
    state = live_rows(world.state, world.mesh)
    if world.mesh.shard_ids[0] == 0:
        save_checkpoint(path, state, world.updates)


def load_distributed_checkpoint(path, mesh: Mesh, config: SimConfig):
    """Load a checkpoint (single-device or distributed) and distribute it
    over ``mesh``. Returns ``(state, step)``."""
    from nbody_simulation_tpu_torch.utils.checkpoint import load_checkpoint
    state, step = load_checkpoint(path)
    return distribute_state(state, mesh, config), step
