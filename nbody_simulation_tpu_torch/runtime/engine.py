"""The two-stage sim→render pipeline.

The reference spawns a physics thread running an unbounded step loop and
ships full particle-vector snapshots through a depth-2 lossy channel to the
winit render thread (reference src/main.rs:101-184). Here the simulation AND
the rasterization run on the state's device; only the finished RGBA
framebuffer (sparse: lit pixels only) crosses to the host, where the physics
thread pushes it into the native lossy SnapshotQueue and any consumer (PNG
dumper, test) pops at its own pace. A full queue skips the render+readback
entirely — the same backpressure the reference gets from `!tx.is_full()`
(src/main.rs:136-139), but saving the render work as well.

Snapshot wire format (little-endian), the JAX package's:
  u64 step | f64 build_bvh | f64 sum_gravity | f64 post_calculations |
  u32 height | u32 width | u32 n_particles | RGBA8 frame bytes |
  [f32 pos (n,2) if n_particles > 0]

Thread use: the producer thread owns ``world``; consumers read snapshots
only. Everything a consumer needs is in the snapshot, fetched on the
producer thread between steps.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops.raster import (render_frame,
                                                   render_frame_sparse,
                                                   sparse_to_frame)
from nbody_simulation_tpu_torch.runtime.queue import SnapshotQueue
from nbody_simulation_tpu_torch.utils.telemetry import Counting

_HDR = struct.Struct("<Qdddiii")


@dataclass
class Snapshot:
    step: int
    counting: Counting
    frame: np.ndarray  # (H, W, 4) uint8
    pos: np.ndarray | None = None  # (n, 2) f32, only with include_particles

    def pack(self) -> bytes:
        h, w = self.frame.shape[:2]
        n = 0 if self.pos is None else self.pos.shape[0]
        out = _HDR.pack(self.step, self.counting.build_bvh,
                        self.counting.sum_gravity,
                        self.counting.post_calculations, h, w, n) + \
            self.frame.tobytes()
        if n:
            out += np.ascontiguousarray(self.pos, np.float32).tobytes()
        return out

    @classmethod
    def unpack(cls, data: bytes) -> "Snapshot":
        step, b, s, p, h, w, n = _HDR.unpack_from(data)
        frame = np.frombuffer(data, np.uint8, h * w * 4,
                              offset=_HDR.size).reshape(h, w, 4)
        pos = None
        if n:
            pos = np.frombuffer(data, np.float32, n * 2,
                                offset=_HDR.size + h * w * 4).reshape(n, 2)
        return cls(step, Counting(b, s, p), frame, pos)


class Engine:
    """Physics thread + lossy snapshot queue around a World."""

    def __init__(self, world: World, queue_depth: int = 2,
                 steps_per_snapshot: int = 1, include_particles: bool = False,
                 nan_check_every: int = 0, snapshot_interval: float = 0.25,
                 profile_every: int = 50, on_batch=None):
        """``snapshot_interval``: minimum seconds between rendered snapshots.
        The reference gets ups≫fps for free (render on its own thread); here
        the frame readback shares the producer thread (see _render_snapshot),
        so the interval bounds how much of the step budget rendering can
        take. 0 = render whenever the queue has room, exactly flume-style.

        ``profile_every``: every k-th batch, one step runs in profile mode
        (``World.step_timed``: a device sync after each phase) so the
        Counting phase seconds in snapshots are real, like the reference's
        per-phase Instant timers (src/main.rs:74-79). 0 disables (fast steps
        report zeros). Counting is cumulative wall time, as in the
        reference.

        ``nan_check_every``: every k steps, ``World.assert_finite`` on the
        producer thread; a divergence stops the engine and ``stop()``
        raises it. 0 disables.

        ``on_batch``: optional callable ``f(world)`` called on the producer
        thread after every step batch, the one place ``world.state`` may be
        read while the engine runs (``utils/telemetry.EnergyMeter``)."""
        self.world = world
        self.on_batch = on_batch
        self.include_particles = include_particles
        self.nan_check_every = nan_check_every
        self.snapshot_interval = snapshot_interval
        self.profile_every = profile_every
        self._batches = 0
        self._last_snap_t = 0.0
        cfg: SimConfig = world.config
        slot = _HDR.size + cfg.render_size * cfg.render_size * 4
        if include_particles:
            slot += world.state.n_real * 8
        self.queue = SnapshotQueue(capacity=queue_depth, slot_bytes=slot)
        self._counts_base = (0, 0)  # (pushed, dropped) from retired queues
        self.steps_per_snapshot = steps_per_snapshot
        self.counting = Counting()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # Interactive controls (the reference window's input handling,
        # src/main.rs:168-182, headless-style): pause/resume/single-step and
        # live re-configuration, all applied by the PRODUCER thread at batch
        # boundaries so the world is only ever stepped from one thread.
        self._paused = threading.Event()
        self._step_once = threading.Event()
        self._pending_cfg: dict = {}
        self._cfg_lock = threading.Lock()
        # Optional control hook (runtime/control.ControlBus.poll): called
        # once per loop iteration on the producer thread, before the
        # pending reconfigure. On a run of several processes it is a
        # collective, the one place controls are applied in lockstep.
        self.control_poll = None

    # -- interactive control ----------------------------------------------------
    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def step_once(self) -> None:
        """While paused: run exactly one snapshot batch."""
        self._step_once.set()

    def reconfigure(self, **changes) -> None:
        """Queue SimConfig changes (theta, dt, render_size, ...) for the
        next batch boundary. A ``render_size`` change
        also rebuilds the snapshot queue (slot size depends on the frame),
        the live version of the reference's window-resize handling
        (src/main.rs:176-181)."""
        with self._cfg_lock:
            self._pending_cfg.update(changes)

    def _rebuild_queue(self) -> None:
        """Swap in a queue sized for the new frame; close the old one so
        blocked consumers wake (they re-read ``self.queue`` per pop).
        Producer-thread only. Drop accounting carries across swaps."""
        cfg = self.world.config
        slot = _HDR.size + cfg.render_size * cfg.render_size * 4
        if self.include_particles:
            slot += self.world.state.n_real * 8
        old = self.queue
        self._counts_base = (self._counts_base[0] + old.pushed,
                             self._counts_base[1] + old.dropped)
        self.queue = SnapshotQueue(capacity=old.capacity, slot_bytes=slot)
        old.close()

    # -- producer -------------------------------------------------------------
    def _render_snapshot(self) -> bytes:
        """Render on device, read back, pack. Runs on the producer thread,
        between steps; the sparse encoding keeps the copy proportional to
        lit pixels instead of the full framebuffer (ops/raster.py)."""
        cfg = self.world.config
        st = self.world.state
        npix = cfg.render_size * cfg.render_size
        cap = min(-(-st.n_real // 128) * 128, npix)
        if cap * 8 < npix * 4:
            idx, vals = render_frame_sparse(
                st.pos, st.vel, st.mass, cap=cap, world_size=cfg.world_size,
                render_size=cfg.render_size, heavy_weight=cfg.heavy_weight)
            frame = sparse_to_frame(idx, vals, cfg.render_size)
        else:
            frame = render_frame(
                st.pos, st.vel, st.mass, world_size=cfg.world_size,
                render_size=cfg.render_size,
                heavy_weight=cfg.heavy_weight).cpu().numpy()
        pos = (st.pos[:st.n_real].cpu().numpy()
               if self.include_particles else None)
        return Snapshot(self.world.updates, self.counting.copy(),
                        frame, pos).pack()

    def _snapshot_due(self, now: float, paused: bool) -> bool:
        """Whether the producer should render a snapshot this batch.

        The default gate is LOCAL and nondeterministic (queue fullness +
        wall clock) — exactly the reference's lossy try_send economics
        (src/main.rs:136-139).
        """
        interval = (max(self.snapshot_interval, 0.1) if paused
                    else self.snapshot_interval)
        return (not self.queue.is_full()
                and now - self._last_snap_t >= interval)

    def _physics_loop(self, max_steps: int | None) -> None:
        try:
            while not self._stop.is_set():
                if max_steps is not None and self.world.updates >= max_steps:
                    break
                if self.control_poll is not None:
                    # Every process calls it at the same iteration index;
                    # every change of state that could diverge comes out
                    # of this call, which keeps them in lockstep.
                    self.control_poll(self)
                    if self._stop.is_set():
                        break
                with self._cfg_lock:
                    pending, self._pending_cfg = self._pending_cfg, {}
                if pending:
                    old_rs = self.world.config.render_size
                    self.world.reconfigure(**pending)
                    if self.world.config.render_size != old_rs:
                        self._rebuild_queue()
                if self._paused.is_set() and not self._step_once.is_set():
                    # Paused: keep serving the current frame, burn no steps.
                    now = time.monotonic()
                    if self._snapshot_due(now, paused=True):
                        self.queue.try_push(self._render_snapshot())
                        self._last_snap_t = now
                    self._stop.wait(0.05)
                    continue
                self._step_once.clear()
                batch = self.steps_per_snapshot
                if max_steps is not None:
                    batch = min(batch, max_steps - self.world.updates)
                self._batches += 1
                if self.profile_every and self._batches % self.profile_every == 0:
                    self.world.step_timed(self.counting)
                    batch -= 1
                if batch > 0:
                    self.world.run(batch)
                if (self.nan_check_every
                        and self.world.updates % self.nan_check_every == 0):
                    self.world.assert_finite()  # raises → surfaced by stop()
                if self.on_batch is not None:
                    self.on_batch(self.world)
                now = time.monotonic()
                if self._snapshot_due(now, paused=False):
                    self.queue.try_push(self._render_snapshot())
                    self._last_snap_t = now
        except BaseException as e:  # surfaced via .error / stop()
            self._error = e
        finally:
            if self._error is None:
                # Push the END state so a bounded run's last frame is the
                # final step, not whatever the lossy cadence last caught
                # (the reference never ends, so it never has this problem).
                # try_push is lossy — if the consumer left the queue full,
                # drop the OLDEST queued frame to make room: the end state
                # must win over a stale intermediate.
                try:
                    snap = self._render_snapshot()
                    if self.queue.is_full():
                        self.queue.pop(0.0)
                    self.queue.try_push(snap)
                except Exception as e:  # surfaced by stop()
                    self._error = e
            self.queue.close()

    def start(self, max_steps: int | None = None) -> None:
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(
            target=self._physics_loop, args=(max_steps,),
            name="physics", daemon=True)
        self._thread.start()

    # -- consumer -------------------------------------------------------------
    def next_snapshot(self, timeout: float | None = None) -> Snapshot | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            q = self.queue
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            data = q.pop(left)
            if data is not None:
                return Snapshot.unpack(data)
            if q is self.queue or (deadline is not None
                                   and time.monotonic() >= deadline):
                return None  # genuine timeout / closed-and-drained
            # The queue was swapped (live render_size reconfigure) while we
            # waited and the retired one closed — retry on the new queue
            # with the REMAINING time (not a fresh full timeout).

    def join(self, timeout: float | None = None) -> None:
        """Wait for the physics loop to finish (only with max_steps set)."""
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._error is not None:
            raise self._error

    @property
    def dropped(self) -> int:
        return self._counts_base[1] + self.queue.dropped
