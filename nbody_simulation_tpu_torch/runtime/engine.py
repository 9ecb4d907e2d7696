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

One snapshot is in flight at a time. At a batch end the producer only
enqueues it: the raster, a copy of its output (and of the positions, with
``include_particles``) into host buffers, pinned on a card, and an event
after the copy. It then enqueues the next batch's steps, and only after
that waits on the event and rebuilds, packs and pushes the frame, so the
host does that work while the card runs the next steps. A pause, a
reconfigure, the end and a stop finish the snapshot in flight before they
act. On the CPU the copy is complete when it is made and the same loop
runs.

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
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops.raster import (render_frame,
                                                   render_frame_sparse,
                                                   sparse_to_frame)
from nbody_simulation_tpu_torch.runtime.queue import SnapshotQueue
from nbody_simulation_tpu_torch.utils.telemetry import (Counting,
                                                        SnapshotCounts)

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


@dataclass
class _InFlight:
    """A snapshot enqueued on the device: the step and phase seconds at its
    batch end, the host buffers its copy fills (sparse ``idx, vals`` or the
    dense frame, then the positions with ``include_particles``) and the
    event after that copy (None on the CPU)."""
    step: int
    counting: Counting
    render_size: int
    sparse: bool
    host: list
    event: object


class Engine:
    """Physics thread + lossy snapshot queue around a World."""

    def __init__(self, world: World, queue_depth: int = 2,
                 steps_per_snapshot: int = 1, include_particles: bool = False,
                 nan_check_every: int = 0, snapshot_interval: float = 0.25,
                 profile_every: int = 50, on_batch=None):
        """``snapshot_interval``: minimum seconds between rendered snapshots.
        The reference gets ups≫fps for free (render on its own thread); here
        the frame's rebuild and packing share the producer thread (see
        _finish_snapshot), so the interval bounds how much of the host's
        time rendering can take. 0 = render whenever the queue has room,
        exactly flume-style.

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
        self.snapshot_counts = SnapshotCounts()
        self._in_flight: _InFlight | None = None
        self._host: list | None = None  # the buffers a snapshot's copy fills
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
    def _snapshot(self) -> None:
        """Enqueue the current state's snapshot without waiting for the
        device: the render, then the copy of its output into the host
        buffers and an event after it. ``_finish_snapshot`` waits, packs
        and pushes it. The sparse encoding keeps the copy proportional to
        lit pixels instead of the full framebuffer (ops/raster.py)."""
        cfg = self.world.config
        st = self.world.state
        npix = cfg.render_size * cfg.render_size
        cap = min(-(-st.n_real // 128) * 128, npix)
        sparse = cap * 8 < npix * 4
        if sparse:
            out = render_frame_sparse(
                st.pos, st.vel, st.mass, cap=cap, world_size=cfg.world_size,
                render_size=cfg.render_size, heavy_weight=cfg.heavy_weight)
        else:
            out = (render_frame(
                st.pos, st.vel, st.mass, world_size=cfg.world_size,
                render_size=cfg.render_size,
                heavy_weight=cfg.heavy_weight),)
        if self.include_particles:
            out += (st.pos[:st.n_real],)
        card = st.pos.device.type == "cuda"
        if self._host is None or [(h.shape, h.dtype) for h in self._host] \
                != [(t.shape, t.dtype) for t in out]:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=card)
                          for t in out]
        for h, t in zip(self._host, out):
            h.copy_(t, non_blocking=card)
        event = None
        if card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(st.pos.device))
        self._in_flight = _InFlight(self.world.updates, self.counting.copy(),
                                    cfg.render_size, sparse, self._host,
                                    event)

    def _finish_snapshot(self, overlapped: bool = False) -> None:
        """Wait for the snapshot in flight, if there is one, rebuild and
        pack its frame on the host and push it. ``overlapped``: the next
        batch's steps were enqueued first. The host buffers are read here,
        before the next ``_snapshot`` fills them again."""
        snap, self._in_flight = self._in_flight, None
        if snap is None:
            return
        t0 = time.perf_counter()
        if snap.event is not None:
            snap.event.synchronize()
        t1 = time.perf_counter()
        if snap.sparse:
            frame = sparse_to_frame(snap.host[0], snap.host[1],
                                    snap.render_size)
        else:
            frame = snap.host[0].numpy()
        pos = snap.host[-1].numpy() if self.include_particles else None
        data = Snapshot(snap.step, snap.counting, frame, pos).pack()
        counts = self.snapshot_counts
        counts.wait_s += t1 - t0
        counts.pack_s += time.perf_counter() - t1
        if overlapped:
            counts.overlapped += 1
        else:
            counts.flushed += 1
        self.queue.try_push(data)

    def _snapshot_due(self, now: float, paused: bool) -> bool:
        """Whether the producer should render a snapshot this batch.

        The default gate is LOCAL and nondeterministic (queue fullness +
        wall clock) — exactly the reference's lossy try_send economics
        (src/main.rs:136-139). A snapshot in flight holds the slot it will
        take.
        """
        interval = (max(self.snapshot_interval, 0.1) if paused
                    else self.snapshot_interval)
        held = len(self.queue) + (self._in_flight is not None)
        return (held < self.queue.capacity
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
                paused = (self._paused.is_set()
                          and not self._step_once.is_set())
                if pending or paused:
                    # The snapshot in flight goes out before either acts.
                    self._finish_snapshot()
                if pending:
                    old_rs = self.world.config.render_size
                    self.world.reconfigure(**pending)
                    if self.world.config.render_size != old_rs:
                        self._rebuild_queue()
                if paused:
                    # Paused: keep serving the current frame, burn no steps.
                    now = time.monotonic()
                    if self._snapshot_due(now, paused=True):
                        self._snapshot()
                        self._finish_snapshot()
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
                # The last batch's snapshot, while the card runs this one.
                self._finish_snapshot(overlapped=True)
                if (self.nan_check_every
                        and self.world.updates % self.nan_check_every == 0):
                    self.world.assert_finite()  # raises → surfaced by stop()
                if self.on_batch is not None:
                    self.on_batch(self.world)
                now = time.monotonic()
                if self._snapshot_due(now, paused=False):
                    self._snapshot()
                    self._last_snap_t = now
        except BaseException as e:  # surfaced via .error / stop()
            self._error = e
        finally:
            try:
                self._finish_snapshot()
                if self._error is None:
                    # Push the END state so a bounded run's last frame is
                    # the final step, not whatever the lossy cadence last
                    # caught (the reference never ends, so it never has
                    # this problem). try_push is lossy — if the consumer
                    # left the queue full, drop the OLDEST queued frame to
                    # make room: the end state must win over a stale
                    # intermediate.
                    if self.queue.is_full():
                        self.queue.pop(0.0)
                    self._snapshot()
                    self._finish_snapshot()
            except Exception as e:  # surfaced by stop()
                if self._error is None:
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
    def pushed(self) -> int:
        return self._counts_base[0] + self.queue.pushed

    @property
    def dropped(self) -> int:
        return self._counts_base[1] + self.queue.dropped
