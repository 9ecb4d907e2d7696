"""Telemetry: per-phase counters and ups/fps meters.

The reference accumulates wall seconds for its three step phases in
``Counting {build_bvh, sum_gravity, post_calculations}`` (reference
src/main.rs:74-79, :402, :417, :424) and prints fps/ups/step/counters once
per second from the render loop (src/main.rs:148-156). Same semantics here:
``ups`` counts simulation steps, ``fps`` counts frames presented; they are
decoupled because the sim and render loops are.

The three phases only have distinct wall times when the step runs in
profile mode (``World.step_timed``: each phase ends in a device
synchronise); the fast path reports zeros.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Counting:
    build_bvh: float = 0.0
    sum_gravity: float = 0.0
    post_calculations: float = 0.0

    def copy(self) -> "Counting":
        return Counting(self.build_bvh, self.sum_gravity, self.post_calculations)

    def __repr__(self) -> str:  # mirrors Rust's {:?} print shape
        return (f"Counting {{ build_bvh: {self.build_bvh}, "
                f"sum_gravity: {self.sum_gravity}, "
                f"post_calculations: {self.post_calculations} }}")


@dataclasses.dataclass
class StepGraphCounts:
    """How a ``World``'s steps ran: ``replayed`` as one CUDA graph launch
    each, or ``eager``, op by op (every step off the Barnes-Hut path or off
    the card, every profiled step, and each graph's first step); the graphs
    ``captured`` and the host seconds their captures took."""
    replayed: int = 0
    eager: int = 0
    captured: int = 0
    capture_s: float = 0.0

    @property
    def replay_share(self) -> float:
        steps = self.replayed + self.eager
        return self.replayed / steps if steps else 0.0


@dataclasses.dataclass
class SnapshotCounts:
    """How an ``Engine`` finished its snapshots: ``overlapped``, after the
    next batch's steps were enqueued, so that the host rebuilt the frame
    while the card ran them; ``flushed``, at a pause, a reconfigure, the
    end or a stop; the host seconds ``wait_s`` blocked on a snapshot's copy
    and ``pack_s`` rebuilding and packing frames."""
    overlapped: int = 0
    flushed: int = 0
    wait_s: float = 0.0
    pack_s: float = 0.0


class PhaseTimer:
    """Context-manager accumulator: ``with timer(counting, 'build_bvh'): ...``"""

    def __init__(self, counting: Counting, phase: str):
        self.counting = counting
        self.phase = phase

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        setattr(self.counting, self.phase,
                getattr(self.counting, self.phase)
                + (time.perf_counter() - self._t0))
        return False


class trace:
    """torch.profiler trace hook: ``with trace("/tmp/tb"): world.run(10)``.

    Writes one Chrome trace (``*.pt.trace.json``, which TensorBoard's
    profiler plugin and chrome://tracing read) into ``log_dir`` when the
    block ends: the host's operations and, where CUDA is available, the
    card's kernels. The counterpart of the JAX package's ``jax.profiler``
    hook; like it, a no-op if the profiler cannot start."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts, on_trace_ready=(
                tensorboard_trace_handler(str(self.log_dir))))
            prof.__enter__()
            self._prof = prof
        except Exception:
            self._prof = None
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        return False


class EnergyMeter:
    """Cadence total-energy telemetry for the Engine's ``on_batch`` hook.

    Every ``every`` steps it evaluates E = KE + U under the conservative
    counterpart law (ops/energy.py) and prints the drift relative to the
    first sample, in the JAX package's format. ``method`` is "exact" (the
    O(N²/2) pair sweep, kernel K6 on the card) or "bh" (the O(N·C)
    Barnes-Hut planned approximation). On a world with a ``mesh`` (a
    ``runtime.distributed.DistributedWorld``) "bh" is
    ``parallel.bh_distributed_total_energy`` with the world's seam stages,
    O(N·C/P) per shard, and "exact" the ring of the potential kernel
    (``parallel.sharded_total_energy``), O(N²/P). Samples are kept in
    ``samples`` as (step, energy), and the potential part of each in
    ``potentials`` as (step, U): on the galaxy E is almost all kinetic, so
    only U itself shows the pair sweep's accuracy. U is read back after E,
    whose readback has already waited for the device.
    """

    def __init__(self, every: int, emit=print, softening2: float = 1e-3,
                 method: str = "exact"):
        if method not in ("exact", "bh"):
            raise ValueError(f"method must be 'exact' or 'bh', got {method!r}")
        self.every = max(1, every)
        self.emit = emit
        self.softening2 = softening2
        self.method = method
        self.e0: float | None = None
        self.samples: list[tuple[int, float]] = []
        self.potentials: list[tuple[int, float]] = []
        self._last = None

    def __call__(self, world) -> None:
        step = world.updates
        if self._last is not None and step - self._last < self.every:
            return
        self._last = step
        st = world.state
        if getattr(world, "mesh", None) is not None:
            from nbody_simulation_tpu_torch.parallel import (
                bh_distributed_total_energy, sharded_total_energy)
            if self.method == "bh":
                parts = bh_distributed_total_energy(
                    st, world.mesh, world.config,
                    extra_pairs=getattr(world, "_extra", ()))
            else:
                parts = sharded_total_energy(st, world.mesh,
                                             softening2=self.softening2)
            e, u = parts["total_energy"], parts["potential_energy"]
        else:
            from nbody_simulation_tpu_torch.ops import energy
            if self.method == "bh":
                u = energy.bh_potential_energy(st, world.config)
                e = energy.kinetic_energy(st.vel, st.mass) + u
            else:
                ke = energy.kinetic_energy(st.vel, st.mass)
                u = energy.potential_energy(st.pos, st.mass,
                                            softening2=self.softening2)
                e = ke + u
        e, u = float(e), float(u)
        if self.e0 is None:
            self.e0 = e
        drift = abs(e - self.e0) / max(abs(self.e0), 1e-30)
        self.samples.append((step, e))
        self.potentials.append((step, u))
        self.emit(f"energy: step {step} E={e:.6e} |dE/E0|={drift:.3e}")


class RateMeter:
    """Once-per-second fps/ups printer (src/main.rs:148-156 semantics)."""

    def __init__(self, emit=print, interval: float = 1.0):
        self.emit = emit
        self.interval = interval
        self.frames = 0
        self.last_updates = 0
        self._t0 = time.perf_counter()

    def frame(self, updates: int, counting: Counting | None = None,
              graphs: StepGraphCounts | None = None) -> None:
        self.frames += 1
        now = time.perf_counter()
        if now - self._t0 >= self.interval:
            self.emit(f"fps: {self.frames}\nups: {updates - self.last_updates}")
            self.emit(f"step: {updates}")
            if counting is not None:
                self.emit(repr(counting))
            if graphs is not None:
                self.emit(f"replayed: {graphs.replay_share:.1%} of "
                          f"{graphs.replayed + graphs.eager} steps, "
                          f"{graphs.captured} graphs captured in "
                          f"{graphs.capture_s:.3f} s")
            self.frames = 0
            self.last_updates = updates
            self._t0 = now
