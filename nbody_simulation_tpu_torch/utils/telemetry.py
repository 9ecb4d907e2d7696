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


class RateMeter:
    """Once-per-second fps/ups printer (src/main.rs:148-156 semantics)."""

    def __init__(self, emit=print, interval: float = 1.0):
        self.emit = emit
        self.interval = interval
        self.frames = 0
        self.last_updates = 0
        self._t0 = time.perf_counter()

    def frame(self, updates: int, counting: Counting | None = None) -> None:
        self.frames += 1
        now = time.perf_counter()
        if now - self._t0 >= self.interval:
            self.emit(f"fps: {self.frames}\nups: {updates - self.last_updates}")
            self.emit(f"step: {updates}")
            if counting is not None:
                self.emit(repr(counting))
            self.frames = 0
            self.last_updates = updates
            self._t0 = now
