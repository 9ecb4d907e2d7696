"""Control bus: the viewer's input applied at one step barrier everywhere.

The port of the JAX package's ``runtime/control.py``. The reference window
is always interactive (reference src/main.rs:168-182). On a run of several
processes a control applied to process 0's engine alone would desynchronise
the collectives, so applying a control is itself made a collective:

- the viewer (process 0 only) never touches the engine; it submits the
  user's intent to the bus (sequence-stamped, under a lock, from an HTTP
  thread);
- every process's producer thread polls the bus once per loop iteration
  (the engine's ``control_poll`` hook): one ``torch.distributed.broadcast``
  of rank 0's intent vector over the default group, which every process
  joins at the same iteration, so all of them apply the same change before
  the same batch;
- lockstep maintains itself: the broadcast blocks until every process
  arrives, and every change of state (pause, resume, step, reconfigure,
  quit) comes out of the same broadcast, so the loops, the paused wait
  included, stay identical everywhere.

The intent crosses processes as an int32[8] vector (seq, flags, step_seq,
render_size, and θ and dt as the two int32 halves of their f64 bits,
exact). A single-process bus skips the collective, so the viewer runs the
same code at P=1.
"""

from __future__ import annotations

import threading

import numpy as np

_FLAG_PAUSE = 1
_FLAG_QUIT = 2


def _pack_f64(v: float) -> tuple[int, int]:
    w = np.frombuffer(np.float64(v).tobytes(), np.int32)
    return int(w[0]), int(w[1])


def _unpack_f64(lo: int, hi: int) -> float:
    return float(np.frombuffer(np.array([lo, hi], np.int32).tobytes(),
                               np.float64)[0])


def _broadcast_from_rank0(vec: np.ndarray) -> np.ndarray:
    """Rank 0's int32[8] vector on every rank of the default group (gloo
    and NCCL alike: the tensor goes on the backend's device)."""
    import torch
    import torch.distributed as dist

    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.from_numpy(vec).to(device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


class ControlBus:
    """Control channel from process 0's viewer to every process's engine.
    Construct it on every process (the poll is a collective); submit on
    process 0 only (only rank 0's vector is broadcast)."""

    def __init__(self, theta: float, dt: float, render_size: int,
                 multiprocess: bool | None = None):
        self._lock = threading.Lock()
        self._seq = 0
        self._pause = False
        self._quit = False
        self._step_seq = 0
        self._theta = float(theta)
        self._dt = float(dt)
        self._render_size = int(render_size)
        self._applied_seq = 0
        self._applied_step_seq = 0
        if multiprocess is None:
            import torch.distributed as dist
            multiprocess = (dist.is_available() and dist.is_initialized()
                            and dist.get_world_size() > 1)
        self._multiprocess = multiprocess

    # -- viewer side (process 0, any thread) --------------------------------
    def submit(self, cmd: str | None = None, **changes) -> None:
        """Record a control intent. ``cmd`` ∈ pause|resume|toggle|step|quit;
        ``changes`` may carry validated theta/dt/render_size. The bus's
        pause flag is authoritative (engines start unpaused and so does the
        bus), so toggle is a plain flip."""
        with self._lock:
            if cmd == "pause":
                self._pause = True
            elif cmd == "resume":
                self._pause = False
            elif cmd == "toggle":
                self._pause = not self._pause
            elif cmd == "step":
                self._step_seq += 1
            elif cmd == "quit":
                self._quit = True
            if "theta" in changes:
                self._theta = float(changes["theta"])
            if "dt" in changes:
                self._dt = float(changes["dt"])
            if "render_size" in changes:
                self._render_size = int(changes["render_size"])
            self._seq += 1

    def _vector(self) -> np.ndarray:
        with self._lock:
            flags = ((_FLAG_PAUSE if self._pause else 0)
                     | (_FLAG_QUIT if self._quit else 0))
            t_lo, t_hi = _pack_f64(self._theta)
            d_lo, d_hi = _pack_f64(self._dt)
            return np.array([self._seq, flags, self._step_seq,
                             self._render_size, t_lo, t_hi, d_lo, d_hi],
                            np.int32)

    # -- engine side (every process, producer thread) -----------------------
    def poll(self, engine) -> None:
        """One broadcast of rank 0's intent; apply what changed to THIS
        process's engine. Called from ``engine.control_poll`` on every loop
        iteration: equal iteration counts on every process keep the
        collective matched."""
        vec = self._vector()
        if self._multiprocess:
            vec = _broadcast_from_rank0(vec)
        seq = int(vec[0])
        if seq == self._applied_seq:
            return
        self._applied_seq = seq
        flags = int(vec[1])
        if flags & _FLAG_QUIT:
            engine._stop.set()
            return
        if flags & _FLAG_PAUSE:
            engine.pause()
        else:
            engine.resume()
        step_seq = int(vec[2])
        if step_seq != self._applied_step_seq:
            self._applied_step_seq = step_seq
            engine.step_once()
        cfg = engine.world.config
        changes = {}
        theta = _unpack_f64(int(vec[4]), int(vec[5]))
        dt = _unpack_f64(int(vec[6]), int(vec[7]))
        rs = int(vec[3])
        if theta != cfg.theta:
            changes["theta"] = theta
        if dt != cfg.dt:
            changes["dt"] = dt
        if rs != cfg.render_size:
            changes["render_size"] = rs
        if changes:
            engine.reconfigure(**changes)
