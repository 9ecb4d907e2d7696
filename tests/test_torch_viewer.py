"""The port's live viewer and control bus: the counterparts of
``tests/test_viewer.py`` and ``tests/test_control_bus.py``, on the CPU.

The viewer serves frames, stats (with the energy once an ``EnergyMeter``
has sampled), the page and the ``/stream`` push; ``/control`` pauses,
resumes, steps and retunes θ and dt; ``read_only`` answers 409. The bus
carries θ and dt as exact f64 bits, drives an ``Engine`` through its
``control_poll`` hook, and takes the viewer's controls in place of the
engine. Across two gloo ranks every rank applies rank 0's intent in the
same poll.
"""

import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from nbody_simulation_tpu.runtime.control import _pack_f64 as jpack
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models import World, uniform_disc
from nbody_simulation_tpu_torch.runtime.control import (ControlBus,
                                                        _pack_f64, _unpack_f64)
from nbody_simulation_tpu_torch.runtime.engine import Engine
from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter
from nbody_simulation_tpu_torch.viz import ViewerServer

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = Path(__file__).resolve().parents[1]


def _engine(**kw) -> Engine:
    world = World(uniform_disc(256, seed=1),
                  SimConfig(force_path="direct", render_size=64, dt=0.1))
    return Engine(world, snapshot_interval=0.0, **kw)


def _get(base: str, path: str) -> bytes:
    return urllib.request.urlopen(f"{base}{path}", timeout=10).read()


def _stats(base: str) -> dict:
    return json.loads(_get(base, "/stats"))


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached in time")
        time.sleep(0.02)


def test_viewer_serves_frames_and_stats():
    meter = EnergyMeter(10, emit=lambda *_: None)
    engine = _engine(on_batch=meter)
    viewer = ViewerServer(engine, port=0)
    viewer.start()
    engine.start(max_steps=30)
    try:
        engine.join(timeout=60)
        assert not engine._thread.is_alive()
        base = f"http://127.0.0.1:{viewer.port}"
        _until(lambda: _stats(base)["step"] == 30)
        stats = _stats(base)
        assert [s for s, _ in meter.samples] == [1, 11, 21]
        assert stats["energy"]["step"] == 21
        assert stats["energy"]["total"] == meter.samples[-1][1]
        assert stats["energy"]["drift"] >= 0
        assert stats["theta"] == 50.0 and stats["paused"] is False
        png = _get(base, "/frame.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        frame = np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))
        np.testing.assert_array_equal(frame, viewer.latest.frame)
        assert b"nbody_simulation_tpu_torch" in _get(base, "/")
    finally:
        engine.stop()
        viewer.stop()


def test_viewer_controls_and_stream():
    """Pause stops the step counter, step runs one batch, dt retunes live,
    resume restarts, the stream pushes multipart PNG parts, quit ends the
    producer thread."""
    engine = _engine(steps_per_snapshot=2)
    world = engine.world
    viewer = ViewerServer(engine, port=0)
    viewer.start()
    engine.start(max_steps=None)
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        req = urllib.request.urlopen(f"{base}/stream", timeout=30)
        chunk = req.read(200)
        assert b"--frame" in chunk and b"image/png" in chunk
        req.close()

        _get(base, "/control?cmd=pause")
        _until(lambda: _stats(base)["paused"])
        time.sleep(0.3)  # a batch under way when the flag was set ends
        paused_at = world.updates
        time.sleep(0.3)
        assert world.updates == paused_at

        _get(base, "/control?cmd=step")
        _until(lambda: world.updates >= paused_at + 2)
        time.sleep(0.2)
        assert world.updates == paused_at + 2 and engine.paused

        # Out-of-range and malformed values are dropped; valid ones apply.
        _get(base, "/control?dt=0.05&theta=nan&render_size=9")
        _get(base, "/control?dt=-1&theta=x")
        _until(lambda: world.config.dt == 0.05)
        assert world.config.theta == 50.0 and world.config.render_size == 64
        _get(base, "/control?cmd=resume")
        _until(lambda: world.updates > paused_at + 4)

        _get(base, "/control?cmd=quit")
        assert viewer.quit_requested.is_set()
        engine.join(timeout=30)
        assert not engine._thread.is_alive()
    finally:
        engine._stop.set()
        engine.stop()
        viewer.stop()


def test_viewer_read_only_refuses_controls():
    engine = _engine()
    viewer = ViewerServer(engine, port=0, read_only=True)
    viewer.start()
    engine.start(max_steps=10)
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/control?cmd=pause")
        assert e.value.code == 409 and b"read-only" in e.value.read()
        assert not engine.paused
        assert b"read-only" in _get(base, "/")
        assert "step" in _stats(base)
        engine.join(timeout=60)
        assert not engine._thread.is_alive()
    finally:
        engine._stop.set()
        engine.stop()
        viewer.stop()


@pytest.mark.parametrize("v", [0.5, 0.1, 50.0, 1e-6, 3.141592653589793, 0.0,
                               -2.5e-300])
def test_f64_bit_packing_is_exact_and_the_jax_packing(v):
    lo, hi = _pack_f64(v)
    assert (lo, hi) == jpack(v)
    assert _unpack_f64(lo, hi) == v


def test_bus_drives_engine_through_poll_hook():
    engine = _engine(steps_per_snapshot=2)
    world = engine.world
    cfg = world.config
    bus = ControlBus(cfg.theta, cfg.dt, cfg.render_size)
    assert bus._multiprocess is False  # no process group here
    engine.control_poll = bus.poll
    engine.start(max_steps=None)
    try:
        _until(lambda: world.updates >= 4)
        bus.submit("pause")
        _until(lambda: engine.paused)
        time.sleep(0.1)
        u0 = world.updates
        time.sleep(0.3)
        assert world.updates == u0

        bus.submit("step")
        _until(lambda: world.updates >= u0 + engine.steps_per_snapshot)
        time.sleep(0.2)
        assert world.updates == u0 + engine.steps_per_snapshot
        assert engine.paused

        bus.submit(theta=0.25, dt=0.05)
        _until(lambda: world.config.theta == 0.25 and world.config.dt == 0.05)

        bus.submit("resume")
        _until(lambda: not engine.paused and world.updates > u0 + 2)
        bus.submit("quit")
        engine.join(timeout=30)
        assert not engine._thread.is_alive()
    finally:
        engine._stop.set()
        engine.stop()


def test_viewer_submits_to_the_bus_not_the_engine():
    engine = _engine(steps_per_snapshot=2)
    cfg = engine.world.config
    bus = ControlBus(cfg.theta, cfg.dt, cfg.render_size, multiprocess=False)
    viewer = ViewerServer(engine, port=0, control_bus=bus)
    viewer.start()
    engine.start(max_steps=None)
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        # No poll hook yet: the request reaches the bus and not the engine.
        _get(base, "/control?cmd=pause&theta=0.5")
        assert bus._pause and bus._theta == 0.5
        time.sleep(0.2)
        assert not engine.paused and engine.world.config.theta == 50.0
        engine.control_poll = bus.poll
        _until(lambda: _stats(base)["paused"] and _stats(base)["theta"] == 0.5)
        _get(base, "/control?cmd=quit")
        assert viewer.quit_requested.is_set()
        engine.join(timeout=30)
        assert not engine._thread.is_alive()
    finally:
        engine._stop.set()
        engine.stop()
        viewer.stop()


# -- two gloo ranks ----------------------------------------------------------

_RANK_CODE = r"""
import json, sys
from types import SimpleNamespace
import torch
import torch.distributed as dist
from nbody_simulation_tpu_torch.runtime.control import ControlBus
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=2,
                        rank=rank)


class StubEngine:
    def __init__(self):
        self.world = SimpleNamespace(config=SimpleNamespace(
            theta=50.0, dt=0.1, render_size=64))
        self._stop = SimpleNamespace(set=self.quit)
        self.paused, self.steps, self.quit_at = False, 0, None

    def quit(self):
        self.quit_at = poll

    def pause(self):
        self.paused = True

    def resume(self):
        self.paused = False

    def step_once(self):
        self.steps += 1

    def reconfigure(self, **changes):
        for k, v in changes.items():
            setattr(self.world.config, k, v)


bus = ControlBus(50.0, 0.1, 64)
eng = StubEngine()
# Rank 0's intents by poll; rank 1 submits its own, which must be ignored.
plan = ({2: [("pause", {})], 4: [("step", {})], 5: [(None, {"theta": 0.3,
                                                           "dt": 0.05})],
         7: [("resume", {})], 8: [("step", {}), ("step", {})],
         9: [("quit", {})]} if rank == 0 else
        {1: [("quit", {})], 3: [(None, {"theta": 9.0})]})
log = []
for poll in range(11):
    for cmd, kw in plan.get(poll, []):
        bus.submit(cmd, **kw)
    bus.poll(eng)
    c = eng.world.config
    log.append([poll, eng.paused, eng.steps, c.theta, c.dt, eng.quit_at])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "nbody_simulation_tpu")]
json.dump({"multiprocess": bus._multiprocess, "log": log, "bad": bad},
          open(out, "w"))
dist.destroy_process_group()
"""


def test_two_gloo_ranks_apply_rank0s_intent_in_the_same_poll(tmp_path):
    """Each rank polls a ControlBus against a stub engine eleven times; the
    bus resolves to multi-process from the default group; every rank
    applies rank 0's intent in the same poll and ignores rank 1's. A rank
    that hangs fails the test after 60 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CODE, f"127.0.0.1:{port}", str(rank),
         str(tmp_path / f"rank{rank}.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in (0, 1)]
    assert all(r["multiprocess"] is True and r["bad"] == [] for r in res)
    assert res[0]["log"] == res[1]["log"]
    log = {row[0]: row[1:] for row in res[0]["log"]}
    assert log[1] == [False, 0, 50.0, 0.1, None]   # rank 1's quit ignored
    assert log[2] == [True, 0, 50.0, 0.1, None]
    assert log[3] == [True, 0, 50.0, 0.1, None]    # rank 1's θ ignored
    assert log[4] == [True, 1, 50.0, 0.1, None]
    assert log[5] == [True, 1, 0.3, 0.05, None]
    assert log[7] == [False, 1, 0.3, 0.05, None]
    assert log[8] == [False, 2, 0.3, 0.05, None]   # two steps: one batch
    assert log[9][-1] == 9 and log[10][-1] == 9
