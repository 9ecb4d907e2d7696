"""The Barnes-Hut step's CUDA graphs in ``World.run``, on the CPU.

A stand-in takes the place of capture and replay (``World.step_graph``) and
mimics both: a capture runs the step's Python once and leaves the state as
it was (a real capture launches nothing), a replay runs it again with the
host's launch counters held still (a real replay runs no Python). It
serves CPU tensors, so ``World`` takes its graph path here; the same world
with the CUDA class (the default) steps eagerly on the CPU, which is the
comparison. On the card, ``chip_smoke.py`` holds real replays bitwise to
eager steps.

The plan, at ``resort_every=8``: batches of ``run(10)`` with a profiled
step (``step_timed``) between them and ``run(2)`` after the second, twice,
with ``reconfigure(dt=...)`` between the halves: 48 steps.
"""

import gc

import pytest
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models import uniform_disc
from nbody_simulation_tpu_torch.models.world import CudaStepGraph, World
from nbody_simulation_tpu_torch.ops import traversal
from nbody_simulation_tpu_torch.utils.telemetry import (Counting, RateMeter,
                                                        StepGraphCounts)

torch.set_num_threads(min(2, torch.get_num_threads()))

N = 512
EVERY = 8
HALF = (10, "timed", 10, "timed", 2)
TIMED = {10, 21, 34, 45}
# Per half: its first re-sorting and first stale step run eagerly, the
# second of each is captured, every later one replayed.
EAGER = {0, 1, 24, 25}
CAPTURED = {2, 8, 26, 32}


def _stand_in(log: list, world_of):
    class StandIn:
        device_type = "cpu"

        @staticmethod
        def new_pool(device):
            log.append(("pool",))
            return object()

        def __init__(self, body, pool, device):
            assert not gc.isenabled()
            w = world_of()
            s = w._static
            kept = [t.clone() for t in (s.pos, s.vel, s.mass)]
            body()
            for t, k in zip((s.pos, s.vel, s.mass), kept):
                t.copy_(k)
            self.body, self.pool = body, pool
            self.resort = w.updates % EVERY == 0
            log.append(("capture", w.updates, pool))

        def replay(self):
            w = world_of()
            assert (w.updates % EVERY == 0) == self.resort
            counted = [getattr(*c) for c in _COUNTERS]
            self.body()
            for c, n in zip(_COUNTERS, counted):
                setattr(*c, n)
            log.append(("replay", w.updates, self.pool))

    return StandIn


_COUNTERS = ((traversal.grouped_sweep, "launches"),
             (traversal.grouped_sweep, "quad_launches"))


def _config(theta, integrator):
    # Below θ=2 the default caps (256) cost a second a step on the CPU.
    caps = {} if theta >= 2 else dict(frontier_cap=16, leaf_cap=16)
    return SimConfig(force_path="bh", theta=theta, integrator=integrator,
                     resort_every=EVERY, **caps)


def _drive(world, handed=None):
    """The plan; returns the state after every batch."""
    counting = Counting()
    out = []
    for half in range(2):
        if half:
            world.reconfigure(dt=0.05)
        for item in HALF:
            if item == "timed":
                world.step_timed(counting)
            else:
                world.run(item)
                if handed is not None:
                    st = world.state
                    handed.append((st, [t.clone() for t in
                                        (st.pos, st.vel, st.mass)]))
            out.append([world.state.pos, world.state.vel, world.state.mass])
    assert world.updates == 48
    return out


def _graphed_world(theta, integrator, monkeypatch, log):
    holder = []
    monkeypatch.setattr(World, "step_graph",
                        _stand_in(log, lambda: holder[0]))
    world = World(uniform_disc(N, seed=11), _config(theta, integrator))
    holder.append(world)
    return world


@pytest.mark.parametrize("theta,integrator", [
    (50.0, "euler"), (50.0, "leapfrog"), (0.5, "euler"), (0.5, "leapfrog")])
def test_replayed_steps_are_bitwise_eager_steps(theta, integrator,
                                                monkeypatch):
    """Every batch end of the graph path equals plain eager stepping of the
    same start, bit for bit, across re-sorts, profiled steps and a
    reconfigure; both integrators, monopole and quadrupole."""
    eager = World(uniform_disc(N, seed=11), _config(theta, integrator))
    want = _drive(eager)
    assert eager.graph_counts.replayed == 0
    assert eager.graph_counts.eager == 48
    log = []
    got = _drive(_graphed_world(theta, integrator, monkeypatch, log))
    assert sum(e[0] == "replay" for e in log) == 40
    for k, (a, b) in enumerate(zip(got, want)):
        for x, y, name in zip(a, b, ("pos", "vel", "mass")):
            assert torch.equal(x, y), f"batch {k}: {name} differs"


def test_variant_schedule_and_counters(monkeypatch):
    """Which step ran how: eager, captured then replayed, or replayed; two
    graphs and one shared pool a configuration; the collector off during a
    capture; the four counters; launch counters that count each step that
    ran once."""
    log = []
    world = _graphed_world(50.0, "euler", monkeypatch, log)
    real_step = World._bh_step

    def counted_step(self, st):
        traversal.grouped_sweep.launches += 1
        return real_step(self, st)

    monkeypatch.setattr(World, "_bh_step", counted_step)
    launches0 = traversal.grouped_sweep.launches
    _drive(world)
    captures = [e for e in log if e[0] == "capture"]
    replays = [e for e in log if e[0] == "replay"]
    assert [e[1] for e in captures] == sorted(CAPTURED)
    assert {e[1] for e in replays} == set(range(48)) - EAGER - TIMED
    assert len(replays) == 48 - len(EAGER) - len(TIMED)
    # Both graphs of one configuration share one pool; reconfigure drops it.
    assert sum(e[0] == "pool" for e in log) == 2
    assert captures[0][2] is captures[1][2]
    assert captures[2][2] is captures[3][2]
    assert captures[1][2] is not captures[2][2]
    assert gc.isenabled()
    counts = world.graph_counts
    assert counts.replayed == 40
    assert counts.eager == len(EAGER) + len(TIMED)
    assert counts.captured == 4
    assert counts.capture_s >= 0.0
    assert counts.replay_share == pytest.approx(40 / 48)
    # The profiled steps do not go through _bh_step.
    assert traversal.grouped_sweep.launches - launches0 == 40 + len(EAGER)


def test_handed_out_state_keeps_its_values(monkeypatch):
    """A state read after ``run`` is not the static buffers: later replays
    leave it as it was."""
    handed = []
    _drive(_graphed_world(50.0, "euler", monkeypatch, []), handed)
    assert len(handed) == 6
    for st, kept in handed:
        for t, k in zip((st.pos, st.vel, st.mass), kept):
            assert torch.equal(t, k)


def test_assigned_state_is_replayed_from(monkeypatch):
    """A state assigned between runs (a checkpoint load) is what the next
    replay steps from; one of another size drops the graphs."""
    log = []
    world = _graphed_world(50.0, "euler", monkeypatch, log)
    world.run(5)
    start = world.state
    moved = start.replace(pos=start.pos + 1.0)
    eager = World(uniform_disc(N, seed=11), _config(50.0, "euler"))
    eager.step_graph = CudaStepGraph  # eager on the CPU
    eager.state, eager.updates = moved, world.updates
    world.state = moved
    world.run(3)
    eager.run(3)
    assert torch.equal(world.state.pos, eager.state.pos)
    assert torch.equal(world.state.vel, eager.state.vel)
    assert world.graph_counts.replayed == 6
    world.state = uniform_disc(2 * N, seed=12)
    world.run(2)
    assert world.graph_counts.replayed == 6
    assert world.graph_counts.eager == 4


@pytest.mark.parametrize("force_path", ["direct", "pallas"])
def test_other_force_paths_stay_eager(force_path, monkeypatch):
    """Only the Barnes-Hut path replays graphs."""
    log = []
    monkeypatch.setattr(World, "step_graph", _stand_in(log, lambda: None))
    world = World(uniform_disc(256, seed=1), SimConfig(force_path=force_path))
    world.run(3)
    assert log == []
    assert world.graph_counts.eager == 3
    assert world.graph_counts.replayed == 0


def test_rate_meter_prints_the_replay_share():
    """The CLI's once-a-second telemetry gives the share of steps
    replayed."""
    lines = []
    meter = RateMeter(emit=lines.append, interval=0.0)
    meter.frame(48, Counting(), StepGraphCounts(replayed=40, eager=8,
                                                captured=4, capture_s=0.05))
    assert lines[-1] == ("replayed: 83.3% of 48 steps, 4 graphs captured in "
                         "0.050 s")
    meter.frame(49, Counting())
    assert not lines[-1].startswith("replayed")
