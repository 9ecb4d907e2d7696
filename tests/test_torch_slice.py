"""The port's main paths as a whole: the Barnes-Hut and all-pairs Worlds
against the JAX World, and the CLI on the CPU.

Tolerances. Per step the two packages differ only in f32 summation order
(the sweep's sums and the leaf COM sums): ~1e-6 of an acceleration, whose
largest value here is ~0.07, so ~1e-8 per step of velocity at dt=0.1 and
~2e-7 over 20 steps. Velocities (|v| ≤ 1) are therefore held to 4 ulps of
the largest velocity (4.8e-7), positions (~5e4, ulp 4e-3) to 4 ulps of each
position: a velocity difference that small moves a position by far less
than one ulp.
"""

import time

import numpy as np
import pytest
import torch

from nbody_simulation_tpu.config import SimConfig as JaxConfig
from nbody_simulation_tpu.models.scenarios import uniform_disc as juniform
from nbody_simulation_tpu.models.world import World as JaxWorld
from nbody_simulation_tpu_torch import run
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.runtime.engine import Engine, Snapshot
from nbody_simulation_tpu_torch.state import state_from_numpy
from nbody_simulation_tpu_torch.utils.telemetry import Counting

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

N = 8192
KW = dict(force_path="bh", sweep_buckets=(0.625, 0.125), resort_every=16)


@pytest.fixture(scope="module")
def trajectories():
    """Both worlds from one state, read after 16 steps (one resort cycle)
    and after 20 (across the resort at step 16)."""
    jst = juniform(N, seed=7)
    jw = JaxWorld(jst, JaxConfig(**KW))
    tw = World(state_from_numpy(np.asarray(jst.pos), np.asarray(jst.vel),
                                np.asarray(jst.mass)), SimConfig(**KW))
    out = {}
    for steps in (16, 4):
        jw.run(steps)
        tw.run(steps)
        assert tw.updates == jw.updates
        out[tw.updates] = (
            {k: np.asarray(getattr(jw.state, k)) for k in ("pos", "vel",
                                                           "mass")},
            {k: getattr(tw.state, k).numpy() for k in ("pos", "vel", "mass")})
    return out


def _check_close(j, t):
    np.testing.assert_array_equal(t["mass"], j["mass"])
    pos_tol = 4 * np.spacing(np.abs(j["pos"]))
    assert np.all(np.abs(t["pos"] - j["pos"]) <= pos_tol)
    vel_tol = 4 * np.spacing(np.abs(j["vel"]).max())
    assert np.abs(t["vel"] - j["vel"]).max() <= vel_tol


def test_world_16_steps_match_jax_elementwise(trajectories):
    """Step 0 sorts identical inputs, so the particle order is identical and
    the states compare row by row."""
    _check_close(*trajectories[16])


def test_world_across_the_resort_matches_jax_sorted(trajectories):
    """Step 16 re-sorts by the current positions; compare the states with
    both sorted by (x, y)."""
    j, t = trajectories[20]
    oj = np.lexsort((j["pos"][:, 1], j["pos"][:, 0]))
    ot = np.lexsort((t["pos"][:, 1], t["pos"][:, 0]))
    _check_close({k: v[oj] for k, v in j.items()},
                 {k: v[ot] for k, v in t.items()})


def test_step_timed_and_diagnostics():
    cfg = SimConfig(force_path="bh")
    w = World(state_from_numpy(*(np.asarray(a) for a in (
        juniform(1000, seed=1).pos, juniform(1000, seed=1).vel,
        juniform(1000, seed=1).mass))), cfg)
    assert w.state.n == 1024 and w.state.n_real == 1000
    counting = Counting()
    w.step_timed(counting)
    w.step()
    assert w.updates == 2
    assert counting.build_bvh > 0 and counting.sum_gravity > 0
    d = w.diagnostics()
    assert float(d["total_mass"]) == 1000.0 and int(d["n_live"]) == 1000
    w.assert_finite()
    w.state = w.state.replace(pos=w.state.pos * float("nan"))
    with pytest.raises(FloatingPointError):
        w.assert_finite()


PALLAS_KW = dict(force_path="pallas", tile_i=64, tile_j=128, sym_tile=128)


def _pallas_worlds_after_8_steps(sym_allpairs):
    """The JAX and port all-pairs Worlds from one N=512 state after 8 steps
    (the symmetric kernel's tournament has nt=4 tiles, the ordered kernel
    8×4)."""
    kw = dict(PALLAS_KW, sym_allpairs=sym_allpairs)
    jst = juniform(512, seed=2)
    jw = JaxWorld(jst, JaxConfig(**kw))
    tw = World(state_from_numpy(np.asarray(jst.pos), np.asarray(jst.vel),
                                np.asarray(jst.mass)), SimConfig(**kw))
    assert tw.state.n == jw.state.n == 512
    jw.run(8)
    tw.run(8)
    assert tw.updates == jw.updates == 8
    return ({k: np.asarray(getattr(jw.state, k)) for k in ("pos", "vel",
                                                          "mass")},
            {k: getattr(tw.state, k).numpy() for k in ("pos", "vel", "mass")})


def test_direct_world_and_pallas_refusal():
    st = juniform(300, seed=2)
    w = World(state_from_numpy(np.asarray(st.pos), np.asarray(st.vel),
                               np.asarray(st.mass)),
              SimConfig(force_path="direct", integrator="leapfrog"))
    w.run(2)
    assert w.updates == 2 and np.isfinite(w.state.pos.numpy()).all()
    # The all-pairs path: the symmetric kernel, as the JAX World runs it.
    _check_close(*_pallas_worlds_after_8_steps(sym_allpairs=True))


def test_pallas_world_with_the_ordered_kernel_matches_jax():
    _check_close(*_pallas_worlds_after_8_steps(sym_allpairs=False))


PROFILED_PATHS = {
    "direct": dict(force_path="direct"),
    "pallas": PALLAS_KW,
    "bh50": dict(force_path="bh", theta=50.0, resort_every=2),
    # Below θ=2 the default caps (256) cost a second a step on the CPU.
    "bh05-quad": dict(force_path="bh", theta=0.5, resort_every=2,
                      frontier_cap=16, leaf_cap=16),
}


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("force_path", list(PROFILED_PATHS))
def test_profiled_step_is_the_step(force_path, integrator):
    """A profiled step is the step World.step takes: a run with step_timed
    at every even update is bitwise the plain run, on every force path and
    under both integrators, and each phase it times is the one that ran.
    On the Barnes-Hut paths the plain run re-sorts at the same (even)
    updates as the profiled step, which always re-sorts. On the direct and
    all-pairs paths both runs are within the slice's tolerance of the JAX
    World's; the JAX step_timed runs Euler on those paths whatever the
    integrator, so its run is the plain one (World.step_timed)."""
    kw = dict(PROFILED_PATHS[force_path], integrator=integrator)
    bh = kw["force_path"] == "bh"
    jst = juniform(256, seed=5)
    arrays = [np.asarray(a) for a in (jst.pos, jst.vel, jst.mass)]
    plain = World(state_from_numpy(*arrays), SimConfig(**kw))
    timed = World(state_from_numpy(*arrays), SimConfig(**kw))
    counting = Counting()
    for i in range(4):
        plain.step()
        if i % 2:
            timed.step()
        else:
            timed.step_timed(counting)
    assert timed.updates == plain.updates == 4
    assert (counting.build_bvh > 0) if bh else (counting.build_bvh == 0)
    assert counting.sum_gravity > 0 and counting.post_calculations > 0
    for k in ("pos", "vel", "mass"):
        assert torch.equal(getattr(timed.state, k), getattr(plain.state, k))
    if bh:
        return
    jw = JaxWorld(jst, JaxConfig(**kw))
    jw.run(4)
    _check_close({k: np.asarray(getattr(jw.state, k)) for k in ("pos", "vel",
                                                               "mass")},
                 {k: getattr(timed.state, k).numpy() for k in ("pos", "vel",
                                                               "mass")})


def test_engine_pause_step_reconfigure():
    st = juniform(256, seed=3)
    w = World(state_from_numpy(np.asarray(st.pos), np.asarray(st.vel),
                               np.asarray(st.mass)),
              SimConfig(force_path="direct", render_size=100))
    eng = Engine(w, steps_per_snapshot=2, snapshot_interval=0.0,
                 nan_check_every=2)
    eng.pause()
    eng.reconfigure(dt=0.05)
    eng.start(max_steps=6)
    try:
        snap = eng.next_snapshot(timeout=30)
        assert snap is not None and snap.frame.shape == (100, 100, 4)
        assert w.updates == 0 and eng.paused  # paused: frames, no steps
        eng.step_once()
        deadline = time.monotonic() + 30
        while w.updates < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.updates == 2 and w.config.dt == 0.05
        eng.resume()
        eng.join(timeout=30)
        assert not eng._thread.is_alive() and w.updates == 6
    finally:
        eng.stop()
    # A diverged state stops the engine at its next check; stop() raises.
    w.state = w.state.replace(pos=w.state.pos * float("nan"))
    bad = Engine(w, steps_per_snapshot=2, nan_check_every=2)
    bad.start(max_steps=10)
    bad.join(timeout=30)
    with pytest.raises(FloatingPointError):
        bad.stop()


def test_engine_calls_on_batch_once_per_batch():
    st = juniform(256, seed=4)
    w = World(state_from_numpy(np.asarray(st.pos), np.asarray(st.vel),
                               np.asarray(st.mass)),
              SimConfig(force_path="direct", render_size=100))
    seen = []
    eng = Engine(w, steps_per_snapshot=3, snapshot_interval=0.0,
                 on_batch=lambda world: seen.append(world.updates))
    eng.start(max_steps=10)
    eng.join(timeout=60)
    eng.stop()
    assert not eng._thread.is_alive()
    assert seen == [3, 6, 9, 10]


def test_snapshot_wire_format_round_trip():
    frame = np.arange(5 * 3 * 4, dtype=np.uint8).reshape(5, 3, 4)
    pos = np.arange(8, dtype=np.float32).reshape(4, 2)
    snap = Snapshot(7, Counting(1.0, 2.0, 3.0), frame, pos)
    back = Snapshot.unpack(snap.pack())
    assert back.step == 7 and back.counting == snap.counting
    np.testing.assert_array_equal(back.frame, frame)
    np.testing.assert_array_equal(back.pos, pos)


def test_cli_runs_on_the_cpu_and_writes_a_frame(tmp_path, capsys):
    rc = run.main(["--device", "cpu", "--scenario", "uniform", "--n", "4096",
                   "--steps", "20", "--out", str(tmp_path)])
    assert rc == 0
    frame = tmp_path / "frame_00000020.png"
    assert frame.exists() and frame.stat().st_size > 0
    out = capsys.readouterr().out
    assert "len: 4096" in out and "done: 20 steps" in out


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tmp_path,
                                                              monkeypatch):
    # Hold the host to "no CUDA", so the test means the same on a GPU host.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--scenario", "uniform", "--n", "256", "--steps", "1",
                  "--out", str(tmp_path)])


@pytest.mark.parametrize("method", ["exact", "bh"])
def test_cli_pallas_path_prints_energy(tmp_path, capsys, method):
    rc = run.main(["--device", "cpu", "--force-path", "pallas", "--scenario",
                   "uniform", "--n", "1024", "--energy-every", "5",
                   "--energy-method", method, "--steps", "10",
                   "--steps-per-snapshot", "5", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("energy:")]
    assert [ln.split(" E=")[0] for ln in lines] == [
        "energy: step 5", "energy: step 10"]
    assert "|dE/E0|=0.000e+00" in lines[0]
    assert "done: 10 steps" in out
    assert (tmp_path / "frame_00000010.png").exists()
