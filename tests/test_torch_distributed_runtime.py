"""The port's distributed runtime: ``DistributedWorld`` (its rebalance
cadence and seam-set swap), ``DistributedEngine`` (its frames), the
distributed checkpoint (read back by the JAX package), and
``simulate_distributed``. Everything here is bitwise or exact: the world is
held to the step, rebalance and matchings it is made of, and frames to the
sharded raster, which tests/test_torch_ring.py holds pixel for pixel to the
single-device one."""

import numpy as np
import pytest
import torch

from nbody_simulation_tpu.utils.checkpoint import load_checkpoint as jload
from nbody_simulation_tpu_torch import parallel as par
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.scenarios import uniform_disc
from nbody_simulation_tpu_torch.parallel.mesh import LocalMesh
from nbody_simulation_tpu_torch.runtime.distributed import (
    DistributedEngine, DistributedWorld, load_distributed_checkpoint,
    save_distributed_checkpoint)
from nbody_simulation_tpu_torch.utils.telemetry import Counting

torch.set_num_threads(min(2, torch.get_num_threads()))

# θ<2 (seam stages on) with a fine cut (256 slot ranges a shard), so that
# not every pair of shards is a seam and the set can change.
QUALITY = dict(force_path="bh", theta=1.9, unweighted_leaf_com=False,
               frontier_cap=16, leaf_cap=32, plan_leaves=1, leaf_size=8,
               forest_levels=9, render_size=96)


def world_of(kw, n=2048, p=8, seed=7, rebalance_every=0, speed=1.0):
    mesh = LocalMesh(p, "cpu")
    cfg = SimConfig(**kw)
    st = uniform_disc(n, seed=seed)
    st = st.replace(vel=st.vel * speed)
    ds = par.distribute_state(st, mesh, cfg)
    return DistributedWorld(ds, mesh, cfg, rebalance_every=rebalance_every)


def test_world_rebalances_and_swaps_its_seam_set():
    """Every 2 steps the collective rebalance, then the matchings of the new
    layout: where they changed the world steps with them (the step's
    cadence restarts at a re-sort); the state is bitwise the step,
    rebalance and matchings applied by hand. The bodies move ~1% of the
    disc per step (speeds up to 2e4), so that the seams do move."""
    w = world_of(QUALITY, rebalance_every=2, speed=2e4)
    mesh, cfg = w.mesh, w.config
    assert w._extra == par.adjacency_stages(w.state, mesh, cfg) != ()
    st, extra = w.state, w._extra
    step = par.make_distributed_bh_step(mesh, cfg, extra_pairs=extra)
    swaps = 0
    for k in range(1, 5):
        w.step()
        st = step(st)
        if k % 2 == 0:
            st = par.collective_rebalance(st, mesh, cfg)
            new = par.adjacency_stages(st, mesh, cfg)
            if new != extra:
                swaps += 1
                extra = new
                step = par.make_distributed_bh_step(mesh, cfg,
                                                    extra_pairs=new)
            else:
                step.reset()
        assert torch.equal(w.state.pos, st.pos) and w._extra == extra
    assert w.updates == 4 and w.state.distributed
    assert swaps >= 1, "the drift never moved a seam: the test runs nothing"
    w.assert_finite()
    d = w.diagnostics()
    assert float(d["total_mass"]) == 2048.0 and int(d["n_live"]) == 2048
    c = Counting()
    w.step_timed(c)
    assert c.sum_gravity > 0 and c.build_bvh == 0 and w.updates == 5
    w.state = w.state.replace(pos=w.state.pos.clone())
    w.state.pos[5, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="step 5"):
        w.assert_finite()


def test_engine_frames_are_the_sharded_raster():
    w = world_of(dict(force_path="bh", leaf_size=8, render_size=96),
                 rebalance_every=4)
    with pytest.raises(ValueError, match="include_particles"):
        DistributedEngine(w, include_particles=True)
    eng = DistributedEngine(w, snapshot_interval=0.0, steps_per_snapshot=3,
                            profile_every=2)
    eng.start(max_steps=9)
    eng.join(timeout=120)
    snaps = []
    while (s := eng.next_snapshot(timeout=0.5)) is not None:
        snaps.append(s)
    eng.stop()
    assert snaps and snaps[-1].step == 9 == w.updates
    want = par.sharded_render_frame(w.state.pos, w.state.vel, w.state.mass,
                                    w.mesh, render_size=96).numpy()
    np.testing.assert_array_equal(snaps[-1].frame, want)
    assert int((want[..., 3] > 0).sum()) > 50
    assert snaps[-1].counting.sum_gravity > 0   # a profiled batch ran


def test_checkpoint_is_the_single_device_format(tmp_path):
    """The live rows in global Morton order, step included; the JAX
    package's ``load_checkpoint`` reads it, and loading onto another mesh
    gives that mesh's ``distribute_state`` layout."""
    w = world_of(dict(force_path="bh", leaf_size=8), n=1500)
    w.run(2)
    path = tmp_path / "ck.npz"
    save_distributed_checkpoint(path, w)
    jst, jstep = jload(path)
    live = w.state.compact()
    assert jstep == 2 and jst.n == 1500
    for k in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, k)),
                                      getattr(live, k).numpy())
    mesh4 = LocalMesh(4, "cpu")
    st, step = load_distributed_checkpoint(path, mesh4, w.config)
    want = par.distribute_state(live, mesh4, w.config)
    assert step == 2 and st.distributed
    assert torch.equal(st.pos, want.pos) and torch.equal(st.mass, want.mass)


def test_simulate_distributed_loop():
    w = world_of(dict(force_path="bh", leaf_size=8, render_size=96), p=4)
    frames = []
    out = par.simulate_distributed(
        w.state, w.mesh, w.config, steps=4, snapshot_every=2,
        on_frame=lambda i, f: frames.append((i, f)), rebalance_every=3)
    ref = DistributedWorld(w.state, w.mesh, w.config, rebalance_every=3)
    ref.run(4)
    assert torch.equal(out.pos, ref.state.pos)
    assert [i for i, _ in frames] == [2, 4]
    np.testing.assert_array_equal(frames[-1][1], par.sharded_render_frame(
        out.pos, out.vel, out.mass, w.mesh, render_size=96).numpy())
