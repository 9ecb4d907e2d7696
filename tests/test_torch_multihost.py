"""The port's distributed application against the JAX package: sharded
checkpoints, the sharded recorder and the distributed CLI
(``nbody_simulation_tpu_torch.run_multihost``).

Files cross between the packages in both directions with no step run on
the JAX side: the JAX functions only lay out (``distribute_state`` on the
8 virtual CPU devices), save, load and play back. Checkpoint rows are held
bitwise; a recording's first frame is bitwise and later frames within the
JAX test's 0.1 (each delta add rounds once in f32). The CLI runs
in-process on ``--local-shards`` and, once, as two gloo ranks (``python -m``,
no JAX in them), each failing after 60 s if it hangs.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu import parallel as jpar
from nbody_simulation_tpu import run_multihost as jcli
from nbody_simulation_tpu.config import SimConfig as JSimConfig
from nbody_simulation_tpu.models import scenarios as jscen
from nbody_simulation_tpu.utils import checkpoint as jck
from nbody_simulation_tpu.utils import recording as jrec
from nbody_simulation_tpu_torch import parallel as par
from nbody_simulation_tpu_torch import run_multihost as cli
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.scenarios import uniform_disc
from nbody_simulation_tpu_torch.runtime.distributed import (
    DistributedEngine, DistributedWorld)
from nbody_simulation_tpu_torch.utils import checkpoint as tck
from nbody_simulation_tpu_torch.utils import recording as trec

torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = Path(__file__).resolve().parents[1]
CFG = dict(force_path="bh", theta=50.0, render_size=128)


def world_of(n, p, seed):
    mesh = par.LocalMesh(p, "cpu")
    cfg = SimConfig(**CFG)
    ds = par.distribute_state(uniform_disc(n, seed=seed), mesh, cfg)
    return DistributedWorld(ds, mesh, cfg)


def assert_bitwise(got, want, what=""):
    got = np.ascontiguousarray(np.asarray(got, np.float32))
    want = np.ascontiguousarray(np.asarray(want, np.float32))
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


def assert_states_bitwise(got, want):
    for name in ("pos", "vel", "mass"):
        assert_bitwise(getattr(got, name), getattr(want, name), name)


# -- sharded checkpoints --------------------------------------------------------

def test_sharded_checkpoint_round_trip_onto_fewer_shards(tmp_path):
    """A LocalMesh(8) world after 2 steps, saved (one file, every live row
    of this process) and loaded onto LocalMesh(4): its live rows and step
    bitwise, and the loaded world steps on."""
    w = world_of(1500, 8, 33)
    w.run(2)
    tck.save_sharded_checkpoint(tmp_path / "ck", w.state, w.updates, w.mesh)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "manifest.json", "shard_00000.npz"]
    mesh4 = par.LocalMesh(4, "cpu")
    state, step = tck.load_sharded_checkpoint(tmp_path / "ck", mesh4,
                                              SimConfig(**CFG))
    assert step == 2 and state.distributed and state.n == 4 * 512
    assert_states_bitwise(state.compact(), w.state.compact())
    w4 = DistributedWorld(state, mesh4, SimConfig(**CFG))
    w4.run(1)
    w4.assert_finite()


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """One state laid out by each package on 8 shards (bitwise the same),
    saved by each, and every directory loaded by both onto 4 shards."""
    root = tmp_path_factory.mktemp("crossed")
    st = uniform_disc(1500, seed=33)
    jst = jscen.uniform_disc(1500, seed=33)
    jcfg = JSimConfig(**CFG)
    jds = jpar.distribute_state(jst, jpar.make_1d_mesh(8), jcfg)
    jck.save_sharded_checkpoint(root / "jax", jds, 5)
    mesh8 = par.LocalMesh(8, "cpu")
    tds = par.distribute_state(st, mesh8, SimConfig(**CFG))
    tck.save_sharded_checkpoint(root / "port", tds, 5, mesh8)
    jmesh4 = jpar.make_1d_mesh(4)
    mesh4 = par.LocalMesh(4, "cpu")
    loads = {}
    for src in ("jax", "port"):
        loads[src, "jax"] = jck.load_sharded_checkpoint(root / src, jmesh4,
                                                        jcfg)
        loads[src, "port"] = tck.load_sharded_checkpoint(
            root / src, mesh4, SimConfig(**CFG))
    return root, loads


def test_jax_sharded_checkpoint_loads_in_the_port(crossed):
    """The JAX package's directory, loaded by the port onto LocalMesh(4),
    is bitwise the JAX load onto 4 devices; both files hold the same rows."""
    root, loads = crossed
    (got, gstep), (want, wstep) = loads["jax", "port"], loads["jax", "jax"]
    assert gstep == wstep == 5 and got.n == int(want.pos.shape[0])
    assert_states_bitwise(got, want)
    with np.load(root / "jax" / "shard_00000.npz") as a, \
            np.load(root / "port" / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert_bitwise(a[name], b[name], name)


def test_port_sharded_checkpoint_loads_in_jax(crossed):
    """The port's directory, loaded by the JAX package onto 4 devices, is
    bitwise the port's own load; the manifests have the same keys and
    values."""
    root, loads = crossed
    (got, gstep), (want, wstep) = loads["port", "jax"], loads["port", "port"]
    assert gstep == wstep == 5
    assert_states_bitwise(want, got)
    assert_states_bitwise(want, loads["jax", "port"][0])
    man = {k: json.loads((root / k / "manifest.json").read_text())
           for k in ("jax", "port")}
    assert man["port"] == man["jax"]
    assert sorted(man["port"]) == ["counts", "n_live", "n_processes",
                                   "step", "version"]


# -- the sharded recorder -------------------------------------------------------

def test_sharded_recorder_round_trip(tmp_path):
    """Frames at steps 2, 4, 6 of a LocalMesh(8) world: the port's and the
    JAX package's ``playback_sharded`` give the same frames, the first
    bitwise the state and the later ones within 0.1."""
    w = world_of(1024, 8, 7)
    rec = trec.ShardedRecorder(tmp_path / "rec", every=2)
    history = {}
    for _ in range(6):
        w.step()
        if rec.maybe_record(w.state, w.updates, w.mesh):
            history[w.updates] = w.state.pos.numpy().copy()
    rec.close()
    assert rec.frames == 3 and sorted(history) == [2, 4, 6]
    man = json.loads((tmp_path / "rec" / "manifest.json").read_text())
    assert man["n_rows"] == 8 * 128 and man["every"] == 2
    assert man["spans"] == [[[128 * i, 128 * (i + 1)] for i in range(8)]]
    got = list(trec.playback_sharded(tmp_path / "rec"))
    other = list(jrec.playback_sharded(tmp_path / "rec"))
    assert [s for s, _ in got] == [s for s, _ in other] == [2, 4, 6]
    for (step, frame), (_, jframe) in zip(got, other):
        assert_bitwise(frame, jframe)
        if step == 2:
            assert_bitwise(frame, history[step])
        np.testing.assert_allclose(frame, history[step], atol=0.1)


def test_jax_sharded_recording_plays_back_in_the_port(tmp_path):
    """The JAX ``ShardedRecorder`` over a layout on the 8 virtual devices,
    recorded at steps 0, 2, 4 with the positions shifted between frames
    (no JAX step): the port's playback is bitwise the JAX playback."""
    jds = jpar.distribute_state(jscen.uniform_disc(1024, seed=7),
                                jpar.make_1d_mesh(8), JSimConfig(**CFG))
    rec = jrec.ShardedRecorder(tmp_path / "jrec", every=2)
    shift = np.float32(0.37)
    for k, step in enumerate((0, 1, 2, 4)):
        st = jds.replace(pos=jds.pos + jnp.float32(k) * shift)
        rec.maybe_record(st, step)
    rec.close()
    got = list(trec.playback_sharded(tmp_path / "jrec"))
    want = list(jrec.playback_sharded(tmp_path / "jrec"))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2, 4]
    for (_, a), (_, b) in zip(got, want):
        assert_bitwise(a, b)
    assert_bitwise(got[0][1], np.asarray(jds.pos))


def test_sharded_recorder_catches_up_through_the_engine(tmp_path):
    """Through ``DistributedEngine``'s on_batch at batches of 3 steps with
    every=2: the first call (step 3) anchors the cadence at 4, caught up
    at 6 (next due 8, caught up at 9), so frames at 6 and 9, as the JAX
    package records them."""
    w = world_of(512, 4, 9)
    rec = trec.ShardedRecorder(tmp_path / "rec", every=2)
    eng = DistributedEngine(
        w, snapshot_interval=0.0, steps_per_snapshot=3,
        on_batch=lambda world: rec.maybe_record(world.state, world.updates,
                                                world.mesh))
    eng.start(max_steps=9)
    while eng.next_snapshot(timeout=60.0) is not None:
        pass
    eng.stop()
    rec.close()
    assert rec.frames == 2
    assert [s for s, _ in trec.playback_sharded(tmp_path / "rec")] == [6, 9]


# -- the CLI ----------------------------------------------------------------------

BASE = ["--device", "cpu", "--scenario", "uniform", "--n", "1024",
        "--rebalance-every", "0", "--render-size", "64"]


def test_cli_sharded_checkpoint_then_resume(tmp_path, capsys):
    ck = tmp_path / "shards"
    assert cli.main(BASE + ["--local-shards", "4", "--steps", "3",
                            "--checkpoint-sharded", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "sharded checkpoint:" in out and "@ step 3" in out
    assert cli.main(BASE + ["--local-shards", "2", "--steps", "1",
                            "--resume-sharded", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "len: 1024" in out and "done: 1 steps" in out


def test_cli_checkpoint_is_read_by_jax(tmp_path, capsys):
    """``--checkpoint`` writes the single-device format: the JAX
    ``load_checkpoint`` reads the port's file bitwise as the port does."""
    path = tmp_path / "ck.npz"
    assert cli.main(BASE + ["--local-shards", "4", "--steps", "2",
                            "--checkpoint", str(path)]) == 0
    assert f"checkpoint: {path} @ step 2" in capsys.readouterr().out
    jst, jstep = jck.load_checkpoint(path)
    tst, tstep = tck.load_checkpoint(path)
    assert jstep == tstep == 2 and tst.n_real == jst.n_real == 1024
    assert_states_bitwise(tst, jst)


def test_cli_serve_returns(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert cli.main(BASE + ["--local-shards", "2", "--steps", "2",
                            "--serve", str(port)]) == 0
    out = capsys.readouterr().out
    assert f"viewer: http://127.0.0.1:{port}/" in out
    assert "done: 2 steps" in out


def test_cli_refuses_what_it_cannot_run():
    with pytest.raises(SystemExit):
        cli.main(BASE + ["--local-shards", "4", "--num-processes", "2"])
    from unittest import mock
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--local-shards", "2", "--steps", "1"])


def test_two_gloo_ranks_write_a_sharded_checkpoint(tmp_path, capsys):
    """Two gloo ranks (``--exact-chunks``) step twice, record and save one
    file each; their rows and recorded frames are bitwise the one-process
    LocalMesh(2) run's, and one process on 4 local shards resumes the
    directory. A rank that hangs fails the test after 60 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    run = BASE + ["--steps", "2", "--exact-chunks"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nbody_simulation_tpu_torch.run_multihost",
         *run, "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--checkpoint-sharded",
         str(tmp_path / "two"), "--record", str(tmp_path / "rec_two"),
         "--record-every", "1"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "processes: 2" in logs[0] and "done: 2 steps" in logs[0]
    man = json.loads((tmp_path / "two" / "manifest.json").read_text())
    assert man["n_processes"] == 2 and man["n_live"] == 1024
    assert cli.main(run + ["--local-shards", "2", "--checkpoint-sharded",
                           str(tmp_path / "one"), "--record",
                           str(tmp_path / "rec_one"), "--record-every",
                           "1"]) == 0
    two = list(trec.playback_sharded(tmp_path / "rec_two"))
    one = list(trec.playback_sharded(tmp_path / "rec_one"))
    assert [s for s, _ in two] == [s for s, _ in one] == [2]
    assert_bitwise(two[0][1], one[0][1])
    man = json.loads((tmp_path / "rec_two" / "manifest.json").read_text())
    assert man["n_processes"] == 2 and man["spans"] == [[[0, 512]],
                                                         [[512, 1024]]]
    with np.load(tmp_path / "one" / "shard_00000.npz") as one:
        parts = [np.load(tmp_path / "two" / f"shard_{i:05d}.npz")
                 for i in range(2)]
        for name in ("pos", "vel", "mass"):
            assert_bitwise(np.concatenate([z[name] for z in parts]),
                           one[name], name)
    capsys.readouterr()
    assert cli.main(BASE + ["--local-shards", "4", "--steps", "1",
                            "--resume-sharded", str(tmp_path / "two")]) == 0
    out = capsys.readouterr().out
    assert "len: 1024" in out and "done: 1 steps" in out


def test_parser_matches_the_jax_cli():
    """The same options, defaults, choices and types, less
    ``--cpu-devices``, plus ``--device`` and ``--local-shards``."""
    def options(parser):
        return {a.option_strings[0]: (a.dest, a.default, a.choices, a.type,
                                      a.nargs, type(a).__name__)
                for a in parser._actions if a.option_strings
                and a.option_strings[0] != "-h"}
    mine, theirs = options(cli.build_parser()), options(jcli.build_parser())
    assert set(mine) == set(theirs) - {"--cpu-devices"} | {"--device",
                                                           "--local-shards"}
    for opt in set(mine) & set(theirs):
        assert mine[opt] == theirs[opt], opt
