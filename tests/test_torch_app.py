"""The port's application layer against the JAX package's: checkpoints,
recordings, the offline renderer, the GIF frames and the CLI flags that use
them (``--checkpoint``, ``--resume``, ``--record``, ``--gif``, ``--serve``).

Files cross between the packages bitwise: each reads the other's
checkpoints and recordings, and the port's ``Recorder`` writes the JAX
``Recorder``'s bytes under zstd and under zlib. A resumed port run is
bitwise an unbroken one, across a Barnes-Hut re-sort. A JAX checkpoint
resumed by the port is held to the JAX resumed run with
``tests/test_torch_slice.py``'s tolerance: 4 ulps of each position, 4 ulps
of the largest velocity, masses equal.

Both CLIs run in this process, on the CPU, at N ≤ 512 and 64² frames.
"""

import importlib.util
import json
import socket
import sys
import zlib

import numpy as np
import pytest
import torch

from nbody_simulation_tpu import render_recording as jrender
from nbody_simulation_tpu import run as jrun
from nbody_simulation_tpu.runtime import frame as jframe
from nbody_simulation_tpu.state import ParticleState as JaxState
from nbody_simulation_tpu.utils import checkpoint as jck
from nbody_simulation_tpu.utils import recording as jrec
from nbody_simulation_tpu_torch import render_recording as trender
from nbody_simulation_tpu_torch import run
from nbody_simulation_tpu_torch.runtime import frame as tframe
from nbody_simulation_tpu_torch.state import ParticleState
from nbody_simulation_tpu_torch.utils import checkpoint as tck
from nbody_simulation_tpu_torch.utils import recording as trec

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("pos", "vel", "mass")


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _assert_bitwise(a: dict, b: dict):
    for k in FIELDS:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def _arrays(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _state_arrays(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1e5, (n, 2)).astype(np.float32),
            rng.normal(0, 1, (n, 2)).astype(np.float32),
            rng.integers(1, 30, n).astype(np.float32))


def _trajectory(seed=1, n=400, frames=12):
    """A sequence of galaxy-sized positions that drift a little per frame,
    with one row permutation midway (as a Barnes-Hut re-sort gives)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1e5, (n, 2)).astype(np.float32)
    out = []
    for k in range(frames):
        pos = pos + rng.normal(0, 3.0, pos.shape).astype(np.float32)
        if k == frames // 2:
            pos = pos[rng.permutation(n)]
        out.append(pos.copy())
    return out


def _write(recorder, traj):
    for step, pos in enumerate(traj):
        recorder.maybe_record(pos, step)
    recorder.close()


def _zlib_pair(monkeypatch, mod):
    monkeypatch.setattr(mod, "_compress",
                        lambda b, level: zlib.compress(b, min(level, 9)))
    monkeypatch.setattr(mod, "_decompress", zlib.decompress)
    monkeypatch.setattr(mod, "CODEC", "zlib")


def _port_recording_without_zstandard(monkeypatch):
    """The port's recording module imported afresh with ``zstandard``
    hidden: its own zlib fallback, not a patched one."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    spec = importlib.util.spec_from_file_location("_rec_zlib", trec.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(params=["zstd", "zlib"])
def codecs(request, monkeypatch):
    """(port module, JAX module) on one codec."""
    if request.param == "zstd":
        assert trec.CODEC == jrec.CODEC == "zstd"
        return trec, jrec
    port = _port_recording_without_zstandard(monkeypatch)
    assert port.CODEC == "zlib"
    _zlib_pair(monkeypatch, jrec)
    return port, jrec


# -- checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_packages_bitwise(tmp_path, writer):
    pos, vel, mass = _state_arrays()
    path = tmp_path / "ck.npz"
    if writer == "jax":
        jck.save_checkpoint(path, JaxState.create(pos, vel, mass,
                                                  n_real=280), 1234)
        st, step = tck.load_checkpoint(path)
        assert isinstance(st, ParticleState) and st.device.type == "cpu"
    else:
        tck.save_checkpoint(path, ParticleState.create(pos, vel, mass,
                                                       n_real=280), 1234)
        st, step = jck.load_checkpoint(path)
    assert step == 1234 and st.n_real == 280
    _assert_bitwise(_arrays(st), {"pos": pos, "vel": vel, "mass": mass})
    assert not path.with_suffix(".npz.tmp").exists()


@pytest.mark.parametrize("load", [jck.load_checkpoint, tck.load_checkpoint],
                         ids=["jax", "port"])
def test_checkpoint_version_2_raises(tmp_path, load):
    pos, vel, mass = _state_arrays()
    path = tmp_path / "v2.npz"
    np.savez_compressed(path, version=np.int64(2), step=np.int64(0),
                        n_real=np.int64(300), pos=pos, vel=vel, mass=mass)
    with pytest.raises(ValueError, match="unsupported checkpoint version 2"):
        load(path)


# -- recordings --------------------------------------------------------------

def test_recorder_writes_the_jax_recorders_bytes(tmp_path, codecs):
    port, jax_mod = codecs
    traj = _trajectory()
    for every in (1, 4):
        tr = port.Recorder(tmp_path / f"t{every}.bin", every=every)
        jr = jax_mod.Recorder(tmp_path / f"j{every}.bin", every=every)
        _write(tr, traj)
        _write(jr, traj)
        got = (tmp_path / f"t{every}.bin").read_bytes()
        assert got == (tmp_path / f"j{every}.bin").read_bytes()
        assert got.startswith(b"NBREC\x00\x00\x01")
        assert (tr.frames, tr.raw_bytes, tr.comp_bytes) == (
            jr.frames, jr.raw_bytes, jr.comp_bytes)
    assert tr.frames == 3 and tr.comp_bytes < tr.raw_bytes


def test_playback_reproduces_the_other_packages_frames(tmp_path, codecs):
    port, jax_mod = codecs
    traj = _trajectory(seed=2)
    _write(port.Recorder(tmp_path / "t.bin", every=3), traj)
    _write(jax_mod.Recorder(tmp_path / "j.bin", every=3), traj)
    for path in ("t.bin", "j.bin"):
        want = list(jax_mod.playback(tmp_path / path))
        got = list(port.playback(tmp_path / path))
        assert [s for s, _ in got] == [s for s, _ in want] == [0, 3, 6, 9]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    # Playback adds f32 deltas: a + (b - a) may miss b by an ulp.
    for step, pos in port.playback(tmp_path / "t.bin"):
        np.testing.assert_allclose(pos, traj[step], rtol=0,
                                   atol=4 * np.spacing(np.float32(2e5)))


@pytest.mark.parametrize("mod", [jrec, trec], ids=["jax", "port"])
def test_headerless_legacy_stream_needs_initial_pos(tmp_path, mod):
    traj = _trajectory(seed=3, frames=3)
    _write(mod.Recorder(tmp_path / "r.bin", every=1), traj)
    legacy = tmp_path / "legacy.bin"
    legacy.write_bytes((tmp_path / "r.bin").read_bytes()[8:])
    with pytest.raises(ValueError, match="headerless"):
        list(mod.playback(legacy))
    frames = list(mod.playback(legacy, initial_pos=np.zeros_like(traj[0])))
    assert [s for s, _ in frames] == [0, 1, 2]


def _sharded_recording(path, traj):
    """Two JAX ``Recorder`` streams over rows [0, 150) and [150, 200) ∪
    [350, 400) of a 400-row layout, and the manifest."""
    path.mkdir()
    spans = [[[0, 150]], [[150, 200], [350, 400]]]
    for pid, proc in enumerate(spans):
        rec = jrec.Recorder(path / f"rec_{pid:05d}.bin", every=2)
        for step, pos in enumerate(traj):
            rec.maybe_record(np.concatenate([pos[lo:hi] for lo, hi in proc]),
                             step)
        rec.close()
    (path / "manifest.json").write_text(json.dumps({
        "version": 1, "every": 2, "n_processes": 2, "n_rows": 400,
        "spans": spans}))


def test_playback_sharded_matches_jax(tmp_path):
    _sharded_recording(tmp_path / "sh", _trajectory(seed=4, frames=7))
    want = list(jrec.playback_sharded(tmp_path / "sh"))
    got = list(trec.playback_sharded(tmp_path / "sh"))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 2, 4, 6]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert not got[-1][1][200:350].any()  # rows no process holds


# -- frames ------------------------------------------------------------------

@pytest.mark.parametrize("lib", ["native", "numpy"])
def test_composite_black_matches_jax(monkeypatch, lib):
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (24, 40, 4)).astype(np.uint8)
    frame[0, :4, 3] = (0, 1, 254, 255)
    if lib == "numpy":
        monkeypatch.setattr(tframe, "_frame_lib", lambda: None)
        monkeypatch.setattr(jframe, "_frame_lib", lambda: None)
    else:
        assert tframe._frame_lib() is not None and jframe._frame_lib()
    got = tframe.composite_black(frame)
    assert got.shape == (24, 40, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jframe.composite_black(frame))


def _png_rgba(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.mark.parametrize("encoder", ["pil", "zlib"])
def test_png_encoders_round_trip(tmp_path, monkeypatch, encoder):
    """``encode_png`` through PIL, and through its own zlib writer where
    PIL is missing (the viewer's two paths); the latter is also the form
    chip_smoke decodes without PIL."""
    from chip_smoke import png_rgba
    from nbody_simulation_tpu_torch.utils.pngio import encode_png, save_png
    frame = np.random.default_rng(8).integers(0, 256, (20, 33, 4),
                                              dtype=np.uint8)
    if encoder == "zlib":
        monkeypatch.setitem(sys.modules, "PIL", None)
    data = encode_png(frame)
    save_png(tmp_path / "f.png", frame)
    assert (tmp_path / "f.png").read_bytes() == data
    np.testing.assert_array_equal(png_rgba(data), frame)
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    np.testing.assert_array_equal(_png_rgba(tmp_path / "f.png"), frame)


@pytest.mark.parametrize("source", ["stream", "sharded"])
def test_render_recording_matches_the_jax_tool(tmp_path, source):
    traj = _trajectory(seed=6, frames=5)
    if source == "stream":
        rec = tmp_path / "r.bin"
        _write(jrec.Recorder(rec, every=1), traj)
        _, _, mass = _state_arrays(seed=6, n=380)  # fewer rows: unit-filled
        mass[::7] = 40.0                           # heavy: green
        ck = tmp_path / "ck.npz"
        jck.save_checkpoint(ck, JaxState.create(traj[-1][:380],
                                                np.zeros((380, 2)), mass), 4)
        extra = ["--state", str(ck), "--every", "2"]
    else:
        rec = tmp_path / "sh"
        _sharded_recording(rec, traj)
        extra = []
    common = [str(rec), "--render-size", "64", "--quiet", *extra]
    assert jrender.main([*common, "--out", str(tmp_path / "j"),
                         "--platform", "cpu"]) == 0
    assert trender.main([*common, "--out", str(tmp_path / "t"),
                         "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    # --every 2 of 5 frames; the sharded streams record every 2nd step.
    assert names == [f"frame_{s:08d}.png" for s in (0, 2, 4)]
    lit = 0
    for name in names:
        want = _png_rgba(tmp_path / "j" / name)
        np.testing.assert_array_equal(_png_rgba(tmp_path / "t" / name), want)
        lit += int((want[..., 3] > 0).sum())
    assert lit > 0


def test_render_recording_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    rec = tmp_path / "r.bin"
    _write(trec.Recorder(rec), _trajectory(frames=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trender.main([str(rec), "--out", str(tmp_path / "o")])


def test_render_recording_state_tints_rows_before_the_last_resort(tmp_path):
    """The row mapping the ``--state`` help warns of: a checkpoint holds
    the masses in the final Morton order, so frames recorded before the
    last re-sort get the masses of other rows. Reproduced, not fixed."""
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models import World
    from nbody_simulation_tpu_torch.ops.raster import render_frame

    pos, vel, mass = _state_arrays(seed=7, n=500)
    mass[::5] = 50.0
    # Fast enough that each re-sort reorders many rows.
    world = World(ParticleState.create(pos, vel * 2000, mass),
                  SimConfig(force_path="bh", resort_every=4))
    rec = trec.Recorder(tmp_path / "r.bin", every=1)
    masses = {}
    for step in (2, 9):  # re-sorts at steps 0, 4 and 8
        world.run(step - world.updates)
        rec.record(world.state.pos[:500].numpy(), step)
        masses[step] = world.state.mass[:500].clone()
    rec.close()
    tck.save_checkpoint(tmp_path / "ck.npz", world.state.real_slice(), 9)
    assert trender.main([str(tmp_path / "r.bin"), "--out", str(tmp_path / "o"),
                         "--state", str(tmp_path / "ck.npz"), "--device",
                         "cpu", "--render-size", "64", "--quiet"]) == 0
    for step, pos in trec.playback(tmp_path / "r.bin"):
        tpos = torch.from_numpy(pos)
        true = render_frame(tpos, torch.zeros_like(tpos), masses[step],
                            render_size=64).numpy()
        got = _png_rgba(tmp_path / "o" / f"frame_{step:08d}.png")
        assert np.array_equal(got, true) == (step == 9), step


# -- the CLI -----------------------------------------------------------------

BH = ["--device", "cpu", "--scenario", "uniform", "--n", "500",
      "--force-path", "bh", "--render-size", "64"]


def test_cli_resume_is_bitwise_an_unbroken_run(tmp_path, capsys):
    """--checkpoint after 10 steps, --resume for 10 more: the live rows
    bitwise the 20-step run's, across the re-sort at step 16. The padding
    rows keep their sentinel positions in both runs; they feel the live
    particles' pull (a speed of ~1e-11 per step, as in the JAX package),
    which moves no position by an ulp of 1e6, and they pull nothing (mass
    0). A checkpoint drops them, so the resumed run's pads restart at
    rest."""
    whole = run.simulate([*BH, "--steps", "20", "--out", str(tmp_path / "a"),
                          "--checkpoint", str(tmp_path / "ck20.npz")])
    run.simulate([*BH, "--steps", "10", "--out", str(tmp_path / "b"),
                  "--checkpoint", str(tmp_path / "ck10.npz")])
    out = capsys.readouterr().out
    assert f"checkpoint: {tmp_path / 'ck10.npz'} @ step 10" in out
    resumed = run.simulate([*BH, "--resume", str(tmp_path / "ck10.npz"),
                            "--steps", "10", "--out", str(tmp_path / "c"),
                            "--checkpoint", str(tmp_path / "ck20r.npz")])
    out = capsys.readouterr().out
    assert "len: 500" in out and "done: 10 steps" in out
    assert (tmp_path / "c" / "frame_00000020.png").exists()
    assert resumed.updates == whole.updates == 20
    assert resumed.state.n == whole.state.n == 512
    _assert_bitwise(_arrays(resumed.state.real_slice()),
                    _arrays(whole.state.real_slice()))
    for w in (whole, resumed):
        pads = w.state.pos[500:].numpy()
        np.testing.assert_array_equal(pads, -1e6 + np.arange(12)[:, None]
                                      + np.zeros((1, 2)))
        assert not w.state.mass[500:].any()
        assert float(w.state.vel[500:].abs().max()) < 1e-9
    a, b = _npz(tmp_path / "ck20.npz"), _npz(tmp_path / "ck20r.npz")
    assert a["step"] == b["step"] == 20 and a["n_real"] == b["n_real"] == 500
    assert a["pos"].shape == (500, 2)
    _assert_bitwise(a, b)


def _sorted(d):
    o = np.lexsort((d["pos"][:, 1], d["pos"][:, 0]))
    return {k: d[k][o] for k in FIELDS}


def test_cli_resumes_a_jax_checkpoint_like_the_jax_cli(tmp_path):
    common = ["--scenario", "uniform", "--n", "500", "--force-path", "bh",
              "--render-size", "64", "--quiet"]
    jax_cli = [*common, "--platform", "cpu"]
    assert jrun.main([*jax_cli, "--steps", "10", "--out",
                      str(tmp_path / "j"), "--checkpoint",
                      str(tmp_path / "j10.npz")]) == 0
    assert jrun.main([*jax_cli, "--resume", str(tmp_path / "j10.npz"),
                      "--steps", "10", "--out", str(tmp_path / "j"),
                      "--checkpoint", str(tmp_path / "j20.npz")]) == 0
    assert run.main([*common, "--device", "cpu", "--resume",
                     str(tmp_path / "j10.npz"), "--steps", "10", "--out",
                     str(tmp_path / "t"), "--checkpoint",
                     str(tmp_path / "t20.npz")]) == 0
    j, t = _npz(tmp_path / "j20.npz"), _npz(tmp_path / "t20.npz")
    assert j["step"] == t["step"] == 20 and j["n_real"] == t["n_real"] == 500
    # Step 16 re-sorts by the current positions: compare sorted by (x, y).
    j, t = _sorted(j), _sorted(t)
    np.testing.assert_array_equal(t["mass"], j["mass"])
    assert np.all(np.abs(t["pos"] - j["pos"])
                  <= 4 * np.spacing(np.abs(j["pos"])))
    assert (np.abs(t["vel"] - j["vel"]).max()
            <= 4 * np.spacing(np.abs(j["vel"]).max()))


def test_cli_record_writes_a_playable_recording(tmp_path, capsys):
    world = run.simulate([*BH, "--steps", "20", "--steps-per-snapshot", "5",
                          "--snapshot-interval", "0", "--out",
                          str(tmp_path), "--record", str(tmp_path / "r.bin")])
    out = capsys.readouterr().out
    frames = list(trec.playback(tmp_path / "r.bin"))
    assert f"recording: {len(frames)} frames" in out
    steps = [s for s, _ in frames]
    assert steps[-1] == 20 and all(s % 10 == 0 for s in steps[1:])
    assert all(p.shape == (500, 2) for _, p in frames)
    np.testing.assert_allclose(frames[-1][1], world.state.pos[:500].numpy(),
                               rtol=0, atol=2 * len(frames)
                               * np.spacing(np.float32(1e5)))


def _gif_frames_kept(snapshots: int, cap: int) -> int:
    frames, stride = 0, 1
    for seen in range(snapshots):
        if seen % stride == 0:
            frames += 1
            if frames > cap:
                frames, stride = (frames + 1) // 2, stride * 2
    return frames


def test_cli_gif_doubles_its_stride_past_the_cap(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(run, "GIF_MAX_FRAMES", 4)
    run.simulate([*BH, "--steps", "40", "--steps-per-snapshot", "1",
                  "--snapshot-interval", "0", "--out", str(tmp_path),
                  "--gif", str(tmp_path / "a.gif")])
    out = capsys.readouterr().out
    kept = int(out.split(" snapshots kept")[0].rsplit(" ", 1)[1])
    assert kept > 4
    want = _gif_frames_kept(kept, 4)
    assert f"gif: {tmp_path / 'a.gif'} ({want} frames)" in out
    assert want <= 4
    assert (tmp_path / "a.gif").read_bytes()[:6] == b"GIF89a"


def test_cli_gif_without_pil_is_skipped(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    run.simulate([*BH, "--steps", "2", "--steps-per-snapshot", "1",
                  "--out", str(tmp_path), "--gif", str(tmp_path / "a.gif")])
    assert "gif: PIL unavailable, skipped" in capsys.readouterr().out
    assert not (tmp_path / "a.gif").exists()


def test_cli_serve_runs_the_viewer_and_returns(tmp_path, capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert run.main([*BH, "--n", "256", "--steps", "4", "--serve", str(port),
                     "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"viewer: http://127.0.0.1:{port}/" in out
    assert "done: 4 steps" in out
