"""The port's sharded all-pairs path against the JAX package.

The JAX functions run on the 8 virtual CPU devices (``make_1d_mesh(P)``),
their Pallas kernels in interpret mode, each under one ``jax.jit`` (op by op
a shard_map costs seconds). The port runs the same numpy inputs on a
``LocalMesh(P, "cpu")``, where every kernel wrapper takes its plain version;
the cross-shard kernel K9 itself runs only on a card (chip_smoke.py holds it
to ``allpairs_accel_sym_pair_ref`` there). One test runs the port's
``ProcessGroupMesh`` in three gloo processes and holds it to ``LocalMesh``.

Tolerances: forces summed in another order within 1e-5 of Σ_j |c_ij| per
row and component (K9), or 1e-5 relative per row where the sums are whole
forces on a random cloud (the rings; a zero row must be exactly zero).
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu.config import SimConfig as JSimConfig
from nbody_simulation_tpu.ops import allpairs as jap
from nbody_simulation_tpu.parallel import mesh as jmesh
from nbody_simulation_tpu.parallel import raster as jraster
from nbody_simulation_tpu.parallel import ring as jring
from nbody_simulation_tpu.parallel import ring_grad as jring_grad
from nbody_simulation_tpu.parallel import sharded_step as jstep
from nbody_simulation_tpu.state import ParticleState as JState
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops import allpairs as tap
from nbody_simulation_tpu_torch.ops.force import pair_accel
from nbody_simulation_tpu_torch.ops.raster import render_frame
from nbody_simulation_tpu_torch.parallel import (LocalMesh, make_1d_mesh,
                                                 make_sharded_step,
                                                 ring_allpairs_accel,
                                                 ring_allpairs_accel_diff,
                                                 shard_state,
                                                 sharded_diagnostics,
                                                 sharded_render_frame,
                                                 sharded_total_energy)
from nbody_simulation_tpu_torch.parallel import ring as tring
from nbody_simulation_tpu_torch.state import ParticleState

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = Path(__file__).resolve().parents[1]
SUM_RTOL = 1e-5
ROW_RTOL = 1e-5
TILE = 64


def cloud(seed, n, vel=False):
    """Uniform positions in [0, 1e5)², masses 1..99, velocities N(0, 1)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100_000, size=(n, 2)).astype(np.float32)
    mass = rng.integers(1, 100, size=n).astype(np.float32)
    v = rng.normal(0, 1, size=(n, 2)).astype(np.float32)
    return (pos, mass, v) if vel else (pos, mass)


def abs_scale(tpos, spos, smass):
    """Σ_j |c_ij| per target and component (float64)."""
    t, s = (torch.tensor(a, dtype=torch.float64) for a in (tpos, spos))
    ax, ay = pair_accel(s[None, :, 0] - t[:, 0:1], s[None, :, 1] - t[:, 1:2],
                        torch.tensor(smass, dtype=torch.float64)[None, :])
    return np.stack([ax.abs().sum(1).numpy(), ay.abs().sum(1).numpy()], 1)


def close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


def close_per_row(got, want):
    """Relative error per row within ROW_RTOL; a zero row exactly zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want, axis=1)
    zero = norm == 0
    assert np.all(got[zero] == 0)
    rel = np.linalg.norm(got - want, axis=1)[~zero] / norm[~zero]
    assert rel.max() <= ROW_RTOL, rel.max()


def both_states(n, p, seed):
    """The same system sharded by both packages: ``(jax_state, port_state,
    jax_mesh, port_mesh)``."""
    pos, mass, vel = cloud(seed, n, vel=True)
    jm = jmesh.make_1d_mesh(p)
    js = jmesh.shard_state(JState.create(pos, vel, mass), jm)
    tm = LocalMesh(p, "cpu")
    ts = shard_state(ParticleState.create(pos, vel, mass), tm)
    return js, ts, jm, tm


# -- K9: the cross-shard symmetric kernel ------------------------------------

@pytest.mark.parametrize("n,tile", [(256, 64), (512, 128)])
def test_sym_pair_matches_jax(n, tile):
    """Both sides against the JAX kernel, with zero-mass padding rows on
    each side (they exert nothing and receive finite forces)."""
    pi, mi = cloud(1, n)
    pj, mj = cloud(2, n)
    mi[-56:] = 0.0
    mj[-40:] = 0.0
    wi, wj = (np.asarray(a) for a in jap.allpairs_accel_sym_pair(
        *(jnp.asarray(a) for a in (pi, mi, pj, mj)), tile=tile,
        interpret=True))
    gi, gj = tap.allpairs_accel_sym_pair(
        *(torch.tensor(a) for a in (pi, mi, pj, mj)), tile=tile)
    assert np.isfinite(gi.numpy()).all() and np.isfinite(gj.numpy()).all()
    close_in_sum(gi.numpy(), wi, abs_scale(pi, pj, mj))
    close_in_sum(gj.numpy(), wj, abs_scale(pj, pi, mi))


@pytest.mark.parametrize("rcp", ["exact", "newton+clamp"])
def test_sym_pair_nan_pattern_matches_jax(rcp):
    """One NaN x on the i side: that row's x is NaN and its y 0, the other
    i rows finite; on the j side every x is NaN and every y finite (d·(m·0)
    with d NaN, as K2). On the CPU both packages compute ``exact`` in every
    mode; on a card the +clamp modes turn every component the NaN particle
    touches NaN (chip_smoke.py)."""
    pi, mi = cloud(3, 256)
    pj, mj = cloud(4, 256)
    pi[5, 0] = np.nan
    want = [np.asarray(a) for a in jap.allpairs_accel_sym_pair(
        *(jnp.asarray(a) for a in (pi, mi, pj, mj)), tile=64, rcp=rcp,
        interpret=True)]
    got = [a.numpy() for a in tap.allpairs_accel_sym_pair(
        *(torch.tensor(a) for a in (pi, mi, pj, mj)), tile=64, rcp=rcp)]
    wi, wj = want
    assert np.isnan(wi[5, 0]) and wi[5, 1] == 0.0
    assert np.isfinite(np.delete(wi, 5, axis=0)).all()
    assert np.isnan(wj[:, 0]).all() and np.isfinite(wj[:, 1]).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert got[0][5, 1] == 0.0
    pi[5, 0] = 0.0
    close_in_sum(np.delete(got[0], 5, axis=0), np.delete(wi, 5, axis=0),
                 np.delete(abs_scale(pi, pj, mj), 5, axis=0))
    close_in_sum(got[1][:, 1], wj[:, 1], abs_scale(pj, pi, mi)[:, 1])


def test_sym_pair_checks():
    p, m = (torch.tensor(a) for a in cloud(5, 128))
    with pytest.raises(ValueError, match="same length"):
        tap.allpairs_accel_sym_pair(p, m, p[:64], m[:64])
    with pytest.raises(ValueError, match="not divisible by tile"):
        tap.allpairs_accel_sym_pair(p[:96], m[:96], p[:96], m[:96], tile=64)
    with pytest.raises(ValueError, match="rcp must be one of"):
        tap.allpairs_accel_sym_pair(p, m, p, m, rcp="fast")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tap.allpairs_sym_pair_cuda(p, m, p, m)
    with pytest.raises(ValueError, match="device meta"):
        tap.allpairs_accel_sym_pair(*(a.to("meta") for a in (p, m, p, m)))


# -- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(1, 1), (7, 3), (170, 3), (1000, 8),
                                 (5000, 2), (20_000, 3)])
def test_shard_state_pads_like_jax(n, p):
    js, ts, _, _ = both_states(n, p, seed=n)
    assert ts.n == js.n and ts.n_real == js.n_real == n
    for a, b in ((ts.pos, js.pos), (ts.vel, js.vel), (ts.mass, js.mass)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mesh_collectives_and_cuda_default(monkeypatch):
    mesh = make_1d_mesh(3, device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.n_shards == 3
    x = torch.arange(6.0).reshape(6, 1)
    assert mesh.ppermute(x, 1).flatten().tolist() == [4, 5, 0, 1, 2, 3]
    assert mesh.ppermute(x, -1).flatten().tolist() == [2, 3, 4, 5, 0, 1]
    per = torch.tensor([[1, 5], [3, 2], [2, 2]], dtype=torch.int32)
    assert mesh.psum(per).tolist() == [6, 9]
    assert mesh.psum(per).dtype == torch.int32
    assert mesh.pmax(per).tolist() == [3, 5]
    assert mesh.axis_index().tolist() == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_1d_mesh(3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalMesh(3)


def test_symring_profitable_matches_jax():
    for p in range(1, 18):
        assert tring.symring_profitable(p) == jring.symring_profitable(p)


# -- the rings ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ring(p, n, sym_ring):
    pos, mass = cloud(10 + p, n)
    mesh = jmesh.make_1d_mesh(p)
    st = jmesh.shard_state(JState.create(pos, np.zeros_like(pos), mass),
                           mesh)
    f = jax.jit(functools.partial(jring.ring_allpairs_accel, mesh=mesh,
                                  tile_i=TILE, tile_j=TILE, sym_tile=TILE,
                                  sym_ring=sym_ring))
    return np.asarray(f(st.pos, st.mass))


@pytest.mark.parametrize("p,n,sym_ring", [
    (1, 64, "auto"),
    (3, 192, "auto"), (3, 192, True), (3, 192, False),
    (4, 256, "auto"), (4, 256, True), (4, 256, False),
    (8, 512, "auto"), (8, 512, True), (8, 512, False),
    (3, 170, "auto"),    # 170 → 3 shards of 64, with padding rows
])
def test_ring_matches_jax(p, n, sym_ring, monkeypatch):
    """Same result and the same kernel family as the JAX ring: K9 only on
    the symmetric ring, ⌊P/2⌋ rounds on every shard; K2 on every self
    stage; K1 on every visiting stage of the ordered ring."""
    symring = (jring.symring_profitable(p) if sym_ring == "auto"
               else sym_ring) and p > 1
    want = _jax_ring(p, n, symring if sym_ring == "auto" else sym_ring)
    calls = {"K9": 0, "K2": 0, "K1": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, attr in (("K9", "allpairs_accel_sym_pair"),
                       ("K2", "allpairs_accel_sym"),
                       ("K1", "allpairs_accel")):
        monkeypatch.setattr(tring, attr, counted(name, getattr(tring, attr)))
    pos, mass = cloud(10 + p, n)
    mesh = LocalMesh(p, "cpu")
    st = shard_state(ParticleState.create(pos, np.zeros_like(pos), mass),
                     mesh)
    got = ring_allpairs_accel(st.pos, st.mass, mesh, tile_i=TILE,
                              tile_j=TILE, sym_tile=TILE, sym_ring=sym_ring)
    close_per_row(got.numpy(), want)
    assert calls == ({"K9": p * (p // 2), "K2": p, "K1": 0} if symring
                     else {"K9": 0, "K2": p, "K1": p * (p - 1)})


def test_sharded_step_matches_jax():
    """Two steps of the sharded step, P=3 with padding rows."""
    js, ts, jm, tm = both_states(170, 3, seed=20)
    jcfg, tcfg = JSimConfig(), SimConfig()
    jst = jstep.make_sharded_step(jm, jcfg, tile_i=TILE, tile_j=TILE)
    tst = make_sharded_step(tm, tcfg, tile_i=TILE, tile_j=TILE)
    for _ in range(2):
        js, ts = jst(js), tst(ts)
    close_per_row(ts.pos.numpy(), np.asarray(js.pos))
    close_per_row(ts.vel.numpy(), np.asarray(js.vel))
    assert ts.n_real == js.n_real


def test_sharded_diagnostics_and_energy_match_jax():
    js, ts, jm, tm = both_states(170, 3, seed=21)
    want = jax.jit(functools.partial(jstep.sharded_diagnostics,
                                     mesh=jm))(js)
    got = sharded_diagnostics(ts, tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5)
    assert got["n_live"].item() == 170
    want = jax.jit(functools.partial(jstep.sharded_total_energy, mesh=jm,
                                     tile_i=TILE, tile_j=TILE))(js)
    got = sharded_total_energy(ts, tm, tile_i=TILE, tile_j=TILE)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)


def test_ring_grad_matches_jax():
    """P=3: the forward is the symmetric ring's, bitwise the run mode's;
    the gradient of Σ a·ḡ in positions and masses within 1e-5 of
    ``jax.grad`` of the JAX ring (both divide exactly on the CPU)."""
    pos, mass = cloud(30, 192)
    cot = np.random.default_rng(31).normal(0, 1, (192, 2)).astype(np.float32)
    jm = jmesh.make_1d_mesh(3)
    kw = dict(tile_i=TILE, tile_j=TILE, sym_tile=TILE)

    def loss(p, m):
        return jnp.sum(jring_grad.ring_allpairs_accel_diff(p, m, jm, **kw)
                       * cot)

    wp, wm = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(pos),
                                                     jnp.asarray(mass))
    tm = LocalMesh(3, "cpu")
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    a = ring_allpairs_accel_diff(p, m, tm, **kw)
    assert torch.equal(a.detach(), ring_allpairs_accel(
        p.detach(), m.detach(), tm, **kw))
    (a * torch.tensor(cot)).sum().backward()
    for got, want in ((p.grad, wp), (m.grad, wm)):
        want = np.asarray(want, np.float64)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, rel


def test_sharded_render_frame_matches_jax():
    """Pixel for pixel the JAX sharded frame and the port's single-device
    frame of the concatenated arrays, on a 64² frame where heavy and light
    particles of different shards share pixels."""
    rng = np.random.default_rng(40)
    n = 700
    pos = rng.uniform(0, 100_000, (n, 2)).astype(np.float32)
    pos[::7] = pos[1::7][:pos[::7].shape[0]]     # shared pixels
    pos[3, 0] = np.nan
    vel = rng.normal(0, 20, (n, 2)).astype(np.float32)
    mass = np.where(rng.random(n) < 0.2, 50.0, 1.0).astype(np.float32)
    jm = jmesh.make_1d_mesh(3)
    js = jmesh.shard_state(JState.create(pos, vel, mass), jm)
    want = np.asarray(jraster.sharded_render_frame(
        js.pos, js.vel, js.mass, jm, render_size=64))
    tm = LocalMesh(3, "cpu")
    ts = shard_state(ParticleState.create(pos, vel, mass), tm)
    got = sharded_render_frame(ts.pos, ts.vel, ts.mass, tm, render_size=64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), render_frame(ts.pos, ts.vel, ts.mass,
                                  render_size=64).numpy())
    assert (want[..., 3] > 0).sum() > 100


# -- ProcessGroupMesh: one shard per gloo rank --------------------------------

_RANK_CODE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from nbody_simulation_tpu_torch.parallel import (
    init_distributed, make_1d_mesh, ring_allpairs_accel, shard_state,
    sharded_diagnostics, sharded_render_frame)
from nbody_simulation_tpu_torch.state import ParticleState
addr, world, rank, out = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
if world == "-":
    init_distributed(device="cpu")
else:
    init_distributed(addr, int(world), int(rank), device="cpu")
mesh = make_1d_mesh(device="cpu")
rng = np.random.default_rng(50)
pos = rng.uniform(0, 1e5, (170, 2)).astype(np.float32)
vel = rng.normal(0, 1, (170, 2)).astype(np.float32)
mass = rng.integers(1, 100, 170).astype(np.float32)
st = shard_state(ParticleState.create(pos, vel, mass), mesh)
acc = ring_allpairs_accel(st.pos, st.mass, mesh, tile_i=64, tile_j=64,
                          sym_tile=64)
diag = sharded_diagnostics(st, mesh)
frame = sharded_render_frame(st.pos, st.vel, st.mass, mesh, render_size=64)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "nbody_simulation_tpu")]
torch.save({"n_shards": mesh.n_shards, "kind": type(mesh).__name__,
            "acc": acc, "diag": diag, "frame": frame, "bad": bad}, out)
torch.distributed.destroy_process_group()
"""


def test_process_group_mesh_matches_local_mesh(tmp_path):
    """Three gloo ranks run the symmetric ring (K9's plain version, one
    round), the diagnostics and the frame; each rank's forces are bitwise
    its block of the ``LocalMesh(3)`` result. Ranks 0 and 1 pass
    ``init_distributed`` its arguments, rank 2 torchrun's variables; a
    fourth process configures nothing and gets a one-process group. A
    process that hangs fails the test after 60 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    by_env = dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                  WORLD_SIZE="3", RANK="2")
    runs = [("3", "0", env), ("3", "1", env), ("-", "-", by_env),
            ("-", "-", env)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CODE, f"127.0.0.1:{port}", world, rank,
         str(tmp_path / f"rank{i}.pt")], cwd=REPO, env=penv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (world, rank, penv) in enumerate(runs)]
    try:
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [torch.load(tmp_path / f"rank{i}.pt") for i in range(4)]

    rng = np.random.default_rng(50)
    pos = rng.uniform(0, 1e5, (170, 2)).astype(np.float32)
    vel = rng.normal(0, 1, (170, 2)).astype(np.float32)
    mass = rng.integers(1, 100, 170).astype(np.float32)
    tm = LocalMesh(3, "cpu")
    st = shard_state(ParticleState.create(pos, vel, mass), tm)
    acc = ring_allpairs_accel(st.pos, st.mass, tm, tile_i=TILE, tile_j=TILE,
                              sym_tile=TILE)
    diag = sharded_diagnostics(st, tm)
    frame = sharded_render_frame(st.pos, st.vel, st.mass, tm, render_size=64)
    for r in range(3):
        assert res[r]["kind"] == "ProcessGroupMesh"
        assert res[r]["n_shards"] == 3 and res[r]["bad"] == []
        assert torch.equal(res[r]["acc"], acc[r * 64:(r + 1) * 64])
        assert torch.equal(res[r]["frame"], frame)
        for k in diag:
            np.testing.assert_allclose(res[r]["diag"][k].numpy(),
                                       diag[k].numpy(), rtol=1e-6)
    one = res[3]
    assert one["kind"] == "ProcessGroupMesh" and one["n_shards"] == 1
    m1 = LocalMesh(1, "cpu")
    st1 = shard_state(ParticleState.create(pos, vel, mass), m1)
    assert torch.equal(one["acc"], ring_allpairs_accel(
        st1.pos, st1.mass, m1, tile_i=TILE, tile_j=TILE, sym_tile=TILE))
