"""The port's fully distributed Barnes-Hut against the JAX package.

The JAX functions run on the 8 virtual CPU devices under one ``jax.jit``
each (op by op a shard_map costs seconds), their Pallas sweeps in interpret
mode; the port runs on ``LocalMesh(P, "cpu")``, where every sweep is the
plain version ``grouped_force_ref``. The layouts (``distribute_state``,
``rebalance_state``) and the seam matchings are host numpy and held
bitwise. The forces are held per row and component against Σ_j |c_ij| of
the all-pairs law (a relative error is ill-conditioned where forces
cancel):

- where both packages plan the same nodes, the sums differ in order only:
  |Δa| ≤ 1e-5·Σ|c|;
- each package builds its own trees, and XLA contracts the tree's COM sums
  into FMAs (tests/test_torch_quad.py), so internal COMs differ by an ulp.
  At θ=50 a node whose COM lies on a group's box edge passes or fails the
  acceptance test by that ulp, and the rows of that group take the node's
  COM in one package and its children in the other: a Barnes-Hut
  difference, below 2e-3·Σ|c|, on under 1% of the rows.

One test starts four gloo ranks (no JAX in them) and holds their
``ProcessGroupMesh`` step and gradient bitwise to ``LocalMesh(4)``'s.
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

from nbody_simulation_tpu import parallel as jpar
from nbody_simulation_tpu.config import SimConfig as JSimConfig
from nbody_simulation_tpu.models import scenarios as jscen
from nbody_simulation_tpu.state import ParticleState as JState
from nbody_simulation_tpu_torch import parallel as par
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models import scenarios as tscen
from nbody_simulation_tpu_torch.ops.force import pair_accel
from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
from nbody_simulation_tpu_torch.parallel import bh_distributed as bd
from nbody_simulation_tpu_torch.parallel.mesh import LocalMesh, map_shards
from nbody_simulation_tpu_torch.parallel.multihost import (chunk_bounds,
                                                           local_layout,
                                                           multihost_state)

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = Path(__file__).resolve().parents[1]
SUM_RTOL = 1e-5

# θ=50 with 8-particle leaves: 64 leaves a shard at N=4096, so the near
# stages refine (the compute-to-data exchange is live).
T50 = dict(leaf_size=8)
# θ=0.5 with seam matchings, small caps, and a cut of one particle per slot
# range, fine enough that some shard pairs are no seam and meet in the
# forest.
T05 = dict(theta=0.5, unweighted_leaf_com=False, frontier_cap=16,
           leaf_cap=32, plan_leaves=1, leaf_size=8, forest_levels=10)
# The ring with the full caps at every distance.
RING = dict(theta=0.5, unweighted_leaf_com=False, frontier_cap=64,
            leaf_cap=64, plan_leaves=1, leaf_size=8, far_mode="ring",
            far_frontier_cap=64, far_leaf_cap=64)


@functools.lru_cache(maxsize=None)
def jmesh(p):
    return jpar.make_1d_mesh(p)


def both(kw, n=4096, seed=2, p=8):
    """The same system laid out by both packages: (port state, mesh,
    config, JAX state, mesh, config)."""
    cfg, jcfg = SimConfig(force_path="bh", **kw), JSimConfig(force_path="bh",
                                                           **kw)
    mesh = LocalMesh(p, "cpu")
    ds = par.distribute_state(tscen.uniform_disc(n, seed=seed), mesh, cfg)
    jds = jpar.distribute_state(jscen.uniform_disc(n, seed=seed), jmesh(p),
                                jcfg)
    return ds, mesh, cfg, jds, jmesh(p), jcfg


def sum_scale(pos, mass):
    """Σ_j |c_ij| of the all-pairs law per row and component (f64)."""
    p, m = pos.double(), mass.double()
    ax, ay = pair_accel(p[None, :, 0] - p[:, 0:1], p[None, :, 1] - p[:, 1:2],
                        m[None, :])
    return torch.stack([ax.abs().sum(1), ay.abs().sum(1)], 1).numpy()


def test_distribute_state_is_the_jax_layout():
    ds, _, cfg, jds, _, _ = both(T05, n=3000)
    for k in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(getattr(ds, k).numpy(),
                                      np.asarray(getattr(jds, k)))
    assert (ds.n_real, ds.distributed) == (jds.n_real, True)
    assert ds.n // 8 == local_layout(3000, 8, cfg)
    with pytest.raises(ValueError, match="compact"):
        ds.real_slice()
    live = ds.compact()
    assert live.n == 3000 and not live.distributed
    assert torch.equal(live.mass, ds.mass[ds.mass > 0])


def test_rebalance_state_is_jax_and_the_collective_rebalance():
    """After three drifting steps the host rebalance is bitwise JAX's on
    the same arrays, and the collective one bitwise both."""
    ds, mesh, cfg, _, jm, jcfg = both(T50)
    step = par.make_distributed_bh_step(mesh, cfg)
    for _ in range(3):
        ds = step(ds)
    got = par.rebalance_state(ds, mesh, cfg)
    jds = JState(jnp.asarray(ds.pos.numpy()), jnp.asarray(ds.vel.numpy()),
                 jnp.asarray(ds.mass.numpy()), n_real=ds.n_real,
                 distributed=True)
    want = jpar.rebalance_state(jds, jm, jcfg)
    coll = par.collective_rebalance(ds, mesh, cfg)
    for k in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
        assert torch.equal(getattr(coll, k), getattr(got, k))
    assert coll.distributed and coll.n == ds.n


def test_adjacency_stages_are_jax_s():
    ds, mesh, cfg, jds, jm, jcfg = both(T05)
    got = par.adjacency_stages(ds, mesh, cfg)
    assert got == jpar.adjacency_stages(jds, jm, jcfg)
    assert len(got) > 0 and isinstance(got[0][0], tuple)
    assert sum(len(m) for m in got) < 2 * 20   # some pairs meet in the forest
    mn, mx = bd.shard_cut_aabbs(ds, mesh, cfg)
    assert mn.shape == (8, 512, 2) and (mn <= mx).all()
    assert par.resolved_seam_stages(cfg)
    assert not par.resolved_seam_stages(cfg.replace(theta=50.0))
    assert par.adjacency_stages(*both(T05, p=3)[:3]) == ()


@pytest.mark.parametrize("mode", ["theta50 forest", "theta0.5 seams",
                                  "ring exact caps"])
def test_bh_distributed_accel_matches_jax(mode):
    kw = {"theta50 forest": T50, "theta0.5 seams": T05,
          "ring exact caps": RING}[mode]
    ds, mesh, cfg, jds, jm, jcfg = both(kw, n=2048 if "ring" in mode
                                        else 4096)
    seams = mode == "theta0.5 seams"
    extra = par.adjacency_stages(ds, mesh, cfg) if seams else ()
    f = jax.jit(functools.partial(jpar.bh_distributed_accel, mesh=jm,
                                  config=jcfg, extra_pairs=extra))
    want = np.asarray(f(jds.pos, jds.mass)).astype(np.float64)
    got = par.bh_distributed_accel(ds.pos, ds.mass, mesh, config=cfg,
                                   extra_pairs=extra).numpy()
    scale = sum_scale(ds.pos, ds.mass)
    ratio = np.abs(got - want) / np.maximum(scale, 1e-300)
    if mode == "theta50 forest":
        assert ratio.max() <= 2e-3, ratio.max()
        assert (ratio.max(axis=1) > SUM_RTOL).mean() < 0.01
    else:
        assert ratio.max() <= SUM_RTOL, ratio.max()


def test_remote_near_stage_is_bitwise_the_same_device_one():
    """The compute-to-data exchange ships the visiting subtree's top levels
    and runs the open rows' continuation on the owner: the same arrays
    through the same walk, so bitwise the same-device protocol, at θ=50 on
    the ring neighbours and at θ=0.5 with refinement on the seam
    matchings (whose idle shards receive zeros)."""
    ds, mesh, cfg, *_ = both(T50)
    k0, cut, refine = bd._near_geometry(cfg, (16, 32), 6)
    assert refine and (k0, cut) == (4, 5)
    got = par.bh_distributed_accel(ds.pos, ds.mass, mesh, config=cfg)
    want = par.bh_distributed_accel(ds.pos, ds.mass, mesh,
                                    config=cfg.replace(near_remote=False))
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    qcfg = SimConfig(force_path="bh", **dict(T05, near_refine_levels=1))
    extra = par.adjacency_stages(ds, mesh, qcfg)
    assert extra and any(len(m) < 16 for m in extra)
    got = par.bh_distributed_accel(ds.pos, ds.mass, mesh, config=qcfg,
                                   extra_pairs=extra)
    want = par.bh_distributed_accel(
        ds.pos, ds.mass, mesh, config=qcfg.replace(near_remote=False),
        extra_pairs=extra)
    assert torch.equal(got, want)


def test_theta_below_2_without_seams_takes_the_ring():
    """A direct θ<2 call without ``extra_pairs`` runs the ring sweep, not
    the forest (the JAX package's rule: flushes at the cut would break the
    1e-3 budget)."""
    ds, mesh, cfg, *_ = both(T05, n=2048)
    assert cfg.resolved_far_mode() == "forest"
    got = par.bh_distributed_accel(ds.pos, ds.mass, mesh, config=cfg)
    ring = par.bh_distributed_accel(ds.pos, ds.mass, mesh,
                                    config=cfg.replace(far_mode="ring"))
    assert torch.equal(got, ring)


def test_total_energy_matches_jax():
    """Relative 1e-5: the potential terms all have one sign, so order and
    COM ulps are relative differences."""
    ds, mesh, cfg, jds, jm, jcfg = both(T50)
    got = par.bh_distributed_total_energy(ds, mesh, cfg)
    want = jpar.bh_distributed_total_energy(jds, jm, jcfg)
    for k in ("potential_energy", "kinetic_energy", "total_energy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_step_across_a_resort(integrator):
    """Three steps with a re-sort every two: steps 1 and 3 sort each
    shard's rows, step 2 keeps the order; bitwise the step written out from
    the sort, the force and the integrator; mass conserved. ``reset``
    restarts the cadence."""
    ds, mesh, cfg, *_ = both(dict(T50, resort_every=2,
                                  integrator=integrator), n=2048)
    step = par.make_distributed_bh_step(mesh, cfg)
    dt = float(np.float32(cfg.dt))
    half = float(np.float32(dt) * np.float32(0.5))
    got, want = ds, ds
    for k in range(3):
        got = step(got)
        if k % 2 == 0:
            p, v, m = map_shards(mesh, lambda a, b, c: morton_sort_state(
                a, b, c, cfg.world_size, bits=15), want.pos, want.vel,
                want.mass)
        else:
            p, v, m = want.pos, want.vel, want.mass
        acc = par.bh_distributed_accel(p, m, mesh, config=cfg)
        if integrator == "leapfrog":
            vh = v + acc * half
            p = p + vh * dt
            v = vh + par.bh_distributed_accel(p, m, mesh, config=cfg) * half
        else:
            v = v + acc * dt
            p = p + v * dt
        want = want.replace(pos=p, vel=v, mass=m)
        assert torch.equal(got.pos, want.pos) and torch.equal(got.vel,
                                                              want.vel)
    assert got.distributed
    assert float(got.mass.sum()) == float(ds.mass.sum())
    step.reset()
    again = step(ds)
    first = par.make_distributed_bh_step(mesh, cfg)(ds)
    assert torch.equal(again.pos, first.pos)


def test_step_matches_jax():
    """Three Euler steps (re-sort, stale, re-sort) of the ring with the
    full caps against the JAX step. The forces differ in summation order
    only (~1e-7 of Σ|c|), so velocities agree within rtol 1e-4 (atol 1e-5)
    and positions, ~5e4 in size, within 1e-2; the re-sorts move the same
    rows, so the masses are bitwise."""
    kw = dict(RING, resort_every=2)
    ds, mesh, cfg, jds, jm, jcfg = both(kw, n=2048, p=4)
    step = par.make_distributed_bh_step(mesh, cfg)
    jstep = jpar.make_distributed_bh_step(jm, jcfg)
    for _ in range(3):
        ds = step(ds)
        jds = jstep(jds)
    np.testing.assert_allclose(ds.pos.numpy(), np.asarray(jds.pos),
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(ds.vel.numpy(), np.asarray(jds.vel),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ds.mass.numpy(), np.asarray(jds.mass))


def test_accel_diff_forward_and_gradient_match_jax():
    """The differentiable force is bitwise the run mode's at multipole=1;
    its gradient of Σ(a·cot) with respect to positions and masses is held
    to ``jax.grad`` of the JAX function (its Pallas backward in interpret
    mode) within rtol 2e-4 and atol 1e-6 (masses 1e-8), the bounds of the
    JAX package's own gradient tests: the backward sums differ in order.
    The forest path with seams differentiates too."""
    ds, mesh, cfg, jds, jm, jcfg = both(RING, n=2048, p=4)
    cot = np.random.default_rng(3).normal(0, 1, (ds.n, 2)).astype(np.float32)
    p = ds.pos.clone().requires_grad_(True)
    m = ds.mass.clone().requires_grad_(True)
    a = par.bh_distributed_accel_diff(p, m, mesh, config=cfg)
    gp, gm = torch.autograd.grad((a * torch.as_tensor(cot)).sum(), (p, m))
    run = par.bh_distributed_accel(ds.pos, ds.mass, mesh,
                                   config=cfg.replace(multipole=1))
    assert torch.equal(a.detach(), run)

    jf = jax.jit(jax.grad(lambda pp, mm: jnp.sum(
        jpar.bh_distributed_accel_diff(pp, mm, jm, config=jcfg)
        * jnp.asarray(cot)), argnums=(0, 1)))
    jgp, jgm = jf(jds.pos, jds.mass)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=2e-4,
                               atol=1e-8)

    fs, fmesh, fcfg, *_ = both(T05, n=2048, p=8)
    extra = par.adjacency_stages(fs, fmesh, fcfg)
    fp = fs.pos.clone().requires_grad_(True)
    fa = par.bh_distributed_accel_diff(fp, fs.mass, fmesh, config=fcfg,
                                       extra_pairs=extra)
    (g,) = torch.autograd.grad((fa * fa).sum(), (fp,))
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)


def test_multihost_state_is_distribute_state():
    """One process holding every shard: the chunk padded and the collective
    repartition, bitwise ``distribute_state`` (and so the JAX layout)."""
    st = tscen.plummer(3000, seed=4)
    for p in (4, 6):
        mesh = LocalMesh(p, "cpu")
        cfg = SimConfig(force_path="bh", leaf_size=16, morton_bits=15)
        got = multihost_state(st, mesh, cfg)
        want = par.distribute_state(st, mesh, cfg)
        for k in ("pos", "vel", "mass"):
            assert torch.equal(getattr(got, k), getattr(want, k))
        assert got.distributed and got.n_real == want.n_real


def test_scenario_chunks():
    """``scenario_chunk`` with ``exact`` partitions the scenario exactly
    for any process count; ``galaxy_chunk`` is bitwise JAX's."""
    full = tscen.uniform_disc(1001, seed=5)
    for nproc in (1, 3):
        parts = [tscen.scenario_chunk("uniform", pid, nproc, seed=5,
                                      exact=True, n=1001)
                 for pid in range(nproc)]
        assert torch.equal(torch.cat([q.pos for q in parts]), full.pos)
        assert [q.n for q in parts] == [hi - lo for lo, hi in (
            chunk_bounds(1001, pid, nproc) for pid in range(nproc))]
    streamed = [tscen.scenario_chunk("plummer", pid, 3, seed=5, n=1001)
                for pid in range(3)]
    assert sum(q.n for q in streamed) == 1001
    for pid in range(3):
        got = tscen.galaxy_chunk(pid, 3, seed=1, n_random=3000)
        want = jscen.galaxy_chunk(pid, 3, seed=1, n_random=3000)
        for k in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
    assert torch.equal(tscen.galaxy_chunk(0, 1, n_random=500).pos,
                       tscen.galaxy(n_random=500).pos)


# -- ProcessGroupMesh: one shard per gloo rank --------------------------------

_RANK_CODE = r"""
import sys
import torch
torch.set_num_threads(1)
from nbody_simulation_tpu_torch import parallel as par
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.scenarios import uniform_disc
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
par.init_distributed(addr, 4, rank, device="cpu")
mesh = par.make_1d_mesh(device="cpu")
cfg = SimConfig(force_path="bh", leaf_size=8)
ds = par.distribute_state(uniform_disc(2048, seed=6), mesh, cfg)
step = par.make_distributed_bh_step(mesh, cfg)
s1 = step(ds)
p = ds.pos.clone().requires_grad_(True)
m = ds.mass.clone().requires_grad_(True)
a = par.bh_distributed_accel_diff(p, m, mesh, config=cfg)
gp, gm = torch.autograd.grad((a * a).sum(), (p, m))
coll = par.collective_rebalance(s1, mesh, cfg)
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                     "nbody_simulation_tpu")]
torch.save({"pos": s1.pos, "vel": s1.vel, "gp": gp, "gm": gm,
            "coll": coll.pos, "bad": bad}, out)
torch.distributed.destroy_process_group()
"""


def test_process_group_mesh_matches_local_mesh(tmp_path):
    """Four gloo ranks run a θ=50 forest step (ring neighbours with the
    compute-to-data exchange, the forest's all-gather), the gradient
    through the permutations' and the gather's backward, and the collective
    rebalance: each rank's rows bitwise its block of ``LocalMesh(4)``'s. A
    rank that hangs fails the test after 60 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CODE, f"127.0.0.1:{port}", str(r),
         str(tmp_path / f"rank{r}.pt")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    try:
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    mesh = LocalMesh(4, "cpu")
    cfg = SimConfig(force_path="bh", leaf_size=8)
    ds = par.distribute_state(tscen.uniform_disc(2048, seed=6), mesh, cfg)
    s1 = par.make_distributed_bh_step(mesh, cfg)(ds)
    p = ds.pos.clone().requires_grad_(True)
    m = ds.mass.clone().requires_grad_(True)
    a = par.bh_distributed_accel_diff(p, m, mesh, config=cfg)
    gp, gm = torch.autograd.grad((a * a).sum(), (p, m))
    coll = par.collective_rebalance(s1, mesh, cfg)
    L = ds.n // 4
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        rows = slice(r * L, (r + 1) * L)
        assert got["bad"] == []
        for k, want in (("pos", s1.pos), ("vel", s1.vel), ("gp", gp),
                        ("gm", gm), ("coll", coll.pos)):
            assert torch.equal(got[k], want[rows]), (r, k)
