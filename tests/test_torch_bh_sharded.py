"""The port's replicated-tree sharded Barnes-Hut.

Every shard gathers the whole system, builds the same tree and sweeps its
own 1/P of the leaf groups, so the walk is the single-device ``bh_accel``'s
with ``plan_leaves=1``: on the CPU, where each group's plain sweep is the
same arithmetic whatever groups are swept beside it, the two are bitwise
equal. One small case is held to the JAX package's ``bh_sharded_accel`` on
the 8 virtual CPU devices (interpret mode, under one ``jax.jit``): each
package builds its own tree, so only the summation order differs, within
1e-5 of Σ_j |c_ij| per row and component.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nbody_simulation_tpu.config import SimConfig as JSimConfig
from nbody_simulation_tpu.parallel import bh_sharded as jbh
from nbody_simulation_tpu.parallel import mesh as jmesh
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.force import pair_accel
from nbody_simulation_tpu_torch.ops.integrate import euler_step
from nbody_simulation_tpu_torch.ops.traversal import bh_accel
from nbody_simulation_tpu_torch.parallel import (LocalMesh, bh_sharded_accel,
                                                 make_sharded_bh_step,
                                                 shard_state)
from nbody_simulation_tpu_torch.state import ParticleState

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def sharded_cloud(n, p, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100_000, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 1, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 100, n).astype(np.float32)
    mesh = LocalMesh(p, "cpu")
    return shard_state(ParticleState.create(pos, vel, mass), mesh), mesh


def single_device(state, cfg):
    fcap, lcap = cfg.resolved_caps()
    return bh_accel(state.pos, state.mass, theta=cfg.theta,
                    softening2=cfg.softening2, leaf_size=cfg.leaf_size,
                    world_size=cfg.world_size,
                    unweighted_leaf_com=cfg.unweighted_leaf_com,
                    frontier_cap=fcap, leaf_cap=lcap, arity=cfg.tree_arity,
                    morton_bits=cfg.resolved_morton_bits(),
                    multipole=cfg.resolved_multipole(),
                    rcp=cfg.resolved_rcp(bh=True))


@pytest.mark.parametrize("p,cfg", [
    (4, SimConfig(force_path="bh")),                      # θ=50, K3
    (8, SimConfig(force_path="bh", leaf_size=16)),
    (4, SimConfig(force_path="bh", theta=0.5,             # θ<2, K4
                  unweighted_leaf_com=False, frontier_cap=64, leaf_cap=32)),
    (2, SimConfig(force_path="bh", theta=0.5, tree_arity=4,
                  frontier_cap=32, leaf_cap=16)),
])
def test_bh_sharded_matches_single_device(p, cfg):
    st, mesh = sharded_cloud(1000, p, seed=p)
    got = bh_sharded_accel(st.pos, st.mass, mesh, config=cfg)
    assert torch.equal(got, single_device(st, cfg))


def test_sharded_bh_step_matches_single_device():
    cfg = SimConfig(force_path="bh")
    st, mesh = sharded_cloud(700, 4, seed=9)
    step = make_sharded_bh_step(mesh, cfg)
    ref = st
    for _ in range(2):
        st = step(st)
        ref = euler_step(ref, single_device(ref, cfg), cfg.dt)
    assert torch.equal(st.pos, ref.pos) and torch.equal(st.vel, ref.vel)
    assert torch.isfinite(st.pos).all() and st.n_real == 700


def test_bh_sharded_needs_leaves_divisible_by_shards():
    st, mesh = sharded_cloud(500, 3, seed=1)
    with pytest.raises(ValueError, match="do not split over 3 shards"):
        bh_sharded_accel(st.pos, st.mass, mesh)


def test_bh_sharded_matches_jax():
    st, mesh = sharded_cloud(256, 2, seed=11)
    jcfg = JSimConfig(force_path="bh", leaf_size=16)
    f = jax.jit(functools.partial(jbh.bh_sharded_accel,
                                  mesh=jmesh.make_1d_mesh(2), config=jcfg))
    want = np.asarray(f(st.pos.numpy(), st.mass.numpy()))
    got = bh_sharded_accel(st.pos, st.mass, mesh,
                           config=SimConfig(force_path="bh", leaf_size=16))
    p = st.pos.double()
    ax, ay = pair_accel(p[None, :, 0] - p[:, 0:1], p[None, :, 1] - p[:, 1:2],
                        st.mass.double()[None, :])
    scale = np.stack([ax.abs().sum(1).numpy(), ay.abs().sum(1).numpy()], 1)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= 1e-5 * scale), (err / scale).max()
