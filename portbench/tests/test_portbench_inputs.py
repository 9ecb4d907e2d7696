"""The frozen generators against the port's, and the reference against the
port on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models import scenarios
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops.raster import render_frame
from nbody_simulation_tpu_torch.state import ParticleState
from portbench.lib import checks, generators, reference


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_galaxy_is_the_ports(seed):
    got = generators.galaxy(seed)
    want = scenarios.galaxy(seed)
    for a, b in zip(got, (want.pos, want.vel, want.mass)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plummer_is_the_ports(seed):
    got = generators.plummer(65536, seed)
    want = scenarios.plummer(65536, seed=seed)
    for a, b in zip(got, (want.pos, want.vel, want.mass)):
        assert np.array_equal(a, b.numpy())


def test_a_seed_past_32_bits_and_a_negative_one_make_states():
    a = generators.plummer(64, seed=2**31 + 12345)
    b = generators.plummer(64, seed=-3)
    assert a[0].shape == b[0].shape == (64, 2)


SIM = dict(theta=50.0, leaf_size=64, world_size=1e5, unweighted_leaf_com=True,
           softening2=1e-3, dt=0.1, resort_every=16, frontier_cap=16,
           leaf_cap=16, plan_leaves=4, morton_bits=15, multipole=1)


@pytest.mark.parametrize("sim", [
    SIM,
    dict(SIM, theta=0.5, unweighted_leaf_com=False, frontier_cap=32,
         leaf_cap=32, morton_bits=24, multipole=2),
], ids=["monopole", "quadrupole"])
def test_reference_follows_the_world(sim):
    """Ten steps of the port's World (its plain CPU path) and of the
    reference from one state agree row by row, re-sort included."""
    pos, vel, mass = generators.plummer(1024, seed=7, scale_radius=300.0)
    cfg = SimConfig(force_path="bh", rcp="exact", **sim)
    world = World(ParticleState.create(pos, vel, mass), cfg)
    p0, v0, m0 = world.state.pos, world.state.vel, world.state.mass
    world.run(10)
    rp, rv, rm, rows = reference.run_steps(p0, v0, m0, 0, 10, False, sim)
    live = rm > 0
    assert torch.equal(world.state.mass, rm)
    assert checks.rel_increment(world.state.vel, rv, v0[rows], live) < 1e-4
    assert checks.ulp_distance(world.state.pos, rp, live) <= 2


def test_reference_raster_is_the_ports():
    rng = np.random.default_rng(3)
    n = 20000
    pos = rng.uniform(-5e3, 1.05e5, (n, 2)).astype(np.float32)
    pos[:5000] = rng.uniform(4.9e4, 5.0e4, (5000, 2))   # crowded pixels
    pos[7] = np.nan
    vel = rng.normal(0, 20, (n, 2)).astype(np.float32)
    mass = np.ones(n, np.float32)
    mass[::97] = 50.0
    want = render_frame(torch.as_tensor(pos), torch.as_tensor(vel),
                        torch.as_tensor(mass)).numpy()
    got = reference.render(pos, vel, mass, 1e5, 1250, 10.0)
    assert np.array_equal(got, want)
