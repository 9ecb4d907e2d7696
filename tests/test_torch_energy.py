"""The port's energy diagnostics against the JAX package.

``allpairs_potential`` runs its plain version on the CPU (the CUDA kernel
in ``csrc/allpairs.cu`` runs only on a card, where chip_smoke.py holds it
to the plain version); the JAX side runs its Pallas kernel in interpret
mode.

Tolerance: relative 1e-5 for every energy and per-target potential. The
two packages sum the same terms in another order, and the counterpart
potential's terms all have the sign of −m, so a sum-order difference is a
relative one.
"""

import numpy as np
import pytest
import torch

from nbody_simulation_tpu.config import SimConfig as JaxConfig
from nbody_simulation_tpu.models.scenarios import plummer as jplummer
from nbody_simulation_tpu.models.scenarios import uniform_disc as juniform
from nbody_simulation_tpu.models.world import World as JaxWorld
from nbody_simulation_tpu.ops import energy as jen
from nbody_simulation_tpu.utils.telemetry import EnergyMeter as JaxMeter
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops import energy as ten
from nbody_simulation_tpu_torch.state import state_from_numpy
from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

RTOL = 1e-5


def port_state(jst):
    return state_from_numpy(np.asarray(jst.pos), np.asarray(jst.vel),
                            np.asarray(jst.mass), n_real=jst.n_real)


def test_potential_matches_jax_with_padding_and_other_sources():
    """Ni=300 and Nj=700 are no tile multiples: the JAX package pads both
    axes with inert particles, the port takes any N as it is."""
    tgt = jplummer(300, seed=1)
    src = jplummer(700, seed=2)
    want = np.asarray(jen.allpairs_potential(
        tgt.pos, tgt.mass, src_pos=src.pos, src_mass=src.mass, tile_i=128,
        tile_j=256, interpret=True))
    got = ten.allpairs_potential(torch.tensor(np.asarray(tgt.pos)), None,
                                 torch.tensor(np.asarray(src.pos)),
                                 torch.tensor(np.asarray(src.mass)),
                                 tile_i=128, tile_j=256)
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_total_energy_matches_jax():
    jst = jplummer(512, seed=3).pad_to(1024)
    tst = port_state(jst)
    np.testing.assert_allclose(float(ten.total_energy(tst)),
                               float(jen.total_energy(jst)), rtol=RTOL)
    np.testing.assert_allclose(
        float(ten.kinetic_energy(tst.vel, tst.mass)),
        float(jen.kinetic_energy(jst.vel, jst.mass)), rtol=RTOL)


def test_coincident_particles_and_padding_are_skipped():
    pos = torch.tensor([[10.0, 10.0], [10.0, 10.0], [13.0, 14.0]])
    mass = torch.ones(3)
    # Only the two distinct pairs (0,2) and (1,2) contribute.
    np.testing.assert_allclose(float(ten.potential_energy(pos, mass)),
                               2 * (-1.0 / 5.0), rtol=1e-6)
    padded = port_state(juniform(100, seed=4).pad_to(128))
    np.testing.assert_allclose(
        float(ten.potential_energy(padded.pos, padded.mass)),
        float(ten.potential_energy(padded.pos[:100], padded.mass[:100])),
        rtol=1e-6)


@pytest.mark.parametrize("theta", [50.0, 0.5])
def test_bh_total_energy_matches_jax(theta):
    kw = dict(theta=theta, multipole=1)
    jst = jplummer(2048, seed=5)
    want = float(jen.bh_total_energy(jst, JaxConfig(**kw)))
    got = float(ten.bh_total_energy(port_state(jst), SimConfig(**kw)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("method", ["exact", "bh"])
def test_energy_meter_samples_match_jax(method):
    """Both meters on both worlds after the same steps: the same sampled
    steps and energies within RTOL, and the same printed lines up to the
    last digits."""
    jst = juniform(300, seed=6)
    jw = JaxWorld(jst, JaxConfig(force_path="direct"))
    tw = World(port_state(jst), SimConfig(force_path="direct"))
    jlines, tlines = [], []
    jm = JaxMeter(4, emit=jlines.append, method=method)
    tm = EnergyMeter(4, emit=tlines.append, method=method)
    for batch in (2, 2, 3, 1, 4):   # samples at steps 2, 7 and 12
        jw.run(batch)
        tw.run(batch)
        jm(jw)
        tm(tw)
    assert [s for s, _ in tm.samples] == [s for s, _ in jm.samples] == [
        2, 7, 12]
    np.testing.assert_allclose([e for _, e in tm.samples],
                               [e for _, e in jm.samples], rtol=RTOL)
    assert [ln.split(" E=")[0] for ln in tlines] == [
        ln.split(" E=")[0] for ln in jlines]
    assert all("|dE/E0|=" in ln for ln in tlines)


def test_energy_meter_refuses_what_is_not_ported():
    """An unknown method raises; on a distributed world (one with a
    ``mesh``) both methods are the JAX meter's mesh branch: "bh" the staged
    distributed potential with the world's seam stages, "exact" the ring of
    the potential kernel."""
    with pytest.raises(ValueError):
        EnergyMeter(4, method="ring")

    from nbody_simulation_tpu import parallel as jpar
    from nbody_simulation_tpu.runtime.distributed import (
        DistributedWorld as JaxDistributedWorld)
    from nbody_simulation_tpu_torch import parallel as tpar
    from nbody_simulation_tpu_torch.runtime.distributed import (
        DistributedWorld as PortDistributedWorld)

    kw = dict(force_path="bh", leaf_size=16)
    jst = juniform(2048, seed=9)
    jw = JaxDistributedWorld(
        jpar.distribute_state(jst, jpar.make_1d_mesh(2), JaxConfig(**kw)),
        jpar.make_1d_mesh(2), JaxConfig(**kw))
    mesh = tpar.LocalMesh(2, "cpu")
    tw = PortDistributedWorld(
        tpar.distribute_state(port_state(jst), mesh, SimConfig(**kw)), mesh,
        SimConfig(**kw))
    for method in ("bh", "exact"):
        jlines, tlines = [], []
        jm = JaxMeter(4, emit=jlines.append, method=method)
        tm = EnergyMeter(4, emit=tlines.append, method=method)
        jm(jw)
        tm(tw)
        assert tlines[0].split(" E=")[0] == jlines[0].split(" E=")[0]
        np.testing.assert_allclose(tm.samples[0][1], jm.samples[0][1],
                                   rtol=RTOL)
