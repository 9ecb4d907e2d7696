"""The port's exact all-pairs path and energy against the benchmark's plain
reference (``portbench/lib/reference_exact.py``), and the energy meter's
samples and potentials under an ``Engine``.

On the CPU the ``pallas`` path runs the symmetric law's plain version (the
kernel K2 runs only on a card) and the energy the potential's plain version
(K6 likewise), both in float32 with float32 sums; the reference computes
the same float32 pair terms and sums them in float64.
"""

import numpy as np
import pytest
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World, make_accel_fn
from nbody_simulation_tpu_torch.ops import energy
from nbody_simulation_tpu_torch.runtime.engine import Engine
from nbody_simulation_tpu_torch.state import ParticleState
from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter
from portbench.lib import checks, reference_exact

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SIM = {"dt": 0.1, "softening2": 1e-3}
CFG = SimConfig(force_path="pallas", **SIM)


def galaxy_like(n: int, seed: int):
    """The reference galaxy in small: its two heavy bodies as World::new
    places them, a third of the rows on circular orbits about the lighter
    one and the rest in a disc about the centre, of mass 1."""
    rng = np.random.default_rng(seed)
    ring, disc = (n - 2) // 3, n - 2 - (n - 2) // 3
    a = rng.random(ring) * 2 * np.pi
    r = 800.0 + 3000.0 * rng.random(ring)
    rp = np.stack([np.cos(a), np.sin(a)], 1) * r[:, None]
    rv = np.stack([rp[:, 1], -rp[:, 0]], 1) * np.sqrt(np.sqrt(750e3)
                                                      / r ** 2)[:, None]
    a = rng.random(disc) * 2 * np.pi
    r = 25_000.0 * np.sqrt(rng.random(disc))
    pos = np.concatenate([[[35_000.0, 35_000.0], [60_000.0, 60_000.0]],
                          rp + 60_000.0,
                          np.stack([np.cos(a), np.sin(a)], 1) * r[:, None]
                          + 50_000.0])
    vel = np.concatenate([[[200.0, 250.0], [0.0, 0.0]], rv,
                          rng.normal(0.0, 1.0, (disc, 2))])
    mass = np.concatenate([[75e6, 750e3], np.ones(n - 2)])
    return ParticleState.create(pos.astype(np.float32),
                                vel.astype(np.float32),
                                mass.astype(np.float32))


@pytest.fixture(scope="module")
def world_state():
    """2,000 bodies, padded by the World to 2,048 rows: the last 48 of zero
    mass."""
    return World(galaxy_like(2000, 19), CFG).state


@pytest.fixture(scope="module")
def stepped(world_state):
    """The state after 10 steps of the World and of the reference."""
    st = world_state
    world = World(st, CFG)
    world.run(10)
    rp, rv = reference_exact.run_steps(st.pos, st.vel, st.mass, 10, SIM)
    return world.state, rp, rv


def _accel(st, request):
    live = st.mass > 0
    got = make_accel_fn(CFG)(st.pos, st.mass)
    want = reference_exact.accel(st.pos, st.mass, CFG.softening2)
    return checks.rel_increment(got, want, torch.zeros_like(want), live, 1.0)


def _steps_dv(st, request):
    got, _, rv = request.getfixturevalue("stepped")
    return checks.rel_increment(got.vel, rv, st.vel, st.mass > 0, 1.0)


def _steps_dx(st, request):
    got, rp, _ = request.getfixturevalue("stepped")
    return checks.ulp_distance(got.pos, rp, st.mass > 0, 1.0)


def _energy(st, request):
    got = float(energy.total_energy(st, softening2=CFG.softening2))
    want = reference_exact.total_energy(st.pos, st.vel, st.mass,
                                        CFG.softening2)
    return abs(got - want) / abs(want)


def _potential(st, request):
    got = float(energy.potential_energy(st.pos, st.mass, CFG.softening2))
    want = float(reference_exact.potential(st.pos, st.mass, CFG.softening2,
                                           block=512))
    return abs(got - want) / abs(want)


# Each comparison with its tolerance and the reason for it:
# - accel: the worst live row's distance from the reference over its |a|
#   (the median |a| for a row below it). The port sums the 2,048 f32 terms
#   of a row in f32, the reference in f64; that costs a few f32 spacings of
#   the row's sum (read: 5.3e-7 on this state; the bf16 control 1.16).
# - steps_dv: the worst row's velocity change over 10 steps, as accel; a
#   close pair grows the rounding of each step along the 10 (read: 1.8e-5).
# - steps_dx: the worst row's position after them, in f32 spacings: one,
#   so that a flipped rounding passes; a velocity error of 1e-5 moves a
#   position far less than the f32 spacing at 1e4-1e5 (read: 0).
# - energy: E is almost all the heavy body's kinetic energy (3.8e12, whose
#   f32 spacing is 6e-8 of it), summed in f32 by the port (read: 5.2e-8;
#   the bf16 control 2.9e-3).
# - potential: the potential alone, every term of one sign, f32 sums of
#   2,048 terms a row; the reference in blocks of 512, so that the blocks'
#   cross terms are exercised (read: 1.8e-7; the bf16 control 7.4e-3).
CASES = {"accel": (_accel, 1e-5), "steps_dv": (_steps_dv, 1e-3),
         "steps_dx": (_steps_dx, 1.0), "energy": (_energy, 1e-6),
         "potential": (_potential, 1e-5)}


@pytest.mark.parametrize("case", list(CASES))
def test_exact_path_matches_the_plain_reference(world_state, request, case):
    measure, tol = CASES[case]
    assert measure(world_state, request) <= tol


def test_reference_blocks_add_up_to_one_block(world_state):
    """The reference's symmetric blocks (each off-diagonal block added to
    both sides) give the single block's sums."""
    st = world_state
    whole = reference_exact.accel(st.pos, st.mass, 1e-3, block=4096)
    cut = reference_exact.accel(st.pos, st.mass, 1e-3, block=300)
    scale = whole.abs().amax(0)
    assert ((whole - cut).abs() <= 1e-12 * scale).all()


def _cadence(every: int, spb: int, steps: int):
    """The steps at which a meter of cadence ``every`` samples when called
    after each batch of ``spb`` steps: the first batch, then each batch at
    least ``every`` steps after the last sample."""
    out = []
    for step in range(spb, steps + 1, spb):
        if not out or step - out[-1] >= every:
            out.append(step)
    return out


@pytest.mark.parametrize("every,spb,method",
                         [(8, 10, "exact"), (20, 10, "bh"), (5, 3, "exact")],
                         ids=["8-10", "20-10", "5-3"])
def test_energy_meter_counts_each_sample_and_prints_as_before(every, spb,
                                                              method):
    """One potential kept a sampling batch, bitwise the potential of the
    state sampled; the energies bitwise ``total_energy``'s
    (``bh_total_energy``'s) of that state, and the printed lines of the
    meter's cadence and format."""
    lines, want = [], {}
    meter = EnergyMeter(every, emit=lines.append, softening2=1e-3,
                        method=method)
    cfg = SimConfig(force_path="bh", **SIM)
    world = World(galaxy_like(100, 4), cfg)

    def on_batch(w):
        n = len(meter.samples)
        meter(w)
        if len(meter.samples) > n:
            st = w.state
            want[w.updates] = (
                (float(energy.bh_total_energy(st, cfg)),
                 float(energy.bh_potential_energy(st, cfg)))
                if method == "bh" else
                (float(energy.total_energy(st, softening2=1e-3)),
                 float(energy.potential_energy(st.pos, st.mass, 1e-3))))

    steps = 6 * spb
    eng = Engine(world, steps_per_snapshot=spb, snapshot_interval=0.0,
                 profile_every=0, on_batch=on_batch)
    eng.start(max_steps=steps)
    while eng.next_snapshot(timeout=60) is not None:
        pass
    eng.stop()
    assert [s for s, _ in meter.samples] == _cadence(every, spb, steps)
    assert {s: (e, u) for (s, e), (_, u) in
            zip(meter.samples, meter.potentials)} == want
    e0 = meter.samples[0][1]
    assert lines == [f"energy: step {s} E={e:.6e} "
                     f"|dE/E0|={abs(e - e0) / abs(e0):.3e}"
                     for s, e in meter.samples]
