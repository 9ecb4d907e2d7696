"""The port's force law and integrators against the JAX package and the
NumPy oracle: bitwise, since every operation is the same IEEE f32 op in the
same order (reference src/main.rs:234-253, :419-423)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.ops import force as jforce
from nbody_simulation_tpu.ops import integrate as jint
from nbody_simulation_tpu.oracle import direct_accel_oracle, pair_accel_oracle
from nbody_simulation_tpu.state import ParticleState as JaxState
from nbody_simulation_tpu_torch.ops import force as tforce
from nbody_simulation_tpu_torch.ops import integrate as tint
from nbody_simulation_tpu_torch.state import ParticleState

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

TINY = np.float32(1e-39)  # subnormal


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _pairs(rng, n=4000):
    """Random separations plus every edge case of the is_normal guard."""
    dx = rng.normal(0, 1e3, n).astype(np.float32)
    dy = rng.normal(0, 1e3, n).astype(np.float32)
    dx[:8] = [0, 0, np.nan, np.inf, -np.inf, TINY, TINY, 1e-3]
    dy[:8] = [0, 1e-20, 0, 0, 5.0, 0, TINY, 0]
    dx[8:12] = [1e-19, 3e-24, 2e-38, 1e30]
    dy[8:12] = [0, 0, 0, 1e30]
    m = rng.integers(1, 100, n).astype(np.float32)
    m[5] = 7.5e7
    return dx, dy, m


def test_pair_accel_bitwise_vs_jax_and_oracle():
    dx, dy, m = _pairs(np.random.default_rng(0))
    tx, ty = tforce.pair_accel(torch.from_numpy(dx), torch.from_numpy(dy),
                               torch.from_numpy(m))
    jx, jy = jforce.pair_accel(jnp.asarray(dx), jnp.asarray(dy),
                               jnp.asarray(m))
    # XLA on the CPU flushes a subnormal denominator to zero (dx=2e-38 gives
    # s·d2 = 2e-41 and then inf); torch, the oracle and the reference keep
    # IEEE subnormals. Those pairs are held to the oracle alone, below.
    with np.errstate(all="ignore"):
        s = np.abs(dx) + np.abs(dy)
        den = s * np.maximum(dx * dx + dy * dy, np.float32(1e-3))
    normal = np.isfinite(s) & (s >= np.float32(1.17549435e-38))
    ieee_only = normal & (den < np.float32(1.17549435e-38))
    assert ieee_only.sum() == 1
    ok = ~ieee_only
    np.testing.assert_array_equal(_bits(tx.numpy())[ok], _bits(jx)[ok])
    np.testing.assert_array_equal(_bits(ty.numpy())[ok], _bits(jy)[ok])
    for i in range(64):
        with np.errstate(over="ignore"):
            want = pair_accel_oracle((0.0, 0.0), (dx[i], dy[i]), m[i])
        np.testing.assert_array_equal(
            _bits([tx[i].item(), ty[i].item()]), _bits(want), err_msg=str(i))


@pytest.mark.parametrize("softening2", [1e-3, 0.5])
def test_pair_accel_softening_bitwise(softening2):
    rng = np.random.default_rng(1)
    dx = rng.normal(0, 0.05, 500).astype(np.float32)
    dy = rng.normal(0, 0.05, 500).astype(np.float32)
    m = np.ones(500, np.float32)
    tx, ty = tforce.pair_accel(torch.from_numpy(dx), torch.from_numpy(dy),
                               torch.from_numpy(m), softening2)
    jx, jy = jforce.pair_accel(jnp.asarray(dx), jnp.asarray(dy),
                               jnp.asarray(m), softening2)
    np.testing.assert_array_equal(_bits(tx.numpy()), _bits(jx))
    np.testing.assert_array_equal(_bits(ty.numpy()), _bits(jy))


def test_direct_accel_matches_oracle_and_jax():
    rng = np.random.default_rng(2)
    n = 700
    pos = rng.uniform(0, 1e5, (n, 2)).astype(np.float32)
    pos[1] = pos[0]  # a coincident pair, masked by the guard
    mass = rng.integers(1, 50, n).astype(np.float32)
    got = tforce.direct_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                              row_chunk=256).numpy()
    want = direct_accel_oracle(pos, mass)
    jgot = np.asarray(jforce.direct_accel(jnp.asarray(pos),
                                          jnp.asarray(mass)))
    # The per-pair terms are bitwise the oracle's; the f32 sums differ from
    # the f64 oracle and from XLA's order only by rounding:
    # |Δa| ≤ 1e-5 · Σ_j |c_ij| per particle.
    scale = np.zeros((n, 2))
    for i in range(n):
        c = torch.stack(tforce.pair_accel(
            torch.from_numpy(pos[:, 0] - pos[i, 0]),
            torch.from_numpy(pos[:, 1] - pos[i, 1]),
            torch.from_numpy(mass)), -1).numpy()
        scale[i] = np.abs(c.astype(np.float64)).sum(0)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    assert np.all(np.abs(got - jgot) <= 1e-5 * scale)


def test_direct_accel_at_rows_equal_direct():
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.uniform(0, 1e4, (300, 2)).astype(np.float32))
    mass = torch.ones(300)
    full = tforce.direct_accel(pos, mass, row_chunk=64)
    part = tforce.direct_accel_at(pos[10:20], pos, mass, row_chunk=64)
    assert torch.equal(part, full[10:20])


def _states(rng, n=1000):
    pos = rng.uniform(0, 1e5, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 3, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 5, n).astype(np.float32)
    acc = rng.normal(0, 1e-2, (n, 2)).astype(np.float32)
    return (JaxState.create(pos, vel, mass),
            ParticleState.create(pos, vel, mass), acc)


@pytest.mark.parametrize("dt", [0.1, 0.37])
def test_euler_step_bitwise(dt):
    jst, tst, acc = _states(np.random.default_rng(4))
    j = jint.euler_step(jst, jnp.asarray(acc), dt)
    t = tint.euler_step(tst, torch.from_numpy(acc), dt)
    np.testing.assert_array_equal(_bits(t.pos.numpy()), _bits(j.pos))
    np.testing.assert_array_equal(_bits(t.vel.numpy()), _bits(j.vel))


def test_leapfrog_step_bitwise():
    jst, tst, _ = _states(np.random.default_rng(5))
    k = np.float32(-1e-3)

    def jacc(pos, mass):
        return pos * k + mass[:, None]

    def tacc(pos, mass):
        return pos * float(k) + mass[:, None]

    j = jint.leapfrog_step(jst, jacc, 0.1)
    t = tint.leapfrog_step(tst, tacc, 0.1)
    np.testing.assert_array_equal(_bits(t.pos.numpy()), _bits(j.pos))
    np.testing.assert_array_equal(_bits(t.vel.numpy()), _bits(j.vel))
