"""Initial states from a seed: frozen copies of the port's generators.

Copied from ``nbody_simulation_tpu_torch/models/scenarios.py`` at commit
c4ece55 (``_rand_disc``, ``_rotate_right``, ``galaxy``, ``plummer``), with
the return changed from a ``ParticleState`` to three NumPy arrays. The
benchmark makes its inputs here and hands the same arrays to the program
and to the reference, so a later change to the program's generators moves
neither. ``tests/test_portbench_inputs.py`` holds them equal to the port's
for seeds 0 to 2.
"""

from __future__ import annotations

import numpy as np

TAU = 2.0 * np.pi


def rng_seed(seed: int) -> int:
    """The benchmark's ``--seed`` as a NumPy seed: any whole number, taken
    modulo 2^64 so that a negative one is valid too."""
    return int(seed) % (1 << 64)


def _rand_disc(rng: np.random.Generator, n: int) -> np.ndarray:
    theta = rng.random(n, dtype=np.float32) * np.float32(TAU)
    r = rng.random(n, dtype=np.float32)
    return np.stack([np.cos(theta) * r, np.sin(theta) * r],
                    axis=-1).astype(np.float32)


def _rotate_right(v: np.ndarray) -> np.ndarray:
    return np.stack([v[..., 1], -v[..., 0]], axis=-1)


def galaxy(seed: int = 0, world_size: float = 100_000.0,
           n_random: int = 100_000):
    """The reference's World::new: two heavy bodies, a lattice annulus
    around body 2 and a center-biased disc. Returns (pos, vel, mass)."""
    rng = np.random.default_rng(rng_seed(seed))
    height = int(world_size)

    pos, vel, mass = [], [], []
    circle2 = np.array([60_000.0, 60_000.0], np.float32)

    pos.append(np.array([[35_000.0, 35_000.0]], np.float32))
    vel.append(np.array([[200.0, 250.0]], np.float32))
    mass.append(np.array([75_000_000.0], np.float32))
    pos.append(circle2[None])
    vel.append(np.array([[0.0, 0.0]], np.float32))
    mass.append(np.array([750_000.0], np.float32))

    c1lenr2 = np.float32(15_000_000.0)
    grid_n = height // 14 - 1
    r_max = np.sqrt(float(c1lenr2))
    lo = max(0, int((circle2[0] - r_max) / 14.0) - 1)
    hi = min(grid_n, int((circle2[0] + r_max) / 14.0) + 2)
    idx = np.arange(lo, hi, dtype=np.float32)
    gx, gy = np.meshgrid(idx * np.float32(14.0), idx * np.float32(14.0),
                         indexing="ij")
    gpos = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
    diff = gpos - circle2
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]).astype(np.float32)
    in_ring = (d2 < c1lenr2) & (d2 > np.float32(500_000.0))
    upper = (c1lenr2 - d2) + np.float32(1.0)
    draw = rng.random(d2.shape[0], dtype=np.float32) * upper
    keep = in_ring & (draw > np.float32(6_000_000.0))
    kpos = gpos[keep]
    kd2 = d2[keep]
    scale = np.sqrt(np.sqrt(np.float32(750_000.0)) / kd2).astype(np.float32)
    kvel = _rotate_right(kpos - circle2) * scale[:, None]
    pos.append(kpos)
    vel.append(kvel.astype(np.float32))
    mass.append(np.ones(kpos.shape[0], np.float32))

    offset = np.array([50_000.0, 50_000.0], np.float32)
    rpos = _rand_disc(rng, n_random) * np.float32(25_000.0) + offset
    rvel = _rand_disc(rng, n_random)
    pos.append(rpos)
    vel.append(rvel)
    mass.append(np.ones(n_random, np.float32))
    return (np.concatenate(pos).astype(np.float32),
            np.concatenate(vel).astype(np.float32),
            np.concatenate(mass).astype(np.float32))


def plummer(n: int, seed: int = 0, scale_radius: float = 5_000.0,
            center=(50_000.0, 50_000.0), total_mass: float | None = None,
            world_size: float = 100_000.0):
    """Plummer-like 2D cluster, clipped to 10 scale radii and the world.
    Returns (pos, vel, mass)."""
    rng = np.random.default_rng(rng_seed(seed))
    u = rng.random(n, dtype=np.float32)
    r = scale_radius / np.sqrt(np.maximum(u ** (-2.0 / 3.0) - 1.0, 1e-9))
    r_max = min(10.0 * scale_radius,
                center[0], center[1],
                world_size - center[0] - 1.0, world_size - center[1] - 1.0)
    r = np.minimum(r, r_max).astype(np.float32)
    theta = rng.random(n, dtype=np.float32) * np.float32(TAU)
    pos = np.stack([np.cos(theta) * r + center[0],
                    np.sin(theta) * r + center[1]], axis=-1).astype(np.float32)
    vel = _rand_disc(rng, n) * np.float32(0.1)
    m = np.float32((total_mass or n) / n)
    return pos, vel.astype(np.float32), np.full(n, m, np.float32)


GENERATORS = {"galaxy": galaxy, "plummer": plummer}


def make_state(scenario: str, seed: int, args: dict):
    """(pos, vel, mass) of the named scenario with the configuration's
    generator arguments."""
    return GENERATORS[scenario](seed=seed, **args)
