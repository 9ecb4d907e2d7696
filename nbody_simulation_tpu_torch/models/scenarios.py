"""Scenario generators (host-side, NumPy, seeded).

The generation is the JAX package's (``nbody_simulation_tpu/models/
scenarios.py``) line for line, so the same seed gives bitwise-equal arrays
(tests/test_torch_port_basics.py). States are built on the CPU; move them
with ``state.to(device)``.

``galaxy`` is the reference's World::new (reference src/main.rs:275-346):
two heavy bodies, a lattice annulus around body 2 and a center-biased
100,000-body disc — 151,317 particles at seed 0.

``galaxy_chunk`` and ``scenario_chunk`` give one process's chunk of a
scenario, for ``parallel.multihost.multihost_state``: each process builds
only its own rows.
"""

from __future__ import annotations

import numpy as np

from nbody_simulation_tpu_torch.state import ParticleState

TAU = 2.0 * np.pi


def _rand_disc(rng: np.random.Generator, n: int) -> np.ndarray:
    """The reference's rand_disc (src/main.rs:255-258): (cosθ, sinθ)·r with
    r ~ U[0,1) — no sqrt, so samples are center-biased."""
    theta = rng.random(n, dtype=np.float32) * np.float32(TAU)
    r = rng.random(n, dtype=np.float32)
    return np.stack([np.cos(theta) * r, np.sin(theta) * r], axis=-1).astype(np.float32)


def _rotate_right(v: np.ndarray) -> np.ndarray:
    """(x, y) -> (y, -x) (src/main.rs:271-273)."""
    return np.stack([v[..., 1], -v[..., 0]], axis=-1)


def galaxy(seed: int = 0, world_size: float = 100_000.0,
           n_random: int = 100_000) -> ParticleState:
    """The reference's exact startup scenario."""
    rng = np.random.default_rng(seed)
    height = int(world_size)

    pos, vel, mass = [], [], []
    circle2 = np.array([60_000.0, 60_000.0], np.float32)

    # Two heavy bodies (src/main.rs:282-291).
    pos.append(np.array([[35_000.0, 35_000.0]], np.float32))
    vel.append(np.array([[200.0, 250.0]], np.float32))
    mass.append(np.array([75_000_000.0], np.float32))
    pos.append(circle2[None])
    vel.append(np.array([[0.0, 0.0]], np.float32))
    mass.append(np.array([750_000.0], np.float32))

    # Annulus lattice around body 2 (src/main.rs:316-332), restricted to the
    # index window that can pass the distance test.
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
    # rng.gen_range(0f32..(c1lenr2 - d2) + 1.0) > 6e6  (src/main.rs:321)
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

    # Center-biased random disc (src/main.rs:333-342).
    offset = np.array([50_000.0, 50_000.0], np.float32)
    rpos = _rand_disc(rng, n_random) * np.float32(25_000.0) + offset
    rvel = _rand_disc(rng, n_random)
    pos.append(rpos)
    vel.append(rvel)
    mass.append(np.ones(n_random, np.float32))

    return ParticleState.create(
        np.concatenate(pos), np.concatenate(vel), np.concatenate(mass))


def collision(seed: int = 0, n_per_galaxy: int = 50_000) -> ParticleState:
    """Two galaxy discs (heavy core + tangential disc) on a collision
    course."""
    rng = np.random.default_rng(seed)
    pos, vel, mass = [], [], []
    for center, v0, w in [((30_000.0, 30_000.0), (60.0, 45.0), 5_000_000.0),
                          ((70_000.0, 70_000.0), (-60.0, -45.0), 5_000_000.0)]:
        c = np.array(center, np.float32)
        pos.append(c[None])
        vel.append(np.array([v0], np.float32))
        mass.append(np.array([w], np.float32))
        theta = rng.random(n_per_galaxy, dtype=np.float32) * np.float32(TAU)
        r = (np.sqrt(rng.random(n_per_galaxy, dtype=np.float32))
             * np.float32(12_000.0) + np.float32(500.0))
        p = np.stack([np.cos(theta) * r, np.sin(theta) * r], -1) + c
        d2 = ((p - c) ** 2).sum(-1).astype(np.float32)
        scale = np.sqrt(np.sqrt(np.float32(w)) / d2).astype(np.float32)
        v = _rotate_right(p - c) * scale[:, None] + np.asarray(v0, np.float32)
        pos.append(p.astype(np.float32))
        vel.append(v.astype(np.float32))
        mass.append(np.ones(n_per_galaxy, np.float32))
    return ParticleState.create(
        np.concatenate(pos), np.concatenate(vel), np.concatenate(mass))


def uniform_disc(n: int, seed: int = 0, radius: float = 25_000.0,
                 center=(50_000.0, 50_000.0)) -> ParticleState:
    """N unit-mass bodies uniform on a disc with small random velocities."""
    rng = np.random.default_rng(seed)
    theta = rng.random(n, dtype=np.float32) * np.float32(TAU)
    r = np.sqrt(rng.random(n, dtype=np.float32)) * np.float32(radius)
    pos = np.stack([np.cos(theta) * r + center[0],
                    np.sin(theta) * r + center[1]], axis=-1).astype(np.float32)
    vel = _rand_disc(rng, n)
    return ParticleState.create(pos, vel, np.ones(n, np.float32))


def _chunk_bounds(n: int, pid: int, nproc: int) -> tuple[int, int]:
    """Row range [lo, hi) of process ``pid``'s chunk of ``n`` rows: the one
    row split, ``parallel.multihost.chunk_bounds``."""
    from nbody_simulation_tpu_torch.parallel.multihost import chunk_bounds
    return chunk_bounds(n, pid, nproc)


def _rows_of(state: ParticleState, lo: int, hi: int) -> ParticleState:
    return ParticleState.create(state.pos[lo:hi].numpy(),
                                state.vel[lo:hi].numpy(),
                                state.mass[lo:hi].numpy())


def galaxy_chunk(pid: int, nproc: int, seed: int = 0,
                 world_size: float = 100_000.0,
                 n_random: int = 100_000) -> ParticleState:
    """Process ``pid``'s chunk of the galaxy. The union over the ``nproc``
    chunks has the galaxy's two heavy bodies and annulus exactly (every
    process draws the small lattice mask and keeps its band), and its
    ``n_random`` disc bodies split evenly, drawn from per-process seeds:
    the same distribution, another draw. ``nproc == 1`` is ``galaxy``
    bitwise."""
    if nproc == 1:
        return galaxy(seed=seed, world_size=world_size, n_random=n_random)
    full = galaxy(seed=seed, world_size=world_size, n_random=0)
    lo, hi = _chunk_bounds(full.n, pid, nproc)
    pos = [full.pos[lo:hi].numpy()]
    vel = [full.vel[lo:hi].numpy()]
    mass = [full.mass[lo:hi].numpy()]
    dlo, dhi = _chunk_bounds(n_random, pid, nproc)
    if dhi > dlo:
        rng = np.random.default_rng(np.random.SeedSequence([seed, 977, pid]))
        offset = np.array([50_000.0, 50_000.0], np.float32)
        pos.append(_rand_disc(rng, dhi - dlo) * np.float32(25_000.0)
                   + offset)
        vel.append(_rand_disc(rng, dhi - dlo))
        mass.append(np.ones(dhi - dlo, np.float32))
    return ParticleState.create(
        np.concatenate(pos), np.concatenate(vel), np.concatenate(mass))


def scenario_chunk(name: str, pid: int, nproc: int, seed: int = 0,
                   exact: bool = False, **kw) -> ParticleState:
    """Process ``pid``'s chunk of a named scenario.

    ``exact=False``: each process draws only its rows from a per-process
    seed (the same distribution, another draw). ``exact=True``: each
    process draws the whole scenario and keeps its band, so the union is
    the one-process scenario bitwise whatever ``nproc``. ``collision``
    always takes the exact form (its two cores are structural)."""
    if name == "galaxy":
        if exact and nproc > 1:
            full = galaxy(seed=seed, **kw)
            return _rows_of(full, *_chunk_bounds(full.n, pid, nproc))
        return galaxy_chunk(pid, nproc, seed=seed, **kw)
    gen = {"uniform": uniform_disc, "plummer": plummer,
           "collision": collision}[name]
    if exact or nproc == 1 or name == "collision":
        full = gen(seed=seed, **kw)
        return _rows_of(full, *_chunk_bounds(full.n, pid, nproc))
    pseed = np.random.SeedSequence([seed, 7919, pid]).generate_state(1)[0]
    n = kw.pop("n")
    lo, hi = _chunk_bounds(n, pid, nproc)
    return gen(hi - lo, seed=int(pseed), **kw)


def plummer(n: int, seed: int = 0, scale_radius: float = 5_000.0,
            center=(50_000.0, 50_000.0), total_mass: float | None = None,
            world_size: float = 100_000.0) -> ParticleState:
    """Plummer-like 2D cluster, clipped to 10 scale radii and the world."""
    rng = np.random.default_rng(seed)
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
    return ParticleState.create(pos, vel, np.full(n, m, np.float32))
