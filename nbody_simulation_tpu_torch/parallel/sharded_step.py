"""The multi-device simulation step: ring force exchange plus integration.

The port of ``nbody_simulation_tpu/parallel/sharded_step.py``: the ring
all-pairs force (``parallel.ring``), semi-implicit Euler in f32, and
diagnostics and the exact total energy summed over the mesh with ``psum``.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.energy import allpairs_potential
from nbody_simulation_tpu_torch.ops.integrate import euler_step
from nbody_simulation_tpu_torch.parallel.mesh import (Mesh, map_shards,
                                                      split_shards)
from nbody_simulation_tpu_torch.parallel.ring import ring_allpairs_accel
from nbody_simulation_tpu_torch.state import ParticleState


def make_sharded_step(mesh: Mesh, config: SimConfig,
                      tile_i: int | None = None, tile_j: int | None = None):
    """A ``state -> state`` step over ``mesh`` (a state from
    ``shard_state``): ``vel += acc·dt``, then ``pos += vel·dt``, with dt
    rounded to f32 as the JAX package does (``ops.integrate``)."""
    ti = tile_i or config.tile_i
    tj = tile_j or config.tile_j
    rcp = config.resolved_rcp()

    def step(state: ParticleState) -> ParticleState:
        acc = ring_allpairs_accel(state.pos, state.mass, mesh,
                                  softening2=config.softening2, tile_i=ti,
                                  tile_j=tj, rcp=rcp)
        return euler_step(state, acc, config.dt)

    return step


def sharded_diagnostics(state: ParticleState, mesh: Mesh) -> dict:
    """Total momentum, kinetic energy, mass, centre of mass and live count
    of a sharded state, each a per-shard sum added over the mesh."""
    pos, vel, mass = (split_shards(mesh, a)
                      for a in (state.pos, state.vel, state.mass))
    m = mass[..., None]
    mom = mesh.psum((vel * m).sum(dim=1))
    ke = mesh.psum((0.5 * mass * (vel ** 2).sum(-1)).sum(dim=1))
    mtot = mesh.psum(mass.sum(dim=1))
    com = mesh.psum((pos * m).sum(dim=1)) / mtot
    nlive = mesh.psum((mass > 0).sum(dim=1, dtype=torch.int32))
    return {"momentum": mom, "kinetic_energy": ke, "total_mass": mtot,
            "center_of_mass": com, "n_live": nlive}


def sharded_total_energy(state: ParticleState, mesh: Mesh,
                         softening2: float = 1e-3, tile_i: int = 512,
                         tile_j: int = 2048) -> dict:
    """Exact E = KE + U of a sharded state. U is the pair potential of
    ``ops.energy`` summed by a ring of the potential kernel (K6): the source
    blocks travel P−1 hops and each shard adds φ of its particles from every
    block. O(N²/P) per shard: a diagnostic for a cadence, not every step."""

    def potential(p, m, vp, vm):
        return allpairs_potential(p, m, src_pos=vp, src_mass=vm,
                                  softening2=softening2, tile_i=tile_i,
                                  tile_j=tile_j)

    phi = torch.zeros_like(state.mass)
    vis_pos, vis_mass = state.pos, state.mass
    for k in range(mesh.n_shards):
        if k > 0:
            vis_pos = mesh.ppermute(vis_pos, 1)
            vis_mass = mesh.ppermute(vis_mass, 1)
        phi = phi + map_shards(mesh, potential, state.pos, state.mass,
                               vis_pos, vis_mass)
    mass = split_shards(mesh, state.mass)
    vel = split_shards(mesh, state.vel)
    pe = mesh.psum((0.5 * mass * split_shards(mesh, phi)).sum(dim=1))
    ke = mesh.psum((0.5 * mass * (vel ** 2).sum(-1)).sum(dim=1))
    return {"potential_energy": pe, "kinetic_energy": ke,
            "total_energy": pe + ke}
