"""Semi-implicit (symplectic) Euler and leapfrog integration.

The reference's integrate loop (reference src/main.rs:419-423):

    velocity += acceleration * dt
    position += velocity * dt        # uses the UPDATED velocity

``dt`` is rounded to f32 first, as the JAX package does, so both packages
take bitwise-equal steps.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_simulation_tpu_torch.state import ParticleState


def euler_step(state: ParticleState, accel: torch.Tensor,
               dt: float) -> ParticleState:
    """One semi-implicit Euler update. ``accel`` is f32[N, 2]."""
    dt = float(np.float32(dt))
    vel = state.vel + accel * dt
    pos = state.pos + vel * dt
    return state.replace(pos=pos, vel=vel)


def leapfrog_step(state: ParticleState, accel_fn, dt: float) -> ParticleState:
    """Kick-drift-kick leapfrog; ``accel_fn`` is (pos, mass) -> accel and is
    evaluated twice per step."""
    dt32 = np.float32(dt)
    half = float(np.float32(0.5) * dt32)
    dt = float(dt32)
    v_half = state.vel + accel_fn(state.pos, state.mass) * half
    pos = state.pos + v_half * dt
    vel = v_half + accel_fn(pos, state.mass) * half
    return state.replace(pos=pos, vel=vel)
