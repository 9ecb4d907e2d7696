"""Semi-implicit (symplectic) Euler and leapfrog integration.

The reference's integrate loop (reference src/main.rs:419-423):

    velocity += acceleration * dt
    position += velocity * dt        # uses the UPDATED velocity

``dt`` is rounded to f32 first, as the JAX package does, so both packages
take bitwise-equal steps. These two functions are the port's only updates
of velocity and position from an acceleration: the World's paths and the
multi-device steps all call them.
"""

from __future__ import annotations

import contextlib

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


def leapfrog_step(state: ParticleState, accel_fn, dt: float,
                  phase=contextlib.nullcontext) -> ParticleState:
    """Kick-drift-kick leapfrog; ``accel_fn`` is (pos, mass) -> accel and is
    evaluated twice per step. ``phase()`` is a context around the
    kick-drift and around the last kick (``World.step_timed`` times them)."""
    dt32 = np.float32(dt)
    half = float(np.float32(0.5) * dt32)
    dt = float(dt32)
    acc = accel_fn(state.pos, state.mass)
    with phase():
        v_half = state.vel + acc * half
        pos = state.pos + v_half * dt
    acc = accel_fn(pos, state.mass)
    with phase():
        vel = v_half + acc * half
    return state.replace(pos=pos, vel=vel)
