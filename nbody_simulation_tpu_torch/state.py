"""Structure-of-arrays particle state on a torch device.

    pos  : f32[N, 2]   world-space position
    vel  : f32[N, 2]   velocity
    mass : f32[N]      the reference's u32 ``weight`` as f32
                       (src/main.rs:193-198, :360)

``pad_to`` appends inert sentinels exactly like the JAX package
(``nbody_simulation_tpu/state.py``): mass 0 (no force) at ``PAD_POS + i``,
outside the world so the raster skips them. ``n_real`` is the live count.

A ``distributed`` state (``parallel.bh_distributed.distribute_state``)
interleaves each shard's padding with the next shard's live rows, so "the
first ``n_real`` rows are live" does not hold there: zero mass is the only
live marker, ``real_slice`` refuses it and ``compact`` gathers the live
rows.

Tensors are never updated in place: every step builds new ones, so a
reference to an old state stays valid.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# Sentinel position for padding particles: outside [0, world)².
PAD_POS = -1.0e6


class ParticleState:
    """Particle state: three tensors on one device plus the live count."""

    __slots__ = ("pos", "vel", "mass", "n_real", "distributed")

    def __init__(self, pos: torch.Tensor, vel: torch.Tensor,
                 mass: torch.Tensor, n_real: int | None = None,
                 distributed: bool = False):
        self.pos = pos
        self.vel = vel
        self.mass = mass
        self.n_real = int(n_real) if n_real is not None else int(pos.shape[0])
        self.distributed = bool(distributed)

    @classmethod
    def create(cls, pos, vel, mass, n_real: int | None = None,
               device: str | torch.device = "cpu") -> "ParticleState":
        pos = torch.as_tensor(np.array(pos, np.float32), device=device)
        vel = torch.as_tensor(np.array(vel, np.float32), device=device)
        mass = torch.as_tensor(np.array(mass, np.float32), device=device)
        if pos.ndim != 2 or pos.shape[1] != 2:
            raise ValueError(f"pos must be (N, 2), got {tuple(pos.shape)}")
        if vel.shape != pos.shape or mass.shape != (pos.shape[0],):
            raise ValueError(f"shape mismatch: pos {tuple(pos.shape)}, "
                             f"vel {tuple(vel.shape)}, mass {tuple(mass.shape)}")
        return cls(pos, vel, mass, n_real)

    @property
    def n(self) -> int:
        """Total (padded) particle count."""
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device: str | torch.device) -> "ParticleState":
        return ParticleState(self.pos.to(device), self.vel.to(device),
                             self.mass.to(device), self.n_real,
                             self.distributed)

    def pad_to(self, multiple: int) -> "ParticleState":
        """Pad to the next multiple of ``multiple`` with inert particles."""
        n = self.n
        target = -(-n // multiple) * multiple
        if target == n:
            return self
        extra = target - n
        dev = self.device
        pad_pos = (torch.full((extra, 2), PAD_POS, dtype=torch.float32,
                              device=dev)
                   + torch.arange(extra, dtype=torch.float32,
                                  device=dev)[:, None])
        return ParticleState(
            torch.cat([self.pos, pad_pos]),
            torch.cat([self.vel, torch.zeros((extra, 2), dtype=torch.float32,
                                             device=dev)]),
            torch.cat([self.mass, torch.zeros((extra,), dtype=torch.float32,
                                              device=dev)]),
            n_real=self.n_real,
        )

    def real_slice(self) -> "ParticleState":
        """Drop padding: the first ``n_real`` rows are the live ones. A
        distributed layout raises (its padding is interleaved): use
        ``compact``."""
        if self.distributed:
            raise ValueError(
                "real_slice() on a distributed state would return interleaved"
                " padding as live rows; use ParticleState.compact() instead")
        k = self.n_real
        return ParticleState(self.pos[:k], self.vel[:k], self.mass[:k], k)

    def compact(self) -> "ParticleState":
        """The live (mass > 0) rows of any layout, in row order, as a
        compact state on this state's device."""
        live = self.mass > 0
        return ParticleState(self.pos[live], self.vel[live], self.mass[live])

    def replace(self, **kw: Any) -> "ParticleState":
        return ParticleState(
            kw.get("pos", self.pos),
            kw.get("vel", self.vel),
            kw.get("mass", self.mass),
            n_real=kw.get("n_real", self.n_real),
            distributed=kw.get("distributed", self.distributed),
        )

    def __repr__(self) -> str:
        return (f"ParticleState(n={self.n}, n_real={self.n_real}"
                + (", distributed" if self.distributed else "")
                + f", device={self.device})")


def state_from_numpy(pos, vel, mass, n_real: int | None = None,
                     device: str | torch.device = "cpu") -> ParticleState:
    """Build a state from host arrays (e.g. a JAX state's ``np.asarray``)."""
    return ParticleState.create(pos, vel, mass, n_real=n_real, device=device)


def state_to_numpy(state: ParticleState):
    """``(pos, vel, mass, n_real)`` as host arrays."""
    return (state.pos.cpu().numpy(), state.vel.cpu().numpy(),
            state.mass.cpu().numpy(), state.n_real)
