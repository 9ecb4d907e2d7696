"""Checkpoint / resume, in the JAX package's file format.

The reference has none (only a commented-out recording sketch, reference
src/main.rs:119-134). A checkpoint holds the simulation state (pos, vel,
mass, step) as a compressed ``.npz``: small, portable and exact (f32 bit
patterns round-trip). The fields are those of the JAX package's
``utils/checkpoint.py`` at ``FORMAT_VERSION`` 1, so each package reads the
other's files.

A distributed run saves in this format too
(``runtime.distributed.save_distributed_checkpoint``). The sharded format
(``save_sharded_checkpoint``, one file per process) is not ported yet
(ROADMAP.md item 6, the sharded checkpoint and recorder).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from nbody_simulation_tpu_torch.state import ParticleState

FORMAT_VERSION = 1


def save_checkpoint(path: str | os.PathLike, state: ParticleState,
                    step: int) -> None:
    """Write ``state`` (its tensors copied to the host) and ``step`` to
    ``path``: first to ``<path>.tmp``, then renamed over ``path``, so a
    reader never sees a half-written file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            version=np.int64(FORMAT_VERSION),
            step=np.int64(step),
            n_real=np.int64(state.n_real),
            pos=state.pos.detach().cpu().numpy(),
            vel=state.vel.detach().cpu().numpy(),
            mass=state.mass.detach().cpu().numpy(),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str | os.PathLike) -> tuple[ParticleState, int]:
    """``(state on the CPU, step)`` from a checkpoint of either package."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        state = ParticleState.create(z["pos"], z["vel"], z["mass"],
                                     n_real=int(z["n_real"]))
        return state, int(z["step"])
