"""Checkpoint / resume, in the JAX package's file format.

The reference has none (only a commented-out recording sketch, reference
src/main.rs:119-134). A checkpoint holds the simulation state (pos, vel,
mass, step) as a compressed ``.npz``: small, portable and exact (f32 bit
patterns round-trip). The fields are those of the JAX package's
``utils/checkpoint.py`` at ``FORMAT_VERSION`` 1, so each package reads the
other's files.

A distributed run saves in this format too
(``runtime.distributed.save_distributed_checkpoint``), which gathers every
live row onto each process. The sharded format avoids that: a directory
of ``manifest.json`` and one ``shard_{pid:05d}.npz`` per process, each
holding only that process's live rows, in the JAX package's layout at
``SHARDED_FORMAT_VERSION`` 1, so each package reads the other's
directories (``save_sharded_checkpoint``, ``load_sharded_checkpoint``).
"""

from __future__ import annotations

import json
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


# -- sharded checkpoints: no step holds the whole system on one process ------
#
# Each file holds one writer process's live rows. The distributed layout is
# globally Morton-sorted with each shard's live rows first, so the files
# concatenated in process order are the compact global state in order: a
# reader with any number of processes and shards loads only the files that
# overlap its equal slice of the live rows and rebuilds the layout with the
# collective repartition of the multi-process start
# (``parallel.multihost.multihost_state``).

SHARDED_FORMAT_VERSION = 1


def save_sharded_checkpoint(path: str | os.PathLike, state: ParticleState,
                            step: int, mesh) -> None:
    """Every process calls this; each writes only its own live rows.

    ``state`` is a distributed state on ``mesh`` in its canonical layout
    (``distribute_state``, ``multihost_state``, or a ``DistributedWorld``'s
    state). Each shard file is written to a temporary name and renamed;
    process 0 writes the manifest after an all-gather of the row counts,
    which no process passes before every file is in place, so a manifest
    implies complete shards."""
    from nbody_simulation_tpu_torch.parallel.multihost import (
        local_block, process_allgather_counts, process_count, process_index)

    path = Path(path)
    pid, nproc = process_index(), process_count()
    path.mkdir(parents=True, exist_ok=True)
    pos, _ = local_block(state.pos, mesh)
    vel, _ = local_block(state.vel, mesh)
    mass, _ = local_block(state.mass, mesh)
    live = mass > 0
    tmp = path / f"shard_{pid:05d}.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, version=np.int64(SHARDED_FORMAT_VERSION),
                            pos=pos[live], vel=vel[live], mass=mass[live])
    os.replace(tmp, path / f"shard_{pid:05d}.npz")
    counts = process_allgather_counts(int(live.sum()))
    if pid == 0:
        man = {"version": SHARDED_FORMAT_VERSION, "step": int(step),
               "n_processes": nproc, "counts": [int(c) for c in counts],
               "n_live": int(counts.sum())}
        tmpm = path / "manifest.json.tmp"
        tmpm.write_text(json.dumps(man))
        os.replace(tmpm, path / "manifest.json")


def load_sharded_checkpoint(path: str | os.PathLike, mesh, config):
    """``(distributed state on mesh, step)`` from a sharded checkpoint of
    either package, written by any number of processes. Every process
    calls this; each reads only the files that overlap its equal slice of
    the live rows."""
    from nbody_simulation_tpu_torch.parallel.multihost import (
        chunk_bounds, multihost_state, process_count, process_index)

    path = Path(path)
    man = json.loads((path / "manifest.json").read_text())
    if man["version"] != SHARDED_FORMAT_VERSION:
        raise ValueError(f"unsupported sharded checkpoint version "
                         f"{man['version']}")
    counts = np.asarray(man["counts"], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    lo, hi = chunk_bounds(int(offsets[-1]), process_index(), process_count())
    parts = {"pos": [np.zeros((0, 2), np.float32)],
             "vel": [np.zeros((0, 2), np.float32)],
             "mass": [np.zeros((0,), np.float32)]}
    for i in range(len(counts)):
        flo, fhi = int(offsets[i]), int(offsets[i + 1])
        if fhi <= lo or flo >= hi:
            continue
        with np.load(path / f"shard_{i:05d}.npz") as z:
            a, b = max(lo, flo) - flo, min(hi, fhi) - flo
            for name, rows in parts.items():
                rows.append(z[name][a:b])
    chunk = ParticleState.create(*(np.concatenate(rows)
                                   for rows in parts.values()))
    return multihost_state(chunk, mesh, config), int(man["step"])
