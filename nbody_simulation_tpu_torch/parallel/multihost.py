"""Process-group set-up and per-process state for the multi-process mesh.

The port of ``nbody_simulation_tpu/parallel/multihost.py``. After
``init_distributed`` returns, ``make_1d_mesh`` gives the
``ProcessGroupMesh`` over every rank. Launch one process per card with
``torchrun --nproc-per-node=P`` (which sets the variables read below), or
pass the arguments to each process yourself.

``multihost_state`` builds the distributed layout of
``parallel.bh_distributed.distribute_state`` without any process holding
the whole system: each process brings its own chunk
(``models.scenarios.scenario_chunk``), pads it to its shards' slots, and
one collective Morton repartition (``parallel.repartition``) sorts and
spreads it, bitwise ``distribute_state`` of the concatenated chunks.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.state import PAD_POS, ParticleState


def is_initialized() -> bool:
    """True once the default ``torch.distributed`` group exists (a
    one-process group included)."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str = "cuda") -> None:
    """Initialise the default ``torch.distributed`` group (idempotent).

    Explicit arguments win; otherwise torchrun's variables are read:
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. With
    nothing set at all the call is still made, as a one-process group on a
    free loopback port, so one process runs through the same code.
    ``device="cuda"`` takes NCCL and the card ``LOCAL_RANK`` (default 0);
    without CUDA it raises. ``device="cpu"`` takes gloo.
    """
    if dist.is_initialized():
        return
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs CUDA; "
                               "pass device='cpu' for gloo on the CPU")
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        coordinator_address = f"127.0.0.1:{port}"
        num_processes, process_id = 1, 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id, from arguments or from "
            "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK: got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes in the default group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def local_layout(n_global: int, n_devices: int, config: SimConfig) -> int:
    """Slots per shard L for ``n_global`` particles on ``n_devices`` shards,
    the rounding of ``distribute_state``: a power-of-two leaf count times
    ``leaf_size``."""
    per_dev = -(-n_global // n_devices)
    leaves = -(-per_dev // config.leaf_size)
    leaves = 1 << max(0, (leaves - 1).bit_length())
    return max(leaves * config.leaf_size, config.leaf_size)


def process_allgather_counts(n_local: int) -> np.ndarray:
    """Every process's chunk size, in rank order (int64), from a
    ``torch.distributed`` all-gather of one count; ``[n_local]`` without a
    group of several processes."""
    if not is_initialized() or dist.get_world_size() == 1:
        return np.array([n_local], np.int64)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(n_local))
    return np.array(counts, np.int64)


def multihost_state(chunk: ParticleState, mesh, config: SimConfig
                    ) -> ParticleState:
    """The distributed state from per-process chunks.

    ``chunk`` is this process's particles, in any order; the union over the
    processes is the system. Each process pads its chunk to its local
    shards' slots (the mesh's ``n_local`` × L) and the collective
    repartition sorts the whole in Morton order and spreads it: bitwise
    ``distribute_state`` of the chunks concatenated in rank order."""
    from nbody_simulation_tpu_torch.parallel.repartition import (
        make_collective_rebalance)

    n_dev = mesh.n_shards
    counts = process_allgather_counts(int(chunk.n))
    L = local_layout(int(counts.sum()), n_dev, config)
    rows = mesh.n_local * L
    if chunk.n > rows:
        raise ValueError(
            f"process chunk ({chunk.n}) exceeds local shard capacity "
            f"({mesh.n_local} shards x {L} slots); increase shards or "
            "rebalance chunk sizes")

    def padf(a, fill):
        a = a.detach().cpu().numpy()
        out = np.full((rows,) + a.shape[1:], fill, np.float32)
        out[:chunk.n] = a
        return torch.as_tensor(out, device=mesh.device)

    state = ParticleState(padf(chunk.pos, PAD_POS), padf(chunk.vel, 0.0),
                          padf(chunk.mass, 0.0), n_real=n_dev * L,
                          distributed=True)
    return make_collective_rebalance(mesh, config)(state)


def chunk_bounds(n: int, pid: int, nproc: int) -> tuple[int, int]:
    """Row range [lo, hi) of process ``pid``'s equal chunk of ``n`` rows:
    the row split that scenario chunks use."""
    base, rem = divmod(n, nproc)
    lo = pid * base + min(pid, rem)
    return lo, lo + base + (1 if pid < rem else 0)


def local_block(x: torch.Tensor, mesh) -> tuple[np.ndarray,
                                                list[tuple[int, int]]]:
    """This process's rows of a mesh-local array ``x`` [S·L, …] on the host,
    and the global [start, stop) row range of each of its shards, in shard
    order."""
    rows = x.shape[0] // mesh.n_local
    spans = [(s * rows, (s + 1) * rows) for s in mesh.shard_ids]
    return x.detach().cpu().numpy(), spans
