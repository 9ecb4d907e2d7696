"""Process-group set-up for the multi-process form of the mesh.

The port of ``init_distributed`` from ``nbody_simulation_tpu/parallel/
multihost.py``. After it returns, ``make_1d_mesh`` gives the
``ProcessGroupMesh`` over every rank. Launch one process per card with
``torchrun --nproc-per-node=P`` (which sets the variables read below), or
pass the arguments to each process yourself.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


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
