"""A one-axis mesh of particle shards, held in one process or one per rank.

The port of ``nbody_simulation_tpu/parallel/mesh.py``. The JAX package
shards the particle axis over a 1-D device mesh and writes each sharded
function once, per shard, inside ``shard_map`` with collectives. The port
keeps that shape with two forms of one interface:

- ``LocalMesh(n_shards, device)``: all P shards in this process on one
  device, the way the JAX tests run on 8 virtual CPU devices. Arrays are
  ``[P·L, …]``, seen as ``[P, L, …]``; a collective is a tensor operation
  over the shard axis. On one card this runs the sharded schedule and its
  kernels, with no interconnect.
- ``ProcessGroupMesh``: one shard per rank of an initialised
  ``torch.distributed`` group (NCCL for CUDA tensors, gloo on the CPU).
  Arrays are the rank's own ``[L, …]`` shard.

A sharded function sees its local arrays as S shards (``n_local``: P or 1)
of L rows each and runs per-shard work with ``map_shards``; per-shard
values it reduces are stacked ``[S, …]`` for ``psum``/``pmax``. So each
ring of ``parallel/`` is written once, against this interface.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nbody_simulation_tpu_torch.state import ParticleState


def _resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but CUDA is not "
                               "available; pass device='cpu' for the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class LocalMesh:
    """P shards held by this process on one device; collectives are tensor
    operations over the shard axis."""

    def __init__(self, n_shards: int, device: str | torch.device = "cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.n_local = self.n_shards
        self.device = _resolve_device(device)
        self.shard_ids = list(range(self.n_shards))

    def axis_index(self) -> torch.Tensor:
        """int64 [S]: the mesh index of each local shard."""
        return torch.arange(self.n_shards, device=self.device)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Shard i's block of ``x`` [S·L, …] goes to shard (i+shift) mod P."""
        p = self.n_shards
        return torch.roll(x.reshape(p, -1, *x.shape[1:]), shift % p,
                          dims=0).reshape(x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of per-shard values ``x`` [S, …] over every shard, in the
        values' dtype."""
        return x.sum(dim=0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's block in mesh order: [P·L, …]. Here the local array
        already is that."""
        return x

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The local shards' blocks of a replicated [P·L, …] array."""
        return x

    def __repr__(self) -> str:
        return f"LocalMesh(n_shards={self.n_shards}, device={self.device})"


class ProcessGroupMesh:
    """One shard per rank of the default ``torch.distributed`` group."""

    def __init__(self, device: str | torch.device = "cuda"):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialised "
                               "torch.distributed group (init_distributed)")
        self.n_shards = dist.get_world_size()
        self.n_local = 1
        self.rank = dist.get_rank()
        self.device = _resolve_device(device)
        self.shard_ids = [self.rank]

    def axis_index(self) -> torch.Tensor:
        return torch.tensor([self.rank], device=self.device)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        p = self.n_shards
        shift %= p
        if shift == 0:
            return x
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), (self.rank + shift) % p),
               dist.P2POp(dist.irecv, out, (self.rank - shift) % p)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x[0].clone()
        dist.all_reduce(y, op=op)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n_shards * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[0] // self.n_shards
        return x[self.rank * rows:(self.rank + 1) * rows]

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(rank={self.rank}, n_shards="
                f"{self.n_shards}, device={self.device})")


Mesh = LocalMesh | ProcessGroupMesh


def make_1d_mesh(n_shards: int | None = None,
                 device: str | torch.device = "cuda") -> Mesh:
    """The process-group mesh when ``torch.distributed`` is initialised
    (``n_shards``, if given, must be its world size), else a ``LocalMesh``
    of ``n_shards`` (default: one per CUDA card, or 1 on the CPU). The device
    defaults to the card; without CUDA that raises, with no CPU fallback."""
    device = _resolve_device(device)
    if dist.is_initialized():
        mesh = ProcessGroupMesh(device)
        if n_shards is not None and n_shards != mesh.n_shards:
            raise ValueError(f"requested {n_shards} shards, the process "
                             f"group has {mesh.n_shards}")
        return mesh
    if n_shards is None:
        n_shards = torch.cuda.device_count() if device.type == "cuda" else 1
    return LocalMesh(n_shards, device)


def shard_local_size(n: int, n_shards: int) -> int:
    """Rows per shard for N particles on P shards: N/P rounded up to a power
    of two ≥ 8 up to 2048, else to a multiple of 2048, so that it divides,
    or is smaller than, every power-of-two tile of the step kernels."""
    local = -(-n // n_shards)
    if local <= 2048:
        return max(8, 1 << (local - 1).bit_length())
    return -(-local // 2048) * 2048


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """Pad ``state`` (the whole system, on any device) to P·L rows with
    inert particles (``ParticleState.pad_to``) and place the mesh's local
    shards on its device: every row on a ``LocalMesh``, the rank's block on
    a ``ProcessGroupMesh``. ``n_real`` stays the global live count."""
    local = shard_local_size(state.n, mesh.n_shards)
    state = state.pad_to(mesh.n_shards * local).to(mesh.device)
    return ParticleState(mesh.local_rows(state.pos),
                         mesh.local_rows(state.vel),
                         mesh.local_rows(state.mass), n_real=state.n_real)


def split_shards(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The local array ``x`` [S·L, …] seen as [S, L, …]."""
    return x.reshape(mesh.n_local, -1, *x.shape[1:])


def map_shards(mesh: Mesh, fn, *arrays: torch.Tensor):
    """``fn`` on each local shard's row block of ``arrays`` (each
    [S·L, …]), in shard order; its outputs (a tensor or a tuple of them)
    concatenated back to [S·L, …]."""
    outs = [fn(*parts) for parts in zip(*(split_shards(mesh, a)
                                          for a in arrays))]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)
