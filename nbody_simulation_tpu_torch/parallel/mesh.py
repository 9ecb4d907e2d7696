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

Besides the ring shift (``ppermute``), ``ppermute_pairs`` moves blocks
along an explicit list of (source, destination) pairs, and a shard that is
no pair's destination receives zeros (JAX ``ppermute`` semantics).
``ppermute_blocks`` and ``all_gather_blocks`` move a list of tensors of any
shapes and dtypes per shard in one collective per dtype. On the
process-group form the permutations and ``all_gather`` are autograd
functions (the inverse permutation; a reduce-scatter), so gradients cross
ranks; on ``LocalMesh`` they are tensor operations with their own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nbody_simulation_tpu_torch.state import ParticleState

# The mesh axis's name in the JAX package; the port's meshes have one axis.
AXIS = "shard"


def _check_pairs(n: int, pairs) -> tuple:
    """``pairs`` as a tuple of (src, dst) int pairs, each shard at most once
    a source and once a destination."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or any(not (0 <= x < n) for x in srcs + dsts)):
        raise ValueError(f"pairs must be a partial permutation of "
                         f"{n} shards, got {pairs}")
    return pairs


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
        self._perm_cache = {}

    def axis_index(self) -> torch.Tensor:
        """int64 [S]: the mesh index of each local shard."""
        return torch.arange(self.n_shards, device=self.device)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Shard i's block of ``x`` [S·L, …] goes to shard (i+shift) mod P."""
        p = self.n_shards
        return torch.roll(x.reshape(p, -1, *x.shape[1:]), shift % p,
                          dims=0).reshape(x.shape)

    def ppermute_pairs(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """Shard s's block of ``x`` [S·L, …] goes to shard d for each (s, d)
        of ``pairs``; a shard that is no destination gets zeros."""
        p = self.n_shards
        src = [-1] * p
        for s, d in _check_pairs(p, pairs):
            src[d] = s
        xs = x.reshape(p, -1, *x.shape[1:])
        key = (tuple(src), x.device)
        if key not in self._perm_cache:
            self._perm_cache[key] = (
                torch.tensor([max(s, 0) for s in src], device=x.device),
                torch.tensor([s >= 0 for s in src], device=x.device))
        idx, keep = self._perm_cache[key]
        out = xs.index_select(0, idx)
        if min(src) < 0:
            out = torch.where(keep.reshape(p, *(1,) * (xs.ndim - 1)), out,
                              torch.zeros((), dtype=x.dtype, device=x.device))
        return out.reshape(x.shape)

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
        return self.ppermute_pairs(x, [(i, (i + shift) % p)
                                       for i in range(p)])

    def ppermute_pairs(self, x: torch.Tensor, pairs) -> torch.Tensor:
        return _PPermute.apply(x, self, _check_pairs(self.n_shards, pairs))

    def _send_recv(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """The rank's block after the permutation ``pairs`` (no autograd)."""
        to = [d for s, d in pairs if s == self.rank]
        frm = [s for s, d in pairs if d == self.rank]
        if to and to[0] == self.rank:
            return x.clone()
        out = torch.zeros_like(x)
        ops = []
        if to:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), to[0]))
        if frm:
            ops.append(dist.P2POp(dist.irecv, out, frm[0]))
        if ops:
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
        return _AllGather.apply(x, self)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n_shards * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    def _reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of each rank's ``g`` [P·L, …], this rank's L rows.
        gloo has no reduce-scatter: an all-reduce, then the rank's rows."""
        rows = g.shape[0] // self.n_shards
        g = g.contiguous()
        if dist.get_backend() == "nccl":
            out = torch.empty((rows, *g.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, g)
            return out
        g = g.clone()                     # all_reduce works in place
        dist.all_reduce(g)
        return g[self.rank * rows:(self.rank + 1) * rows].clone()

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[0] // self.n_shards
        return x[self.rank * rows:(self.rank + 1) * rows]

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(rank={self.rank}, n_shards="
                f"{self.n_shards}, device={self.device})")


class _PPermute(torch.autograd.Function):
    """``ProcessGroupMesh.ppermute_pairs``; its backward sends the
    cotangent back along the inverse pairs."""

    @staticmethod
    def forward(ctx, x, mesh, pairs):
        ctx.mesh, ctx.pairs = mesh, pairs
        return mesh._send_recv(x, pairs)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.pairs)
        return ctx.mesh._send_recv(g.contiguous(), inv), None, None


class _AllGather(torch.autograd.Function):
    """``ProcessGroupMesh.all_gather``; its backward is a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh._gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce_scatter(g), None


Mesh = LocalMesh | ProcessGroupMesh


def _pack(parts):
    """One flat buffer per dtype of the tensors ``parts``, and what
    ``_unpack`` needs to cut it back."""
    groups = {}
    for i, t in enumerate(parts):
        groups.setdefault(t.dtype, []).append(i)
    bufs = {dt: torch.cat([parts[i].reshape(-1) for i in idx])
            for dt, idx in groups.items()}
    return bufs, (groups, [(t.shape, t.numel()) for t in parts])


def _unpack(bufs, spec):
    groups, shapes = spec
    out = [None] * len(shapes)
    for dt, idx in groups.items():
        off = 0
        for i in idx:
            shape, n = shapes[i]
            out[i] = bufs[dt][off:off + n].reshape(shape)
            off += n
    return out


def _blocks(mesh: Mesh, parts, collective, n_out: int):
    """``collective`` ([S·B] → [n_out·B]) on the per-shard tensor lists
    ``parts`` (one list per local shard, alike in shapes and dtypes),
    packed by dtype; returns ``n_out`` lists."""
    packed = [_pack(list(p)) for p in parts]
    spec = packed[0][1]
    moved = {dt: collective(torch.cat([b[dt] for b, _ in packed]))
             for dt in packed[0][0]}
    return [_unpack({dt: m.reshape(n_out, -1)[k] for dt, m in moved.items()},
                    spec) for k in range(n_out)]


def ppermute_blocks(mesh: Mesh, parts, pairs):
    """``ppermute_pairs`` of each local shard's list of tensors ``parts``
    (lists alike in shapes and dtypes), one collective per dtype; returns
    the local shards' received lists, zeros where no pair sends."""
    return _blocks(mesh, parts, lambda x: mesh.ppermute_pairs(x, pairs),
                   mesh.n_local)


def all_gather_blocks(mesh: Mesh, parts):
    """Every shard's list of tensors, in mesh order (P lists), from each
    local shard's list ``parts``."""
    return _blocks(mesh, parts, mesh.all_gather, mesh.n_shards)


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
