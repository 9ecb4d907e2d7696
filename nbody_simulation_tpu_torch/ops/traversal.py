"""Barnes-Hut traversal: a level-synchronous planner plus one force sweep.

The port of ``nbody_simulation_tpu/ops/traversal.py``: the monopole path
(θ≥2) and the quadrupole path (``multipole=2``, every θ<2). The reference
walks the tree recursively per particle (reference src/main.rs:348-386);
here, as in the JAX package, the walk is split:

1. **Planning (plain torch).** Each planning row (``plan_leaves`` adjacent
   leaves) walks the tree one level at a time with a fixed-capacity
   frontier. A node is accepted when it is disjoint from the row's AABB and
   passes the θ test at the minimum distance from that AABB to the node's
   COM — conservative against the per-particle rule. Every level's
   candidates become source columns (COM, mass if accepted else 0); nodes
   that reach the leaf level land in a leaf list whose particles are
   gathered in. Overflow of a capacity accepts the node's COM instead of
   dropping it. With ``multipole=2`` a node is accepted only when it is
   also strictly separated from the AABB in both axes, or passes θ/2;
   accepted nodes that are separated carry their second moments in three
   more columns. The JAX package's ``lax.scan`` over width-padded level
   buckets (a TPU gather tuning) is one Python loop over levels here; the
   child-interleaved candidate order, which fixes the source-column order,
   is the same.
2. **Force sweep (CUDA).** For group g, its S targets against its C
   planned sources: ``grouped_force``, which launches the hand-written
   kernel ``csrc/grouped_sweep.cu`` on CUDA tensors (K3, or K4 with the
   quadrupole columns) and runs the plain version ``grouped_force_ref`` on
   CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nbody_simulation_tpu_torch.config import check_rcp
from nbody_simulation_tpu_torch.ops import split
from nbody_simulation_tpu_torch.ops.force import (FLT_MAX, FLT_MIN_NORMAL,
                                                  pair_accel)
from nbody_simulation_tpu_torch.ops.tree import BIG, FlatTree, build_tree


def accept_node_scalar(p, nmin, nmax, com, theta):
    """The reference's per-particle acceptance of a node (reference
    src/main.rs:370-373), kept for tests: accept iff the node does not
    contain ``p`` and max(w, h)² < d²(p, com)·θ². Works on tensors of any
    matching leading shape (the last axis holds x, y)."""
    contains = ((p[..., 1] > nmin[..., 1]) & (p[..., 0] > nmin[..., 0])
                & (p[..., 0] < nmax[..., 0]) & (p[..., 1] < nmax[..., 1]))
    size = nmax - nmin
    s2 = torch.maximum(size[..., 0], size[..., 1]) ** 2
    d2 = (p[..., 0] - com[..., 0]) ** 2 + (p[..., 1] - com[..., 1]) ** 2
    return ~contains & (s2 < d2 * theta * theta)


def _group_node_d2(gmin, gmax, nmin, nmax, ncom):
    """Min squared distance from the group AABB to the node COM; plus the
    strict-disjoint flag and node size²."""
    disjoint = ((gmax[..., 0] <= nmin[..., 0]) | (gmin[..., 0] >= nmax[..., 0])
                | (gmax[..., 1] <= nmin[..., 1]) | (gmin[..., 1] >= nmax[..., 1]))
    size = nmax - nmin
    s2 = torch.maximum(size[..., 0], size[..., 1]) ** 2
    dx = torch.clamp_min(torch.maximum(gmin[..., 0] - ncom[..., 0],
                                       ncom[..., 0] - gmax[..., 0]), 0.0)
    dy = torch.clamp_min(torch.maximum(gmin[..., 1] - ncom[..., 1],
                                       ncom[..., 1] - gmax[..., 1]), 0.0)
    return disjoint, s2, dx * dx + dy * dy


def segment_sum_ref(src: torch.Tensor, key: torch.Tensor, perm: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """The plain version of ``segment_sum_cuda``, with its arguments: row r
    of the result is the sum of ``src[perm[j]]`` over the run of entries j
    whose ``key[j]`` is r, added one term after another in f64 and rounded
    once; a row no key names gets +0."""
    terms = src.index_select(0, perm).double()
    return torch.segment_reduce(terms, "sum",
                                lengths=torch.bincount(key, minlength=n_rows),
                                axis=0, unsafe=True).float()


_segment_lib = None
_segment_window = None


def _load_segment_lib():
    global _segment_lib, _segment_window
    if _segment_lib is None:
        from nbody_simulation_tpu_torch.cuda_build import load_cuda_library
        lib = load_cuda_library("segment_sum")
        lib.segment_sum_window.restype = ctypes.c_int
        lib.segment_sum_window.argtypes = []
        lib.segment_sum_launch.restype = ctypes.c_int
        lib.segment_sum_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        _segment_window = lib.segment_sum_window()
        _segment_lib = lib
    return _segment_lib


def segment_sum_cuda(src: torch.Tensor, key: torch.Tensor, perm: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """Launch the fixed-order segmented sum (``csrc/segment_sum.cu``): f32
    (n_rows, W) from ``src`` f32 (K, W), ``key`` int32 or int64 (K,), the
    gather's index sorted stably, and ``perm`` int64 (K,), the permutation
    that sorts it; all contiguous on one CUDA device, anything else raises.
    Blocks take fixed windows of the sorted entries and find the run edges
    in ``key`` themselves; each run is added in f64 in index order, a run
    cut by a window edge finished by a second pass in window order, and
    rounded once. Nothing waits on the host. ``segment_sum_cuda.launches``
    counts the calls."""
    if src.device.type != "cuda":
        raise ValueError(f"segment_sum_cuda needs CUDA tensors, got "
                         f"{src.device}")
    if src.ndim != 2 or src.dtype != torch.float32:
        raise ValueError(f"src must be f32 (K, W), got {src.dtype} "
                         f"{tuple(src.shape)}")
    k, w = src.shape
    if (key.dtype not in (torch.int32, torch.int64) or tuple(key.shape) != (k,)
            or perm.dtype != torch.int64 or tuple(perm.shape) != (k,)):
        raise ValueError(f"key must be int32 or int64 and perm int64, both "
                         f"{(k,)}, got {key.dtype} {tuple(key.shape)} and "
                         f"{perm.dtype} {tuple(perm.shape)}")
    for t in (src, key, perm):
        if t.device != src.device or not t.is_contiguous():
            raise ValueError("segment_sum_cuda needs contiguous tensors on "
                             "one device")
    if not 0 <= n_rows < 2**31 or w >= 2**21:
        raise ValueError(f"segment_sum_cuda: {n_rows} rows of width {w}")
    out = torch.empty((n_rows, w), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _load_segment_lib()
    # Scratch: two f64 partials a window, only those a window edge cuts
    # written and read.
    slots = torch.empty((max(1, -(-k // _segment_window)), 2, w),
                        dtype=torch.float64, device=src.device)
    err = lib.segment_sum_launch(
        src.data_ptr(), key.data_ptr(), key.element_size(), perm.data_ptr(),
        slots.data_ptr(), out.data_ptr(), k, n_rows, w,
        src.device.index or 0, _stream_of(src))
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err} at K={k}, W={w}, rows={n_rows}")
    segment_sum_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0


def index_add_ordered(n_rows: int, idx: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """``zeros(n_rows, …).index_add_(0, idx, src)`` with every row's
    duplicates added in a fixed order: a stable sort of ``idx`` puts each
    row's entries in their index order, and a segmented sum adds each run
    in an order set by the sorted index alone (``segment_sum_cuda`` on a
    CUDA tensor, ``segment_sum_ref`` on a CPU tensor). The bits do not
    depend on the launch, where ``index_add_`` on a CUDA tensor adds
    duplicates with float atomics in whatever order they land. An int32
    ``idx`` sorts in half the radix passes of an int64 one."""
    key, perm = torch.sort(idx, stable=True)
    flat = src.reshape(src.shape[0], math.prod(src.shape[1:]))
    if src.device.type == "cuda":
        out = segment_sum_cuda(flat.contiguous(), key, perm, n_rows)
    elif src.device.type == "cpu":
        out = segment_sum_ref(flat, key, perm, n_rows)
    else:
        raise ValueError(f"no segmented sum on {src.device}")
    return out.reshape(n_rows, *src.shape[1:])


class _GatherRows(torch.autograd.Function):
    """``index_select`` forward; the backward adds the cotangent rows of
    each gathered row in a fixed order (``index_add_ordered``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return index_add_ordered(ctx.n_rows, idx, g), None


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer index of any shape, by ``index_select``:
    the same values. In the planner every group gathers the same few
    top-level nodes, so the backward adds many duplicates per row. It adds
    them in a fixed order (``_GatherRows``), so a Barnes-Hut gradient is
    bitwise the same on two calls. ``index_select``'s own backward adds
    them with float atomics, in no fixed order. Advanced indexing's
    backward is also ordered, but took one galaxy Barnes-Hut value+grad
    from 27.8 to 171.7 ms on an H100 (PERF.md)."""
    flat = idx.reshape(-1)
    out = (_GatherRows.apply(table, flat) if table.requires_grad
           else torch.index_select(table, 0, flat))
    return out.reshape(*idx.shape, *table.shape[1:])


def _compact(flags: torch.Tensor, values: torch.Tensor, cap: int):
    """Prefix-compact ``values`` where ``flags`` into per-row lists of width
    ``cap``. Returns (lists (G,cap) int32, valid (G,cap) bool, overflow
    (G,K) bool)."""
    g = flags.shape[0]
    dev = flags.device
    slot = torch.cumsum(flags.to(torch.int32), dim=1) - 1
    overflow = flags & (slot >= cap)
    store = flags & (slot < cap)
    rows = torch.arange(g, dtype=torch.int64, device=dev)[:, None] * cap
    # Entries that are not stored go to one extra slot, cut off below.
    flat_idx = torch.where(store, rows + slot, g * cap).ravel()
    lists = torch.zeros(g * cap + 1, dtype=torch.int32, device=dev)
    lists.scatter_(0, flat_idx, values.to(torch.int32).ravel())
    valid = torch.zeros(g * cap + 1, dtype=torch.bool, device=dev)
    valid.scatter_(0, flat_idx, store.ravel())
    return (lists[:g * cap].reshape(g, cap), valid[:g * cap].reshape(g, cap),
            overflow)


# Candidate widths up to this run the dense rank compaction; wider ones
# (physics-quality caps) sort, as in the JAX package.
_RANK_COMPACT_MAX_K = 128


def _compact_ranked(flags: torch.Tensor, values: torch.Tensor,
                    key: torch.Tensor, cap: int):
    """Closest-first compaction: entry j's slot is its rank among flagged
    entries ordered by (key, index). Same result as a stable sort by key
    followed by ``_compact``. Returns (lists, valid, overflow) as
    ``_compact``."""
    k = flags.shape[1]
    dev = flags.device
    kf = torch.where(flags, key, torch.full((), float("inf"),
                                            dtype=key.dtype, device=dev))
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    first = kf[:, :, None] < kf[:, None, :]
    tie = (kf[:, :, None] == kf[:, None, :]) & (idx[:, None] < idx[None, :])
    less = (first | tie) & flags[:, :, None]
    rank = less.sum(dim=1, dtype=torch.int32)
    overflow = flags & (rank >= cap)
    store = flags & (rank < cap)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    onehot = (rank[:, :, None] == slots) & store[:, :, None]  # (G, K, cap)
    lists = torch.where(onehot, values.to(torch.int32)[:, :, None],
                        torch.zeros((), dtype=torch.int32, device=dev)
                        ).sum(dim=1, dtype=torch.int32)
    valid = onehot.any(dim=1)
    return lists, valid, overflow


def bh_plan_sources(tree: FlatTree, theta: float, frontier_cap: int,
                    leaf_cap: int, arity: int = 2, plan_leaves: int = 1,
                    multipole: int = 1):
    """Planning pass → per-group source columns (src_x, src_y, src_m), each
    (G, C), plus (src_qxx, src_qxy, src_qyy) with ``multipole=2``. Zero-mass
    entries contribute zero monopole force. The walk starts at level
    log2(F) with all its nodes in the frontier; ``arity=4`` walks two binary
    levels per iteration."""
    if arity not in (2, 4):
        raise ValueError(f"arity must be 2 or 4, got {arity}")
    depth = tree.depth
    n_leaves = tree.leaf_pos.shape[0]
    # One planning row covers pl_ adjacent leaves; its AABB is their common
    # ancestor at level depth - log2(pl_).
    pl_ = plan_leaves
    while pl_ > 1 and (n_leaves % pl_ or (1 << depth) < pl_):
        pl_ //= 2
    own_level = tree.levels[depth - (pl_.bit_length() - 1)]
    return plan_rows(tree, own_level, theta, frontier_cap, leaf_cap, arity,
                     multipole=multipole)


def plan_rows(tree: FlatTree, own, theta: float, frontier_cap: int,
              leaf_cap: int, arity: int = 2, multipole: int = 1,
              max_levels: int | None = None, seed=None,
              return_frontier: bool = False):
    """The planner over explicit own-AABB rows (one per planning row; only
    ``own.aabb_min`` and ``own.aabb_max`` are read).

    Returns ``(src_x, src_y, src_m)`` of (G, C), plus ``(src_qxx, src_qxy,
    src_qyy)`` with ``multipole=2`` (Q only where a node was accepted and is
    separated in both axes; overflow fallbacks and leaf particles carry 0).

    ``max_levels``: the bounded walk. It expands at most this many levels
    past the seed level, then flushes: every node still open at the cut
    level becomes a COM column, monopole only even at ``multipole=2`` (the
    nodes failed the θ test), and no leaf tile is gathered, so it serves
    trees without leaf data (the distributed forest). ``seed``: ``(level,
    frontier, valid)`` resumes a walk from an explicit frontier at
    ``level`` (its width must equal ``frontier_cap``).
    ``return_frontier``: with ``max_levels``, skip the flush and return
    ``(cols, frontier, valid)``, the columns of the walked levels only.
    The default, unbounded and unseeded, walks to the leaves.
    """
    if multipole not in (1, 2):
        raise ValueError(f"multipole must be 1 or 2, got {multipole}")
    quad = multipole == 2
    depth = tree.depth
    F = frontier_cap
    dev = own.aabb_min.device
    g_rows = own.aabb_min.shape[0]
    gmin = own.aabb_min[:, None, :]     # (G,1,2) group AABB
    gmax = own.aabb_max[:, None, :]
    theta2 = float(np.float32(theta * theta))
    # θ²/4 as the JAX package writes it, jnp.float32(theta * theta * 0.25)
    # (equal to theta2 / 4: scaling by 4 commutes with the rounding).
    tight2 = float(np.float32(theta * theta * 0.25))
    if seed is not None:
        k0 = seed[0]
        if seed[1].shape[1] != F:
            raise ValueError(f"a seeded frontier must be {F} wide, got "
                             f"{tuple(seed[1].shape)}")
    else:
        k0 = min(max(F.bit_length() - 1, 0), depth - 1) if depth > 0 else 0

    def level_body(packed_child, frontier, valid, fan, cap):
        """Expand one level: test fan·F candidate children, emit their COM
        source columns, compact the opened ones (closest first) into a
        width-``cap`` list."""
        g_, fw = frontier.shape
        w, ncols = packed_child.shape
        # The fan children of frontier node k are rows fan·k .. fan·k+fan−1:
        # one gather by parent fetches them, child-interleaved per parent.
        rec = _rows(packed_child.reshape(w // fan, fan * ncols),
                    frontier).reshape(g_, fw * fan, ncols)
        cand = (frontier[:, :, None] * fan
                + torch.arange(fan, dtype=torch.int32, device=dev)
                ).reshape(g_, fw * fan)
        cvalid = valid[:, :, None].expand(g_, fw, fan).reshape(g_, fw * fan)
        nmin, nmax, ncom = rec[..., 0:2], rec[..., 2:4], rec[..., 4:6]
        nonempty = rec[..., 7] > 0
        disjoint, s2, d2 = _group_node_d2(gmin, gmax, nmin, nmax, ncom)
        accept = cvalid & disjoint & (s2 < d2 * theta2)
        both_sep = None
        if quad:
            # The law's |d|_1 kinks at dx=0 and dy=0: the expansion holds
            # only for a node strictly separated from the group in both
            # axes. Others must pass θ/2 and stay monopole.
            both_sep = (((gmax[..., 0] <= nmin[..., 0])
                         | (gmin[..., 0] >= nmax[..., 0]))
                        & ((gmax[..., 1] <= nmin[..., 1])
                           | (gmin[..., 1] >= nmax[..., 1])))
            tight = cvalid & disjoint & (s2 < d2 * tight2)
            accept = (accept & both_sep) | tight
        opened = cvalid & ~accept & nonempty
        # Closest-first: overflow falls back to COM on the farthest nodes.
        if cand.shape[1] <= _RANK_COMPACT_MAX_K:
            new_list, new_valid, overflow = _compact_ranked(
                opened, cand, d2, cap)
        else:
            if cap < cand.shape[1]:
                perm = torch.argsort(
                    torch.where(opened, d2, torch.full((), BIG, device=dev)),
                    dim=1, stable=True)
                cand = torch.take_along_dim(cand, perm, dim=1)
                opened = torch.take_along_dim(opened, perm, dim=1)
                accept = torch.take_along_dim(accept, perm, dim=1)
                rec = torch.take_along_dim(rec, perm[..., None], dim=1)
                if quad:
                    both_sep = torch.take_along_dim(both_sep, perm, dim=1)
            new_list, new_valid, overflow = _compact(opened, cand, cap)
        use_com = accept | overflow  # overflow → COM, never dropped
        zero = torch.zeros((), device=dev)
        cols = (rec[..., 4], rec[..., 5], torch.where(use_com, rec[..., 6],
                                                      zero))
        if quad:
            # Overflow fallbacks are close nodes: monopole only.
            use_q = accept & both_sep
            cols += tuple(torch.where(use_q, rec[..., 8 + k], zero)
                          for k in range(3))
        return new_list, new_valid, cols

    def packed_of(level):
        return level.packed_quad if quad else level.packed

    src_cols = [[] for _ in range(6 if quad else 3)]
    if seed is not None:
        frontier, valid = seed[1], seed[2]
    else:
        width = 1 << k0
        frontier = torch.zeros((g_rows, max(F, width)), dtype=torch.int32,
                               device=dev)
        frontier[:, :width] = torch.arange(width, dtype=torch.int32,
                                           device=dev)
        valid = (torch.arange(frontier.shape[1], device=dev) < width
                 ).expand(g_rows, -1)
    leaf_ids = torch.zeros((g_rows, 1), dtype=torch.int32, device=dev)
    leaf_valid = torch.ones((g_rows, 1), dtype=torch.bool, device=dev)

    # The bounded walk's cut: the deepest level it expands to, then flushes.
    cut = None if max_levels is None else min(depth, k0 + max_levels)
    end = depth if cut is None else cut
    lvl = k0
    while lvl < end:
        step = 2 if (arity == 4 and lvl + 2 <= end) else 1
        last = cut is None and lvl + step >= depth
        level = tree.levels[lvl + step]
        out_list, out_valid, cols = level_body(
            packed_of(level), frontier, valid, 1 << step,
            leaf_cap if last else F)
        if last:
            leaf_ids, leaf_valid = out_list, out_valid
        else:
            frontier, valid = out_list, out_valid
        for k, col in enumerate(cols):
            src_cols[k].append(col)
        lvl += step

    def joined():
        return tuple(torch.cat(c, dim=1) if c else
                     torch.zeros((g_rows, 0), device=dev) for c in src_cols)

    if cut is not None and return_frontier:
        return joined(), frontier, valid
    if cut is not None:
        # Flush: the still-open frontier nodes at the cut become COM
        # columns (close nodes: monopole only, like the overflow fallback).
        rec = _rows(packed_of(tree.levels[cut]), frontier)
        zero = torch.zeros((), device=dev)
        src_cols[0].append(rec[..., 4])
        src_cols[1].append(rec[..., 5])
        src_cols[2].append(torch.where(valid, rec[..., 6], zero))
        for k in range(3, len(src_cols)):
            src_cols[k].append(torch.zeros(frontier.shape, device=dev))
        return joined()

    # Leaf tiles: gather (G, L, S) particle data; invalid slots massless,
    # particles without second moments.
    lp = _rows(tree.leaf_pos, leaf_ids)                 # (G, L, S, 2)
    lm = _rows(tree.leaf_mass, leaf_ids) * leaf_valid[..., None]
    n_src = leaf_ids.shape[1] * tree.leaf_pos.shape[1]
    src_cols[0].append(lp[..., 0].reshape(g_rows, n_src))
    src_cols[1].append(lp[..., 1].reshape(g_rows, n_src))
    src_cols[2].append(lm.reshape(g_rows, n_src))
    for k in range(3, len(src_cols)):
        src_cols[k].append(torch.zeros((g_rows, n_src), device=dev))
    return tuple(torch.cat(c, dim=1) for c in src_cols)


# -- the force sweep ----------------------------------------------------------

_REF_CHUNK_ELEMS = 1 << 25


def quad_tile(dx, dy, mj, qxx, qxy, qyy, softening2: float = 1e-3):
    """Monopole + quadrupole contributions (cx, cy) of sources with second
    moments Q = Σ m·δδᵀ about their COM: the JAX package's ``_quad_tile`` in
    ``exact``, operation for operation (``csrc/pair_law.cuh`` quad_pair is
    the kernel's form). The correction is ½·Q : ∇∇f at the COM displacement,
    f(d) = d/(‖d‖₁·‖d‖₂²). It does not scale with ``mj``, and it is
    computed for every pair, Q = 0 included: where a³b overflows, 0·inf
    makes the pair NaN, as in the JAX kernel. Masked pairs (‖d‖₁ not a
    normal float) give 0; there is no "+clamp" form."""
    adx = dx.abs()
    ady = dy.abs()
    s = adx + ady
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
    a = torch.reciprocal(s)
    b = torch.reciprocal(d2)
    w = mj * (a * b)
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    sx = torch.where(dx >= 0, one, -one)
    sy = torch.where(dy >= 0, one, -one)
    ab = a * b
    a2b = a * ab
    ab2 = b * ab
    a3b = a * a2b
    a2b2 = b * a2b
    ab3 = b * ab2
    gx = -(sx * a2b + 2.0 * dx * ab2)
    gy = -(sy * a2b + 2.0 * dy * ab2)
    t1 = 2.0 * a3b
    t2 = 2.0 * ab2
    gxx = t1 + 4.0 * adx * a2b2 - t2 + 8.0 * dx * dx * ab3
    gyy = t1 + 4.0 * ady * a2b2 - t2 + 8.0 * dy * dy * ab3
    gxy = (2.0 * sx * sy * a3b + 2.0 * (sx * dy + sy * dx) * a2b2
           + 8.0 * dx * dy * ab3)
    corr_x = 0.5 * ((2.0 * gx + dx * gxx) * qxx
                    + 2.0 * (gy + dx * gxy) * qxy + (dx * gyy) * qyy)
    corr_y = 0.5 * ((dy * gxx) * qxx + 2.0 * (gx + dy * gxy) * qxy
                    + (2.0 * gy + dy * gyy) * qyy)
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    return (torch.where(normal, dx * w + corr_x, zero),
            torch.where(normal, dy * w + corr_y, zero))


def grouped_force_ref(tgt: torch.Tensor, src_x: torch.Tensor,
                      src_y: torch.Tensor, src_m: torch.Tensor,
                      softening2: float = 1e-3, rcp: str = "exact",
                      col_limit: torch.Tensor | None = None,
                      src_q=None) -> torch.Tensor:
    """The sweep's plain version: targets (G, S, 2) against per-group
    sources (G, C) → accel (G, S, 2), summing columns ``c < col_limit[g]``
    (all C when None). ``src_q`` = (qxx, qxy, qyy) of (G, C) switches the
    law to the quadrupole form ``quad_tile`` (K4's).

    Always computes ``exact`` — the law of ``ops/force.pair_accel``, or
    ``quad_tile`` — as the JAX package's interpret path does; ``rcp`` is
    validated only. Groups are taken in chunks so the (g, S, C) temporaries
    stay near ``_REF_CHUNK_ELEMS`` elements (the whole galaxy sweep would be
    1.3 GB each).
    """
    check_rcp(rcp)
    g, s, _ = tgt.shape
    c = src_x.shape[1]
    out = torch.empty_like(tgt)
    gc = max(1, _REF_CHUNK_ELEMS // max(1, s * c))
    cols = torch.arange(c, device=tgt.device)
    for g0 in range(0, g, gc):
        sl = slice(g0, g0 + gc)
        dx = src_x[sl, None, :] - tgt[sl, :, 0:1]      # (gc, S, C)
        dy = src_y[sl, None, :] - tgt[sl, :, 1:2]
        if src_q is None:
            ax, ay = pair_accel(dx, dy, src_m[sl, None, :], softening2)
        else:
            ax, ay = quad_tile(dx, dy, src_m[sl, None, :],
                               *(q[sl, None, :] for q in src_q), softening2)
        if col_limit is not None:
            keep = (cols[None, :] < col_limit[sl, None])[:, None, :]
            zero = torch.zeros((), dtype=ax.dtype, device=ax.device)
            ax = torch.where(keep, ax, zero)
            ay = torch.where(keep, ay, zero)
        out[sl, :, 0] = ax.sum(dim=-1)
        out[sl, :, 1] = ay.sum(dim=-1)
    return out


_sweep_lib = None


def _load_sweep_lib():
    global _sweep_lib
    if _sweep_lib is None:
        from nbody_simulation_tpu_torch.cuda_build import load_cuda_library
        _sweep_lib = _bind_sweep(load_cuda_library("grouped_sweep"))
    return _sweep_lib


def _bind_sweep(lib):
    """Set the C signatures of ``csrc/grouped_sweep.cu`` on a loaded
    library."""
    lib.grouped_sweep_launch.restype = ctypes.c_int
    lib.grouped_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.grouped_sweep_shape.restype = ctypes.c_int
    lib.grouped_sweep_shape.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.grouped_sweep_regs.restype = ctypes.c_int
    lib.grouped_sweep_regs.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)])
    lib.quad_sweep_launch.restype = ctypes.c_int
    lib.quad_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.quad_sweep_shape.restype = ctypes.c_int
    lib.quad_sweep_shape.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
    return lib


# -- K3's work split ----------------------------------------------------------

# K3: target lanes per block, at most (32: 2 blocks of 8 slices per galaxy
# group; 16 and 64 were no faster there, tools/sweep_kernel_ab.py).
MONO_LANES = 32


class MonoPlan(NamedTuple):
    """K3's grid (``mono_sweep_plan``): blocks of ``threads`` threads,
    ``lanes`` target lanes times ``slices`` column slices, each thread
    ``targets`` targets, ``tpg`` blocks per group. Block (g, b), thread
    (slice w, lane l) sums targets b·lanes·targets + l + t·lanes (t <
    targets) against the runs of 32 columns w, w + slices, … below the
    group's bound; the block adds the slices' partials in slice order."""
    threads: int
    targets: int
    lanes: int
    slices: int
    tpg: int


def mono_sweep_plan(g: int, s: int, c: int, threads: int,
                    targets: int) -> MonoPlan:
    """K3's grid for G groups of S targets and C columns: S / targets
    lanes, rounded up to a power of two, at most ``MONO_LANES`` and
    ``threads`` (a power of two), and the block's other threads column
    slices. It depends on S alone, not on G, C or the per-group bounds, so
    the bounded sweep adds the full sweep's runs in the same order, and a
    group sums alike in a call of any G."""
    if min(g, s, threads, targets) <= 0 or c < 0 or threads & (threads - 1):
        raise ValueError(f"mono_sweep_plan: bad shape G={g} S={s} C={c}, "
                         f"{threads}x{targets} per block")
    lanes = min(MONO_LANES, threads, 1 << (-(-s // targets) - 1).bit_length())
    return MonoPlan(threads, targets, lanes, threads // lanes,
                    -(-s // (lanes * targets)))


def mono_launch_plan(g: int, s: int, c: int, device: torch.device,
                     mode: int) -> MonoPlan:
    """``mono_sweep_plan`` for K3 in rcp mode ``mode`` on a CUDA
    ``device``, with the block read from the built kernel
    (``split.launch_shape``)."""
    shape = split.launch_shape(_load_sweep_lib().grouped_sweep_shape, device,
                               s, mode)
    return mono_sweep_plan(g, s, c, shape.threads, shape.targets)


def mono_sweep(lib, tgt, src_x, src_y, src_m, col_limit, softening2: float,
               mode: int, lanes: int, allow_fast: bool = True):
    """Launch K3 from ``lib`` with ``lanes`` target lanes per block, on
    inputs ``grouped_sweep`` has checked; returns the CUDA error and the
    output. ``allow_fast=False`` keeps every tile on the general law (the
    bitwise reference of the fast form's)."""
    g, s, _ = tgt.shape
    out = torch.empty_like(tgt)
    err = lib.grouped_sweep_launch(
        tgt.data_ptr(), src_x.data_ptr(), src_y.data_ptr(), src_m.data_ptr(),
        None if col_limit is None else col_limit.data_ptr(), out.data_ptr(),
        g, s, src_x.shape[1], lanes, int(allow_fast), float(softening2),
        mode, tgt.device.index or 0, _stream_of(tgt))
    return err, out


# -- K4's work split ----------------------------------------------------------

class QuadPlan(NamedTuple):
    """K4's grid (``quad_sweep_plan``): ``tpg`` blocks of ``threads`` ×
    ``targets`` targets per group, and each group's columns cut into
    ``chunks`` chunks of ``chunk`` columns (a multiple of ``split.RUN``).
    Block (group, target block, chunk k) sums columns [k·chunk,
    (k+1)·chunk) up to the group's bound; a chunk that starts at or past
    the bound is skipped, and the fold adds the others in chunk order."""
    threads: int
    targets: int
    tpg: int
    chunk: int
    chunks: int


def quad_sweep_plan(g: int, s: int, c: int, threads: int, targets: int,
                    resident_blocks: int) -> QuadPlan:
    """K4's grid for G groups of S targets and C columns:
    ``split.chunk_plan`` over the G × ``tpg`` target blocks, with G × S ×
    16 bytes of slots per chunk, bounded. It depends on the shape alone,
    not on the per-group bounds, so the bounded sweep's chunks are the full
    sweep's."""
    if min(g, s, threads, targets) <= 0 or c < 0:
        raise ValueError(f"quad_sweep_plan: bad shape G={g} S={s} C={c}, "
                         f"{threads}x{targets} per block")
    tpg = -(-s // (threads * targets))
    plan = split.chunk_plan(g * tpg, -(-c // split.RUN), resident_blocks,
                            16 * g * s, bounded=True)
    return QuadPlan(threads, targets, tpg, *plan)


def quad_launch_shape(s: int, device: torch.device,
                      mode: int) -> split.LaunchShape:
    """K4's block for S targets per group in rcp mode ``mode`` on a CUDA
    ``device``, read from the built kernel (``split.launch_shape``)."""
    return split.launch_shape(_load_sweep_lib().quad_sweep_shape, device, s,
                              mode)


def quad_launch_plan(g: int, s: int, c: int, device: torch.device,
                     mode: int) -> QuadPlan:
    """``quad_sweep_plan`` for K4 in rcp mode ``mode`` on a CUDA
    ``device``."""
    shape = quad_launch_shape(s, device, mode)
    return quad_sweep_plan(g, s, c, shape.threads, shape.targets,
                           shape.resident_blocks)


def _stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quad_sweep_chunked(lib, tgt, src_x, src_y, src_m, src_q, col_limit,
                       softening2: float, mode: int, chunk: int):
    """Launch K4 and its fold from ``lib`` with columns cut into chunks of
    ``chunk``, on inputs ``grouped_sweep`` has checked; returns the CUDA
    error and the output. The slots are allocated here, uninitialised: the
    kernel writes every slot the fold reads."""
    g, s, _ = tgt.shape
    c = src_x.shape[1]
    out = torch.empty_like(tgt)
    slots = torch.empty((-(-c // chunk), g, s, 2), dtype=torch.float64,
                        device=tgt.device)
    err = lib.quad_sweep_launch(
        tgt.data_ptr(), src_x.data_ptr(), src_y.data_ptr(), src_m.data_ptr(),
        *(q.data_ptr() for q in src_q),
        None if col_limit is None else col_limit.data_ptr(),
        slots.data_ptr() if slots.numel() else None, out.data_ptr(), g, s, c,
        chunk, float(softening2), mode, tgt.device.index or 0,
        _stream_of(tgt))
    return err, out


def grouped_sweep(tgt: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor,
                  src_m: torch.Tensor, softening2: float = 1e-3,
                  rcp: str = "approx",
                  col_limit: torch.Tensor | None = None,
                  src_q=None) -> torch.Tensor:
    """Launch the CUDA sweep kernel (``csrc/grouped_sweep.cu``): K3 on the
    grid of ``mono_launch_plan``, or K4 and its fold when ``src_q`` = (qxx,
    qxy, qyy) is given (its law ignores a "+clamp" suffix, as the JAX
    package's does), on the grid of ``quad_launch_plan``.

    CUDA tensors only: tgt f32 (G, S, 2), src_x/src_y/src_m (and src_q) f32
    (G, C), col_limit int32 (G,) or None, all contiguous on one device.
    Anything else raises; there is no fallback. ``grouped_sweep.launches``
    counts the monopole launches, ``grouped_sweep.quad_launches`` the
    quadrupole ones.
    """
    mode = check_rcp(rcp)
    if tgt.device.type != "cuda":
        raise ValueError(f"grouped_sweep needs CUDA tensors, got {tgt.device}")
    if tgt.ndim != 3 or tgt.shape[2] != 2:
        raise ValueError(f"tgt must be (G, S, 2), got {tuple(tgt.shape)}")
    g, s, _ = tgt.shape
    if src_q is not None and len(src_q) != 3:
        raise ValueError(f"src_q must be (qxx, qxy, qyy), got {len(src_q)}")
    srcs = (src_x, src_y, src_m) + tuple(src_q or ())
    c = src_x.shape[1] if src_x.ndim == 2 else -1
    tensors = (tgt,) + srcs
    for t in srcs:
        if t.shape != (g, c):
            raise ValueError(f"sources must all be (G, C) = ({g}, C), got "
                             f"{[tuple(a.shape) for a in srcs]}")
    if col_limit is not None:
        if col_limit.shape != (g,) or col_limit.dtype != torch.int32:
            raise ValueError("col_limit must be int32 (G,), got "
                             f"{col_limit.dtype} {tuple(col_limit.shape)}")
        tensors = tensors + (col_limit,)
    for t in tensors:
        if t.device != tgt.device:
            raise ValueError(f"all tensors must be on {tgt.device}, "
                             f"one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("grouped_sweep needs contiguous tensors")
    for t in (tgt,) + srcs:
        if t.dtype != torch.float32:
            raise ValueError(f"grouped_sweep needs float32, got {t.dtype}")
    if max(g, s, c) >= 2**31 or g * s * 2 >= 2**31 or g * c >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: {g, s, c}")
    if src_q is None and g * s == 0:
        return torch.empty_like(tgt)  # no target: nothing to launch
    lib = _load_sweep_lib()
    if src_q is None:
        plan = mono_launch_plan(g, s, c, tgt.device, mode)
        err, out = mono_sweep(lib, tgt, src_x, src_y, src_m, col_limit,
                              softening2, mode, plan.lanes)
    else:
        plan = quad_launch_plan(g, s, c, tgt.device, mode)
        err, out = quad_sweep_chunked(lib, tgt, src_x, src_y, src_m, src_q,
                                      col_limit, softening2, mode,
                                      plan.chunk)
    if err != 0:
        raise RuntimeError(f"grouped_sweep kernel launch failed: CUDA error "
                           f"{err} at G={g}, S={s}, C={c}, rcp={rcp}, "
                           f"quad={src_q is not None}")
    if src_q is None:
        grouped_sweep.launches += 1
    else:
        grouped_sweep.quad_launches += 1
    return out


grouped_sweep.launches = 0
grouped_sweep.quad_launches = 0


def grouped_force(tgt: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor,
                  src_m: torch.Tensor, softening2: float = 1e-3,
                  rcp: str = "approx",
                  col_limit: torch.Tensor | None = None,
                  src_q=None) -> torch.Tensor:
    """Targets (G, S, 2) vs per-group sources (G, C) → accel (G, S, 2),
    with the quadrupole correction when ``src_q`` is given.

    CUDA tensors launch the kernel (``grouped_sweep``); CPU tensors run the
    plain version (``grouped_force_ref``, always ``exact``).
    """
    check_rcp(rcp)
    if tgt.device.type == "cuda":
        return grouped_sweep(tgt, src_x, src_y, src_m, softening2, rcp,
                             col_limit, src_q)
    if tgt.device.type == "cpu":
        return grouped_force_ref(tgt, src_x, src_y, src_m, softening2, rcp,
                                 col_limit, src_q)
    raise ValueError(f"no sweep for device {tgt.device}")


def last_nonzero_columns(src_m: torch.Tensor, src_q=None) -> torch.Tensor:
    """int32 (G,): one past each group's last column with a nonzero mass,
    or a nonzero second moment when ``src_q`` is given (0 when the group has
    none). A quadrupole column with m = 0 still acts through Q: a node of
    fractional masses sums to an int32 mass of 0 but not to Q = 0."""
    g, c = src_m.shape
    if c == 0:
        return torch.zeros(g, dtype=torch.int32, device=src_m.device)
    live = src_m != 0
    for q in src_q or ():
        live = live | (q != 0)
    cols1 = torch.arange(1, c + 1, dtype=torch.int32, device=src_m.device)
    return torch.where(live, cols1,
                       torch.zeros((), dtype=torch.int32,
                                   device=src_m.device)).amax(dim=1)


def sweep_inputs(tree: FlatTree, theta: float, frontier_cap: int,
                 leaf_cap: int, arity: int = 2, plan_leaves: int = 1,
                 multipole: int = 1):
    """What ``bh_accel_sorted`` sweeps: ``(tgt, (src_x, src_y, src_m),
    src_q, col_limit)`` with targets (G, S, 2), source columns (G, C), the
    second moments (qxx, qxy, qyy) or None, and the per-group column
    bound."""
    n_leaves, S, _ = tree.leaf_pos.shape
    pl_ = max(1, min(plan_leaves, n_leaves))
    while n_leaves % pl_:
        pl_ //= 2
    planned = bh_plan_sources(tree, theta, frontier_cap, leaf_cap,
                              arity=arity, plan_leaves=pl_,
                              multipole=multipole)
    src_q = planned[3:] or None
    tgt = tree.leaf_pos.reshape(n_leaves // pl_, pl_ * S, 2)
    return (tgt, planned[:3], src_q,
            last_nonzero_columns(planned[2], src_q))


def bh_accel_sorted(tree: FlatTree, theta: float = 50.0,
                    softening2: float = 1e-3, frontier_cap: int = 32,
                    leaf_cap: int = 16, arity: int = 2, plan_leaves: int = 1,
                    multipole: int = 1, rcp: str | None = None) -> torch.Tensor:
    """Accelerations for all (sorted, padded) particles of the tree, as
    f32[n_leaves*leaf_size, 2] in sorted order. ``rcp=None`` resolves from θ
    like ``SimConfig.resolved_rcp``.

    Each group is swept only up to its last column with a nonzero mass (or
    second moment), which is what the JAX package's occupancy-bucketed
    sweep buys with static-width calls: a GPU block loops to its own
    group's bound. The columns past it have m = 0 and Q = 0 and add exactly
    ±0 wherever the law is finite, so the result is bitwise the full
    sweep's (tests/test_torch_traversal.py, tests/test_torch_quad.py,
    chip_smoke.py). ``multipole=2`` needs a tree built with ``quad``."""
    if rcp is None:
        rcp = "approx" if theta >= 2.0 else "newton"
    tgt, (src_x, src_y, src_m), src_q, col_limit = sweep_inputs(
        tree, theta, frontier_cap, leaf_cap, arity=arity,
        plan_leaves=plan_leaves, multipole=multipole)
    acc = grouped_force(tgt, src_x, src_y, src_m, softening2, rcp,
                        col_limit=col_limit, src_q=src_q)
    return acc.reshape(-1, 2)


def bh_accel(pos: torch.Tensor, mass: torch.Tensor, *, theta: float = 50.0,
             softening2: float = 1e-3, leaf_size: int = 64,
             world_size: float = 100_000.0, unweighted_leaf_com: bool = True,
             frontier_cap: int | None = None, leaf_cap: int | None = None,
             arity: int = 2, plan_leaves: int = 1,
             morton_bits: int | None = None, multipole: int | None = None,
             rcp: str | None = None) -> torch.Tensor:
    """Full Barnes-Hut acceleration: sort + build + plan + sweep + unsort.
    Returns accelerations in the original particle order. ``None`` knobs
    resolve from θ like ``SimConfig``."""
    n = pos.shape[0]
    if morton_bits is None:
        morton_bits = 15 if theta >= 2.0 else 24
    if multipole is None:
        multipole = 1 if theta >= 2.0 else 2
    pl_ = max(1, plan_leaves)
    if frontier_cap is None:
        frontier_cap = 16 if theta >= 2.0 else 256
    if leaf_cap is None:
        leaf_cap = max(8, 4 * pl_) if theta >= 2.0 else max(256, 32 * pl_)
    tree, order = build_tree(pos, mass, leaf_size=leaf_size,
                             world_size=world_size,
                             unweighted_leaf_com=unweighted_leaf_com,
                             morton_bits=morton_bits, quad=multipole == 2)
    acc_sorted = bh_accel_sorted(tree, theta=theta, softening2=softening2,
                                 frontier_cap=frontier_cap, leaf_cap=leaf_cap,
                                 arity=arity, plan_leaves=plan_leaves,
                                 multipole=multipole, rcp=rcp)
    out = torch.zeros((n, 2), dtype=torch.float32, device=pos.device)
    out[order] = acc_sorted[:n]
    return out


def bh_accel_fn(config):
    """World adapter: (pos, mass) -> accel from a SimConfig."""
    fcap, lcap = config.resolved_caps()
    return functools.partial(
        bh_accel, theta=config.theta, softening2=config.softening2,
        leaf_size=config.leaf_size, world_size=config.world_size,
        unweighted_leaf_com=config.unweighted_leaf_com,
        frontier_cap=fcap, leaf_cap=lcap,
        arity=config.tree_arity, plan_leaves=config.plan_leaves,
        morton_bits=config.resolved_morton_bits(),
        multipole=config.resolved_multipole(),
        rcp=config.resolved_rcp(bh=True))
