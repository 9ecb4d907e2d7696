"""Differentiable grouped force sweep, and with it differentiable
Barnes-Hut.

The port of ``nbody_simulation_tpu/ops/traversal_grad.py``. The rest of
the Barnes-Hut pipeline is plain torch and differentiates by autograd: the
Morton permutation is a gather, the tree summaries are reductions, and the
planner's decisions are integer and boolean. Only the sweep needs its own
backward: the closed-form Jᵀḡ of ``ops/allpairs_grad.py`` in the per-group
layout,

    t̄gt[g,s]      = −Σ_c u[g,s,c]
    s̄rc_x/y[g,c]  = +Σ_s u[g,s,c]
    s̄rc_m[g,c]    =  Σ_s r·(d·ḡ)

which on a CUDA tensor runs K8's two kernels (``csrc/force_grad.cu``,
``grouped_bwd_tgt_cuda``, ``grouped_bwd_src_cuda``) and on a CPU tensor
the plain version ``grouped_force_bwd_ref``.

``bh_accel_diff`` is the user-facing entry: the physics of
``ops.traversal.bh_accel`` with ``multipole=1`` and 15-bit Morton keys.
Position gradients flow through the leaf interactions and through the
accepted node COMs; mass gradients through the leaf tiles only, since node
masses are int32 sums.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from nbody_simulation_tpu_torch.ops.allpairs import check_cuda_inputs
from nbody_simulation_tpu_torch.ops.allpairs_grad import (_grad_terms,
                                                          _load_lib, _stream)
from nbody_simulation_tpu_torch.ops.traversal import (_REF_CHUNK_ELEMS,
                                                      bh_plan_sources,
                                                      grouped_force,
                                                      last_nonzero_columns)
from nbody_simulation_tpu_torch.ops.tree import build_tree


def _group_chunks(tgt, src_x):
    g, s, _ = tgt.shape
    gc = max(1, _REF_CHUNK_ELEMS // max(1, s * src_x.shape[1]))
    return [slice(g0, g0 + gc) for g0 in range(0, g, gc)]


def _group_terms(sl, tgt, gbar, src_x, src_y, src_m, softening2):
    """(ux, uy, r·t) of (gc, S, C) for the groups of ``sl``."""
    return _grad_terms(tgt[sl, :, 0:1], tgt[sl, :, 1:2], gbar[sl, :, 0:1],
                       gbar[sl, :, 1:2], src_x[sl, None, :],
                       src_y[sl, None, :], src_m[sl, None, :], softening2)


def grouped_bwd_tgt_ref(tgt, gbar, src_x, src_y, src_m,
                        softening2: float = 1e-3) -> torch.Tensor:
    """K8a's plain version: t̄gt = −Σ_c u, f32 (G, S, 2), over all C
    columns. Groups go in chunks of about ``_REF_CHUNK_ELEMS`` pairs."""
    out = torch.empty_like(tgt)
    for sl in _group_chunks(tgt, src_x):
        ux, uy, _ = _group_terms(sl, tgt, gbar, src_x, src_y, src_m,
                                 softening2)
        out[sl, :, 0] = -ux.sum(dim=-1)
        out[sl, :, 1] = -uy.sum(dim=-1)
    return out


def grouped_bwd_src_ref(tgt, gbar, src_x, src_y, src_m,
                        softening2: float = 1e-3):
    """K8b's plain version: (s̄rc_x, s̄rc_y, s̄rc_m), each f32 (G, C)."""
    outs = [torch.empty_like(src_x) for _ in range(3)]
    for sl in _group_chunks(tgt, src_x):
        terms = _group_terms(sl, tgt, gbar, src_x, src_y, src_m, softening2)
        for out, term in zip(outs, terms):
            out[sl] = term.sum(dim=1)
    return tuple(outs)


def grouped_force_bwd_ref(tgt, gbar, src_x, src_y, src_m,
                          softening2: float = 1e-3):
    """The sweep's backward, plain: (t̄gt (G,S,2), s̄rc_x, s̄rc_y, s̄rc_m
    (G,C)), always with exact division."""
    return (grouped_bwd_tgt_ref(tgt, gbar, src_x, src_y, src_m, softening2),
            *grouped_bwd_src_ref(tgt, gbar, src_x, src_y, src_m, softening2))


# -- the CUDA kernels ---------------------------------------------------------

def _check_k8(name, tgt, gbar, src_x, src_y, src_m):
    if tgt.ndim != 3 or tgt.shape[2] != 2:
        raise ValueError(f"tgt must be (G, S, 2), got {tuple(tgt.shape)}")
    g, s, _ = tgt.shape
    c = src_x.shape[1] if src_x.ndim == 2 else -1
    check_cuda_inputs(name, [(tgt, (g, s, 2)), (gbar, (g, s, 2)),
                             (src_x, (g, c)), (src_y, (g, c)),
                             (src_m, (g, c))])
    return g, s, c


def grouped_bwd_tgt_cuda(tgt, gbar, src_x, src_y, src_m,
                         softening2: float = 1e-3) -> torch.Tensor:
    """Launch K8a (``csrc/force_grad.cu``): t̄gt f32 (G, S, 2) for targets
    (G, S, 2) with cotangents (G, S, 2) against source columns (G, C), all
    contiguous f32 on one CUDA device; anything else raises.
    ``grouped_bwd_tgt_cuda.launches`` counts the launches."""
    g, s, c = _check_k8("grouped_bwd_tgt_cuda", tgt, gbar, src_x, src_y,
                        src_m)
    out = torch.empty_like(tgt)
    err = _load_lib().grouped_bwd_tgt_launch(
        tgt.data_ptr(), gbar.data_ptr(), src_x.data_ptr(), src_y.data_ptr(),
        src_m.data_ptr(), out.data_ptr(), g, s, c, float(softening2),
        *_stream(tgt))
    if err != 0:
        raise RuntimeError(f"grouped_bwd_tgt kernel launch failed: CUDA "
                           f"error {err} at G={g}, S={s}, C={c}")
    grouped_bwd_tgt_cuda.launches += 1
    return out


grouped_bwd_tgt_cuda.launches = 0


def grouped_bwd_src_cuda(tgt, gbar, src_x, src_y, src_m,
                         softening2: float = 1e-3):
    """Launch K8b (``csrc/force_grad.cu``): (s̄rc_x, s̄rc_y, s̄rc_m), each
    f32 (G, C), on K8a's inputs; anything else raises.
    ``grouped_bwd_src_cuda.launches`` counts the launches."""
    g, s, c = _check_k8("grouped_bwd_src_cuda", tgt, gbar, src_x, src_y,
                        src_m)
    outs = [torch.empty_like(src_x) for _ in range(3)]
    err = _load_lib().grouped_bwd_src_launch(
        tgt.data_ptr(), gbar.data_ptr(), src_x.data_ptr(), src_y.data_ptr(),
        src_m.data_ptr(), *(o.data_ptr() for o in outs), g, s, c,
        float(softening2), *_stream(tgt))
    if err != 0:
        raise RuntimeError(f"grouped_bwd_src kernel launch failed: CUDA "
                           f"error {err} at G={g}, S={s}, C={c}")
    grouped_bwd_src_cuda.launches += 1
    return tuple(outs)


grouped_bwd_src_cuda.launches = 0


# -- the entry points ---------------------------------------------------------

def grouped_force_bwd(tgt, gbar, src_x, src_y, src_m,
                      softening2: float = 1e-3):
    """(t̄gt, s̄rc_x, s̄rc_y, s̄rc_m) over all C columns: K8's two kernels
    on CUDA tensors, the plain version on CPU tensors."""
    if tgt.device.type == "cuda":
        return (grouped_bwd_tgt_cuda(tgt, gbar, src_x, src_y, src_m,
                                     softening2),
                *grouped_bwd_src_cuda(tgt, gbar, src_x, src_y, src_m,
                                      softening2))
    if tgt.device.type == "cpu":
        return grouped_force_bwd_ref(tgt, gbar, src_x, src_y, src_m,
                                     softening2)
    raise ValueError(f"no sweep backward for device {tgt.device}")


class _GroupedForceDiff(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tgt, src_x, src_y, src_m, softening2, rcp):
        ctx.save_for_backward(tgt, src_x, src_y, src_m)
        ctx.softening2 = softening2
        return grouped_force(tgt, src_x, src_y, src_m, softening2, rcp,
                             col_limit=last_nonzero_columns(src_m))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        tgt, src_x, src_y, src_m = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        return (*grouped_force_bwd(tgt, g, src_x, src_y, src_m,
                                   ctx.softening2), None, None)


def grouped_force_diff(tgt: torch.Tensor, src_x: torch.Tensor,
                       src_y: torch.Tensor, src_m: torch.Tensor,
                       softening2: float = 1e-3,
                       rcp: str = "newton") -> torch.Tensor:
    """Differentiable monopole sweep: targets (G, S, 2) against per-group
    columns (G, C) → accel (G, S, 2).

    The forward is the run mode's sweep (``grouped_force``, K3 on CUDA) with
    the caller's ``rcp`` and each group bounded at its last nonzero-mass
    column, bitwise the full sweep. The backward (K8) runs over all C
    columns with its own Newton-refined reciprocal: ``rcp`` selects forward
    arithmetic, not the function."""
    return _GroupedForceDiff.apply(tgt, src_x, src_y, src_m, softening2, rcp)


def bh_accel_diff(pos: torch.Tensor, mass: torch.Tensor, *,
                  theta: float = 50.0, softening2: float = 1e-3,
                  leaf_size: int = 64, world_size: float = 100_000.0,
                  unweighted_leaf_com: bool = True, frontier_cap: int = 32,
                  leaf_cap: int = 16, arity: int = 2, plan_leaves: int = 1,
                  rcp: str = "newton") -> torch.Tensor:
    """Differentiable Barnes-Hut acceleration f32 (N, 2), in the original
    particle order.

    The walk of ``ops.traversal.bh_accel`` with 15-bit Morton keys and
    ``multipole=1`` (the JAX defaults of ``bh_accel_diff``); pass the run
    configuration's ``rcp`` for a forward bitwise equal to ``bh_accel``'s
    under that mode."""
    n = pos.shape[0]
    tree, order = build_tree(pos, mass, leaf_size=leaf_size,
                             world_size=world_size,
                             unweighted_leaf_com=unweighted_leaf_com,
                             morton_bits=15)
    n_leaves, S, _ = tree.leaf_pos.shape
    pl_ = max(1, min(plan_leaves, n_leaves))
    while n_leaves % pl_:
        pl_ //= 2
    src_x, src_y, src_m = bh_plan_sources(tree, theta, frontier_cap,
                                          leaf_cap, arity=arity,
                                          plan_leaves=pl_)
    tgt = tree.leaf_pos.reshape(n_leaves // pl_, pl_ * S, 2)
    acc = grouped_force_diff(tgt, src_x, src_y, src_m, softening2, rcp)
    out = torch.zeros((n, 2), dtype=torch.float32, device=pos.device)
    out[order] = acc.reshape(n_leaves * S, 2)[:n]
    return out
