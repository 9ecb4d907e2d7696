"""Differentiable all-pairs force: a ``torch.autograd.Function`` whose
backward is the two hand-written sweeps of K7.

The port of ``nbody_simulation_tpu/ops/allpairs_grad.py``. Per unmasked
pair, with d = p_j − p_i, s = ‖d‖₁, q = max(‖d‖₂², ε), r = 1/(s·q), the
force contribution is c = m·d·r (reference src/main.rs:234-253). For a
cotangent ḡ_i of a_i = Σ_j c_ij:

    ∂r/∂d = −r²·(psign(d)·q + 2·s·d·κ),   κ = [‖d‖₂² > ε]
    u_ij  = m·( r·ḡ_i + (∂r/∂d)·(d·ḡ_i) )        (= Jᵀḡ, J = ∂c/∂d)
    p̄_j  += u_ij,   p̄_i −= Σ_j u_ij,   m̄_j += r·(d·ḡ_i)

The backward is this closed form and not torch autograd of the plain
forward, because the two differ where the law has kinks: the JAX
convention ``psign(0) = +1`` (the subgradient of ``lax.abs``) where torch's
``abs`` backward gives 0, and a strict κ where torch's ``clamp_min``
backward treats the tie ‖d‖₂² = ε the other way. On a lattice (the
galaxy's annulus sits on one) many pairs have dx = 0 or dy = 0.

A CUDA tensor runs the kernels of ``csrc/force_grad.cu`` (``bwd_i_cuda``,
``bwd_j_cuda``), whose reciprocal is ``rcp.approx`` plus one Newton step
whatever the forward's ``rcp``, as the JAX backward runs on its chip; a CPU
tensor runs the plain version ``bwd_sweeps_ref``, with exact division as
the JAX interpret path computes it; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from nbody_simulation_tpu_torch.ops.allpairs import (_CHUNK_ELEMS,
                                                     allpairs_accel,
                                                     allpairs_accel_sym,
                                                     check_cuda_inputs)
from nbody_simulation_tpu_torch.ops.force import FLT_MAX, FLT_MIN_NORMAL


def pair_terms(dx: torch.Tensor, dy: torch.Tensor, softening2: float):
    """``(s, q, r, kappa)`` of the JAX ``_pair_terms`` with ``exact_rcp``:
    r = 1/where(normal, s·q, 1), then 0 where the pair is masked."""
    s = dx.abs() + dy.abs()
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    d2 = dx * dx + dy * dy
    kappa = (d2 > softening2).to(dx.dtype)
    q = torch.clamp_min(d2, softening2)
    den = s * q
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    r = torch.reciprocal(torch.where(normal, den, one))
    r = torch.where(normal, r, torch.zeros_like(one))
    return s, q, r, kappa


def psign(x: torch.Tensor) -> torch.Tensor:
    """+1 where x >= 0 (x == 0 included), else −1: the JAX subgradient of
    |x|, unlike ``sign(0) = 0``."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


def u_terms(dx, dy, gx, gy, m, s, q, r, kappa):
    """``(ux, uy, t)``: u = m·(r·ḡ + ∂r/∂d·(d·ḡ)) and t = d·ḡ, in the JAX
    ``_u_terms`` operation order."""
    t = dx * gx + dy * gy
    mr2t = m * (r * r) * t
    two_sk = 2.0 * s * kappa
    ux = m * r * gx - mr2t * (psign(dx) * q + two_sk * dx)
    uy = m * r * gy - mr2t * (psign(dy) * q + two_sk * dy)
    return ux, uy, t


def _grad_terms(xi, yi, gx, gy, xj, yj, mj, softening2):
    dx = xj - xi
    dy = yj - yi
    s, q, r, kappa = pair_terms(dx, dy, softening2)
    ux, uy, t = u_terms(dx, dy, gx, gy, mj, s, q, r, kappa)
    return ux, uy, r * t


def bwd_i_ref(pos_i, g_i, pos_j, mass_j, softening2: float) -> torch.Tensor:
    """K7a's plain version: p̄_i = −Σ_j u, f32 (Ni, 2). Targets go in chunks
    of about ``_CHUNK_ELEMS`` pairs, as ``ops.allpairs.pair_sums`` does."""
    nj = pos_j.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(1, nj))
    xj, yj, mj = pos_j[None, :, 0], pos_j[None, :, 1], mass_j[None, :]
    out = torch.empty_like(pos_i)
    for i0 in range(0, pos_i.shape[0], rows):
        sl = slice(i0, i0 + rows)
        ux, uy, _ = _grad_terms(pos_i[sl, 0:1], pos_i[sl, 1:2],
                                g_i[sl, 0:1], g_i[sl, 1:2], xj, yj, mj,
                                softening2)
        out[sl, 0] = -ux.sum(dim=1)
        out[sl, 1] = -uy.sum(dim=1)
    return out


def bwd_j_ref(pos_i, g_i, pos_j, mass_j, softening2: float):
    """K7b's plain version: (p̄_j = Σ_i u f32 (Nj, 2), m̄_j = Σ_i r·t f32
    (Nj,)). Sources go in chunks of about ``_CHUNK_ELEMS`` pairs."""
    ni = pos_i.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(1, ni))
    xi, yi = pos_i[None, :, 0], pos_i[None, :, 1]
    gx, gy = g_i[None, :, 0], g_i[None, :, 1]
    pbar = torch.empty_like(pos_j)
    mbar = torch.empty_like(mass_j)
    for j0 in range(0, pos_j.shape[0], rows):
        sl = slice(j0, j0 + rows)
        ux, uy, rt = _grad_terms(xi, yi, gx, gy, pos_j[sl, 0:1],
                                 pos_j[sl, 1:2], mass_j[sl, None], softening2)
        pbar[sl, 0] = ux.sum(dim=1)
        pbar[sl, 1] = uy.sum(dim=1)
        mbar[sl] = rt.sum(dim=1)
    return pbar, mbar


def bwd_sweeps_ref(pos_i, g_i, pos_j, mass_j, softening2: float):
    """The two backward sweeps' plain version: (p̄_i (Ni,2), p̄_j (Nj,2),
    m̄_j (Nj,)), always with exact division."""
    return (bwd_i_ref(pos_i, g_i, pos_j, mass_j, softening2),
            *bwd_j_ref(pos_i, g_i, pos_j, mass_j, softening2))


# -- the CUDA kernels ---------------------------------------------------------

_lib = None


def _load_lib():
    """Build (at first use) and load ``csrc/force_grad.cu``: K7 and K8."""
    global _lib
    if _lib is None:
        from nbody_simulation_tpu_torch.cuda_build import load_cuda_library
        lib = load_cuda_library("force_grad")
        tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for name, ptrs, ints in (("allpairs_bwd_i_launch", 5, 2),
                                 ("allpairs_bwd_j_launch", 6, 2),
                                 ("grouped_bwd_tgt_launch", 6, 3),
                                 ("grouped_bwd_src_launch", 8, 3)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                           + tail)
        _lib = lib
    return _lib


def _stream(t: torch.Tensor):
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def _check_k7(name, pos_i, g_i, pos_j, mass_j):
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    check_cuda_inputs(name, [(pos_i, (ni, 2)), (g_i, (ni, 2)),
                             (pos_j, (nj, 2)), (mass_j, (nj,))])
    return ni, nj


def bwd_i_cuda(pos_i, g_i, pos_j, mass_j,
               softening2: float = 1e-3) -> torch.Tensor:
    """Launch K7a (``csrc/force_grad.cu``): p̄_i f32 (Ni, 2) for targets
    ``pos_i`` with cotangents ``g_i`` against sources ``pos_j``, ``mass_j``,
    all contiguous f32 on one CUDA device; anything else raises.
    ``bwd_i_cuda.launches`` counts the launches."""
    ni, nj = _check_k7("bwd_i_cuda", pos_i, g_i, pos_j, mass_j)
    out = torch.empty_like(pos_i)
    err = _load_lib().allpairs_bwd_i_launch(
        pos_i.data_ptr(), g_i.data_ptr(), pos_j.data_ptr(), mass_j.data_ptr(),
        out.data_ptr(), ni, nj, float(softening2), *_stream(pos_i))
    if err != 0:
        raise RuntimeError(f"allpairs_bwd_i kernel launch failed: CUDA error "
                           f"{err} at Ni={ni}, Nj={nj}")
    bwd_i_cuda.launches += 1
    return out


bwd_i_cuda.launches = 0


def bwd_j_cuda(pos_i, g_i, pos_j, mass_j, softening2: float = 1e-3):
    """Launch K7b (``csrc/force_grad.cu``): (p̄_j f32 (Nj, 2), m̄_j f32
    (Nj,)) on K7a's inputs; anything else raises. ``bwd_j_cuda.launches``
    counts the launches."""
    ni, nj = _check_k7("bwd_j_cuda", pos_i, g_i, pos_j, mass_j)
    pbar = torch.empty_like(pos_j)
    mbar = torch.empty_like(mass_j)
    err = _load_lib().allpairs_bwd_j_launch(
        pos_i.data_ptr(), g_i.data_ptr(), pos_j.data_ptr(), mass_j.data_ptr(),
        pbar.data_ptr(), mbar.data_ptr(), ni, nj, float(softening2),
        *_stream(pos_i))
    if err != 0:
        raise RuntimeError(f"allpairs_bwd_j kernel launch failed: CUDA error "
                           f"{err} at Ni={ni}, Nj={nj}")
    bwd_j_cuda.launches += 1
    return pbar, mbar


bwd_j_cuda.launches = 0


# -- the entry points ---------------------------------------------------------

def bwd_sweeps(pos_i: torch.Tensor, g_i: torch.Tensor, pos_j: torch.Tensor,
               mass_j: torch.Tensor, softening2: float, tile_i: int,
               tile_j: int):
    """The two backward sweeps for one (targets i, sources j) block.

    Returns (p̄_i (Ni,2), p̄_j (Nj,2), m̄_j (Nj,)): the cotangent shares of
    this block's pairs in the target positions, the source positions and
    the source masses. ``pos_i`` and ``pos_j`` may be one array (the caller
    then adds both position parts) or different blocks (the ring backward).
    Ni and Nj must be multiples of the clipped tiles: the JAX grid
    ``Ni // tile_i`` would leave a ragged edge uncomputed, so the port
    raises there instead. The tiles do not shape the CUDA kernels."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    ti, tj = min(tile_i, ni), min(tile_j, nj)
    if ni % ti or nj % tj:
        raise ValueError(f"N=({ni},{nj}) not divisible by tiles ({ti},{tj})")
    if pos_i.device.type == "cuda":
        return (bwd_i_cuda(pos_i, g_i, pos_j, mass_j, softening2),
                *bwd_j_cuda(pos_i, g_i, pos_j, mass_j, softening2))
    if pos_i.device.type == "cpu":
        return bwd_sweeps_ref(pos_i, g_i, pos_j, mass_j, softening2)
    raise ValueError(f"no all-pairs backward for device {pos_i.device}")


class _AllpairsAccelDiff(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pos, mass, softening2, tile_i, tile_j, rcp, sym,
                sym_tile, sym_strips):
        ctx.save_for_backward(pos, mass)
        ctx.args = (softening2, tile_i, tile_j)
        if sym and pos.shape[0] % min(sym_tile, pos.shape[0]) == 0:
            return allpairs_accel_sym(pos, mass, softening2=softening2,
                                      tile=sym_tile, strips=sym_strips,
                                      rcp=rcp)
        return allpairs_accel(pos, mass, softening2=softening2,
                              tile_i=tile_i, tile_j=tile_j, rcp=rcp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pos, mass = ctx.saved_tensors
        softening2, tile_i, tile_j = ctx.args
        g = g.to(torch.float32).contiguous()
        pb_i, pb_j, mb = bwd_sweeps(pos, g, pos, mass, softening2, tile_i,
                                    tile_j)
        return pb_i + pb_j, mb, None, None, None, None, None, None, None


def allpairs_accel_diff(pos: torch.Tensor, mass: torch.Tensor,
                        softening2: float = 1e-3, tile_i: int = 512,
                        tile_j: int = 2048, rcp: str = "newton",
                        sym: bool = False, sym_tile: int = 1024,
                        sym_strips: int = 4) -> torch.Tensor:
    """Differentiable all-pairs acceleration f32 (N, 2).

    The forward is the run mode's kernel with the caller's ``rcp``: the
    symmetric kernel (K2) when ``sym`` and N is a multiple of
    ``min(sym_tile, N)``, else the ordered one (K1), so the grad-mode value
    is bitwise the run-mode value. The backward is the closed-form Jᵀḡ
    (``bwd_sweeps``): p̄ = p̄_i + p̄_j, m̄ = m̄_j. The reciprocal mode selects
    forward arithmetic, not the function, so the backward ignores it."""
    return _AllpairsAccelDiff.apply(pos, mass, softening2, tile_i, tile_j,
                                    rcp, sym, sym_tile, sym_strips)
