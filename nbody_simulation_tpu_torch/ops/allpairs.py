"""Exact all-pairs forces: the ordered sweep (K1), the symmetric
third-law sweep (K2) and its cross-block form (K9).

The port of ``nbody_simulation_tpu/ops/allpairs.py``. ``allpairs_accel``,
``allpairs_accel_sym`` and ``allpairs_accel_sym_pair`` keep the JAX
signatures, checks and errors; a CUDA tensor launches the hand-written
kernel of ``csrc/allpairs.cu`` (``allpairs_cuda``, ``allpairs_sym_cuda``,
``allpairs_sym_pair_cuda``), a CPU tensor runs the plain version, and any
other device raises. The plain versions always compute
``exact``, as the JAX package's CPU (interpret) path does; ``rcp`` is then
validated only.

The JAX tile arguments (``tile_i``, ``tile_j``, ``tile``, ``strips``) keep
their divisibility checks, so the same calls raise the same errors; they
size VMEM blocks on the TPU and do not shape the CUDA kernels, which take
any N.

K2 and K9 share one round kernel, which runs the tournament of tiles of
256 (``SYM_TILE``) by the table ``sym_schedule`` builds here: several
rounds per launch, each block writing f64 partial sums into slots that a
fold then adds in round order. ``sym_launch_plan`` sizes the launches from
the kernel's resident blocks on the card and caches the table there;
``tests/test_torch_allpairs.py`` checks the table on the CPU.

Non-finite positions. The symmetric law multiplies ``d · (m · k)`` after
the mask has set ``k`` to 0, and NaN·0 is NaN: one NaN x-coordinate makes
the x-component of every row NaN, while every y-component stays finite and
the NaN particle's own y is 0. The cross-block law (K9) does the same on
each side: one NaN x on the i side makes that row's x NaN and its y 0, and
the x of every j-side row NaN with every y finite. The ordered law in
``exact`` selects 0 for a masked pair instead, so every row stays finite and
the NaN particle's row is 0. All match the JAX package on the CPU
(tests/test_torch_allpairs.py, tests/test_torch_ring.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from nbody_simulation_tpu_torch.config import check_rcp
from nbody_simulation_tpu_torch.ops import split
from nbody_simulation_tpu_torch.ops.force import (FLT_MAX, FLT_MIN_NORMAL,
                                                  pair_accel)

# Pair terms per chunk of the plain sums: the (rows, Nj) temporaries stay
# near this many elements (the galaxy's full N² would be 92 GB each).
_CHUNK_ELEMS = 1 << 25

# Operations per pairwise interaction, the fp32 divide counted as one, as
# the JAX package counts them for its rates.
FLOPS_PER_PAIR = 22

# The floor of the L1 norm in the "+clamp" modes, which exist only in the
# kernels: ``csrc/pair_law.cuh`` kL1Clamp holds this value
# (tests/test_torch_port_basics.py reads it there). A representable pair
# separation is 0 or ≳ 1e-19, so the clamp is the identity on every
# normal pair, and the clamped denominator stays ≥ 1e-12·softening2, whose
# reciprocal times the largest reference mass is finite in f32.
L1_CLAMP = 1e-12


def mono_tile(dx: torch.Tensor, dy: torch.Tensor, mj: torch.Tensor,
              softening2: float = 1e-3, rcp: str = "exact"):
    """The ordered law's plain version: contributions ``(cx, cy)``.

    Always ``exact`` — ``pair_accel``, the reference law op for op — as the
    JAX package's CPU path computes it; ``rcp`` is validated only. The other
    modes exist only in the kernel (``csrc/pair_law.cuh``)."""
    check_rcp(rcp)
    return pair_accel(dx, dy, mj, softening2)


def sym_r(dx: torch.Tensor, dy: torch.Tensor,
          softening2: float = 1e-3) -> torch.Tensor:
    """The symmetric pair kernel k(d) = 1/(‖d‖₁·max(‖d‖₂², ε)) in ``exact``
    (``_sym_r``): ``1/den`` first and the mass products after, as the JAX
    package orders it (≤2 ulp from ``pair_accel``'s numerator-first
    order). Masked pairs give 0."""
    s = dx.abs() + dy.abs()
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    d2 = torch.clamp_min(dx * dx + dy * dy, softening2)
    one = torch.ones((), dtype=s.dtype, device=s.device)
    r = torch.reciprocal(torch.where(normal, s * d2, one))
    return torch.where(normal, r, torch.zeros_like(one))


def _sym_term(dx, dy, mj, softening2):
    w = mj * sym_r(dx, dy, softening2)
    return dx * w, dy * w


def pair_sums(tpos: torch.Tensor, spos: torch.Tensor, smass: torch.Tensor,
              term, softening2: float) -> torch.Tensor:
    """Σ_j term(p_j − p_i, m_j) per target: ``term(dx, dy, mj, softening2)``
    returns a tuple of K (rows, Nj) tensors; the result is (Ni, K). Targets
    are taken in chunks of about ``_CHUNK_ELEMS`` pair terms."""
    nj = spos.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(1, nj))
    x, y = spos[:, 0], spos[:, 1]
    parts = []
    for start in range(0, tpos.shape[0], rows):
        t = tpos[start:start + rows]
        terms = term(x[None, :] - t[:, 0:1], y[None, :] - t[:, 1:2],
                     smass[None, :], softening2)
        parts.append(torch.stack([c.sum(dim=1) for c in terms], dim=1))
    return torch.cat(parts)


def allpairs_accel_ref(pos: torch.Tensor, mass: torch.Tensor,
                       src_pos: torch.Tensor | None = None,
                       src_mass: torch.Tensor | None = None,
                       softening2: float = 1e-3) -> torch.Tensor:
    """K1's plain version: f32[Ni, 2] from sources (default: the targets),
    each pair by ``pair_accel``."""
    if src_pos is None:
        src_pos, src_mass = pos, mass
    return pair_sums(pos, src_pos, src_mass, mono_tile, softening2)


def allpairs_accel_sym_ref(pos: torch.Tensor, mass: torch.Tensor,
                           softening2: float = 1e-3) -> torch.Tensor:
    """K2's plain version: every ordered pair by the symmetric law,
    ``d · (m_j · k(d))``. From j's side the kernel subtracts
    ``d · (m_i · k(d))``, which is bitwise ``(−d) · (m_i · k(−d))``, so
    the ordered sum is the same function."""
    return pair_sums(pos, pos, mass, _sym_term, softening2)


def allpairs_accel_sym_pair_ref(pos_i: torch.Tensor, mass_i: torch.Tensor,
                                pos_j: torch.Tensor, mass_j: torch.Tensor,
                                softening2: float = 1e-3):
    """K9's plain version: ``(acc_i, acc_j)``, f32 (L, 2) each, every pair
    by the symmetric law. As in ``allpairs_accel_sym_ref``, the j side's
    ``−d · (m_i · k(d))`` is bitwise ``(−d) · (m_i · k(−d))``, so each side
    is the ordered sum of the symmetric term over the other side."""
    return (pair_sums(pos_i, pos_j, mass_j, _sym_term, softening2),
            pair_sums(pos_j, pos_i, mass_i, _sym_term, softening2))


# -- the CUDA kernels ---------------------------------------------------------

_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/allpairs.cu`` on ``lib``."""
    lib.allpairs_launch.restype = ctypes.c_int
    lib.allpairs_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.allpairs_sym_launch.restype = ctypes.c_int
    lib.allpairs_sym_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.allpairs_sym_pair_launch.restype = ctypes.c_int
    lib.allpairs_sym_pair_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.allpairs_sym_shape.restype = ctypes.c_int
    lib.allpairs_sym_shape.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.potential_launch.restype = ctypes.c_int
    lib.potential_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.potential_shape.restype = ctypes.c_int
    lib.potential_shape.argtypes = (
        [ctypes.c_float, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    return lib


def _load_lib():
    global _lib
    if _lib is None:
        from nbody_simulation_tpu_torch.cuda_build import load_cuda_library
        _lib = _bind(load_cuda_library("allpairs"))
    return _lib


# -- the symmetric kernels' schedule ------------------------------------------

SYM_TILE = 256            # csrc/allpairs.cu: kSymTile, particles per tile
SYM_WAVES = 16            # resident waves of blocks a launch aims at


class SymSchedule(NamedTuple):
    """The launches of one K2 or K9 call (``sym_schedule``).

    ``blocks`` int32 (B, 4): one row per block, (round, i tile, j tile,
    slot), launch after launch; ``fold`` uint8 (K, nt): for round k and tile
    t, bit 0 if a block of round k wrote tile t's i-side slot, bit 1 its
    j-side slot; ``launches`` int32 (L, 4): (first row of ``blocks``, blocks,
    first round, rounds)."""
    blocks: np.ndarray
    fold: np.ndarray
    launches: np.ndarray


def sym_rounds(nt: int, self_pairs: bool) -> list[int]:
    """Blocks in each round of the tournament over ``nt`` tiles. K2
    (``self_pairs``): rounds 0..nt//2, round 0 the diagonal, and for even nt
    round nt/2 only its first nt/2 blocks (its other half repeats them). K9:
    nt full rounds."""
    if not self_pairs:
        return [nt] * nt
    return [nt // 2 if nt % 2 == 0 and k == nt // 2 else nt
            for k in range(nt // 2 + 1)]


def sym_schedule(nt: int, rounds_per_launch: int,
                 self_pairs: bool) -> SymSchedule:
    """The schedule the symmetric round kernel runs, ``rounds_per_launch``
    consecutive rounds per launch. Block b of round k pairs i tile b with j
    tile (b + k) mod nt and writes slot k - (the launch's first round); in
    K2's round 0 the block has no j side. The fold after each launch adds
    its slots into the accumulators in round order."""
    per_round = np.array(sym_rounds(nt, self_pairs), dtype=np.int64)
    starts = np.cumsum(per_round) - per_round
    k = np.repeat(np.arange(len(per_round)), per_round)
    b = np.arange(len(k)) - starts[k]
    k0 = k // rounds_per_launch * rounds_per_launch
    blocks = np.stack([k, b, (b + k) % nt, k - k0], axis=1).astype(np.int32)
    firsts = starts[::rounds_per_launch]
    first_rounds = np.arange(0, len(per_round), rounds_per_launch)
    launches = np.stack([
        firsts, np.diff(np.append(firsts, len(k))), first_rounds,
        np.diff(np.append(first_rounds, len(per_round)))],
        axis=1).astype(np.int32)
    fold = np.zeros((len(per_round), nt), dtype=np.uint8)
    fold[blocks[:, 0], blocks[:, 1]] |= 1
    side_j = blocks[:, 0] != 0 if self_pairs else np.ones(len(blocks), bool)
    fold[blocks[side_j, 0], blocks[side_j, 2]] |= 2
    return SymSchedule(blocks, fold, launches)


def sym_rounds_per_launch(nt: int, self_pairs: bool,
                          resident_blocks: int) -> int:
    """Rounds per launch: enough that a launch holds ``SYM_WAVES`` waves of
    the card's ``resident_blocks``, at most ``split.SLOT_SCRATCH`` bytes of
    slots (2 sides × nt·256 particles × 16 bytes a round), then evened out
    over the launches that takes."""
    rounds = len(sym_rounds(nt, self_pairs))
    per_round = 2 * nt * SYM_TILE * 16
    r = min(rounds, -(-SYM_WAVES * resident_blocks // nt),
            max(1, split.SLOT_SCRATCH // per_round))
    return -(-rounds // -(-rounds // r))


class SymPlan(NamedTuple):
    """A K2 or K9 call's launches on one device (``sym_launch_plan``)."""
    nt: int
    rounds_per_launch: int
    blocks_per_sm: int       # resident blocks per SM, by the CUDA runtime
    threads_per_block: int
    schedule: SymSchedule
    sched: torch.Tensor      # schedule.blocks on the device
    fold: torch.Tensor       # schedule.fold on the device
    launch_rows: ctypes.Array


_plans: dict = {}


def sym_launch_plan(n: int, device: torch.device, rcp: str = "newton",
                    self_pairs: bool = True) -> SymPlan:
    """The launches of K2 (``self_pairs``) or K9 on N (or L) particles on a
    CUDA ``device`` in rcp mode ``rcp``: rounds per launch from the round
    kernel's resident blocks on the card (``split.launch_shape``), and the
    schedule's tables on the device. Built once per (device, tile count,
    mode, side)."""
    mode = check_rcp(rcp)
    device = torch.device(device)
    nt = -(-n // SYM_TILE)
    key = (device, nt, mode, self_pairs)
    if key not in _plans:
        shape = split.launch_shape(_load_lib().allpairs_sym_shape, device,
                                   int(self_pairs), mode)
        r = sym_rounds_per_launch(nt, self_pairs, shape.resident_blocks)
        sch = sym_schedule(nt, r, self_pairs)
        rows = sch.launches.reshape(-1)
        _plans[key] = SymPlan(
            nt, r, shape.blocks_per_sm, shape.threads, sch,
            torch.from_numpy(sch.blocks).to(device),
            torch.from_numpy(sch.fold).to(device),
            (ctypes.c_int * len(rows))(*rows.tolist()))
    return _plans[key]


def _sym_launch(pos_i, mass_i, pos_j, mass_j, out, n, softening2, rcp,
                self_pairs):
    """One K2 (``self_pairs``: pos_j, mass_j are ignored) or K9 call: its
    plan, the f64 accumulators and slots, the launches. Returns the CUDA
    error."""
    lib = _load_lib()
    fn = (lib.allpairs_sym_launch if self_pairs
          else lib.allpairs_sym_pair_launch)
    plan = sym_launch_plan(n, pos_i.device, rcp, self_pairs)
    acc = torch.zeros((2, n, 2), dtype=torch.float64, device=pos_i.device)
    slots = torch.empty((2, plan.rounds_per_launch, plan.nt * SYM_TILE, 2),
                        dtype=torch.float64, device=pos_i.device)
    sides = ((pos_i.data_ptr(), mass_i.data_ptr()) if self_pairs else
             (pos_i.data_ptr(), mass_i.data_ptr(), pos_j.data_ptr(),
              mass_j.data_ptr()))
    return fn(*sides, plan.sched.data_ptr(), plan.fold.data_ptr(),
              plan.launch_rows, len(plan.schedule.launches),
              slots.data_ptr(), plan.rounds_per_launch, acc.data_ptr(),
              out.data_ptr(), n, float(softening2), check_rcp(rcp),
              pos_i.device.index or 0,
              torch.cuda.current_stream(pos_i.device).cuda_stream)


def check_cuda_inputs(name: str, pairs) -> None:
    """Raise unless every ``(tensor, shape)`` is a contiguous f32 CUDA
    tensor of that shape on one device, with int32-indexable sizes."""
    dev = pairs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t, shape in pairs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, one is "
                             f"on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: shape {shape} too large for int32 "
                             "indexing")


def allpairs_cuda(pos: torch.Tensor, src_pos: torch.Tensor,
                  src_mass: torch.Tensor, softening2: float = 1e-3,
                  rcp: str = "newton") -> torch.Tensor:
    """Launch K1 (``csrc/allpairs.cu``): targets f32 (Ni, 2) against
    sources f32 (Nj, 2) with masses f32 (Nj,), all contiguous on one CUDA
    device. Anything else raises; there is no fallback.
    ``allpairs_cuda.launches`` counts the launches."""
    mode = check_rcp(rcp)
    ni, nj = pos.shape[0], src_pos.shape[0]
    check_cuda_inputs("allpairs_cuda", [(pos, (ni, 2)), (src_pos, (nj, 2)),
                                        (src_mass, (nj,))])
    out = torch.empty_like(pos)
    err = _load_lib().allpairs_launch(
        pos.data_ptr(), src_pos.data_ptr(), src_mass.data_ptr(),
        out.data_ptr(), ni, nj, float(softening2), mode,
        pos.device.index or 0,
        torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"allpairs kernel launch failed: CUDA error {err} "
                           f"at Ni={ni}, Nj={nj}, rcp={rcp}")
    allpairs_cuda.launches += 1
    return out


allpairs_cuda.launches = 0


def allpairs_sym_cuda(pos: torch.Tensor, mass: torch.Tensor,
                      softening2: float = 1e-3,
                      rcp: str = "newton") -> torch.Tensor:
    """Launch K2 (``csrc/allpairs.cu``): f32 (N, 2) positions and f32 (N,)
    masses, contiguous on one CUDA device. One call runs the launches of
    ``sym_launch_plan`` (several tournament rounds each, then a fold) and a
    finishing one, and counts once in ``allpairs_sym_cuda.launches``.
    Anything else raises; there is no fallback. The f64 scratch is (2, N, 2)
    accumulators and (2, R, nt·256, 2) slots for R rounds per launch."""
    check_rcp(rcp)
    n = pos.shape[0]
    check_cuda_inputs("allpairs_sym_cuda", [(pos, (n, 2)), (mass, (n,))])
    out = torch.empty_like(pos)
    err = _sym_launch(pos, mass, None, None, out, n, softening2, rcp,
                      self_pairs=True)
    if err != 0:
        raise RuntimeError(f"allpairs_sym kernel launch failed: CUDA error "
                           f"{err} at N={n}, rcp={rcp}")
    allpairs_sym_cuda.launches += 1
    return out


allpairs_sym_cuda.launches = 0


def allpairs_sym_pair_cuda(pos_i: torch.Tensor, mass_i: torch.Tensor,
                           pos_j: torch.Tensor, mass_j: torch.Tensor,
                           softening2: float = 1e-3, rcp: str = "newton"):
    """Launch K9 (``csrc/allpairs.cu``): two blocks of L particles, f32
    (L, 2) positions and f32 (L,) masses each, contiguous on one CUDA
    device; returns ``(acc_i, acc_j)``. One call runs the launches of
    ``sym_launch_plan(..., self_pairs=False)`` over the ceil(L/256) rounds
    and a finishing one, and counts once in
    ``allpairs_sym_pair_cuda.launches``. Anything else raises; there is no
    fallback. The f64 scratch is as K2's."""
    check_rcp(rcp)
    n = pos_i.shape[0]
    check_cuda_inputs("allpairs_sym_pair_cuda",
                      [(pos_i, (n, 2)), (mass_i, (n,)), (pos_j, (n, 2)),
                       (mass_j, (n,))])
    out = torch.empty((2, n, 2), dtype=torch.float32, device=pos_i.device)
    err = _sym_launch(pos_i, mass_i, pos_j, mass_j, out, n, softening2, rcp,
                      self_pairs=False)
    if err != 0:
        raise RuntimeError(f"allpairs_sym_pair kernel launch failed: CUDA "
                           f"error {err} at L={n}, rcp={rcp}")
    allpairs_sym_pair_cuda.launches += 1
    return out[0], out[1]


allpairs_sym_pair_cuda.launches = 0


# -- the entry points ---------------------------------------------------------

def allpairs_accel_sym(pos: torch.Tensor, mass: torch.Tensor,
                       softening2: float = 1e-3, tile: int = 1024,
                       rcp: str = "newton", strips: int = 4) -> torch.Tensor:
    """Self-interaction all-pairs acceleration by the symmetric kernel (K2):
    each unordered pair evaluated once and applied to both particles. Same
    law as ``allpairs_accel(pos, mass)`` up to f32 summation order for
    finite inputs (non-finite ones: the module docstring).

    N must be a multiple of ``min(tile, N)``, and ``tile`` of the clipped
    ``strips``, as in the JAX package."""
    n = pos.shape[0]
    tile = min(tile, n)
    if n % tile:
        raise ValueError(f"N={n} not divisible by tile {tile}")
    strips = max(1, min(strips, tile // 8))
    if tile % strips:
        raise ValueError(f"tile={tile} not divisible by strips {strips}")
    check_rcp(rcp)
    if pos.device.type == "cuda":
        return allpairs_sym_cuda(pos, mass, softening2, rcp)
    if pos.device.type == "cpu":
        return allpairs_accel_sym_ref(pos, mass, softening2)
    raise ValueError(f"no all-pairs kernel for device {pos.device}")


def allpairs_accel_sym_pair(pos_i: torch.Tensor, mass_i: torch.Tensor,
                            pos_j: torch.Tensor, mass_j: torch.Tensor,
                            softening2: float = 1e-3, tile: int = 1024,
                            rcp: str = "newton", strips: int = 4):
    """Third-law all-pairs between two blocks (K9): ``(acc_i, acc_j)``, the
    acceleration of the i side due to every j-side particle and of the j
    side due to every i-side particle, each unordered pair's kernel k(d)
    evaluated once. The compute side of the symmetric ring
    (``parallel.ring.ring_allpairs_accel_symring``).

    Both sides hold the same L particles' worth; L must be a multiple of
    ``min(tile, L)`` and ``tile`` of the clipped ``strips``, as in the JAX
    package. Non-finite inputs: the module docstring."""
    n = pos_i.shape[0]
    if pos_j.shape[0] != n:
        raise ValueError(f"both sides need the same length, got "
                         f"{tuple(pos_i.shape)} and {tuple(pos_j.shape)}")
    tile = min(tile, n)
    if n % tile:
        raise ValueError(f"N={n} not divisible by tile {tile}")
    strips = max(1, min(strips, tile // 8))
    if tile % strips:
        raise ValueError(f"tile={tile} not divisible by strips {strips}")
    check_rcp(rcp)
    if pos_i.device.type == "cuda":
        return allpairs_sym_pair_cuda(pos_i, mass_i, pos_j, mass_j,
                                      softening2, rcp)
    if pos_i.device.type == "cpu":
        return allpairs_accel_sym_pair_ref(pos_i, mass_i, pos_j, mass_j,
                                           softening2)
    raise ValueError(f"no all-pairs kernel for device {pos_i.device}")


def allpairs_accel(pos: torch.Tensor, mass: torch.Tensor,
                   src_pos: torch.Tensor | None = None,
                   src_mass: torch.Tensor | None = None,
                   softening2: float = 1e-3, tile_i: int = 512,
                   tile_j: int = 2048, rcp: str = "newton") -> torch.Tensor:
    """Acceleration of targets ``pos`` f32[Ni, 2] due to sources (default:
    themselves) ``src_pos`` f32[Nj, 2], ``src_mass`` f32[Nj] by the ordered
    kernel (K1). Ni and Nj must be multiples of the (clipped) tiles, as in
    the JAX package.

    ``rcp``: "exact" (IEEE division, the reference bit for bit), "newton"
    (hardware reciprocal plus one Newton step), "approx" (the hardware
    reciprocal alone), and their "+clamp" forms, which replace the
    is_normal mask by an L1 clamp (config.RCP_MODES)."""
    if src_pos is None:
        src_pos = pos
    if src_mass is None:
        src_mass = mass
    ni, nj = pos.shape[0], src_pos.shape[0]
    tile_i = min(tile_i, ni)
    tile_j = min(tile_j, nj)
    if ni % tile_i or nj % tile_j:
        raise ValueError(
            f"N=({ni},{nj}) not divisible by tiles ({tile_i},{tile_j})")
    check_rcp(rcp)
    if pos.device.type == "cuda":
        return allpairs_cuda(pos, src_pos, src_mass, softening2, rcp)
    if pos.device.type == "cpu":
        return allpairs_accel_ref(pos, mass, src_pos, src_mass, softening2)
    raise ValueError(f"no all-pairs kernel for device {pos.device}")
