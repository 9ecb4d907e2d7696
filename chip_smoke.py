#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card. It
builds the port's CUDA kernels from ``nbody_simulation_tpu_torch/csrc/``
(one nvcc per source, all at once) and holds each to its plain PyTorch
version at the main paths' shapes:

- the Barnes-Hut sweep (K3/K5) in all five rcp modes at the galaxy's
  planned shape, and in the path's mode at the shapes that
  ``bh_accel_diff`` (the galaxy and a 1,048,576-body disc) and a P=4
  ``bh_sharded_accel`` shard give it, at ragged shapes up to S=2048 and at
  empty ones: bounded == full and two calls bitwise, with its grid,
  registers and resident blocks; its fast form bitwise its general law on
  special inputs (NaN, inf and huge coordinates, a coincident pair, a
  denominator below 2^-126, an inf mass, a tiny softening); then θ=0
  Barnes-Hut against an f64 direct sum;
- the quadrupole sweep (K4) in all five rcp modes on a 65,536-body
  Plummer cluster at θ=0.5 with mass-weighted leaf COMs, at one leaf per
  planning row (the force-error shape) and at the CLI's four, and in
  ``newton`` on the θ=0.5 galaxy's columns, bounded == full and two calls
  bitwise, with its grid of chunks; the force error against an
  f64 direct sum beside the monopole's, and θ=0 with the quadrupole
  against the f64 sum;
- the symmetric (K2) and ordered (K1) all-pairs kernels in all five rcp
  modes on the galaxy and on 4,096 sampled targets at N=1,048,576, K2's
  determinism, K2 against K1, and the NaN pattern of both in ``exact``
  and in the +clamp modes;
- K1, K2 and the potential kernel (K6) at small N, where K2's tournament
  has one tile, an odd count of tiles or a ragged last tile;
- K6 on the galaxy, bitwise on two calls, and its NaN pattern, and at the
  P=3 ring's shard shape;
- the backward kernels of the gradient path: K7's two all-pairs sweeps on
  4,096 sampled rows of the padded galaxy (the sampled rows of a full
  launch bitwise those of the sampled launch) and at small N, K8's two
  grouped sweeps at ``bh_accel_diff``'s galaxy shape; ``allpairs_accel_diff``
  and θ=0 ``bh_accel_diff`` gradients against f64 torch autograd of the
  direct sum on a random cloud; both differentiable forwards bitwise the
  run mode's on the galaxy; value+grad of Σ|a|² on the galaxy (Barnes-Hut
  and all-pairs) and on a 1,048,576-body disc, one of them traced; the
  Barnes-Hut value+grad bitwise on two calls (output and both gradients);
  the segmented sum of the planner's gathers' backward
  (``csrc/segment_sum.cu``) at every shape a galaxy value+grad gives it
  and at edge shapes (runs of one, one row holding every entry, rows with
  none, runs of whole windows, ragged K, K=0, int32 and int64 keys,
  widths not a multiple of 32), against its plain version and bitwise on
  two calls, timed beside ``index_add_`` and the deterministic
  ``index_add_``; and the gradient of the galaxy's spread after 4 Euler
  steps;
- the multi-device paths on a ``LocalMesh`` of P shards on the card (one
  card runs the sharded schedule and its kernels; no interconnect): the
  cross-shard symmetric kernel (K9) in all five rcp modes on 4,096 sampled
  rows of each side at both shard shapes below, bitwise on two calls, and
  its NaN pattern, and K2 alone at L=51,200 (the ring's self stage); for
  each K2 and K9 shape, its launches per call, rounds and blocks per launch
  and the round kernel's resident blocks per SM; the galaxy at P=3 (the
  symmetric ring: K2, then one K9 round per shard) held to single-device
  K2, ``make_sharded_step`` with its diagnostics, frame (pixel for pixel
  the single-device dense and sparse frames) and exact energy, one traced
  step; the galaxy at P=4 (the ordered ring: K2 and K1) and
  ``bh_sharded_accel`` there against ``bh_accel``;
  ``ring_allpairs_accel_diff`` at P=3 against f64 autograd; the
  1,048,576-body disc at P=8 (K=4 rounds with the half round), its ring
  held on sampled rows and two steps timed;
- the fully distributed Barnes-Hut on a ``LocalMesh(8)`` of 1,048,576
  bodies a shard (``distributed_phase``): 16 ``DistributedWorld`` steps at
  θ=50 with two collective rebalances (K3 launches per stage, one traced
  step, peak memory), mass conserved, the forest against the ring, the
  compute-to-data near stages and the collective rebalance bitwise their
  same-device and host forms, a ``DistributedEngine`` frame, both
  energies (the exact one against a single device), and the distributed
  force against single-device ``bh_accel``; the θ=0.5 Plummer with seam
  matchings against the ring, the ring with full caps against a single
  device, the gradient at P=4 against ``bh_accel_diff`` and bitwise on two
  calls, the segmented sum at every shape it gives at θ=50 and θ=0.5, and
  one traced P=4 value+grad; and K3, K8 and K4 at the local (S=256), near
  (S=512) and forest (S=2048) rows;
- the distributed CLI (``cli_phase``), ``python -m
  nbody_simulation_tpu_torch.run_multihost`` in subprocesses: one NCCL
  rank with the self-check, energies, a sharded recording (held to an
  in-process run) and a sharded checkpoint; then N=8,388,608 on 8 local
  shards with a sharded checkpoint, resumed on 4 (the loaded live rows
  bitwise the files').

Then it drives the main paths through the CLI: the Barnes-Hut galaxy
(``python -m nbody_simulation_tpu_torch.run`` defaults) for 64 steps, the
θ=0.5 Plummer cluster (``--scenario plummer --n 65536 --theta 0.5
--weighted-leaf-com --energy-every 8``) for 32 steps, the all-pairs galaxy
with energy telemetry (``--force-path pallas --energy-every 8``) for 32
steps, plus 8 steps of the galaxy World at θ=0.5 and 4 of the ordered
all-pairs World (``sym_allpairs=False``), and ``make_sharded_step`` on
the P=3 galaxy and the P=8 disc; each run zeroes the kernels' launch counts
just before and reads them just after. ``World.run``'s CUDA graphs
(``step_graph_phase``, alone with ``--only-step-graphs``): 64 replayed
steps of the galaxy (Euler and leapfrog) and of the θ=0.5 Plummer cluster,
with a profiled step and a ``reconfigure`` between batches, bitwise eager
stepping of the same start (state and frames), with the capture seconds
and the replay share. The engine's snapshot in flight
(``engine_overlap_phase``): a snapshot's enqueue returns before a sleep
given to the card ends; on the galaxy and the θ=0.5 Plummer cluster every
frame of 20 batches equals the synchronous render of its state, and the
engine-view loop runs in turns synchronously and overlapped, with its
ups, snapshot counts and the card's idle time a batch. Last, the
application on the
galaxy: a run checkpointed at step 40 and resumed for 40 more, bitwise an
unbroken 80-step run (live rows and checkpoints; the padding rows keep
their sentinels), with 40 + 40 sweep launches against 80; a run with
``--record`` and ``--gif``, its recording played back within 2 ulps of the
largest coordinate per delta frame of a fresh World's positions and
rendered by ``render_recording --device cuda``; the engine's ups with and
without the particle readback; and the live viewer driven over HTTP
(frames, stats, stream, pause, step, a θ retune, quit), with the host
stages' times. Four steps of each
Barnes-Hut world are traced with torch.profiler (device time and
operations per step, the sweep kernel's share; a trace without device
time for the step or the sweep kernel fails; a value+grad trace without
the K8 kernels fails; a trace's device time counts each device event
once). Every check that fails
raises, and the exit code is then nonzero. Progress lines carry the card's
name and power limit. The last three lines are the kernel table as JSON,
the card, and ``{"ok": true, "device": {...}}``.

Nothing of JAX is imported: the card's machine has none.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SOFTENING2 = 1e-3
# |kernel - plain| per target and component, relative to Σ_j |c_ij|. In
# `exact` the per-pair terms are the same IEEE operations and only the
# summation order differs (the kernels add runs of 32 terms in f32 and the
# runs in f64, torch reduces pairwise in f32): ~1e-6 of Σ|c| at the galaxy.
# The other modes multiply by the hardware reciprocal (1 ulp) instead of
# dividing, a few ulps per pair, so they add a few 1e-7 of Σ|c| at most.
# The symmetric law divides first and multiplies after (≤2 ulp from the
# ordered law per pair). The plain versions are always `exact`, so every
# mode is held to them with the same bound, which a wrong mask or
# reciprocal step exceeds by orders of magnitude. For the potential every
# term has one sign, so Σ|c| = |φ| and the bound is relative per target.
SUM_ORDER_RTOL = 1e-5
STEPS = 64           # Barnes-Hut main path
QUAD_STEPS = 32      # θ=0.5 Plummer path (K4)
QUAD_GALAXY_STEPS = 8
N_PLUMMER = 65_536
PALLAS_STEPS = 32    # all-pairs main path
ENERGY_EVERY = 8
ORDERED_STEPS = 4    # the ordered all-pairs World
N_BIG = 1_048_576
APP_STEPS = 40       # the application phase: a run, and the resume after it
VIEWER_STREAM_S = 2.0
N_SAMPLED = 4096
SMALL_N = (200, 512, 768, 1000, 1280)   # K2 tiles of 256: nt 1, 2, 3, 4, 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP64_PER_S = 34e12            # H100 SXM data sheet, FP64 (no tensor cores)
# The segmented sum has no TPU kernel: it is the backward of the planner's
# gather, which XLA differentiates into a scatter-add.
SEG_REPLACES = "nbody_simulation_tpu/ops/traversal.py:367"
FP32_PER_SM_CLK = 128         # FP32 results per SM and clock (67 TFLOP/s FMA)
MUFU_PER_SM_CLK = 16          # reciprocal / rsqrt results per SM and clock


def law_ops(form: str, rcp: str) -> int:
    """FP32 operations per pair that the pair law itself needs, besides its
    MUFU ops (``law_mufu``), in a form of ``csrc/pair_law.cuh``: "mono",
    an ordered pair of K1; "sweep", one of K3 (below); "sym", an unordered
    pair of K2, applied to both sides; "pot", a term of K6; "quad", a pair
    of K4; "grad_i" and "grad_j", a pair of the target-side (K7a, K8a) and
    source-side (K7b, K8b) backward sweeps, whose ``rcp`` is always newton.
    The sums into the accumulators count; loads, loop control and K2's
    shuffles do not, being the implementation's. Every multiply and add is
    rounded on its own (the JAX operation order; nvcc contracts nothing
    into an FMA), so each counts. K3, K4 and K6 count the form they take where every
    coordinate of a staged tile lies within the kernel's bound, as every
    input timed here does (K3: 0 or 2^-64 ≤ |x| ≤ 2^40; K4: |x| ≤ 2^61;
    K6: 2^125; a tile outside runs the general form: K4 and K6 one compare
    more, K3 two, the mask's second compare and its select). ``exact`` has
    no count: an IEEE division is no fixed number of operations."""
    base, _, guard = rcp.partition("+")
    if form in ("grad_i", "grad_j"):
        # grad_pair, always newton: d 2 sub; |d|_1 1 add; d2 2 mul, add; κ
        # compare and select; q max; den 1 mul; the Newton step 3; the mask
        # 2 compares and a select; t 2 mul, add; m·r and its products with
        # gx, gy 3; r·r, m·r², ·t 3; 2·s, ·κ 2; psign 2 compares, 2
        # selects; psign·q 2; 2sκ·d 2; their sums 2; mr2t·(…) 2; the two
        # differences 2; the sums into the accumulators 2: 43. The j side
        # (K7b, K8b) adds r·t and its sum.
        return 43 if form == "grad_i" else 45
    if form == "quad":
        # _quad_tile: d 2 sub; |d|_1 1 add; d2 2 mul, add, max; the mask 1
        # compare (the tile's bound proves |d|_1 finite) and 2 selects; a·b
        # and m·ab 2; the signs 2 compares and 2 selects; a²b, ab², a³b,
        # a²b², ab³ 5; 2dx, 2dy, 8dx, 8dy 4; g_x and g_y 3 each; 2a³b, 2ab²
        # 2; g_xx and g_yy 7 each; g_xy 12; corr_x and corr_y 13 each; d·w
        # + corr 2 each; the sums 2: 91, plus 3 for each of the two Newton
        # steps. "+clamp" is ignored.
        return 91 + {"newton": 6, "approx": 0}[base]
    ops = 8  # d: 2 sub; |d|_1: 1 add; d2: 2 mul, add, max; den or m*r: 1 mul
    if form == "pot":
        # −m·rsqrt is the 1 mul above; the mask 1 compare (the tile's bound
        # proves |d|_1 finite) and the sum 1 add under its predicate, which
        # is the JAX select's sum (a run sum that starts at +0 is never -0).
        return ops + 2
    ops += {"newton": 3, "approx": 0}[base]  # the Newton step r*(2 - den*r)
    if form == "sweep":
        # K3's form where a tile's bound holds (mono_pair_bounded): the mask
        # 1 compare, the sums under its predicate; max(s, clamp) under
        # +clamp, as mono.
        return ops + 1 + 5
    ops += 1 if guard == "clamp" else 3      # max(s, clamp), or the mask
    return ops + (5 if form == "mono" else 10)  # m*r, d*w, sums; per side


def law_mufu(form: str) -> int:
    """MUFU ops per pair: K4 takes 1/‖d‖₁ and 1/d2 apart, the others one
    reciprocal (or rsqrt) of a product."""
    return 2 if form == "quad" else 1


def card_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return card_query("name,power.limit")


def png_rgba(data: bytes):
    """Decode a PNG file's bytes to an (H, W, 4) uint8 array: with PIL where
    it is installed, else the one form ``utils/pngio`` writes without it
    (8-bit RGBA, one zlib stream, every row unfiltered)."""
    import numpy as np
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError("not a PNG file")
    at, idat, head = 8, b"", None
    while at < len(data):
        n, tag = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        at += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
    w, h, depth, color = head
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    if depth != 8 or color != 6 or rows[:, 0].any():
        raise RuntimeError("PNG form not decodable without PIL")
    return rows[:, 1:].reshape(h, w, 4)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found")


@functools.lru_cache(maxsize=None)
def sass_text(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library, run once per library (a run
    takes seconds, and the bounds ask for one library many times)."""
    return subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def sass_per_pair(lib: Path, function: str) -> tuple[float, float]:
    """(instructions, MUFU ops) per pair in the hot loop of ``function`` in
    the built library, from ``cuobjdump -sass``: the law's operations and
    the implementation's overhead together. Every form of the pair law
    computes ‖d‖₁ = |dx| + |dy| once, as one FADD with two absolute-value
    operands (the first may carry a ``.reuse`` flag), so those count the
    loop's pairs; the hot loop is the innermost loop (a backward branch
    with no other loop inside) holding the most pairs, less any
    warp-uniform slow path inside it (the code a branch after a VOTE.ALL
    jumps over); of two such loops with as many pairs (a kernel's fast and
    general forms, chosen per tile), the one with fewer instructions."""
    text = sass_text(lib)
    body, name = [], None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None and function in name:
                break
            name, body = m.group(1), []
            continue
        body.append(line)
    if name is None or function not in name:
        raise RuntimeError(f"no SASS function matching {function} in {lib}")
    instrs, where, branches = [], {}, []
    for line in body:
        lab = re.match(r"^\s*(\.L_x_\d+):", line)
        if lab:
            where[lab.group(1)] = len(instrs)
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if ins:
            where[f"0x{int(ins.group(1), 16):x}"] = len(instrs)
            tgt = re.search(r"BRA\S*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                            ins.group(2))
            if tgt:
                label = tgt.group(1) or f"0x{int(tgt.group(2), 16):x}"
                branches.append((len(instrs), label))
            instrs.append(ins.group(2))
    loops = [(where[t], at) for at, t in branches
             if t in where and where[t] <= at]
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    pair_op = re.compile(
        r"FADD\S*\s+R\d+,\s*\|R\d+\|(?:\.reuse)?,\s*\|R\d+\|")
    best = None
    for a, b in inner:
        # A warp-uniform slow path inside the loop (VOTE.ALL, then a branch
        # over it to the fast path) is left out: the count is that of the
        # path the warp takes when the vote passes.
        skip = set()
        for k in range(a, b):
            vote = re.match(r"VOTE\.ALL\s+(P\d+)", instrs[k])
            jump = vote and re.match(
                rf"@{vote.group(1)}\s+BRA\S*\s+(?:`\((\.L_x_\d+)\)|"
                r"(0x[0-9a-f]+))", instrs[k + 1])
            if jump:
                label = jump.group(1) or f"0x{int(jump.group(2), 16):x}"
                if label in where and k + 1 < where[label] <= b:
                    skip.update(range(k + 2, where[label]))
        loop = [instrs[i] for i in range(a, b + 1) if i not in skip]
        pairs = sum(bool(pair_op.search(s)) for s in loop)
        if pairs and (best is None or (pairs, -len(loop))
                      > (best[2], -best[0])):
            best = (len(loop), sum("MUFU." in s for s in loop), pairs)
    if best is None:
        raise RuntimeError(f"no pair loop found in the SASS of {function}")
    return best[0] / best[2], best[1] / best[2]


def dev_us(e) -> float:
    """A profiler event's own device time in µs."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def same_bits(a, b) -> bool:
    """Whether two f32 tensors hold the same bits (NaN payloads included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def on_device(e) -> bool:
    """Whether a profiler event ran on the card (a kernel, copy or set)."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_ms(prof, *names) -> float:
    """The device time of a torch.profiler trace in ms: each device-side
    event once, or those whose name holds one of ``names``. An operator's
    own device time is that of the kernels it launched, so a sum over
    ``key_averages()`` counts every kernel launched inside an operator
    twice (``all_entries_ms``)."""
    return sum(dev_us(e) for e in prof.events() if on_device(e) and (
        not names or any(n in e.name for n in names))) / 1e3


def all_entries_ms(prof) -> float:
    """The sum of every ``key_averages()`` entry's own device time, which
    earlier versions of this script reported as the device time: kernels
    launched inside an operator count twice in it."""
    return sum(dev_us(e) for e in prof.key_averages()) / 1e3


def segment_bound(k: int, w: int, n_rows: int, key_bytes: int):
    """(bound_ms, bound_by, note) of the segmented sum of K gathered rows
    of width W into n_rows: each input read once (the f32 rows, the sorted
    key, the i64 permutation), the f32 output written once, over the memory
    rate; its K·W f64 adds over the FP64 rate."""
    nbytes = 4.0 * k * w + (key_bytes + 8.0) * k + 4.0 * n_rows * w
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_adds = float(k) * w / FP64_PER_S
    return (max(t_bytes, t_adds) * 1e3,
            "bytes" if t_bytes >= t_adds else "operations",
            f"{nbytes:.4e} bytes over {HBM_BYTES_PER_S:.3e} B/s "
            f"{t_bytes * 1e3:.4f} ms, {k * w:.4e} f64 adds over "
            f"{FP64_PER_S:.1e} op/s {t_adds * 1e3:.4f} ms")


@contextlib.contextmanager
def captured_gathers():
    """Inside the block, every call of the planner's gather backward
    (``ops/traversal.py:index_add_ordered``) appends its (n_rows, idx,
    src) to the list it yields, and runs as it would."""
    from nbody_simulation_tpu_torch.ops import traversal
    calls, real = [], traversal.index_add_ordered

    def capture(n_rows, idx, src):
        calls.append((n_rows, idx, src))
        return real(n_rows, idx, src)

    traversal.index_add_ordered = capture
    try:
        yield calls
    finally:
        traversal.index_add_ordered = real


N_DIST = 8_388_608   # the distributed path: P=8 shards of 1,048,576
DIST_P = 8
DIST_STEPS = 16
DIST_REBALANCE = 8
N_DIST_QUALITY = 262_144
N_DIST_EXACT = 65_536
N_DIST_GRAD = 131_072  # the galaxy's first 2^17 rows: P=4 shards, no padding
FOREST_ROWS = 32       # leaves per forest row (bh_distributed.FOREST_ROW_LEAVES)


def distributed_phase(h):
    """The fully distributed Barnes-Hut path on a ``LocalMesh`` of P shards
    on the card (ROADMAP item 6.1-6.5): the θ=50 main path at N=8,388,608
    under ``DistributedWorld`` with its rebalances, the θ=0.5 quality path
    with seam matchings, exact parity of the ring, the gradient, the
    energy, and K3, K4 and K8 at the path's row shapes. ``h`` holds
    ``main``'s helpers. Returns (the launches of its runs per kernel, the
    kernels' checks at the new shapes)."""
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.scenarios import (galaxy, plummer,
                                                             uniform_disc)
    from nbody_simulation_tpu_torch.ops import energy as en
    from nbody_simulation_tpu_torch.ops import traversal
    from nbody_simulation_tpu_torch.ops import traversal_grad as tgr
    from nbody_simulation_tpu_torch.ops.raster import render_frame
    from nbody_simulation_tpu_torch.parallel import bh_distributed as bd
    from nbody_simulation_tpu_torch.runtime.distributed import (
        DistributedEngine, DistributedWorld)
    from nbody_simulation_tpu_torch.state import ParticleState
    from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter

    log, dev = h.log, h.dev
    t_phase = time.perf_counter()
    gs = traversal.grouped_sweep
    counted = {"K3": (gs, "launches"), "K4": (gs, "quad_launches"),
               "K6": (en.potential_cuda, "launches"),
               "K8a": (tgr.grouped_bwd_tgt_cuda, "launches"),
               "K8b": (tgr.grouped_bwd_src_cuda, "launches"),
               "SEG": (traversal.segment_sum_cuda, "launches")}

    def zero_counts():
        for fn, attr in counted.values():
            setattr(fn, attr, 0)

    def read_counts():
        torch.cuda.synchronize()
        return {k: getattr(fn, attr) for k, (fn, attr) in counted.items()
                if getattr(fn, attr)}

    # Every stage's sweep goes through bh_distributed._sweep: tally its
    # launches and device time per stage, and keep each monopole stage's
    # first inputs (K3 and K8 are held at these shapes below).
    real_sweep = bd._sweep
    stages, first = {}, {}
    seg_rows = {}  # the segmented sum at the gradient's largest shapes

    def staged_sweep(stage, tgt, cols, cfg, mp, rcp, force=None):
        k3, k4 = gs.launches, gs.quad_launches
        k8 = tgr.grouped_bwd_tgt_cuda.launches
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_sweep(stage, tgt, cols, cfg, mp, rcp, force)
        e1.record()
        rec = stages.setdefault(stage, {"K3": 0, "K4": 0, "events": []})
        rec["K3"] += gs.launches - k3
        rec["K4"] += gs.quad_launches - k4
        rec["events"].append((e0, e1))
        if mp == 1 and force is None and stage not in first:
            first[stage] = (tgt, cols, rcp)
        return out

    def stage_report():
        torch.cuda.synchronize()
        out = {s: {"K3": r["K3"], "K4": r["K4"],
                   "ms": sum(a.elapsed_time(b) for a, b in r["events"])}
               for s, r in stages.items()}
        stages.clear()
        return out

    def rel_err(got, want, live):
        r = ((got - want).double().norm(dim=1)
             / want.double().norm(dim=1).clamp_min(1e-12))[live]
        return r.median().item(), torch.quantile(r.float(), 0.99).item()

    bd._sweep = staged_sweep
    try:
        # -- the main path: θ=50, P=8, N=8,388,608, forest, compute to data
        mesh = par.LocalMesh(DIST_P, dev)
        cfg = SimConfig(force_path="bh", theta=50.0)
        t0 = time.perf_counter()
        ds = par.distribute_state(uniform_disc(N_DIST, seed=0), mesh, cfg)
        torch.cuda.synchronize()
        L = ds.n // DIST_P
        log(f"distributed BH: uniform_disc N={N_DIST} laid out on P={DIST_P} "
            f"shards of L={L} in {time.perf_counter() - t0:.2f} s "
            "(host Morton sort)")
        mass0 = par.sharded_diagnostics(ds, mesh)["total_mass"]
        world = DistributedWorld(ds, mesh, cfg,
                                 rebalance_every=DIST_REBALANCE)
        world.step()                         # warm-up: first-call costs
        torch.cuda.synchronize()
        world = DistributedWorld(ds, mesh, cfg,
                                 rebalance_every=DIST_REBALANCE)
        torch.cuda.reset_peak_memory_stats()
        stages.clear()
        zero_counts()
        t0 = time.perf_counter()
        world.run(DIST_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        main_counts = read_counts()
        main_stages = stage_report()
        peak = torch.cuda.max_memory_allocated()
        log(f"distributed BH theta=50 P={DIST_P} N={N_DIST}: {DIST_STEPS} "
            f"DistributedWorld steps (rebalance every {DIST_REBALANCE}, "
            f"re-sort every {cfg.resort_every}) in {run_s:.3f} s, "
            f"{DIST_STEPS / run_s:.3f} steps/s untraced; launches "
            f"{main_counts}; per stage {main_stages}; peak memory "
            f"{peak / 2**30:.3f} GiB")
        if set(main_counts) != {"K3"} or not main_counts["K3"]:
            raise RuntimeError(f"distributed BH launches {main_counts}")
        diag = par.sharded_diagnostics(world.state, mesh)
        m_err = abs(diag["total_mass"].item() - mass0.item()) / mass0.item()
        if not (m_err <= 1e-6 and bool(torch.isfinite(world.state.pos).all())
                and diag["n_live"].item() == N_DIST):
            raise RuntimeError(f"distributed BH: mass {diag['total_mass']}"
                               f" against {mass0}, n_live {diag['n_live']}")
        log(f"distributed BH: total mass conserved ({m_err:.2e} relative, "
            f"bound 1e-6), n_live {diag['n_live'].item()}, positions finite")

        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            world.step()
            torch.cuda.synchronize()
        traced = stage_report()
        dev_ms = device_ms(prof)
        k3_ms = device_ms(prof, "grouped_sweep_kernel")
        n_ops = sum(1 for e in prof.events() if on_device(e))
        if dev_ms <= 0 or k3_ms <= 0:
            raise RuntimeError("distributed BH trace recorded no device time")
        log(f"distributed BH traced step: device time {dev_ms:.3f} ms in "
            f"{n_ops} device operations (summed over every profiler entry: "
            f"{all_entries_ms(prof):.3f} ms), K3 {k3_ms:.3f} ms "
            f"({k3_ms / dev_ms:.0%}); K3 launches per stage "
            + ", ".join(f"{s} {r['K3']}" for s, r in traced.items()))

        # Forest against the ring on the same state; the compute-to-data
        # near stage against the same-device one, bitwise.
        st = world.state
        live = st.mass > 0
        forest = par.bh_distributed_accel(st.pos, st.mass, mesh, config=cfg)
        ring = par.bh_distributed_accel(
            st.pos, st.mass, mesh, config=cfg.replace(far_mode="ring"))
        med, p99 = rel_err(forest, ring, live)
        log(f"distributed BH forest vs far_mode=ring: median relative "
            f"{med:.4e} (bound 0.02), p99 {p99:.4e}")
        if not med < 0.02:
            raise RuntimeError(f"forest vs ring median {med}")
        del ring
        same = par.bh_distributed_accel(
            st.pos, st.mass, mesh, config=cfg.replace(near_remote=False))
        if not torch.equal(forest.view(torch.int32), same.view(torch.int32)):
            raise RuntimeError("near_remote=True differs from near_remote="
                               "False")
        log("distributed BH: compute-to-data near stages (near_remote=True) "
            "bitwise the same-device ones")
        del same
        stage_report()

        # The collective rebalance against the host's after a drift.
        step = par.make_distributed_bh_step(mesh, cfg)
        drift = st
        for _ in range(3):
            drift = step(drift)
        t0 = time.perf_counter()
        host = par.rebalance_state(drift, mesh, cfg)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        coll = par.collective_rebalance(drift, mesh, cfg)
        torch.cuda.synchronize()
        coll_s = time.perf_counter() - t0
        if not all(torch.equal(getattr(host, k), getattr(coll, k))
                   for k in ("pos", "vel", "mass")):
            raise RuntimeError("collective_rebalance differs from "
                               "rebalance_state")
        log(f"collective_rebalance bitwise rebalance_state after 3 steps of "
            f"drift: {coll_s * 1e3:.1f} ms on the card, {host_s * 1e3:.1f} ms "
            "through the host")
        del drift, host, coll
        stage_report()

        # The engine: a few batches, the last frame against the sharded
        # raster of the same state.
        eng = DistributedEngine(world, snapshot_interval=0.0,
                                steps_per_snapshot=2, profile_every=0)
        start = world.updates
        eng.start(max_steps=start + 4)
        eng.join(timeout=300)
        snap = None
        while True:
            nxt = eng.next_snapshot(timeout=1.0)
            if nxt is None:
                break
            snap = nxt
        eng.stop()
        want = par.sharded_render_frame(
            world.state.pos, world.state.vel, world.state.mass, mesh,
            world_size=cfg.world_size, render_size=cfg.render_size,
            heavy_weight=cfg.heavy_weight).cpu().numpy()
        if (snap is None or snap.step != start + 4
                or not np.array_equal(snap.frame, want)):
            raise RuntimeError("DistributedEngine frame differs from "
                               "sharded_render_frame")
        log(f"DistributedEngine: steps {start} to {snap.step} in batches of "
            f"2; the last frame pixel for pixel sharded_render_frame of the "
            f"state ({int((want[..., 3] > 0).sum())} lit pixels)")
        stage_report()

        # Energy on the θ=50 world: Barnes-Hut staged and exact (K6 ring).
        lines = []
        meters = {}
        for method in ("bh", "exact"):
            zero_counts()
            meter = EnergyMeter(1, emit=lines.append, method=method)
            t0 = time.perf_counter()
            meter(world)
            torch.cuda.synchronize()
            meters[method] = (meter.samples[-1][1],
                              (time.perf_counter() - t0) * 1e3, read_counts())
        stage_report()
        flat = ParticleState(world.state.pos, world.state.vel,
                             world.state.mass)
        t0 = time.perf_counter()
        e1 = en.total_energy(flat).item()
        e1_ms = (time.perf_counter() - t0) * 1e3
        e_exact = meters["exact"][0]
        log(f"EnergyMeter on the theta=50 world: bh {meters['bh'][0]:.6e} "
            f"({meters['bh'][1]:.1f} ms, launches {meters['bh'][2]}), exact "
            f"{e_exact:.6e} ({meters['exact'][1]:.1f} ms, launches "
            f"{meters['exact'][2]}); single-device total_energy {e1:.6e} "
            f"({e1_ms:.1f} ms)")
        if (abs(e_exact - e1) > 1e-5 * abs(e1)
                or meters["exact"][2] != {"K6": DIST_P * DIST_P}):
            raise RuntimeError(f"distributed exact energy {e_exact} against "
                               f"{e1}, launches {meters['exact'][2]}")
        energy_counts = meters["exact"][2]

        # Last of the main path: the distributed force against the
        # single-device bh_accel on the same state (run_multihost's
        # self-check).
        fcap, lcap = cfg.resolved_caps()
        single = traversal.bh_accel(
            flat.pos, flat.mass, theta=cfg.theta, softening2=cfg.softening2,
            leaf_size=cfg.leaf_size, world_size=cfg.world_size,
            unweighted_leaf_com=cfg.unweighted_leaf_com, frontier_cap=fcap,
            leaf_cap=lcap, plan_leaves=cfg.plan_leaves,
            morton_bits=cfg.resolved_morton_bits(), multipole=1,
            rcp=cfg.resolved_rcp(bh=True))
        forest = par.bh_distributed_accel(st.pos, st.mass, mesh, config=cfg)
        self_med, self_p99 = rel_err(forest, single, st.mass > 0)
        del single, forest, flat, world, st, ds, eng
        stage_report()
        torch.cuda.empty_cache()

        # -- θ=0.5 quality, P=8: seam matchings, forest against the ring
        qcfg = SimConfig(force_path="bh", theta=0.5, frontier_cap=128,
                         leaf_cap=256, plan_leaves=1,
                         unweighted_leaf_com=False)
        qds = par.distribute_state(plummer(N_DIST_QUALITY, seed=0), mesh,
                                   qcfg)
        extra = par.adjacency_stages(qds, mesh, qcfg)
        log(f"theta=0.5 Plummer N={N_DIST_QUALITY} P={DIST_P}: "
            f"{len(extra)} seam matchings, "
            f"{sum(len(m) for m in extra) // 2} shard pairs")
        if not extra:
            raise RuntimeError("no seam matchings at theta=0.5")
        stage_report()
        zero_counts()
        qf = par.bh_distributed_accel(qds.pos, qds.mass, mesh, config=qcfg,
                                      extra_pairs=extra)
        q_counts = read_counts()
        q_stages = stage_report()
        qring = par.bh_distributed_accel(
            qds.pos, qds.mass, mesh,
            config=qcfg.replace(far_mode="ring", far_frontier_cap=128,
                                far_leaf_cap=256))
        qmed, qp99 = rel_err(qf, qring, qds.mass > 0)
        log(f"theta=0.5 forest with seams vs the ring (full far caps): "
            f"median {qmed:.4e}, p99 {qp99:.4e} (bounds 1e-3); launches "
            f"{q_counts}; K4 per stage "
            + ", ".join(f"{s} {r['K4']} launches {r['ms']:.3f} ms"
                        for s, r in q_stages.items()))
        if not (qmed < 1e-3 and qp99 < 1e-3) or not q_counts.get("K4"):
            raise RuntimeError(f"theta=0.5 forest error {qmed}, {qp99}, "
                               f"launches {q_counts}")
        del qf, qring
        qstep = par.make_distributed_bh_step(mesh, qcfg, extra_pairs=extra)
        qm0 = par.sharded_diagnostics(qds, mesh)["total_mass"].item()
        q2 = qstep(qstep(qds))
        qm1 = par.sharded_diagnostics(q2, mesh)["total_mass"].item()
        if abs(qm1 - qm0) > 1e-6 * qm0 or not bool(
                torch.isfinite(q2.pos).all()):
            raise RuntimeError(f"theta=0.5 steps: mass {qm1} against {qm0}")
        log(f"theta=0.5: two steps conserve mass ({qm1:.6e}), positions "
            "finite")
        del qds, q2
        stage_report()

        # -- exact parity: the ring with full far caps against one device.
        # With caps at least the level widths and a frontier of half the
        # global leaves, every stage tests the nodes of the single-device
        # walk (the JAX package's contract), so only sums differ in order.
        fe = N_DIST_EXACT // 64 // 2
        ecfg = SimConfig(force_path="bh", theta=0.5, frontier_cap=fe,
                         leaf_cap=256, plan_leaves=1,
                         unweighted_leaf_com=False, far_mode="ring",
                         far_frontier_cap=fe, far_leaf_cap=256)
        eds = par.distribute_state(uniform_disc(N_DIST_EXACT, seed=0), mesh,
                                   ecfg)
        dist_e = par.bh_distributed_accel(eds.pos, eds.mass, mesh,
                                          config=ecfg)
        one_e = traversal.bh_accel(
            eds.pos, eds.mass, theta=0.5, unweighted_leaf_com=False,
            frontier_cap=fe, leaf_cap=256, multipole=2, morton_bits=24)
        emed, ep99 = rel_err(dist_e, one_e, eds.mass > 0)
        log(f"ring with full far caps vs single-device bh_accel "
            f"(uniform_disc N={N_DIST_EXACT}, P={DIST_P}, theta=0.5, caps "
            f"F={fe} L=256): median "
            f"{emed:.3e} (bound 1e-6), p99 {ep99:.3e} (bound 1e-5)")
        if not (emed < 1e-6 and ep99 < 1e-5):
            raise RuntimeError(f"exact ring parity {emed}, {ep99}")
        del eds, dist_e, one_e
        stage_report()

        # -- the gradient, P=4, on the galaxy's first 2^17 rows
        mesh4 = par.LocalMesh(4, dev)
        gal = galaxy(seed=0)
        gal = ParticleState(gal.pos[:N_DIST_GRAD], gal.vel[:N_DIST_GRAD],
                            gal.mass[:N_DIST_GRAD])
        grad_counts = {}
        # The caps of the JAX package's equivalence contract: a frontier of
        # half the global leaves and a leaf list of all of them, at every
        # ring distance, so that both walks open the same nodes.
        fcap_g = N_DIST_GRAD // 64 // 2
        lcap_g = N_DIST_GRAD // 64
        for theta in (50.0, 0.5):
            gcfg = SimConfig(force_path="bh", theta=theta,
                             unweighted_leaf_com=False, frontier_cap=fcap_g,
                             leaf_cap=lcap_g, plan_leaves=1, far_mode="ring",
                             far_frontier_cap=fcap_g, far_leaf_cap=lcap_g,
                             morton_bits=15, multipole=1)
            gds = par.distribute_state(gal, mesh4, gcfg)
            if gds.n != N_DIST_GRAD:
                raise RuntimeError(f"gradient layout {gds.n} rows")
            cot = torch.tensor(np.random.default_rng(3).normal(
                0, 1, (gds.n, 2)).astype(np.float32), device=dev)
            run = par.bh_distributed_accel(gds.pos, gds.mass, mesh4,
                                           config=gcfg)
            p = gds.pos.clone().requires_grad_(True)
            m = gds.mass.clone().requires_grad_(True)
            zero_counts()
            t0 = time.perf_counter()
            with captured_gathers() as gathers:
                a = par.bh_distributed_accel_diff(p, m, mesh4, config=gcfg)
                gp, gm = torch.autograd.grad((a * cot).sum(), (p, m))
            torch.cuda.synchronize()
            vg_ms = (time.perf_counter() - t0) * 1e3
            grad_counts[theta] = read_counts()
            if not torch.equal(a.detach(), run):
                raise RuntimeError(f"theta={theta}: bh_distributed_accel_diff "
                                   "differs from bh_distributed_accel")
            # A second call on the same inputs: output and both gradients
            # bitwise (the gathers' backward adds in a fixed order).
            p2 = gds.pos.clone().requires_grad_(True)
            m2 = gds.mass.clone().requires_grad_(True)
            a2 = par.bh_distributed_accel_diff(p2, m2, mesh4, config=gcfg)
            twice = [same_bits(x, y) for x, y in zip(
                (a.detach(), gp, gm),
                (a2.detach(), *torch.autograd.grad((a2 * cot).sum(),
                                                   (p2, m2))))]
            del p2, m2, a2
            if not all(twice):
                raise RuntimeError(f"theta={theta}: bh_distributed_accel_diff "
                                   f"differs between two calls (output, "
                                   f"positions, masses): {twice}")
            p1 = gds.pos.clone().requires_grad_(True)
            m1 = gds.mass.clone().requires_grad_(True)
            a1 = tgr.bh_accel_diff(p1, m1, theta=theta, frontier_cap=fcap_g,
                                   leaf_cap=lcap_g, unweighted_leaf_com=False,
                                   plan_leaves=1, rcp=gcfg.resolved_rcp(
                                       bh=True))
            gp1, gm1 = torch.autograd.grad((a1 * cot).sum(), (p1, m1))
            # Positions: the JAX test's bounds. Masses: rtol 2e-4 and an
            # atol of 1e-6 of the largest |g_m|. Each g_m is a sum of
            # terms of random sign (a random cotangent) that the two walks
            # add in different orders, so entries that cancel to near 0
            # carry ~1e-7 of the terms' scale; the JAX test's atol of 1e-8
            # is sized for its unit-mass disc.
            m_atol = 1e-6 * gm1.abs().max().item()
            ok = (torch.allclose(a.detach(), a1.detach(), rtol=2e-4,
                                 atol=1e-6)
                  and torch.allclose(gp, gp1, rtol=2e-4, atol=1e-6)
                  and torch.allclose(gm, gm1, rtol=2e-4, atol=m_atol))
            dp = ((gp - gp1).abs() / (1e-6 + 2e-4 * gp1.abs())).max().item()
            dm = ((gm - gm1).abs() / (m_atol + 2e-4 * gm1.abs())).max().item()
            over = int(((gm - gm1).abs() > 1e-8 + 2e-4 * gm1.abs()).sum())
            rel_m = ((gm - gm1).norm() / gm1.norm()).item()
            rel_p = ((gp - gp1).norm() / gp1.norm()).item()
            log(f"bh_distributed_accel_diff theta={theta} P=4 (galaxy, "
                f"{N_DIST_GRAD} rows, caps F={fcap_g} L={lcap_g}): forward "
                f"bitwise bh_distributed_accel; output and both gradients "
                f"bitwise on two calls; gradient of sum(a*cot) vs "
                f"single-device bh_accel_diff: pos {dp:.3f} of the allowed "
                f"(rtol 2e-4, atol 1e-6), relative norm {rel_p:.3e}; mass "
                f"{dm:.3f} of the allowed (rtol 2e-4, atol {m_atol:.3e}), "
                f"relative norm {rel_m:.3e}, {over} of {gm.numel()} beyond "
                f"atol 1e-8; value+grad {vg_ms:.1f} ms; launches "
                f"{grad_counts[theta]}")
            if not ok or not grad_counts[theta].get("K8a"):
                raise RuntimeError(f"distributed gradient theta={theta}: "
                                   f"{dp}, {dm}, launches "
                                   f"{grad_counts[theta]}")
            # The segmented sum at every shape this gradient gives it.
            seg_err, (sn, sidx, sflat, skey, sperm) = h.hold_seg(
                f"the P=4 distributed gradient, theta={theta}", gathers)
            seg_ms = h.timed_ms(lambda: traversal.segment_sum_cuda(
                sflat, skey, sperm, sn), reps=20)
            _, seg_plain = h.plain_timed(lambda: traversal.segment_sum_ref(
                sflat, skey, sperm, sn))
            seg_bd = segment_bound(*sflat.shape, sn, skey.element_size())
            seg_rows[f"segment_sum P=4 theta={theta}"] = (
                seg_err, seg_ms, seg_plain, seg_bd)
            log(f"segment_sum, the largest call of the P=4 gradient at "
                f"theta={theta} (K={sflat.shape[0]}, W={sflat.shape[1]}, "
                f"{sn} rows, longest run {int(torch.bincount(skey).max())}):"
                f" kernel {seg_ms:.4f} ms, plain {seg_plain:.3f} ms (once), "
                f"bound {seg_bd[0]:.4f} ms by {seg_bd[1]}")
            del gathers, sidx, sflat, skey, sperm
            if theta == 50.0:
                # One traced value+grad: device time and operations.
                from torch.profiler import ProfilerActivity, profile
                p3 = gds.pos.clone().requires_grad_(True)
                m3 = gds.mass.clone().requires_grad_(True)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    a3 = par.bh_distributed_accel_diff(p3, m3, mesh4,
                                                       config=gcfg)
                    torch.autograd.grad((a3 * cot).sum(), (p3, m3))
                    torch.cuda.synchronize()
                d_ms = device_ms(prof)
                d_ops = sum(1 for e in prof.events() if on_device(e))
                d_seg = device_ms(prof, "segment_windows", "segment_carry")
                del p3, m3, a3, prof
                gal_vg = getattr(h, "vg_trace", None)
                log(f"traced value+grad, P=4 distributed theta=50: device "
                    f"time {d_ms:.3f} ms in {d_ops} device operations, "
                    f"segment_sum {d_seg:.3f} ms"
                    + ("" if gal_vg is None else
                       f"; galaxy bh_accel_diff: {gal_vg[0]:.3f} ms in "
                       f"{gal_vg[1]} operations, segment_sum "
                       f"{gal_vg[2]:.3f} ms"))
        del gds, p, m, a, gp, gm, p1, m1, a1, gp1, gm1, run, cot
        stage_report()
    finally:
        bd._sweep = real_sweep

    # -- the kernels at this path's row shapes: K3 (and K8) from the θ=50
    # stages' inputs
    kernel_rows = dict(seg_rows)
    for stage, (tgt, cols, rcp) in sorted(first.items()):
        g, s, _ = tgt.shape
        if s not in (256, 512, 2048):
            continue
        label = f"{stage} rows (G={g}, S={s}, C={cols[0].shape[1]})"
        lim = traversal.last_nonzero_columns(cols[2])
        errs = h.hold_mono(f"K3 at the {label}", (tgt, *cols[:3], lim),
                           [rcp])
        ms = h.timed_ms(lambda: traversal.grouped_sweep(
            tgt, *cols[:3], h.softening2, rcp, col_limit=lim), reps=10)
        mode = h.rcp_modes.index(rcp)
        pairs = float(lim.sum().item()) * s
        bd_ = h.bound("sweep", rcp, pairs,
                      4.0 * (3 * lim.sum().item() + 4 * g * s) + 4 * g,
                      "grouped_sweep", f"grouped_sweep_kernelILi{mode}EE")
        _, plain_ms = h.plain_timed(lambda: traversal.grouped_force_ref(
            tgt, *cols[:3], h.softening2))
        kernel_rows[f"K3 {stage} S={s}"] = (errs[rcp], ms, plain_ms, bd_)
        log(f"K3 at the {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
            f"(once), bound {bd_[0]:.4f} ms by {bd_[1]}")
        if stage == "forest":
            # K8 at the same shape, a random cotangent.
            gbar = torch.tensor(np.random.default_rng(11).normal(
                0, 1, tuple(tgt.shape)).astype(np.float32), device=dev)
            kernel_rows.update(
                (f"{k} {stage} S={s}", v) for k, v in h.hold_k8(
                    f"K8 at the {label}", (tgt, gbar, *cols[:3])).items())

    # At P=8 every pair of non-neighbours is a θ=0.5 seam (the shards'
    # boxes overlap), so the θ=0.5 forest rows sweep no live column. K4 is
    # held at their shape (S=2048, 32 leaves a row) on the single-device
    # planner's columns of the 65,536-body Plummer at θ=0.5.
    from nbody_simulation_tpu_torch.ops.tree import build_tree
    kst = plummer(N_PLUMMER, seed=0).to(dev)
    ktree, _ = build_tree(kst.pos, kst.mass, unweighted_leaf_com=False,
                          morton_bits=24, quad=True)
    kin = traversal.sweep_inputs(ktree, 0.5, 128, 256,
                                 plan_leaves=FOREST_ROWS, multipole=2)
    errs, plain_ms, ms_b, _, bd_ = h.hold_quad(
        f"K4 at the forest rows' shape (Plummer N={N_PLUMMER}, theta=0.5, "
        f"{FOREST_ROWS} leaves a row)", kin, ("newton",), "newton", reps=5)
    kernel_rows[f"K4 forest-row shape S={kin[0].shape[1]}"] = (
        errs["newton"], ms_b, plain_ms, bd_)
    del kst, ktree, kin
    log(f"phase distributed Barnes-Hut: {time.perf_counter() - t_phase:.1f} s")
    log(f"distributed BH self-check: the distributed force vs single-device "
        f"bh_accel on the same N={N_DIST} state: median relative "
        f"{self_med:.4e}, p99 {self_p99:.4e}")
    launches = {"theta=50 main path": main_counts,
                "theta=0.5 forest call": q_counts,
                "exact energy": energy_counts}
    launches.update({f"gradient theta={t}": c
                     for t, c in grad_counts.items()})
    return launches, kernel_rows


N_CLI_RANK = 262_144   # the CLI as one NCCL rank
CLI_STEPS = 8
CLI_RESUME_STEPS = 4


def cli_phase(h):
    """The distributed CLI, ``python -m nbody_simulation_tpu_torch.
    run_multihost``, in subprocesses (a process group stays in its
    process): one NCCL rank on the card with the self-check, Barnes-Hut
    energies, a sharded recording and a sharded checkpoint, its recording
    held to an in-process run; then the distributed main path's size on 8
    local shards with a sharded checkpoint, resumed on 4. Each run prints
    its kernel launches, counted from 0 in its own process. Returns the
    phase's numbers."""
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.scenarios import scenario_chunk
    from nbody_simulation_tpu_torch.parallel.multihost import multihost_state
    from nbody_simulation_tpu_torch.runtime.distributed import (
        DistributedWorld)
    from nbody_simulation_tpu_torch.utils.checkpoint import (
        load_sharded_checkpoint)
    from nbody_simulation_tpu_torch.utils.recording import playback_sharded

    log, dev = h.log, h.dev
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(root)

    def cli(label, *args):
        """Run the CLI; return (its stdout's lines that start with a prefix,
        as a function of the prefix; its wall seconds)."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nbody_simulation_tpu_torch.run_multihost",
             *args], cwd=root, env=env, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"run_multihost ({label}) exited "
                               f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()

        def found(prefix):
            got = [ln for ln in lines if ln.startswith(prefix)]
            if not got:
                raise RuntimeError(f"run_multihost ({label}): no {prefix!r} "
                                   f"line in\n{proc.stdout[-3000:]}")
            return got
        return found, wall

    def num(text, before):
        return float(re.search(re.escape(before) + r"\s*([-+0-9.eEinfa]+)",
                               text).group(1))

    cfg = SimConfig(force_path="bh", theta=50.0)
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="nbody_cli_"))
    try:
        # -- one NCCL rank: the CLI's default on one card
        rec, d1 = tmp / "rec", tmp / "d1"
        found, wall = cli(
            "one NCCL rank", "--scenario", "uniform", "--n", str(N_CLI_RANK),
            "--steps", str(CLI_STEPS), "--selfcheck", "--energy-every", "4",
            "--energy-method", "bh", "--record", str(rec), "--record-every",
            "2", "--snapshot-every", "2", "--checkpoint-sharded", str(d1))
        head, done = found("processes:")[-1], found("done:")[-1]
        launches = json.loads(found("launches:")[-1].split(":", 1)[1])
        energies = found("energy:")
        if (not head.startswith("processes: 1, shards: 1 (1 local) on cuda")
                or found("len:")[-1] != f"len: {N_CLI_RANK}"
                or not done.startswith(f"done: {CLI_STEPS} steps")
                or len(energies) != 2 or not launches.get("K3")):
            raise RuntimeError(f"run_multihost as one NCCL rank: {head}; "
                               f"{done}; {energies}; launches {launches}")
        sc = found("selfcheck:")[-1]
        out["rank"] = {"steps_per_s": num(done, "s ("), "wall_s": wall,
                       "selfcheck_median": num(sc, "median="),
                       "selfcheck_p99": num(sc, "p99="),
                       "launches": launches}
        log(f"run_multihost, one NCCL rank (ProcessGroupMesh, "
            f"uniform N={N_CLI_RANK}, {CLI_STEPS} steps): {sc}; "
            f"{len(energies)} Barnes-Hut energies ({energies[-1]}); {done}; "
            f"{found('recording:')[-1]}; "
            f"{found('sharded checkpoint:')[-1]}; launches {launches}; "
            f"{wall:.1f} s with start-up")
        # Its recording against the same run in this process on a
        # LocalMesh(1): the first frame bitwise, later ones within 0.1
        # (each delta add rounds once in f32).
        frames = list(playback_sharded(rec))
        mesh1 = par.LocalMesh(1, dev)
        w = DistributedWorld(multihost_state(scenario_chunk(
            "uniform", 0, 1, seed=0, n=N_CLI_RANK), mesh1, cfg), mesh1, cfg,
            rebalance_every=1000)
        worst = 0.0
        for k, (step, frame) in enumerate(frames):
            w.run(step - w.updates)
            want = w.state.pos.cpu().numpy()
            if k == 0 and not np.array_equal(frame.view(np.uint32),
                                             want.view(np.uint32)):
                raise RuntimeError(f"run_multihost recording: frame at "
                                   f"step {step} differs from the run")
            worst = max(worst, float(np.abs(frame - want).max()))
        steps = [s for s, _ in frames]
        if steps != list(range(2, CLI_STEPS + 1, 2)) or not worst <= 0.1:
            raise RuntimeError(f"run_multihost recording: steps {steps}, "
                               f"worst {worst}")
        log(f"run_multihost recording: frames at steps {steps}, the first "
            f"bitwise a LocalMesh(1) run's positions, the rest within "
            f"{worst:.3e} (bound 0.1)")
        del w, frames

        # -- the distributed main path's size on 8 local shards, saved and
        # resumed on 4
        d2 = tmp / "d2"
        found, wall = cli(
            "8 local shards", "--scenario", "uniform", "--n", str(N_DIST),
            "--steps", str(DIST_STEPS), "--rebalance-every",
            str(DIST_REBALANCE), "--local-shards", str(DIST_P),
            "--checkpoint-sharded", str(d2))
        done, saved = found("done:")[-1], found("sharded checkpoint:")[-1]
        launches = json.loads(found("launches:")[-1].split(":", 1)[1])
        nbytes = sum(f.stat().st_size for f in d2.iterdir())
        if (found("len:")[-1] != f"len: {N_DIST}" or not launches.get("K3")
                or not done.startswith(f"done: {DIST_STEPS} steps")):
            raise RuntimeError(f"run_multihost on {DIST_P} local shards: "
                               f"{done}; launches {launches}")
        out["local"] = {"steps_per_s": num(done, "s ("), "wall_s": wall,
                        "save_ms": num(saved, " in"), "bytes": nbytes,
                        "launches": launches}
        log(f"run_multihost --local-shards {DIST_P} (uniform N={N_DIST}, "
            f"{DIST_STEPS} steps, rebalance every {DIST_REBALANCE}): {done}; "
            f"{saved}, {nbytes} bytes in {len(list(d2.iterdir()))} files; "
            f"launches {launches}; {wall:.1f} s with start-up")
        mass2 = num(done, ", mass")
        found, wall = cli(
            "resume on 4 local shards", "--resume-sharded", str(d2),
            "--local-shards", "4", "--steps", str(CLI_RESUME_STEPS))
        done, resumed = found("done:")[-1], found("resumed:")[-1]
        ke = num(done, ", ke")
        if (found("len:")[-1] != f"len: {N_DIST}"
                or not done.startswith(f"done: {CLI_RESUME_STEPS} steps")
                or not math.isfinite(ke) or num(done, ", mass") != mass2):
            raise RuntimeError(f"run_multihost resume: {done}")
        out["resume"] = {"steps_per_s": num(done, "s ("), "wall_s": wall,
                         "load_ms": num(resumed, " in")}
        log(f"run_multihost --resume-sharded on 4 local shards: {resumed}; "
            f"{done}; {wall:.1f} s with start-up")
        # The resumed layout's live rows are the files' rows, bitwise.
        state, step = load_sharded_checkpoint(d2, par.LocalMesh(4, dev), cfg)
        live = state.compact()
        with np.load(d2 / "shard_00000.npz") as z:
            same = [np.array_equal(z[k].view(np.uint32), getattr(
                live, k).cpu().numpy().view(np.uint32))
                for k in ("pos", "vel", "mass")]
        if step != DIST_STEPS or not all(same):
            raise RuntimeError(f"sharded checkpoint load: step {step}, live "
                               f"rows (pos, vel, mass) bitwise {same}")
        log(f"load_sharded_checkpoint onto LocalMesh(4): step {step}, the "
            f"{live.n} live rows bitwise the file's")
        del state, live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase distributed CLI: {out['phase_s']:.1f} s")
    return out


GRAPH_PLAN = (10, 10, 10, "timed", 10, "dt", 10, 10, 3)   # 64 steps


def step_graph_phase(h):
    """``World.run``'s CUDA graphs against eager steps of the same start:
    the galaxy at θ=50 (Euler, and leapfrog: two force evaluations in one
    graph) and the 65,536-body Plummer cluster at θ=0.5, the benchmark's
    configurations. Each world runs ``GRAPH_PLAN``: batches of ``run``
    with a profiled step (``step_timed``) and a ``reconfigure(dt=0.05)``
    between them; its twin steps eagerly, one ``World._step`` at a time.
    ``pos``, ``vel``, ``mass`` and the frame at every batch end are held
    bitwise, and the sweep's launch count to the steps that ran. Logs the
    graphs captured, their capture seconds, the replay share, and 32
    steps' host time each way. Returns the capture seconds per case."""
    import dataclasses

    import torch

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models import World
    from nbody_simulation_tpu_torch.models.scenarios import galaxy, plummer
    from nbody_simulation_tpu_torch.ops import traversal
    from nbody_simulation_tpu_torch.ops.raster import render_frame
    from nbody_simulation_tpu_torch.utils.telemetry import Counting

    log, dev = h.log, h.dev
    t_phase = time.perf_counter()
    cases = (
        ("galaxy theta=50", lambda: galaxy(seed=0),
         SimConfig(force_path="bh")),
        ("galaxy theta=50 leapfrog", lambda: galaxy(seed=0),
         SimConfig(force_path="bh", integrator="leapfrog")),
        ("Plummer theta=0.5", lambda: plummer(N_PLUMMER, seed=0),
         SimConfig(force_path="bh", theta=0.5, unweighted_leaf_com=False)))

    def eager_run(world, n):
        for _ in range(n):
            world.state = world._step(world.state)
            world.updates += 1

    def sweeps():
        return (traversal.grouped_sweep.launches
                + traversal.grouped_sweep.quad_launches)

    def frame(world):
        st, cfg = world.state, world.config
        return render_frame(st.pos, st.vel, st.mass, cfg.world_size,
                            cfg.render_size, cfg.heavy_weight)

    out = {}
    for label, scenario, cfg in cases:
        start = scenario().to(dev)
        graphed, eager = World(start, cfg), World(start, cfg)
        counting = Counting()
        for k, item in enumerate(GRAPH_PLAN):
            if item == "timed":
                graphed.step_timed(counting)
                eager.step_timed(counting)
            elif item == "dt":
                graphed.reconfigure(dt=0.05)
                eager.reconfigure(dt=0.05)
                continue
            else:
                before = sweeps()
                graphed.run(item)
                per_step = 2 if cfg.integrator == "leapfrog" else 1
                if sweeps() - before != per_step * item:
                    raise RuntimeError(
                        f"step graphs, {label}: {sweeps() - before} sweep "
                        f"launches counted in {item} steps")
                eager_run(eager, item)
            for name in ("pos", "vel", "mass"):
                if not same_bits(getattr(graphed.state, name),
                                 getattr(eager.state, name)):
                    raise RuntimeError(
                        f"step graphs, {label}: {name} differs from eager "
                        f"stepping after batch {k} (step {graphed.updates})")
            if not torch.equal(frame(graphed), frame(eager)):
                raise RuntimeError(f"step graphs, {label}: the frame differs "
                                   f"after batch {k}")
        c = dataclasses.replace(graphed.graph_counts)  # before the timing
        if graphed.updates != 64 or c.captured < 2 or not c.replayed:
            raise RuntimeError(f"step graphs, {label}: {graphed.updates} "
                               f"steps, counts {c}")
        times = {}
        for way, go in (("replayed", graphed.run),
                        ("eager", functools.partial(eager_run, eager))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go(32)
            torch.cuda.synchronize()
            times[way] = (time.perf_counter() - t0) / 32 * 1e3
        log(f"step graphs, {label}: 64 steps bitwise eager stepping (pos, "
            f"vel, mass, frames at {len(GRAPH_PLAN) - 1} batch ends); "
            f"{c.captured} graphs captured in {c.capture_s:.4f} s, replay "
            f"share "
            f"{c.replay_share:.1%} ({c.replayed} replayed, {c.eager} eager); "
            f"32 more steps: {times['replayed']:.3f} ms a step replayed, "
            f"{times['eager']:.3f} ms eager")
        out[label] = c.capture_s
        del graphed, eager, start
        torch.cuda.empty_cache()
    log(f"phase step graphs: {time.perf_counter() - t_phase:.1f} s")
    return out


OVERLAP_BATCHES = 20      # batches whose frames are held to their states
OVERLAP_SEGMENT_S = 3.0   # one steady run of the engine-view loop
OVERLAP_TRACE_BATCHES = 4  # profiled after it


class _ProfileGate:
    """An engine's ``on_batch`` that, when asked, stops the producer at a
    batch end after a device sync while the calling thread starts, then
    stops, a CUDA-only profiler ``batches`` later (the profiler is never
    started or stopped while the producer launches work)."""

    def __init__(self):
        import threading
        self.k, self.at = 0, ()
        self.asked, self.done = threading.Event(), threading.Event()

    def __call__(self, world) -> None:
        import torch
        self.k += 1
        if self.k in self.at:
            torch.cuda.synchronize()
            self.asked.set()
            if not self.done.wait(timeout=300):
                raise RuntimeError("the profiler did not start or stop")
            self.done.clear()

    def profile(self, batches: int):
        import torch
        self.at = (self.k + 2, self.k + 2 + batches)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        for act in (prof.__enter__, lambda: prof.__exit__(None, None, None)):
            if not self.asked.wait(timeout=300):
                raise RuntimeError("the producer did not reach the batch")
            self.asked.clear()
            act()
            self.done.set()
        return prof


def _idle_per_batch(prof, batches: float):
    """(idle ms a batch, ms a batch in gaps over 0.5 ms) between the first
    and last device events of a CUDA-only profile, each event once."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA"))
    busy, end, wide = 0, None, 0
    for s, e in spans:
        if end is not None and s > end and s - end > 500_000:
            wide += s - end
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    idle = (spans[-1][1] - spans[0][0]) - busy
    return idle / 1e6 / batches, wide / 1e6 / batches


def engine_overlap_phase(h):
    """The engine's snapshot in flight on the card (``runtime/engine.py``):
    the enqueue of a snapshot returns before a 0.2-s sleep the card was
    given ends (nothing in the render or its copy waits for the device);
    on the galaxy at θ=50 and the 65,536-body Plummer cluster at θ=0.5
    (the benchmark's configurations) every frame of ``OVERLAP_BATCHES``
    batches, taken by a consumer thread, equals ``render_frame`` of the
    state at its batch end, copied by the ``on_batch`` hook, with the same
    step; then the engine-view loop (10 steps a snapshot, queue depth 2, a
    snapshot whenever the queue has room, a consumer popping each) in
    turns as a synchronous loop (each snapshot finished as it is enqueued,
    the order before the overlap) and as the engine runs it, for
    ``OVERLAP_SEGMENT_S`` each: ups from the frames received, the
    snapshot counts of that steady stretch (at least 99% overlapped), then
    the card's idle time a batch from a CUDA-only profile of
    ``OVERLAP_TRACE_BATCHES`` batches after it. Returns the numbers by case."""
    import dataclasses
    import threading

    import torch

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models import World
    from nbody_simulation_tpu_torch.models.scenarios import galaxy, plummer
    from nbody_simulation_tpu_torch.ops.raster import render_frame
    from nbody_simulation_tpu_torch.runtime.engine import Engine
    from nbody_simulation_tpu_torch.utils.telemetry import SnapshotCounts

    class SyncEngine(Engine):
        """The loop before the snapshot in flight: each snapshot finished
        as soon as it is enqueued, before the next batch."""

        def _snapshot(self):
            super()._snapshot()
            self._finish_snapshot()

    log, dev = h.log, h.dev
    t_phase = time.perf_counter()
    cases = (("galaxy theta=50", lambda: galaxy(seed=0),
              SimConfig(force_path="bh")),
             ("Plummer theta=0.5", lambda: plummer(N_PLUMMER, seed=0),
              SimConfig(force_path="bh", theta=0.5,
                        unweighted_leaf_com=False)))

    def frame_of(world, pos, vel, mass):
        cfg = world.config
        return render_frame(pos, vel, mass, cfg.world_size, cfg.render_size,
                            cfg.heavy_weight).cpu().numpy()

    def consume(eng, got):
        while (snap := eng.next_snapshot(timeout=120)) is not None:
            got.append((time.monotonic(), snap))

    out = {}
    for label, scenario, cfg in cases:
        world = World(scenario().to(dev), cfg)
        world.run(40)   # both step graphs captured
        # -- the enqueue does not wait for the card
        eng = Engine(world, queue_depth=4)
        eng._snapshot()
        eng._finish_snapshot()   # the host buffers made, the raster warm
        eng.queue.pop(0.0)
        torch.cuda.synchronize()
        cycles = int(0.2 * float(card_query("clocks.max.sm").split()[0])
                     * 1e6)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        eng._snapshot()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        pending = not eng._in_flight.event.query()
        eng._finish_snapshot()
        snap = eng.next_snapshot(timeout=0)
        st = world.state
        if not pending or enqueue_ms > 100:
            raise RuntimeError(
                f"engine overlap, {label}: the snapshot's enqueue took "
                f"{enqueue_ms:.2f} ms behind a 0.2-s sleep on the card "
                f"(copy still pending after it: {pending})")
        if snap is None or (snap.frame != frame_of(world, st.pos, st.vel,
                                                   st.mass)).any():
            raise RuntimeError(f"engine overlap, {label}: the frame of the "
                               "snapshot behind the sleep differs")
        del eng
        # -- every frame is the synchronous render of its state
        kept = {}

        def hook(w):
            s = w.state
            kept[w.updates] = (s.pos.clone(), s.vel.clone(), s.mass.clone())

        eng = Engine(world, queue_depth=OVERLAP_BATCHES + 2,
                     snapshot_interval=0.0, steps_per_snapshot=10,
                     on_batch=hook)
        got = []
        consumer = threading.Thread(target=consume, args=(eng, got),
                                    daemon=True)
        consumer.start()
        eng.start(max_steps=world.updates + 10 * OVERLAP_BATCHES)
        eng.join(timeout=300)
        eng.stop()
        consumer.join(timeout=120)
        kept[world.updates] = (world.state.pos, world.state.vel,
                               world.state.mass)
        steps = [s.step for _, s in got]
        if consumer.is_alive() or steps != sorted(steps) \
                or len(got) != OVERLAP_BATCHES + 1:
            raise RuntimeError(f"engine overlap, {label}: frames of steps "
                               f"{steps}")
        for _, s in got:
            if (s.frame != frame_of(world, *kept[s.step])).any():
                raise RuntimeError(f"engine overlap, {label}: the frame of "
                                   f"step {s.step} differs from the render "
                                   "of its state")
        c = eng.snapshot_counts
        log(f"engine overlap, {label}: {len(got)} frames (steps {steps[0]}-"
            f"{steps[-1]}) equal the synchronous render of their states, "
            f"pixel for pixel; snapshot counts {c}; the enqueue behind a "
            f"0.2-s sleep on the card returned in {enqueue_ms:.3f} ms")
        del kept, got, eng
        # -- the engine-view loop, synchronous and overlapped in turns
        rows = []
        for kind in ("sync", "overlap", "sync", "overlap"):
            cls = SyncEngine if kind == "sync" else Engine
            gate = _ProfileGate()
            eng = cls(world, queue_depth=2, snapshot_interval=0.0,
                      steps_per_snapshot=10, profile_every=50,
                      on_batch=gate)
            got = []
            consumer = threading.Thread(target=consume, args=(eng, got),
                                        daemon=True)
            consumer.start()
            eng.start()
            time.sleep(0.5)
            n0, c0 = len(got), dataclasses.replace(eng.snapshot_counts)
            time.sleep(OVERLAP_SEGMENT_S)
            n1 = len(got)
            c1 = dataclasses.replace(eng.snapshot_counts)
            prof = gate.profile(OVERLAP_TRACE_BATCHES)
            eng.stop()
            consumer.join(timeout=120)
            wall = got[n1 - 1][0] - got[n0][0]
            ups = (got[n1 - 1][1].step - got[n0][1].step) / wall
            steady = SnapshotCounts(
                c1.overlapped - c0.overlapped, c1.flushed - c0.flushed,
                c1.wait_s - c0.wait_s, c1.pack_s - c0.pack_s)
            idle, wide = _idle_per_batch(prof, OVERLAP_TRACE_BATCHES)
            del prof
            done = steady.overlapped + steady.flushed
            share = steady.overlapped / max(done, 1)
            if kind == "overlap" and share < 0.99:
                raise RuntimeError(f"engine overlap, {label}: {share:.1%} of "
                                   f"the steady run's snapshots overlapped")
            rows.append({"kind": kind, "ups": ups, "overlapped": share,
                         "wait_share": steady.wait_s / wall,
                         "pack_ms": steady.pack_s / max(done, 1) * 1e3,
                         "idle_ms_per_batch": idle,
                         "gaps_over_0.5ms_per_batch": wide})
            log(f"engine overlap, {label}, {kind}: ups {ups:.2f}; steady "
                f"snapshots {done}, {share:.1%} overlapped, waited "
                f"{steady.wait_s:.3f} s ({steady.wait_s / wall:.1%} of "
                f"{wall:.2f} s), packing {rows[-1]['pack_ms']:.2f} ms a "
                f"frame; card idle {idle:.3f} ms a batch ({wide:.3f} ms of "
                f"it in gaps over 0.5 ms) over {OVERLAP_TRACE_BATCHES} "
                "traced batches")
            del eng, got
        out[label] = rows
        del world
        torch.cuda.empty_cache()
    log(f"phase engine overlap: {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this check "
                         "needs a GPU")
    try:
        import nbody_simulation_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit("chip_smoke: the nbody_simulation_tpu_torch package "
                         "is missing; run from the root of the repository "
                         f"({e})")
    from nbody_simulation_tpu_torch.config import RCP_MODES, SimConfig
    from nbody_simulation_tpu_torch.cuda_build import library_path
    from nbody_simulation_tpu_torch.models import World
    from nbody_simulation_tpu_torch.models.scenarios import (galaxy, plummer,
                                                             uniform_disc)
    from nbody_simulation_tpu_torch.ops import allpairs as ap
    from nbody_simulation_tpu_torch.ops import allpairs_grad as agr
    from nbody_simulation_tpu_torch.ops import energy as en
    from nbody_simulation_tpu_torch.ops import split
    from nbody_simulation_tpu_torch.ops import traversal
    from nbody_simulation_tpu_torch.ops import traversal_grad as tgr
    from nbody_simulation_tpu_torch.ops.force import direct_accel, pair_accel
    from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
    from nbody_simulation_tpu_torch.ops.tree import (build_tree,
                                                     summarize_sorted)
    from nbody_simulation_tpu_torch.utils.telemetry import Counting

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg: str) -> None:
        print(f"{msg}  [{card}]", flush=True)

    # -- 1. environment and build ---------------------------------------------
    log(f"card: {card}; torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    banned = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "nbody_simulation_tpu."))
              or m == "nbody_simulation_tpu"]
    if banned:
        raise RuntimeError(f"JAX or the JAX package was imported: {banned}")
    loaders = {"grouped_sweep": traversal._load_sweep_lib,
               "allpairs": ap._load_lib, "force_grad": agr._load_lib,
               "segment_sum": traversal._load_segment_lib}

    def build(name):
        t = time.perf_counter()
        loaders[name]()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        build_s = dict(zip(loaders, pool.map(build, loaders)))
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s, in "
        "parallel: " + ", ".join(f"{k} {v:.2f} s ({library_path(k).name})"
                                 for k, v in build_s.items()))

    if "--only-step-graphs" in sys.argv[1:]:
        # A developer's run of the step graphs' phase alone; no result line.
        step_graph_phase(types.SimpleNamespace(log=log, dev=dev))
        return 0

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk_hz = float(card_query("clocks.max.sm").split()[0]) * 1e6
    log(f"{sms} SMs at a maximum SM clock of {clk_hz / 1e6:.0f} MHz: FP32 "
        f"{sms * FP32_PER_SM_CLK * clk_hz:.4e} op/s, MUFU "
        f"{sms * MUFU_PER_SM_CLK * clk_hz:.4e} op/s")

    def bound(form: str, rcp: str, pairs: float, nbytes: float,
              lib: str, function: str):
        """(bound_ms, bound_by, note): the larger of the bytes over the
        memory rate and the law's pair work (``law_ops`` and ``law_mufu``
        per pair) over the FP32 and MUFU rates. The note gives the three
        times and, beside them, the instructions per pair in the hot loop
        of ``function`` as built, which the bound does not use."""
        ops, mufu = law_ops(form, rcp), law_mufu(form)
        t_fp32 = pairs * ops / (sms * FP32_PER_SM_CLK * clk_hz)
        t_mufu = pairs * mufu / (sms * MUFU_PER_SM_CLK * clk_hz)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = max(t_fp32, t_mufu)
        try:
            built = "{:.2f} instructions and {:.2f} MUFU per pair".format(
                *sass_per_pair(library_path(lib), function))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            built = f"not counted: {e}"
        note = (f"{pairs:.4e} pairs, law {ops} FP32 + {mufu} MUFU per pair: "
                f"FP32 {t_fp32 * 1e3:.4f} ms, MUFU {t_mufu * 1e3:.4f} ms, bytes "
                f"{t_bytes * 1e3:.4f} ms; built hot loop {built}")
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes", note)

    def sym_plan(label: str, n: int, rcp: str, self_pairs: bool) -> None:
        """Log the launches of one K2 (``self_pairs``) or K9 call on n
        particles: round launches (each followed by a fold), rounds and
        blocks per launch, and the round kernel's resident blocks per SM as
        the CUDA runtime gives them."""
        plan = ap.sym_launch_plan(n, dev, rcp, self_pairs)
        blocks = plan.schedule.launches[:, 1]
        resident = plan.blocks_per_sm * sms
        log(f"{label} (n={n}, rcp={rcp}): {len(blocks)} launches of the "
            f"round kernel per call, each followed by a fold, then one "
            f"finish; {plan.rounds_per_launch} rounds and {blocks.min()} to "
            f"{blocks.max()} blocks of {plan.threads_per_block} threads per "
            f"launch; {plan.blocks_per_sm} resident blocks per SM "
            f"({resident} on the card: {blocks.max() / resident:.2f} waves "
            f"per launch)")

    def timed_ms(fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def abs_sum(tgt, sx, sy, sm, col_limit=None):
        """Σ_j |c_ij| per target and component (over the columns below
        ``col_limit``, if given), for the tolerances; groups go in chunks
        of ~2^24 pairs."""
        out = torch.empty_like(tgt)
        nc = sx.shape[1]
        chunk = max(1, (1 << 24) // max(1, tgt.shape[1] * nc))
        cols = torch.arange(nc, device=tgt.device)
        for g0 in range(0, tgt.shape[0], chunk):
            sl = slice(g0, g0 + chunk)
            ax, ay = pair_accel(sx[sl, None, :] - tgt[sl, :, 0:1],
                                sy[sl, None, :] - tgt[sl, :, 1:2],
                                sm[sl, None, :], SOFTENING2)
            if col_limit is not None:
                keep = (cols[None, :] < col_limit[sl, None])[:, None, :]
                ax, ay = (torch.where(keep, a, 0.0) for a in (ax, ay))
            out[sl, :, 0] = ax.abs().sum(-1)
            out[sl, :, 1] = ay.abs().sum(-1)
        return out

    def quad_abs_sum(tgt, sx, sy, sm, sq):
        """Σ_j (|dx·w| + |corr|) per target and component, for K4's
        tolerance: the quadrupole law with Q = 0 is the monopole term, with
        m = 0 the correction. Groups go in chunks of ~2^25 pairs."""
        out = torch.empty_like(tgt)
        chunk = max(1, (1 << 25) // (tgt.shape[1] * sx.shape[1]))
        for g0 in range(0, tgt.shape[0], chunk):
            sl = slice(g0, g0 + chunk)
            dx = sx[sl, None, :] - tgt[sl, :, 0:1]
            dy = sy[sl, None, :] - tgt[sl, :, 1:2]
            zero = torch.zeros_like(dx)
            mono = traversal.quad_tile(dx, dy, sm[sl, None, :], zero, zero,
                                       zero, SOFTENING2)
            corr = traversal.quad_tile(dx, dy, zero,
                                       *(q[sl, None, :] for q in sq),
                                       SOFTENING2)
            for k in range(2):
                out[sl, :, k] = (mono[k].abs() + corr[k].abs()).sum(-1)
        return out

    def abs_terms(dx, dy, mj, e):
        ax, ay = pair_accel(dx, dy, mj, e)
        return ax.abs(), ay.abs()

    def hold(label, got, want, scale):
        """Fail unless |got - want| <= SUM_ORDER_RTOL * scale everywhere;
        return the max |d|."""
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{label}: non-finite kernel output")
        err = (got - want).abs()
        ratio = (err / scale.clamp_min(1e-30)).max().item()
        log(f"{label}: max |d| {err.max().item():.3e}, max |d|/sum|c| "
            f"{ratio:.3e} (bound {SUM_ORDER_RTOL:g})")
        if not bool((err <= SUM_ORDER_RTOL * scale).all()):
            raise RuntimeError(f"{label}: kernel disagrees with the plain "
                               f"version: max |d|/sum|c| {ratio:.3e}")
        return err.max().item()

    def trace_steps(label, world, steps=4):
        """Trace ``steps`` steps of ``world`` with torch.profiler and log
        the device time and device operations per step and the sweep
        kernel's share (the CUPTI trace; untraced rates are taken apart)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            world.run(steps)
            torch.cuda.synchronize()
        total = device_ms(prof) / steps
        sweep = device_ms(prof, "grouped_sweep_kernel",
                          "quad_sweep_kernel") / steps
        fold = device_ms(prof, "quad_fold") / steps
        ops = sum(1 for e in prof.events() if on_device(e))
        if total <= 0 or sweep <= 0:
            raise RuntimeError(f"{label} trace: device time {total} ms, sweep "
                               f"kernel {sweep} ms per step: the profiler "
                               "recorded no device time for the step or the "
                               "sweep kernel")
        log(f"{label} trace ({steps} steps): device time {total:.3f} ms per "
            f"step in {ops / steps:.0f} device operations (summed over every "
            f"profiler entry: {all_entries_ms(prof) / steps:.3f} ms); sweep "
            f"kernel "
            f"{sweep:.3f} ms ({sweep / total:.0%})"
            + (f" and K4's fold {fold:.3f} ms" if fold else "")
            + f", the rest (sort, tree, planner, integration) "
            f"{total - sweep - fold:.3f} ms")

    def plain_timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def path_inputs(state, c):
        """The sweep's inputs on a Barnes-Hut World's path at config ``c``
        (a re-sorting step of ``World._bh_step``): the sorted positions and
        masses, the tree, and ``traversal.sweep_inputs``."""
        spos, _, smass = morton_sort_state(
            state.pos, state.vel, state.mass, c.world_size,
            bits=c.resolved_morton_bits())
        tree = summarize_sorted(spos, smass, leaf_size=c.leaf_size,
                                unweighted_leaf_com=c.unweighted_leaf_com,
                                quad=c.resolved_multipole() == 2)
        fcap, lcap = c.resolved_caps()
        return spos, smass, tree, traversal.sweep_inputs(
            tree, c.theta, fcap, lcap, arity=c.tree_arity,
            plan_leaves=c.plan_leaves, multipole=c.resolved_multipole())

    def grad_magnitudes(xi, yi, gx, gy, xj, yj, mj):
        """|m·r·g| + |m·r²·t·(psign·q + 2sκ·d)| per component, and |r·t|:
        the magnitudes the rounding of u and r·t scales with. u itself is
        a poor scale: inside the softening its two terms cancel (for d
        along g exactly), and on the galaxy's K8 shape the plain f32
        version lies 5.1e-4·Σ|u| from an f64 truth but 5.6e-7 of these
        sums (CPU run)."""
        dx, dy = xj - xi, yj - yi
        s, q, r, kappa = agr.pair_terms(dx, dy, SOFTENING2)
        mr = mj * r
        mr2t = (mj * (r * r) * (dx * gx + dy * gy)).abs()
        two_sk = 2.0 * s * kappa
        return ((mr * gx).abs() + mr2t * (q + (two_sk * dx).abs()),
                (mr * gy).abs() + mr2t * (q + (two_sk * dy).abs()),
                (r * (dx * gx + dy * gy)).abs())

    def hold_seg(label, calls):
        """The segmented sum at each (n_rows, idx, src) of ``calls``, sorted
        as ``index_add_ordered`` sorts, against its plain version: within
        1e-6 of each row's Σ|x| (both add each run in f64 and round once,
        in other orders), two calls bitwise, rows no index names +0.
        Returns (max |d|, the largest call as (n_rows, idx, flat, key,
        perm))."""
        err_max, big, shapes = 0.0, None, set()
        for n_rows, idx, src in calls:
            flat = src.reshape(src.shape[0], math.prod(src.shape[1:]))
            flat = flat.contiguous()
            key, perm = torch.sort(idx, stable=True)
            got = traversal.segment_sum_cuda(flat, key, perm, n_rows)
            again = traversal.segment_sum_cuda(flat, key, perm, n_rows)
            want = traversal.segment_sum_ref(flat, key, perm, n_rows)
            scale = traversal.segment_sum_ref(flat.abs(), key, perm,
                                              n_rows).double()
            empty = torch.bincount(key, minlength=n_rows) == 0
            err = ((got.double() - want.double()).abs()
                   / scale.clamp_min(1e-30)).max().item() if got.numel() \
                else 0.0
            if not (same_bits(got, again) and err <= 1e-6 and bool(
                    (got[empty].view(torch.int32) == 0).all())):
                raise RuntimeError(
                    f"segment_sum at {label}, K={flat.shape[0]}, W="
                    f"{flat.shape[1]}, rows={n_rows}, {key.dtype}: {err} of "
                    "sum|x| from the plain version, two calls differ, or a "
                    "row with no entry is not +0")
            if got.numel():
                err_max = max(err_max, (got - want).abs().max().item())
            shapes.add((flat.shape[0], flat.shape[1], n_rows))
            if big is None or flat.numel() > big[2].numel():
                big = (n_rows, idx, flat, key, perm)
        log(f"segment_sum at {label}: {len(calls)} calls, {len(shapes)} "
            f"shapes (K, W, rows) {sorted(shapes)}: every one within 1e-6 of "
            f"sum|x| of the plain version (max |d| {err_max:.3e}), bitwise "
            "on two calls, rows with no entry +0")
        return err_max, big

    def hold_k8(label, k8in):
        """K8a and K8b against their plain versions on ``k8in`` = (tgt,
        gbar, src_x, src_y, src_m), every output, bounded relative to the
        sums of ``grad_magnitudes``; with their times and bounds. Returns
        {"K8a": ..., "K8b": ...} of (max |d|, kernel ms, plain ms,
        bound)."""
        kt, kgb, kx, ky, km = k8in
        kg, ks, _ = kt.shape
        kc = kx.shape[1]
        scale = [torch.empty_like(kt)] + [torch.empty_like(kx)
                                          for _ in range(3)]
        chunk = max(1, (1 << 25) // (ks * kc))
        for g0 in range(0, kg, chunk):
            sl = slice(g0, g0 + chunk)
            ux, uy, rt = grad_magnitudes(
                kt[sl, :, 0:1], kt[sl, :, 1:2], kgb[sl, :, 0:1],
                kgb[sl, :, 1:2], kx[sl, None], ky[sl, None], km[sl, None])
            scale[0][sl] = torch.stack([ux.sum(-1), uy.sum(-1)], -1)
            for k, term in enumerate((ux, uy, rt)):
                scale[k + 1][sl] = term.sum(1)
        want_t, tgt_plain_ms = plain_timed(
            lambda: tgr.grouped_bwd_tgt_ref(*k8in, SOFTENING2))
        want_s, src_plain_ms = plain_timed(
            lambda: tgr.grouped_bwd_src_ref(*k8in, SOFTENING2))
        got_t = tgr.grouped_bwd_tgt_cuda(*k8in, SOFTENING2)
        got_s = tgr.grouped_bwd_src_cuda(*k8in, SOFTENING2)
        again_t = tgr.grouped_bwd_tgt_cuda(*k8in, SOFTENING2)
        again_s = tgr.grouped_bwd_src_cuda(*k8in, SOFTENING2)
        torch.cuda.synchronize()
        if not (torch.equal(got_t, again_t) and all(
                torch.equal(a, b) for a, b in zip(got_s, again_s))):
            raise RuntimeError(f"{label}: two K8 calls on the same input "
                               "differ")
        err_a = hold(f"{label}: grouped_bwd_tgt vs plain, bound relative to "
                     "sum(|m r g|+|m r^2 t (..)|); two calls bitwise",
                     got_t, want_t, scale[0])
        err_b = max(hold(f"{label}: grouped_bwd_src {lab} vs plain, bound "
                         "relative to " + ("sum|r t|" if lab == "m" else
                                           "sum(|m r g|+|m r^2 t (..)|)"),
                         got, want, sc)
                    for lab, got, want, sc in zip("xym", got_s, want_s,
                                                  scale[1:]))
        del want_t, want_s, scale, got_t, got_s, again_t, again_s
        ms_a = timed_ms(lambda: tgr.grouped_bwd_tgt_cuda(*k8in, SOFTENING2),
                        reps=20)
        ms_b = timed_ms(lambda: tgr.grouped_bwd_src_cuda(*k8in, SOFTENING2),
                        reps=20)
        pairs = float(kg) * ks * kc
        in_bytes = 4.0 * (4 * kg * ks + 3 * kg * kc)
        bound_a = bound("grad_i", "newton", pairs, in_bytes + 8.0 * kg * ks,
                        "force_grad", "grouped_bwd_tgt")
        bound_b = bound("grad_j", "newton", pairs, in_bytes + 12.0 * kg * kc,
                        "force_grad", "grouped_bwd_src")
        for name, ms, pl_ms, bd in (
                ("grouped_bwd_tgt (K8a)", ms_a, tgt_plain_ms, bound_a),
                ("grouped_bwd_src (K8b)", ms_b, src_plain_ms, bound_b)):
            log(f"{label}: {name} kernel {ms:.4f} ms, plain {pl_ms:.3f} ms "
                f"(once), bound {bd[0]:.4f} ms by {bd[1]} ({bd[2]})")
        return {"K8a": (err_a, ms_a, tgt_plain_ms, bound_a),
                "K8b": (err_b, ms_b, src_plain_ms, bound_b)}

    # -- 2. K3: sweep kernel vs plain version at the main path's shapes -------
    t_phase = time.perf_counter()
    cfg = SimConfig(force_path="bh")
    *_, (tgt, (sx, sy, sm), _, lim) = path_inputs(
        galaxy(seed=0).to(dev).pad_to(256), cfg)
    g, s, _ = tgt.shape
    c = sx.shape[1]
    log(f"galaxy sweep shape: G={g} S={s} C={c} "
        f"({g * s * c / 1e6:.1f}M pairs)")
    if (g, s, c) != (1024, 256, 1280):
        raise RuntimeError(f"unexpected main-path shape {(g, s, c)}")
    log(f"per-group bound: mean last nonzero column "
        f"{lim.float().mean().item():.1f} of {c} "
        f"({lim.sum().item() / (g * c):.3f} of the full sweep's pairs)")
    main_rcp = cfg.resolved_rcp(bh=True)
    main_mode = RCP_MODES.index(main_rcp)
    sweep_lib = traversal._load_sweep_lib()

    def mono_grid(label, gg, ss, cc, mode):
        """Log K3's grid for a (G, S, C) call in ``mode``."""
        plan = traversal.mono_launch_plan(gg, ss, cc, dev, mode)
        shape = split.launch_shape(sweep_lib.grouped_sweep_shape, dev, ss,
                                   mode)
        regs = ctypes.c_int(0)
        if sweep_lib.grouped_sweep_regs(mode, 0, ctypes.byref(regs)) != 0:
            raise RuntimeError("grouped_sweep_regs failed")
        log(f"{label}: K3 grid {gg * plan.tpg} blocks ({plan.tpg} per "
            f"group) of {plan.threads} threads = {plan.lanes} target lanes "
            f"x {plan.slices} column slices, {plan.targets} targets per "
            f"thread; {shape.blocks_per_sm} resident blocks per SM "
            f"({gg * plan.tpg / shape.resident_blocks:.2f} waves); "
            f"{regs.value} registers per thread")

    def hold_mono(label, inputs, modes):
        """K3 against its plain version (exact) on ``inputs`` = (tgt, sx,
        sy, sm, col_limit) in each of ``modes``: bounded == full and two
        calls bitwise, within SUM_ORDER_RTOL of sum|c| below the bound.
        Returns the max |d| per mode."""
        mt, mx, my, mm, ml = inputs
        mg, ms_, _ = mt.shape
        mono_grid(label, mg, ms_, mx.shape[1], RCP_MODES.index(modes[0]))
        mplain = traversal.grouped_force_ref(mt, mx, my, mm, SOFTENING2,
                                             col_limit=ml)
        mscale = abs_sum(mt, mx, my, mm, col_limit=ml)
        errs = {}
        for rcp in modes:
            full = traversal.grouped_sweep(mt, mx, my, mm, SOFTENING2, rcp)
            bounded = traversal.grouped_sweep(mt, mx, my, mm, SOFTENING2,
                                              rcp, col_limit=ml)
            torch.cuda.synchronize()
            again = traversal.grouped_sweep(mt, mx, my, mm, SOFTENING2, rcp,
                                            col_limit=ml)
            torch.cuda.synchronize()
            if not torch.equal(full.view(torch.int32),
                               bounded.view(torch.int32)):
                raise RuntimeError(f"{label} {rcp}: bounded sweep differs "
                                   "from the full sweep")
            if not torch.equal(bounded.view(torch.int32),
                               again.view(torch.int32)):
                raise RuntimeError(f"{label} {rcp}: two calls on the same "
                                   "input differ")
            errs[rcp] = hold(f"{label}: grouped_sweep rcp={rcp} vs plain "
                             "(exact); bounded == full, two calls bitwise",
                             bounded, mplain, mscale)
        return errs

    max_abs_err = hold_mono("galaxy (1024, 256, 1280)", (tgt, sx, sy, sm, lim),
                            [main_rcp] + [r for r in RCP_MODES
                                          if r != main_rcp])

    # The other shapes K3 runs at, as the entry points give them: the first
    # K3 launch of each captured (the recorder launches it as it is).
    def captured(fn):
        seen = []
        real = traversal.mono_sweep

        def record(lib, tg, x_, y_, m_, col_limit, soft2, mode, lanes,
                   allow_fast=True):
            if not seen:
                seen.append(((tg, x_, y_, m_, col_limit), RCP_MODES[mode]))
            return real(lib, tg, x_, y_, m_, col_limit, soft2, mode, lanes,
                        allow_fast)
        traversal.mono_sweep = record
        try:
            with torch.no_grad():
                fn()
        finally:
            traversal.mono_sweep = real
        if not seen:
            raise RuntimeError("no monopole sweep call was captured")
        return seen[0]

    from nbody_simulation_tpu_torch import parallel as par
    gal_k3 = galaxy(seed=0).to(dev)
    disc_k3 = uniform_disc(N_BIG, seed=0).to(dev)
    mesh4_k3 = par.LocalMesh(4, dev)
    st4_k3 = par.shard_state(galaxy(seed=0), mesh4_k3)
    ms_paths = {}
    for label, fn in (
            ("bh_accel_diff galaxy", lambda: tgr.bh_accel_diff(
                gal_k3.pos, gal_k3.mass)),
            ("bh_sharded P=4 shard", lambda: par.bh_sharded_accel(
                st4_k3.pos, st4_k3.mass, mesh4_k3, config=cfg)),
            (f"bh_accel_diff disc N={N_BIG}", lambda: tgr.bh_accel_diff(
                disc_k3.pos, disc_k3.mass))):
        inputs, rcp = captured(fn)
        label = f"{label} {tuple(inputs[0].shape[:2]) + (inputs[1].shape[1],)}"
        hold_mono(label, inputs, [rcp])
        ms_paths[label] = timed_ms(lambda: traversal.grouped_sweep(
            *inputs[:4], SOFTENING2, rcp, col_limit=inputs[4]), reps=20)
        log(f"{label}: kernel rcp={rcp} bounded {ms_paths[label]:.4f} ms")
    del gal_k3, disc_k3, st4_k3, mesh4_k3

    # Ragged shapes, S up to 2048 (ROADMAP's forest rows), and the empty
    # ones: C=0 writes zeros; G=0 or S=0 launches nothing.
    krng = np.random.default_rng(4)

    def cloud(gg, ss, cc):
        ct = torch.tensor(krng.uniform(0, 1e5, (gg, ss, 2)).astype(
            np.float32), device=dev)
        cx, cy = (torch.tensor(krng.uniform(0, 1e5, (gg, cc)).astype(
            np.float32), device=dev) for _ in range(2))
        cm = torch.tensor(krng.integers(1, 100, (gg, cc)).astype(np.float32),
                          device=dev)
        for gi in range(gg):
            cm[gi, int(krng.integers(0, cc + 1)):] = 0.0
        return ct, cx, cy, cm, traversal.last_nonzero_columns(cm)

    for shape in ((5, 7, 1), (3, 300, 70), (4, 1, 70), (8, 2048, 1280)):
        hold_mono(f"ragged {shape}", cloud(*shape), RCP_MODES)
    for shape in ((4, 16, 0), (0, 16, 32), (4, 0, 32)):
        ct, cx, cy, cm, _ = cloud(*shape)
        before = traversal.grouped_sweep.launches
        out = traversal.grouped_sweep(ct, cx, cy, cm, SOFTENING2, main_rcp)
        torch.cuda.synchronize()
        launched = traversal.grouped_sweep.launches - before
        if out.shape != ct.shape or bool(out.ne(0).any()) or bool(
                torch.signbit(out).any()) or launched != int(ct.numel() > 0):
            raise RuntimeError(f"empty shape {shape}: output "
                               f"{tuple(out.shape)}, launches {launched}")
        log(f"empty shape {shape}: +0 output of {tuple(out.shape)}, "
            f"{launched} launches")

    # The special-case set: one call whose groups each hold one special
    # input, the others within the tile bound (the fast form), against the
    # same launch with the fast form off, bitwise.
    ct, cx, cy, cm, _ = cloud(10, 64, 96)
    cm.clamp_(min=1.0)
    cx[0, 5] = float("nan")                          # a NaN coordinate
    cy[1, 6] = float("inf")                          # an inf coordinate
    cx[2, 7] = 2.0 ** 50                             # |x| = 2^50
    cx[3, 8], cy[3, 8] = ct[3, 9, 0], ct[3, 9, 1]    # a coincident pair
    ct[4, 0] = 0.0                                   # den = 2^-117 * 1e-3,
    cx[4, 0], cy[4, 0] = 2.0 ** -117, 0.0            # in [2^-128, 2^-126)
    cm[5, 3] = float("inf")                          # an inf mass
    ct[6, 3, 0] = float("nan")                       # a NaN target
    climit = traversal.last_nonzero_columns(cm)
    lanes = traversal.mono_launch_plan(10, 64, 96, dev, main_mode).lanes
    for soft2 in (SOFTENING2, 1e-30):                # and a tiny softening
        for mode, rcp in enumerate(RCP_MODES):
            runs = [traversal.mono_sweep(sweep_lib, ct, cx, cy, cm, climit,
                                         soft2, mode, lanes, allow_fast=fast)
                    for fast in (True, False)]
            torch.cuda.synchronize()
            if any(err for err, _ in runs) or not torch.equal(
                    runs[0][1].view(torch.int32),
                    runs[1][1].view(torch.int32)):
                raise RuntimeError(f"K3 special cases, eps={soft2:g}, {rcp}:"
                                   " the fast form differs from the general "
                                   "law")
    log("K3 special cases (NaN and inf coordinates, |x|=2^50, a coincident "
        "pair, den in [2^-128, 2^-126), an inf mass, a NaN target; eps 1e-3 "
        "and 1e-30) in five modes: the fast form bitwise the general law in "
        "one call")

    ms_full = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, main_rcp), reps=50)
    ms_bound = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, main_rcp, col_limit=lim), reps=50)
    ms_exact = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, "exact", col_limit=lim), reps=50)
    ms_plain = timed_ms(lambda: traversal.grouped_force_ref(
        tgt, sx, sy, sm, SOFTENING2), reps=5, warmup=1)
    sweep_pairs = float(lim.sum().item()) * s
    sweep_bytes = 4.0 * (3 * lim.sum().item() + 4 * g * s) + 4 * g
    sweep_bound = bound("sweep", main_rcp, sweep_pairs, sweep_bytes,
                        "grouped_sweep",
                        f"grouped_sweep_kernelILi{main_mode}EE")
    log(f"sweep time at (1024, 256, 1280): kernel rcp={main_rcp} full "
        f"{ms_full:.4f} ms, bounded {ms_bound:.4f} ms; kernel exact bounded "
        f"{ms_exact:.4f} ms; plain torch {ms_plain:.3f} ms; bound "
        f"{sweep_bound[0]:.4f} ms by {sweep_bound[1]} ({sweep_bound[2]})")
    log(f"phase monopole sweep: {time.perf_counter() - t_phase:.1f} s")

    # -- 2b. K4: quadrupole sweep vs plain version at the θ<2 shapes ----------
    def hold_quad(label, inputs, modes, quad_rcp, reps=10):
        """K4 against its plain version on ``inputs`` (``sweep_inputs``'s)
        in each of ``modes``, bounded == full bitwise. Returns the max |d|
        per mode, the plain version's time, K4's bounded and full times in
        ``quad_rcp``, and its bound there."""
        qtgt, (qx, qy, qm), qq, qlim = inputs
        qg, qs, _ = qtgt.shape
        qc = qx.shape[1]
        qmode = RCP_MODES.index(quad_rcp)
        plan = traversal.quad_launch_plan(qg, qs, qc, dev, qmode)
        qshape = traversal.quad_launch_shape(qs, dev, qmode)
        live = int(((qlim + plan.chunk - 1) // plan.chunk).sum()) * plan.tpg
        resident = qshape.resident_blocks
        log(f"{label}: G={qg} S={qs} C={qc} ({qg * qs * qc / 1e6:.1f}M "
            f"pairs, {qlim.sum().item() * qs / 1e6:.1f}M within the "
            f"per-group bounds); K4 grid: {plan.tpg} blocks of "
            f"{plan.threads} threads x {plan.targets} targets per group, "
            f"{plan.chunks} chunks of {plan.chunk} columns, "
            f"{qshape.blocks_per_sm} resident blocks per SM: "
            f"{qg * plan.tpg * plan.chunks / resident:.2f} waves full, "
            f"{live / resident:.2f} bounded")
        qplain, plain_ms = plain_timed(lambda: traversal.grouped_force_ref(
            qtgt, qx, qy, qm, SOFTENING2, src_q=qq))
        qscale = quad_abs_sum(qtgt, qx, qy, qm, qq)
        errs = {}
        for rcp in modes:
            full = traversal.grouped_sweep(qtgt, qx, qy, qm, SOFTENING2, rcp,
                                           src_q=qq)
            bounded = traversal.grouped_sweep(qtgt, qx, qy, qm, SOFTENING2,
                                              rcp, col_limit=qlim, src_q=qq)
            torch.cuda.synchronize()
            again = traversal.grouped_sweep(qtgt, qx, qy, qm, SOFTENING2,
                                            rcp, col_limit=qlim, src_q=qq)
            torch.cuda.synchronize()
            if not torch.equal(full, bounded):
                raise RuntimeError(f"{label}, quad {rcp}: bounded sweep "
                                   "differs from the full sweep (max "
                                   f"{(full - bounded).abs().max()})")
            if not torch.equal(bounded.view(torch.int32),
                               again.view(torch.int32)):
                raise RuntimeError(f"{label}, quad {rcp}: two calls on the "
                                   "same input differ")
            errs[rcp] = hold(f"{label}: grouped_sweep quad rcp={rcp} vs plain"
                             " (exact), bound relative to sum(|dx w|+|corr|);"
                             " bounded == full bitwise, two calls bitwise",
                             full, qplain, qscale)
        del qplain, qscale, full, bounded, again
        ms_full = timed_ms(lambda: traversal.grouped_sweep(
            qtgt, qx, qy, qm, SOFTENING2, quad_rcp, src_q=qq), reps=reps)
        ms_bound = timed_ms(lambda: traversal.grouped_sweep(
            qtgt, qx, qy, qm, SOFTENING2, quad_rcp, col_limit=qlim,
            src_q=qq), reps=reps)
        qpairs = float(qlim.sum().item()) * qs
        qbytes = 4.0 * (6 * qlim.sum().item() + 4 * qg * qs) + 4 * qg
        bd = bound("quad", quad_rcp, qpairs, qbytes, "grouped_sweep",
                   f"quad_sweep_kernelILi{RCP_MODES.index(quad_rcp)}EE")
        log(f"{label}: kernel rcp={quad_rcp} full {ms_full:.4f} ms, bounded "
            f"{ms_bound:.4f} ms; plain torch {plain_ms:.3f} ms (once); bound "
            f"{bd[0]:.4f} ms by {bd[1]} ({bd[2]})")
        return errs, plain_ms, ms_bound, ms_full, bd

    helpers = types.SimpleNamespace(
        log=log, dev=dev, hold=hold, hold_mono=hold_mono, hold_quad=hold_quad,
        hold_k8=hold_k8, hold_seg=hold_seg, timed_ms=timed_ms,
        plain_timed=plain_timed,
        bound=bound, softening2=SOFTENING2,
        rcp_modes=RCP_MODES)
    if "--only-distributed" in sys.argv[1:]:
        # A developer's run of the distributed phase alone (after the
        # monopole sweep's); no result line.
        launches, rows = distributed_phase(helpers)
        log(f"distributed BH launches per kernel: {json.dumps(launches)}")
        cli_phase(helpers)
        return 0

    # The 65,536-body Plummer cluster at θ=0.5 with mass-weighted leaf COMs:
    # first with one leaf per planning row, the JAX package's force-error
    # configuration (benchmarks/suite.py config 2; 64-thread blocks), then
    # at the CLI's own config (plan_leaves=4, 256-thread blocks), then the
    # θ=0.5 galaxy's columns, the widest.
    t_phase = time.perf_counter()
    pst = plummer(N_PLUMMER, seed=0).to(dev).pad_to(256)
    qcfg = SimConfig(force_path="bh", theta=0.5, plan_leaves=1,
                     unweighted_leaf_com=False)
    quad_rcp = qcfg.resolved_rcp(bh=True)
    qpos, qmass, qtree, qin = path_inputs(pst, qcfg)
    if qin[0].shape[1] != 64:
        raise RuntimeError(f"plan_leaves=1 targets per group {qin[0].shape}")
    hold_quad(f"quadrupole sweep, Plummer N={N_PLUMMER}, theta=0.5, "
              "plan_leaves=1, weighted leaf COMs", qin, RCP_MODES, quad_rcp)

    # Fidelity: median relative force error against an f64 direct sum, with
    # and without the quadrupole, at the same caps.
    qtgt, (qx, qy, qm), qq, qlim = qin
    q64 = direct_accel(qpos.double(), qmass.double(), SOFTENING2)
    qf, ql = qcfg.resolved_caps()
    mx, my, mm = traversal.bh_plan_sources(qtree, qcfg.theta, qf, ql,
                                           plan_leaves=1, multipole=1)
    errs = {}
    for label, acc in (
            ("quadrupole", traversal.grouped_sweep(
                qtgt, qx, qy, qm, SOFTENING2, quad_rcp, col_limit=qlim,
                src_q=qq)),
            ("monopole", traversal.grouped_sweep(
                qtgt, mx, my, mm, SOFTENING2, quad_rcp,
                col_limit=traversal.last_nonzero_columns(mm)))):
        rel = ((acc.reshape(-1, 2).double() - q64).norm(dim=1)
               / q64.norm(dim=1).clamp_min(1e-300))
        errs[label] = rel.median().item()
    log(f"force error at theta=0.5 (Plummer N={N_PLUMMER}, plan_leaves=1, "
        f"caps F={qf} L={ql}, rcp={quad_rcp}) vs f64 direct: median "
        f"relative {errs['quadrupole']:.4e} with the quadrupole, "
        f"{errs['monopole']:.4e} monopole only (bound 1e-3, and below the "
        "monopole's)")
    if not (errs["quadrupole"] < 1e-3
            and errs["quadrupole"] < errs["monopole"]):
        raise RuntimeError(f"quadrupole force error {errs}")
    del qin, qtgt, qx, qy, qm, qq, qlim, q64, mx, my, mm, qtree

    # The CLI's θ=0.5 Plummer run (--weighted-leaf-com, plan_leaves=4):
    # these are the shape and numbers of the kernel table's K4 entry.
    pcli = SimConfig(force_path="bh", theta=0.5, unweighted_leaf_com=False)
    *_, pin = path_inputs(pst, pcli)
    if pin[0].shape[1] != 256:
        raise RuntimeError(f"plan_leaves=4 targets per group {pin[0].shape}")
    quad_err, ms_qplain, ms_qbound, _, quad_bound = hold_quad(
        f"quadrupole sweep, Plummer N={N_PLUMMER}, theta=0.5, plan_leaves=4 "
        "(the CLI's), weighted leaf COMs", pin, RCP_MODES, quad_rcp)
    del pin, pst
    *_, gin = path_inputs(galaxy(seed=0).to(dev).pad_to(256),
                          SimConfig(force_path="bh", theta=0.5))
    hold_quad("quadrupole sweep, galaxy, theta=0.5", gin, (quad_rcp,),
              quad_rcp, reps=5)
    del gin
    log(f"phase quadrupole sweep: {time.perf_counter() - t_phase:.1f} s")

    # -- 3. θ=0 Barnes-Hut equals direct summation ----------------------------
    disc = uniform_disc(16_384, seed=3).to(dev)
    d64 = direct_accel(disc.pos.double(), disc.mass.double(), SOFTENING2)
    x, y = disc.pos[:, 0].double(), disc.pos[:, 1].double()
    m64 = disc.mass.double()
    scale0 = torch.empty_like(d64)
    for i0 in range(0, disc.n, 1024):
        xi = x[i0:i0 + 1024, None]
        yi = y[i0:i0 + 1024, None]
        ax, ay = pair_accel(x[None, :] - xi, y[None, :] - yi, m64[None, :],
                            SOFTENING2)
        scale0[i0:i0 + 1024, 0] = ax.abs().sum(1)
        scale0[i0:i0 + 1024, 1] = ay.abs().sum(1)
    for multipole in (1, 2):
        for rcp in ("exact", "newton"):
            bh0 = traversal.bh_accel(disc.pos, disc.mass, theta=0.0,
                                     multipole=multipole, rcp=rcp)
            ratio = ((bh0.double() - d64).abs()
                     / scale0.clamp_min(1e-300)).max()
            log(f"theta=0 BH (N=16384, multipole={multipole}, rcp={rcp}) vs "
                f"f64 direct: max |d|/sum|c| {ratio.item():.3e} (bound "
                f"{SUM_ORDER_RTOL:g})")
            if not ratio.item() <= SUM_ORDER_RTOL:
                raise RuntimeError(f"theta=0 BH (multipole={multipole}, "
                                   f"{rcp}) differs from direct sum")

    # -- 4. K2 and K1 vs their plain versions on the galaxy -------------------
    pcfg = SimConfig(force_path="pallas")
    pad = max(pcfg.tile_i, pcfg.tile_j, pcfg.sym_tile)
    gal = galaxy(seed=0).to(dev).pad_to(pad)
    gpos, gmass = gal.pos, gal.mass
    n_gal = gal.n
    log(f"all-pairs galaxy: N={n_gal} ({gal.n_real} particles, padded to a "
        f"multiple of {pad}), {n_gal ** 2 / 1e9:.2f}G ordered pairs")
    sym_plain, ms_sym_plain = plain_timed(
        lambda: ap.allpairs_accel_sym_ref(gpos, gmass, SOFTENING2))
    ord_plain, ms_ord_plain = plain_timed(
        lambda: ap.allpairs_accel_ref(gpos, gmass, None, None, SOFTENING2))
    gscale = ap.pair_sums(gpos, gpos, gmass, abs_terms, SOFTENING2)
    sym_err, ord_err = {}, {}
    for rcp in RCP_MODES:
        sym = ap.allpairs_accel_sym(gpos, gmass, SOFTENING2, rcp=rcp)
        ordered = ap.allpairs_accel(gpos, gmass, softening2=SOFTENING2,
                                    rcp=rcp)
        sym_err[rcp] = hold(f"allpairs_sym rcp={rcp} vs plain (exact), "
                            "galaxy", sym, sym_plain, gscale)
        ord_err[rcp] = hold(f"allpairs rcp={rcp} vs plain (exact), galaxy",
                            ordered, ord_plain, gscale)
        hold(f"allpairs_sym vs allpairs, rcp={rcp}, galaxy", sym, ordered,
             gscale)
        again = ap.allpairs_accel_sym(gpos, gmass, SOFTENING2, rcp=rcp)
        torch.cuda.synchronize()
        if not torch.equal(sym, again):
            raise RuntimeError(f"allpairs_sym rcp={rcp}: two calls on the "
                               "same input differ")
    log("allpairs_sym: two calls bitwise equal in every rcp mode")

    # NaN pattern in `exact` (the JAX package's on the CPU): K2 makes every
    # row's x NaN and keeps every y finite, the NaN particle's y at 0; K1
    # keeps every row finite and the NaN particle's row at 0.
    bad = 5
    npos = gpos.clone()
    npos[bad, 0] = float("nan")
    nsym = ap.allpairs_accel_sym(npos, gmass, SOFTENING2, rcp="exact")
    nord = ap.allpairs_accel(npos, gmass, softening2=SOFTENING2, rcp="exact")
    torch.cuda.synchronize()
    if not (bool(torch.isnan(nsym[:, 0]).all())
            and bool(torch.isfinite(nsym[:, 1]).all())
            and nsym[bad, 1].item() == 0.0):
        raise RuntimeError("allpairs_sym: NaN pattern differs from the JAX "
                           "package's")
    if not (bool(torch.isfinite(nord).all())
            and nord[bad].abs().sum().item() == 0.0):
        raise RuntimeError("allpairs: NaN pattern differs from the JAX "
                           "package's")
    log("NaN pattern (exact, one NaN x): allpairs_sym x NaN in all rows, y "
        "finite, own y 0; allpairs all finite, own row 0")
    # Under +clamp, max(NaN, clamp) is NaN (jnp.maximum's rule), so every
    # pair with the NaN particle is NaN in both components, in every row.
    for rcp in ("newton+clamp", "approx+clamp"):
        for label, out in (
                ("allpairs_sym", ap.allpairs_accel_sym(npos, gmass, SOFTENING2,
                                                       rcp=rcp)),
                ("allpairs", ap.allpairs_accel(npos, gmass,
                                               softening2=SOFTENING2,
                                               rcp=rcp))):
            if not bool(torch.isnan(out).all()):
                raise RuntimeError(f"{label} rcp={rcp}: one NaN x left "
                                   f"{int((~torch.isnan(out)).sum())} "
                                   "components not NaN")
    log("NaN pattern (+clamp, one NaN x): allpairs_sym and allpairs NaN in "
        "every component")

    # -- 4b. K2, K1 and K6 at small N: one tile, odd and even tile counts, a
    # ragged last tile (K2 cuts N into tiles of 256 whatever `tile` says).
    srng = np.random.default_rng(2)
    for n in SMALL_N:
        p_ = torch.tensor(srng.uniform(0, 1e5, (n, 2)).astype(np.float32),
                          device=dev)
        m_ = torch.tensor(srng.integers(1, 100, n).astype(np.float32),
                          device=dev)
        m_[0] = 7.5e7
        sc = ap.pair_sums(p_, p_, m_, abs_terms, SOFTENING2)
        sym_want = ap.allpairs_accel_sym_ref(p_, m_, SOFTENING2)
        ord_want = ap.allpairs_accel_ref(p_, m_, None, None, SOFTENING2)
        for rcp in ("exact", "newton"):
            hold(f"allpairs_sym rcp={rcp}, N={n}",
                 ap.allpairs_accel_sym(p_, m_, SOFTENING2, tile=n, rcp=rcp),
                 sym_want, sc)
            hold(f"allpairs rcp={rcp}, N={n}",
                 ap.allpairs_accel(p_, m_, softening2=SOFTENING2, tile_i=n,
                                   tile_j=n, rcp=rcp), ord_want, sc)
        phi_want = en.allpairs_potential_ref(p_, m_, None, None, SOFTENING2)
        hold(f"potential, N={n} (bound relative per target)",
             en.allpairs_potential(p_, m_, softening2=SOFTENING2), phi_want,
             phi_want.abs())

    # -- 5. K2 and K1 on 4,096 sampled targets at N=1M (bench.py's data) ------
    rng = np.random.default_rng(0)
    bpos = torch.tensor(rng.uniform(0, 1e5, (N_BIG, 2)).astype(np.float32),
                        device=dev)
    bmass = torch.tensor(rng.integers(1, 100, N_BIG).astype(np.float32),
                         device=dev)
    rows = torch.tensor(np.sort(np.random.default_rng(1).choice(
        N_BIG, N_SAMPLED, replace=False)), device=dev)
    tpos = bpos[rows].contiguous()
    bplain = ap.allpairs_accel_ref(tpos, None, bpos, bmass, SOFTENING2)
    bscale = ap.pair_sums(tpos, bpos, bmass, abs_terms, SOFTENING2)
    for rcp in RCP_MODES:
        hold(f"allpairs_sym rcp={rcp}, N=1M, {N_SAMPLED} sampled targets",
             ap.allpairs_accel_sym(bpos, bmass, SOFTENING2, rcp=rcp)[rows],
             bplain, bscale)
        hold(f"allpairs rcp={rcp}, N=1M, {N_SAMPLED} sampled targets",
             ap.allpairs_accel(bpos, bmass, softening2=SOFTENING2,
                               rcp=rcp)[rows], bplain, bscale)

    # -- 6. K6 vs its plain version on the galaxy -----------------------------
    phi_plain, ms_pot_plain = plain_timed(
        lambda: en.allpairs_potential_ref(gpos, gmass, None, None,
                                          SOFTENING2))
    phi = en.allpairs_potential(gpos, gmass, softening2=SOFTENING2)
    again = en.allpairs_potential(gpos, gmass, softening2=SOFTENING2)
    torch.cuda.synchronize()
    if not torch.equal(phi.view(torch.int32), again.view(torch.int32)):
        raise RuntimeError("potential: two calls on the same input differ")
    pot_err = hold("potential vs plain, galaxy (bound relative per target); "
                   "two calls bitwise", phi, phi_plain, phi_plain.abs())
    pot_rel = ((phi.double() - phi_plain.double()).abs()
               / phi_plain.double().abs().clamp_min(1e-300))
    log(f"potential vs plain, galaxy: relative error max {pot_rel.max():.3e}"
        f", median {pot_rel.median():.3e} (the root is rsqrt.approx)")
    pplan = en.potential_launch_plan(n_gal, n_gal, dev, SOFTENING2)
    log(f"potential grid at N={n_gal}: {pplan.target_blocks} target blocks "
        f"of {pplan.targets_per_block}, {pplan.chunks} chunks of "
        f"{pplan.chunk} sources: {pplan.target_blocks * pplan.chunks} blocks")
    # NaN pattern (the JAX package's): the mask drops every pair with a NaN
    # position, so every φ stays finite and the NaN particle's is 0.
    nphi = en.allpairs_potential(npos, gmass, softening2=SOFTENING2)
    nphi_plain = en.allpairs_potential_ref(npos, gmass, None, None,
                                           SOFTENING2)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(nphi).all()) and nphi[bad].item() == 0.0
            and torch.equal(torch.isfinite(nphi), torch.isfinite(nphi_plain))
            and nphi_plain[bad].item() == 0.0):
        raise RuntimeError("potential: NaN pattern differs from the plain "
                           "version's")
    hold("potential, one NaN x, vs plain (bound relative per target)", nphi,
         nphi_plain, nphi_plain.abs().clamp_min(1e-30))
    del again, nphi, nphi_plain

    # -- 7. the Barnes-Hut main path ------------------------------------------
    from nbody_simulation_tpu_torch import run

    def lit_pixels(png: Path) -> int:
        if not png.exists() or not png.stat().st_size:
            return 0
        return int((png_rgba(png.read_bytes())[..., 3] > 0).sum())

    def check_world(label, world, steps, tmp, mass0):
        pos = world.state.pos[:world.state.n_real]
        if not bool(torch.isfinite(pos).all()):
            raise RuntimeError(f"{label}: non-finite positions")
        mass1 = world.state.mass.double().sum().item()
        if mass1 != mass0:
            raise RuntimeError(f"{label}: total mass changed: {mass0} -> "
                               f"{mass1}")
        png = Path(tmp) / f"frame_{steps:08d}.png"
        lit = lit_pixels(png)
        if lit == 0:
            raise RuntimeError(f"{label}: final frame missing or dark ({png})")
        log(f"{label} checks: positions finite, mass {mass1:.1f} unchanged, "
            f"final PNG {png.stat().st_size} bytes with {lit} lit pixels")

    mass0 = galaxy(seed=0).mass.double().sum().item()
    with tempfile.TemporaryDirectory() as tmp:
        traversal.grouped_sweep.launches = 0
        t0 = time.perf_counter()
        world = run.simulate(["--steps", str(STEPS), "--out", tmp,
                              "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = traversal.grouped_sweep.launches
        log(f"BH main path: {STEPS} galaxy steps in {wall:.2f} s wall "
            f"(process start-up, scenario and first launches included); "
            f"sweep launches {launches}")
        if launches != STEPS:
            raise RuntimeError(f"sweep kernel launched {launches} times in "
                               f"{STEPS} steps")
        check_world("BH main path", world, STEPS, tmp, mass0)

    # Steady-state rate and the Counting split, on the same world.
    world.run(STEPS)  # warm: covers a full resort cycle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    world.run(STEPS)
    torch.cuda.synchronize()
    ups = STEPS / (time.perf_counter() - t0)
    counting = Counting()
    n_timed = 16
    for _ in range(n_timed):
        world.step_timed(counting)
    log(f"galaxy ups {ups:.1f} (steady state, {STEPS} steps, "
        f"resort every {cfg.resort_every}); per profiled step: build_bvh "
        f"{counting.build_bvh / n_timed * 1e3:.3f} ms, sum_gravity "
        f"{counting.sum_gravity / n_timed * 1e3:.3f} ms, post_calculations "
        f"{counting.post_calculations / n_timed * 1e3:.3f} ms")
    trace_steps("galaxy theta=50", world)

    # -- 7b. the θ=0.5 quality path through the CLI: K4 on every step --------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        traversal.grouped_sweep.launches = 0
        traversal.grouped_sweep.quad_launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            qworld = run.simulate([
                "--scenario", "plummer", "--n", str(N_PLUMMER), "--theta",
                "0.5", "--weighted-leaf-com", "--steps", str(QUAD_STEPS),
                "--energy-every", str(ENERGY_EVERY), "--device", "cuda",
                "--out", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        quad_launches = traversal.grouped_sweep.quad_launches
        k3_in_quad = traversal.grouped_sweep.launches
        qenergy = [(float(mt.group(1)), float(mt.group(2))) for mt in
                   re.finditer(r"energy: step \d+ E=(\S+) \|dE/E0\|=(\S+)",
                               buf.getvalue())]
        for line in buf.getvalue().splitlines():
            if line.startswith(("energy:", "done:", "len:")):
                log(f"  run: {line}")
        log(f"theta=0.5 Plummer path: {QUAD_STEPS} steps in {wall:.2f} s "
            f"wall; quadrupole sweep launches {quad_launches}, monopole "
            f"sweep launches {k3_in_quad}, energy samples {len(qenergy)}")
        if quad_launches != QUAD_STEPS or k3_in_quad != 0:
            raise RuntimeError(f"theta=0.5 path: quadrupole sweep launched "
                               f"{quad_launches} times and the monopole "
                               f"sweep {k3_in_quad} in {QUAD_STEPS} steps")
        if not qenergy or not all(math.isfinite(e) and math.isfinite(d)
                                  for e, d in qenergy):
            raise RuntimeError(f"theta=0.5 path: energy prints {qenergy}")
        check_world("theta=0.5 Plummer path", qworld, QUAD_STEPS, tmp,
                    plummer(N_PLUMMER, seed=0).mass.double().sum().item())
    qworld.run(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qworld.run(QUAD_STEPS)
    torch.cuda.synchronize()
    quad_ups = QUAD_STEPS / (time.perf_counter() - t0)
    log(f"theta=0.5 Plummer ups {quad_ups:.1f} (steady state, {QUAD_STEPS} "
        "steps, plan_leaves=4)")
    trace_steps("theta=0.5 Plummer", qworld)

    # The galaxy at θ=0.5: the quadrupole sweep at the widest planned shape.
    gcfg = SimConfig(force_path="bh", theta=0.5)
    gworld = World(galaxy(seed=0).to(dev), gcfg)
    traversal.grouped_sweep.launches = 0
    traversal.grouped_sweep.quad_launches = 0
    gworld.run(QUAD_GALAXY_STEPS)
    torch.cuda.synchronize()
    gq, g3 = (traversal.grouped_sweep.quad_launches,
              traversal.grouped_sweep.launches)
    log(f"theta=0.5 galaxy World: {QUAD_GALAXY_STEPS} steps, quadrupole "
        f"sweep launches {gq}, monopole {g3}")
    if gq != QUAD_GALAXY_STEPS or g3 != 0:
        raise RuntimeError("theta=0.5 galaxy World did not run the "
                           "quadrupole sweep once per step")
    if not bool(torch.isfinite(gworld.state.pos).all()):
        raise RuntimeError("theta=0.5 galaxy World: non-finite positions")
    t0 = time.perf_counter()
    gworld.run(QUAD_GALAXY_STEPS)
    torch.cuda.synchronize()
    gups = QUAD_GALAXY_STEPS / (time.perf_counter() - t0)
    gcounting = Counting()
    for _ in range(4):
        gworld.step_timed(gcounting)
    log(f"theta=0.5 galaxy ups {gups:.1f} ({QUAD_GALAXY_STEPS} steps); per "
        f"profiled step: build_bvh {gcounting.build_bvh / 4 * 1e3:.3f} ms, "
        f"sum_gravity {gcounting.sum_gravity / 4 * 1e3:.3f} ms, "
        f"post_calculations {gcounting.post_calculations / 4 * 1e3:.3f} ms")
    trace_steps("theta=0.5 galaxy", gworld)
    del qworld, gworld
    log(f"phase theta=0.5 paths: {time.perf_counter() - t_phase:.1f} s")

    # -- 7c. the Barnes-Hut step as CUDA graphs against eager steps -----------
    graph_capture_s = step_graph_phase(helpers)

    # -- 7d. the engine's snapshot in flight ----------------------------------
    overlap = engine_overlap_phase(helpers)

    # -- 8. the all-pairs main path with energy telemetry ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        ap.allpairs_sym_cuda.launches = 0
        ap.allpairs_cuda.launches = 0
        en.potential_cuda.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            pworld = run.simulate([
                "--force-path", "pallas", "--energy-every", str(ENERGY_EVERY),
                "--steps", str(PALLAS_STEPS), "--device", "cuda",
                "--out", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sym_launches = ap.allpairs_sym_cuda.launches
        k1_in_pallas = ap.allpairs_cuda.launches
        pot_launches = en.potential_cuda.launches
        energy = [(int(mt.group(1)), float(mt.group(2)), float(mt.group(3)))
                  for mt in re.finditer(
                      r"energy: step (\d+) E=(\S+) \|dE/E0\|=(\S+)",
                      buf.getvalue())]
        for line in buf.getvalue().splitlines():
            if line.startswith(("energy:", "done:", "len:")):
                log(f"  run: {line}")
        log(f"all-pairs main path: {PALLAS_STEPS} galaxy steps in "
            f"{wall:.2f} s wall; allpairs_sym launches {sym_launches}, "
            f"allpairs launches {k1_in_pallas}, potential launches "
            f"{pot_launches}, energy samples {len(energy)}")
        if sym_launches != PALLAS_STEPS or k1_in_pallas != 0:
            raise RuntimeError(
                f"all-pairs path: allpairs_sym called {sym_launches} times "
                f"and allpairs {k1_in_pallas} times in {PALLAS_STEPS} steps")
        if not energy or pot_launches != len(energy):
            raise RuntimeError(f"potential launched {pot_launches} times for "
                               f"{len(energy)} energy samples")
        if not all(math.isfinite(e) and math.isfinite(d)
                   for _, e, d in energy):
            raise RuntimeError(f"non-finite energy or drift: {energy}")
        check_world("all-pairs main path", pworld, PALLAS_STEPS, tmp, mass0)
    pworld.run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pworld.run(8)
    torch.cuda.synchronize()
    pallas_ups = 8 / (time.perf_counter() - t0)
    log(f"all-pairs galaxy ups {pallas_ups:.2f} (8 steps, symmetric kernel, "
        f"rcp={pcfg.resolved_rcp()})")

    # The ordered kernel's path: the same World with sym_allpairs off.
    ocfg = SimConfig(force_path="pallas", sym_allpairs=False)
    oworld = World(galaxy(seed=0).to(dev), ocfg)
    ap.allpairs_cuda.launches = 0
    ap.allpairs_sym_cuda.launches = 0
    oworld.run(ORDERED_STEPS)
    torch.cuda.synchronize()
    k1_launches = ap.allpairs_cuda.launches
    k2_in_ordered = ap.allpairs_sym_cuda.launches
    log(f"ordered all-pairs World: {ORDERED_STEPS} galaxy steps, allpairs "
        f"launches {k1_launches}, allpairs_sym {k2_in_ordered}")
    if k1_launches != ORDERED_STEPS or k2_in_ordered != 0:
        raise RuntimeError("ordered all-pairs World did not run the ordered "
                           "kernel once per step")
    if not bool(torch.isfinite(oworld.state.pos).all()):
        raise RuntimeError("ordered all-pairs World: non-finite positions")

    # -- 8b. the gradient path: K7 and K8 ------------------------------------
    t_phase = time.perf_counter()

    def grad_sums(pos_i, g_i, pos_j, mass_j, side):
        """``grad_magnitudes`` summed over the other axis, per target
        (``side="i"``: the x and y scales) or per source (``"j"``: those
        and the r·t scale), for the kernels' tolerances; chunks of ~2^25
        pairs."""
        rows_of, cols_of = (pos_i, pos_j) if side == "i" else (pos_j, pos_i)
        rows = max(1, (1 << 25) // cols_of.shape[0])
        out = torch.empty((rows_of.shape[0], 3), device=dev)
        for r0 in range(0, rows_of.shape[0], rows):
            sl = slice(r0, r0 + rows)
            if side == "i":
                terms = grad_magnitudes(
                    pos_i[sl, 0:1], pos_i[sl, 1:2], g_i[sl, 0:1],
                    g_i[sl, 1:2], pos_j[None, :, 0], pos_j[None, :, 1],
                    mass_j[None, :])
            else:
                terms = grad_magnitudes(
                    pos_i[None, :, 0], pos_i[None, :, 1], g_i[None, :, 0],
                    g_i[None, :, 1], pos_j[sl, 0:1], pos_j[sl, 1:2],
                    mass_j[sl, None])
            for k, term in enumerate(terms):
                out[sl, k] = term.sum(1)
        return out[:, :2], out[:, 2]

    def hold_k7(label, pos_i, g_i, pos_j, mass_j):
        """K7a and K7b against their plain versions; returns their max
        |d| (K7b: over p̄_j and m̄_j)."""
        si, _ = grad_sums(pos_i, g_i, pos_j, mass_j, "i")
        sj, sm_ = grad_sums(pos_i, g_i, pos_j, mass_j, "j")
        ea = hold(f"{label}: allpairs_bwd_i vs plain, bound relative to "
                  "sum(|m r g|+|m r^2 t (..)|)",
                  agr.bwd_i_cuda(pos_i, g_i, pos_j, mass_j, SOFTENING2),
                  agr.bwd_i_ref(pos_i, g_i, pos_j, mass_j, SOFTENING2), si)
        pb, mb = agr.bwd_j_cuda(pos_i, g_i, pos_j, mass_j, SOFTENING2)
        pw, mw = agr.bwd_j_ref(pos_i, g_i, pos_j, mass_j, SOFTENING2)
        eb = max(hold(f"{label}: allpairs_bwd_j pbar vs plain, bound "
                      "relative to sum(|m r g|+|m r^2 t (..)|)", pb, pw,
                      sj),
                 hold(f"{label}: allpairs_bwd_j mbar vs plain, bound "
                      "relative to sum|r t|", mb, mw, sm_))
        return ea, eb

    # K7 on the padded galaxy (the all-pairs value+grad's shape): 4,096
    # sampled targets against every source (K7a), every target against
    # 4,096 sampled sources (K7b); the sampled rows of a full launch are
    # bitwise those of the sampled launch, since each thread's loop is the
    # same. Then ragged N.
    grng = np.random.default_rng(5)
    gbar = torch.tensor(grng.normal(0, 1, (n_gal, 2)).astype(np.float32),
                        device=dev)
    grows = torch.tensor(np.sort(grng.choice(n_gal, N_SAMPLED,
                                             replace=False)), device=dev)
    rp, rg, rm = (gpos[grows].contiguous(), gbar[grows].contiguous(),
                  gmass[grows].contiguous())
    k7a_err, _ = hold_k7(f"K7a galaxy, {N_SAMPLED} sampled targets",
                         rp, rg, gpos, gmass)
    _, k7b_err = hold_k7(f"K7b galaxy, {N_SAMPLED} sampled sources",
                         gpos, gbar, rp, rm)
    full_i = agr.bwd_i_cuda(gpos, gbar, gpos, gmass, SOFTENING2)
    full_j = agr.bwd_j_cuda(gpos, gbar, gpos, gmass, SOFTENING2)
    part_i = agr.bwd_i_cuda(rp, rg, gpos, gmass, SOFTENING2)
    part_j = agr.bwd_j_cuda(gpos, gbar, rp, rm, SOFTENING2)
    torch.cuda.synchronize()
    if not (torch.equal(full_i[grows], part_i)
            and torch.equal(full_j[0][grows], part_j[0])
            and torch.equal(full_j[1][grows], part_j[1])):
        raise RuntimeError("K7 at the full galaxy differs from the sampled "
                           "launch on the sampled rows")
    log("K7 at the full galaxy: sampled rows bitwise the sampled launch's")
    del full_i, full_j, part_i, part_j
    for n in (200, 512, 1000):
        p_ = torch.tensor(grng.uniform(0, 1e5, (n, 2)).astype(np.float32),
                          device=dev)
        m_ = torch.tensor(grng.integers(1, 100, n).astype(np.float32),
                          device=dev)
        m_[0] = 7.5e7
        g_ = torch.tensor(grng.normal(0, 1, (n, 2)).astype(np.float32),
                          device=dev)
        hold_k7(f"K7 N={n}", p_, g_, p_, m_)

    # K8 at bh_accel_diff's shape on the galaxy (the planner's own columns,
    # plan_leaves=1), every output compared.
    gal0 = galaxy(seed=0).to(dev)
    gtree, _ = build_tree(gal0.pos, gal0.mass, morton_bits=15)
    k8x, k8y, k8m = traversal.bh_plan_sources(gtree, 50.0, 32, 16)
    k8t = gtree.leaf_pos
    kg, ks, kc = k8x.shape[0], k8t.shape[1], k8x.shape[1]
    log(f"K8 galaxy shape (bh_accel_diff defaults): G={kg} S={ks} C={kc} "
        f"({kg * ks * kc / 1e6:.1f}M pairs, every column)")
    k8g = torch.tensor(grng.normal(0, 1, (kg, ks, 2)).astype(np.float32),
                       device=dev)
    k8in = (k8t, k8g, k8x, k8y, k8m)
    k8_main = hold_k8("K8 galaxy", k8in)

    # An independent truth: f64 torch autograd of the direct sum on a
    # random cloud (off the law's kinks, where autograd is the derivative).
    trng = np.random.default_rng(6)
    tpos = torch.tensor(trng.uniform(0, 1e5, (4096, 2)).astype(np.float32),
                        device=dev)
    tmass = torch.tensor(trng.integers(1, 100, 4096).astype(np.float32),
                         device=dev)
    tcot = torch.tensor(trng.normal(0, 1, (4096, 2)).astype(np.float32),
                        device=dev)
    p64 = tpos.double().requires_grad_(True)
    m64 = tmass.double().requires_grad_(True)
    (direct_accel(p64, m64, SOFTENING2) * tcot.double()).sum().backward()
    for label, fn, kernels in (
            ("allpairs_accel_diff", lambda p, m: agr.allpairs_accel_diff(
                p, m, SOFTENING2), (agr.bwd_i_cuda, agr.bwd_j_cuda)),
            ("bh_accel_diff theta=0", lambda p, m: tgr.bh_accel_diff(
                p, m, theta=0.0, frontier_cap=64, leaf_cap=64,
                unweighted_leaf_com=False),
             (tgr.grouped_bwd_tgt_cuda, tgr.grouped_bwd_src_cuda))):
        before = [k.launches for k in kernels]
        p = tpos.clone().requires_grad_(True)
        m = tmass.clone().requires_grad_(True)
        (fn(p, m) * tcot).sum().backward()
        rel_p = ((p.grad.double() - p64.grad).norm()
                 / p64.grad.norm()).item()
        rel_m = ((m.grad.double() - m64.grad).norm()
                 / m64.grad.norm()).item()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        log(f"{label} gradients (N=4096 random cloud) vs f64 autograd of "
            f"the direct sum: positions {rel_p:.3e}, masses {rel_m:.3e} "
            f"relative norm (bounds 1e-4, 1e-3); backward launches {ran}")
        if not (rel_p < 1e-4 and rel_m < 1e-3 and ran == [1, 1]):
            raise RuntimeError(f"{label}: gradients {rel_p}, {rel_m} from "
                               f"the f64 truth, launches {ran}")
    del p64, m64

    # Forward parity: both differentiable forwards are the run mode's,
    # bitwise, on the galaxy.
    gp = gal0.pos.clone().requires_grad_(True)
    bh_run = traversal.bh_accel(gal0.pos, gal0.mass, theta=50.0,
                                frontier_cap=32, leaf_cap=16, multipole=1,
                                morton_bits=15, plan_leaves=1, rcp="newton")
    if not torch.equal(tgr.bh_accel_diff(gp, gal0.mass).detach(), bh_run):
        raise RuntimeError("bh_accel_diff forward differs from bh_accel")
    pp = gpos.clone().requires_grad_(True)
    for sym, run_fn in ((False, lambda: ap.allpairs_accel(
            gpos, gmass, softening2=SOFTENING2, rcp="newton")),
                        (True, lambda: ap.allpairs_accel_sym(
                            gpos, gmass, SOFTENING2, rcp="newton"))):
        if not torch.equal(agr.allpairs_accel_diff(
                pp, gmass, SOFTENING2, sym=sym).detach(), run_fn()):
            raise RuntimeError(f"allpairs_accel_diff(sym={sym}) forward "
                               "differs from run mode")
    log("forward parity on the galaxy: bh_accel_diff == bh_accel "
        "(multipole=1, 15-bit keys, newton), allpairs_accel_diff == "
        "allpairs_accel and == allpairs_accel_sym with sym, bitwise")
    del bh_run

    # Value+grad of Σ|a|² (benchmarks/probe_grad_tpu.py's loss), with the
    # launches of one call.
    def value_grad(fn, pos, mass):
        p = pos.detach().requires_grad_(True)
        a = fn(p, mass)
        loss = (a * a).sum()
        return loss, torch.autograd.grad(loss, (p,))[0]

    counted = {"K3": traversal.grouped_sweep, "K1": ap.allpairs_cuda,
               "K2": ap.allpairs_sym_cuda, "K7a": agr.bwd_i_cuda,
               "K7b": agr.bwd_j_cuda, "K8a": tgr.grouped_bwd_tgt_cuda,
               "K8b": tgr.grouped_bwd_src_cuda,
               "SEG": traversal.segment_sum_cuda}

    def one_call(label, fn, pos, mass, expect):
        """``expect``: launches per kernel, None for "at least one"."""
        for k in counted.values():
            k.launches = 0
        loss, grad = value_grad(fn, pos, mass)
        torch.cuda.synchronize()
        got = {k: v.launches for k, v in counted.items() if v.launches}
        log(f"{label} value+grad: loss {loss.item():.6e}, launches {got}")
        if (set(got) != set(expect)
                or any(n is not None and got[k] != n
                       for k, n in expect.items())
                or not bool(torch.isfinite(grad).all())):
            raise RuntimeError(f"{label} value+grad: launches {got} (want "
                               f"{expect}), finite grad "
                               f"{bool(torch.isfinite(grad).all())}")
        return got

    disc = uniform_disc(N_BIG, seed=0).to(dev)
    vg_ms, vg_launches = {}, {}
    for label, fn, pos, mass, expect, reps in (
            ("BH galaxy theta=50", tgr.bh_accel_diff, gal0.pos, gal0.mass,
             {"K3": 1, "K8a": 1, "K8b": 1, "SEG": None}, 5),
            ("all-pairs galaxy (padded)",
             lambda p, m: agr.allpairs_accel_diff(p, m, SOFTENING2),
             gpos, gmass, {"K1": 1, "K7a": 1, "K7b": 1}, 3),
            (f"BH disc N={N_BIG} theta=50", tgr.bh_accel_diff, disc.pos,
             disc.mass, {"K3": 1, "K8a": 1, "K8b": 1, "SEG": None}, 3)):
        vg_launches[label] = one_call(label, fn, pos, mass, expect)
        vg_ms[label] = timed_ms(lambda: value_grad(fn, pos, mass), reps=reps)
        fwd_ms = timed_ms(lambda: fn(pos, mass), reps=reps)
        log(f"{label}: value+grad {vg_ms[label]:.3f} ms, the forward alone "
            f"{fwd_ms:.3f} ms (CUDA events after warm-up, {reps} calls)")
    del disc

    # The Barnes-Hut value+grad is bitwise on two calls: the output and both
    # gradients. The planner's gathers add each row's duplicates in a fixed
    # order (ops/traversal.py, index_add_ordered), where index_select's own
    # backward added them with float atomics.
    def bh_value_grads(pos, mass):
        p = pos.detach().requires_grad_(True)
        m = mass.detach().requires_grad_(True)
        a = tgr.bh_accel_diff(p, m)
        return (a.detach(), *torch.autograd.grad((a * a).sum(), (p, m)))

    twice = [same_bits(x, y) for x, y in zip(
        bh_value_grads(gal0.pos, gal0.mass),
        bh_value_grads(gal0.pos, gal0.mass))]
    log(f"BH galaxy value+grad twice on the same inputs: output, position "
        f"gradient, mass gradient bitwise {twice}")
    if not all(twice):
        raise RuntimeError(f"BH galaxy value+grad differs between two calls "
                           f"(output, positions, masses): {twice}")

    # The segmented sum (csrc/segment_sum.cu) at the shapes one galaxy
    # value+grad gives it and at edge shapes, against its plain version.
    with captured_gathers() as seg_calls:
        value_grad(tgr.bh_accel_diff, gal0.pos, gal0.mass)
    seg_err, seg_big = hold_seg("one galaxy value+grad", seg_calls)
    window = traversal._segment_window
    rng = np.random.default_rng(7)
    edge_calls = []
    for w_ in (1, 16, 44, 128, 130):
        for n_rows, idx in (
                (4096, rng.permutation(4096)),               # runs of one
                (4096, np.full(65_536, 1234)),               # one row
                (4096, rng.integers(0, 2048, 3000) * 2),     # rows with none
                (10, np.repeat([1, 4, 7, 8], 2 * window)),   # whole windows
                (50, rng.integers(0, 50, 4 * window + 77)),  # ragged K
                (5, np.zeros(0, np.int64))):                 # K = 0
            src = torch.tensor(rng.normal(0, 1, (len(idx), w_)).astype(
                np.float32), device=dev)
            for dt in (torch.int32, torch.int64):
                edge_calls.append((n_rows, torch.tensor(idx, dtype=dt,
                                                        device=dev), src))
    seg_err = max(seg_err, hold_seg("edge shapes", edge_calls)[0])
    del edge_calls
    n_rows, idx, flat, key, perm = seg_big
    k_, w_ = flat.shape
    ms_seg = timed_ms(lambda: traversal.segment_sum_cuda(flat, key, perm,
                                                         n_rows), reps=20)
    ms_iao = timed_ms(lambda: traversal.index_add_ordered(n_rows, idx, flat),
                      reps=20)
    _, ms_seg_plain = plain_timed(lambda: traversal.segment_sum_ref(
        flat, key, perm, n_rows))
    ms_seg_atomic = timed_ms(lambda: torch.zeros(
        (n_rows, w_), device=dev).index_add_(0, idx, flat), reps=20)
    # The one PyTorch call that adds duplicates in a fixed order.
    torch.use_deterministic_algorithms(True)
    try:
        ms_seg_lib = timed_ms(lambda: torch.zeros(
            (n_rows, w_), device=dev).index_add_(0, idx, flat), reps=5)
    finally:
        torch.use_deterministic_algorithms(False)
    seg_bound = segment_bound(k_, w_, n_rows, key.element_size())
    log(f"segment_sum, the largest galaxy call (K={k_}, W={w_}, {n_rows} "
        f"rows, {key.dtype} key, longest run "
        f"{int(torch.bincount(key).max())}, windows of {window}): kernel "
        f"{ms_seg:.4f} ms (2 launches), with the sort (index_add_ordered) "
        f"{ms_iao:.4f} ms, plain {ms_seg_plain:.3f} ms (once), index_add_ "
        f"{ms_seg_atomic:.4f} ms (float atomics), deterministic index_add_ "
        f"{ms_seg_lib:.4f} ms, bound {seg_bound[0]:.4f} ms by {seg_bound[1]}"
        f" ({seg_bound[2]})")
    del seg_calls, seg_big, flat, key, perm, idx

    # One traced BH value+grad on the galaxy: device time, operations, and
    # K8's share.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value_grad(tgr.bh_accel_diff, gal0.pos, gal0.mass)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = device_ms(prof)
    k8_ms = device_ms(prof, "grouped_bwd")
    k3_ms = device_ms(prof, "grouped_sweep_kernel")
    seg_trace_ms = device_ms(prof, "segment_windows", "segment_carry")
    n_ops = sum(1 for e in prof.events() if on_device(e))
    if total <= 0 or k8_ms <= 0:
        raise RuntimeError(f"BH value+grad trace: device time {total} ms, "
                           f"K8 {k8_ms} ms: no K8 kernel in the trace")
    top = sorted((e for e in events if on_device(e)), key=dev_us,
                 reverse=True)[:4]
    log(f"BH galaxy value+grad trace: device time {total:.3f} ms in {n_ops} "
        f"device operations (summed over every profiler entry: "
        f"{all_entries_ms(prof):.3f} ms); K8 {k8_ms:.3f} ms "
        f"({k8_ms / total:.0%}), K3 {k3_ms:.3f} ms, segment_sum "
        f"{seg_trace_ms:.3f} ms, the rest (sort, tree, planner, their "
        f"backward) {total - k8_ms - k3_ms - seg_trace_ms:.3f} ms; the most "
        "device time: "
        + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top))
    # The distributed phase prints its traced value+grad beside this one.
    helpers.vg_trace = (total, n_ops, seg_trace_ms)

    # The gradient of the galaxy's spread after 4 Euler steps with respect
    # to the initial positions: K8 once per step.
    dt = float(np.float32(SimConfig().dt))
    for k in counted.values():
        k.launches = 0
    p0 = gal0.pos.clone().requires_grad_(True)
    p, v = p0, gal0.vel
    for _ in range(4):
        v = v + tgr.bh_accel_diff(p, gal0.mass) * dt
        p = p + v * dt
    spread = ((p - p.mean(0)) ** 2).sum()
    (g0,) = torch.autograd.grad(spread, (p0,))
    torch.cuda.synchronize()
    traj = {k: v.launches for k, v in counted.items() if v.launches}
    log(f"trajectory gradient (4 Euler steps of the galaxy): spread "
        f"{spread.item():.6e}, |grad| {g0.norm().item():.6e}, finite "
        f"{bool(torch.isfinite(g0).all())}, launches {traj}")
    seg_per_call = vg_launches["BH galaxy theta=50"]["SEG"]
    if (traj != {"K3": 4, "K8a": 4, "K8b": 4, "SEG": 4 * seg_per_call}
            or not bool(torch.isfinite(g0).all())):
        raise RuntimeError(f"trajectory gradient: launches {traj}")
    del p0, p, v, g0, gp, pp

    # Times at the gradient path's shapes, and bounds.
    ms_k7a = timed_ms(lambda: agr.bwd_i_cuda(gpos, gbar, gpos, gmass,
                                             SOFTENING2), reps=3)
    ms_k7b = timed_ms(lambda: agr.bwd_j_cuda(gpos, gbar, gpos, gmass,
                                             SOFTENING2), reps=3)
    _, ms_k7a_plain = plain_timed(lambda: agr.bwd_i_ref(
        gpos, gbar, gpos, gmass, SOFTENING2))
    _, ms_k7b_plain = plain_timed(lambda: agr.bwd_j_ref(
        gpos, gbar, gpos, gmass, SOFTENING2))
    k7_pairs = float(n_gal) * n_gal
    k7a_bound = bound("grad_i", "newton", k7_pairs, 4.0 * 9 * n_gal,
                      "force_grad", "allpairs_bwd_i")
    k7b_bound = bound("grad_j", "newton", k7_pairs, 4.0 * 10 * n_gal,
                      "force_grad", "allpairs_bwd_j")
    for name, ms, pl_ms, bd in (
            ("allpairs_bwd_i (K7a)", ms_k7a, ms_k7a_plain, k7a_bound),
            ("allpairs_bwd_j (K7b)", ms_k7b, ms_k7b_plain, k7b_bound)):
        log(f"{name}: kernel {ms:.4f} ms, plain {pl_ms:.3f} ms (once), "
            f"bound {bd[0]:.4f} ms by {bd[1]} ({bd[2]})")
    del gal0, gtree, k8in, k8t, k8g, k8x, k8y, k8m, gbar
    log(f"phase gradients: {time.perf_counter() - t_phase:.1f} s")

    # -- 9. times -------------------------------------------------------------
    main_ap = pcfg.resolved_rcp()
    ms_sym = timed_ms(lambda: ap.allpairs_accel_sym(
        gpos, gmass, SOFTENING2, rcp=main_ap), reps=10)
    ms_ord = timed_ms(lambda: ap.allpairs_accel(
        gpos, gmass, softening2=SOFTENING2, rcp=main_ap), reps=10)
    ms_pot = timed_ms(lambda: en.allpairs_potential(
        gpos, gmass, softening2=SOFTENING2), reps=10)
    gal_bytes = 12.0 * n_gal + 8.0 * n_gal
    mode = RCP_MODES.index(main_ap)
    sym_bound = bound("sym", main_ap, n_gal * n_gal / 2.0, gal_bytes,
                      "allpairs", f"allpairs_sym_roundsILi{mode}ELb0E")
    ord_bound = bound("mono", main_ap, float(n_gal) * n_gal, gal_bytes,
                      "allpairs", f"ordered_kernelILi{mode}EE")
    pot_bound = bound("pot", "exact", float(n_gal) * n_gal,
                      12.0 * n_gal + 4.0 * n_gal, "allpairs",
                      "potential_kernelILb1EE")
    sym_plan("K2 on the galaxy", n_gal, main_ap, True)
    sym_plan("K2 at N=1M", N_BIG, "newton", True)
    for name, ms, pl_ms, bd in (
            ("allpairs_sym", ms_sym, ms_sym_plain, sym_bound),
            ("allpairs", ms_ord, ms_ord_plain, ord_bound),
            ("potential", ms_pot, ms_pot_plain, pot_bound)):
        log(f"{name} at the galaxy (N={n_gal}): kernel {ms:.4f} ms, plain "
            f"{pl_ms:.3f} ms (once), bound {bd[0]:.4f} ms by {bd[1]} "
            f"({bd[2]})")
    big = {}
    for label, fn in (
            ("allpairs_sym newton", lambda: ap.allpairs_accel_sym(
                bpos, bmass, SOFTENING2, rcp="newton")),
            ("allpairs_sym approx+clamp", lambda: ap.allpairs_accel_sym(
                bpos, bmass, SOFTENING2, rcp="approx+clamp")),
            ("allpairs newton", lambda: ap.allpairs_accel(
                bpos, bmass, softening2=SOFTENING2, rcp="newton"))):
        big[label] = timed_ms(fn, reps=2, warmup=1)
        log(f"{label} at N={N_BIG}: {big[label]:.2f} ms, "
            f"{float(N_BIG) ** 2 / (big[label] * 1e-3):.4e} pairs/s (N^2/t)")
    for label, form, rcp, fn_name, pairs in (
            ("allpairs_sym newton", "sym", "newton",
             "allpairs_sym_roundsILi1ELb0E", 0.5),
            ("allpairs_sym approx+clamp", "sym", "approx+clamp",
             "allpairs_sym_roundsILi4ELb0E", 0.5),
            ("allpairs newton", "mono", "newton", "ordered_kernelILi1EE",
             1.0)):
        bd = bound(form, rcp, pairs * N_BIG * N_BIG, 20.0 * N_BIG,
                   "allpairs", fn_name)
        log(f"{label} bound at N={N_BIG}: {bd[0]:.2f} ms by {bd[1]} "
            f"({bd[2]})")

    # -- 10. the multi-device paths on one card: a LocalMesh of P shards ----
    # One card measures the sharded schedule and its kernels: the shards'
    # blocks move by tensor copies on the card, not over an interconnect.
    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.ops.raster import (render_frame,
                                                       render_frame_sparse,
                                                       sparse_to_frame)
    t_phase = time.perf_counter()
    md_counted = {"K9": ap.allpairs_sym_pair_cuda, "K2": ap.allpairs_sym_cuda,
                  "K1": ap.allpairs_cuda, "K6": en.potential_cuda,
                  "K3": traversal.grouped_sweep, "K7a": agr.bwd_i_cuda,
                  "K7b": agr.bwd_j_cuda}

    def zero_counts():
        for k in md_counted.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: v.launches for k, v in md_counted.items() if v.launches}

    def hold_k9(label, pi, mi, pj, mj, modes):
        """K9 against its plain version on N_SAMPLED rows of each side, in
        each of ``modes``, and bitwise equal on two calls; returns the max
        |d| per mode."""
        n = pi.shape[0]
        rows = torch.tensor(np.sort(np.random.default_rng(7).choice(
            n, N_SAMPLED, replace=False)), device=dev)
        want_i = ap.allpairs_accel_sym_pair_ref(
            pi[rows].contiguous(), mi[rows].contiguous(), pj, mj,
            SOFTENING2)[0]
        want_j = ap.allpairs_accel_sym_pair_ref(
            pi, mi, pj[rows].contiguous(), mj[rows].contiguous(),
            SOFTENING2)[1]
        sc_i = ap.pair_sums(pi[rows], pj, mj, abs_terms, SOFTENING2)
        sc_j = ap.pair_sums(pj[rows], pi, mi, abs_terms, SOFTENING2)
        errs = {}
        for rcp in modes:
            ai, aj = ap.allpairs_accel_sym_pair(pi, mi, pj, mj, SOFTENING2,
                                                rcp=rcp)
            bi, bj = ap.allpairs_accel_sym_pair(pi, mi, pj, mj, SOFTENING2,
                                                rcp=rcp)
            torch.cuda.synchronize()
            if not (torch.equal(ai, bi) and torch.equal(aj, bj)):
                raise RuntimeError(f"{label} rcp={rcp}: two calls differ")
            errs[rcp] = max(
                hold(f"{label} rcp={rcp}: i side, {N_SAMPLED} sampled rows",
                     ai[rows], want_i, sc_i),
                hold(f"{label} rcp={rcp}: j side, {N_SAMPLED} sampled rows",
                     aj[rows], want_j, sc_j))
        return errs

    # The galaxy at P=3: 151,317 particles in 3 shards of L=51,200. Auto
    # dispatch takes the symmetric ring: K2 on each shard, then one full
    # round of K9 per shard.
    gal_host = galaxy(seed=0)
    n_real = gal_host.n_real
    mesh3 = par.LocalMesh(3, dev)
    st3 = par.shard_state(gal_host, mesh3)
    l3 = st3.n // 3
    log(f"multi-device galaxy P=3: N={st3.n}, L={l3} per shard")
    if (st3.n, l3) != (153_600, 51_200):
        raise RuntimeError(f"P=3 galaxy shards {st3.n}, {l3}")
    ring3 = par.ring_allpairs_accel(st3.pos, st3.mass, mesh3, rcp=main_ap)
    again = par.ring_allpairs_accel(st3.pos, st3.mass, mesh3, rcp=main_ap)
    single3 = ap.allpairs_accel_sym(st3.pos, st3.mass, SOFTENING2,
                                    rcp=main_ap)
    torch.cuda.synchronize()
    if not torch.equal(ring3, again):
        raise RuntimeError("P=3 symmetric ring: two calls differ")
    if not bool(torch.isfinite(ring3).all()):
        raise RuntimeError("P=3 symmetric ring: non-finite forces")
    ring3_err = hold(f"P=3 symmetric ring vs single-device K2 (N={st3.n}, "
                     f"rcp={main_ap}), {n_real} real rows; two calls bitwise "
                     "equal", ring3[:n_real], single3[:n_real],
                     gscale[:n_real])
    del again, single3

    # The main path: make_sharded_step on the P=3 galaxy, with its
    # diagnostics, one frame and one exact energy.
    step3 = par.make_sharded_step(mesh3, pcfg)
    diag0 = par.sharded_diagnostics(st3, mesh3)
    md_steps = 4
    zero_counts()
    s3 = st3
    for _ in range(md_steps):
        s3 = step3(s3)
    p3_counts = read_counts()
    log(f"P=3 galaxy: {md_steps} make_sharded_step steps, launches "
        f"{p3_counts}")
    if p3_counts != {"K9": 3 * md_steps, "K2": 3 * md_steps}:
        raise RuntimeError(f"P=3 sharded step launches {p3_counts}")
    diag = par.sharded_diagnostics(s3, mesh3)
    if not (all(bool(torch.isfinite(v.double()).all()) for v in diag.values())
            and torch.equal(diag["total_mass"], diag0["total_mass"])
            and abs(diag["total_mass"].item() - mass0) <= 1e-6 * mass0
            and diag["n_live"].item() == n_real
            and bool(torch.isfinite(s3.pos).all())):
        raise RuntimeError(f"P=3 sharded step diagnostics {diag}")
    log(f"P=3 diagnostics after {md_steps} steps: total mass "
        f"{diag['total_mass'].item():.1f} unchanged, n_live "
        f"{diag['n_live'].item()}, kinetic energy "
        f"{diag['kinetic_energy'].item():.6e}, positions finite")
    frame = par.sharded_render_frame(s3.pos, s3.vel, s3.mass, mesh3)
    dense = render_frame(s3.pos, s3.vel, s3.mass)
    sparse = sparse_to_frame(*render_frame_sparse(s3.pos, s3.vel, s3.mass,
                                                  cap=s3.n))
    if not (torch.equal(frame, dense)
            and np.array_equal(frame.cpu().numpy(), sparse)):
        raise RuntimeError("P=3 sharded frame differs from the single-device "
                           "frame")
    lit = int((frame[..., 3] > 0).sum())
    log(f"P=3 sharded frame == single-device dense and sparse frames pixel "
        f"for pixel ({lit} lit pixels)")
    if lit == 0:
        raise RuntimeError("P=3 sharded frame is dark")
    zero_counts()
    energy3 = par.sharded_total_energy(s3, mesh3)
    e_counts = read_counts()
    pe1 = en.potential_energy(s3.pos, s3.mass, SOFTENING2).item()
    ke1 = en.kinetic_energy(s3.vel, s3.mass).item()
    pe3, ke3 = (energy3["potential_energy"].item(),
                energy3["kinetic_energy"].item())
    log(f"P=3 sharded_total_energy: U {pe3:.6e} (single device "
        f"{pe1:.6e}), KE {ke3:.6e} ({ke1:.6e}); launches {e_counts}")
    if (e_counts != {"K6": 9} or abs(pe3 - pe1) > 1e-5 * abs(pe1)
            or abs(ke3 - ke1) > 1e-5 * abs(ke1)):
        raise RuntimeError(f"P=3 sharded energy {energy3}, launches "
                           f"{e_counts}")
    # K6 at the ring's shard shape: one of sharded_total_energy's 9 calls.
    p3i, m3i = st3.pos[:l3].contiguous(), st3.mass[:l3].contiguous()
    p3j = st3.pos[l3:2 * l3].contiguous()
    m3j = st3.mass[l3:2 * l3].contiguous()
    phi3_plain = en.allpairs_potential_ref(p3i, None, p3j, m3j, SOFTENING2)
    hold(f"potential at the P=3 shard shape (Ni=Nj={l3}) vs plain (bound "
         "relative per target)", en.allpairs_potential(
             p3i, m3i, p3j, m3j, SOFTENING2), phi3_plain, phi3_plain.abs())
    ms_pot3 = timed_ms(lambda: en.allpairs_potential(
        p3i, m3i, p3j, m3j, SOFTENING2), reps=10)
    pot3_bound = bound("pot", "exact", float(l3) * l3, 24.0 * l3, "allpairs",
                       "potential_kernelILb1EE")
    pplan3 = en.potential_launch_plan(l3, l3, dev, SOFTENING2)
    log(f"potential at Ni=Nj={l3}: kernel {ms_pot3:.4f} ms, bound "
        f"{pot3_bound[0]:.4f} ms by {pot3_bound[1]} ({pot3_bound[2]}); grid "
        f"{pplan3.target_blocks} target blocks x {pplan3.chunks} chunks of "
        f"{pplan3.chunk} sources")
    del p3i, m3i, p3j, m3j, phi3_plain
    ms_ring3 = timed_ms(lambda: par.ring_allpairs_accel(
        st3.pos, st3.mass, mesh3, rcp=main_ap), reps=10)
    ms_step3 = timed_ms(lambda: step3(st3), reps=10)
    ms_k2_3 = timed_ms(lambda: ap.allpairs_accel_sym(
        st3.pos, st3.mass, SOFTENING2, rcp=main_ap), reps=10)
    log(f"P=3 galaxy: ring force {ms_ring3:.4f} ms, sharded step "
        f"{ms_step3:.4f} ms; single-device K2 on the same N={st3.n} "
        f"{ms_k2_3:.4f} ms (CUDA events, 10 calls)")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step3(st3)
        torch.cuda.synchronize()
    dev_total = device_ms(prof) / 2
    rounds = device_ms(prof, "allpairs_sym_rounds", "sym_fold") / 2
    n_ops = sum(1 for e in prof.events() if on_device(e)) / 2
    if dev_total <= 0 or rounds <= 0:
        raise RuntimeError("P=3 step trace recorded no device time")
    log(f"P=3 step trace (2 steps): device time {dev_total:.3f} ms per step "
        f"in {n_ops:.0f} device operations; K2 and K9 rounds and folds "
        f"{rounds:.3f} ms ({rounds / dev_total:.0%}), the rest (finishes, "
        f"shard copies, "
        f"adds, integration) {dev_total - rounds:.3f} ms")

    # K9 alone at the P=3 galaxy's shard shape: shard 0 against shard 1.
    pi, mi = st3.pos[:l3].contiguous(), st3.mass[:l3].contiguous()
    pj, mj = st3.pos[l3:2 * l3].contiguous(), st3.mass[l3:2 * l3].contiguous()
    k9_err = hold_k9(f"K9 L={l3} (galaxy shards 0, 1)", pi, mi, pj, mj,
                     RCP_MODES)
    _, ms_k9_plain = plain_timed(lambda: ap.allpairs_accel_sym_pair_ref(
        pi, mi, pj, mj, SOFTENING2))
    ms_k9 = timed_ms(lambda: ap.allpairs_accel_sym_pair(
        pi, mi, pj, mj, SOFTENING2, rcp=main_ap), reps=20)
    k9_bound = bound("sym", main_ap, float(l3) * l3, 40.0 * l3, "allpairs",
                     f"allpairs_sym_roundsILi{mode}ELb0E")
    log(f"K9 at L={l3}: kernel {ms_k9:.4f} ms, plain {ms_k9_plain:.3f} ms "
        f"(once), bound {k9_bound[0]:.4f} ms by {k9_bound[1]} "
        f"({k9_bound[2]})")
    sym_plan("K9 at the P=3 shard", l3, main_ap, False)
    # K2 at the same shard shape: the symmetric ring's self stage.
    ms_k2_l3 = timed_ms(lambda: ap.allpairs_accel_sym(
        pi, mi, SOFTENING2, rcp=main_ap), reps=20)
    k2_l3_bound = bound("sym", main_ap, float(l3) * l3 / 2.0, 20.0 * l3,
                        "allpairs", f"allpairs_sym_roundsILi{mode}ELb0E")
    log(f"K2 at L={l3} (the P=3 ring's self stage): kernel {ms_k2_l3:.4f} ms, "
        f"bound {k2_l3_bound[0]:.4f} ms by {k2_l3_bound[1]}")
    sym_plan("K2 at the P=3 shard", l3, main_ap, True)

    # K9's NaN pattern, one NaN x on the i side. exact: that row's x NaN and
    # y 0, every j row's x NaN and y finite. +clamp: max(NaN, clamp) is NaN,
    # so the NaN row and every j row are NaN in both components.
    npi = pi.clone()
    npi[5, 0] = float("nan")
    for rcp in ("exact", "approx+clamp"):
        ai, aj = ap.allpairs_accel_sym_pair(npi, mi, pj, mj, SOFTENING2,
                                            rcp=rcp)
        torch.cuda.synchronize()
        others = torch.cat([ai[:5], ai[6:]])
        if rcp == "exact":
            ok = (bool(torch.isnan(ai[5, 0])) and ai[5, 1].item() == 0.0
                  and bool(torch.isnan(aj[:, 0]).all())
                  and bool(torch.isfinite(aj[:, 1]).all()))
        else:
            ok = (bool(torch.isnan(ai[5]).all())
                  and bool(torch.isnan(aj).all()))
        if not (ok and bool(torch.isfinite(others).all())):
            raise RuntimeError(f"K9 rcp={rcp}: NaN pattern differs")
    log("K9 NaN pattern (one NaN x on the i side): exact, that row x NaN and "
        "y 0, every j row x NaN and y finite; approx+clamp, that row and "
        "every j row NaN; other i rows finite")
    del npi, ai, aj, others

    # The galaxy at P=4: auto dispatch takes the ordered ring (K2 self, K1
    # visiting), and the replicated-tree Barnes-Hut.
    mesh4 = par.LocalMesh(4, dev)
    st4 = par.shard_state(gal_host, mesh4)
    zero_counts()
    ring4 = par.ring_allpairs_accel(st4.pos, st4.mass, mesh4, rcp=main_ap)
    p4_counts = read_counts()
    single4 = ap.allpairs_accel_sym(st4.pos, st4.mass, SOFTENING2,
                                    rcp=main_ap)
    if p4_counts != {"K2": 4, "K1": 12}:
        raise RuntimeError(f"P=4 ring launches {p4_counts}")
    ring4_err = hold(f"P=4 ordered ring vs single-device K2 (N={st4.n}, "
                     f"L={st4.n // 4}), {n_real} real rows; launches "
                     f"{p4_counts}", ring4[:n_real], single4[:n_real],
                     gscale[:n_real])
    ms_ring4 = timed_ms(lambda: par.ring_allpairs_accel(
        st4.pos, st4.mass, mesh4, rcp=main_ap), reps=5)
    log(f"P=4 galaxy ordered ring: {ms_ring4:.4f} ms (CUDA events, 5 calls)")
    del ring4, single4
    bh_cfg = SimConfig(force_path="bh")
    zero_counts()
    bh4 = par.bh_sharded_accel(st4.pos, st4.mass, mesh4, config=bh_cfg)
    bh_counts = read_counts()
    bh_f, bh_l = bh_cfg.resolved_caps()
    bh1 = traversal.bh_accel(st4.pos, st4.mass, theta=bh_cfg.theta,
                             frontier_cap=bh_f, leaf_cap=bh_l,
                             rcp=bh_cfg.resolved_rcp(bh=True))
    torch.cuda.synchronize()
    if bh_counts != {"K3": 4}:
        raise RuntimeError(f"bh_sharded launches {bh_counts}")
    hold(f"bh_sharded P=4 galaxy vs single-device bh_accel (theta=50), "
         f"{n_real} real rows, bound relative to the all-pairs sum|c|; "
         f"bitwise equal: {torch.equal(bh4, bh1)}", bh4[:n_real],
         bh1[:n_real], gscale[:n_real])
    del bh4, bh1, st4, ring3

    # ring_allpairs_accel_diff at P=3 against f64 autograd of the direct sum
    # on a random cloud of 3 x 1024.
    drng = np.random.default_rng(8)
    dpos = torch.tensor(drng.uniform(0, 1e5, (3072, 2)).astype(np.float32),
                        device=dev)
    dmass = torch.tensor(drng.integers(1, 100, 3072).astype(np.float32),
                         device=dev)
    dcot = torch.tensor(drng.normal(0, 1, (3072, 2)).astype(np.float32),
                        device=dev)
    p64 = dpos.double().requires_grad_(True)
    m64 = dmass.double().requires_grad_(True)
    (direct_accel(p64, m64, SOFTENING2) * dcot.double()).sum().backward()
    p = dpos.clone().requires_grad_(True)
    m = dmass.clone().requires_grad_(True)
    zero_counts()
    (par.ring_allpairs_accel_diff(p, m, mesh3) * dcot).sum().backward()
    rg_counts = read_counts()
    rel_p = ((p.grad.double() - p64.grad).norm() / p64.grad.norm()).item()
    rel_m = ((m.grad.double() - m64.grad).norm() / m64.grad.norm()).item()
    log(f"ring_allpairs_accel_diff P=3 (N=3072) vs f64 autograd of the "
        f"direct sum: positions {rel_p:.3e}, masses {rel_m:.3e} relative "
        f"norm (bounds 1e-4, 1e-3); launches {rg_counts}")
    if not (rel_p < 1e-4 and rel_m < 1e-3
            and rg_counts == {"K9": 3, "K2": 3, "K7a": 9, "K7b": 9}):
        raise RuntimeError(f"ring gradient {rel_p}, {rel_m}, launches "
                           f"{rg_counts}")
    del p64, m64, p, m

    # The 1,048,576-body disc at P=8 (L=131,072): the even symmetric ring,
    # K=4 rounds with the half round.
    disc8 = uniform_disc(N_BIG, seed=0)
    mesh8 = par.LocalMesh(8, dev)
    st8 = par.shard_state(disc8, mesh8)
    l8 = st8.n // 8
    step8 = par.make_sharded_step(mesh8, pcfg)
    zero_counts()
    s8 = step8(st8)
    p8_counts = read_counts()
    log(f"P=8 disc N={st8.n} (L={l8}): one make_sharded_step step, launches "
        f"{p8_counts}")
    if p8_counts != {"K9": 32, "K2": 8} or not bool(
            torch.isfinite(s8.pos).all()):
        raise RuntimeError(f"P=8 sharded step launches {p8_counts}")
    rows8 = torch.tensor(np.sort(np.random.default_rng(9).choice(
        N_BIG, N_SAMPLED, replace=False)), device=dev)
    ring8 = par.ring_allpairs_accel(st8.pos, st8.mass, mesh8, rcp=main_ap)
    t8 = st8.pos[rows8].contiguous()
    hold(f"P=8 symmetric ring vs plain, N={N_BIG}, {N_SAMPLED} sampled rows",
         ring8[rows8], ap.allpairs_accel_ref(t8, None, st8.pos, st8.mass,
                                             SOFTENING2),
         ap.pair_sums(t8, st8.pos, st8.mass, abs_terms, SOFTENING2))
    del ring8, s8
    ms_step8 = timed_ms(lambda: step8(st8), reps=2, warmup=0)
    log(f"P=8 disc: sharded step {ms_step8:.2f} ms (CUDA events, 2 steps)")
    p8i, m8i = st8.pos[:l8].contiguous(), st8.mass[:l8].contiguous()
    p8j = st8.pos[4 * l8:5 * l8].contiguous()
    m8j = st8.mass[4 * l8:5 * l8].contiguous()
    hold_k9(f"K9 L={l8} (disc shards 0, 4)", p8i, m8i, p8j, m8j, RCP_MODES)
    ms_k9_8 = timed_ms(lambda: ap.allpairs_accel_sym_pair(
        p8i, m8i, p8j, m8j, SOFTENING2, rcp=main_ap), reps=3)
    k9_bound8 = bound("sym", main_ap, float(l8) * l8, 40.0 * l8, "allpairs",
                      f"allpairs_sym_roundsILi{mode}ELb0E")
    log(f"K9 at L={l8}: kernel {ms_k9_8:.4f} ms, bound {k9_bound8[0]:.4f} ms "
        f"by {k9_bound8[1]}")
    sym_plan("K9 at the P=8 shard", l8, main_ap, False)
    sym_plan("K2 at the P=8 shard", l8, main_ap, True)
    del st8, disc8, p8i, m8i, p8j, m8j
    log(f"phase multi-device: {time.perf_counter() - t_phase:.1f} s")

    # -- 11. the application: checkpoint and resume, recording, GIF, viewer --
    # Host layers over the Barnes-Hut galaxy (K3 on every step). Their times
    # are the host's; none of them is a kernel's.
    t_phase = time.perf_counter()
    from nbody_simulation_tpu_torch import render_recording
    from nbody_simulation_tpu_torch.ops.raster import render_frame
    from nbody_simulation_tpu_torch.runtime.engine import Engine
    from nbody_simulation_tpu_torch.state import PAD_POS
    from nbody_simulation_tpu_torch.utils import recording as rec_mod
    from nbody_simulation_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                             save_checkpoint)
    from nbody_simulation_tpu_torch.utils.pngio import encode_png
    from nbody_simulation_tpu_torch.viz import ViewerServer
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    log(f"application: recordings in {rec_mod.CODEC}; PNGs through "
        + ("PIL, GIFs written" if has_pil else
           "utils/pngio's zlib encoder (no PIL here), GIFs skipped"))

    def cli(args):
        """``run.simulate(args)`` on the card, its output captured: (world,
        output, sweep launches)."""
        buf = io.StringIO()
        traversal.grouped_sweep.launches = 0
        with contextlib.redirect_stdout(buf):
            w = run.simulate([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        return w, buf.getvalue(), traversal.grouped_sweep.launches

    every = cfg.resort_every
    if APP_STEPS % every == 0:
        raise RuntimeError("the resume must fall between re-sorts")
    with tempfile.TemporaryDirectory() as tmpd:
        tmp = Path(tmpd)
        # Checkpoint at step 40, resume for 40 more, against 80 unbroken.
        whole, _, l_whole = cli(["--steps", str(2 * APP_STEPS), "--out",
                                 str(tmp / "a"), "--checkpoint",
                                 str(tmp / "ck80.npz")])
        first, _, l_first = cli(["--steps", str(APP_STEPS), "--out",
                                 str(tmp / "b"), "--checkpoint",
                                 str(tmp / "ck40.npz")])
        resumed, out, l_res = cli(["--resume", str(tmp / "ck40.npz"),
                                   "--steps", str(APP_STEPS), "--out",
                                   str(tmp / "c"), "--checkpoint",
                                   str(tmp / "ck80r.npz")])
        if (whole.updates, first.updates, resumed.updates) != (
                2 * APP_STEPS, APP_STEPS, 2 * APP_STEPS):
            raise RuntimeError(f"resume: updates {whole.updates}, "
                               f"{first.updates}, {resumed.updates}")
        if (l_first, l_res, l_whole) != (APP_STEPS, APP_STEPS, 2 * APP_STEPS):
            raise RuntimeError(f"resume: sweep launches {l_first} + {l_res} "
                               f"against {l_whole}")
        live_w, live_r = whole.state.real_slice(), resumed.state.real_slice()
        for k in ("pos", "vel", "mass"):
            if not same_bits(getattr(live_w, k), getattr(live_r, k)):
                raise RuntimeError(f"resume at step {APP_STEPS}: live {k} not "
                                   f"bitwise the unbroken run's")
        with np.load(tmp / "ck80.npz") as za, np.load(tmp / "ck80r.npz") as zb:
            for k in ("step", "n_real", "pos", "vel", "mass"):
                if za[k].tobytes() != zb[k].tobytes():
                    raise RuntimeError(f"resume: checkpoint field {k} differs")
        pad_speed = 0.0
        for w in (whole, resumed):
            n_real = w.state.n_real
            n_pad = w.state.n - n_real
            want = (torch.full((n_pad, 2), PAD_POS, device=dev)
                    + torch.arange(n_pad, dtype=torch.float32,
                                   device=dev)[:, None])
            if not torch.equal(w.state.pos[n_real:], want) \
                    or w.state.mass[n_real:].any():
                raise RuntimeError("padding rows moved or gained mass")
            pad_speed = max(pad_speed,
                            w.state.vel[n_real:].abs().max().item())
        log(f"resume: {APP_STEPS} steps, checkpoint, {APP_STEPS} resumed "
            f"steps bitwise {2 * APP_STEPS} unbroken ones (live pos, vel, "
            f"mass; the checkpoints byte for byte); updates "
            f"{resumed.updates}; sweep launches {l_first} + {l_res} against "
            f"{l_whole}; {n_pad} padding rows at their sentinels, mass 0, "
            f"speed at most {pad_speed:.3e} (the live particles' pull; no "
            f"position moves by it)")
        save_ms, load_ms = [], []
        for k in range(3):
            t0 = time.perf_counter()
            save_checkpoint(tmp / f"t{k}.npz", live_r, resumed.updates)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            st, step = load_checkpoint(tmp / f"t{k}.npz")
            load_ms.append((time.perf_counter() - t0) * 1e3)
        if step != 2 * APP_STEPS or not same_bits(st.pos, live_r.pos.cpu()):
            raise RuntimeError("checkpoint round trip differs")
        log(f"checkpoint of the galaxy ({live_r.n} bodies): save "
            + ", ".join(f"{t:.2f}" for t in save_ms) + " ms (device copy "
            f"included), load " + ", ".join(f"{t:.2f}" for t in load_ms)
            + f" ms, {(tmp / 't0.npz').stat().st_size} bytes")

        # Recording, GIF and the offline renderer.
        rworld, out, l_rec = cli(["--steps", str(APP_STEPS), "--out",
                                  str(tmp / "d"), "--record",
                                  str(tmp / "r.bin"), "--gif",
                                  str(tmp / "a.gif"), "--checkpoint",
                                  str(tmp / "ckr.npz")])
        if l_rec != APP_STEPS:
            raise RuntimeError(f"record run: {l_rec} sweep launches")
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("recording:", "gif:"))]
        for line in lines:
            log(f"  run: {line}")
        if has_pil:
            if not (tmp / "a.gif").read_bytes().startswith(b"GIF89a"):
                raise RuntimeError("--gif wrote no GIF")
        elif "gif: PIL unavailable, skipped" not in out \
                or (tmp / "a.gif").exists():
            raise RuntimeError("--gif without PIL: no skip message")
        frames = list(rec_mod.playback(tmp / "r.bin"))
        n_real = rworld.state.n_real
        ref = World(galaxy(seed=0).to(dev), SimConfig(force_path="bh"))
        truth, masses = {}, {}
        for step in sorted({s for s, _ in frames}):
            ref.run(step - ref.updates)
            truth[step] = ref.state.pos[:n_real].cpu().numpy()
            masses[step] = ref.state.mass[:n_real].clone()
        if not same_bits(torch.from_numpy(truth[APP_STEPS]),
                         rworld.state.pos[:n_real].cpu()):
            raise RuntimeError("a fresh World does not retrace the run")
        big = max(float(np.abs(t).max()) for t in truth.values())
        ulp = float(np.spacing(np.float32(big)))
        errs = []
        for k, (step, pos) in enumerate(frames):
            err = float(np.abs(pos - truth[step]).max())
            errs.append(err / ulp)
            # Frame k adds k deltas, each rounded twice (the delta and the
            # sum) by at most 1 and 1/2 ulp of the largest coordinate.
            if err > 2 * k * ulp:
                raise RuntimeError(f"playback frame {k} (step {step}): "
                                   f"{err:.3e} from the run, bound "
                                   f"{2 * k} ulp of {big:.4e}")
        log(f"playback: {len(frames)} frames at steps "
            f"{[s for s, _ in frames]}; max |playback - run| per frame in "
            f"ulps of the largest coordinate {big:.4e} (ulp {ulp:.3e}): "
            + ", ".join(f"{e:.2f}" for e in errs) + " (bound 2 per delta "
            "frame)")
        rec = rec_mod.Recorder(tmp / "t.bin")
        rec_ms = []
        for step in sorted(truth):
            t0 = time.perf_counter()
            rec.record(truth[step], step)
            rec_ms.append((time.perf_counter() - t0) * 1e3)
        rec.close()
        log(f"recorder ({rec_mod.CODEC}): " + ", ".join(
            f"{t:.2f}" for t in rec_ms) + f" ms per frame; raw "
            f"{rec.raw_bytes // rec.frames} bytes per frame, compressed "
            f"{rec.comp_bytes / rec.frames:.0f} (first frame absolute)")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            render_recording.main([str(tmp / "r.bin"), "--out",
                                   str(tmp / "rr"), "--state",
                                   str(tmp / "ckr.npz"), "--device", "cuda"])
        torch.cuda.synchronize()
        rr_s = time.perf_counter() - t0
        last = tmp / "rr" / f"frame_{APP_STEPS:08d}.png"
        lit = lit_pixels(last)
        if lit == 0:
            raise RuntimeError(f"render_recording: last frame dark ({last})")
        # --state maps the checkpoint's masses by row, and rows follow the
        # re-sorts: only frames after the last re-sort get the right ones.
        wrong = []
        for step, pos in frames:
            tpos = torch.from_numpy(pos).to(dev)
            want = render_frame(tpos, torch.zeros_like(tpos), masses[step])
            got = png_rgba((tmp / "rr" / f"frame_{step:08d}.png")
                           .read_bytes())
            wrong.append(int((got != want.cpu().numpy()).any(-1).sum()))
        log(f"render_recording --device cuda: {len(frames)} frames in "
            f"{rr_s:.2f} s, the last with {lit} lit pixels; pixels that "
            f"differ from a render with the masses of the recording's rows: "
            f"{wrong} (the --state row mapping is exact only after the last "
            f"re-sort, step {APP_STEPS // every * every})")
        if wrong[-1] != 0:
            raise RuntimeError("render_recording --state: the last frame, "
                               "after the last re-sort, is mis-tinted")

        # ups with the particle readback of --record and without it.
        uworld = World(galaxy(seed=0).to(dev), SimConfig(force_path="bh"))
        uworld.run(every + 1)
        rates = []
        for turn, include in enumerate((False, True, True, False)):
            eng = Engine(uworld, include_particles=include,
                         steps_per_snapshot=10, snapshot_interval=0.0)
            urec = (rec_mod.Recorder(tmp / f"u{turn}.bin") if include
                    else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.start(max_steps=uworld.updates + 2 * APP_STEPS)
            while (snap := eng.next_snapshot(timeout=None)) is not None:
                if urec is not None:
                    urec.maybe_record(snap.pos, snap.step)
            eng.join(timeout=120)
            eng.stop()
            rates.append(2 * APP_STEPS / (time.perf_counter() - t0))
            if urec is not None:
                urec.close()
        log(f"galaxy ups through the engine, {2 * APP_STEPS} steps each, in "
            f"turns without/with/with/without --record's particle readback "
            f"and recorder: " + ", ".join(f"{r:.1f}" for r in rates))

    # The viewer over a galaxy engine, driven over HTTP.
    vworld = World(galaxy(seed=0).to(dev), SimConfig(force_path="bh"))
    veng = Engine(vworld, steps_per_snapshot=10, snapshot_interval=0.0)
    viewer = ViewerServer(veng, port=0)
    base = f"http://127.0.0.1:{viewer.port}"

    def get(path: str) -> bytes:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read()

    def stats() -> dict:
        return json.loads(get("/stats"))

    def until(cond, what: str, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"viewer: {what} not reached in "
                                   f"{timeout} s")
            time.sleep(0.02)

    viewer.start()
    veng.start(max_steps=None)
    try:
        until(lambda: stats()["step"] > 0, "a first frame")
        s1 = stats()["step"]
        until(lambda: stats()["step"] > s1, "/stats advancing")
        parts, tail = 0, b""
        with urllib.request.urlopen(base + "/stream", timeout=30) as r:
            t0 = time.monotonic()
            while time.monotonic() - t0 < VIEWER_STREAM_S:
                chunk = tail + r.read1(1 << 16)
                parts += chunk.count(b"--frame\r\n")
                tail = chunk[-8:]
            stream_s = time.monotonic() - t0
        get("/control?cmd=pause")
        until(lambda: stats()["paused"], "pause")
        time.sleep(0.5)  # a batch under way when the flag was set ends
        u0 = vworld.updates
        time.sleep(0.5)
        if vworld.updates != u0:
            raise RuntimeError("viewer: pause did not freeze updates")
        until(lambda: viewer.latest is not None and viewer.latest.step == u0,
              "a frame of the paused state")
        png = get("/frame.png")
        if not np.array_equal(png_rgba(png), viewer.latest.frame):
            raise RuntimeError("viewer: /frame.png is not the snapshot's "
                               "frame")
        get("/control?cmd=step")
        until(lambda: vworld.updates >= u0 + veng.steps_per_snapshot,
              "a step")
        time.sleep(0.5)
        if vworld.updates != u0 + veng.steps_per_snapshot or not veng.paused:
            raise RuntimeError(f"viewer: step went {u0} -> {vworld.updates}")
        get("/control?theta=40")
        until(lambda: vworld.config.theta == 40.0, "the theta retune")
        get("/control?cmd=quit")
        veng.join(timeout=60)
        if veng._thread.is_alive():
            raise RuntimeError("viewer: quit left the producer running")
    finally:
        veng._stop.set()
        veng.stop()
        viewer.stop()
    enc_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_png(viewer.latest.frame)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"viewer: /stats advanced, {parts} frames pushed on /stream in "
        f"{stream_s:.2f} s ({parts / stream_s:.2f} per s); pause held "
        f"updates at {u0}, step went to {u0 + veng.steps_per_snapshot}, "
        f"theta 40 reached world.config, quit ended the producer; PNG "
        f"encode of a {viewer.latest.frame.shape[0]}^2 frame "
        + ", ".join(f"{t:.2f}" for t in enc_ms) + f" ms, {len(png)} bytes "
        + ("(PIL)" if has_pil else "(utils/pngio)"))
    log(f"phase application: {time.perf_counter() - t_phase:.1f} s")

    # -- 12. the fully distributed Barnes-Hut path ----------------------------
    dist_launches, dist_rows = distributed_phase(helpers)
    for name, (err, ms, plain_ms, bd) in dist_rows.items():
        log(f"{name}: max |d| {err:.3e}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}")

    # -- 13. the distributed CLI ----------------------------------------------
    cli_numbers = cli_phase(helpers)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bd):
        return {"name": name, "route": "cuda",
                "source": f"nbody_simulation_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None}

    kernels = {"kernels": [
        entry("grouped_sweep", "grouped_sweep.cu",
              "nbody_simulation_tpu/ops/traversal.py:210", launches,
              max_abs_err[main_rcp], ms_bound, ms_plain, sweep_bound),
        entry("grouped_sweep_quad", "grouped_sweep.cu",
              "nbody_simulation_tpu/ops/traversal.py:149", quad_launches,
              quad_err[quad_rcp], ms_qbound, ms_qplain, quad_bound),
        entry("allpairs_sym", "allpairs.cu",
              "nbody_simulation_tpu/ops/allpairs.py:290", sym_launches,
              sym_err[main_ap], ms_sym, ms_sym_plain, sym_bound),
        entry("allpairs", "allpairs.cu",
              "nbody_simulation_tpu/ops/allpairs.py:537", k1_launches,
              ord_err[main_ap], ms_ord, ms_ord_plain, ord_bound),
        entry("potential", "allpairs.cu",
              "nbody_simulation_tpu/ops/energy.py:118", pot_launches,
              pot_err, ms_pot, ms_pot_plain, pot_bound),
        entry("allpairs_bwd_i", "force_grad.cu",
              "nbody_simulation_tpu/ops/allpairs_grad.py:183",
              vg_launches["all-pairs galaxy (padded)"]["K7a"], k7a_err,
              ms_k7a, ms_k7a_plain, k7a_bound),
        entry("allpairs_bwd_j", "force_grad.cu",
              "nbody_simulation_tpu/ops/allpairs_grad.py:198",
              vg_launches["all-pairs galaxy (padded)"]["K7b"], k7b_err,
              ms_k7b, ms_k7b_plain, k7b_bound),
        entry("grouped_bwd_tgt", "force_grad.cu",
              "nbody_simulation_tpu/ops/traversal_grad.py:128", traj["K8a"],
              *k8_main["K8a"]),
        entry("grouped_bwd_src", "force_grad.cu",
              "nbody_simulation_tpu/ops/traversal_grad.py:143", traj["K8b"],
              *k8_main["K8b"]),
        entry("allpairs_sym_pair", "allpairs.cu",
              "nbody_simulation_tpu/ops/allpairs.py:441", p3_counts["K9"],
              k9_err[main_ap], ms_k9, ms_k9_plain, k9_bound),
        dict(entry("segment_sum", "segment_sum.cu", SEG_REPLACES,
                   traj["SEG"], seg_err, ms_seg, ms_seg_plain, seg_bound),
             library_ms=ms_seg_lib),
    ]}
    log(f"chip_smoke: every check passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"distributed BH launches per kernel: {json.dumps(dist_launches)}")
    log(f"distributed CLI: {json.dumps(cli_numbers)}")
    log(f"step graphs' capture seconds: {json.dumps(graph_capture_s)}")
    log(f"engine overlap: {json.dumps(overlap)}")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
