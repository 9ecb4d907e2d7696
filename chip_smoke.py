#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card. It
builds the port's CUDA kernel from ``nbody_simulation_tpu_torch/csrc/``,
holds it against its plain PyTorch version at the main path's shapes,
checks Barnes-Hut at θ=0 against an f64 direct sum, and drives the main
path (``python -m nbody_simulation_tpu_torch.run`` with its defaults: the
reference galaxy, Barnes-Hut θ=50, sparse raster, PNG output) for 64 steps.
Every check that fails raises, and the exit code is then nonzero. Progress
lines carry the card's name and power limit. The second-to-last line holds
the kernel table as JSON, the line before it the card, and the last line is
``{"ok": true, "device": {...}}``.

Nothing of JAX is imported: the card's machine has none.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SOFTENING2 = 1e-3
# |kernel - plain| per target and component, relative to Σ_j |c_ij|. In
# `exact` the per-pair terms are the same IEEE operations and only the
# summation order differs (the kernel adds runs of 32 columns, torch
# reduces pairwise): ~1e-6 of Σ|c| at the galaxy. The other modes multiply
# by the hardware reciprocal (1 ulp) instead of dividing, a few ulps per
# pair, so they add a few 1e-7 of Σ|c| at most. The plain version is always
# `exact`, so every mode is held to it with the same bound, which a wrong
# mask or reciprocal step exceeds by orders of magnitude.
SUM_ORDER_RTOL = 1e-5
STEPS = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    from nbody_simulation_tpu_torch.models.scenarios import (galaxy,
                                                             uniform_disc)
    from nbody_simulation_tpu_torch.ops import traversal
    from nbody_simulation_tpu_torch.ops.force import direct_accel, pair_accel
    from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
    from nbody_simulation_tpu_torch.ops.tree import summarize_sorted
    from nbody_simulation_tpu_torch.utils.telemetry import Counting

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg: str) -> None:
        print(f"{msg}  [{card}]", flush=True)

    # -- 1. environment -------------------------------------------------------
    log(f"card: {card}; torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    banned = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "nbody_simulation_tpu."))
              or m == "nbody_simulation_tpu"]
    if banned:
        raise RuntimeError(f"JAX or the JAX package was imported: {banned}")
    t0 = time.perf_counter()
    traversal._load_sweep_lib()
    log(f"kernel grouped_sweep built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({library_path('grouped_sweep')})")

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

    def abs_sum(tgt, sx, sy, sm, chunk=64):
        """Σ_j |c_ij| per target and component, for the tolerances."""
        out = torch.empty_like(tgt)
        for g0 in range(0, tgt.shape[0], chunk):
            sl = slice(g0, g0 + chunk)
            ax, ay = pair_accel(sx[sl, None, :] - tgt[sl, :, 0:1],
                                sy[sl, None, :] - tgt[sl, :, 1:2],
                                sm[sl, None, :], SOFTENING2)
            out[sl, :, 0] = ax.abs().sum(-1)
            out[sl, :, 1] = ay.abs().sum(-1)
        return out

    # -- 2. kernel vs plain version at the main path's shapes -----------------
    cfg = SimConfig(force_path="bh")
    st = galaxy(seed=0).to(dev).pad_to(256)
    spos, _, smass = morton_sort_state(st.pos, st.vel, st.mass,
                                       cfg.world_size,
                                       bits=cfg.resolved_morton_bits())
    tree = summarize_sorted(spos, smass, leaf_size=cfg.leaf_size)
    fcap, lcap = cfg.resolved_caps()
    sx, sy, sm = traversal.bh_plan_sources(tree, cfg.theta, fcap, lcap,
                                           plan_leaves=cfg.plan_leaves)
    g, c = sx.shape
    tgt = tree.leaf_pos.reshape(g, -1, 2)
    s = tgt.shape[1]
    log(f"galaxy sweep shape: G={g} S={s} C={c} "
        f"({g * s * c / 1e6:.1f}M pairs)")
    if (g, s, c) != (1024, 256, 1280):
        raise RuntimeError(f"unexpected main-path shape {(g, s, c)}")
    lim = traversal.last_nonzero_columns(sm)
    log(f"per-group bound: mean last nonzero column "
        f"{lim.float().mean().item():.1f} of {c} "
        f"({lim.sum().item() / (g * c):.3f} of the full sweep's pairs)")

    plain = traversal.grouped_force_ref(tgt, sx, sy, sm, SOFTENING2)
    scale = abs_sum(tgt, sx, sy, sm)
    main_rcp = cfg.resolved_rcp(bh=True)
    max_abs_err = {}
    for rcp in RCP_MODES:
        full = traversal.grouped_sweep(tgt, sx, sy, sm, SOFTENING2, rcp)
        bound = traversal.grouped_sweep(tgt, sx, sy, sm, SOFTENING2, rcp,
                                        col_limit=lim)
        torch.cuda.synchronize()
        if not torch.isfinite(full).all():
            raise RuntimeError(f"{rcp}: non-finite kernel output")
        if not torch.equal(full, bound):
            raise RuntimeError(f"{rcp}: bounded sweep differs from the full "
                               f"sweep (max {(full - bound).abs().max()})")
        err = (full - plain).abs()
        max_abs_err[rcp] = err.max().item()
        ratio = (err / scale.clamp_min(1e-30)).max().item()
        log(f"rcp={rcp}: kernel vs plain (exact) max |d| "
            f"{max_abs_err[rcp]:.3e}, max |d|/sum|c| {ratio:.3e} "
            f"(bound {SUM_ORDER_RTOL:g}); bounded == full bitwise")
        if not bool((err <= SUM_ORDER_RTOL * scale).all()):
            raise RuntimeError(f"rcp={rcp}: kernel disagrees with the plain "
                               f"version: max |d|/sum|c| {ratio:.3e}")

    ms_full = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, main_rcp), reps=50)
    ms_bound = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, main_rcp, col_limit=lim), reps=50)
    ms_exact = timed_ms(lambda: traversal.grouped_sweep(
        tgt, sx, sy, sm, SOFTENING2, "exact", col_limit=lim), reps=50)
    ms_plain = timed_ms(lambda: traversal.grouped_force_ref(
        tgt, sx, sy, sm, SOFTENING2), reps=5, warmup=1)
    log(f"sweep time at (1024, 256, 1280): kernel rcp={main_rcp} full "
        f"{ms_full:.4f} ms, bounded {ms_bound:.4f} ms; kernel exact bounded "
        f"{ms_exact:.4f} ms; plain torch {ms_plain:.3f} ms")

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
    for rcp in ("exact", "newton"):
        bh0 = traversal.bh_accel(disc.pos, disc.mass, theta=0.0, multipole=1,
                                 rcp=rcp)
        ratio = ((bh0.double() - d64).abs() / scale0.clamp_min(1e-300)).max()
        log(f"theta=0 BH (N=16384, rcp={rcp}) vs f64 direct: max "
            f"|d|/sum|c| {ratio.item():.3e} (bound {SUM_ORDER_RTOL:g})")
        if not ratio.item() <= SUM_ORDER_RTOL:
            raise RuntimeError(f"theta=0 BH ({rcp}) differs from direct sum")

    # -- 4. the main path -----------------------------------------------------
    from nbody_simulation_tpu_torch import run

    mass0 = galaxy(seed=0).mass.double().sum().item()
    with tempfile.TemporaryDirectory() as tmp:
        traversal.grouped_sweep.launches = 0
        t0 = time.perf_counter()
        world = run.simulate(["--steps", str(STEPS), "--out", tmp,
                              "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = traversal.grouped_sweep.launches
        png = Path(tmp) / f"frame_{STEPS:08d}.png"
        png_bytes = png.stat().st_size if png.exists() else 0
        try:
            from PIL import Image
            lit = (int((np.asarray(Image.open(png))[..., 3] > 0).sum())
                   if png_bytes else 0)
        except ImportError:
            from nbody_simulation_tpu_torch.ops.raster import render_frame
            w = world.state
            lit = int((render_frame(w.pos, w.vel, w.mass)[..., 3] > 0).sum())
    log(f"main path: {STEPS} galaxy steps in {wall:.2f} s wall (process "
        f"start-up, scenario and first launches included); sweep launches "
        f"{launches}")
    if launches != STEPS:
        raise RuntimeError(f"sweep kernel launched {launches} times in "
                           f"{STEPS} steps")
    pos = world.state.pos[:world.state.n_real]
    if not bool(torch.isfinite(pos).all()):
        raise RuntimeError("non-finite positions after the main path")
    mass1 = world.state.mass.double().sum().item()
    if mass1 != mass0:
        raise RuntimeError(f"total mass changed: {mass0} -> {mass1}")
    if not png_bytes or lit == 0:
        raise RuntimeError(f"final frame missing or dark ({png}, {lit} lit)")
    log(f"main path checks: positions finite, mass {mass1:.1f} unchanged, "
        f"final PNG {png_bytes} bytes with {lit} lit pixels")

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

    kernels = {"kernels": [{
        "name": "grouped_sweep", "route": "cuda",
        "source": "nbody_simulation_tpu_torch/csrc/grouped_sweep.cu",
        "replaces": "nbody_simulation_tpu/ops/traversal.py:210",
        "launches": launches, "max_abs_err": max_abs_err[main_rcp],
        "ms": ms_bound, "plain_ms": ms_plain}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
