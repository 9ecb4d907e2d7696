#!/usr/bin/env python3
"""Barnes-Hut value+grad on the card: bitwise on two calls, and its time,
for several checkouts in turns.

    python3 tools/grad_repro_ab.py [--out FILE] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding a checkout of the repository (``.``
for this tree; an earlier commit unpacked with ``git archive <commit> |
tar -x -C DIR``). The runs go in the order given, so ``A B B A`` compares
two versions in turns. Each run is one process with ``PYTHONPATH`` set to
its checkout, which builds that checkout's kernels and measures, through
the public entry points only:

- the galaxy's ``bh_accel_diff`` (151,317 bodies, θ=50) with the loss
  Σ|a|²: two calls on the same inputs, ``torch.equal`` of the output and
  of the position and mass gradients, and how many entries differ; the
  value+grad time (gradient of the positions, CUDA events over 10 calls
  after warm-up, and the host clock over the same) and the forward alone;
  one traced call's device time (each device event once), device
  operations and the segmented sum's device time;
- the P=4 ``bh_distributed_accel_diff`` on the galaxy's first 2^17 rows
  (``LocalMesh(4)`` on the card, the caps of the equivalence contract) at
  θ=50 and θ=0.5 with a random cotangent: the same two-call check, the
  value+grad time (3 calls), one traced call's device time, operations
  and segmented-sum time, and how many mass-gradient entries lie beyond
  1e-8 + 2e-4·|g_m| of the single-device ``bh_accel_diff`` gradient, and
  beyond it between two single-device calls;
- the segmented sum of the planner's gathers' backward
  (``ops/traversal.py:segment_sum_cuda``, through the checkout's own
  interface) at the largest call of the galaxy value+grad and of each
  distributed one, CUDA events over 20 calls, and ``index_add_ordered``
  (the sort and the sum) there.

Prints one JSON line per run and, last, one JSON object of all of them;
``--out`` also writes it to a file. Exits 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_GRAD = 131_072  # the galaxy's first 2^17 rows: P=4 shards, no padding


def _timed_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _same(a, b) -> dict:
    import torch
    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    diff = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    return {"bitwise": bool(same), "differing": int(diff.sum()),
            "max_abs_diff": float((a - b).abs().max())}


def _two_calls(fn) -> dict:
    """``fn()`` → (output, position grad, mass grad), twice."""
    first, second = fn(), fn()
    return {name: _same(x, y) for name, x, y in
            zip(("out", "grad_pos", "grad_mass"), first, second)}


def _largest_gather(fn) -> tuple:
    """Run ``fn()`` with the planner's gather backward captured; the
    largest call's (n_rows, idx, src)."""
    from nbody_simulation_tpu_torch.ops import traversal
    calls, real = [], traversal.index_add_ordered

    def capture(n_rows, idx, src):
        calls.append((n_rows, idx, src))
        return real(n_rows, idx, src)

    traversal.index_add_ordered = capture
    try:
        fn()
    finally:
        traversal.index_add_ordered = real
    return max(calls, key=lambda c: c[2].numel())


def _segment_times(n_rows, idx, src) -> dict:
    """The segmented sum's wrapper alone and ``index_add_ordered`` at one
    call. Checkouts before the windowed kernel take (perm, edges)."""
    import torch
    from nbody_simulation_tpu_torch.ops import traversal as tt
    flat = src.reshape(src.shape[0], -1).contiguous()
    if hasattr(tt, "_sorted_segments"):
        perm, edges = tt._sorted_segments(idx, n_rows)
        args = (flat, perm, edges)
    else:
        key, perm = torch.sort(idx, stable=True)
        args = (flat, key, perm, n_rows)
    return {"K": flat.shape[0], "W": flat.shape[1], "rows": n_rows,
            "index_dtype": str(idx.dtype),
            "kernel_ms": _timed_ms(lambda: tt.segment_sum_cuda(*args), 20),
            "index_add_ordered_ms": _timed_ms(
                lambda: tt.index_add_ordered(n_rows, idx, flat), 20)}


def _traced(fn) -> dict:
    """One traced ``fn()``: device time, device operations, the segmented
    sum's device time and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")
    events = prof.key_averages()
    top = sorted((e for e in events if on_device(e)), key=dev_us,
                 reverse=True)[:6]
    # Each device event once; the sum over every key_averages() entry also
    # counts each kernel launched inside an operator under the operator.
    return {"device_ms": sum(dev_us(e) for e in prof.events()
                             if on_device(e)) / 1e3,
            "all_entries_ms": sum(dev_us(e) for e in events) / 1e3,
            "device_ops": sum(1 for e in prof.events() if on_device(e)),
            "segment_ms": sum(dev_us(e) for e in prof.events()
                              if on_device(e) and "segment_" in e.name) / 1e3,
            "top": [[e.key[:70], dev_us(e) / 1e3, e.count] for e in top]}


def worker() -> dict:
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.scenarios import galaxy
    from nbody_simulation_tpu_torch.ops import traversal_grad as tgr
    from nbody_simulation_tpu_torch.state import ParticleState

    dev = torch.device("cuda")
    gal = galaxy(seed=0).to(dev)
    res = {"torch": torch.__version__}

    def galaxy_call():
        p = gal.pos.detach().requires_grad_(True)
        m = gal.mass.detach().requires_grad_(True)
        a = tgr.bh_accel_diff(p, m)
        gp, gm = torch.autograd.grad((a * a).sum(), (p, m))
        return a.detach(), gp, gm

    def value_grad():
        p = gal.pos.detach().requires_grad_(True)
        a = tgr.bh_accel_diff(p, gal.mass)
        return torch.autograd.grad((a * a).sum(), (p,))[0]

    galaxy_call()
    res["galaxy"] = {"two_calls": _two_calls(galaxy_call),
                     "value_grad_ms": _timed_ms(value_grad, 10),
                     "forward_ms": _timed_ms(
                         lambda: tgr.bh_accel_diff(gal.pos, gal.mass), 10)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        value_grad()
    torch.cuda.synchronize()
    res["galaxy"]["value_grad_wall_ms"] = (time.perf_counter() - t0) * 100
    res["galaxy"]["segment_sum"] = _segment_times(*_largest_gather(
        value_grad))
    res["galaxy"]["trace"] = _traced(value_grad)

    mesh = par.LocalMesh(4, dev)
    g = galaxy(seed=0)
    g = ParticleState(g.pos[:N_GRAD], g.vel[:N_GRAD], g.mass[:N_GRAD])
    fcap, lcap = N_GRAD // 64 // 2, N_GRAD // 64
    for theta in (50.0, 0.5):
        cfg = SimConfig(force_path="bh", theta=theta,
                        unweighted_leaf_com=False, frontier_cap=fcap,
                        leaf_cap=lcap, plan_leaves=1, far_mode="ring",
                        far_frontier_cap=fcap, far_leaf_cap=lcap,
                        morton_bits=15, multipole=1)
        ds = par.distribute_state(g, mesh, cfg)
        cot = torch.tensor(np.random.default_rng(3).normal(
            0, 1, (ds.n, 2)).astype(np.float32), device=dev)

        def dist_call():
            p = ds.pos.clone().requires_grad_(True)
            m = ds.mass.clone().requires_grad_(True)
            a = par.bh_distributed_accel_diff(p, m, mesh, config=cfg)
            gp, gm = torch.autograd.grad((a * cot).sum(), (p, m))
            return a.detach(), gp, gm

        def single_call():
            p = ds.pos.clone().requires_grad_(True)
            m = ds.mass.clone().requires_grad_(True)
            a = tgr.bh_accel_diff(p, m, theta=theta, frontier_cap=fcap,
                                  leaf_cap=lcap, unweighted_leaf_com=False,
                                  plan_leaves=1,
                                  rcp=cfg.resolved_rcp(bh=True))
            gp, gm = torch.autograd.grad((a * cot).sum(), (p, m))
            return a.detach(), gp, gm

        two = _two_calls(dist_call)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            dist_call()
        torch.cuda.synchronize()
        vg_ms = (time.perf_counter() - t0) * 1e3 / reps
        gm = dist_call()[2]
        gm1, gm2 = single_call()[2], single_call()[2]

        def over(x, y):
            return int(((x - y).abs() > 1e-8 + 2e-4 * y.abs()).sum())
        res[f"distributed_theta{theta}"] = {
            "two_calls": two, "value_grad_ms": vg_ms,
            "segment_sum": _segment_times(*_largest_gather(dist_call)),
            "trace": _traced(dist_call),
            "mass_over_vs_single": over(gm, gm1),
            "mass_over_single_vs_single": over(gm2, gm1),
            "mass_entries": gm.numel(),
            "max_abs_grad_mass": float(gm1.abs().max())}
    return res


def run(checkout: Path) -> dict:
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(checkout.resolve()))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--worker"], cwd=checkout, env=env,
                          capture_output=True, text=True)
    out = {"checkout": str(checkout), "rc": proc.returncode,
           "seconds": time.perf_counter() - t0}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        out.update(json.loads(lines[-1]))
    else:
        out["error"] = (proc.stdout + proc.stderr)[-4000:]
    return out


def main() -> int:
    if sys.argv[1:] == ["--worker"]:
        print(json.dumps(worker()))
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", type=Path, nargs="+")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    results = []
    for checkout in args.checkouts:
        res = run(checkout)
        res["card"] = card
        results.append(res)
        print(json.dumps(res), flush=True)
    report = {"card": card, "runs": results}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
