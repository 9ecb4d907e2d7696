"""The application shell: ``python -m nbody_simulation_tpu_torch.run``.

The counterpart of the reference's main() (reference src/main.rs:81-184)
and of the JAX package's ``run.py``, with the same parser: a headless
simulation that consumes the engine's lossy snapshot queue, writes PNG
frames and prints the once-per-second fps/ups/step/Counting telemetry
(src/main.rs:148-156 semantics).

With no flags it runs the reference galaxy (151,317 particles) with
Barnes-Hut at θ=50 on the GPU; ``--theta`` below 2 switches Barnes-Hut to
the quality path (24-bit Morton keys, wide planner caps and the quadrupole
sweep kernel), e.g. ``--scenario plummer --n 65536 --theta 0.5
--weighted-leaf-com``; ``--force-path pallas`` runs the exact all-pairs
kernels instead, and ``--energy-every K`` prints the total energy every K
steps. ``--device`` (default ``cuda``) replaces the JAX package's
``--platform``; a CUDA run on a machine without CUDA raises rather than
running on the CPU. Flags of modules not ported yet raise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from nbody_simulation_tpu_torch.config import RCP_MODES

# Flags whose modules are not ported yet → the ROADMAP item that ports them.
_NOT_PORTED = {
    "resume": "ROADMAP item 1, checkpoint",
    "checkpoint": "ROADMAP item 1, checkpoint",
    "record": "ROADMAP item 2, recording",
    "gif": "ROADMAP item 2, recording",
    "serve": "ROADMAP item 4, viewer",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_simulation_tpu_torch.run",
        description="Barnes-Hut N-body simulator on PyTorch and CUDA")
    p.add_argument("--scenario", default="galaxy",
                   choices=["galaxy", "uniform", "plummer", "collision"])
    p.add_argument("--n", type=int, default=100_000,
                   help="particle count for uniform/plummer scenarios")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force-path", default="bh",
                   choices=["direct", "pallas", "bh"],
                   help="'bh' Barnes-Hut (the grouped sweep kernel), "
                        "'pallas' the exact all-pairs kernels (symmetric "
                        "third-law kernel where N allows, else the ordered "
                        "one), 'direct' plain torch")
    p.add_argument("--theta", type=float, default=50.0,
                   help="reference convention: accept when s/d < theta")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--integrator", default="euler",
                   choices=["euler", "leapfrog"])
    p.add_argument("--rcp", default=None, choices=list(RCP_MODES),
                   help="reciprocal/guard mode of the force kernel; default "
                        "resolves from theta (SimConfig.resolved_rcp)")
    p.add_argument("--sweep-buckets", default="auto",
                   help="'BF,CF', 'off' or 'auto', as in the JAX package; "
                        "no effect here: the GPU sweep always stops each "
                        "group at its last nonzero-mass column, bitwise the "
                        "full sweep's forces")
    p.add_argument("--leaf-size", type=int, default=64)
    p.add_argument("--world-size", type=float, default=100_000.0)
    p.add_argument("--render-size", type=int, default=1250)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", type=Path, default=Path("frames"),
                   help="directory for PNG frames (empty string disables)")
    p.add_argument("--frame-every", type=int, default=0,
                   help="save every k-th snapshot (0 = only the last)")
    p.add_argument("--checkpoint", type=Path, default=None,
                   help="save final state here (not ported yet)")
    p.add_argument("--resume", type=Path, default=None,
                   help="resume from a checkpoint (not ported yet)")
    p.add_argument("--record", type=Path, default=None,
                   help="position-delta recording file (not ported yet)")
    p.add_argument("--gif", type=Path, default=None,
                   help="animated GIF of kept snapshots (not ported yet)")
    p.add_argument("--weighted-leaf-com", action="store_true",
                   help="fix the reference's unweighted-leaf-COM quirk")
    p.add_argument("--energy-every", type=int, default=0, metavar="K",
                   help="steps between live total-energy prints (0 = off): "
                        "E = KE + U under the conservative counterpart law "
                        "(ops/energy.py; the reference's own law is non-"
                        "conservative) plus |dE/E0| drift since start")
    p.add_argument("--energy-method", choices=("exact", "bh"),
                   default="exact",
                   help="exact: O(N²/2) pair sweep per sample (the potential "
                        "kernel); bh: O(N·C) θ-consistent BH-planned "
                        "approximation (ops/energy.bh_total_energy)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="live browser viewer (not ported yet)")
    p.add_argument("--snapshot-interval", type=float, default=0.0,
                   help="min seconds between rendered snapshots (0 = every "
                        "attempt with queue room, flume-style)")
    p.add_argument("--steps-per-snapshot", type=int, default=10,
                   help="physics steps between snapshot attempts")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device; 'cuda' (default) raises when CUDA is "
                        "unavailable")
    return p


def main(argv=None) -> int:
    simulate(argv)
    return 0


def simulate(argv=None):
    """The body of ``main``: parse ``argv``, run, print, and return the
    ``World`` after its last step."""
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not yet ported ({item})")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: CUDA is not available on this machine (pass "
            "--device cpu for a run on the CPU)")
    device = torch.device(args.device)

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models import (World, collision, galaxy,
                                                   plummer, uniform_disc)
    from nbody_simulation_tpu_torch.runtime.engine import Engine
    from nbody_simulation_tpu_torch.utils.pngio import save_png
    from nbody_simulation_tpu_torch.utils.telemetry import (EnergyMeter,
                                                            RateMeter)

    buckets = (None if args.sweep_buckets in ("auto", "off") else
               tuple(float(v) for v in args.sweep_buckets.split(",")))
    cfg = SimConfig(force_path=args.force_path, theta=args.theta, dt=args.dt,
                    leaf_size=args.leaf_size, world_size=args.world_size,
                    render_size=args.render_size, integrator=args.integrator,
                    unweighted_leaf_com=not args.weighted_leaf_com,
                    rcp=args.rcp, sweep_buckets=buckets)

    if args.scenario == "galaxy":
        state = galaxy(seed=args.seed, world_size=args.world_size)
    elif args.scenario == "uniform":
        state = uniform_disc(args.n, seed=args.seed)
    elif args.scenario == "collision":
        state = collision(seed=args.seed)
    else:
        state = plummer(args.n, seed=args.seed)

    emit = (lambda *_: None) if args.quiet else print
    emit(f"len: {state.n_real}")  # reference prints this (src/main.rs:343)

    world = World(state.to(device), cfg)
    on_batch = None
    if args.energy_every:
        on_batch = EnergyMeter(args.energy_every, emit=emit,
                               softening2=cfg.softening2,
                               method=args.energy_method)
    engine = Engine(world, snapshot_interval=args.snapshot_interval,
                    steps_per_snapshot=args.steps_per_snapshot,
                    on_batch=on_batch)
    meter = RateMeter(emit=emit)

    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)

    engine.start(max_steps=args.steps)
    last = None
    kept = 0
    while True:
        snap = engine.next_snapshot(timeout=None)
        if snap is None:
            break
        last = snap
        kept += 1
        meter.frame(snap.step, snap.counting)
        if args.out and args.frame_every and kept % args.frame_every == 0:
            save_png(args.out / f"frame_{snap.step:08d}.png", snap.frame)
    engine.join(timeout=600)
    engine.stop()

    if last is not None and args.out:
        save_png(args.out / f"frame_{last.step:08d}.png", last.frame)
        emit(f"final frame: {args.out / f'frame_{last.step:08d}.png'}")
    d = world.diagnostics()
    emit(f"done: {world.updates} steps, "
         f"{kept} snapshots kept, {engine.dropped} dropped, "
         f"mass {float(d['total_mass']):.1f}, "
         f"ke {float(d['kinetic_energy']):.6e}")
    return world


if __name__ == "__main__":
    sys.exit(main())
