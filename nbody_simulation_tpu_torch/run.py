"""The application shell: ``python -m nbody_simulation_tpu_torch.run``.

The counterpart of the reference's main() (reference src/main.rs:81-184)
and of the JAX package's ``run.py``, with the same parser: a headless
simulation that consumes the engine's lossy snapshot queue, writes PNG
frames and prints the once-per-second fps/ups/step/Counting telemetry
(src/main.rs:148-156 semantics) and the share of steps replayed as CUDA
graphs (``models/world.py``), plus what the reference lacks:
checkpoint and resume, a position-delta recording (render it offline with
``python -m nbody_simulation_tpu_torch.render_recording``), an animated
GIF, and a live browser viewer.

With no flags it runs the reference galaxy (151,317 particles) with
Barnes-Hut at θ=50 on the GPU; ``--theta`` below 2 switches Barnes-Hut to
the quality path (24-bit Morton keys, wide planner caps and the quadrupole
sweep kernel), e.g. ``--scenario plummer --n 65536 --theta 0.5
--weighted-leaf-com``; ``--force-path pallas`` runs the exact all-pairs
kernels instead, and ``--energy-every K`` prints the total energy every K
steps. ``--checkpoint`` saves the final state, ``--resume`` continues from
one (the step count carries over, and with it the Barnes-Hut re-sort
cadence, so a resumed run's particles are bitwise an unbroken run's);
``--record`` writes the recording, ``--gif`` the GIF (with PIL; without it
the CLI says so and skips it), and ``--serve PORT`` runs the viewer until
the run ends or the page quits. ``--device`` (default ``cuda``) replaces
the JAX package's ``--platform``; a CUDA run on a machine without CUDA
raises rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from nbody_simulation_tpu_torch.config import RCP_MODES

# GIF frames stay in host memory until assembly: past this many, every
# other frame is dropped and the keep-stride doubles, so a long run keeps
# an evenly subsampled ~GIF_MAX_FRAMES.
GIF_MAX_FRAMES = 400


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
                   help="save final state here")
    p.add_argument("--resume", type=Path, default=None,
                   help="resume from a checkpoint")
    p.add_argument("--record", type=Path, default=None,
                   help="position-delta recording file (zstd, or zlib "
                        "without the zstandard module; self-contained; "
                        "render offline with python -m "
                        "nbody_simulation_tpu_torch.render_recording)")
    p.add_argument("--gif", type=Path, default=None,
                   help="assemble kept snapshots into an animated GIF "
                        "(composited over black like the reference window; "
                        "needs PIL)")
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
                   help="serve a live browser viewer on this port "
                        "(the headless stand-in for the reference's window)")
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
    from nbody_simulation_tpu_torch.runtime.frame import composite_black
    from nbody_simulation_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                             save_checkpoint)
    from nbody_simulation_tpu_torch.utils.pngio import save_png
    from nbody_simulation_tpu_torch.utils.recording import Recorder
    from nbody_simulation_tpu_torch.utils.telemetry import (EnergyMeter,
                                                            RateMeter)

    buckets = (None if args.sweep_buckets in ("auto", "off") else
               tuple(float(v) for v in args.sweep_buckets.split(",")))
    cfg = SimConfig(force_path=args.force_path, theta=args.theta, dt=args.dt,
                    leaf_size=args.leaf_size, world_size=args.world_size,
                    render_size=args.render_size, integrator=args.integrator,
                    unweighted_leaf_com=not args.weighted_leaf_com,
                    rcp=args.rcp, sweep_buckets=buckets)

    start_step = 0
    if args.resume:
        state, start_step = load_checkpoint(args.resume)
    elif args.scenario == "galaxy":
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
    # The step count carries over, and with it the Barnes-Hut re-sort
    # cadence (updates % resort_every).
    world.updates = start_step
    on_batch = None
    if args.energy_every:
        on_batch = EnergyMeter(args.energy_every, emit=emit,
                               softening2=cfg.softening2,
                               method=args.energy_method)
    engine = Engine(world, include_particles=bool(args.record),
                    snapshot_interval=args.snapshot_interval,
                    steps_per_snapshot=args.steps_per_snapshot,
                    on_batch=on_batch)

    if args.serve:
        from nbody_simulation_tpu_torch.viz import ViewerServer
        viewer = ViewerServer(engine, port=args.serve, energy_meter=on_batch)
        viewer.start()
        emit(f"viewer: http://127.0.0.1:{viewer.port}/")
        engine.start(max_steps=start_step + args.steps if args.steps else None)
        try:
            engine.join()
        except KeyboardInterrupt:
            pass
        engine.stop()
        viewer.stop()
        emit(f"done: {world.updates - start_step} steps")
        return world
    recorder = Recorder(args.record) if args.record else None
    meter = RateMeter(emit=emit)

    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)

    engine.start(max_steps=start_step + args.steps)
    last = None
    kept = 0
    gif_frames = []
    gif_stride, gif_seen = 1, 0
    try:
        while True:
            snap = engine.next_snapshot(timeout=None)
            if snap is None:
                break
            last = snap
            kept += 1
            meter.frame(snap.step, snap.counting, world.graph_counts)
            if args.out and args.frame_every and kept % args.frame_every == 0:
                save_png(args.out / f"frame_{snap.step:08d}.png", snap.frame)
            if recorder is not None and snap.pos is not None:
                recorder.maybe_record(snap.pos, snap.step)
            if args.gif is not None:
                if gif_seen % gif_stride == 0:
                    gif_frames.append(composite_black(snap.frame))
                    if len(gif_frames) > GIF_MAX_FRAMES:
                        gif_frames = gif_frames[::2]
                        gif_stride *= 2
                gif_seen += 1
    finally:
        if recorder is not None:
            recorder.close()
    engine.join(timeout=600)
    engine.stop()

    if last is not None and args.out:
        save_png(args.out / f"frame_{last.step:08d}.png", last.frame)
        emit(f"final frame: {args.out / f'frame_{last.step:08d}.png'}")
    if recorder is not None:
        emit(f"recording: {recorder.frames} frames, raw {recorder.raw_bytes}"
             f" comp {recorder.comp_bytes}")
    if args.gif is not None and gif_frames:
        try:
            from PIL import Image
            imgs = [Image.fromarray(f) for f in gif_frames]
            imgs[0].save(args.gif, save_all=True, append_images=imgs[1:],
                         duration=80, loop=0)
            emit(f"gif: {args.gif} ({len(imgs)} frames)")
        except ImportError:
            emit("gif: PIL unavailable, skipped")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, world.state.real_slice(),
                        world.updates)
        emit(f"checkpoint: {args.checkpoint} @ step {world.updates}")
    d = world.diagnostics()
    c = engine.snapshot_counts
    emit(f"done: {world.updates - start_step} steps, "
         f"{kept} snapshots kept, {engine.dropped} dropped, "
         f"{c.overlapped} overlapped, {c.flushed} flushed (waited "
         f"{c.wait_s:.3f} s, packed {c.pack_s:.3f} s), "
         f"mass {float(d['total_mass']):.1f}, "
         f"ke {float(d['kinetic_energy']):.6e}")
    return world


if __name__ == "__main__":
    sys.exit(main())
