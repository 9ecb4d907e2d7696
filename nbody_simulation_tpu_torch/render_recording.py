"""Offline renderer: recording → PNG frames.

The counterpart of the JAX package's ``render_recording.py``. It turns a
recording made with ``run --record`` into framebuffer PNGs with the exact
splat rules (``ops/raster.render_frame``, reference src/main.rs:41-72).

    python -m nbody_simulation_tpu_torch.render_recording REC --out DIR
        [--render-size 1250] [--state ck.npz] [--every 1] [--device cuda]

``REC`` is a single-device ``.bin`` stream or a sharded recording directory
(``manifest.json`` + per-process streams). Recordings carry positions
only, so by default every particle renders with unit mass and zero
velocity (constant tint, no heavy green); ``--state`` (a checkpoint from
the same run) restores the real masses and the heavy-particle rule.
Padding rows sit at the PAD_POS sentinel and render nowhere.

``--device`` replaces the JAX tool's ``--platform`` and, as everywhere in
this package, defaults to ``cuda``: a run with ``cuda`` on a machine
without CUDA raises, where the JAX tool defaults to the CPU. Pass
``--device cpu`` to render on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nbody_simulation_tpu_torch.render_recording",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recording", type=Path,
                   help=".bin stream or sharded recording directory")
    p.add_argument("--out", type=Path, required=True,
                   help="directory for frame_{step:08d}.png files")
    p.add_argument("--render-size", type=int, default=1250)
    p.add_argument("--world-size", type=float, default=100_000.0)
    p.add_argument("--state", type=Path, default=None,
                   help="checkpoint (.npz) from the same run: restores "
                        "masses (heavy-green rule) by ROW. Single-device "
                        "recordings only. Row mapping is exact for runs "
                        "that never Morton-resort (direct and all-pairs "
                        "paths) and for frames after the last re-sort; "
                        "earlier Barnes-Hut frames may tint the wrong "
                        "particles green.")
    p.add_argument("--every", type=int, default=1,
                   help="render every K-th recorded frame")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device; 'cuda' (default) raises when CUDA is "
                        "unavailable")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: CUDA is not available on this machine (pass "
            "--device cpu to render on the CPU)")
    device = torch.device(args.device)

    from nbody_simulation_tpu_torch.ops.raster import render_frame
    from nbody_simulation_tpu_torch.utils.pngio import save_png
    from nbody_simulation_tpu_torch.utils.recording import (playback,
                                                            playback_sharded)

    emit = (lambda *a, **k: None) if args.quiet else print
    sharded = (args.recording / "manifest.json").exists()
    frames = (playback_sharded(args.recording) if sharded
              else playback(args.recording))

    mass = None
    if args.state is not None:
        if sharded:
            raise SystemExit(
                "--state cannot be row-mapped onto a sharded recording: "
                "its rows are the padded device-major layout, a "
                "checkpoint's are compact live rows. Render without "
                "--state (unit masses).")
        from nbody_simulation_tpu_torch.utils.checkpoint import (
            load_checkpoint)
        st, _ = load_checkpoint(args.state)
        mass = st.mass.numpy()

    args.out.mkdir(parents=True, exist_ok=True)
    rendered = 0
    for k, (step, pos) in enumerate(frames):
        if k % max(1, args.every):
            continue
        n = pos.shape[0]
        if mass is not None and mass.shape[0] >= n:
            m = mass[:n]
        elif mass is not None:
            # Unit-fill, not zero-fill: rows beyond the checkpoint still
            # hold recorded particles, which mass 0 would erase.
            m = np.concatenate([mass, np.ones(n - mass.shape[0],
                                              np.float32)])
        else:
            m = np.ones(n, np.float32)
        tpos = torch.from_numpy(pos).to(device)
        frame = render_frame(
            tpos, torch.zeros_like(tpos), torch.from_numpy(m).to(device),
            world_size=args.world_size, render_size=args.render_size)
        out = args.out / f"frame_{step:08d}.png"
        save_png(out, frame.cpu().numpy())
        rendered += 1
        emit(f"rendered: {out}")
    emit(f"done: {rendered} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
