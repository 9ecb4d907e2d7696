"""The distributed CLI: ``python -m nbody_simulation_tpu_torch.run_multihost``.

The counterpart of the JAX package's ``run_multihost.py``, with the same
parser. Each process brings its chunk of the scenario
(``models.scenarios.scenario_chunk``), joins the mesh, and drives the
distributed Barnes-Hut (``runtime.distributed.DistributedWorld`` under
``DistributedEngine``); process 0 prints and writes frames, the
single-file checkpoint and the viewer. ``--checkpoint-sharded`` and
``--record`` write per process (``utils.checkpoint``,
``utils.recording``), in directories that the JAX package reads too.

Two departures from the JAX flags:

- ``--device cuda|cpu`` (default ``cuda``). A CUDA run on a machine
  without CUDA raises rather than running on the CPU. Without
  ``--local-shards`` the process joins a ``torch.distributed`` group
  (``parallel.init_distributed``: NCCL on the card, gloo on the CPU) and
  holds one shard (``parallel.make_1d_mesh``); with no distributed flags
  and no torchrun variables that group has this one process.
- ``--local-shards K`` in place of ``--cpu-devices K``: one process holds
  K shards on one device (``parallel.LocalMesh``), which is how one card
  runs a mesh of K. It runs no process group, and with several processes
  it is an error.

Example: two processes on the CPU, as ``tests/test_torch_multihost.py``
starts them (one card each on a machine of several cards with ``--device
cuda``):

    python -m nbody_simulation_tpu_torch.run_multihost --device cpu \\
        --coordinator 127.0.0.1:8476 --num-processes 2 --process-id $I \\
        --scenario uniform --n 16384 --steps 100
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nbody_simulation_tpu_torch.config import RCP_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_simulation_tpu_torch.run_multihost")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (or torchrun's MASTER_ADDR "
                        "and MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--scenario", default="uniform",
                   choices=["galaxy", "uniform", "plummer", "collision"])
    p.add_argument("--n", type=int, default=65_536,
                   help="global particle count (uniform/plummer)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--theta", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--render-size", type=int, default=1250,
                   help="framebuffer side (the snapshot render and its "
                        "merge across shards scale with its square)")
    p.add_argument("--rcp", default=None, choices=list(RCP_MODES),
                   help="reciprocal/guard mode; default resolves from "
                        "theta (SimConfig.resolved_rcp)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="steps between sharded renders (0 = none)")
    p.add_argument("--rebalance-every", type=int, default=1000,
                   help="steps between collective rebalances (0 = never)")
    p.add_argument("--out", default=None,
                   help="frame directory (process 0 only)")
    p.add_argument("--checkpoint", default=None,
                   help="save the final state here in the single-device "
                        "file format (every live row gathered; process 0 "
                        "writes)")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint (single-device or "
                        "distributed; distributed over this mesh)")
    p.add_argument("--checkpoint-sharded", default=None, metavar="DIR",
                   help="sharded checkpoint directory: every process "
                        "writes only its own rows; resumable with any "
                        "process or shard count")
    p.add_argument("--resume-sharded", default=None, metavar="DIR",
                   help="resume from a sharded checkpoint directory")
    p.add_argument("--record", default=None, metavar="DIR",
                   help="sharded position-delta recording: every process "
                        "streams only its own rows "
                        "(utils.recording.playback_sharded reassembles)")
    p.add_argument("--record-every", type=int, default=10,
                   help="steps between recorded frames (checked at batch "
                        "boundaries with catch-up semantics)")
    p.add_argument("--energy-every", type=int, default=0, metavar="K",
                   help="steps between live total-energy prints (0 = off) "
                        "(utils.telemetry.EnergyMeter)")
    p.add_argument("--energy-method", choices=("exact", "bh"),
                   default="exact",
                   help="exact: the ring of the potential kernel, O(N²/P) "
                        "per shard; bh: the staged Barnes-Hut potential, "
                        "O(N·C/P) (parallel.bh_distributed_total_energy)")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="process 0: live browser viewer on this port")
    p.add_argument("--selfcheck", action="store_true",
                   help="before stepping, compare the distributed accel "
                        "(with this run's seam stages) against the "
                        "single-device walk on the gathered state and "
                        "print the relative-error quantiles (O(N) on "
                        "process 0; use at modest N)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--exact-chunks", action="store_true",
                   help="exact-slice scenario chunking (O(N) host memory, "
                        "the same particle set at any process count)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device; 'cuda' (default) raises when CUDA is "
                        "unavailable")
    p.add_argument("--local-shards", type=int, default=0, metavar="K",
                   help="hold K shards in this one process "
                        "(parallel.LocalMesh); no process group")
    return p


def _launches() -> dict:
    """This process's kernel launches so far, per kernel with any (the
    wrappers' counts): the sweep K3 or K4 and the potential K6."""
    from nbody_simulation_tpu_torch.ops import energy, traversal
    counts = {"K3": traversal.grouped_sweep.launches,
              "K4": traversal.grouped_sweep.quad_launches,
              "K6": energy.potential_cuda.launches}
    return {k: n for k, n in counts.items() if n}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: CUDA is not available on this machine (pass "
            "--device cpu for a run on the CPU)")
    from nbody_simulation_tpu_torch.parallel import (LocalMesh,
                                                     init_distributed,
                                                     make_1d_mesh)
    from nbody_simulation_tpu_torch.parallel.multihost import (
        process_count, process_index)

    own_group = False
    if args.local_shards:
        if ((args.num_processes or 1) > 1
                or int(os.environ.get("WORLD_SIZE", "1")) > 1):
            parser.error("--local-shards holds every shard in one process; "
                         "it cannot run with several processes")
        mesh, pid, nproc = LocalMesh(args.local_shards, args.device), 0, 1
    else:
        own_group = not dist.is_initialized()
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)
        mesh = make_1d_mesh(device=args.device)
        pid, nproc = process_index(), process_count()
    try:
        return _run(args, mesh, pid, nproc)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, mesh, pid: int, nproc: int) -> int:
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.parallel import sharded_diagnostics
    from nbody_simulation_tpu_torch.runtime.distributed import (
        DistributedEngine, DistributedWorld)
    from nbody_simulation_tpu_torch.utils.telemetry import RateMeter

    emit = print if (pid == 0 and not args.quiet) else (lambda *a, **k: None)
    emit(f"processes: {nproc}, shards: {mesh.n_shards} ({mesh.n_local} "
         f"local) on {mesh.device}")

    cfg = SimConfig(force_path="bh", theta=args.theta, dt=args.dt,
                    rcp=args.rcp, render_size=args.render_size)

    start_step = 0
    if args.resume_sharded:
        from nbody_simulation_tpu_torch.utils.checkpoint import (
            load_sharded_checkpoint)
        t0 = time.perf_counter()
        state, start_step = load_sharded_checkpoint(args.resume_sharded,
                                                    mesh, cfg)
        emit(f"resumed: {args.resume_sharded} @ step {start_step} in "
             f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    elif args.resume:
        from nbody_simulation_tpu_torch.runtime.distributed import (
            load_distributed_checkpoint)
        state, start_step = load_distributed_checkpoint(args.resume, mesh,
                                                        cfg)
    else:
        from nbody_simulation_tpu_torch.models.scenarios import (
            scenario_chunk)
        from nbody_simulation_tpu_torch.parallel.multihost import (
            multihost_state)
        kw = {"galaxy": {}, "collision": {}}.get(args.scenario,
                                                 {"n": args.n})
        chunk = scenario_chunk(args.scenario, pid, nproc, seed=args.seed,
                               exact=args.exact_chunks, **kw)
        state = multihost_state(chunk, mesh, cfg)
    emit(f"len: {int(sharded_diagnostics(state, mesh)['n_live'])}")

    world = DistributedWorld(state, mesh, cfg,
                             rebalance_every=args.rebalance_every)
    world.updates = start_step
    if args.selfcheck:
        # Every process joins the gathers; process 0 runs the
        # single-device walk and prints the quantiles.
        from nbody_simulation_tpu_torch.ops.traversal import bh_accel
        from nbody_simulation_tpu_torch.parallel import bh_distributed_accel
        got = bh_distributed_accel(state.pos, state.mass, mesh, config=cfg,
                                   extra_pairs=world._extra)
        pos_all, mass_all, got_all = (mesh.all_gather(x) for x in
                                      (state.pos, state.mass, got))
        if pid == 0:
            want = bh_accel(pos_all, mass_all, theta=cfg.theta,
                            multipole=cfg.resolved_multipole(),
                            morton_bits=cfg.resolved_morton_bits(),
                            plan_leaves=cfg.plan_leaves)
            real = mass_all > 0
            rel = ((got_all[real] - want[real]).double().norm(dim=1)
                   / want[real].double().norm(dim=1).clamp_min(1e-12)
                   ).cpu().numpy()
            emit(f"selfcheck: median={np.median(rel):.3e} "
                 f"p99={np.percentile(rel, 99):.3e}")
        del got, pos_all, mass_all, got_all
    recorder = None
    if args.record:
        from nbody_simulation_tpu_torch.utils.recording import ShardedRecorder
        recorder = ShardedRecorder(args.record, every=args.record_every)
    callbacks = []
    meter_cb = None
    if recorder is not None:
        callbacks.append(lambda w: recorder.maybe_record(w.state, w.updates,
                                                         w.mesh))
    if args.energy_every:
        # A collective: every process joins the sum; only process 0
        # prints (emit does nothing elsewhere).
        from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter
        meter_cb = EnergyMeter(args.energy_every, emit=emit,
                               softening2=cfg.softening2,
                               method=args.energy_method)
        callbacks.append(meter_cb)
    engine = DistributedEngine(
        world, snapshot_interval=0.0,
        steps_per_snapshot=max(1, args.snapshot_every or 10),
        on_batch=((lambda w: [cb(w) for cb in callbacks])
                  if callbacks else None))

    out = None
    if args.out and pid == 0:
        from pathlib import Path
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)

    viewer = None
    bus = None
    # A run of several processes gets an interactive viewer on process 0:
    # /control submits intent to a ControlBus and every process's producer
    # thread applies it in the same poll (runtime/control.py), so pause,
    # step, θ, dt and quit keep the mesh in lockstep. The bus must exist on
    # every process (the poll is a collective) and controls come from
    # process 0 only, so one broadcast of process 0's --serve flag decides
    # (processes may be launched with differing --serve values).
    if nproc > 1:
        import torch.distributed as dist
        flag = torch.tensor([1 if (pid == 0 and args.serve) else 0],
                            dtype=torch.int32, device=mesh.device)
        dist.broadcast(flag, src=0)
        if int(flag.item()):
            from nbody_simulation_tpu_torch.runtime.control import ControlBus
            bus = ControlBus(world.config.theta, world.config.dt,
                             world.config.render_size)
            engine.control_poll = bus.poll
    if args.serve and pid == 0:
        from nbody_simulation_tpu_torch.viz import ViewerServer
        viewer = ViewerServer(engine, port=args.serve, energy_meter=meter_cb,
                              control_bus=bus)
        viewer.start()
        emit(f"viewer: http://127.0.0.1:{viewer.port}/"
             + (" (controls broadcast to all processes)"
                if nproc > 1 else ""), flush=True)

    from nbody_simulation_tpu_torch.utils.pngio import save_png
    meter = RateMeter(emit=emit)
    t0 = time.perf_counter()
    engine.start(max_steps=start_step + args.steps)
    last = None
    kept = 0
    while True:
        snap = engine.next_snapshot(timeout=None)
        if snap is None:
            break
        last = snap
        kept += 1
        meter.frame(snap.step, snap.counting)
        if out is not None and args.snapshot_every:
            save_png(out / f"frame_{snap.step:08d}.png", snap.frame)
    engine.join(timeout=600)
    engine.stop()
    if viewer is not None:
        viewer.stop()

    d = world.diagnostics()
    dt_wall = time.perf_counter() - t0
    steps = world.updates - start_step
    emit(f"done: {steps} steps in {dt_wall:.3f}s "
         f"({steps / max(dt_wall, 1e-9):.3f} steps/s), "
         f"{kept} snapshots kept, {engine.dropped} dropped, "
         f"mass {float(d['total_mass']):.1f}, "
         f"ke {float(d['kinetic_energy']):.6e}")
    emit(f"launches: {json.dumps(_launches())}")
    if out is not None and last is not None:
        save_png(out / f"frame_{last.step:08d}.png", last.frame)
    if recorder is not None:
        recorder.close()
        emit(f"recording: {args.record} — {recorder.frames} frames, "
             f"raw {recorder.raw_bytes} comp {recorder.comp_bytes} "
             f"(this process)")

    if args.checkpoint_sharded:
        from nbody_simulation_tpu_torch.utils.checkpoint import (
            save_sharded_checkpoint)
        t1 = time.perf_counter()
        save_sharded_checkpoint(args.checkpoint_sharded, world.state,
                                world.updates, mesh)
        emit(f"sharded checkpoint: {args.checkpoint_sharded} "
             f"@ step {world.updates} in "
             f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    if args.checkpoint:
        # Every process joins the gather of the live rows; process 0
        # writes the file.
        from nbody_simulation_tpu_torch.runtime.distributed import (
            save_distributed_checkpoint)
        save_distributed_checkpoint(args.checkpoint, world)
        emit(f"checkpoint: {args.checkpoint} @ step {world.updates}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
