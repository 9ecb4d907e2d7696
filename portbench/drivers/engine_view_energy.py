"""Driver ``engine_view_energy``: the CLI's run loop on the exact all-pairs
path with energy telemetry, and a viewer on the other end.

The program under test is ``runtime/engine.Engine`` over
``models/world.World`` on the configuration's force path (``pallas``: the
symmetric all-pairs kernel K2 on the card), with
``utils/telemetry.EnergyMeter`` chained after ``engine_view``'s sampling
hook in ``on_batch``, as ``python -m nbody_simulation_tpu_torch.run
--force-path pallas --energy-every K`` chains the meter; a consumer thread
pops every snapshot, a closed loop as in ``engine_view``.

Traffic parameters: ``engine_view``'s, and ``energy_every`` and
``energy_method``, the meter's.

End to end: ``ups``, ``frame_gap_p95_ms`` and ``setup_s`` as
``engine_view`` takes them (with ``--trace``, from the first snapshot after
the traced stretch on).

The check: ``engine_view``'s hook copies the state after batch 1 and at the
ends of ``pairs`` reservoir-sampled pairs of consecutive batches (the
all-pairs path keeps its rows in one order, so every batch may be
sampled). After the window, ``reference_exact`` follows batch 1 from the
seed's state and each sampled batch from the program's own state at its
start, and the frames of those states are compared pixel for pixel with
the reference's splat. Numbers: ``dv_p99``, ``dx_ulp_p99``, ``frame_px``
as ``engine_view`` defines them; ``energy_rel``, the largest
|E − E_ref| / |E_ref| over the meter's samples at the copied states, E_ref
the reference's total energy of the copied state; and ``potential_rel``,
the same for the potential part U of those samples (the meter's
``potentials``) against the reference's potential. E is almost all the
heavy body's kinetic energy, so only U shows the potential kernel K6's
error. A program whose meter keeps no potentials cannot be held to the
check: the run stops before its set-up, with an error.

Per layer (``--trace``): the trace of ``engine_view``'s traced stretch,
the steps in it, the energy samples taken in it (``len(samples)`` before
and after) and the live rows.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench.lib import checks, generators, manifest, reference_exact
from portbench.lib.traces import TraceWindow

view = manifest.load_module("drivers", "engine_view")

# No step of the all-pairs path re-sorts: a cadence no batch reaches lets
# engine_view's hook sample every batch.
NEVER = 1 << 62


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, log=print):
    import torch

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.world import World
    from nbody_simulation_tpu_torch.runtime.engine import Engine
    from nbody_simulation_tpu_torch.state import ParticleState
    from nbody_simulation_tpu_torch.utils.telemetry import EnergyMeter

    if not hasattr(EnergyMeter(1), "potentials"):
        raise SystemExit("engine_view_energy: this program's EnergyMeter "
                         "keeps no potential energies, which the check "
                         "holds to the reference")
    conf, p = cell.config, cell.params
    sim = conf["sim"]
    spb = int(p["steps_per_snapshot"])
    pos0, vel0, mass0 = generators.make_state(conf["scenario"], seed,
                                              conf["scenario_args"])
    cfg = SimConfig(**sim)
    state = ParticleState.create(pos0, vel0, mass0).to(device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def meter():
        return EnergyMeter(int(p["energy_every"]), emit=lambda *_: None,
                           softening2=cfg.softening2,
                           method=p["energy_method"])

    def engine(world, profile_every, on_batch):
        return Engine(world, queue_depth=int(p["queue_depth"]),
                      steps_per_snapshot=spb,
                      snapshot_interval=float(p["snapshot_interval"]),
                      profile_every=profile_every, on_batch=on_batch)

    # Warm-up on a world of its own: a profiled step, steps, energy samples
    # and renders, through the engine's threads.
    warm = engine(World(state, cfg), 1, meter())
    warm.start(max_steps=2 * spb)
    while warm.next_snapshot(timeout=600) is not None:
        pass
    warm.stop()
    sync()
    del warm

    wanted, frames, arrivals, latest = set(), {}, [], [None]
    world = World(state, cfg)
    trace_spec = cell.trace if trace else None
    hook = view._Hook(world, seed, p, dict(sim, resort_every=NEVER),
                      int(cell.check["pairs"]), trace_spec, wanted, sync)
    energy = meter()
    marks = {}

    def on_batch(w):
        hook(w)
        if trace_spec and hook.k in (hook.t_first,
                                     hook.t_first + hook.t_count):
            marks[hook.k] = len(energy.samples)
        energy(w)

    eng = engine(world, int(p["profile_every"]), on_batch)
    hook.counting = eng.counting

    def consume():
        while True:
            snap = eng.next_snapshot(timeout=None)
            if snap is None:
                return
            arrivals.append((time.monotonic(), snap.step))
            latest[0] = (snap.step, snap.frame)
            if snap.step in wanted:
                frames[snap.step] = snap.frame

    consumer = threading.Thread(target=consume, name="consumer", daemon=True)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    consumer.start()
    t_w0 = time.monotonic()
    eng.start()
    hook.serve(t_w0 + seconds)
    t_end = time.monotonic()
    eng.stop()
    consumer.join(timeout=120)
    if consumer.is_alive():
        raise RuntimeError("the consumer did not finish")
    final = world.state
    final_update = world.updates
    if latest[0] is not None and latest[0][0] == final_update:
        frames[final_update] = latest[0][1]
    sync()
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)

    got = [(t, s) for t, s in arrivals if t <= t_end]
    e2e = {"setup_s": t_w0 - t0}
    if trace and hook.t_resumed is not None:
        after = [(t, s) for t, s in got if t >= hook.t_resumed]
        if after:
            e2e.update(view._view_rates(after, *after[0]))
    else:
        e2e.update(view._view_rates(got, t_w0, 0))
    samples = (dict(energy.samples), dict(energy.potentials))
    final_pos, final_vel, final_mass = final.pos, final.vel, final.mass
    del eng, world, state, final

    layer = None
    if trace and hook.stopped:
        tw = TraceWindow.from_profile(hook.prof, hook.trace_s)
        hook.prof = None
        layer = {"trace": tw, "steps": hook.t_count * spb,
                 "samples": (marks[hook.t_first + hook.t_count]
                             - marks[hook.t_first]),
                 "n": int((final_mass > 0).sum()), "sim": sim, "e2e": e2e}

    numbers = _check(hook, frames, samples,
                     (final_pos, final_vel, final_mass), final_update,
                     (pos0, vel0, mass0), sim, conf, spb, log)
    return {"e2e": e2e, "attempted": len(got), "failed": 0,
            "memory_peak_bytes": memory_peak, "numbers": numbers,
            "layer": layer}


def _check(hook, frames, samples, final, final_update, start, sim, conf,
           spb, log):
    import torch
    t_check = time.monotonic()
    dev = hook.first.pos.device
    soft2 = float(sim.get("softening2", 1e-3))
    batches = [(0, tuple(torch.as_tensor(a, device=dev) for a in start), 0,
                hook.first.get(0))]
    for k, j in hook.pairs():
        batches.append((k, hook.before.get(j), hook.before.update[j],
                        hook.after.get(j)))
    dv, dx = [], []
    for k, (bp, bvel, bm), u, (ap, avel, am) in batches:
        n = bp.shape[0]
        rp, rv = reference_exact.run_steps(bp, bvel, bm, spb, sim)
        live = bm > 0
        if not torch.equal(am[:n], bm):
            log(f"check: batch {k + 1}: the masses changed")
        dv.append(checks.rel_increment(avel[:n], rv, bvel, live))
        dx.append(checks.ulp_distance(ap[:n], rp, live))
        worst = checks.rel_increment(avel[:n], rv, bvel, live, 1.0)
        log(f"check: batch {k + 1} (steps {u}..{u + spb - 1}): dv_p99 "
            f"{dv[-1]:.4e} (the worst row {worst:.4e}), dx_ulp_p99 "
            f"{dx[-1]:.4e}")
    ends = {hook.first.update[0]: hook.first.get(0)}
    for k, j in hook.pairs():
        ends[hook.before.update[j]] = hook.before.get(j)
        ends[hook.after.update[j]] = hook.after.get(j)
    energies, potentials = samples
    e_rel, u_rel = [], []
    for u, (pos, vel, mass) in sorted(ends.items()):
        if u in energies:
            u_ref = float(reference_exact.potential(pos, mass, soft2))
            e_ref = float(reference_exact.kinetic(vel, mass)) + u_ref
            e_rel.append(abs(energies[u] - e_ref) / abs(e_ref))
            u_rel.append(abs(potentials[u] - u_ref) / abs(u_ref))
            log(f"check: the energy of step {u}: {energies[u]:.9e} against "
                f"{e_ref:.9e}, {e_rel[-1]:.4e} apart; its potential "
                f"{potentials[u]:.9e} against {u_ref:.9e}, {u_rel[-1]:.4e} "
                "apart")
    px, n_frames = 0, 0
    for u, st in sorted({**ends, final_update: final}.items()):
        frame = frames.get(u)
        if frame is None:
            continue
        bad = int((np.asarray(frame) != view._render(conf, *st)).any(-1).sum())
        px += bad
        n_frames += 1
        if bad:
            log(f"check: the frame of step {u}: {bad} pixels differ")
    log(f"check: {len(batches)} batches followed, {n_frames} frames and "
        f"{len(e_rel)} energies compared (the last frame at step "
        f"{final_update}) in {time.monotonic() - t_check:.1f} s")
    return {"dv_p99": max(dv), "dx_ulp_p99": max(dx),
            "frame_px": float(px) if n_frames else None,
            "energy_rel": max(e_rel) if e_rel else None,
            "potential_rel": max(u_rel) if u_rel else None}
