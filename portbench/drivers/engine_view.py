"""Driver ``engine_view``: the CLI's run loop with a viewer on the other end.

The program under test is ``runtime/engine.Engine`` over
``models/world.World`` (the Barnes-Hut path), built as
``python -m nbody_simulation_tpu_torch.run`` builds it, and a consumer
thread that pops every snapshot and keeps its frame, as the CLI does with
``--frame-every 0``: a closed loop in which the producer renders whenever
the queue has room.

Traffic parameters (``params`` of the cell): ``steps_per_snapshot``,
``snapshot_interval``, ``queue_depth``, ``profile_every``.

End to end: ``ups``, the steps of the last snapshot the consumer received
in the window over the time from the window's start to that snapshot (a
snapshot's readback is a point the host has seen the device complete);
``frame_gap_p95_ms``, the 95th percentile of the intervals between
consecutive snapshots received in the window; ``setup_s``. Where the cell
has an end-to-end metric read from the device trace, ``step_device_ms``,
the run without ``--trace`` profiles the card over the whole window
(device events only) and reports its busy time over every step the window
ran. With ``--trace``, ``ups`` and ``frame_gap_p95_ms`` are taken from the
first snapshot after the traced stretch on, so that the profiler's cost
stays out of them; the per-layer readers see them as ``ctx["e2e"]``.

The check (``check`` of the cell): the engine's ``on_batch`` hook copies
the state at batch ends the run samples from the seed (``pairs`` pairs of
consecutive batch ends, reservoir-sampled over the batches whose only
re-sort, if any, is their first step, so that every row of the program's
state and of the reference's stays in one order), and the state after the
first batch. Once the window has closed, the reference follows each
sampled batch from the program's own state at its start (the first batch
from the seed's state), and renders every sampled state the consumer got a
frame of, and the last one. Numbers: ``dv_p99`` (velocity change over the
batch, ``checks.rel_increment``), ``dx_ulp_p99`` (positions, in f32
spacings), ``frame_px`` (pixels that differ, over every compared frame).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from portbench.lib import checks, generators, reference, traces
from portbench.lib.traces import TraceWindow


class _States:
    """Preallocated copies of the world's state, filled on the producer
    thread without waiting for the device."""

    def __init__(self, like, count: int):
        import torch
        self.pos = torch.empty((count,) + tuple(like.pos.shape),
                               dtype=like.pos.dtype, device=like.pos.device)
        self.vel = torch.empty_like(self.pos)
        self.mass = torch.empty((count,) + tuple(like.mass.shape),
                                dtype=like.mass.dtype, device=like.mass.device)
        self.update = [None] * count

    def put(self, i: int, st, update: int) -> None:
        self.pos[i].copy_(st.pos, non_blocking=True)
        self.vel[i].copy_(st.vel, non_blocking=True)
        self.mass[i].copy_(st.mass, non_blocking=True)
        self.update[i] = update

    def get(self, i: int):
        return self.pos[i], self.vel[i], self.mass[i]


def _resorts_inside(first_update: int, steps: int, every: int) -> bool:
    """Whether a batch re-sorts at a step other than its first."""
    every = max(every, 1)
    return any((first_update + j) % every == 0 for j in range(1, steps))


class _Hook:
    """The engine's ``on_batch``: sampling, capture and the traced part of
    the window. Runs on the producer thread."""

    def __init__(self, world, seed: int, params: dict, sim: dict,
                 pairs: int, trace: dict | None, wanted: set, sync):
        self.sync = sync
        self.spb = int(params["steps_per_snapshot"])
        self.prof_every = int(params["profile_every"])
        self.every = int(sim.get("resort_every", 16))
        self.k = 0
        self.rng = np.random.default_rng([generators.rng_seed(seed), 0x5EED])
        self.n_pairs = pairs
        self.before = _States(world.state, pairs)
        self.after = _States(world.state, pairs)
        self.first = _States(world.state, 1)
        self.meta = [None] * pairs      # (batch k, complete)
        self.seen = 0
        self.wanted = wanted
        self.profiled = []               # (time, batch, Counting copy)
        self.trace = trace
        self.traced = None
        self.prof = None
        self.trace_s = None
        self.t_resumed = None
        self.request = None
        self.stopped = False
        self.asked, self.done = threading.Event(), threading.Event()
        if trace:
            self.t_first = int(trace["skip_batches"])
            self.t_count = int(trace["batches"])
            self.traced = _States(world.state, self.t_count)
        self.counting = None

    def profiled_batch(self, k: int) -> bool:
        return bool(self.prof_every) and k % self.prof_every == 0

    def __call__(self, world) -> None:
        self.k += 1
        k, u, st = self.k, world.updates, world.state
        if self.profiled_batch(k) and self.counting is not None:
            self.profiled.append((time.monotonic(), k, self.counting.copy()))
        if k == 1:
            self.first.put(0, st, u)
            self.wanted.add(u)
        for j, m in enumerate(self.meta):
            if m is not None and not m[1] and m[0] + 1 == k:
                self.after.put(j, st, u)
                self.meta[j] = (m[0], True)
                self.wanted.add(u)
        if not _resorts_inside(u, self.spb, self.every):
            self.seen += 1
            j = (self.seen - 1 if self.seen <= self.n_pairs
                 else int(self.rng.integers(self.seen)))
            if j < self.n_pairs:
                self.before.put(j, st, u)
                self.after.update[j] = None
                self.meta[j] = (k, False)
                self.wanted.add(u)
        if self.trace:
            t0, n = self.t_first, self.t_count
            if t0 <= k < t0 + n:
                self.traced.put(k - t0, st, u)
            if k == t0:
                self.sync()
                self.ask("start")
                self._t = time.perf_counter()
            elif k == t0 + n:
                self.sync()
                self.trace_s = time.perf_counter() - self._t
                self.ask("stop")
                self.t_resumed = time.monotonic()

    def ask(self, what: str) -> None:
        """Have the main thread start or stop the profiler (it must run
        where it was set up), and wait until it has."""
        self.request = what
        self.asked.set()
        if not self.done.wait(timeout=600):
            raise RuntimeError(f"the profiler did not {what}")
        self.done.clear()

    def serve(self, until: float) -> None:
        """On the main thread until ``until`` (monotonic): start and stop
        the profiler when the producer asks."""
        import torch
        while True:
            tracing = self.prof is not None and not self.stopped
            left = until - time.monotonic()
            if left <= 0 and not tracing:
                return
            if not self.asked.wait(timeout=max(left, 1.0)):
                continue
            self.asked.clear()
            if self.request == "start":
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
            else:
                self.prof.__exit__(None, None, None)
                self.stopped = True
            self.done.set()

    def pairs(self):
        """Complete sampled pairs: (batch k, before index)."""
        return [(m[0], j) for j, m in enumerate(self.meta) if m and m[1]]


def traces_whole_window(cell, trace: bool, device: str) -> bool:
    """Whether a run profiles the card over its whole window: without
    ``--trace``, on a card, in a cell with an end-to-end metric read from
    the device trace."""
    return (not trace and device == "cuda"
            and any(m["source"] == "device_trace" for m in cell.end_to_end))


def _view_rates(got, t_from: float, step_from: int) -> dict:
    """``ups`` and ``frame_gap_p95_ms`` of the snapshots ``got`` (time,
    step), counted from ``(t_from, step_from)``."""
    if len(got) < 2:
        return {}
    t_last, steps = got[-1]
    gaps = np.diff([t for t, _ in got]) * 1e3
    return {"ups": (steps - step_from) / (t_last - t_from),
            "frame_gap_p95_ms": float(np.percentile(gaps, 95))}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, log=print):
    import torch

    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.world import World
    from nbody_simulation_tpu_torch.runtime.engine import Engine
    from nbody_simulation_tpu_torch.state import ParticleState

    conf, p = cell.config, cell.params
    sim = conf["sim"]
    spb = int(p["steps_per_snapshot"])
    pos0, vel0, mass0 = generators.make_state(conf["scenario"], seed,
                                              conf["scenario_args"])
    cfg = SimConfig(**sim)
    state = ParticleState.create(pos0, vel0, mass0).to(device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def engine(world, profile_every, on_batch=None):
        return Engine(world, queue_depth=int(p["queue_depth"]),
                      steps_per_snapshot=spb,
                      snapshot_interval=float(p["snapshot_interval"]),
                      profile_every=profile_every, on_batch=on_batch)

    # Warm-up on a world of its own: a profiled (re-sorting) step, stale
    # steps, a re-sort at step 16 and renders, through the engine's threads.
    warm = engine(World(state, cfg), profile_every=1)
    warm.start(max_steps=2 * spb)
    while warm.next_snapshot(timeout=600) is not None:
        pass
    warm.stop()
    sync()
    del warm

    wanted, frames, arrivals, latest = set(), {}, [], [None]
    world = World(state, cfg)
    trace_spec = cell.trace if trace else None
    hook = _Hook(world, seed, p, sim, int(cell.check["pairs"]), trace_spec,
                 wanted, sync)
    eng = engine(world, int(p["profile_every"]), on_batch=hook)
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
    whole = None
    if traces_whole_window(cell, trace, device):
        whole = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
    consumer.start()
    t_w0 = time.monotonic()
    if whole is not None:
        whole.__enter__()
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
            e2e.update(_view_rates(after, *after[0]))
    else:
        e2e.update(_view_rates(got, t_w0, 0))
    if whole is not None:
        whole.__exit__(None, None, None)
        e2e["step_device_ms"] = (traces.device_busy_s(whole) * 1e3
                                 / max(final_update, 1))
        del whole
    done = [c for tt, k, c in hook.profiled if tt <= t_end]
    counting = ({"profiled_steps": len(done),
                 "build_bvh": done[-1].build_bvh,
                 "sum_gravity": done[-1].sum_gravity} if done else None)
    final_pos, final_vel, final_mass = final.pos, final.vel, final.mass
    del eng, world, state, final

    layer = None
    if trace and hook.stopped:
        tw = TraceWindow.from_profile(hook.prof, hook.trace_s)
        hook.prof = None
        tr = hook.traced

        def work():
            out = []
            for i in range(tr.pos.shape[0]):
                k = hook.t_first + i
                out += reference.batch_work(
                    tr.pos[i], tr.mass[i], tr.update[i], spb,
                    hook.profiled_batch(k + 1), sim)
            return out

        layer = {"trace": tw, "steps": hook.t_count * spb, "calls": None,
                 "counting": counting, "sim": sim, "work": work, "e2e": e2e}

    numbers = _check(hook, frames, (final_pos, final_vel, final_mass),
                     final_update, (pos0, vel0, mass0), sim, conf, spb, log)
    return {"e2e": e2e, "attempted": len(got), "failed": 0,
            "memory_peak_bytes": memory_peak, "numbers": numbers,
            "layer": layer}


def _render(conf, pos, vel, mass):
    sim = conf["sim"]
    return reference.render(pos.cpu().numpy(), vel.cpu().numpy(),
                            mass.cpu().numpy(), sim.get("world_size", 1e5),
                            sim.get("render_size", 1250),
                            sim.get("heavy_weight", 10.0))


def _check(hook, frames, final, final_update, start, sim, conf, spb, log):
    import torch
    dev = hook.first.pos.device
    batches = [(0, tuple(torch.as_tensor(a, device=dev) for a in start), 0,
                hook.first.get(0))]
    for k, j in hook.pairs():
        batches.append((k, hook.before.get(j), hook.before.update[j],
                        hook.after.get(j)))
    dv, dx = [], []
    for k, (bp, bvel, bm), u, (ap, avel, am) in batches:
        rp, rv, rm, rows = reference.run_steps(
            bp, bvel, bm, u, spb, hook.profiled_batch(k + 1), sim)
        n = rp.shape[0]
        live = rm > 0
        if not torch.equal(am[:n], rm):
            log(f"check: batch {k + 1}: the masses after it are not in the "
                "reference's order")
        dv.append(checks.rel_increment(avel[:n], rv, bvel[rows], live))
        dx.append(checks.ulp_distance(ap[:n], rp, live))
        worst = checks.rel_increment(avel[:n], rv, bvel[rows], live, 1.0)
        log(f"check: batch {k + 1} (steps {u}..{u + spb - 1}): dv_p99 "
            f"{dv[-1]:.4e} (the worst row {worst:.4e}), dx_ulp_p99 "
            f"{dx[-1]:.4e}")
    kept = {hook.first.update[0]: hook.first.get(0), final_update: final}
    for k, j in hook.pairs():
        kept[hook.before.update[j]] = hook.before.get(j)
        kept[hook.after.update[j]] = hook.after.get(j)
    px, n_frames = 0, 0
    for u, st in sorted(kept.items()):
        frame = frames.get(u)
        if frame is None:
            continue
        bad = int((np.asarray(frame) != _render(conf, *st)).any(-1).sum())
        px += bad
        n_frames += 1
        if bad:
            log(f"check: the frame of step {u}: {bad} pixels differ")
    log(f"check: {len(batches)} batches followed, {n_frames} frames "
        f"compared (the last at step {final_update})")
    return {"dv_p99": max(dv), "dx_ulp_p99": max(dx),
            "frame_px": float(px) if n_frames else None}
