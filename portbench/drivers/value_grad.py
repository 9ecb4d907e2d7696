"""Driver ``value_grad``: trajectory optimisation through the differentiable
Barnes-Hut forces.

Each call runs ``steps`` semi-implicit Euler steps from the seeded initial
state through ``ops/traversal_grad.bh_accel_diff`` (the configuration's θ,
leaf size, world size, softening and leaf-COM rule; the function's own
defaults otherwise), takes the loss Σ|p − p̄|² of the final positions about
their mean, its gradient with respect to the initial positions by
``torch.autograd.grad``, and reads the loss and the gradient's norm back to
the host, as an optimiser's loop must before its next step. Calls run back
to back on the same inputs: a closed loop with one caller.

Traffic parameters (``params``): ``steps``.

End to end: ``grad_per_s``, the calls completed in the window over the
time from its start to the last of them; ``setup_s``.

The check: every call's loss and gradient norm are the same bits as the
first's (``calls_differ``, the configuration states that the value and
gradient are deterministic); the last call's loss, gradient and final
positions against the reference's (``reference.trajectory_grad``, f64):
``loss_rel`` and ``gforce_p90`` (``control.grad_compare``: the gradient
less its part that no force makes, 2(p − p̄), so that the forces' backward
is what is judged).
"""

from __future__ import annotations

import time

from portbench.lib import checks, control, generators, reference
from portbench.lib.traces import TraceWindow


def _bh_kwargs(sim: dict) -> dict:
    return {k: sim[k] for k in ("theta", "leaf_size", "world_size",
                                "softening2", "unweighted_leaf_com")
            if k in sim}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, log=print):
    import torch

    from nbody_simulation_tpu_torch.ops.traversal_grad import bh_accel_diff

    conf, p = cell.config, cell.params
    sim = conf["sim"]
    steps = int(p["steps"])
    dt = reference.f32_dt(sim.get("dt", 0.1))
    kw = _bh_kwargs(sim)
    pos_np, vel_np, mass_np = generators.make_state(
        conf["scenario"], seed, conf["scenario_args"])
    pos0 = torch.as_tensor(pos_np, device=device)
    vel0 = torch.as_tensor(vel_np, device=device)
    mass = torch.as_tensor(mass_np, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def call():
        p0 = pos0.detach().requires_grad_(True)
        q, v = p0, vel0
        for _ in range(steps):
            v = v + bh_accel_diff(q, mass, **kw) * dt
            q = q + v * dt
        loss = ((q - q.mean(0)) ** 2).sum()
        (g,) = torch.autograd.grad(loss, p0)
        return loss.detach(), g, q.detach()

    loss, g, q = call()                                  # warm-up
    float(loss), float(g.norm())
    del loss, g, q
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()

    n_trace = int(cell.trace.get("calls", 0)) if trace else 0
    skip = int(cell.trace.get("skip_calls", 0))
    prof, trace_s = None, None
    reads, t_last = [], None
    t_w0 = time.monotonic()
    t_end = t_w0 + seconds
    while True:
        i = len(reads)
        if n_trace and i == skip:
            sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_tr = time.perf_counter()
        loss, g, q = call()
        read = (float(loss), float(g.norm()))
        if n_trace and i == skip + n_trace - 1:
            sync()
            trace_s = time.perf_counter() - t_tr
            prof.__exit__(None, None, None)
        t = time.monotonic()
        if t > t_end and reads and (not n_trace or trace_s is not None):
            break
        reads.append(read)
        t_last = t
        last = (loss, g, q)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)
    del loss, g, q

    e2e = {"setup_s": t_w0 - t0}
    if reads and t_last <= t_end:
        e2e["grad_per_s"] = len(reads) / (t_last - t_w0)
    layer = None
    if trace_s is not None:
        layer = {"trace": TraceWindow.from_profile(prof, trace_s),
                 "steps": None, "calls": n_trace, "counting": None,
                 "sim": sim, "n": pos0.shape[0]}
        prof = None

    differ = sum(r != reads[0] for r in reads)
    lv, gv, qv = last
    l_ref, g_ref, q_ref = reference.trajectory_grad(
        pos0, vel0, mass, steps, reference.diff_bh(sim), dt)
    live = mass > 0
    numbers = {"calls_differ": float(differ)}
    numbers.update(control.grad_compare(float(lv), gv, qv, float(l_ref),
                                        g_ref, q_ref, live))
    c_got, c_ref = control.force_part(gv, qv), control.force_part(g_ref, q_ref)
    zero = torch.zeros_like(c_ref)
    log("check: the force part's distance at the 50th and 99th percentile "
        f"{checks.rel_increment(c_got, c_ref, zero, live, 0.5):.4e}, "
        f"{checks.rel_increment(c_got, c_ref, zero, live, 0.99):.4e}; "
        f"the reference's median {float(c_ref[live].norm(dim=1).median()):.4e}")
    log(f"check: {len(reads)} calls, {differ} with another loss or gradient "
        f"norm than the first; loss {float(lv)!r} against {float(l_ref)!r}")
    return {"e2e": e2e, "attempted": len(reads), "failed": 0,
            "memory_peak_bytes": memory_peak, "numbers": numbers,
            "layer": layer}
