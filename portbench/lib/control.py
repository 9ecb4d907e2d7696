"""The control: the reference put in the program's place, computed in
bfloat16, the precision below the configurations' float32. Its numbers,
read as a run reads the program's, must fail the cell's limits; the tests
under ``tests/`` hold that, on the CPU at a small size and on the card at
the cells' own sizes.
"""

from __future__ import annotations

import torch

from portbench.lib import checks, generators, reference


def _state(cell, seed: int, device: str):
    conf = cell.config
    return tuple(torch.as_tensor(a, device=device) for a in
                 generators.make_state(conf["scenario"], seed,
                                       conf["scenario_args"]))


def view_numbers(cell, seed: int, device: str) -> dict:
    """The first batch of a view cell from the seed's state, stepped by the
    control and by the reference: ``dv_p99``, ``dx_ulp_p99`` and
    ``frame_px`` (the control's frame, rendered from its bfloat16 state,
    against the reference's)."""
    sim = cell.config["sim"]
    spb = int(cell.params["steps_per_snapshot"])
    pos, vel, mass = _state(cell, seed, device)
    rp, rv, rm, rows = reference.run_steps(pos, vel, mass, 0, spb, False, sim)
    cp, cv, cm, _ = reference.run_steps(pos, vel, mass, 0, spb, False, sim,
                                        prec=reference.CONTROL)
    live = rm > 0
    cp, cv = cp.float(), cv.float()

    def frame(p, v, m):
        return reference.render(p.cpu().numpy(), v.cpu().numpy(),
                                m.float().cpu().numpy(),
                                sim.get("world_size", 1e5),
                                sim.get("render_size", 1250),
                                sim.get("heavy_weight", 10.0))

    px = int((frame(cp, cv, cm) != frame(rp, rv, rm)).any(-1).sum())
    return {"dv_p99": checks.rel_increment(cv, rv, vel[rows], live),
            "dx_ulp_p99": checks.ulp_distance(cp, rp, live),
            "frame_px": float(px)}


def grad_numbers(cell, seed: int, device: str) -> dict:
    """The value+grad of a gradient cell by the control and by the
    reference: ``grad_compare``'s numbers."""
    steps = int(cell.params["steps"])
    dt = cell.config["sim"].get("dt", 0.1)
    bh = reference.diff_bh(cell.config["sim"])
    pos, vel, mass = _state(cell, seed, device)
    l_ref, g_ref, q_ref = reference.trajectory_grad(pos, vel, mass, steps,
                                                    bh, dt)
    l_c, g_c, q_c = reference.trajectory_grad(pos, vel, mass, steps, bh, dt,
                                              prec=reference.CONTROL)
    return grad_compare(float(l_c), g_c, q_c, float(l_ref), g_ref, q_ref,
                        mass > 0)


def force_part(g, q):
    """The gradient of Σ|p − p̄|² less the part no force makes, 2(p − p̄)."""
    q = q.double()
    return g.double() - 2.0 * (q - q.mean(0))


def grad_compare(loss, g, q, l_ref, g_ref, q_ref, live) -> dict:
    """``loss_rel``, the loss's distance from the reference's over it, and
    ``gforce_p90``: the 90th percentile over live rows of the distance of
    the gradient's force part from the reference's, over the reference's
    (``checks.rel_increment``). The program's gradient is f32 and its
    force part a small share of it, so the quantile is the 90th: rounding
    alone takes each row some per cent from the reference, and a force
    part missing from a tenth of the rows or more reads about 1."""
    c_got, c_ref = force_part(g, q), force_part(g_ref, q_ref)
    return {"loss_rel": abs(loss - l_ref) / abs(l_ref),
            "gforce_p90": checks.rel_increment(
                c_got, c_ref, torch.zeros_like(c_ref), live, 0.9)}
