"""``phase.sum_gravity_ms``: the engine's ``Counting.sum_gravity`` (the
planner and the sweep of ``World.step_timed``) over the profiled steps that
ended in the window, in ms per profiled step."""


def read(ctx):
    c = ctx.get("counting")
    if not c or not c["profiled_steps"]:
        return None
    return c["sum_gravity"] * 1e3 / c["profiled_steps"]
