"""``phase.build_bvh_ms``: the engine's ``Counting.build_bvh`` (the Morton
sort and the tree summaries of ``World.step_timed``, each phase ended by a
device synchronise) over the profiled steps that ended in the window, in ms
per profiled step."""


def read(ctx):
    c = ctx.get("counting")
    if not c or not c["profiled_steps"]:
        return None
    return c["build_bvh"] * 1e3 / c["profiled_steps"]
