"""``engine.ups``: the view loop's steps per second on the host clock, from
the first snapshot after the traced stretch to the last in the window.
Per layer in a cell whose rate spreads between runs by more than a bound
can hold (the launch-bound galaxy: the host's speed sets it)."""


def read(ctx):
    return ctx.get("e2e", {}).get("ups")
