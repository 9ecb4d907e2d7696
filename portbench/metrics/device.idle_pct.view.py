"""``device.idle_pct.view``: the share of the traced window of the view
loop in which no operation ran on the card, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not ctx.get("steps") or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s()) / tr.window_s
