"""``engine.frame_gap_p95_ms``: the 95th percentile of the intervals
between consecutive snapshots the consumer received after the traced
stretch, in ms; per layer where ``engine.ups`` is."""


def read(ctx):
    return ctx.get("e2e", {}).get("frame_gap_p95_ms")
