"""The numbers that decide ``correct``, and the judgement against limits."""

from __future__ import annotations

import math

import torch

QUANTILE = 0.99


def rel_increment(got, want, start, live, q: float = QUANTILE) -> float:
    """The ``q`` quantile, over live rows, of each row's distance from the
    reference over the reference's change from ``start``, a change below
    the median counted at the median (so rows that barely move are judged
    on the typical change)."""
    got, want, start = (t.double() for t in (got, want, start))
    inc = (want - start).norm(dim=1)[live]
    floor = inc.median().clamp_min(1e-300)
    err = (got - want).norm(dim=1)[live] / torch.maximum(inc, floor)
    return float(torch.quantile(err, q))


def ulp_distance(got, want, live, q: float = QUANTILE) -> float:
    """The ``q`` quantile, over live rows, of the larger of each row's two
    coordinate distances from the reference in units of the f32 spacing at
    the reference's value."""
    w = want.float()
    spacing = torch.nextafter(w.abs(), torch.full_like(w, float("inf"))) - w.abs()
    err = ((got.double() - want.double()).abs() / spacing.double()).amax(1)
    return float(torch.quantile(err[live], q))


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value": v, "limit": l}}): every number at or below
    its limit; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v if v is None or math.isfinite(v) else str(v),
                     "limit": limit}
    return ok, out
