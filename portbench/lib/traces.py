"""What a torch.profiler trace says about the card.

``on_device`` is a frozen copy of ``chip_smoke.py``'s at commit c4ece55,
and ``TraceWindow.device_s`` is its ``device_ms`` (in seconds, from each
event's time range): each device event (kernel, copy, set) counted once. Summing ``key_averages()``
instead counts every kernel launched inside an operator twice (chip_smoke's
``all_entries_ms``, which measures the wrong thing).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

NAME_CHARS = 120   # a breakdown's names, cut: C++ kernel names run to 1,000


def on_device(e) -> bool:
    """Whether a profiler event ran on the card (a kernel, copy or set)."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


@dataclasses.dataclass
class TraceWindow:
    """The events of one traced window: device events as (name, start µs,
    end µs), host events likewise, and the window's length on the host
    clock."""
    window_s: float
    device: list
    host: list

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "TraceWindow":
        dev, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            (dev if on_device(e) else host).append(span)
        return cls(window_s, dev, host)

    def select(self, *names):
        return [d for d in self.device
                if not names or any(n in d[0] for n in names)]

    def count(self, *names) -> int:
        return len(self.select(*names))

    def device_s(self, *names) -> float:
        """Device time of the events whose name holds one of ``names`` (all
        of them without), each counted once."""
        return sum(e - s for _, s, e in self.select(*names)) / 1e6

    def busy_intervals(self):
        spans = sorted((s, e) for _, s, e in self.device)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_top(self, k: int = 10):
        """The ``k`` device operations that took most time, by name."""
        total = defaultdict(float)
        for name, s, e in self.device:
            total[name] += (e - s) / 1e6
        return _top(total, k)

    def idle_gaps(self, k: int = 10):
        """Idle time between device operations, by what the host was doing
        at the middle of each gap (the innermost host event around it, or
        "python" where none is), the ``k`` largest."""
        merged = self.busy_intervals()
        host = sorted((s, e, n) for n, s, e in self.host)
        starts = [h[0] for h in host]
        total = defaultdict(float)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = 0.5 * (e0 + s1)
            name = "python"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 400), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            total[name] += (s1 - e0) / 1e6
        return _top(total, k)


def merged_busy_ns(spans) -> float:
    """Nanoseconds covered by the union of ``(start, end)`` spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_busy_s(prof) -> float:
    """Seconds in which some operation ran on the card over a whole
    profiled window, read from the profiler's raw events
    (``kineto_results``) without building a ``FunctionEvent`` for each of
    them: a 40-s galaxy window holds ~3 million."""
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")]
    return merged_busy_ns(spans) / 1e9


def _top(total: dict, k: int):
    """The ``k`` largest entries, names cut to ``NAME_CHARS``."""
    return [[name[:NAME_CHARS], s] for name, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:k]]
