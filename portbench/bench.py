"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/bench.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json`` and
``workloads/<name>.json`` name its configuration, its driver and its
traffic; the driver sets up the program (the package
``nbody_simulation_tpu_torch``) from the seed, warms up the cell's shapes,
measures for ``--seconds`` and checks what the timed path produced against
the plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced part of the window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``) and, last, ``checks``: each number compared with its limit,
which the last lines of standard error also give. The run exits 2 without
a result where the card or the cells' chips are missing, and 3 where JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.monotonic`` clock (Linux: its
    start time since boot; elsewhere, now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_simulation_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench.lib import checks, manifest

    cell = manifest.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = manifest.load_module("drivers", cell.driver)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T0, log=log)
    correct, compared = checks.judge(out["numbers"], cell.check["limits"])

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        ctx = out["layer"]
        metrics = {}
        for m in cell.per_layer:
            value = manifest.load_module("metrics", m["name"]).read(ctx) \
                if ctx else None
            if _number(value) is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx:
            tr = ctx["trace"]
            device["busy_s"] = tr.busy_s()
            device["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_top(),
                                   "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end
                   if _number(out["e2e"].get(m["name"])) is not None}
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = compared

    found = loaded_forbidden()
    if found:
        log(f"portbench: loaded {', '.join(found)}; the benchmark runs the "
            "port alone")
        return 3
    for name, c in compared.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
