#!/usr/bin/env python3
"""Run ``chip_smoke.py`` from several checkouts in turns, on one card.

    python3 tools/smoke_in_turns.py --out DIR CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory that holds a checkout of the repository (the
tree itself is ``.``; an earlier commit is unpacked with ``git archive
<commit> | tar -x -C DIR``). The runs go in the order given, so ``A B B A``
compares two versions in turns. Each run's output is written to
``DIR/<i>_<name>.log``, every line stamped with the seconds since that run
began, so that two runs' phases can be set side by side. Prints, for each
run, its exit code, its seconds, its ``phase`` lines and the ``ms`` of
each kernel from its ``kernels`` line, and as its last line one JSON object
of the same. Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def run(checkout: Path, log: Path) -> dict:
    t0 = time.perf_counter()
    phases, kernels = [], None
    with subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=checkout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, bufsize=1) as proc, log.open("w") as f:
        for line in proc.stdout:
            at = time.perf_counter() - t0
            f.write(f"[{at:8.2f}] {line}")
            if line.startswith("phase ") or " phase " in line:
                phases.append(f"{at:.2f} s: {line.strip()}")
            if line.startswith('{"kernels"'):
                kernels = {k["name"]: k["ms"]
                           for k in json.loads(line)["kernels"]}
    return {"checkout": str(checkout), "rc": proc.returncode,
            "seconds": time.perf_counter() - t0, "phases": phases,
            "kernel_ms": kernels, "log": str(log)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", type=Path, nargs="+")
    parser.add_argument("--out", type=Path, required=True)
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    results = []
    for i, checkout in enumerate(args.checkouts):
        name = checkout.resolve().name
        res = run(checkout, args.out / f"{i}_{name}.log")
        results.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps({"runs": results}))
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
