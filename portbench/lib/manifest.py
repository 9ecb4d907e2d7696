"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) reads ``workloads/<cell>.json``: its
configuration, traffic mix and chips (as BENCHMARK.json has them), its
driver, its traffic parameters, how its output is checked and how its
trace is taken. The configuration it names reads
``configs/<config>.json``, the driver is ``drivers/<driver>.py`` and each
per-layer metric is read by ``metrics/<metric>.py``. Adding a cell, a
configuration, a driver or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: str
    chips: int
    driver: str
    params: dict
    check: dict
    trace: dict
    end_to_end: list
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_metrics(manifest: dict, name: str):
    """(end-to-end, per-layer) metric entries that cell ``name`` reports:
    those whose ``workloads`` list it, or, without the key, every
    end-to-end metric and every per-layer metric whose ``moves`` the cell
    reports."""
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def load_cell(name: str, manifest: dict | None = None,
              root: Path = ROOT) -> Cell:
    manifest = manifest if manifest is not None else load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    spec = _read(BENCH_DIR / "workloads" / f"{name}.json")
    mine = (spec["config"], spec["traffic"], spec["chips"])
    theirs = (entry["config"], entry["traffic"], entry["chips"])
    if mine != theirs:
        raise ValueError(f"workloads/{name}.json names {mine}, "
                         f"BENCHMARK.json {theirs}")
    e2e, per = cell_metrics(manifest, name)
    return Cell(name=name, config_name=entry["config"],
                config=_read(ROOT / conf["file"]), traffic=entry["traffic"],
                chips=int(entry["chips"]), driver=spec["driver"],
                params=spec["params"], check=spec["check"],
                trace=spec.get("trace", {}), end_to_end=e2e, per_layer=per)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder as a module (names
    may hold dots, so it is loaded from its path)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
