"""BENCHMARK.json against the contract's shape, and every name it holds
found by name under portbench/."""

import json
import re

import pytest

from portbench.lib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "portbench/bench.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    for word in bench["command"]:
        _line(word)
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        _line(c["source"])
        _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4)
        _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        _line(m["layer"])
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_manifest()["workloads"]])
def test_cell_found_by_name(cell):
    bench = manifest.load_manifest()
    c = manifest.load_cell(cell, bench)
    entry = next(x for x in bench["configs"] if x["name"] == c.config_name)
    assert c.config["name"] == c.config_name
    assert entry["file"].startswith("portbench/")
    assert manifest.load_module("drivers", c.driver).run
    assert set(c.check["limits"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert manifest.load_module("metrics", m["name"]).read
    for m in c.end_to_end:
        if "workloads" in m:
            assert cell in m["workloads"]


def test_configuration_files_are_each_their_own(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no driver 'nope'"):
        manifest.load_module("drivers", "nope")
    with pytest.raises(KeyError):
        manifest.load_cell("nope")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_manifest()["workloads"]])
def test_the_whole_window_is_traced_where_an_end_to_end_metric_needs_it(cell):
    """A view cell with an end-to-end metric read from the device trace
    profiles its whole window in a run without ``--trace`` on a card, and
    only there."""
    c = manifest.load_cell(cell)
    driver = manifest.load_module("drivers", c.driver)
    if not hasattr(driver, "traces_whole_window"):
        assert all(m["source"] == "host_clock" for m in c.end_to_end)
        return
    wants = any(m["source"] == "device_trace" for m in c.end_to_end)
    assert driver.traces_whole_window(c, False, "cuda") == wants
    assert not driver.traces_whole_window(c, True, "cuda")
    assert not driver.traces_whole_window(c, False, "cpu")
