"""The roofline and trace arithmetic at known shapes."""

import ast
from pathlib import Path

import pytest

from portbench.lib import roofline, traces
from portbench.lib.traces import TraceWindow

BENCH = Path(__file__).resolve().parents[1]


def test_law_counts_are_chip_smokes():
    assert roofline.law_ops("sweep", "approx") == 14
    assert roofline.law_ops("sweep", "newton") == 17
    assert roofline.law_ops("quad", "newton") == 97
    assert roofline.law_ops("grad_i", "newton") == 43
    assert roofline.law_ops("grad_j", "newton") == 45
    assert roofline.law_mufu("quad") == 2 and roofline.law_mufu("sweep") == 1


def test_least_time_at_the_galaxy_sweep():
    """K3's bounded galaxy sweep, 165.8M pairs at 14 FP32 operations: chip_smoke
    read 0.0694 ms at its derived 3.3454e13 op/s; the published 67 TFLOP/s
    gives 3.35e13."""
    t, by = roofline.least_s("sweep", "approx", 165.8e6,
                             roofline.sweep_bytes(300_000, 262_144, False))
    assert by == "fp32"
    assert t == pytest.approx(165.8e6 * 14 / 3.35e13)
    assert t * 1e3 == pytest.approx(0.0693, abs=2e-4)


def test_k8_shape_and_time_at_the_galaxy():
    assert roofline.k8_shape(151_317, 64, 32, 16) == (4096, 64, 1472)
    g, s, c = 4096, 64, 1472
    t = roofline.k8_least_s(g, s, c, 1, 1)
    pairs = g * s * c
    assert t == pytest.approx(pairs * (43 + 45) / 3.35e13)
    # chip_smoke: 0.4960 ms and 0.5191 ms at its derived rate.
    assert t * 1e3 == pytest.approx(0.4960 + 0.5191, rel=0.01)


def _window():
    dev = [("k_a", 0.0, 10.0), ("k_b", 5.0, 20.0), ("k_a", 50.0, 60.0),
           ("k_c", 100.0, 130.0)]
    host = [("aten::index_select", 18.0, 55.0), ("cudaStreamSynchronize",
                                                 70.0, 99.0)]
    return TraceWindow(window_s=200e-6, device=dev, host=host)


def test_trace_arithmetic():
    tw = _window()
    assert tw.count() == 4 and tw.count("k_a") == 2
    assert tw.device_s() == pytest.approx(65e-6)    # each event once
    assert tw.busy_s() == pytest.approx(60e-6)      # their union
    assert tw.device_top(2) == [["k_c", pytest.approx(30e-6)],
                                ["k_a", pytest.approx(20e-6)]]
    gaps = dict(tw.idle_gaps())
    assert gaps == {"aten::index_select": pytest.approx(30e-6),
                    "cudaStreamSynchronize": pytest.approx(40e-6)}


class _RawEvent:
    """A profiler's raw event as ``kineto_results.events()`` gives it."""

    def __init__(self, kind, start_ns, duration_ns):
        self.kind, self.start, self.duration = kind, start_ns, duration_ns

    def device_type(self):
        return f"DeviceType.{self.kind}"

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.duration


def test_whole_window_busy_time_counts_the_union_of_device_events():
    """The same window as ``_window`` in raw events, with host events that
    overlap it and do not count."""
    raw = [_RawEvent("CUDA", 0, 10_000), _RawEvent("CPU", 0, 200_000),
           _RawEvent("CUDA", 5_000, 15_000), _RawEvent("CUDA", 100_000, 30_000),
           _RawEvent("CUDA", 50_000, 10_000), _RawEvent("CUDA", 52_000, 1_000)]
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: raw})()
    assert traces.device_busy_s(prof) == pytest.approx(60e-6)
    assert traces.merged_busy_ns([]) == 0.0


FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_simulation_tpu"}
PLAIN = ("lib/reference.py", "lib/generators.py", "lib/checks.py",
         "lib/roofline.py", "lib/traces.py", "lib/control.py")


def _top_imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_imports(BENCH / path) & FORBIDDEN


@pytest.mark.parametrize("path", PLAIN)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "nbody_simulation_tpu_torch" not in _top_imports(BENCH / path)
