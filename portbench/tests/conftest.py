"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. Tests marked ``card`` need a CUDA device and skip without
one; ``python -m pytest portbench/tests -m card -s`` runs them on the card
and prints their readings."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def small_cell(name: str):
    """Cell ``name`` with its configuration cut to a compact 1,024-body
    Plummer cluster (caps of 32 below θ=2), so that a run fits the CPU; the
    limits stay the cell's."""
    from portbench.lib import manifest
    cell = manifest.load_cell(name)
    conf = cell.config
    conf["scenario"] = "plummer"
    conf["scenario_args"] = {"n": 1024, "scale_radius": 300.0}
    if conf["sim"]["theta"] < 2:
        conf["sim"].update(frontier_cap=32, leaf_cap=32)
    return cell
