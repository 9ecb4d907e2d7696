"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell but the look for a card (the
driver, then the judgement against the cell's limits) on the CPU at a
small size, once sound and once with each fault the cell can have: a step
that returns its state unchanged, half of the rows left out, an answer
altered where it is produced. One chip, so no exchange between chips."""

import time

import pytest
import torch

from conftest import small_cell
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops import traversal_grad
from nbody_simulation_tpu_torch.runtime import engine as engine_mod
from portbench.lib import checks, manifest


def _run(cell, seconds):
    driver = manifest.load_module("drivers", cell.driver)
    out = driver.run(cell, 5, seconds, False, "cpu", time.monotonic(),
                     log=lambda *_: None)
    return checks.judge(out["numbers"], cell.check["limits"])


def _unchanged(monkeypatch):
    monkeypatch.setattr(World, "_bh_step", lambda self, st: st)


def _half_rows(monkeypatch):
    force = World._bh_force

    def half(self, spos, smass):
        acc = force(self, spos, smass)
        return torch.cat([acc[:acc.shape[0] // 2],
                          torch.zeros_like(acc[acc.shape[0] // 2:])])
    monkeypatch.setattr(World, "_bh_force", half)


def _altered_frame(monkeypatch):
    render = engine_mod.render_frame_sparse

    def altered(*a, **kw):
        idx, vals = render(*a, **kw)
        vals = vals.clone()
        vals[0] ^= 0x00FF00
        return idx, vals
    monkeypatch.setattr(engine_mod, "render_frame_sparse", altered)


VIEW_FAULTS = {"sound": None, "unchanged": _unchanged,
               "half_rows": _half_rows, "altered_frame": _altered_frame}


@pytest.mark.parametrize("fault", list(VIEW_FAULTS))
@pytest.mark.parametrize("name", ["galaxy-bh-view", "plummer-quad-view"])
def test_view_run_sees_each_fault(monkeypatch, name, fault):
    if VIEW_FAULTS[fault]:
        VIEW_FAULTS[fault](monkeypatch)
    ok, compared = _run(small_cell(name), 2.0)
    assert ok == (fault == "sound"), compared


def _no_force(monkeypatch):
    diff = traversal_grad.bh_accel_diff
    monkeypatch.setattr(traversal_grad, "bh_accel_diff",
                        lambda pos, mass, **kw: diff(pos, mass, **kw) * 0.0)


def _half_force(monkeypatch):
    diff = traversal_grad.bh_accel_diff

    def half(pos, mass, **kw):
        acc = diff(pos, mass, **kw)
        keep = (torch.arange(acc.shape[0]) < acc.shape[0] // 2)[:, None]
        return acc * keep
    monkeypatch.setattr(traversal_grad, "bh_accel_diff", half)


def _altered_gradient(monkeypatch):
    grad = torch.autograd.grad

    def altered(outputs, inputs, *a, **kw):
        return tuple(g * (1.0 + 1e-4) for g in grad(outputs, inputs, *a, **kw))
    monkeypatch.setattr(torch.autograd, "grad", altered)


GRAD_FAULTS = {"sound": None, "unchanged": _no_force,
               "half_rows": _half_force, "altered_gradient": _altered_gradient}


@pytest.mark.parametrize("fault", list(GRAD_FAULTS))
def test_grad_run_sees_each_fault(monkeypatch, fault):
    if GRAD_FAULTS[fault]:
        GRAD_FAULTS[fault](monkeypatch)
    ok, compared = _run(small_cell("galaxy-bh-grad"), 1.0)
    assert ok == (fault == "sound"), compared
