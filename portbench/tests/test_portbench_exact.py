"""The cell ``galaxy-exact-view``: a sound run judges correct and each fault
does not, the control fails the cell's limits, the configuration is the
CLI's, and the per-layer readers' arithmetic on the cell's trace.

The runs drive the whole driver and the judgement on the CPU at a small
size (a 1,024-body Plummer cluster, padded by the World to 2,048 rows);
``-m card -s`` runs the faults and the control at the cell's own size on
the card and prints their readings."""

import time

import pytest
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models import world as world_mod
from nbody_simulation_tpu_torch.ops import energy as energy_mod
from nbody_simulation_tpu_torch.runtime import engine as engine_mod
from portbench.lib import (checks, generators, manifest, reference,
                           reference_exact, roofline)
from portbench.lib.traces import TraceWindow

CELL = "galaxy-exact-view"


def small_exact():
    """The cell with its galaxy swapped for a compact 1,024-body Plummer
    cluster, so that a run fits the CPU; the limits stay the cell's."""
    cell = manifest.load_cell(CELL)
    cell.config["scenario"] = "plummer"
    cell.config["scenario_args"] = {"n": 1024, "scale_radius": 300.0}
    return cell


def _run(cell, seconds, device, log=lambda *_: None):
    driver = manifest.load_module("drivers", cell.driver)
    out = driver.run(cell, 2**31 + 77, seconds, False, device,
                     time.monotonic(), log=log)
    return checks.judge(out["numbers"], cell.check["limits"])


def _unchanged(monkeypatch):
    monkeypatch.setattr(world_mod, "euler_step", lambda st, accel, dt: st)


def _half_rows(monkeypatch):
    sym = world_mod.allpairs_accel_sym

    def half(pos, mass, **kw):
        acc = sym(pos, mass, **kw)
        # Every other row, so that half of the live rows lose their force
        # whatever the padding after them.
        keep = (torch.arange(acc.shape[0], device=acc.device) % 2 == 0)
        return acc * keep[:, None]
    monkeypatch.setattr(world_mod, "allpairs_accel_sym", half)


def _altered_energy(monkeypatch):
    kinetic = energy_mod.kinetic_energy
    monkeypatch.setattr(energy_mod, "kinetic_energy",
                        lambda *a, **kw: kinetic(*a, **kw) * (1.0 + 1e-4))


def _altered_potential(monkeypatch):
    """A potential 0.1% off: on the galaxy that moves E by ~4e-7 of it,
    within ``energy_rel``'s limit, so only ``potential_rel`` sees it."""
    potential = energy_mod.potential_energy
    monkeypatch.setattr(energy_mod, "potential_energy",
                        lambda *a, **kw: potential(*a, **kw) * (1.0 + 1e-3))


def _altered_frame(monkeypatch):
    render = engine_mod.render_frame_sparse

    def altered(*a, **kw):
        idx, vals = render(*a, **kw)
        vals = vals.clone()
        vals[0] ^= 0x00FF00
        return idx, vals
    monkeypatch.setattr(engine_mod, "render_frame_sparse", altered)


FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows,
          "altered_energy": _altered_energy,
          "altered_potential": _altered_potential,
          "altered_frame": _altered_frame}


@pytest.mark.parametrize("fault", ["sound"] + list(FAULTS))
def test_run_sees_each_fault(monkeypatch, fault):
    if fault in FAULTS:
        FAULTS[fault](monkeypatch)
    ok, compared = _run(small_exact(), 2.0, "cpu")
    assert ok == (fault == "sound"), compared


@pytest.mark.card
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_fail_at_the_cells_size(card, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    ok, compared = _run(manifest.load_cell(CELL), 5.0, card)
    print(f"fault {fault}: {compared}")
    assert not ok, compared


def control_numbers(cell, seed: int, device: str) -> dict:
    """The first batch from the seed's state, stepped by the control (the
    reference in bfloat16) and by the reference, and the control's energy
    of the reference's state after it: the cell's numbers, read as a run
    reads the program's; ``potential_rel`` is the control's potential in
    the potential kernel K6's place alone."""
    conf, sim = cell.config, cell.config["sim"]
    spb = int(cell.params["steps_per_snapshot"])
    pos, vel, mass = (torch.as_tensor(a, device=device) for a in
                      generators.make_state(conf["scenario"], seed,
                                            conf["scenario_args"]))
    soft2 = float(sim["softening2"])
    rp, rv = reference_exact.run_steps(pos, vel, mass, spb, sim)
    cp, cv = reference_exact.run_steps(pos, vel, mass, spb, sim,
                                       reference_exact.CONTROL)
    cp, cv = cp.float(), cv.float()
    live = mass > 0

    def frame(p, v):
        return reference.render(p.cpu().numpy(), v.cpu().numpy(),
                                mass.cpu().numpy(), sim["world_size"],
                                sim["render_size"], sim["heavy_weight"])

    e_ref = reference_exact.total_energy(rp, rv, mass, soft2)
    e_ctl = reference_exact.total_energy(rp, rv, mass, soft2,
                                         reference_exact.CONTROL)
    u_ref = float(reference_exact.potential(rp, mass, soft2))
    u_ctl = float(reference_exact.potential(rp, mass, soft2,
                                            reference_exact.CONTROL))
    return {"dv_p99": checks.rel_increment(cv, rv, vel, live),
            "dx_ulp_p99": checks.ulp_distance(cp, rp, live),
            "frame_px": float((frame(cp, cv) != frame(rp, rv)).any(-1).sum()),
            "energy_rel": abs(e_ctl - e_ref) / abs(e_ref),
            "potential_rel": abs(u_ctl - u_ref) / abs(u_ref)}


def test_control_fails_at_a_small_size():
    cell = small_exact()
    numbers = control_numbers(cell, 11, "cpu")
    ok, compared = checks.judge(numbers, cell.check["limits"])
    assert not ok, compared
    # Each number alone, not only one of them.
    for name, limit in cell.check["limits"].items():
        assert numbers[name] > limit, (name, compared)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 7, 424242, 9001])
def test_control_fails_at_the_cells_size(card, seed):
    cell = manifest.load_cell(CELL)
    numbers = control_numbers(cell, seed, card)
    ok, compared = checks.judge(numbers, cell.check["limits"])
    print(f"control {CELL} seed {seed}: {compared}")
    assert not ok, compared


def test_the_configuration_is_the_clis_exact_path():
    """Every setting of ``sim`` is SimConfig's under ``--force-path
    pallas``, the reciprocal as it resolves."""
    sim = manifest.load_cell(CELL).config["sim"]
    cli = SimConfig(force_path="pallas")
    for key, value in sim.items():
        got = cli.resolved_rcp() if key == "rcp" else getattr(cli, key)
        assert got == value, key


# -- the readers ---------------------------------------------------------------

N = 151_317


def _window():
    """40 galaxy steps of K2 at 12.91 ms (3 launches of the round kernel and
    fold, one finish), 4 samples of K6 at 8.65 ms, and a kernel of the
    cross-block form K9 and others that are neither; times in µs."""
    dev, t = [], 0.0
    for _ in range(40):
        for name, ms in (("void allpairs_sym_rounds<1, true>(float2 const*)",
                          4.0), ("sym_fold(double2 const*)", 0.3)) * 3:
            dev.append((name, t, t + ms * 1e3))
            t += ms * 1e3
        dev.append(("sym_finish(double2 const*)", t, t + 0.01e3))
        t += 0.01e3 + 50.0
    for _ in range(4):
        dev.append(("void potential_kernel<false>(float2 const*)", t,
                    t + 8.6e3))
        dev.append(("potential_fold(double const*)", t + 8.6e3, t + 8.65e3))
        t += 8.65e3 + 1e3
    dev.append(("sym_pair_finish(double2 const*)", t, t + 5e3))
    dev.append(("elementwise_kernel", t + 5e3, t + 6e3))
    return TraceWindow(window_s=(t + 6e3) / 1e6 + 0.05, device=dev, host=[])


def _ctx(**kw):
    ctx = {"trace": _window(), "steps": 40, "samples": 4, "n": N,
           "sim": manifest.load_cell(CELL).config["sim"], "e2e": {}}
    ctx.update(kw)
    return ctx


def _read(name, ctx):
    return manifest.load_module("metrics", name).read(ctx)


def test_k2_share_is_the_laws_pairs_over_the_kernels_time():
    k2_s = 40 * 12.91e-3
    least = N * N / 2 * 24 / 3.35e13          # 24 FP32 operations a pair
    assert roofline.law_ops("sym", "newton") == 24
    assert _read("allpairs.k2_roofline_pct", _ctx()) == pytest.approx(
        100 * 40 * least / k2_s)
    assert _read("allpairs.k2_roofline_pct", _ctx()) == pytest.approx(
        63.5, abs=0.1)


def test_k6_share_is_the_potentials_pairs_over_the_kernels_time():
    # U needs the n²/2 pairs i < j; K6 sums all n², so it reads 39.5%.
    k6_s = 4 * 8.65e-3
    least = N * N / 2 * 10 / 3.35e13          # 10 FP32 operations a pair
    assert roofline.law_ops("pot", "newton") == 10
    assert _read("energy.k6_roofline_pct", _ctx()) == pytest.approx(
        100 * 4 * least / k6_s)
    assert _read("energy.k6_roofline_pct", _ctx()) == pytest.approx(
        39.5, abs=0.1)


def test_the_step_readers_read_the_exact_cells_trace():
    """``step.device_ms``, ``step.device_ops`` and ``device.idle_pct.view``
    read this cell's trace as the Plummer view's: every device event of the
    window (the samples' K6 among them) over the steps traced."""
    tw = _window()
    busy = sum(e - s for _, s, e in tw.device) / 1e6   # no two overlap
    assert _read("step.device_ms", _ctx()) == pytest.approx(
        1e3 * busy / 40)
    assert _read("step.device_ops", _ctx()) == pytest.approx(
        len(tw.device) / 40)
    assert _read("device.idle_pct.view", _ctx()) == pytest.approx(
        100 * (tw.window_s - busy) / tw.window_s)


@pytest.mark.parametrize("name,ctx", [
    ("energy.k6_roofline_pct", {"samples": 0}),
    ("energy.k6_roofline_pct", {"trace": TraceWindow(1.0, [], [])}),
    ("allpairs.k2_roofline_pct", {"trace": TraceWindow(1.0, [], [])}),
    ("device.idle_pct.view", {"trace": TraceWindow(1.0, [], [])}),
], ids=["no_samples", "no_k6", "no_k2", "no_device"])
def test_a_reader_with_nothing_to_read_returns_nothing(name, ctx):
    assert _read(name, _ctx(**ctx)) is None


def test_a_meter_without_potentials_fails_before_set_up(monkeypatch):
    """A program whose meter keeps only its samples cannot be held to
    ``potential_rel``: the run exits with an error at once."""
    from nbody_simulation_tpu_torch.utils import telemetry

    class Plain:
        def __init__(self, *a, **kw):
            self.samples = []
    monkeypatch.setattr(telemetry, "EnergyMeter", Plain)
    driver = manifest.load_module("drivers", "engine_view_energy")
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="no potential energies"):
        driver.run(small_exact(), 1, 1.0, False, "cpu", t0)
    assert time.monotonic() - t0 < 5.0


def test_the_exact_reference_imports_nothing_of_the_port():
    from test_portbench_arithmetic import BENCH, FORBIDDEN, _top_imports
    tops = _top_imports(BENCH / "lib/reference_exact.py")
    assert not tops & (FORBIDDEN | {"nbody_simulation_tpu_torch"})
