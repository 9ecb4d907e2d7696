"""The PyTorch port's config, state and scenarios against the JAX package.

Scenario generation is NumPy in both packages, so the arrays must be bitwise
equal; the config must carry the same fields, defaults and resolution rules;
and importing the port must not import JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_simulation_tpu.config import RCP_MODES as JAX_RCP_MODES
from nbody_simulation_tpu.config import SimConfig as JaxConfig
from nbody_simulation_tpu.models import scenarios as jsc
from nbody_simulation_tpu.state import ParticleState as JaxState
from nbody_simulation_tpu_torch.config import RCP_MODES, SimConfig
from nbody_simulation_tpu_torch.models import scenarios as tsc
from nbody_simulation_tpu_torch.state import (ParticleState, state_from_numpy,
                                              state_to_numpy)

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

PORT_DIR = Path(__file__).resolve().parents[1] / "nbody_simulation_tpu_torch"


def _assert_state_bitwise(jst, tst):
    assert tst.n_real == jst.n_real
    for name in ("pos", "vel", "mass"):
        want = np.asarray(getattr(jst, name))
        got = getattr(tst, name).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)


def test_simconfig_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert tf == jf
    assert RCP_MODES == JAX_RCP_MODES


@pytest.mark.parametrize("kw", [
    {}, {"theta": 0.5}, {"theta": 1.99, "plan_leaves": 1},
    {"theta": 2.0, "plan_leaves": 8}, {"rcp": "approx+clamp"},
    {"frontier_cap": 32, "leaf_cap": 12, "morton_bits": 20, "multipole": 1},
])
def test_simconfig_resolution_matches(kw):
    j, t = JaxConfig(**kw), SimConfig(**kw)
    assert t.resolved_caps() == j.resolved_caps()
    assert t.resolved_rcp() == j.resolved_rcp()
    assert t.resolved_rcp(bh=True) == j.resolved_rcp(bh=True)
    assert t.resolved_morton_bits() == j.resolved_morton_bits()
    assert t.resolved_multipole() == j.resolved_multipole()
    assert t.pixels_per_world == j.pixels_per_world
    assert t.replace(dt=0.2).dt == j.replace(dt=0.2).dt


def test_galaxy_bitwise_equal():
    tst = tsc.galaxy(seed=0)
    assert tst.n_real == 151_317
    _assert_state_bitwise(jsc.galaxy(seed=0), tst)


@pytest.mark.parametrize("name,kw", [
    ("uniform_disc", {"n": 1000, "seed": 3}),
    ("plummer", {"n": 1000, "seed": 4}),
    ("collision", {"seed": 5, "n_per_galaxy": 500}),
])
def test_small_scenarios_bitwise_equal(name, kw):
    _assert_state_bitwise(getattr(jsc, name)(**kw), getattr(tsc, name)(**kw))


@pytest.mark.parametrize("n,multiple", [(1000, 256), (256, 256), (5, 64)])
def test_pad_to_sentinels_equal(n, multiple):
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 1e5, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 1, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 9, n).astype(np.float32)
    jst = JaxState.create(pos, vel, mass).pad_to(multiple)
    tst = ParticleState.create(pos, vel, mass).pad_to(multiple)
    assert tst.n == jst.n and tst.n % multiple == 0
    _assert_state_bitwise(jst, tst)


def test_state_round_trip_through_numpy():
    jst = jsc.uniform_disc(300, seed=1).pad_to(128)
    tst = state_from_numpy(np.asarray(jst.pos), np.asarray(jst.vel),
                           np.asarray(jst.mass), n_real=jst.n_real)
    _assert_state_bitwise(jst, tst)
    pos, vel, mass, n_real = state_to_numpy(tst)
    assert n_real == 300 and pos.shape == (384, 2)
    np.testing.assert_array_equal(pos, np.asarray(jst.pos))
    np.testing.assert_array_equal(vel, np.asarray(jst.vel))
    np.testing.assert_array_equal(mass, np.asarray(jst.mass))
    live = tst.real_slice()
    assert live.n == 300 and live.n_real == 300
    moved = tst.to("cpu").replace(vel=torch.zeros_like(tst.vel))
    assert moved.n_real == 300 and not moved.vel.any()
    assert torch.equal(moved.pos, tst.pos)


def test_create_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ParticleState.create(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4))
    with pytest.raises(ValueError):
        ParticleState.create(np.zeros((4, 2)), np.zeros((4, 2)), np.zeros(3))


def test_port_sources_import_neither_jax_nor_the_jax_package():
    for path in sorted(PORT_DIR.rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib"), (path, line)
                assert not mod.startswith("nbody_simulation_tpu."), (path, line)
                assert mod != "nbody_simulation_tpu", (path, line)


def test_import_port_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import nbody_simulation_tpu_torch, nbody_simulation_tpu_torch.run, "
        "nbody_simulation_tpu_torch.run_multihost\n"
        "import nbody_simulation_tpu_torch.models, "
        "nbody_simulation_tpu_torch.ops, nbody_simulation_tpu_torch.runtime, "
        "nbody_simulation_tpu_torch.parallel\n"
        "import nbody_simulation_tpu_torch.utils.checkpoint, "
        "nbody_simulation_tpu_torch.utils.recording, "
        "nbody_simulation_tpu_torch.render_recording, "
        "nbody_simulation_tpu_torch.runtime.control, "
        "nbody_simulation_tpu_torch.viz\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nbody_simulation_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=PORT_DIR.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_sources_are_the_ports_own():
    """The host libraries build from sources inside the port, not from the
    JAX package's directory."""
    from nbody_simulation_tpu_torch.runtime import nativelib
    native = Path(nativelib.NATIVE_DIR).resolve()
    assert native.is_relative_to(PORT_DIR.resolve())
    for name in ("frame", "snapshot_queue"):
        assert (native / f"{name}.cpp").is_file()
    for path in sorted(PORT_DIR.rglob("*.py")):  # no path into it either
        assert '"nbody_simulation_tpu"' not in path.read_text(), path


# -- the small names: constants, morton_encode, accept_node_scalar, trace ----

def test_constants_match_the_jax_package():
    """The rate constants and the "+clamp" floor equal the JAX package's,
    and the kernels' floor (``csrc/pair_law.cuh`` kL1Clamp) is the same
    number as the Python one."""
    import re

    from nbody_simulation_tpu.ops import allpairs as jap
    from nbody_simulation_tpu.ops import energy as jen
    from nbody_simulation_tpu_torch.ops import allpairs as tap
    from nbody_simulation_tpu_torch.ops import energy as ten
    assert tap.FLOPS_PER_PAIR == jap.FLOPS_PER_PAIR == 22
    assert tap.L1_CLAMP == jap.L1_CLAMP == 1e-12
    assert ten.POT_FLOPS_PER_PAIR == jen.POT_FLOPS_PER_PAIR == 10
    header = (PORT_DIR / "csrc" / "pair_law.cuh").read_text()
    (value,) = re.findall(r"kL1Clamp\s*=\s*([0-9.eE+-]+)f;", header)
    assert np.float32(value) == np.float32(tap.L1_CLAMP)


@pytest.mark.parametrize("bits", [15, 24])
def test_morton_encode_matches_jax(bits):
    """Bitwise the JAX ``morton_encode`` (the high key word) on a cloud
    with padding rows and coordinates beyond the world at both ends. Both
    packages take 1 to 24 bits per axis and refuse 30."""
    import jax.numpy as jnp

    from nbody_simulation_tpu.ops.morton import morton_encode as jenc
    from nbody_simulation_tpu_torch.ops.morton import morton_encode as tenc
    rng = np.random.default_rng(bits)
    pos = rng.uniform(-1e3, 1.01e5, (4096, 2)).astype(np.float32)
    mass = rng.integers(0, 4, 4096).astype(np.float32)
    got = tenc(torch.tensor(pos), torch.tensor(mass), 1e5, bits).numpy()
    want = np.asarray(jenc(jnp.asarray(pos), jnp.asarray(mass), 1e5, bits))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError):
        jenc(jnp.asarray(pos), jnp.asarray(mass), 1e5, 30)
    with pytest.raises(ValueError, match="bits"):
        tenc(torch.tensor(pos), torch.tensor(mass), 1e5, 30)


def test_accept_node_scalar_matches_jax():
    """The reference's per-particle criterion on seeded random nodes and
    points (some inside their node, some on its edges), one at a time as
    the JAX function takes them and all at once."""
    import jax.numpy as jnp

    from nbody_simulation_tpu.ops.traversal import accept_node_scalar as jacc
    from nbody_simulation_tpu_torch.ops.traversal import (
        accept_node_scalar as tacc)
    rng = np.random.default_rng(5)
    n = 256
    nmin = rng.uniform(0, 9e4, (n, 2)).astype(np.float32)
    nmax = nmin + rng.uniform(1, 1e4, (n, 2)).astype(np.float32)
    com = (nmin + rng.uniform(0, 1, (n, 2)).astype(np.float32)
           * (nmax - nmin)).astype(np.float32)
    p = rng.uniform(0, 1e5, (n, 2)).astype(np.float32)
    p[:32] = com[:32]                     # inside their node
    p[32:48, 0] = nmin[32:48, 0]          # on an edge: not strictly inside
    theta = np.float32(0.7)
    want = np.array([bool(jacc(jnp.asarray(p[i]), jnp.asarray(nmin[i]),
                               jnp.asarray(nmax[i]), jnp.asarray(com[i]),
                               theta)) for i in range(n)])
    got = tacc(*(torch.tensor(a) for a in (p, nmin, nmax, com)),
               float(theta)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n and not want[:32].any()
    one = tacc(*(torch.tensor(a[40]) for a in (p, nmin, nmax, com)),
               float(theta))
    assert bool(one) == bool(want[40])


def test_trace_writes_a_trace_file(tmp_path):
    from nbody_simulation_tpu_torch.utils.telemetry import trace
    with trace(tmp_path / "tb") as t:
        torch.ones(64).cumsum(0)
    assert t._prof is None
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "traceEvents" in files[0].read_text()
