"""The port's quadrupole Barnes-Hut path (θ<2) against the JAX package.

Tree second moments, the ``multipole=2`` planner, the quadrupole pair law
and sweep (kernel K4's plain version, which ``grouped_force`` runs for CPU
tensors; chip_smoke.py holds the CUDA kernel to it on a card), and the path
as a whole. The JAX sweep runs in interpret mode (exact reciprocals), as
the JAX package's own tests run it.

Tolerances. Sums that differ only in order: |Δa| ≤ 1e-5 · Σ_j (|dx·w| +
|corr|) per target and component, the sum of the absolute monopole and
correction terms (a per-target relative error is ill-conditioned where
forces cancel). The per-pair law and the planner's columns are the same
IEEE operations in the same order in both packages: bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.config import SimConfig as JaxConfig
from nbody_simulation_tpu.models.scenarios import plummer as jplummer
from nbody_simulation_tpu.models.scenarios import uniform_disc as juniform
from nbody_simulation_tpu.models.world import World as JaxWorld
from nbody_simulation_tpu.ops import morton as jmorton
from nbody_simulation_tpu.ops import traversal as jtrav
from nbody_simulation_tpu.ops import tree as jtree
from nbody_simulation_tpu_torch import run
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.world import World
from nbody_simulation_tpu_torch.ops import traversal as ttrav
from nbody_simulation_tpu_torch.ops import tree as ttree
from nbody_simulation_tpu_torch.ops.force import direct_accel, pair_accel
from nbody_simulation_tpu_torch.state import state_from_numpy

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUM_RTOL = 1e-5
F32_EPS = float(np.finfo(np.float32).eps)


def _port_tree(jt):
    return ttree.tree_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in jt.levels],
        np.asarray(jt.leaf_pos), np.asarray(jt.leaf_mass))


@pytest.fixture(scope="module")
def trees():
    """One JAX tree (N=8192 uniform disc) and the same tree in the port."""
    st = juniform(8192, seed=1)
    jt, _ = jtree.build_tree(st.pos, st.mass)
    return jt, _port_tree(jt)


# -- 1. tree second moments ---------------------------------------------------

def _exact_sum_cloud(seed, n=3000):
    """Integer positions and masses in halves, small enough that every leaf
    sum of positions (and of mass·position) is exact in f32 in any order:
    both packages then store bitwise the same leaf COMs, and the moments
    differ only by their own sums' order."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(10_000, 50_000, (n, 2)).astype(np.float32)
    pos[:200] = pos[0] + rng.integers(0, 8, (200, 2))  # a tight cluster
    mass = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0, 3.0]), n)
    mass[rng.choice(n, 70, replace=False)] = 0.0       # padding mixed in
    order = np.asarray(jmorton.morton_order(jnp.asarray(pos),
                                            jnp.asarray(mass), 1e5))
    return pos[order], mass[order]


@pytest.mark.parametrize("unweighted", [True, False])
def test_tree_second_moments_match_jax(unweighted):
    """Level.quad at every level. Internal COMs may differ by an ulp (XLA
    contracts the JAX package's two-child COM sum into an FMA), and Q about
    a COM moved by ε moves by up to 2ε·Σm|δ| + M·ε² ≤ 2ε·√(M·tr Q) + M·ε²;
    beyond that, a few f32 ulps of tr Q = Σ m·|δ|²."""
    spos, smass = _exact_sum_cloud(3)
    jt = jtree.summarize_sorted(jnp.asarray(spos), jnp.asarray(smass),
                                leaf_size=16, unweighted_leaf_com=unweighted)
    tt = ttree.summarize_sorted(torch.from_numpy(spos),
                                torch.from_numpy(smass), leaf_size=16,
                                unweighted_leaf_com=unweighted, quad=True)
    np.testing.assert_array_equal(tt.levels[-1].com.numpy(),
                                  np.asarray(jt.levels[-1].com))
    for lt, lj in zip(tt.levels, jt.levels):
        got = lt.quad.numpy().astype(np.float64)
        want = np.asarray(lj.quad, np.float64)
        tr = want[:, 0] + want[:, 2]
        com_t = lt.com.numpy().astype(np.float64)
        com_j = np.asarray(lj.com, np.float64)
        eps = np.maximum(np.abs(com_t - com_j).max(axis=1),
                         np.abs(com_j).max(axis=1) * F32_EPS)
        m = lt.mass_i.numpy().astype(np.float64)
        tol = 8 * F32_EPS * tr + 4 * eps * np.sqrt(m * tr) + 2 * m * eps ** 2
        assert np.all(np.abs(got - want).max(axis=1) <= tol)
    np.testing.assert_array_equal(tt.levels[-1].packed_quad.numpy()[:, 8:],
                                  tt.levels[-1].quad.numpy())
    # The monopole paths build no moments, and the planner says so.
    plain = ttree.summarize_sorted(torch.from_numpy(spos),
                                   torch.from_numpy(smass), leaf_size=16)
    assert plain.levels[0].quad is None
    with pytest.raises(ValueError, match="quad=True"):
        ttrav.bh_plan_sources(plain, 0.5, 16, 16, multipole=2)


def test_tree_round_trip_carries_the_moments(trees):
    jt, pt = trees
    levels, leaf_pos, leaf_mass = ttree.tree_to_numpy(pt)
    assert len(levels) == len(jt.levels)
    for got, lvl in zip(levels, jt.levels):
        assert len(got) == 6
        for a, b in zip(got, lvl):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(leaf_pos, np.asarray(jt.leaf_pos))
    np.testing.assert_array_equal(leaf_mass, np.asarray(jt.leaf_mass))


# -- 2. the multipole=2 planner -----------------------------------------------

# The JAX planner under one jit (op-by-op dispatch costs seconds per call).
_jax_plan = jax.jit(jtrav.bh_plan_sources, static_argnums=(1, 2, 3),
                    static_argnames=("arity", "plan_leaves", "multipole"))


@pytest.mark.parametrize("theta,fcap,lcap,arity,pl", [
    (0.5, 16, 32, 2, 4),     # binary walk, 4 leaves per planning row
    (0.5, 16, 32, 4, 1),     # 4-ary walk, one leaf per row
    (0.5, 8, 4, 2, 1),       # overflow on both caps → monopole COM fallback
    (0.7, 128, 64, 2, 1),    # wide candidates: the sorting compaction
])
def test_planner_quad_columns_identical_on_the_same_tree(trees, theta, fcap,
                                                         lcap, arity, pl):
    jt, pt = trees
    want = _jax_plan(jt, theta, fcap, lcap, arity=arity, plan_leaves=pl,
                     multipole=2)
    got = ttrav.bh_plan_sources(pt, theta, fcap, lcap, arity=arity,
                                plan_leaves=pl, multipole=2)
    assert len(got) == 6
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[3] != 0).any())  # some nodes carry moments
    # Leaf-particle tiles carry no moments; the monopole planner is as before.
    n_leaf = lcap * pt.leaf_pos.shape[1]
    assert not bool(got[3][:, -n_leaf:].any())
    mono = ttrav.bh_plan_sources(pt, theta, fcap, lcap, arity=arity,
                                 plan_leaves=pl)
    assert len(mono) == 3


# -- 3. the pair law ----------------------------------------------------------

def _parts(dx, dy, m, q, soft2=1e-3):
    """(|dx·w| + |corr_x|, |dy·w| + |corr_y|) of quad_tile per pair: the law
    with Q = 0 is the monopole term, with m = 0 the correction."""
    z = torch.zeros_like(dx)
    mono = ttrav.quad_tile(dx, dy, m, z, z, z, soft2)
    corr = ttrav.quad_tile(dx, dy, torch.zeros_like(m), *q, soft2)
    return [a.abs().double() + b.abs().double() for a, b in zip(mono, corr)]


def test_quad_tile_matches_jax_per_pair():
    """Elementwise within 4 ulps of |dx·w| + |corr| (measured: bitwise),
    with the same NaN pattern: kinks at dx=0 and dy=0 (sign +1 at ±0), a
    coincident pair, subnormal and huge ‖d‖₁ (huge d makes (8dx·dx)·ab³ =
    inf·0, NaN in both), NaN and inf inputs."""
    rng = np.random.default_rng(0)
    n = 2048
    dx, dy = rng.uniform(-1e4, 1e4, (2, n)).astype(np.float32)
    m = rng.integers(0, 1000, n).astype(np.float32)
    size2 = rng.uniform(1, 3e3, n) ** 2
    qxx = (m * size2 * rng.uniform(0, 1, n)).astype(np.float32)
    qyy = (m * size2 * rng.uniform(0, 1, n)).astype(np.float32)
    qxy = (np.sqrt(qxx * qyy) * rng.uniform(-1, 1, n)).astype(np.float32)
    special = [(0.0, 5.0), (5.0, 0.0), (-0.0, 7.0), (3.0, -0.0), (0.0, 0.0),
               (2e-40, 0.0), (1e-45, 1e-45), (1e-3, 2e-3), (1e20, 1e20),
               (3e38, 0.0), (np.nan, 1.0), (1.0, np.nan), (np.inf, 1.0)]
    for i, (a, b) in enumerate(special):
        dx[i], dy[i] = a, b
    arrs = [dx, dy, m, qxx, qxy, qyy]
    want = [np.asarray(a) for a in jtrav._quad_tile(
        *(jnp.asarray(a) for a in arrs), 1e-3, "exact")]
    tt = [torch.from_numpy(a) for a in arrs]
    got = [a.numpy() for a in ttrav.quad_tile(*tt, 1e-3)]
    scale = _parts(tt[0], tt[1], tt[2], tt[3:])
    for g, w, sc in zip(got, want, scale):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        tol = 4 * np.spacing(sc.numpy()[ok].astype(np.float32))
        assert np.all(np.abs(g[ok].astype(np.float64) - w[ok]) <= tol)
    assert np.isnan(got[0][8]) and got[0][4] == 0.0 and got[0][5] == 0.0


# -- 4. the sweep -------------------------------------------------------------

def _scene(g, s, c, seed):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
    sx, sy = rng.uniform(0, 1e5, (2, g, c)).astype(np.float32)
    sm = rng.integers(0, 100, (g, c)).astype(np.float32)
    q = [(sm * rng.uniform(0, 4e6, (g, c))).astype(np.float32)
         for _ in range(3)]
    q[1] = (q[1] - sm * 2e6).astype(np.float32)  # qxy of either sign
    return tgt, sx, sy, sm, q


def _sweep_scale(tgt, sx, sy, sm, q):
    """Σ_j (|dx·w| + |corr|) per target and component (float64)."""
    dx = sx[:, None, :] - tgt[:, :, 0:1]
    dy = sy[:, None, :] - tgt[:, :, 1:2]
    parts = _parts(dx, dy, sm[:, None, :].expand_as(dx),
                   [a[:, None, :].expand_as(dx) for a in q])
    return torch.stack([p.sum(-1) for p in parts], -1).numpy()


def _jax_sweep(tgt, sx, sy, sm, q):
    return np.asarray(jtrav._grouped_force(
        *(jnp.asarray(a) for a in (tgt, sx, sy, sm)), softening2=1e-3,
        rcp="exact", interpret=True, src_q=tuple(jnp.asarray(a) for a in q)))


def _close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


@pytest.mark.parametrize("g,s,c", [(3, 64, 200), (16, 32, 300), (5, 7, 1)])
def test_quad_sweep_matches_jax_sweep(g, s, c):
    tgt, sx, sy, sm, q = _scene(g, s, c, g * 100 + s)
    sx[0, 0], sy[0, 0] = tgt[0, 0]  # a coincident pair, masked
    want = _jax_sweep(tgt, sx, sy, sm, q)
    tt = [torch.from_numpy(a) for a in (tgt, sx, sy, sm)]
    tq = tuple(torch.from_numpy(a) for a in q)
    got = ttrav.grouped_force(*tt, softening2=1e-3, rcp="exact", src_q=tq)
    assert got.shape == (g, s, 2)
    _close_in_sum(got.numpy(), want, _sweep_scale(*tt, tq))
    # The plain version computes "exact" whatever rcp says, like the JAX
    # interpret path, and "+clamp" changes nothing in this law.
    assert torch.equal(ttrav.grouped_force(*tt, rcp="newton+clamp",
                                           src_q=tq), got)


def test_column_bound_keeps_moment_only_columns():
    """A column with m = 0 and Q ≠ 0 (a node of fractional masses whose
    int32 mass is 0) past each group's last nonzero mass still acts: the
    bound counts it, and the bounded sweep equals JAX's full sweep and,
    bitwise, the port's own."""
    tgt, sx, sy, sm, q = _scene(4, 16, 96, 9)
    sm[:, 40:] = 0.0
    for a in q:
        a[:, 40:] = 0.0
    q[0][1, 70], q[1][1, 70], q[2][1, 70] = 5e9, -2e9, 3e9
    want = _jax_sweep(tgt, sx, sy, sm, q)
    tt = [torch.from_numpy(a) for a in (tgt, sx, sy, sm)]
    tq = tuple(torch.from_numpy(a) for a in q)
    lim = ttrav.last_nonzero_columns(tt[3], tq)
    assert lim.tolist() == [40, 71, 40, 40]
    assert ttrav.last_nonzero_columns(tt[3]).tolist() == [40] * 4
    got = ttrav.grouped_force(*tt, rcp="exact", col_limit=lim, src_q=tq)
    _close_in_sum(got.numpy(), want, _sweep_scale(*tt, tq))
    assert torch.equal(got, ttrav.grouped_force(*tt, rcp="exact", src_q=tq))
    mass_only = ttrav.grouped_force(*tt, rcp="exact", src_q=tq,
                                    col_limit=ttrav.last_nonzero_columns(
                                        tt[3]))
    assert not torch.equal(mass_only[1], got[1])


def test_quad_sweep_refuses_what_it_cannot_run():
    t, s = torch.zeros(2, 4, 2), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ttrav.grouped_sweep(t, s, s, s, src_q=(s, s, s))


# -- 5. the path as a whole ---------------------------------------------------

# Caps small enough for the plain sweep on the CPU. With 32-particle leaves
# a 2048-body Plummer has 64 leaves: no cap overflows, the far leaves are
# accepted with their moments and the near ones summed exactly.
CAPS = dict(frontier_cap=64, leaf_cap=64, leaf_size=32)


def _rel_err(got, want):
    num = np.linalg.norm(got - want, axis=1)
    return num / np.maximum(np.linalg.norm(want, axis=1), 1e-12)


def test_bh_accel_quad_matches_jax_and_beats_monopole():
    """Each package builds its own tree, whose COMs and moments are ulps
    apart (test_tree_second_moments_match_jax), so the accepted nodes'
    terms differ by ~1e-7 relative: held within 1e-5 of Σ_j |c_ij| of the
    direct sum. Against f64 direct summation the median relative error is
    below 1e-3 and below half of the monopole's, as the JAX package's
    tests/test_traversal.py asks of it."""
    st = jplummer(2048, seed=0)
    kw = dict(theta=0.5, unweighted_leaf_com=False, **CAPS)
    want = np.asarray(jtrav.bh_accel(st.pos, st.mass, multipole=2, **kw))
    pos = torch.from_numpy(np.array(st.pos))
    mass = torch.from_numpy(np.array(st.mass))
    got = ttrav.bh_accel(pos, mass, multipole=2, **kw).numpy()
    mono = ttrav.bh_accel(pos, mass, multipole=1, **kw).numpy()
    d64 = direct_accel(pos.double(), mass.double()).numpy()
    x, y = pos[:, 0].double(), pos[:, 1].double()
    ax, ay = pair_accel(x[None, :] - x[:, None], y[None, :] - y[:, None],
                        mass.double()[None, :])
    scale = torch.stack([ax.abs().sum(1), ay.abs().sum(1)], -1).numpy()
    _close_in_sum(got, want, scale)
    e_quad, e_mono = np.median(_rel_err(got, d64)), np.median(
        _rel_err(mono, d64))
    assert e_quad < 1e-3 and e_quad < 0.5 * e_mono, (e_quad, e_mono)


def test_quad_theta0_equals_direct_summation():
    st = juniform(1024, seed=2)
    pos = torch.from_numpy(np.array(st.pos))
    mass = torch.from_numpy(np.array(st.mass))
    got = ttrav.bh_accel(pos, mass, theta=0.0, multipole=2, **CAPS)
    want = direct_accel(pos, mass)
    x, y = pos[:, 0], pos[:, 1]
    ax, ay = pair_accel(x[None, :] - x[:, None], y[None, :] - y[:, None],
                        mass[None, :])
    scale = torch.stack([ax.double().abs().sum(1),
                         ay.double().abs().sum(1)], -1).numpy()
    _close_in_sum(got.numpy(), want.numpy(), scale)


def test_quad_world_two_steps_match_jax():
    """The θ=0.5 World resolves to 24-bit keys, multipole=2 and rcp=newton
    (exact on the CPU in both packages). Forces agree to ~1e-6 relative and
    are ~1e-8 here, so after two steps velocities agree within 4 ulps of the
    largest and positions within 4 ulps each."""
    kw = dict(force_path="bh", theta=0.5, frontier_cap=64, leaf_cap=32)
    jst = jplummer(2048, seed=3)
    jw = JaxWorld(jst, JaxConfig(**kw))
    tw = World(state_from_numpy(np.asarray(jst.pos), np.asarray(jst.vel),
                                np.asarray(jst.mass)), SimConfig(**kw))
    assert tw.config.resolved_multipole() == 2
    jw.run(2)
    tw.run(2)
    j = {k: np.asarray(getattr(jw.state, k)) for k in ("pos", "vel", "mass")}
    t = {k: getattr(tw.state, k).numpy() for k in ("pos", "vel", "mass")}
    np.testing.assert_array_equal(t["mass"], j["mass"])
    assert np.all(np.abs(t["pos"] - j["pos"])
                  <= 4 * np.spacing(np.abs(j["pos"])))
    assert (np.abs(t["vel"] - j["vel"]).max()
            <= 4 * np.spacing(np.abs(j["vel"]).max()))


def test_cli_theta_half_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    seen = []
    real = ttrav.grouped_force

    def spy(*args, src_q=None, **kw):
        seen.append(src_q is not None)
        return real(*args, src_q=src_q, **kw)

    monkeypatch.setattr(ttrav, "grouped_force", spy)
    world = run.simulate(["--scenario", "plummer", "--n", "512",
                          "--leaf-size", "16", "--theta", "0.5",
                          "--weighted-leaf-com", "--device", "cpu",
                          "--steps", "2", "--out", str(tmp_path)])
    assert world.updates == 2 and seen == [True, True]
    assert np.isfinite(world.state.pos.numpy()).all()
    assert (tmp_path / "frame_00000002.png").exists()
    assert "done: 2 steps" in capsys.readouterr().out
