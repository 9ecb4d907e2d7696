"""The port's Barnes-Hut planner and grouped sweep against the JAX package.

The sweep's CUDA kernel runs only on a card (chip_smoke.py holds it to the
plain version there); on the CPU ``grouped_force`` runs the plain version
``grouped_force_ref``, which these tests hold to the JAX sweep in interpret
mode (exact reciprocal), as the JAX package's own tests run it.

Tolerance for sums that differ only in order: |Δa| ≤ 1e-5 · Σ_j |c_ij| per
target and component (a per-target relative error is ill-conditioned where
forces cancel).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.models.scenarios import uniform_disc as juniform
from nbody_simulation_tpu.ops import traversal as jtrav
from nbody_simulation_tpu.ops import tree as jtree
from nbody_simulation_tpu_torch.ops import traversal as ttrav
from nbody_simulation_tpu_torch.ops.force import direct_accel, pair_accel
from nbody_simulation_tpu_torch.ops.tree import tree_from_numpy

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUM_RTOL = 1e-5


def _abs_sum(tgt, sx, sy, sm):
    """Σ_j |c_ij| per target and component (float64)."""
    ax, ay = pair_accel(sx[:, None, :] - tgt[:, :, 0:1],
                        sy[:, None, :] - tgt[:, :, 1:2], sm[:, None, :])
    return torch.stack([ax.double().abs().sum(-1),
                        ay.double().abs().sum(-1)], -1).numpy()


def _close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


@pytest.fixture(scope="module")
def trees():
    """One JAX tree (N=8192 uniform disc) and the same tree in the port."""
    st = juniform(8192, seed=1)
    tree, _ = jtree.build_tree(st.pos, st.mass)
    port = tree_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in tree.levels],
        np.asarray(tree.leaf_pos), np.asarray(tree.leaf_mass))
    return tree, port


# The JAX planner under one jit (op-by-op dispatch costs seconds per call).
_jax_plan = jax.jit(jtrav.bh_plan_sources, static_argnums=(1, 2, 3),
                    static_argnames=("arity", "plan_leaves"))


@pytest.mark.parametrize("theta,fcap,lcap,arity,pl", [
    (50.0, 16, 16, 2, 4),    # the main path's configuration
    (50.0, 16, 16, 4, 4),    # 4-ary walk
    (2.0, 8, 4, 2, 1),       # overflow on both caps → COM fallback
    (0.7, 128, 64, 2, 1),    # wide candidates: the sorting compaction
])
def test_planner_columns_identical_on_the_same_tree(trees, theta, fcap, lcap,
                                                    arity, pl):
    jt, pt = trees
    want = _jax_plan(jt, theta, fcap, lcap, arity=arity, plan_leaves=pl)
    got = ttrav.bh_plan_sources(pt, theta, fcap, lcap, arity=arity,
                                plan_leaves=pl)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("theta,fcap,arity,mp,levels", [
    (50.0, 16, 2, 1, 2),     # the θ=50 near stage's bounded walk
    (0.7, 16, 4, 2, 2),      # 4-ary, quadrupole (flushes carry no Q)
    (0.7, 8, 2, 2, 0),       # no level walked: the seed level flushed
])
def test_bounded_and_seeded_walks_identical_on_the_same_tree(
        trees, theta, fcap, arity, mp, levels):
    """The distributed paths' planner forms on one tree: the bounded walk
    that flushes at the cut (the forest's), the bounded walk that returns
    its frontier instead, and the walk seeded with that frontier down to
    the leaves (a near stage's continuation). Same tree, same integer
    decisions: frontier, valid and every column bitwise JAX's."""
    jt, pt = trees
    j_own, p_own = jt.levels[jt.depth - 1], pt.levels[pt.depth - 1]
    kw = dict(arity=arity, multipole=mp, max_levels=levels)
    want = jax.jit(lambda t, o: jtrav.plan_rows(t, o, theta, fcap, 0, **kw))(
        jt, j_own)
    got = ttrav.plan_rows(pt, p_own, theta, fcap, 0, **kw)
    assert len(got) == 3 * mp
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    (jcols, jfr, jva), cut = jax.jit(lambda t, o: jtrav.plan_rows(
        t, o, theta, fcap, 0, return_frontier=True, **kw))(jt, j_own), \
        min(jt.depth, min(fcap.bit_length() - 1, jt.depth - 1) + levels)
    cols, fr, va = ttrav.plan_rows(pt, p_own, theta, fcap, 0,
                                   return_frontier=True, **kw)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(va.numpy(), np.asarray(jva))
    for w, g in zip(jcols, cols):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    want = jax.jit(lambda t, o, f, v: jtrav.plan_rows(
        t, o, theta, fcap, 32, arity=arity, multipole=mp,
        seed=(cut, f, v)))(jt, j_own, jfr, jva)
    got = ttrav.plan_rows(pt, p_own, theta, fcap, 32, arity=arity,
                          multipole=mp, seed=(cut, fr, va))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="seeded frontier"):
        ttrav.plan_rows(pt, p_own, theta, 2 * fcap, 32, seed=(cut, fr, va))


@pytest.mark.parametrize("g,s,c", [(3, 64, 200), (16, 32, 300), (5, 7, 1)])
def test_grouped_force_ref_matches_jax_sweep(g, s, c):
    rng = np.random.default_rng(g * 100 + s)
    tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
    sx = rng.uniform(0, 1e5, (g, c)).astype(np.float32)
    sy = rng.uniform(0, 1e5, (g, c)).astype(np.float32)
    sm = rng.integers(0, 100, (g, c)).astype(np.float32)
    sx[0, 0], sy[0, 0] = tgt[0, 0]  # a coincident pair, masked
    want = np.asarray(jtrav._grouped_force(
        jnp.asarray(tgt), jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sm),
        softening2=1e-3, rcp="exact", interpret=True))
    tt = [torch.from_numpy(a) for a in (tgt, sx, sy, sm)]
    got = ttrav.grouped_force(*tt, softening2=1e-3, rcp="exact")
    assert got.shape == (g, s, 2)
    _close_in_sum(got.numpy(), want, _abs_sum(*tt))
    # The plain version computes "exact" whatever rcp says, like the JAX
    # interpret path.
    assert torch.equal(ttrav.grouped_force(*tt, rcp="approx"), got)


def _bucket_scene(rng, g=512, s=64, c=512, sparse_frac=0.5,
                  dense_blocks=(0, 2)):
    """tests/test_bucketed_sweep.py's scene: only dense_blocks carry mass
    past sparse_frac·c."""
    tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
    sx = rng.uniform(0, 1e5, (g, c)).astype(np.float32)
    sy = rng.uniform(0, 1e5, (g, c)).astype(np.float32)
    sm = rng.integers(1, 100, (g, c)).astype(np.float32)
    cut = int(c * sparse_frac)
    for b in range(g // 128):
        if b not in dense_blocks:
            sm[b * 128:(b + 1) * 128, cut:] = 0.0
    return tgt, sx, sy, sm


def test_bounded_sweep_matches_jax_bucketed_and_own_full_sweep():
    arrs = _bucket_scene(np.random.default_rng(0))
    want = np.asarray(jtrav._grouped_force_bucketed(
        *(jnp.asarray(a) for a in arrs), softening2=1e-3, rcp="exact",
        interpret=True, block_frac=0.5, col_frac=0.5))
    tt = [torch.from_numpy(a) for a in arrs]
    lim = ttrav.last_nonzero_columns(tt[3])
    assert lim[:128].eq(512).all() and lim[128:256].eq(256).all()
    got = ttrav.grouped_force(*tt, softening2=1e-3, rcp="exact",
                              col_limit=lim)
    _close_in_sum(got.numpy(), want, _abs_sum(*tt))
    full = ttrav.grouped_force(*tt, softening2=1e-3, rcp="exact")
    assert torch.equal(got, full)


def test_bh_sweep_stops_each_group_at_its_last_source(trees, monkeypatch):
    """The Barnes-Hut path always passes the per-group bound to the sweep."""
    _, pt = trees
    seen = []
    real = ttrav.grouped_force

    def spy(*args, col_limit=None, **kw):
        seen.append(col_limit)
        return real(*args, col_limit=col_limit, **kw)

    monkeypatch.setattr(ttrav, "grouped_force", spy)
    ttrav.bh_accel_sorted(pt, theta=50.0, frontier_cap=16, leaf_cap=16,
                          plan_leaves=4)
    sm = ttrav.bh_plan_sources(pt, 50.0, 16, 16, plan_leaves=4)[2]
    assert len(seen) == 1
    assert torch.equal(seen[0], ttrav.last_nonzero_columns(sm))
    assert int(seen[0].min()) < sm.shape[1]  # the bound cuts real work here


def test_last_nonzero_columns():
    m = torch.tensor([[0.0, 1.0, 0.0, 2.0, 0.0], [0.0] * 5, [1.0] + [0.0] * 4])
    assert ttrav.last_nonzero_columns(m).tolist() == [4, 0, 1]
    assert ttrav.last_nonzero_columns(torch.zeros(3, 0)).tolist() == [0] * 3


def test_theta0_equals_direct_summation():
    st = juniform(2048, seed=2)
    pos = torch.from_numpy(np.array(st.pos))
    mass = torch.from_numpy(np.array(st.mass))
    got = ttrav.bh_accel(pos, mass, theta=0.0, multipole=1)
    want = direct_accel(pos, mass)
    x, y = pos[:, 0], pos[:, 1]
    ax, ay = pair_accel(x[None, :] - x[:, None], y[None, :] - y[:, None],
                        mass[None, :])
    scale = torch.stack([ax.double().abs().sum(1),
                         ay.double().abs().sum(1)], -1).numpy()
    _close_in_sum(got.numpy(), want.numpy(), scale)


def test_theta50_sorted_sweep_matches_jax_on_the_same_tree(trees):
    """Same tree, same planned columns: only the summation order differs."""
    jt, pt = trees
    kw = dict(theta=50.0, frontier_cap=16, leaf_cap=16, plan_leaves=4)
    want = np.asarray(jtrav.bh_accel_sorted(jt, **kw))
    got = ttrav.bh_accel_sorted(pt, **kw)
    sx, sy, sm = ttrav.bh_plan_sources(pt, 50.0, 16, 16, plan_leaves=4)
    tgt = pt.leaf_pos.reshape(sx.shape[0], -1, 2)
    _close_in_sum(got.numpy(), want, _abs_sum(tgt, sx, sy, sm).reshape(-1, 2))


def test_theta50_matches_jax_bh_accel():
    """Each package builds its own tree. Leaf COMs are f32 means whose sums
    run in another order (rtol 1e-6, ~0.01 world units), and at θ=50 nodes
    are accepted as close as a few leaf widths, so a moved COM changes its
    term by ~1e-5 relative (1.7e-5 of Σ|c| measured here): 1e-4 · Σ|c|."""
    st = juniform(8192, seed=4)
    kw = dict(theta=50.0, plan_leaves=4)
    want = np.asarray(jtrav.bh_accel(st.pos, st.mass, **kw))
    pos = torch.from_numpy(np.array(st.pos))
    mass = torch.from_numpy(np.array(st.mass))
    got = ttrav.bh_accel(pos, mass, **kw)
    from nbody_simulation_tpu_torch.ops.tree import build_tree
    tree, order = build_tree(pos, mass)
    sx, sy, sm = ttrav.bh_plan_sources(tree, 50.0, 16, 16, plan_leaves=4)
    tgt = tree.leaf_pos.reshape(sx.shape[0], -1, 2)
    scale = np.empty((8192, 2))
    scale[order.numpy()] = _abs_sum(tgt, sx, sy, sm).reshape(-1, 2)[:8192]
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= 1e-4 * scale), (err / scale).max()


def test_sweep_refuses_what_it_cannot_run():
    t = torch.zeros(2, 4, 2)
    s = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ttrav.grouped_sweep(t, s, s, s)  # CPU tensors never reach a kernel
    with pytest.raises(ValueError, match="no sweep"):
        ttrav.grouped_force(t.to("meta"), s.to("meta"), s.to("meta"),
                            s.to("meta"))
    with pytest.raises(ValueError, match="rcp"):
        ttrav.grouped_force(t, s, s, s, rcp="fast")
    # θ<2 resolves to the quadrupole path (kernel K4's plain version here).
    acc = ttrav.bh_accel(torch.rand(64, 2) * 1e5, torch.ones(64), theta=0.5)
    assert acc.shape == (64, 2) and bool(torch.isfinite(acc).all())
