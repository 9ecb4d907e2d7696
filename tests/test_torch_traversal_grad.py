"""The port's differentiable Barnes-Hut against the JAX package.

The backward kernels (K8, ``csrc/force_grad.cu``) run only on a card;
chip_smoke.py holds them to the plain versions there. On the CPU the
sweep's backward runs the plain closed form ``grouped_force_bwd_ref`` and
the tree and planner differentiate by torch autograd; these tests hold
both to the JAX package's ``jax.vjp`` and ``jax.grad``, its Pallas kernels
in interpret mode (exact reciprocal), as its own tests run them.

Tolerances: the sweeps sum the same terms in another order, |Δ| ≤ 1e-5 ·
Σ|term| per output element; whole gradients 1e-5 in relative norm (torch
autograd of the plain tree and planner lies ~3e-7 from the JAX package's
on these inputs, measured on the CPU host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu.ops import traversal as jtrav
from nbody_simulation_tpu.ops import traversal_grad as jtg
from nbody_simulation_tpu.ops import tree as jtree
from nbody_simulation_tpu_torch.ops import traversal_grad as ttg
from nbody_simulation_tpu_torch.ops.allpairs_grad import _grad_terms
from nbody_simulation_tpu_torch.ops.force import direct_accel
from nbody_simulation_tpu_torch.ops.traversal import bh_accel

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUM_RTOL = 1e-5
GRAD_RTOL = 1e-5


def cloud(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100_000, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 100, n).astype(np.float32)
    return pos, mass


def lattice(seed):
    """32×32 bodies at spacing 100, as the galaxy's annulus sits on a
    lattice: many leaf pairs have dx = 0 or dy = 0."""
    ii, jj = np.meshgrid(np.arange(32), np.arange(32))
    pos = np.stack([ii.ravel(), jj.ravel()], 1) * 100.0 + 40_000.0
    mass = np.random.default_rng(seed).integers(1, 100, 1024)
    return pos.astype(np.float32), mass.astype(np.float32)


def cotangent(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def rel_norm(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# -- (d) the sweep's four cotangents on the JAX tree's columns ----------------

@pytest.fixture(scope="module")
def planned():
    """The JAX tree of 1000 bodies (24 padding slots at EMPTY_POS) planned
    at θ=0.5, one leaf per row, its columns carried over as numpy arrays,
    with the JAX forward and ``jax.vjp`` of ``grouped_force_diff``."""
    pos, mass = cloud(1, 1000)
    tree, _ = jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass))
    cols = jax.jit(jtrav.bh_plan_sources, static_argnums=(1, 2, 3))(
        tree, 0.5, 64, 32)
    g = cols[0].shape[0]
    tgt = tree.leaf_pos.reshape(g, -1, 2)
    cot = cotangent(2, tgt.shape)
    out, vjp = jax.vjp(lambda *a: jtg.grouped_force_diff(*a, 1e-3, "newton"),
                       tgt, *cols)
    arrays = [np.asarray(a) for a in (tgt, *cols)]
    return arrays, cot, np.asarray(out), [np.asarray(v) for v in vjp(cot)]


def _sweep_scale(tgt, gbar, sx, sy, sm):
    f = lambda a: torch.tensor(a, dtype=torch.float64)
    ux, uy, rt = _grad_terms(*(f(a) for a in (tgt[:, :, 0:1], tgt[:, :, 1:2],
                                              gbar[:, :, 0:1],
                                              gbar[:, :, 1:2])),
                             f(sx[:, None]), f(sy[:, None]), f(sm[:, None]),
                             1e-3)
    ux, uy, rt = ux.abs(), uy.abs(), rt.abs()
    return [torch.stack([ux.sum(-1), uy.sum(-1)], -1).numpy(),
            ux.sum(1).numpy(), uy.sum(1).numpy(), rt.sum(1).numpy()]


def _close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


def test_grouped_force_diff_cotangents_match_jax_vjp(planned):
    arrays, cot, out_want, vjp_want = planned
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = ttg.grouped_force_diff(*ins, 1e-3, "newton")
    out.backward(torch.tensor(cot))
    assert np.abs(out.detach().numpy() - out_want).max() <= (
        SUM_RTOL * np.abs(out_want).max())
    for t, w, sc in zip(ins, vjp_want, _sweep_scale(arrays[0], cot,
                                                    *arrays[1:])):
        assert t.grad.shape == w.shape
        _close_in_sum(t.grad.numpy(), w, sc)


def test_backward_runs_over_every_column(planned):
    """m̄ = Σ r·t does not scale with the mass, so a massless column past a
    group's last nonzero mass still gets its cotangent: the backward does
    not take the forward's column bound."""
    arrays, cot, _, vjp_want = planned
    tgt, sx, sy, sm = (torch.tensor(a) for a in arrays)
    tail = sm == 0
    assert bool(tail.any())
    mbar = ttg.grouped_force_bwd(tgt, torch.tensor(cot), sx, sy, sm)[3]
    assert bool((mbar[tail] != 0).any())
    assert torch.equal(mbar, ttg.grouped_bwd_src_ref(
        tgt, torch.tensor(cot), sx, sy, sm)[2])


# -- (e) whole Barnes-Hut gradients against jax.grad --------------------------

CASES = {
    "cloud-theta0": (cloud, 0.0, dict(frontier_cap=64, leaf_cap=16,
                                      unweighted_leaf_com=False)),
    "cloud-theta0.5": (cloud, 0.5, dict(frontier_cap=64, leaf_cap=32)),
    "cloud-theta50": (cloud, 50.0, {}),
    "lattice-theta50": (lambda s, n: lattice(s), 50.0, {}),
}


@pytest.fixture(scope="module")
def jax_bh_grads():
    out = {}
    for k, (make, theta, kw) in CASES.items():
        pos, mass = make(3, 1024)
        cot = cotangent(4, (1024, 2))

        def loss(p, m):
            return jnp.sum(jtg.bh_accel_diff(p, m, theta=theta, **kw) * cot)
        out[k] = (pos, mass, cot, jax.jit(jax.grad(loss, (0, 1)))(
            jnp.asarray(pos), jnp.asarray(mass)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_bh_gradients_match_jax(jax_bh_grads, case):
    _, theta, kw = CASES[case]
    pos, mass, cot, (gp, gm) = jax_bh_grads[case]
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    a = ttg.bh_accel_diff(p, m, theta=theta, **kw)
    (a * torch.tensor(cot)).sum().backward()
    assert rel_norm(p.grad, gp) < GRAD_RTOL
    assert rel_norm(m.grad, gm) < GRAD_RTOL
    # The forward is the run mode's walk at multipole=1 and 15-bit keys.
    kw = {"frontier_cap": 32, "leaf_cap": 16, **kw}
    run = bh_accel(torch.tensor(pos), torch.tensor(mass), theta=theta,
                   multipole=1, morton_bits=15, plan_leaves=1, rcp="newton",
                   **kw)
    assert torch.equal(a.detach(), run)


# -- (f) θ=0 against torch autograd of direct_accel ---------------------------

def test_theta0_gradients_match_autograd_of_direct_sum():
    """θ=0 Barnes-Hut is the direct sum; off the kinks (a random cloud) its
    gradient is torch autograd of ``direct_accel``: relative norm 1e-4 for
    positions and rtol 1e-3 for masses, the JAX package's bounds."""
    pos, mass = cloud(5, 512)
    cot = torch.tensor(cotangent(6, (512, 2)))
    kw = dict(theta=0.0, frontier_cap=64, leaf_cap=16,
              unweighted_leaf_com=False)
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    (ttg.bh_accel_diff(p, m, **kw) * cot).sum().backward()
    pd = torch.tensor(pos, requires_grad=True)
    md = torch.tensor(mass, requires_grad=True)
    (direct_accel(pd, md) * cot).sum().backward()
    assert rel_norm(p.grad, pd.grad) < 1e-4
    np.testing.assert_allclose(m.grad.numpy(), md.grad.numpy(), rtol=1e-3,
                               atol=1e-10)


# -- (g) what the wrappers refuse ---------------------------------------------

def test_only_cuda_tensors_reach_the_kernels():
    t = torch.zeros(2, 4, 2)
    s = torch.ones(2, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ttg.grouped_bwd_tgt_cuda(t, t, s, s, s)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ttg.grouped_bwd_src_cuda(t, t, s, s, s)
    with pytest.raises(ValueError, match="no sweep backward"):
        ttg.grouped_force_bwd(*(a.to("meta") for a in (t, t, s, s, s)))
    assert ttg.grouped_bwd_tgt_cuda.launches == 0
    assert ttg.grouped_bwd_src_cuda.launches == 0


# -- (h) the planner's gather: a backward in fixed order ----------------------

def _top_nodes(rng):
    """Rows 0-3 in every one of 512 groups (the top of the tree), a sparse
    spread of rows 4-29, rows 30-39 never."""
    return np.concatenate([np.tile(np.arange(4), (512, 1)),
                           rng.integers(4, 30, (512, 6))], axis=1)


# Index shapes for the segmented sum, whose kernel takes windows of 256
# sorted entries (the largest window a build may choose, 512, too): a run
# cut by window edges or filling them exactly, runs of one, rows with none.
GATHER_INDICES = {
    "top-nodes": _top_nodes,
    "every-row-once": lambda rng: rng.permutation(40)[:, None],
    "one-row-all": lambda rng: np.full((700, 1), 17),
    "runs-of-whole-windows": lambda rng: np.repeat([2, 5, 6, 9], 512)[
        rng.permutation(2048)].reshape(256, 8),
    "ragged-K": lambda rng: rng.integers(0, 40, (333, 3)) // 3 * 3,
}


# Ids: dtype0/dtype1 for the top-nodes cases, the index's name first for
# the others.
GATHER_CASES = [
    pytest.param(case, dtype, id=(f"dtype{k}" if case == "top-nodes"
                                  else f"{case}-dtype{k}"))
    for case in GATHER_INDICES
    for k, dtype in enumerate((torch.int64, torch.int32))]


@pytest.mark.parametrize("case, dtype", GATHER_CASES)
def test_gather_backward_adds_duplicates_in_fixed_order(case, dtype):
    """``traversal._rows`` gathers rows of a table; every group gathers the
    same top-level nodes, so its backward adds many duplicates per row.
    Against an f64 ``index_add`` of the same cotangent: within f32 rounding
    of the sum of |terms| per row (a run of k terms is k - 1 f32 additions).
    Bitwise on two calls; rows no index names get +0; the forward is
    ``index_select``'s bits."""
    from nbody_simulation_tpu_torch.ops.traversal import (_rows,
                                                          index_add_ordered)
    rng = np.random.default_rng(12)
    n_rows, width = 40, 8
    idx = GATHER_INDICES[case](rng)
    table = torch.tensor(rng.normal(0, 1, (n_rows, 2, width)).astype(
        np.float32), requires_grad=True)
    cot = torch.tensor(rng.normal(0, 1e3, idx.shape + (2, width)).astype(
        np.float32))
    tidx = torch.tensor(idx, dtype=dtype)

    def grad():
        out = _rows(table, tidx)
        assert torch.equal(out.detach(), table.detach()[tidx.long()])
        return torch.autograd.grad((out * cot).sum(), table)[0]

    g1, g2 = grad(), grad()
    assert torch.equal(g1.view(torch.int32), g2.view(torch.int32))
    flat_cot = cot.reshape(-1, 2, width)
    want = torch.zeros((n_rows, 2, width), dtype=torch.float64).index_add_(
        0, tidx.reshape(-1).long(), flat_cot.double())
    scale = torch.zeros((n_rows, 2, width), dtype=torch.float64).index_add_(
        0, tidx.reshape(-1).long(), flat_cot.double().abs())
    runs = torch.bincount(tidx.reshape(-1).long(), minlength=n_rows)
    bound = (runs.clamp_min(1) - 1)[:, None, None] * 2.0 ** -24 * scale
    assert bool(((g1.double() - want).abs() <= bound).all())
    assert bool((g1[runs == 0].view(torch.int32) == 0).all())   # +0
    assert torch.equal(g1, index_add_ordered(
        n_rows, tidx.reshape(-1), flat_cot))


def test_gather_backward_matches_jax_vjp():
    """``index_add_ordered`` against the JAX package's own gather gradient,
    ``jax.vjp(lambda t: t[idx], table)``, at a planner level's shape: 64
    nodes of fan·ncols = 4·8 columns, 16 groups of a 12-wide frontier, each
    holding the top 4 nodes. XLA adds each row's k terms in f32 (k - 1
    roundings), the port in f64 rounded once: within k·2^-24 of the row's
    Σ|terms|."""
    from nbody_simulation_tpu_torch.ops.traversal import index_add_ordered
    rng = np.random.default_rng(21)
    n_rows, width = 64, 32
    idx = np.concatenate([np.tile(np.arange(4), (16, 1)),
                          rng.integers(4, 48, (16, 8))], axis=1).astype(
                              np.int32)
    table = rng.normal(0, 1, (n_rows, width)).astype(np.float32)
    cot = rng.normal(0, 1e3, idx.shape + (width,)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    got = index_add_ordered(n_rows, torch.tensor(idx.reshape(-1)),
                            torch.tensor(cot.reshape(-1, width)))
    runs = np.bincount(idx.reshape(-1), minlength=n_rows)[:, None]
    scale = np.zeros((n_rows, width))
    np.add.at(scale, idx.reshape(-1), np.abs(cot.reshape(-1, width)))
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    assert np.all(err <= runs * 2.0 ** -24 * scale)
    assert np.all(got.numpy()[runs[:, 0] == 0] == 0)


def test_segment_sum_runs_only_where_it_can():
    """The segmented sum's kernel takes CUDA tensors only (and counts no
    launch otherwise); its plain version takes the same arguments (the
    sorted key, its permutation, the row count) and adds empty runs as
    +0."""
    from nbody_simulation_tpu_torch.ops import traversal as tt
    src = torch.ones(6, 3)
    key = torch.tensor([0, 0, 2, 2, 2, 2])
    perm = torch.arange(6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tt.segment_sum_cuda(src, key, perm, 4)
    assert tt.segment_sum_cuda.launches == 0
    for k in (key, key.int()):
        out = tt.segment_sum_ref(src, k, perm, 4)
        assert out.dtype == torch.float32
        assert out.tolist() == [[2.0] * 3, [0.0] * 3, [4.0] * 3, [0.0] * 3]
    with pytest.raises(ValueError, match="no segmented sum"):
        tt.index_add_ordered(3, perm.to("meta"), src.to("meta"))
