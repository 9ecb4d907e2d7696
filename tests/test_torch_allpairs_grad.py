"""The port's differentiable all-pairs force against the JAX package.

The backward kernels (K7, ``csrc/force_grad.cu``) run only on a card;
chip_smoke.py holds them to the plain versions there. On the CPU the
backward runs the plain closed form ``bwd_sweeps_ref``, which these tests
hold to the JAX package's ``bwd_sweeps`` and ``jax.grad`` with its Pallas
kernels in interpret mode (exact reciprocal), as its own tests run them.

Tolerances:
- the pair law (``pair_terms``, ``u_terms``) is the same IEEE operations in
  the same order, eagerly in both packages: bitwise, except where XLA on
  the CPU flushes a subnormal intermediate to zero and torch does not;
- the sweeps sum the same terms in another order (and XLA may contract
  ``dx·gx + dy·gy`` into an FMA inside the interpret kernel): |Δ| ≤ 1e-5 ·
  Σ|term| per output element;
- whole gradients: 1e-5 in relative norm (2.8e-7 measured on the CPU host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu.ops import allpairs_grad as jag
from nbody_simulation_tpu.ops.allpairs import allpairs_accel as jallpairs
from nbody_simulation_tpu_torch.ops import allpairs_grad as tag
from nbody_simulation_tpu_torch.ops.allpairs import (allpairs_accel,
                                                     allpairs_accel_sym)
from nbody_simulation_tpu_torch.ops.force import direct_accel

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUM_RTOL = 1e-5
GRAD_RTOL = 1e-5
N = 256


def cloud(seed, n=N):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100_000, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 100, n).astype(np.float32)
    return pos, mass


def lattice(seed):
    """16×16 bodies at spacing 100: every pair has dx = 0 or dy = 0 or
    neither, and many pairs of a row or column share |d|."""
    ii, jj = np.meshgrid(np.arange(16), np.arange(16))
    pos = (np.stack([ii.ravel(), jj.ravel()], 1) * 100.0 + 5000.0)
    mass = np.random.default_rng(seed).integers(1, 100, N)
    return pos.astype(np.float32), mass.astype(np.float32)


def cotangent(seed, n=N):
    return np.random.default_rng(seed).normal(0, 1, (n, 2)).astype(np.float32)


def rel_norm(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# -- (a) the pair law on edge inputs ------------------------------------------

EDGES = {
    # dx = 0 with dy ≠ 0 and the reverse: psign(0) = +1.
    "axis": ([0.0, 0.0, -3.0, 0.0], [5.0, -2.0, 0.0, 0.0], 1e-3),
    # d2 exactly equal to softening2: κ = 0, q = ε.
    "tie": ([0.5, -0.5, 0.0, 0.3], [0.0, 0.0, 0.5, 0.4], 0.25),
    "coincident": ([0.0, -0.0], [0.0, 0.0], 1e-3),
    # |d|₁ below FLT_MIN_NORMAL (masked), and a normal one whose s·q and
    # d·ḡ are subnormal.
    "subnormal": ([1e-39, 2e-38, 1e-20, 1e-30], [0.0, 0.0, 1e-20, 0.0], 1e-3),
    # r·r overflows (1e-18), d2 overflows, |d|₁ overflows.
    "huge": ([1e20, 3e38, 1e30, 1e-18], [1e20, 3e38, 0.0, 0.0], 1e-3),
    "nan": ([np.nan, 1.0, np.inf, -np.inf], [0.0, np.nan, 1.0, 0.0], 1e-3),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_pair_law_matches_jax_on_edge_inputs(case):
    dx, dy, eps = EDGES[case]
    dx = np.array(dx, np.float32)
    dy = np.array(dy, np.float32)
    g = cotangent(1, dx.size)
    m = np.full(dx.size, 3.0, np.float32)
    jt = jag._pair_terms(jnp.asarray(dx), jnp.asarray(dy), eps, True)
    want = [*jt, *jag._u_terms(jnp.asarray(dx), jnp.asarray(dy),
                               jnp.asarray(g[:, 0]), jnp.asarray(g[:, 1]),
                               jnp.asarray(m), *jt)]
    tt = tag.pair_terms(torch.tensor(dx), torch.tensor(dy), eps)
    got = [*tt, *tag.u_terms(torch.tensor(dx), torch.tensor(dy),
                             torch.tensor(g[:, 0]), torch.tensor(g[:, 1]),
                             torch.tensor(m), *tt)]
    names = ("s", "q", "r", "kappa", "ux", "uy", "t")
    keep = np.ones(dx.size, bool)
    if case == "subnormal":
        # XLA on the CPU flushes subnormals to zero: the masked pair's s
        # (1e-39) becomes 0 (r = 0 either way), and at |d|₁ = 2e-38 its
        # subnormal t becomes 0, so r²·t is inf·0 = NaN where the port
        # keeps IEEE subnormals, as the reference and the card do, and gets
        # −inf. Non-finite in both; bitwise equal elsewhere.
        keep[:2] = False
        assert not np.isfinite(got[5][1].item())
        assert not np.isfinite(np.asarray(want[5])[1])
    for name, w, t in zip(names, want, got):
        np.testing.assert_array_equal(t.numpy()[keep], np.asarray(w)[keep],
                                      err_msg=name)
    if case in ("axis", "tie"):
        # The ties the closed form exists for: psign(0) = +1 and strict κ.
        assert torch.equal(tag.psign(torch.tensor([0.0, -0.0, -1.0])),
                           torch.tensor([1.0, 1.0, -1.0]))
        assert got[3].numpy()[np.float32(dx * dx + dy * dy) == eps].sum() == 0


# -- (b) the two sweeps against the JAX kernels -------------------------------

def _scale(pos_i, g_i, pos_j, mass_j):
    """Σ|ux|, Σ|uy| per target and per source, and Σ|r·t| per source, in
    float64, for the sum-order tolerance."""
    f = lambda a: torch.tensor(a, dtype=torch.float64)
    pi, gi, pj, mj = f(pos_i), f(g_i), f(pos_j), f(mass_j)
    ux, uy, rt = tag._grad_terms(pi[:, None, 0], pi[:, None, 1],
                                 gi[:, None, 0], gi[:, None, 1],
                                 pj[None, :, 0], pj[None, :, 1],
                                 mj[None, :], 1e-3)
    ux, uy, rt = ux.abs(), uy.abs(), rt.abs()
    return (torch.stack([ux.sum(1), uy.sum(1)], 1).numpy(),
            torch.stack([ux.sum(0), uy.sum(0)], 1).numpy(), rt.sum(0).numpy())


def _close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


@pytest.mark.parametrize("layout", ["same", "other"])
def test_bwd_sweeps_match_jax(layout):
    """``pos_i = pos_j`` (one chip) and ``pos_i ≠ pos_j`` (a ring block, with
    a heavy body among the sources), tiles of 128."""
    pos_i, _ = cloud(2)
    g_i = cotangent(3)
    if layout == "same":
        pos_j, mass_j = pos_i, cloud(2)[1]
    else:
        pos_j, mass_j = cloud(4)
        mass_j[0] = 75_000_000.0
    want = jag.bwd_sweeps(*(jnp.asarray(a) for a in (pos_i, g_i, pos_j,
                                                     mass_j)),
                          1e-3, 128, 128)
    got = tag.bwd_sweeps(*(torch.tensor(a) for a in (pos_i, g_i, pos_j,
                                                     mass_j)),
                         1e-3, 128, 128)
    for w, t, sc in zip(want, got, _scale(pos_i, g_i, pos_j, mass_j)):
        assert t.shape == w.shape and t.dtype == torch.float32
        _close_in_sum(t.numpy(), np.asarray(w), sc)


# -- (c) whole gradients against jax.grad -------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of Σ a·cot through the JAX ``allpairs_accel_diff`` (tiles
    128, symmetric tile 128), per scene and ``sym``."""
    out = {}
    for scene, make in (("cloud", cloud), ("lattice", lattice)):
        pos, mass = make(5)
        cot = cotangent(6)
        for sym in (False, True):
            def loss(p, m):
                return jnp.sum(jag.allpairs_accel_diff(
                    p, m, 1e-3, 128, 128, "newton", sym, 128, 4) * cot)
            out[scene, sym] = (pos, mass, cot, jax.grad(loss, (0, 1))(
                jnp.asarray(pos), jnp.asarray(mass)))
    return out


def _port_grads(pos, mass, cot, **kw):
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    a = tag.allpairs_accel_diff(p, m, 1e-3, 128, 128, **kw)
    (a * torch.tensor(cot)).sum().backward()
    return a.detach(), p.grad, m.grad


@pytest.mark.parametrize("scene", ["cloud", "lattice"])
@pytest.mark.parametrize("sym", [False, True])
def test_gradients_match_jax(jax_grads, scene, sym):
    pos, mass, cot, (gp, gm) = jax_grads[scene, sym]
    a, p_bar, m_bar = _port_grads(pos, mass, cot, rcp="newton", sym=sym,
                                  sym_tile=128)
    assert rel_norm(p_bar, gp) < GRAD_RTOL
    assert rel_norm(m_bar, gm) < GRAD_RTOL
    # The forward is the run mode's kernel, bitwise.
    if sym:
        run = allpairs_accel_sym(torch.tensor(pos), torch.tensor(mass),
                                 tile=128)
    else:
        run = allpairs_accel(torch.tensor(pos), torch.tensor(mass),
                             tile_i=128, tile_j=128)
    assert torch.equal(a, run)


def test_lattice_is_where_autograd_of_the_plain_forward_fails(jax_grads):
    """Torch autograd through the plain law takes |x|' = 0 at x = 0 where
    the JAX package takes +1: on the lattice its position gradient is far
    from the reference's (0.32 in relative norm), which is why the port's
    backward is the closed form."""
    pos, mass, cot, (gp, _) = jax_grads["lattice", False]
    p = torch.tensor(pos, requires_grad=True)
    (direct_accel(p, torch.tensor(mass)) * torch.tensor(cot)).sum().backward()
    assert rel_norm(p.grad, gp) > 0.1


def test_forward_matches_jax_run_mode():
    pos, mass = cloud(7)
    want = np.asarray(jallpairs(jnp.asarray(pos), jnp.asarray(mass),
                                tile_i=128, tile_j=128, interpret=True))
    got = tag.allpairs_accel_diff(torch.tensor(pos), torch.tensor(mass),
                                  1e-3, 128, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# -- (f) against torch autograd of direct_accel, on a random cloud ------------

def test_gradients_match_autograd_of_direct_sum_on_a_cloud():
    """Off the kinks the closed form is the derivative: torch autograd of
    ``direct_accel`` agrees (relative norm 1e-4 for positions, rtol 1e-3
    for masses, the JAX package's own bounds for this check)."""
    pos, mass = cloud(8)
    cot = torch.tensor(cotangent(9))
    _, p_bar, m_bar = _port_grads(pos, mass, cot.numpy())
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    (direct_accel(p, m) * cot).sum().backward()
    assert rel_norm(p_bar, p.grad) < 1e-4
    np.testing.assert_allclose(m_bar.numpy(), m.grad.numpy(), rtol=1e-3,
                               atol=1e-10)


# -- (g) what the wrappers refuse ---------------------------------------------

def test_only_cuda_tensors_reach_the_kernels():
    pos, mass = (torch.tensor(a) for a in cloud(10, 128))
    g = torch.tensor(cotangent(11, 128))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tag.bwd_i_cuda(pos, g, pos, mass)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tag.bwd_j_cuda(pos, g, pos, mass)
    meta = [t.to("meta") for t in (pos, g, pos, mass)]
    with pytest.raises(ValueError, match="device meta"):
        tag.bwd_sweeps(*meta, 1e-3, 128, 128)
    with pytest.raises(ValueError, match="not divisible"):
        tag.bwd_sweeps(pos[:100], g[:100], pos, mass, 1e-3, 64, 128)
    assert tag.bwd_i_cuda.launches == 0 and tag.bwd_j_cuda.launches == 0
