"""The port's Morton sort and tree summaries against the JAX package.

Keys and permutations are integer work: identical. Level masses, counts and
AABBs are exact (int32 sums, min/max); only the leaf COM sums f32 positions,
whose reduction order differs, so COMs agree to rtol 1e-6 (64-term sums of
~5e4 positions round to ~1e-7 relative; internal COMs combine two children
exactly as the JAX package does).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.ops import morton as jmorton
from nbody_simulation_tpu.ops import tree as jtree
from nbody_simulation_tpu_torch.ops import morton as tmorton
from nbody_simulation_tpu_torch.ops import tree as ttree

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _cloud(seed, n=3000, n_pad=70):
    """Clustered positions (equal keys exercise stability), varied masses,
    zero-mass padding mixed in."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(5e4, 8e3, (n, 2)).astype(np.float32)
    pos[:200] = pos[0] + rng.uniform(0, 1, (200, 2)).astype(np.float32)
    pos[200:210] = [-5.0, 2e5]  # outside the world: clamped keys
    mass = rng.integers(1, 30, n).astype(np.float32)
    mass[rng.choice(n, n_pad, replace=False)] = 0.0
    return pos, mass


@pytest.mark.parametrize("bits", [15, 24])
def test_morton_order_identical(bits):
    pos, mass = _cloud(bits)
    jhi, jlo = jmorton.morton_keys(jnp.asarray(pos), jnp.asarray(mass),
                                   1e5, bits)
    thi, tlo = tmorton.morton_keys(torch.from_numpy(pos),
                                   torch.from_numpy(mass), 1e5, bits)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    want = np.asarray(jmorton.morton_order(jnp.asarray(pos),
                                           jnp.asarray(mass), 1e5, bits))
    got = tmorton.morton_order(torch.from_numpy(pos), torch.from_numpy(mass),
                               1e5, bits)
    assert torch.equal(got, torch.from_numpy(want.astype(np.int64)))


@pytest.mark.parametrize("bits", [15, 24])
def test_morton_sort_state_identical(bits):
    pos, mass = _cloud(bits + 1)
    vel = np.random.default_rng(0).normal(0, 1, pos.shape).astype(np.float32)
    want = jmorton.morton_sort_state(jnp.asarray(pos), jnp.asarray(vel),
                                     jnp.asarray(mass), 1e5, bits)
    got = tmorton.morton_sort_state(torch.from_numpy(pos),
                                    torch.from_numpy(vel),
                                    torch.from_numpy(mass), 1e5, bits)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("unweighted", [True, False])
@pytest.mark.parametrize("leaf_size", [64, 16])
def test_summaries_match(unweighted, leaf_size):
    pos, mass = _cloud(7)
    order = np.asarray(jmorton.morton_order(jnp.asarray(pos),
                                            jnp.asarray(mass), 1e5))
    spos, smass = pos[order], mass[order]
    jt = jtree.summarize_sorted(jnp.asarray(spos), jnp.asarray(smass),
                                leaf_size=leaf_size,
                                unweighted_leaf_com=unweighted)
    tt = ttree.summarize_sorted(torch.from_numpy(spos),
                                torch.from_numpy(smass), leaf_size=leaf_size,
                                unweighted_leaf_com=unweighted)
    assert tt.depth == jt.depth
    np.testing.assert_array_equal(tt.leaf_pos.numpy(), np.asarray(jt.leaf_pos))
    np.testing.assert_array_equal(tt.leaf_mass.numpy(),
                                  np.asarray(jt.leaf_mass))
    for lt, lj in zip(tt.levels, jt.levels):
        np.testing.assert_array_equal(lt.mass_i.numpy(), np.asarray(lj.mass_i))
        np.testing.assert_array_equal(lt.count.numpy(), np.asarray(lj.count))
        np.testing.assert_array_equal(lt.aabb_min.numpy(),
                                      np.asarray(lj.aabb_min))
        np.testing.assert_array_equal(lt.aabb_max.numpy(),
                                      np.asarray(lj.aabb_max))
        np.testing.assert_allclose(lt.com.numpy(), np.asarray(lj.com),
                                   rtol=1e-6)
    np.testing.assert_allclose(tt.levels[-1].packed.numpy(),
                               np.asarray(jt.levels[-1].packed), rtol=1e-6)


def test_build_tree_order_and_tree_round_trip():
    pos, mass = _cloud(9)
    jt, jorder = jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass))
    tt, torder = ttree.build_tree(torch.from_numpy(pos),
                                  torch.from_numpy(mass))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    conv = ttree.tree_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in jt.levels],
        np.asarray(jt.leaf_pos), np.asarray(jt.leaf_mass))
    levels, leaf_pos, leaf_mass = ttree.tree_to_numpy(conv)
    assert len(levels) == len(jt.levels)
    for got, lvl in zip(levels, jt.levels):
        for a, b in zip(got, lvl[:5]):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(leaf_pos, np.asarray(jt.leaf_pos))
    np.testing.assert_array_equal(leaf_mass, np.asarray(jt.leaf_mass))


def test_morton_bits_out_of_range_raise():
    with pytest.raises(ValueError):
        tmorton.morton_keys(torch.zeros(4, 2), torch.ones(4), 1e5, bits=25)
