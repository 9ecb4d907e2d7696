"""The port's raster: pixel-exact against the sequential oracle (reference
src/main.rs:41-72) and the JAX package's raster, on both tint branches."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.ops import raster as jraster
from nbody_simulation_tpu.oracle import draw_oracle
from nbody_simulation_tpu_torch.ops import raster as traster

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _cloud(seed, n=2500, nan_vel=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1000, 101_000, (n, 2)).astype(np.float32)  # some OOB
    pos[:50] = pos[50]            # a crowded pixel: α saturates
    pos[60] = [np.nan, 100.0]     # NaN fails the bounds test
    pos[61] = [99_999.99, 0.0]    # the last in-bounds pixel column
    pos[62] = [100_000.0, 5.0]    # just outside
    vel = rng.normal(0, 20, (n, 2)).astype(np.float32)
    if nan_vel:  # (the oracle's tint cast cannot take NaN)
        vel[70] = [np.nan, 1.0]   # NaN speed tints as 0
    vel[71] = [1e6, 1e6]          # saturating speed
    mass = rng.integers(1, 30, n).astype(np.float32)  # heavy and light
    return pos, vel, mass


@pytest.mark.parametrize("pack_tint", [True, False])
@pytest.mark.parametrize("render_size", [1250, 250])
def test_frame_pixel_exact(pack_tint, render_size):
    pos, vel, mass = _cloud(render_size, nan_vel=False)
    kw = dict(world_size=100_000.0, render_size=render_size,
              heavy_weight=10.0)
    want = draw_oracle(pos, vel, mass, **kw)
    green, count, _, vlast = traster.accumulate_pixels(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(mass),
        pack_tint=pack_tint, **kw)
    got = traster.colorize_pixels(green, count, vlast, render_size).numpy()
    np.testing.assert_array_equal(got, want)
    if pack_tint:  # the default for N < 2²²
        np.testing.assert_array_equal(traster.render_frame(
            torch.from_numpy(pos), torch.from_numpy(vel),
            torch.from_numpy(mass), **kw).numpy(), want)
    green, count, _, vlast = jraster.accumulate_pixels(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        pack_tint=pack_tint, **kw)
    jframe = np.asarray(jraster.colorize_pixels(green, count, vlast,
                                                render_size))
    np.testing.assert_array_equal(got, jframe)


@pytest.mark.parametrize("pack_tint", [True, False])
def test_pixel_reductions_match_jax(pack_tint):
    pos, vel, mass = _cloud(1)
    kw = dict(world_size=100_000.0, render_size=1250, heavy_weight=10.0,
              pack_tint=pack_tint)
    want = jraster.accumulate_pixels(jnp.asarray(pos), jnp.asarray(vel),
                                     jnp.asarray(mass), **kw)
    got = traster.accumulate_pixels(torch.from_numpy(pos),
                                    torch.from_numpy(vel),
                                    torch.from_numpy(mass), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sparse_frame_reconstructs_dense():
    pos, vel, mass = _cloud(2)
    t = [torch.from_numpy(a) for a in (pos, vel, mass)]
    dense = traster.render_frame(*t).numpy()
    idx, vals = traster.render_frame_sparse(*t, cap=4096)
    assert idx.dtype == torch.int32 and idx.shape == (4096,)
    np.testing.assert_array_equal(traster.sparse_to_frame(idx, vals), dense)
    jidx, jvals = jraster.render_frame_sparse(
        *(jnp.asarray(a) for a in (pos, vel, mass)), cap=4096)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  np.asarray(jvals))


def test_sparse_cap_truncates_in_pixel_order():
    pos, vel, mass = _cloud(3)
    t = [torch.from_numpy(a) for a in (pos, vel, mass)]
    idx, _ = traster.render_frame_sparse(*t, cap=100)
    full, _ = traster.render_frame_sparse(*t, cap=8192)
    assert torch.equal(idx, full[:100])


def test_pack_tint_refuses_large_n():
    n = 1 << 22
    z = torch.zeros(n, 2)
    with pytest.raises(ValueError, match="pack_tint"):
        traster.accumulate_pixels(z, z, torch.ones(n), 1e5, 10, 10.0,
                                  pack_tint=True)
