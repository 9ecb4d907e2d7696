"""The port's collective repartition against the host rebalance and JAX.

``collective_rebalance`` only moves rows (no arithmetic touches them), so
it is held bitwise: to the port's host ``rebalance_state``, and to the JAX
package's ``rebalance_state`` of the same arrays (host numpy, no compile).
The states drift by a few port steps first, so that shards hold rows out
of their Morton run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu import parallel as jpar
from nbody_simulation_tpu.config import SimConfig as JSimConfig
from nbody_simulation_tpu.state import ParticleState as JState
from nbody_simulation_tpu_torch import parallel as par
from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.models.scenarios import plummer, uniform_disc
from nbody_simulation_tpu_torch.ops.morton import morton_keys
from nbody_simulation_tpu_torch.parallel.mesh import LocalMesh
from nbody_simulation_tpu_torch.parallel.repartition import (
    make_collective_rebalance)

torch.set_num_threads(min(2, torch.get_num_threads()))


def drifted(st, p, kw, steps=2):
    mesh = LocalMesh(p, "cpu")
    cfg = SimConfig(force_path="bh", **kw)
    ds = par.distribute_state(st, mesh, cfg)
    step = par.make_distributed_bh_step(mesh, cfg)
    for _ in range(steps):
        ds = step(ds)
    return ds, mesh, cfg


@pytest.mark.parametrize("p,n,scene,kw", [
    (2, 700, "plummer", dict(leaf_size=16, morton_bits=15)),
    (4, 2048, "plummer", dict(leaf_size=16, morton_bits=15)),  # key ties
    (6, 1500, "uniform", dict(leaf_size=16)),                  # P not 2^k
    (8, 8 * 300, "uniform", dict(leaf_size=16, morton_bits=24)),  # 2 words
])
def test_collective_matches_host_and_jax_bitwise(p, n, scene, kw):
    st = (plummer if scene == "plummer" else uniform_disc)(n, seed=p)
    ds, mesh, cfg = drifted(st, p, kw)
    host = par.rebalance_state(ds, mesh, cfg)
    got = par.collective_rebalance(ds, mesh, cfg)
    jds = JState(jnp.asarray(ds.pos.numpy()), jnp.asarray(ds.vel.numpy()),
                 jnp.asarray(ds.mass.numpy()), n_real=ds.n_real,
                 distributed=True)
    want = jpar.rebalance_state(jds, jpar.make_1d_mesh(p),
                                JSimConfig(force_path="bh", **kw))
    assert got.pos.shape == ds.pos.shape and got.distributed
    for k in ("pos", "vel", "mass"):
        assert torch.equal(getattr(got, k), getattr(host, k)), k
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))


def test_layout_invariants_and_reuse():
    """Each shard real-first with ceil(n/P) live rows but the last; live
    rows globally Morton-nondecreasing; one ``make_collective_rebalance``
    serves repeated calls, and a balanced state comes back unchanged."""
    n = 8 * 300
    ds, mesh, cfg = drifted(uniform_disc(n, seed=22), 8, dict(leaf_size=16))
    fn = make_collective_rebalance(mesh, cfg)
    out = fn(ds)
    mass = out.mass.numpy()
    L, per = out.n // 8, -(-n // 8)
    for d in range(8):
        m = mass[d * L:(d + 1) * L]
        k = int((m > 0).sum())
        assert k == min(per, max(0, n - d * per))
        assert (m[:k] > 0).all() and (m[k:] == 0).all()
    live = out.mass > 0
    hi, lo = morton_keys(out.pos[live], out.mass[live], cfg.world_size,
                         bits=cfg.resolved_morton_bits())
    key = hi.long() * (1 << 31) + lo.long()
    assert bool((key[1:] >= key[:-1]).all())
    again = fn(out)
    for k in ("pos", "vel", "mass"):
        assert torch.equal(getattr(again, k), getattr(out, k))
