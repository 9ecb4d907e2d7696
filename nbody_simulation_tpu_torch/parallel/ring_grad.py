"""The differentiable ring all-pairs force.

The port of ``nbody_simulation_tpu/parallel/ring_grad.py``. The forward is
``ring_allpairs_accel`` with the caller's ``rcp`` and ``sym``, so the
grad-mode value is bitwise the run mode's. The backward is the JAX
package's P-hop cotangent circuit: for every pair block (local targets i,
visiting sources j) the backward sweeps (``ops.allpairs_grad.bwd_sweeps``:
K7a and K7b on a card) give p̄_i, which stays on the shard, and p̄_j, m̄_j,
which belong to the sources' owner. So those accumulators travel with the
visiting block, each shard adds its targets' share, and after P−1 hops a
closing hop brings every shard its own sources' cotangents.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from nbody_simulation_tpu_torch.ops.allpairs_grad import bwd_sweeps
from nbody_simulation_tpu_torch.parallel.mesh import Mesh, map_shards
from nbody_simulation_tpu_torch.parallel.ring import ring_allpairs_accel


class _RingAllpairsAccelDiff(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pos, mass, mesh, softening2, tile_i, tile_j, rcp, sym,
                sym_tile):
        ctx.save_for_backward(pos, mass)
        ctx.args = (mesh, softening2, tile_i, tile_j)
        return ring_allpairs_accel(pos, mass, mesh, softening2=softening2,
                                   tile_i=tile_i, tile_j=tile_j, rcp=rcp,
                                   sym=sym, sym_tile=sym_tile)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pos, mass = ctx.saved_tensors
        mesh, softening2, tile_i, tile_j = ctx.args
        g = g.to(torch.float32).contiguous()

        def sweeps(p, gg, vp, vm):
            return bwd_sweeps(p, gg, vp, vm, softening2, tile_i, tile_j)

        pb_i = torch.zeros_like(pos)
        vis_pos, vis_mass = pos, mass
        vis_pb = torch.zeros_like(pos)
        vis_mb = torch.zeros_like(mass)
        for k in range(mesh.n_shards):
            if k > 0:
                vis_pos = mesh.ppermute(vis_pos, 1)
                vis_mass = mesh.ppermute(vis_mass, 1)
                vis_pb = mesh.ppermute(vis_pb, 1)
                vis_mb = mesh.ppermute(vis_mb, 1)
            d_pi, d_pj, d_mj = map_shards(mesh, sweeps, pos, g, vis_pos,
                                          vis_mass)
            pb_i = pb_i + d_pi
            vis_pb = vis_pb + d_pj
            vis_mb = vis_mb + d_mj
        # After P−1 hops the accumulator of shard d's block sits on shard
        # d−1; one more hop completes the circuit.
        vis_pb = mesh.ppermute(vis_pb, 1)
        vis_mb = mesh.ppermute(vis_mb, 1)
        return (pb_i + vis_pb, vis_mb, None, None, None, None, None, None,
                None)


def ring_allpairs_accel_diff(pos: torch.Tensor, mass: torch.Tensor,
                             mesh: Mesh, softening2: float = 1e-3,
                             tile_i: int = 512, tile_j: int = 2048,
                             rcp: str = "newton", sym: bool = True,
                             sym_tile: int = 1024) -> torch.Tensor:
    """Differentiable sharded all-pairs acceleration f32[S·L, 2] of the
    mesh's local shards (``pos`` f32[S·L, 2], ``mass`` f32[S·L]). The
    backward evaluates the closed-form Jᵀḡ with its own reciprocal whatever
    ``rcp`` says (the mode selects forward arithmetic, not the function)."""
    return _RingAllpairsAccelDiff.apply(pos, mass, mesh, softening2, tile_i,
                                        tile_j, rcp, sym, sym_tile)
