"""Collective repartition: the global Morton sort on the device.

The port of ``nbody_simulation_tpu/parallel/repartition.py``.
``bh_distributed.rebalance_state`` takes the whole state through the
host; this is the same re-partition with O(N/P) work per shard and no
host, bitwise ``rebalance_state``'s result (tests/test_torch_repartition.py,
chip_smoke.py). Two phases over P shards of L rows:

1. **Merge-split sort.** Each shard sorts its rows by the key triple
   (Morton hi, Morton lo, gid), gid the row's global index before the sort.
   Then P rounds of block odd-even transposition: in round r shards (i,
   i+1) with i ≡ r (mod 2) swap their blocks (``ppermute_pairs``), each
   sorts the 2L merged rows and keeps the lower (left shard) or upper half.
   P rounds sort any input. gid breaks key ties in the order a stable host
   sort sees them; padding carries ``PAD_KEY`` and sinks to the end.
2. **Even spread.** The n sorted live rows are cut into P runs of
   ceil(n/P): shard d takes global ranks [d·per, (d+1)·per) into its first
   slots, padding after, the layout of ``distribute_state``. The blocks
   travel once around the ring and each shard copies the ranks it wants.
"""

from __future__ import annotations

import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.morton import morton_keys
from nbody_simulation_tpu_torch.parallel.mesh import (Mesh, ppermute_blocks,
                                                      split_shards)
from nbody_simulation_tpu_torch.state import PAD_POS, ParticleState


def _sort_rows(key: torch.Tensor, gid: torch.Tensor, cols):
    """Rows ordered by (key, gid), both unique together: a stable sort by
    gid, then a stable sort by key."""
    order = torch.sort(gid, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    return key[order], gid[order], [c[order] for c in cols]


def _merge_split_sort(mesh: Mesh, blocks):
    """Phase 1 on the local shards' ``blocks``, each ``[key, gid, *cols]``
    sorted by (key, gid): returns them sorted globally."""
    n_dev = mesh.n_shards
    L = blocks[0][0].shape[0]
    for r in range(n_dev):
        pairs = []
        for i in range(r % 2, n_dev - 1, 2):
            pairs += [(i, i + 1), (i + 1, i)]
        if not pairs:
            continue
        recv = ppermute_blocks(mesh, blocks, pairs)
        out = []
        for my, mine, theirs in zip(mesh.shard_ids, blocks, recv):
            direction = 1 if my % 2 == r % 2 else -1
            if not 0 <= my + direction < n_dev:
                out.append(mine)
                continue
            key, gid, cols = _sort_rows(
                torch.cat([mine[0], theirs[0]]),
                torch.cat([mine[1], theirs[1]]),
                [torch.cat([a, b]) for a, b in zip(mine[2:], theirs[2:])])
            half = slice(0, L) if direction > 0 else slice(L, 2 * L)
            out.append([key[half], gid[half]] + [c[half] for c in cols])
        blocks = out
    return blocks


def _even_spread(mesh: Mesh, cols, fills):
    """Phase 2: the globally sorted local ``cols`` (one list per local
    shard, live rows first, column 4 the mass) re-cut into P equal
    live-first runs."""
    n_dev = mesh.n_shards
    L = cols[0][0].shape[0]
    dev = cols[0][0].device
    n = mesh.psum(torch.stack([(c[4] > 0).sum(dtype=torch.int64)
                               for c in cols]))
    per = (n + n_dev - 1) // n_dev
    j = torch.arange(L, device=dev)
    back = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    outs = [[torch.full_like(c, f) for c, f in zip(cs, fills)]
            for cs in cols]
    block = cols
    for s in range(n_dev):
        if s > 0:
            block = ppermute_blocks(mesh, block, back)
        for k, my in enumerate(mesh.shard_ids):
            src = (my + s) % n_dev
            r = my * per + j
            want = (j < per) & (r < n) & (r // L == src)
            idx = torch.clamp(r - src * L, 0, L - 1)
            outs[k] = [torch.where(want, b[idx], o)
                       for b, o in zip(block[k], outs[k])]
    return outs


def make_collective_rebalance(mesh: Mesh, config: SimConfig):
    """``fn(state) -> state``: the collective repartition of a distributed
    state on ``mesh``, with the same padded shapes in and out; bitwise
    ``rebalance_state`` whenever that keeps the local size (a state in the
    ``distribute_state`` layout for this mesh and count)."""
    mbits = config.resolved_morton_bits()

    def rebalance(state: ParticleState) -> ParticleState:
        with torch.no_grad():
            blocks = []
            for my, p, v, m in zip(mesh.shard_ids,
                                   split_shards(mesh, state.pos),
                                   split_shards(mesh, state.vel),
                                   split_shards(mesh, state.mass)):
                L = p.shape[0]
                hi, lo = morton_keys(p, m, config.world_size, bits=mbits)
                # (hi, lo) in one int64: both words are non-negative and
                # below 2^31.
                key = hi.to(torch.int64) * (1 << 31) + lo.to(torch.int64)
                gid = my * L + torch.arange(L, device=p.device)
                key, gid, cols = _sort_rows(
                    key, gid, [p[:, 0], p[:, 1], v[:, 0], v[:, 1], m])
                blocks.append([key, gid] + cols)
            blocks = _merge_split_sort(mesh, blocks)
            outs = _even_spread(mesh, [b[2:] for b in blocks],
                                (PAD_POS, PAD_POS, 0.0, 0.0, 0.0))
            pos = torch.cat([torch.stack(o[:2], 1) for o in outs])
            vel = torch.cat([torch.stack(o[2:4], 1) for o in outs])
            mass = torch.cat([o[4] for o in outs])
        return state.replace(pos=pos, vel=vel, mass=mass)

    return rebalance


def collective_rebalance(state: ParticleState, mesh: Mesh,
                         config: SimConfig) -> ParticleState:
    """One call of ``make_collective_rebalance(mesh, config)``."""
    return make_collective_rebalance(mesh, config)(state)
