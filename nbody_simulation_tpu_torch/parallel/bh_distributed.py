"""Fully distributed Barnes-Hut: no shard holds the whole system.

The port of ``nbody_simulation_tpu/parallel/bh_distributed.py``, where the
design is set out. In short:

- **Ownership.** ``distribute_state`` sorts the system once in global
  Morton order on the host and gives shard d the d-th contiguous run of
  ceil(N/P) particles, padded to a power-of-two leaf count. Each step a
  shard re-sorts only its own rows; a stale global order loosens the
  shards' boxes and the conservative walk opens more, so the physics is
  unchanged (``rebalance_state`` and ``parallel.repartition`` renew it).
- **Local subtree.** Each shard builds the flat tree of its own rows.
- **Stages.** In ``far_mode="ring"`` the subtrees travel P−1 hops around
  the ring, and every shard plans and sweeps its rows against each. In the
  default forest mode a shard walks its own subtree, its two ring
  neighbours' as near stages, seam stages for the shards the
  ``adjacency_stages`` matchings pair it with (θ<2), and everything else in
  one bounded walk over a coarse forest of every shard's top levels
  (``_gather_forest``).
- **Compute to data.** A near stage at θ≥2 ships only the visiting
  subtree's top levels; the rows still open at the cut travel back to the
  subtree's owner, which finishes their walk against its own tree and
  returns their accelerations. The same arrays feed the same seeded walk,
  so this is bitwise the same-device form (``near_remote=False``).

The functions are written once against the mesh interface
(``parallel.mesh``): every shard's work is a loop over the local shards
(all P of a ``LocalMesh``, the rank's one on a ``ProcessGroupMesh``) and
the exchanges are ``ppermute_blocks`` and ``all_gather_blocks``. Every
sweep is ``grouped_force`` (the CUDA kernel K3, or K4 at ``multipole=2``,
on a card), bounded per group at its last live column, which is bitwise
the full sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nbody_simulation_tpu_torch.config import SimConfig
from nbody_simulation_tpu_torch.ops.energy import bh_potential_from_columns
from nbody_simulation_tpu_torch.ops.integrate import euler_step, leapfrog_step
from nbody_simulation_tpu_torch.ops.morton import (morton_keys,
                                                   morton_sort_state)
from nbody_simulation_tpu_torch.ops.traversal import (_group_node_d2, _rows,
                                                      grouped_force,
                                                      last_nonzero_columns,
                                                      plan_rows)
from nbody_simulation_tpu_torch.ops.tree import (EMPTY_POS, FlatTree, Level,
                                                 _combine, summarize_sorted)
from nbody_simulation_tpu_torch.parallel.mesh import (Mesh,
                                                      all_gather_blocks,
                                                      map_shards,
                                                      ppermute_blocks,
                                                      split_shards)
from nbody_simulation_tpu_torch.state import PAD_POS, ParticleState

# Leaves per planning row of the non-local stages, the JAX package's.
NEAR_ROW_LEAVES = 8     # near stages at θ≥2 (S = 512 at 64-particle leaves)
FOREST_ROW_LEAVES = 32  # the forest walk (S = 2048)


def distribute_state(state: ParticleState, mesh: Mesh, config: SimConfig
                     ) -> ParticleState:
    """Sort the system (all of it, in ``state``) in global Morton order on
    the host and give each shard an equal contiguous run of ceil(N/P) live
    particles, padded per shard to L = (next power of two of the leaf
    count) × ``leaf_size`` slots with particles of mass 0 at ``PAD_POS``.
    The padding is interleaved per shard, so ``n_real`` covers the whole
    layout and the state is flagged ``distributed``. The mesh's local shards
    are placed on its device."""
    n_dev = mesh.n_shards
    n = state.n_real
    pos = state.pos[:n].detach().cpu()
    mass = state.mass[:n].detach().cpu()
    hi, lo = morton_keys(pos, mass, config.world_size,
                         bits=config.resolved_morton_bits())
    order = np.lexsort((lo.numpy(), hi.numpy()))
    pos = pos.numpy()[order]
    vel = state.vel[:n].detach().cpu().numpy()[order]
    mass = mass.numpy()[order]

    per_dev = -(-n // n_dev)
    leaves = -(-per_dev // config.leaf_size)
    leaves = 1 << max(0, (leaves - 1).bit_length())
    local = max(leaves * config.leaf_size, config.leaf_size)

    def chunk(a, fill=0.0):
        out = np.full((n_dev * local,) + a.shape[1:], fill, np.float32)
        for d in range(n_dev):
            src = a[d * per_dev:(d + 1) * per_dev]
            out[d * local:d * local + len(src)] = src
        return mesh.local_rows(torch.as_tensor(out, device=mesh.device))

    return ParticleState(chunk(pos, PAD_POS), chunk(vel), chunk(mass),
                         n_real=n_dev * local, distributed=True)


def live_rows(state: ParticleState, mesh: Mesh) -> ParticleState:
    """The live rows of every shard of a distributed state, in global order
    (the same on every rank)."""
    return ParticleState(mesh.all_gather(state.pos),
                         mesh.all_gather(state.vel),
                         mesh.all_gather(state.mass)).compact()


def rebalance_state(state: ParticleState, mesh: Mesh, config: SimConfig
                    ) -> ParticleState:
    """Re-partition a drifted distributed state on the host: its live rows
    (the padding dropped, so rebalances do not add padding) through
    ``distribute_state``. ``parallel.repartition.collective_rebalance`` does
    the same on the device, bitwise."""
    return distribute_state(live_rows(state, mesh), mesh, config)


def shard_cut_aabbs(state: ParticleState, mesh: Mesh, config: SimConfig):
    """Per-shard boxes of the ``2^(forest_levels-1)`` equal slot ranges
    (the leaf ranges of the forest's deepest gathered level), zero-mass
    rows left out and an empty range at (3e38, −3e38): (mins, maxs) of
    (P, W, 2) as numpy."""
    W = 1 << max(0, config.forest_levels - 1)
    big = 3.0e38

    def local(pos_l, mass_l):
        L = pos_l.shape[0]
        w = W
        while L % w or w > L:
            w //= 2
        seg = pos_l.reshape(w, L // w, 2)
        m = (mass_l.reshape(w, L // w) > 0)[..., None]
        fill = torch.full((), big, dtype=pos_l.dtype, device=pos_l.device)
        return (torch.where(m, seg, fill).amin(dim=1),
                torch.where(m, seg, -fill).amax(dim=1))

    with torch.no_grad():
        mn, mx = map_shards(mesh, local, state.pos, state.mass)
        p = mesh.n_shards
        return (mesh.all_gather(mn).reshape(p, -1, 2).cpu().numpy(),
                mesh.all_gather(mx).reshape(p, -1, 2).cpu().numpy())


def adjacency_stages(state: ParticleState, mesh: Mesh, config: SimConfig):
    """Seam near stages: matchings of (src, dst) pairs that cover every
    pair of shards that the forest's cut cannot θ-accept.

    For each ordered pair (dest a, source b), off the ring neighbours, every
    nonempty cut node v of b must be strictly disjoint from shard a's box
    and satisfy 2·size(v) < θ_eff·gap(v, box a), with θ_eff = θ/2 under the
    quadrupole (the 2 is drift margin between rebalances). Pairs that fail,
    the Morton seams, get a full near stage. Host numpy on the small cut
    boxes, as in the JAX package; the edges are colored greedily into
    matchings, each pair in both directions. Returns a tuple of tuples of
    pairs (empty below 4 shards)."""
    n_dev = mesh.n_shards
    if n_dev < 4:
        return ()
    mn, mx = shard_cut_aabbs(state, mesh, config)
    empty = mn[..., 0] > mx[..., 0]
    size = np.where(empty[..., None], 0.0, mx - mn).max(-1)     # (P, W)
    smin = np.where(empty[..., None], np.float32(3e38), mn)
    smax = np.where(empty[..., None], np.float32(-3e38), mx)
    amin = smin.min(axis=1)                                     # (P, 2)
    amax = smax.max(axis=1)
    theta_eff = config.theta * (
        0.5 if config.resolved_multipole() == 2 else 1.0)
    edges = set()
    for a in range(n_dev):
        for b in range(n_dev):
            if b in (a, (a + 1) % n_dev, (a - 1) % n_dev):
                continue
            gap = np.sqrt((np.maximum(
                0.0, np.maximum(mn[b] - amax[a], amin[a] - mx[b])) ** 2
            ).sum(-1))                                          # (W,)
            ok = empty[b] | ((gap > 0) & (2.0 * size[b] < theta_eff * gap))
            if not ok.all():
                edges.add((min(a, b), max(a, b)))
    matchings: list[list[tuple[int, int]]] = []
    used: list[set[int]] = []
    for a, b in sorted(edges):
        for m, u in zip(matchings, used):
            if a not in u and b not in u:
                m += [(a, b), (b, a)]
                u |= {a, b}
                break
        else:
            matchings.append([(a, b), (b, a)])
            used.append({a, b})
    return tuple(tuple(m) for m in matchings)


def resolved_seam_stages(config: SimConfig) -> bool:
    """Whether forest mode schedules seam stages: below θ=2, where flushes
    at the cut would break the 1e-3 error budget."""
    return config.theta < 2.0


def _stage_caps(config: SimConfig, dist: int, n_dev: int):
    """(frontier, leaf) caps for a visiting subtree at folded ring distance
    ``dist``: full caps for the neighbours (and at P ≤ 4), the far caps
    (default caps/4 and caps/8) beyond."""
    fcap, lcap = config.resolved_caps()
    if dist <= 1 or n_dev <= 4:
        return fcap, lcap
    ff = config.far_frontier_cap or max(4, fcap // 4)
    fl = config.far_leaf_cap or max(2, lcap // 8)
    return min(fcap, ff), min(lcap, fl)


# -- trees across the mesh -----------------------------------------------------

def _tree_parts(tree: FlatTree) -> list:
    parts = []
    for lv in tree.levels:
        parts += [lv.aabb_min, lv.aabb_max, lv.com, lv.mass_i, lv.count]
        if lv.quad is not None:
            parts.append(lv.quad)
    return parts + [tree.leaf_pos, tree.leaf_mass]


def _tree_from_parts(parts: list, quad: bool) -> FlatTree:
    k = 6 if quad else 5
    n_levels = (len(parts) - 2) // k
    levels = [Level(*parts[i * k:i * k + 5],
                    quad=parts[i * k + 5] if quad else None)
              for i in range(n_levels)]
    return FlatTree(levels=levels, leaf_pos=parts[-2], leaf_mass=parts[-1])


def _permute_trees(mesh: Mesh, trees: list, pairs) -> list:
    """``ppermute_pairs`` of the local shards' trees (a shard that no pair
    sends to gets an all-zero tree: nothing opens, nothing pulls)."""
    quad = trees[0].levels[0].quad is not None
    moved = ppermute_blocks(mesh, [_tree_parts(t) for t in trees], pairs)
    return [_tree_from_parts(p, quad) for p in moved]


def _gather_forest(trees: list, mesh: Mesh, top_levels: int,
                   covered_np=None) -> list:
    """The coarse forest of each local shard: every shard's top
    ``top_levels`` levels gathered, the subtrees covered by a near stage
    emptied (mass 0, boxes at ``EMPTY_POS``: by default ring distance 0 and
    ±1; ``covered_np`` (P, P), row d the subtrees shard d covers, adds the
    seam stages), the shards padded to a power of two, and virtual levels
    combined above the subtree roots, so that the levels index like the
    top of one complete binary tree. The forest has one-particle dummy
    leaves: walk it with ``plan_rows(..., max_levels=...)``, which never
    reads them."""
    n_dev = mesh.n_shards
    tree0 = trees[0]
    quad = tree0.levels[0].quad is not None
    levels_m = min(top_levels, tree0.depth + 1)
    fields = 6 if quad else 5
    parts = [[x for lv in t.levels[:levels_m]
              for x in (lv.aabb_min, lv.aabb_max, lv.com, lv.mass_i,
                        lv.count) + ((lv.quad,) if quad else ())]
             for t in trees]
    every = all_gather_blocks(mesh, parts)          # P lists of fields
    p2 = 1 << max(0, (n_dev - 1).bit_length())
    dev = mesh.device
    forests = []
    for my in mesh.shard_ids:
        if covered_np is not None:
            covered = torch.as_tensor(covered_np[my], device=dev)
        else:
            d = (torch.arange(n_dev, device=dev) - my) % n_dev
            covered = (d == 0) | (d == 1) | (d == n_dev - 1)
        gathered = []
        for lvl in range(levels_m):
            def field(k, fill):
                x = torch.stack([every[s][lvl * fields + k]
                                 for s in range(n_dev)])
                m = covered.reshape((n_dev,) + (1,) * (x.ndim - 1))
                x = torch.where(m, torch.full((), fill, dtype=x.dtype,
                                              device=dev), x)
                if p2 != n_dev:
                    x = torch.cat([x, torch.full(
                        (p2 - n_dev,) + x.shape[1:], fill, dtype=x.dtype,
                        device=dev)])
                return x.reshape((p2 * x.shape[1],) + x.shape[2:])

            gathered.append(Level(
                aabb_min=field(0, EMPTY_POS), aabb_max=field(1, EMPTY_POS),
                com=field(2, EMPTY_POS), mass_i=field(3, 0),
                count=field(4, 0), quad=field(5, 0.0) if quad else None))
        vlevels = [gathered[0]]
        while vlevels[0].aabb_min.shape[0] > 1:
            vlevels.insert(0, _combine(vlevels[0]))
        levels = vlevels + gathered[1:]
        w = levels[-1].aabb_min.shape[0]
        forests.append(FlatTree(
            levels=levels, leaf_pos=torch.zeros((w, 1, 2), device=dev),
            leaf_mass=torch.zeros((w, 1), device=dev)))
    return forests


# -- near stages ---------------------------------------------------------------

class SeamRows(NamedTuple):
    """The own rows of a seeded continuation walk: ``plan_rows`` reads only
    the row boxes."""
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor


def _sweep(stage: str, tgt, cols, cfg: SimConfig, mp: int, rcp: str,
           force=None) -> torch.Tensor:
    """One stage's sweep of targets (G, S, 2) against planned ``cols``:
    ``grouped_force`` bounded per group at its last live column (bitwise
    the full sweep), or the caller's ``force(tgt, x, y, m, softening2,
    rcp)`` (the differentiable sweep, monopole only). ``stage`` names the
    stage ("local", "near_bounded", "near_deep", "near", "forest",
    "ring"), for instrumentation."""
    if force is not None:
        return force(tgt, *cols[:3], cfg.softening2, rcp)
    src_q = tuple(cols[3:6]) if mp == 2 else None
    return grouped_force(tgt, *cols[:3], cfg.softening2, rcp,
                         col_limit=last_nonzero_columns(cols[2], src_q),
                         src_q=src_q)


def _near_geometry(cfg: SimConfig, caps, depth: int):
    """(k0, cut, refine) of a near stage against a depth-``depth`` subtree:
    the walk's seed level, the bounded walk's flush level, and whether the
    stage splits into a bounded walk and a continuation."""
    fcap = caps[0]
    k0 = min(max(fcap.bit_length() - 1, 0), depth - 1)
    ma = cfg.resolved_near_refine()
    cut = min(depth - 1, k0 + ma) if ma else depth
    return k0, cut, bool(ma) and cut > k0


def _near_bounded(acc, visiting: FlatTree, own, tgt, cfg: SimConfig,
                  mp: int, rcp: str, caps, k0: int, cut: int, force=None):
    """The bounded part of a near stage: a walk of every row over the
    visiting subtree's levels down to ``cut`` (no leaf data), a flush to COM
    columns for the open rows beyond the ``near_rows`` closest to the
    subtree's root, and the choice of those rows. Returns ``(acc, ids,
    request)``, where ``request = (targets, own_min, own_max, frontier,
    valid as int8)`` of the chosen rows is all the continuation needs."""
    fcap, _ = caps
    cols, frontier, valid = plan_rows(
        visiting, own, cfg.theta, fcap, 0, cfg.tree_arity, multipole=mp,
        max_levels=cut - k0, return_frontier=True)
    g = own.aabb_min.shape[0]
    r = min(g, cfg.near_rows or max(64, g // 16))
    deep = valid.any(dim=1)
    root = visiting.levels[0]
    _, _, d2 = _group_node_d2(own.aabb_min, own.aabb_max, root.aabb_min[0],
                              root.aabb_max[0], root.com[0])
    order = torch.argsort(torch.where(deep, d2, torch.full(
        (), float("inf"), device=d2.device)), stable=True)
    ids = order[:r]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(g, device=order.device)
    flush_rows = deep & (rank >= r)
    lvl = visiting.levels[cut]
    rec = _rows(lvl.packed_quad if mp == 2 else lvl.packed,
                frontier.to(torch.int64))
    fm = flush_rows[:, None] & valid
    zero = torch.zeros((), device=rec.device)
    cols = list(cols)
    cols[0] = torch.cat([cols[0], rec[..., 4]], 1)
    cols[1] = torch.cat([cols[1], rec[..., 5]], 1)
    cols[2] = torch.cat([cols[2], torch.where(fm, rec[..., 6], zero)], 1)
    for k in range(3, len(cols)):
        cols[k] = torch.cat([cols[k], torch.zeros_like(rec[..., 6])], 1)
    acc = acc + _sweep("near_bounded", tgt, cols, cfg, mp, rcp, force)
    request = (tgt.index_select(0, ids), own.aabb_min.index_select(0, ids),
               own.aabb_max.index_select(0, ids),
               frontier.index_select(0, ids),
               valid.index_select(0, ids).to(torch.int8))
    return acc, ids, request


def _near_deep_serve(tree: FlatTree, request, cfg: SimConfig, mp: int,
                     rcp: str, caps, cut: int, force=None) -> torch.Tensor:
    """The full-depth continuation of a bounded near walk against ``tree``,
    the subtree its frontier indexes: the visiting one on the same shard,
    or the owner's own tree in the compute-to-data exchange (the same
    arrays, so the same bits)."""
    fcap, lcap = caps
    tgt_rows, own_min, own_max, frontier, valid = request
    deep_cols = plan_rows(tree, SeamRows(own_min, own_max), cfg.theta, fcap,
                          lcap, cfg.tree_arity, multipole=mp,
                          seed=(cut, frontier, valid != 0))
    return _sweep("near_deep", tgt_rows, deep_cols, cfg, mp, rcp, force)


def _near_stage(acc, visiting: FlatTree, own, tgt, cfg: SimConfig, mp: int,
                rcp: str, caps=None, force=None) -> torch.Tensor:
    """One visiting-subtree stage on one shard: with refinement the
    bounded walk for every row and the continuation for the chosen rows,
    else one full walk. ``caps``: the (frontier, leaf) caps."""
    caps = caps if caps is not None else cfg.resolved_caps()
    fcap, lcap = caps
    k0, cut, refine = _near_geometry(cfg, caps, visiting.depth)
    if not refine:
        planned = plan_rows(visiting, own, cfg.theta, fcap, lcap,
                            cfg.tree_arity, multipole=mp)
        return acc + _sweep("near", tgt, planned, cfg, mp, rcp, force)
    acc, ids, request = _near_bounded(acc, visiting, own, tgt, cfg, mp, rcp,
                                      caps, k0, cut, force=force)
    acc_deep = _near_deep_serve(visiting, request, cfg, mp, rcp, caps, cut,
                                force=force)
    return acc.index_add(0, ids, acc_deep)


# -- the force -----------------------------------------------------------------

class _Rows(NamedTuple):
    """One shard's planning rows at a granularity of ``pl`` leaves."""
    own: Level
    tgt: torch.Tensor       # (n_leaves / pl, pl·S, 2)


def _plan_granularity(n_leaves: int, want: int, floor: int = 1) -> int:
    """Leaves per planning row: ``want``, at least ``floor`` and at most
    the leaf count, halved until it divides the leaf count."""
    pl_ = max(floor, min(want, n_leaves))
    while n_leaves % pl_:
        pl_ //= 2
    return pl_


def _rows_at(tree: FlatTree, pl_: int) -> _Rows:
    n_leaves, S, _ = tree.leaf_pos.shape
    return _Rows(tree.levels[tree.depth - (pl_.bit_length() - 1)],
                 tree.leaf_pos.reshape(n_leaves // pl_, pl_ * S, 2))


def _covered(n_dev: int, extra_pairs):
    covered_np = np.zeros((n_dev, n_dev), bool)
    for d in range(n_dev):
        covered_np[d, [d, (d + 1) % n_dev, (d - 1) % n_dev]] = True
    for matching in extra_pairs:
        for s, d in matching:
            covered_np[d, s] = True
    return covered_np


def _forest_mode(cfg: SimConfig, n_dev: int, extra_pairs) -> bool:
    """Forest mode needs four shards for a ring-far subtree. Below θ=2 it
    needs the seam stages too: a call without ``extra_pairs`` takes the
    ring (the JAX package's rule, not a device fallback)."""
    forest = cfg.resolved_far_mode() == "forest" and n_dev >= 4
    return forest and not (resolved_seam_stages(cfg) and not extra_pairs)


def _forest_walk(cfg: SimConfig, forest: FlatTree, n_dev: int):
    """(frontier cap, max_levels) of the bounded forest walk: it flushes at
    the deepest gathered level."""
    ff = max(16, 1 << max(0, (n_dev - 1).bit_length()))
    k0 = min(max(ff.bit_length() - 1, 0), forest.depth - 1)
    return ff, forest.depth - k0


def bh_distributed_accel(pos: torch.Tensor, mass: torch.Tensor, mesh: Mesh,
                         config: SimConfig | None = None, extra_pairs=(),
                         force=None) -> torch.Tensor:
    """Distributed Barnes-Hut acceleration f32[S·L, 2] of the mesh's local
    shards of a distributed state (each shard in local Morton order), in
    that order.

    ``extra_pairs``: the seam matchings of ``adjacency_stages``; each runs
    one more near stage and its subtrees leave the forest. ``force``: the
    sweep (``force(tgt, x, y, m, softening2, rcp)``) in place of
    ``grouped_force``; ``parallel.bh_distributed_grad`` passes the
    differentiable one."""
    cfg = config or SimConfig(force_path="bh")
    n_dev = mesh.n_shards
    mp = cfg.resolved_multipole()
    rcp = cfg.resolved_rcp(bh=True)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    forest = _forest_mode(cfg, n_dev, extra_pairs)
    covered_np = _covered(n_dev, extra_pairs) if forest and extra_pairs \
        else None
    fcap, lcap = cfg.resolved_caps()

    trees = [summarize_sorted(p, m, leaf_size=cfg.leaf_size,
                              unweighted_leaf_com=cfg.unweighted_leaf_com,
                              quad=mp == 2)
             for p, m in zip(split_shards(mesh, pos),
                             split_shards(mesh, mass))]
    n_leaves, S, _ = trees[0].leaf_pos.shape
    pl_ = _plan_granularity(n_leaves, cfg.plan_leaves)
    local = [_rows_at(t, pl_) for t in trees]
    acc = [torch.zeros_like(r.tgt) for r in local]

    if forest:
        # The local subtree at full depth; the two ring neighbours and the
        # seam matchings as near stages; everything else in one bounded
        # walk over the gathered forest.
        for i, (t, r) in enumerate(zip(trees, local)):
            acc[i] = acc[i] + _sweep("local", r.tgt, plan_rows(
                t, r.own, cfg.theta, fcap, lcap, cfg.tree_arity,
                multipole=mp), cfg, mp, rcp, force)
        back = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        # Near rows: 8 leaves at θ≥2, the local plan's granularity below.
        pln = _plan_granularity(
            n_leaves, NEAR_ROW_LEAVES if cfg.theta >= 2.0 else 1, pl_)
        near = [_rows_at(t, pln) for t in trees]
        ncaps = (fcap, max(lcap, 4 * pln))
        stage_perms = [perm, back] + [list(m) for m in extra_pairs]
        k0n, cutn, refine = _near_geometry(cfg, ncaps, trees[0].depth)
        if refine and cfg.near_remote:
            # Compute to data: ship the subtree's levels 0..cut, send the
            # rows still open back to its owner, return their forces.
            tops = [FlatTree(levels=list(t.levels[:cutn + 1]),
                             leaf_pos=torch.zeros((1, S, 2), device=pos.device),
                             leaf_mass=torch.zeros((1, S), device=pos.device))
                    for t in trees]
            for sperm in stage_perms:
                inv = [(d, s) for (s, d) in sperm]
                vis_top = _permute_trees(mesh, tops, sperm)
                bounded = [_near_bounded(
                    torch.zeros_like(nr.tgt), v, nr.own, nr.tgt, cfg, mp,
                    rcp, ncaps, k0n, cutn, force=force)
                    for v, nr in zip(vis_top, near)]
                reqs = ppermute_blocks(mesh, [list(b[2]) for b in bounded],
                                       inv)
                served = [[_near_deep_serve(t, req, cfg, mp, rcp, ncaps,
                                            cutn, force=force)]
                          for t, req in zip(trees, reqs)]
                acc_back = ppermute_blocks(mesh, served, sperm)
                for i, (acc_n, ids, _) in enumerate(bounded):
                    acc_n = acc_n.index_add(0, ids, acc_back[i][0])
                    acc[i] = acc[i] + acc_n.reshape(acc[i].shape)
        else:
            for sperm in stage_perms:
                visiting = _permute_trees(mesh, trees, sperm)
                for i, (v, nr) in enumerate(zip(visiting, near)):
                    acc_n = _near_stage(torch.zeros_like(nr.tgt), v, nr.own,
                                        nr.tgt, cfg, mp, rcp, caps=ncaps,
                                        force=force)
                    acc[i] = acc[i] + acc_n.reshape(acc[i].shape)
        forests = _gather_forest(trees, mesh, cfg.forest_levels,
                                 covered_np=covered_np)
        # Forest rows of 32 leaves: coarser rows only open more.
        plf = _plan_granularity(n_leaves, FOREST_ROW_LEAVES, pl_)
        for i, (t, ft) in enumerate(zip(trees, forests)):
            rf = _rows_at(t, plf)
            ff, max_levels = _forest_walk(cfg, ft, n_dev)
            planned = plan_rows(ft, rf.own, cfg.theta, ff, 0, arity=2,
                                multipole=mp, max_levels=max_levels)
            acc_f = _sweep("forest", rf.tgt, planned, cfg, mp, rcp, force)
            acc[i] = acc[i] + acc_f.reshape(acc[i].shape)
    else:
        visiting = trees
        for s in range(n_dev):
            if s > 0:
                visiting = _permute_trees(mesh, visiting, perm)
            f_s, l_s = _stage_caps(cfg, min(s, n_dev - s), n_dev)
            for i, (v, r) in enumerate(zip(visiting, local)):
                acc[i] = acc[i] + _sweep("ring", r.tgt, plan_rows(
                    v, r.own, cfg.theta, f_s, l_s, cfg.tree_arity,
                    multipole=mp), cfg, mp, rcp, force)
    return torch.cat([a.reshape(n_leaves * S, 2) for a in acc])


def bh_distributed_total_energy(state: ParticleState, mesh: Mesh,
                                config: SimConfig, extra_pairs=()) -> dict:
    """E = KE + U of a distributed state, U from the Barnes-Hut planned
    columns of every stage fed to the pair potential
    (``ops.energy.bh_potential_from_columns``): O(N·C/P) per shard. The
    stages are the force's (local, neighbours, seams, forest; or the ring),
    with whole visiting subtrees shipped, monopole plans, unrefined, at the
    local plan granularity."""
    cfg = config
    n_dev = mesh.n_shards
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    forest = _forest_mode(cfg, n_dev, extra_pairs)
    covered_np = _covered(n_dev, extra_pairs) if forest and extra_pairs \
        else None
    fcap, lcap = cfg.resolved_caps()
    with torch.no_grad():
        trees = [summarize_sorted(p, m, leaf_size=cfg.leaf_size,
                                  unweighted_leaf_com=cfg.unweighted_leaf_com)
                 for p, m in zip(split_shards(mesh, state.pos),
                                 split_shards(mesh, state.mass))]
        n_leaves, S, _ = trees[0].leaf_pos.shape
        pl_ = _plan_granularity(n_leaves, cfg.plan_leaves)
        local = [_rows_at(t, pl_) for t in trees]
        tgtm = [t.leaf_mass.reshape(n_leaves // pl_, pl_ * S) for t in trees]

        def pot(i, planned):
            return bh_potential_from_columns(tgtm[i], local[i].tgt,
                                             *planned[:3],
                                             softening2=cfg.softening2)

        u = [torch.zeros((), device=state.pos.device) for _ in trees]
        if forest:
            for i, (t, r) in enumerate(zip(trees, local)):
                u[i] = pot(i, plan_rows(t, r.own, cfg.theta, fcap, lcap,
                                        cfg.tree_arity, multipole=1))
            back = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            for sperm in [perm, back] + [list(m) for m in extra_pairs]:
                visiting = _permute_trees(mesh, trees, sperm)
                for i, (v, r) in enumerate(zip(visiting, local)):
                    u[i] = u[i] + pot(i, plan_rows(
                        v, r.own, cfg.theta, fcap, max(lcap, 4 * pl_),
                        cfg.tree_arity, multipole=1))
            forests = _gather_forest(trees, mesh, cfg.forest_levels,
                                     covered_np=covered_np)
            for i, (ft, r) in enumerate(zip(forests, local)):
                ff, max_levels = _forest_walk(cfg, ft, n_dev)
                u[i] = u[i] + pot(i, plan_rows(ft, r.own, cfg.theta, ff, 0,
                                               arity=2, multipole=1,
                                               max_levels=max_levels))
        else:
            visiting = trees
            for s in range(n_dev):
                if s > 0:
                    visiting = _permute_trees(mesh, visiting, perm)
                f_s, l_s = _stage_caps(cfg, min(s, n_dev - s), n_dev)
                for i, (v, r) in enumerate(zip(visiting, local)):
                    u[i] = u[i] + pot(i, plan_rows(v, r.own, cfg.theta, f_s,
                                                   l_s, cfg.tree_arity,
                                                   multipole=1))
        pe = mesh.psum(torch.stack(u))
        mass = split_shards(mesh, state.mass)
        vel = split_shards(mesh, state.vel)
        ke = mesh.psum((0.5 * mass * (vel ** 2).sum(-1)).sum(dim=1))
    return {"potential_energy": pe, "kinetic_energy": ke,
            "total_energy": pe + ke}


def make_distributed_bh_step(mesh: Mesh, config: SimConfig, extra_pairs=()):
    """A ``state -> state`` distributed Barnes-Hut step: every
    ``resort_every``-th call re-sorts each shard's own rows in Morton
    order (the others step in the current order, as the single-device
    World does), then ``bh_distributed_accel`` and semi-implicit Euler, or
    leapfrog with two force evaluations. ``step.reset()`` restarts the
    re-sort cadence (after a rebalance the state is freshly sorted)."""
    cfg = config
    mbits = cfg.resolved_morton_bits()
    every = max(1, cfg.resort_every)
    counter = [0]

    def accel(p, m):
        return bh_distributed_accel(p, m, mesh, config=cfg,
                                    extra_pairs=extra_pairs)

    def step(state: ParticleState) -> ParticleState:
        resort = counter[0] % every == 0
        counter[0] += 1
        if resort:
            spos, svel, smass = map_shards(
                mesh, lambda p, v, m: morton_sort_state(
                    p, v, m, cfg.world_size, bits=mbits),
                state.pos, state.vel, state.mass)
            state = state.replace(pos=spos, vel=svel, mass=smass)
        if cfg.integrator == "leapfrog":
            return leapfrog_step(state, accel, cfg.dt)
        return euler_step(state, accel(state.pos, state.mass), cfg.dt)

    def reset() -> None:
        counter[0] = 0

    step.reset = reset
    return step
