"""The plain reference: the semantics the port states, written again in
plain PyTorch and NumPy.

It imports nothing of the port and nothing of the JAX package. What it
follows is the documented behaviour of the two configurations' paths:

- Morton order: positions quantised to ``bits`` per axis (``pos · 2^bits /
  world`` in f32, clamped, truncated), the two axes interleaved, massless
  rows last, ties kept in row order.
- The flat tree: leaves of ``leaf_size`` consecutive rows, the leaf count
  padded to a power of two, node k's children 2k and 2k+1; masses summed as
  integers (each f32 mass truncated), a leaf's COM the unweighted mean of
  its rows or the mass-weighted one, an internal COM the children's COMs
  weighted by their integer masses rounded to f32, empty nodes at
  ``EMPTY_POS``; second moments about the COM, combined by the parallel
  axis rule.
- The planner: each row of ``plan_leaves`` leaves walks the tree level by
  level from the level whose width is the frontier cap. A child is
  accepted when it is disjoint from the row's box and max(w, h)² < d²·θ²,
  d the least distance from the box to its COM (below θ=2 it must also be
  separated in both axes, or pass θ/2). Opened children are kept closest
  first up to the cap; those past it act through their COM. Accepted
  nodes act through their COM (and, separated in both axes at
  multipole 2, their second moments); the rows of the leaves the walk
  reaches act one by one.
- The law: a = m·d / (|d|₁ · max(|d|², ε²)), 0 where |d|₁ is not a normal
  f32; its quadrupole term ½ Σ Q_ij ∂_i∂_j (d φ), φ = 1/(|d|₁ |d|²).
- Semi-implicit Euler with dt rounded to f32; the re-sort on every
  ``resort_every``-th step and on a profiled step.
- The splat raster of the reference program (src/main.rs:41-72).

The decisions (order, acceptance) are taken in the state's precision from
the reference's own summaries; the sums run in ``law`` precision (f64).
``Precision`` also gives the control: everything in bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.autograd import grad as autograd_grad
from torch.utils.checkpoint import checkpoint

FLT_MIN_NORMAL = float(np.finfo(np.float32).tiny)
FLT_MAX = float(np.finfo(np.float32).max)
EMPTY_POS = 2.0e5
PAD_KEY = 1 << 62
CHUNK_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Precision:
    """``state``: positions and velocities; ``decide``: the sort and the
    acceptance tests; ``law``: the pair terms and their sums."""
    state: torch.dtype = torch.float32
    decide: torch.dtype = torch.float32
    law: torch.dtype = torch.float64


REFERENCE = Precision()
GRADIENT = Precision(state=torch.float64)
CONTROL = Precision(torch.bfloat16, torch.bfloat16, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class BH:
    """The Barnes-Hut settings a configuration resolves to."""
    theta: float
    leaf_size: int
    world_size: float
    unweighted_leaf_com: bool
    softening2: float
    frontier_cap: int
    leaf_cap: int
    plan_leaves: int
    multipole: int
    morton_bits: int


def resolve_bh(sim: dict) -> BH:
    """The settings of a configuration's ``sim`` block, with the port's
    documented rules for those left out (θ ≥ 2: frontier 16, leaves
    max(8, 4·pl), 15-bit keys, monopole; below: 256, max(256, 32·pl), 24
    bits, quadrupole)."""
    theta = float(sim.get("theta", 50.0))
    far = theta >= 2.0
    pl = int(sim.get("plan_leaves", 4))
    return BH(
        theta=theta, leaf_size=int(sim.get("leaf_size", 64)),
        world_size=float(sim.get("world_size", 100_000.0)),
        unweighted_leaf_com=bool(sim.get("unweighted_leaf_com", True)),
        softening2=float(sim.get("softening2", 1e-3)),
        frontier_cap=int(sim.get("frontier_cap") or (16 if far else 256)),
        leaf_cap=int(sim.get("leaf_cap") or (max(8, 4 * pl) if far
                                            else max(256, 32 * pl))),
        plan_leaves=pl,
        multipole=int(sim.get("multipole") or (1 if far else 2)),
        morton_bits=int(sim.get("morton_bits") or (15 if far else 24)))


# -- order --------------------------------------------------------------------

def morton_order(pos: torch.Tensor, mass: torch.Tensor, world_size: float,
                 bits: int, decide: torch.dtype = torch.float32):
    """Stable Z-order permutation, massless rows last."""
    scale = float(np.float32((1 << bits) / world_size))
    top = (1 << bits) - 1
    p = pos.detach().to(decide)
    q = torch.clamp(torch.nan_to_num(p * scale, nan=0.0), 0.0,
                    float(top)).to(torch.int64)
    key = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for b in range(bits):
        key |= ((q[:, 0] >> b) & 1) << (2 * b)
        key |= ((q[:, 1] >> b) & 1) << (2 * b + 1)
    key = torch.where(mass > 0, key, torch.full_like(key, PAD_KEY))
    return torch.sort(key, stable=True).indices


# -- the tree -----------------------------------------------------------------

@dataclasses.dataclass
class Level:
    lo: torch.Tensor       # (w, 2) box, decide precision
    hi: torch.Tensor
    com: torch.Tensor      # (w, 2) law precision (carries autograd)
    mass_i: torch.Tensor   # (w,) int64 integer mass
    mass: torch.Tensor     # (w,) that mass rounded to f32, law precision
    count: torch.Tensor    # (w,) int64
    q: torch.Tensor | None  # (w, 3) law precision


@dataclasses.dataclass
class Tree:
    levels: list           # root first
    leaf_pos: torch.Tensor  # (L, S, 2) law precision
    leaf_mass: torch.Tensor  # (L, S) law precision

    @property
    def depth(self) -> int:
        return len(self.levels) - 1


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def summarize(spos, smass, bh: BH, prec: Precision) -> Tree:
    """The tree over rows already in their order."""
    n = spos.shape[0]
    s = bh.leaf_size
    n_leaves = _next_pow2(-(-n // s))
    extra = n_leaves * s - n
    law, dec = prec.law, prec.decide
    pos = spos.to(law)
    mass = smass.to(law)
    if extra:
        pos = torch.cat([pos, torch.full((extra, 2), EMPTY_POS, dtype=law,
                                         device=pos.device)])
        mass = torch.cat([mass, torch.zeros(extra, dtype=law,
                                            device=pos.device)])
    p3 = pos.reshape(n_leaves, s, 2)
    m2 = mass.reshape(n_leaves, s)
    real = m2 > 0
    count = real.sum(1)
    empty = count == 0
    pd = p3.detach().to(dec)
    inf = torch.tensor(float("inf"), dtype=dec, device=pos.device)
    lo = torch.where(real[..., None], pd, inf).amin(1)
    hi = torch.where(real[..., None], pd, -inf).amax(1)
    w = torch.where(real, m2, torch.zeros((), dtype=law, device=pos.device))
    mass_i = torch.trunc(w.detach().float()).to(torch.int64).sum(1)
    if bh.unweighted_leaf_com:
        com = (p3 * real[..., None]).sum(1) / count.clamp_min(1)[:, None]
    else:
        com = (p3 * w[..., None]).sum(1) / w.sum(1).clamp_min(1e-30)[:, None]
    q = None
    if bh.multipole == 2:
        d = p3 - com[:, None, :]
        q = torch.stack([(w * d[..., 0] * d[..., 0]).sum(1),
                         (w * d[..., 0] * d[..., 1]).sum(1),
                         (w * d[..., 1] * d[..., 1]).sum(1)], -1)
    levels = [_level(lo, hi, com, mass_i, count, q, empty, law)]
    while levels[0].count.shape[0] > 1:
        levels.insert(0, _combine(levels[0], law))
    return Tree(levels, p3, m2)


def _level(lo, hi, com, mass_i, count, q, empty, law) -> Level:
    e = EMPTY_POS
    return Level(lo=torch.where(empty[:, None], torch.full_like(lo, e), lo),
                 hi=torch.where(empty[:, None], torch.full_like(hi, e), hi),
                 com=torch.where(empty[:, None], torch.full_like(com, e), com),
                 mass_i=mass_i, mass=mass_i.to(torch.float32).to(law),
                 count=count, q=None if q is None else torch.where(
                     empty[:, None], torch.zeros_like(q), q))


def _combine(c: Level, law) -> Level:
    m = c.count.shape[0] // 2

    def pair(x):
        return x.reshape(m, 2, *x.shape[1:])

    count = pair(c.count).sum(1)
    mass_i = pair(c.mass_i).sum(1)
    mf = pair(c.mass)                                  # children, as f32
    den = mass_i.to(torch.float32).to(law).clamp_min(1.0)
    com = (pair(c.com) * mf[..., None]).sum(1) / den[:, None]
    cempty = pair(c.count) == 0
    inf = torch.tensor(float("inf"), dtype=c.lo.dtype, device=c.lo.device)
    lo = torch.where(cempty[..., None], inf, pair(c.lo)).amin(1)
    hi = torch.where(cempty[..., None], -inf, pair(c.hi)).amax(1)
    q = None
    if c.q is not None:
        d = pair(c.com) - com[:, None, :]
        shift = torch.stack([d[..., 0] * d[..., 0], d[..., 0] * d[..., 1],
                             d[..., 1] * d[..., 1]], -1)
        q = (pair(c.q) + mf[..., None] * shift).sum(1)
    return _level(lo, hi, com, mass_i, count, q, count == 0, law)


# -- the planner --------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """Per planning row: for each walked level the candidate node ids, which
    act through their COM mass and which through their second moments; the
    leaves reached and which of those slots are valid."""
    nodes: list            # [(level, ids (G,K), use_m (G,K), use_q (G,K))]
    leaf_ids: torch.Tensor  # (G, leaf_cap)
    leaf_valid: torch.Tensor
    pl: int


def plan_rows(tree: Tree, bh: BH, decide: torch.dtype) -> Plan:
    depth = tree.depth
    n_leaves = tree.leaf_pos.shape[0]
    pl = max(1, min(bh.plan_leaves, n_leaves))
    while pl > 1 and (n_leaves % pl or (1 << depth) < pl):
        pl //= 2
    own = tree.levels[depth - (pl.bit_length() - 1)]
    gmin, gmax = own.lo[:, None, :], own.hi[:, None, :]
    g = own.lo.shape[0]
    dev = own.lo.device
    F = bh.frontier_cap
    quad = bh.multipole == 2
    theta2 = torch.tensor(np.float32(bh.theta * bh.theta), dtype=decide,
                          device=dev)
    tight2 = torch.tensor(np.float32(bh.theta * bh.theta * 0.25),
                          dtype=decide, device=dev)
    k0 = min(max(F.bit_length() - 1, 0), depth - 1) if depth > 0 else 0
    frontier = torch.arange(1 << k0, device=dev).expand(g, -1)
    valid = torch.ones_like(frontier, dtype=torch.bool)
    nodes = []
    zero = torch.zeros((), dtype=decide, device=dev)
    for lvl in range(k0, depth):
        cap = bh.leaf_cap if lvl + 1 == depth else F
        child = tree.levels[lvl + 1]
        cand = torch.stack([2 * frontier, 2 * frontier + 1], -1).reshape(g, -1)
        cvalid = valid.repeat_interleave(2, dim=1)
        nmin, nmax = child.lo[cand], child.hi[cand]
        ncom = child.com.detach().to(decide)[cand]
        disjoint = ((gmax[..., 0] <= nmin[..., 0]) | (gmin[..., 0] >= nmax[..., 0])
                    | (gmax[..., 1] <= nmin[..., 1])
                    | (gmin[..., 1] >= nmax[..., 1]))
        size = nmax - nmin
        s2 = torch.maximum(size[..., 0], size[..., 1]) ** 2
        dx = torch.maximum(torch.maximum(gmin[..., 0] - ncom[..., 0],
                                         ncom[..., 0] - gmax[..., 0]), zero)
        dy = torch.maximum(torch.maximum(gmin[..., 1] - ncom[..., 1],
                                         ncom[..., 1] - gmax[..., 1]), zero)
        d2 = dx * dx + dy * dy
        accept = cvalid & disjoint & (s2 < d2 * theta2)
        use_q = None
        if quad:
            both = (((gmax[..., 0] <= nmin[..., 0]) | (gmin[..., 0] >= nmax[..., 0]))
                    & ((gmax[..., 1] <= nmin[..., 1])
                       | (gmin[..., 1] >= nmax[..., 1])))
            tight = cvalid & disjoint & (s2 < d2 * tight2)
            accept = (accept & both) | tight
            use_q = accept & both
        opened = cvalid & ~accept & (child.count[cand] > 0)
        # Closest first; among equal distances, candidate order.
        order = torch.sort(torch.where(opened, d2.float(),
                                       torch.full_like(d2.float(),
                                                       float("inf"))),
                           dim=1, stable=True).indices
        n_open = opened.sum(1, keepdim=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(
            order.shape[1], device=dev).expand_as(order).contiguous())
        overflow = opened & (rank >= cap)
        nodes.append((lvl + 1, cand, accept | overflow, use_q))
        keep = order[:, :cap]
        width = keep.shape[1]
        new_front = torch.gather(cand, 1, keep)
        new_valid = torch.arange(width, device=dev)[None, :] < n_open
        if width < cap:
            pad = cap - width
            new_front = torch.cat([new_front, torch.zeros(
                (g, pad), dtype=new_front.dtype, device=dev)], 1)
            new_valid = torch.cat([new_valid, torch.zeros(
                (g, pad), dtype=torch.bool, device=dev)], 1)
        frontier, valid = new_front, new_valid
    if depth == 0:
        frontier = torch.zeros((g, 1), dtype=torch.int64, device=dev)
        valid = torch.ones((g, 1), dtype=torch.bool, device=dev)
    return Plan(nodes, frontier, valid, pl)


def columns(tree: Tree, plan: Plan):
    """The sources each planning row sums: (x, y, m) of (G, C) and the
    second moments (G, C, 3) or None, in law precision."""
    xs, ys, ms, qs = [], [], [], []
    for lvl, ids, use_m, use_q in plan.nodes:
        lv = tree.levels[lvl]
        com = lv.com[ids]
        xs.append(com[..., 0])
        ys.append(com[..., 1])
        ms.append(torch.where(use_m, lv.mass[ids], torch.zeros_like(com[..., 0])))
        if use_q is not None:
            qs.append(torch.where(use_q[..., None], lv.q[ids],
                                  torch.zeros_like(lv.q[ids])))
    g = plan.leaf_ids.shape[0]
    lp = tree.leaf_pos[plan.leaf_ids]                      # (G, Lc, S, 2)
    lm = tree.leaf_mass[plan.leaf_ids] * plan.leaf_valid[..., None]
    xs.append(lp[..., 0].reshape(g, -1))
    ys.append(lp[..., 1].reshape(g, -1))
    ms.append(lm.reshape(g, -1))
    q = None
    if qs:
        qs.append(torch.zeros((g, xs[-1].shape[1], 3), dtype=lm.dtype,
                              device=lm.device))
        q = torch.cat(qs, 1)
    return torch.cat(xs, 1), torch.cat(ys, 1), torch.cat(ms, 1), q


def plan_work(tree: Tree, plan: Plan):
    """(pairs, live sources, live targets) the plan needs: for each planning
    row, its live targets (rows of positive mass) times its live sources (a
    nonzero mass, or nonzero second moments), and the sums of each."""
    _, _, m, q = columns(tree, plan)
    live = m != 0
    if q is not None:
        live = live | (q != 0).any(-1)
    g = m.shape[0]
    tgt = (tree.leaf_mass.reshape(g, -1) > 0).sum(1)
    cols = live.sum(1)
    return int((cols * tgt).sum()), int(cols.sum()), int(tgt.sum())


# -- the law ------------------------------------------------------------------

def _abs(x):
    """|x| whose derivative at 0 is +1, the gradient convention the
    configuration's backward states (psign(0) = +1)."""
    return x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype).detach()


def _law(tx, ty, sx, sy, sm, soft2, sq=None):
    """Sum over sources of each target's acceleration: tx, ty (g, S, 1),
    sources (g, 1, C), second moments (g, 1, C, 3) or None."""
    dx = sx - tx
    dy = sy - ty
    adx, ady = _abs(dx), _abs(dy)
    s = adx + ady
    normal = (s >= FLT_MIN_NORMAL) & (s <= FLT_MAX)
    d2 = torch.clamp_min(dx * dx + dy * dy, soft2)
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    a = 1.0 / torch.where(normal, s, one)
    b = 1.0 / d2
    phi = a * b
    ax = dx * sm * phi
    ay = dy * sm * phi
    if sq is not None:
        qxx, qxy, qyy = sq[..., 0], sq[..., 1], sq[..., 2]
        sgx = torch.where(dx >= 0, one, -one)
        sgy = torch.where(dy >= 0, one, -one)
        # ∂φ and ∂∂φ with φ = a·b, a = 1/|d|₁, b = 1/|d|².
        gx = -(sgx * a * a * b + 2.0 * dx * a * b * b)
        gy = -(sgy * a * a * b + 2.0 * dy * a * b * b)
        a3b, a2b2, ab2, ab3 = a ** 3 * b, a * a * b * b, a * b * b, a * b ** 3
        gxx = 2.0 * a3b + 4.0 * adx * a2b2 - 2.0 * ab2 + 8.0 * dx * dx * ab3
        gyy = 2.0 * a3b + 4.0 * ady * a2b2 - 2.0 * ab2 + 8.0 * dy * dy * ab3
        gxy = (2.0 * sgx * sgy * a3b + 2.0 * (sgx * dy + sgy * dx) * a2b2
               + 8.0 * dx * dy * ab3)
        lap = qxx * gxx + 2.0 * qxy * gxy + qyy * gyy
        ax = ax + qxx * gx + qxy * gy + 0.5 * dx * lap
        ay = ay + qxy * gx + qyy * gy + 0.5 * dy * lap
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    return (torch.where(normal, ax, zero).sum(-1),
            torch.where(normal, ay, zero).sum(-1))


def sweep(tgt, sx, sy, sm, sq, soft2: float, law: torch.dtype):
    """(G, S, 2) accelerations of the targets from their row's sources, in
    ``law`` precision, in chunks of rows (recomputed under autograd, so a
    gradient never holds the pair terms)."""
    g, s, _ = tgt.shape
    c = sx.shape[1]
    step = max(1, CHUNK_PAIRS // max(1, s * c))
    out = []
    for g0 in range(0, g, step):
        sl = slice(g0, g0 + step)
        args = (tgt[sl, :, 0:1].to(law), tgt[sl, :, 1:2].to(law),
                sx[sl, None, :].to(law), sy[sl, None, :].to(law),
                sm[sl, None, :].to(law))
        q = None if sq is None else sq[sl, None].to(law)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            ax, ay = checkpoint(_law, *args, soft2, q, use_reentrant=False)
        else:
            ax, ay = _law(*args, soft2, q)
        out.append(torch.stack([ax, ay], -1))
    return torch.cat(out, 0)


def bh_accel_sorted(spos, smass, bh: BH, prec: Precision):
    """Accelerations (law precision) of rows already in their order."""
    tree = summarize(spos, smass, bh, prec)
    plan = plan_rows(tree, bh, prec.decide)
    sx, sy, sm, sq = columns(tree, plan)
    g = sx.shape[0]
    tgt = tree.leaf_pos.reshape(g, -1, 2)
    acc = sweep(tgt, sx, sy, sm, sq, bh.softening2, prec.law)
    return acc.reshape(-1, 2)[:spos.shape[0]]


def bh_accel(pos, mass, bh: BH, prec: Precision):
    """Accelerations in the rows' own order: sort, sum, unsort."""
    order = morton_order(pos, mass, bh.world_size, bh.morton_bits, prec.decide)
    acc = bh_accel_sorted(pos[order], mass[order], bh, prec)
    return torch.zeros_like(acc).index_copy(0, order, acc)


# -- the step loop ------------------------------------------------------------

def f32_dt(dt: float) -> float:
    return float(np.float32(dt))


def run_steps(pos, vel, mass, first_update: int, steps: int,
              profiled_first: bool, sim: dict, prec: Precision = REFERENCE):
    """``steps`` Barnes-Hut Euler steps of the world from its state after
    ``first_update`` updates, rows in the world's order; the first step
    re-sorts when it is profiled. Returns (pos, vel, mass, rows), ``rows``
    the starting row of each row."""
    bh = resolve_bh(sim)
    dt = f32_dt(sim.get("dt", 0.1))
    every = max(int(sim.get("resort_every", 16)), 1)
    pos, vel, mass = pos.to(prec.state), vel.to(prec.state), mass.to(prec.state)
    rows = torch.arange(pos.shape[0], device=pos.device)
    for k in range(steps):
        if (k == 0 and profiled_first) or (first_update + k) % every == 0:
            order = morton_order(pos, mass, bh.world_size, bh.morton_bits,
                                 prec.decide)
            pos, vel, mass, rows = pos[order], vel[order], mass[order], rows[order]
        acc = bh_accel_sorted(pos, mass, bh, prec)
        vel = vel + acc.to(prec.state) * dt
        pos = pos + vel * dt
    return pos, vel, mass, rows


def batch_work(pos, mass, first_update: int, steps: int,
               profiled_first: bool, sim: dict):
    """The work of each step of a batch, ``plan_work`` of the plan the step
    sweeps, taken from the batch's starting positions in the order each
    step has (re-sorted where the step re-sorts): the sweep's inputs
    without the motion within the batch."""
    bh = resolve_bh(sim)
    every = max(int(sim.get("resort_every", 16)), 1)
    out, last = [], None
    for k in range(steps):
        if (k == 0 and profiled_first) or (first_update + k) % every == 0:
            order = morton_order(pos, mass, bh.world_size, bh.morton_bits)
            pos, mass, last = pos[order], mass[order], None
        if last is None:
            tree = summarize(pos, mass, bh, REFERENCE)
            last = plan_work(tree, plan_rows(tree, bh, torch.float32))
        out.append(last)
    return out


# -- the trajectory gradient --------------------------------------------------

def diff_bh(sim: dict) -> BH:
    """The settings of ``bh_accel_diff`` called with a configuration's θ,
    leaf size, world size, softening and leaf-COM rule and its own
    defaults otherwise: frontier 32, leaves 16, one leaf a row, monopole,
    15-bit keys."""
    return resolve_bh(dict(sim, frontier_cap=32, leaf_cap=16, plan_leaves=1,
                           multipole=1, morton_bits=15))


def trajectory_loss(pos0, vel0, mass, steps: int, bh: BH, dt: float,
                    prec: Precision = GRADIENT):
    """The spread of the positions after ``steps`` Euler steps about their
    mean, Σ|p − p̄|², and those positions; differentiable in ``pos0``."""
    p, v = pos0, vel0.to(prec.state)
    dt = f32_dt(dt)
    for _ in range(steps):
        v = v + bh_accel(p, mass, bh, prec).to(prec.state) * dt
        p = p + v * dt
    return ((p - p.mean(0)) ** 2).sum(), p


def trajectory_grad(pos0, vel0, mass, steps: int, bh: BH, dt: float,
                    prec: Precision = GRADIENT):
    """(loss, d loss / d pos0, final positions), all detached."""
    p0 = pos0.detach().to(prec.state).requires_grad_(True)
    loss, p = trajectory_loss(p0, vel0, mass, steps, bh, dt, prec)
    (g,) = autograd_grad(loss, p0)
    return loss.detach(), g, p.detach()


# -- the raster ---------------------------------------------------------------

def render(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
           world_size: float, render_size: int,
           heavy_weight: float) -> np.ndarray:
    """The reference program's splat (src/main.rs:41-72) as per-pixel rules:
    a pixel any heavy row hits is opaque green; else, hit by k light rows,
    its colour comes from the last of them in row order (0xFF, 0xFF − t,
    0xFF − t, min(10k, 250)), t = 0x10 + min(0xEF, sat_u8(10·(|vx|+|vy|)))."""
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    mass = np.asarray(mass, np.float32)
    ws = np.float32(world_size)
    scale = int(world_size) // render_size
    npix = render_size * render_size
    x, y = pos[:, 0], pos[:, 1]
    with np.errstate(invalid="ignore"):
        inb = (y < ws) & (x < ws) & (y >= 0) & (x >= 0)
    rows = np.nonzero(inb)[0]
    pix = ((y[rows].astype(np.int64) // scale) * render_size
           + x[rows].astype(np.int64) // scale)
    heavy = mass[rows] > np.float32(heavy_weight)
    frame = np.zeros((npix, 4), np.uint8)
    lpix, lrow = pix[~heavy], rows[~heavy]
    count = np.bincount(lpix, minlength=npix)
    last = np.full(npix, -1, np.int64)
    np.maximum.at(last, lpix, lrow)
    lit = last >= 0
    with np.errstate(invalid="ignore", over="ignore"):
        speed = (np.abs(vel[:, 0]) + np.abs(vel[:, 1])) * np.float32(10.0)
    v8 = np.clip(np.nan_to_num(speed, nan=0.0, posinf=255.0, neginf=0.0),
                 0, 255).astype(np.int64)
    tint = 0x10 + np.minimum(v8, 0xEF)
    t = tint[last[lit]]
    frame[lit, 0] = 0xFF
    frame[lit, 1] = 0xFF - t
    frame[lit, 2] = 0xFF - t
    frame[lit, 3] = np.minimum(10 * count[lit], 250)
    frame[np.unique(pix[heavy])] = (0x00, 0xFF, 0x00, 0xFF)
    return frame.reshape(render_size, render_size, 4)
