"""The work split of the Barnes-Hut sweeps (K3 and K4) and the potential
sweep (K6).

K3 (the monopole sweep) spreads each group over blocks of target lanes
times column slices: ``ops/traversal.py:mono_sweep_plan`` picks the lanes
from S alone, each slice takes the runs of 32 columns whose index is its
own modulo the slices, adds their f32 sums in f64, and the block adds the
slices' partials in slice order. K4 and K6 cut their columns (K4) or
sources (K6) into chunks of whole 32-term runs across the grid, write f64
partial sums to one slot per (chunk, target) and fold the slots in chunk
order. The chunk sizes come from ``ops/split.py:chunk_plan``, through
``ops/traversal.py:quad_sweep_plan`` and ``ops/energy.py:potential_plan``,
plain Python that these tests reach. The kernels run only on a card
(chip_smoke.py and tools/sweep_kernel_ab.py hold them to their plain
versions and to the earlier kernels there); here the plans are held to
their contract, and the kernels' order is played back on a small seeded
input against the JAX package's kernels (interpret mode) and the port's
plain versions.

Tolerances: the playback sums in the kernels' order (K3: f32 runs, f64
across them; K4 and K6: every term in f64), the plain versions and the JAX
kernels in f32 in other orders, so they agree within a sum-order error:
1e-5 of Σ_j |c_ij| per target and component for K3, of Σ_j (|dx·w| +
|corr|) for K4, and 1e-5 relative per target for K6 (every potential term
has the sign of −m).
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbody_simulation_tpu.models.scenarios import plummer as jplummer
from nbody_simulation_tpu.ops import energy as jen
from nbody_simulation_tpu.ops import traversal as jtrav
from nbody_simulation_tpu_torch.ops import energy as ten
from nbody_simulation_tpu_torch.ops.force import pair_accel
from nbody_simulation_tpu_torch.ops import split
from nbody_simulation_tpu_torch.ops import traversal as ttrav

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

RUN = 32
SUM_RTOL = 1e-5
SMS = 132  # an H100's SMs; the plans take the resident blocks as numbers


# -- the shared planner -------------------------------------------------------

@pytest.mark.parametrize("items,runs,resident,slot_bytes,bounded", [
    (256, 544, 1188, 1 << 20, True),      # K4 at the CLI's Plummer shape
    (1024, 576, 1188, 4 << 20, True),     # K4 on the θ=0.5 galaxy
    (37, 4736, 264, 1_212_416, False),    # K6 on the galaxy
    (13, 1600, 264, 409_600, False),      # K6 at the P=3 shard shape
    (5, 3, 100, 64, True),                # fewer runs than waves need
    (1, 1, 1, 8, False),
    (3, 100, 7, 100 << 20, False)])       # one chunk's slots past the cap
def test_chunk_plan_is_the_cheapest_allowed(items, runs, resident, slot_bytes,
                                            bounded):
    """Every run lies in one chunk; the slots keep within SLOT_SCRATCH (or
    one chunk's); and the chunk length is the cheapest in the plan's model
    of whole waves, ties to fewer chunks, among the lengths the slots allow
    and, for a bounded grid, no longer than MIN_WAVES waves permit."""
    plan = split.chunk_plan(items, runs, resident, slot_bytes, bounded)
    per = plan.chunk // RUN
    assert plan.chunk % RUN == 0
    assert (plan.chunks - 1) * per < runs <= plan.chunks * per

    def chunks(p):
        return -(-runs // p)

    def cost(p):
        return (-(-(items * chunks(p)) // resident)
                * (p + split.BLOCK_COST_RUNS))

    scratch = max(split.SLOT_SCRATCH, slot_bytes)
    assert plan.chunks * slot_bytes <= scratch
    allowed = [p for p in range(1, runs + 1)
               if chunks(p) * slot_bytes <= scratch]
    if bounded:
        need = -(-split.MIN_WAVES * resident // items)
        wide = [p for p in allowed if p <= -(-runs // need)]
        allowed = wide or [min(allowed)]
    best = min(cost(p) for p in allowed)
    assert cost(per) == best
    assert per == max(p for p in allowed if cost(p) == best)


def test_launch_shape_asks_each_query_once(monkeypatch):
    """``split.launch_shape`` takes a ctypes function (which cannot be
    hashed), asks it once per (query, device, args), and gives the card's
    resident blocks; a failed query raises."""
    out = ctypes.POINTER(ctypes.c_int)
    asked = []

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int, out, out,
                      out)
    def query(s, device, threads, targets, blocks):
        asked.append((s, device))
        threads[0], targets[0], blocks[0] = 128, 2, 0 if s < 0 else 9
        return 0

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    monkeypatch.setattr(split, "_shapes", {})
    shape = split.launch_shape(query, torch.device("cuda", 0), 256)
    assert shape == split.LaunchShape(128, 2, 9, SMS)
    assert shape.resident_blocks == 9 * SMS
    assert split.launch_shape(query, "cuda:0", 256) == shape
    split.launch_shape(query, "cuda:0", 64)
    assert asked == [(256, 0), (64, 0)]
    with pytest.raises(RuntimeError, match="resident blocks"):
        split.launch_shape(query, "cuda:0", -1)


# -- K3 -----------------------------------------------------------------------

MONO_STAGE = 1024  # csrc/grouped_sweep.cu: kMonoStage, columns per staged tile


def _mono_threads(plan, g, s, limits):
    """K3's threads as the kernel runs them: (group, block, slice, its
    targets, its runs in the order it adds them). The slice's runs come
    from the kernel's loop over staged tiles: in the tile at column base,
    slice w starts at local run (w - (base / 32) mod slices) mod slices
    and steps by slices."""
    per_block = plan.lanes * plan.targets
    for gi in range(g):
        limit = int(limits[gi])
        for w in range(plan.slices):
            runs = []
            for base in range(0, limit, MONO_STAGE):
                n = min(MONO_STAGE, limit - base)
                first = (w - (base // RUN) % plan.slices) % plan.slices
                runs += [(base + j0) // RUN
                         for j0 in range(first * RUN, n, plan.slices * RUN)]
            for b in range(plan.tpg):
                for lane in range(plan.lanes):
                    tg = [b * per_block + lane + k * plan.lanes
                          for k in range(plan.targets)]
                    yield gi, b, w, [x for x in tg if x < s], runs


MONO_SHAPES = [
    (1024, 256, 1280),   # the galaxy's θ=50 main path
    (4096, 64, 1472),    # bh_accel_diff on the galaxy
    (1024, 64, 1280),    # a P=4 bh_sharded_accel shard
    (16384, 64, 1600),   # bh_accel_diff on the 1,048,576-body disc
    (8, 2048, 1280),     # S = FOREST_ROW_LEAVES rows
    (2, 256, 3000),      # three staged tiles
    (5, 7, 1), (3, 300, 70), (4, 1, 70), (4, 16, 0)]   # ragged and empty


@pytest.mark.parametrize("g,s,c", MONO_SHAPES)
def test_mono_plan_covers_every_run_once(g, s, c):
    """Every (group, target, 32-column run) below the group's bound is
    summed by exactly one thread, none past it; each thread adds its runs
    in column order; a run's slice does not move with the bound (the
    bounded sweep adds the full sweep's runs, less +0 ones); the block is
    lanes × slices threads. Up to 40 groups are played (the plan does not
    depend on G)."""
    plan = ttrav.mono_sweep_plan(g, s, c, 256, 4)
    assert plan.lanes * plan.slices == plan.threads == 256
    assert plan.lanes & (plan.lanes - 1) == 0
    per_block = plan.lanes * plan.targets
    assert plan.tpg * per_block >= s > (plan.tpg - 1) * per_block
    gp = min(g, 40)
    rng = np.random.default_rng(g + s + c)
    limits = rng.integers(0, c + 1, gp)
    limits[0] = c
    if gp > 1:
        limits[1] = 0
    runs_c = -(-c // RUN)
    cover = np.zeros((gp, s, max(1, runs_c)), dtype=np.int64)
    full = {(gi, w): runs
            for gi, _, w, _, runs in _mono_threads(plan, gp, s, [c] * gp)}
    for gi, _, w, targets, runs in _mono_threads(plan, gp, s, limits):
        assert runs == sorted(runs)
        bound_runs = -(-int(limits[gi]) // RUN)
        assert runs == [r for r in full[gi, w] if r < bound_runs]
        assert all(r % plan.slices == w for r in runs)
        if targets and runs:
            cover[gi][np.ix_(targets, runs)] += 1
    for gi in range(gp):
        bound_runs = -(-int(limits[gi]) // RUN)
        assert (cover[gi, :, :bound_runs] == 1).all()
        assert not cover[gi, :, bound_runs:].any()


def test_mono_plan_depends_on_s_alone():
    """The lanes and slices, so the order of every group's sums, depend on
    S alone: a P-way sharded call (G/P groups) and a bounded or narrower
    call sum a group as the single-device full sweep does; the main
    shapes get several blocks per group or many groups per wave."""
    for s in (1, 7, 64, 256, 300, 2048):
        plans = {ttrav.mono_sweep_plan(g, s, c, 256, 4)
                 for g in (1, 1024, 4096) for c in (0, 70, 1280)}
        assert len(plans) == 1
    gal = ttrav.mono_sweep_plan(1024, 256, 1280, 256, 4)
    assert (gal.lanes, gal.slices, gal.tpg) == (32, 8, 2)
    diff = ttrav.mono_sweep_plan(4096, 64, 1472, 256, 4)
    assert (diff.lanes, diff.slices, diff.tpg) == (16, 16, 1)
    assert ttrav.mono_sweep_plan(8, 2048, 1280, 256, 4).tpg == 16


def _mono_scene(seed):
    rng = np.random.default_rng(seed)
    g, s, c = 4, 40, 300
    tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
    sx, sy = rng.uniform(0, 1e5, (2, g, c)).astype(np.float32)
    sm = rng.integers(1, 100, (g, c)).astype(np.float32)
    sm[0, 3] = 7.5e7  # a heavy node among light ones
    # Bounds: the full width, none, a partial run, a whole number of runs.
    for gi, last in ((1, 0), (2, 77), (3, 160)):
        sm[gi, last:] = 0.0
    sx[0, 0], sy[0, 0] = tgt[0, 0]  # a coincident pair, masked
    return tgt, sx, sy, sm


def test_mono_playback_matches_jax_and_plain():
    """K3's order played back (terms by the plain law; each run summed in
    f32 in column order, a slice's runs in f64 in run order, the slices in
    f64 in slice order, then rounded once) at a plan of 2 slices of 16
    lanes, against JAX ``_grouped_force`` (interpret) and
    ``grouped_force_ref``, within 1e-5 of Σ|c|; a bound of 0 gives +0."""
    tgt, sx, sy, sm = _mono_scene(6)
    g, s, c = sm.shape[0], tgt.shape[1], sm.shape[1]
    tt = [torch.from_numpy(a) for a in (tgt, sx, sy, sm)]
    lim = ttrav.last_nonzero_columns(tt[3])
    assert lim.tolist() == [300, 0, 77, 160]
    plan = ttrav.mono_sweep_plan(g, s, c, 32, 4)
    assert (plan.lanes, plan.slices, plan.tpg) == (16, 2, 1)
    cx, cy = pair_accel(tt[1][:, None, :] - tt[0][:, :, 0:1],
                        tt[2][:, None, :] - tt[0][:, :, 1:2],
                        tt[3][:, None, :], 1e-3)
    # Each run's f32 sum in column order; the columns past the bound and
    # the padding add +0, which leaves an f32 sum bitwise as it is.
    runs_c = -(-c // RUN)
    keep = torch.arange(runs_c * RUN)[None, :] < lim[:, None]
    run_sums = []
    for terms in (cx, cy):
        padded = torch.zeros((g, s, runs_c * RUN), dtype=torch.float32)
        padded[..., :c] = terms
        padded = torch.where(keep[:, None, :], padded, 0.0).reshape(
            g, s, runs_c, RUN)
        acc = torch.zeros((g, s, runs_c), dtype=torch.float32)
        for j in range(RUN):
            acc = acc + padded[..., j]
        run_sums.append(acc)
    part = torch.zeros((plan.slices, g, s, 2), dtype=torch.float64)
    for gi, _, w, targets, runs in _mono_threads(plan, g, s, lim.tolist()):
        for r in runs:  # f64, in the slice's run order
            for k in range(2):
                part[w, gi, targets, k] += run_sums[k][gi, targets, r].double()
    got = torch.zeros((g, s, 2), dtype=torch.float64)
    for w in range(plan.slices):
        got += part[w]
    got = got.float()
    want_jax = np.asarray(jtrav._grouped_force(
        *(jnp.asarray(a) for a in (tgt, sx, sy, sm)), softening2=1e-3,
        rcp="exact", interpret=True))
    want_ref = ttrav.grouped_force_ref(*tt, rcp="exact", col_limit=lim)
    scale = torch.stack([cx.abs().double().sum(-1),
                         cy.abs().double().sum(-1)], -1).numpy()
    for want in (want_jax, want_ref.numpy()):
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert np.all(err <= SUM_RTOL * scale), (err / scale).max()
    assert torch.equal(got[1], torch.zeros(s, 2))  # bound 0: no run, +0
    assert not bool(torch.signbit(got[1]).any())


# -- K4 -----------------------------------------------------------------------

def _quad_blocks(plan, g, s, limits):
    """The blocks of K4's grid that do work, as the kernel runs them:
    (group, first target, end target, first column, end column, chunk).
    A block whose chunk starts at or past the group's bound returns."""
    per_block = plan.threads * plan.targets
    for k in range(plan.chunks):
        for gi in range(g):
            c0 = k * plan.chunk
            if c0 >= limits[gi]:
                continue
            for b in range(plan.tpg):
                yield (gi, b * per_block, min((b + 1) * per_block, s), c0,
                       min(c0 + plan.chunk, limits[gi]), k)


def _fold_chunks(plan, limit):
    """The chunks K4's fold adds for a group bounded at ``limit``."""
    return range(-(-limit // plan.chunk))


@pytest.mark.parametrize("g,s,c,threads,blocks_per_sm", [
    (256, 256, 17408, 128, 9),    # the CLI's θ=0.5 Plummer shape
    (1024, 64, 17408, 32, 32),    # plan_leaves=1
    (1024, 256, 18432, 128, 9),   # the θ=0.5 galaxy
    (5, 7, 1, 32, 4),             # ragged: one column, S below a warp
    (3, 300, 70, 128, 3),         # ragged: S past one block, C past a run
    (4, 16, 0, 32, 8),            # no columns
])
def test_quad_plan_covers_every_run_once(g, s, c, threads, blocks_per_sm):
    """Every (group, target, 32-column run) below the group's bound is
    summed by exactly one block, none past it; the chunks the fold adds are
    those the kernel wrote, in column order; the slots fit their bound."""
    plan = ttrav.quad_sweep_plan(g, s, c, threads, 2, blocks_per_sm * SMS)
    assert plan.chunk % RUN == 0 and plan.chunk > 0
    assert plan.chunks * plan.chunk >= c > (plan.chunks - 1) * plan.chunk \
        or plan.chunks == c == 0
    assert plan.chunks * g * s * 16 <= split.SLOT_SCRATCH
    assert plan.chunks <= split.MAX_CHUNKS
    assert plan.tpg * threads * 2 >= s > (plan.tpg - 1) * threads * 2
    rng = np.random.default_rng(g + s + c)
    limits = rng.integers(0, c + 1, g)
    limits[0] = c
    if g > 1:
        limits[1] = 0
    cover = np.zeros((g, -(-c // RUN)), dtype=np.int64)
    targets = np.zeros((g, s), dtype=np.int64)
    written = np.zeros((g, plan.chunks), dtype=bool)
    for gi, s0, s1, c0, c1, k in _quad_blocks(plan, g, s, limits):
        assert c0 % RUN == 0 and c0 < c1 <= limits[gi]
        assert k == c0 // plan.chunk  # a run lies in one chunk: column order
        if s0 == 0:
            cover[gi, c0 // RUN:-(-c1 // RUN)] += 1
        if k == 0:
            targets[gi, s0:s1] += 1
        written[gi, k] = True
    for gi in range(g):
        runs = -(-int(limits[gi]) // RUN)
        assert (cover[gi, :runs] == 1).all() and not cover[gi, runs:].any()
        assert (targets[gi] == (1 if runs else 0)).all()
        assert (np.flatnonzero(written[gi]).tolist()
                == list(_fold_chunks(plan, limits[gi])))


@pytest.mark.parametrize("g,s,c,threads,blocks_per_sm", [
    (256, 256, 17408, 128, 9), (1024, 64, 17408, 32, 32),
    (1024, 256, 18432, 128, 9)])
def test_quad_plan_makes_many_waves_at_the_main_shapes(g, s, c, threads,
                                                       blocks_per_sm):
    """The θ<2 shapes' full grids hold about MIN_WAVES waves of resident
    blocks (one block per group left the CLI's shape one partial wave)."""
    resident = blocks_per_sm * SMS
    plan = ttrav.quad_sweep_plan(g, s, c, threads, 2, resident)
    waves = g * plan.tpg * plan.chunks / resident
    assert split.MIN_WAVES * 0.75 <= waves <= split.MIN_WAVES * 1.5
    assert ttrav.quad_sweep_plan(g, s, c, threads, 2, resident) == plan


def _quad_scene(seed):
    rng = np.random.default_rng(seed)
    g, s, c = 4, 40, 300
    tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
    sx, sy = rng.uniform(0, 1e5, (2, g, c)).astype(np.float32)
    sm = rng.integers(0, 100, (g, c)).astype(np.float32)
    q = [(sm * rng.uniform(0, 4e6, (g, c))).astype(np.float32)
         for _ in range(3)]
    q[1] = (q[1] - sm * 2e6).astype(np.float32)
    # Bounds: the full width, none, a partial run, and a column that acts
    # through its moments alone past the last mass.
    for gi, last in ((1, 0), (2, 77), (3, 150)):
        sm[gi, last:] = 0.0
        for a in q:
            a[gi, last:] = 0.0
    q[0][3, 201], q[1][3, 201], q[2][3, 201] = 5e9, -2e9, 3e9
    sx[0, 0], sy[0, 0] = tgt[0, 0]  # a coincident pair, masked
    return tgt, sx, sy, sm, q


def test_quad_chunked_playback_matches_jax_and_plain():
    """K4's order played in f64 (terms by the plain law, summed per block
    over its chunk, then folded in chunk order) at a plan that cuts C=300
    into chunks of 64, against JAX ``_grouped_force`` (interpret) and
    ``grouped_force_ref``, within 1e-5 of Σ(|dx·w| + |corr|)."""
    tgt, sx, sy, sm, q = _quad_scene(5)
    g, s, c = sm.shape[0], tgt.shape[1], sm.shape[1]
    tt = [torch.from_numpy(a) for a in (tgt, sx, sy, sm)]
    tq = tuple(torch.from_numpy(a) for a in q)
    lim = ttrav.last_nonzero_columns(tt[3], tq)
    assert lim.tolist() == [300, 0, 77, 202]
    plan = ttrav.quad_sweep_plan(g, s, c, 32, 2, 2)
    assert plan.chunk == 64 and plan.chunks == 5 and plan.tpg == 1
    dx = tt[1][:, None, :] - tt[0][:, :, 0:1]
    dy = tt[2][:, None, :] - tt[0][:, :, 1:2]
    terms = [a.double() for a in ttrav.quad_tile(
        dx, dy, tt[3][:, None, :], *(a[:, None, :] for a in tq))]
    slots = torch.zeros((plan.chunks, g, s, 2), dtype=torch.float64)
    written = set()
    for gi, s0, s1, c0, c1, k in _quad_blocks(plan, g, s, lim.tolist()):
        for comp in range(2):
            slots[k, gi, s0:s1, comp] = terms[comp][gi, s0:s1, c0:c1].sum(-1)
        written.add((k, gi))
    out = torch.zeros((g, s, 2), dtype=torch.float64)
    for gi in range(g):
        for k in _fold_chunks(plan, int(lim[gi])):
            assert (k, gi) in written
            out[gi] += slots[k, gi]
    got = out.float()
    want_jax = np.asarray(jtrav._grouped_force(
        *(jnp.asarray(a) for a in (tgt, sx, sy, sm)), softening2=1e-3,
        rcp="exact", interpret=True, src_q=tuple(jnp.asarray(a) for a in q)))
    want_ref = ttrav.grouped_force_ref(*tt, rcp="exact", col_limit=lim,
                                       src_q=tq)
    z = torch.zeros_like(dx)
    mono = ttrav.quad_tile(dx, dy, tt[3][:, None, :], z, z, z)
    corr = ttrav.quad_tile(dx, dy, z, *(a[:, None, :] for a in tq))
    scale = torch.stack([(a.abs().double() + b.abs().double()).sum(-1)
                         for a, b in zip(mono, corr)], -1).numpy()
    for want in (want_jax, want_ref.numpy()):
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert np.all(err <= SUM_RTOL * scale), (err / scale).max()
    assert torch.equal(got[1], torch.zeros(s, 2))  # bound 0: no chunk, +0
    assert not bool(torch.signbit(got[1]).any())


# -- K6 -----------------------------------------------------------------------

def _pot_blocks(plan, ni, nj):
    """K6's blocks as the kernel runs them: (first target, end target,
    first source, end source, chunk)."""
    tpb = plan.targets_per_block
    for k in range(plan.chunks):
        for b in range(plan.target_blocks):
            yield (b * tpb, min((b + 1) * tpb, ni), k * plan.chunk,
                   min((k + 1) * plan.chunk, nj), k)


@pytest.mark.parametrize("ni,nj,per_block,blocks_per_sm", [
    (151_552, 151_552, 4096, 2), (151_552, 151_552, 1024, 8),  # the galaxy
    (51_200, 51_200, 4096, 2), (51_200, 51_200, 1024, 4),  # P=3's shards
    (300, 700, 4096, 2), (200, 200, 1024, 8), (1, 33, 4096, 2),
    (5, 0, 4096, 2), (5000, 3000, 1024, 3)])
def test_potential_plan_covers_every_pair_once(ni, nj, per_block,
                                               blocks_per_sm):
    """Every (target, source) pair is summed by exactly one block; chunks
    are whole runs in source order; the slots fit their bound."""
    plan = ten.potential_plan(ni, nj, per_block, blocks_per_sm * SMS)
    assert plan.chunk % RUN == 0 and plan.chunk > 0
    assert plan.chunks * plan.chunk >= nj > (plan.chunks - 1) * plan.chunk \
        or plan.chunks == nj == 0
    assert plan.chunks * ni * 8 <= split.SLOT_SCRATCH
    assert (plan.target_blocks * per_block >= ni
            > (plan.target_blocks - 1) * per_block)
    cover = np.zeros(-(-nj // RUN), dtype=np.int64)
    rows = np.zeros(ni, dtype=np.int64)
    for i0, i1, j0, j1, k in _pot_blocks(plan, ni, nj):
        assert j0 % RUN == 0 and j0 < j1 and k == j0 // plan.chunk
        if i0 == 0:
            cover[j0 // RUN:-(-j1 // RUN)] += 1
        if j0 == 0:
            rows[i0:i1] += 1
    assert (cover == 1).all() and (rows == (1 if nj else 0)).all()


@pytest.mark.parametrize("ni,per_block,blocks_per_sm", [
    (151_552, 4096, 2), (151_552, 4096, 3), (151_552, 2048, 4),
    (151_552, 1024, 8), (51_200, 4096, 2), (51_200, 4096, 3),
    (51_200, 2048, 4), (51_200, 1024, 8)])
def test_potential_plan_makes_whole_waves(ni, per_block, blocks_per_sm):
    """At the galaxy and at the P=3 ring's shard shape the grid ends within
    5% of a whole wave of resident blocks (one thread per target left the
    galaxy half a wave and the shards 200 blocks)."""
    resident = blocks_per_sm * SMS
    plan = ten.potential_plan(ni, ni, per_block, resident)
    waves = plan.target_blocks * plan.chunks / resident
    assert waves >= 0.95 and -(-waves // 1) - waves <= 0.05


def test_potential_chunked_playback_matches_jax_and_plain():
    """K6's order played in f64 on ragged Ni=300, Nj=700 with a zero-mass
    tail and a coincident pair, at a plan of chunks of 96 sources, against
    JAX ``allpairs_potential`` (interpret) and the plain version."""
    tgt = jplummer(300, seed=1)
    src = jplummer(700, seed=2)
    tp = torch.tensor(np.asarray(tgt.pos))
    sp = torch.tensor(np.asarray(src.pos))
    sm = torch.tensor(np.asarray(src.mass))
    sm[650:] = 0.0
    sp[3] = tp[3]
    plan = ten.potential_plan(300, 700, 256, 16)
    assert (plan.chunk, plan.chunks, plan.target_blocks) == (96, 8, 2)
    terms = ten.pot_tile(sp[None, :, 0] - tp[:, 0:1],
                         sp[None, :, 1] - tp[:, 1:2], sm[None, :]).double()
    slots = torch.zeros((plan.chunks, 300), dtype=torch.float64)
    for i0, i1, j0, j1, k in _pot_blocks(plan, 300, 700):
        slots[k, i0:i1] = terms[i0:i1, j0:j1].sum(-1)
    got = slots.sum(0).float()  # the fold: chunk order
    want_jax = np.asarray(jen.allpairs_potential(
        jnp.asarray(tp.numpy()), None, src_pos=jnp.asarray(sp.numpy()),
        src_mass=jnp.asarray(sm.numpy()), tile_i=128, tile_j=256,
        interpret=True))
    want_ref = ten.allpairs_potential_ref(tp, None, sp, sm)
    for want in (want_jax, want_ref.numpy()):
        np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL)


# -- the wrappers -------------------------------------------------------------

def test_wrappers_and_plans_refuse_what_they_cannot_run():
    t, s = torch.zeros(2, 4, 2), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ttrav.grouped_sweep(t, s, s, s, src_q=(s, s, s))
    for bad in (t, t.to("meta")):  # K3 as well: no device but CUDA
        with pytest.raises(ValueError, match="CUDA"):
            ttrav.grouped_sweep(bad, s, s, s, col_limit=torch.zeros(
                2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.mono_sweep_plan(0, 64, 100, 256, 4)
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.mono_sweep_plan(4, 0, 100, 256, 4)
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.mono_sweep_plan(4, 64, -1, 256, 4)
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.mono_sweep_plan(4, 64, 100, 192, 4)  # not a power of two
    p, m = torch.zeros(6, 2), torch.zeros(6)
    with pytest.raises(ValueError, match="CUDA"):
        ten.potential_cuda(p, p, m)
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.quad_sweep_plan(0, 64, 100, 32, 2, 528)
    with pytest.raises(ValueError, match="bad shape"):
        ttrav.quad_sweep_plan(4, 64, -1, 32, 2, 528)
    with pytest.raises(ValueError, match="bad shape"):
        ten.potential_plan(10, 10, 1024, 0)
    with pytest.raises(ValueError, match="bad shape"):
        ten.potential_plan(-1, 10, 1024, 528)
    with pytest.raises(ValueError, match="bad shape"):
        split.chunk_plan(4, 10, 528, 0, True)
