"""The port's all-pairs kernels' plain versions against the JAX package.

The CUDA kernels (``csrc/allpairs.cu``) run only on a card; chip_smoke.py
holds them to the plain versions there. On the CPU ``allpairs_accel`` and
``allpairs_accel_sym`` run the plain versions, which these tests hold to
the JAX kernels in interpret mode (exact reciprocal), as the JAX package's
own tests run them.

Tolerance: the two packages sum the same pair terms in another order, so
|Δa| ≤ 1e-5 · Σ_j |c_ij| per target and component (a per-target relative
error is ill-conditioned where forces cancel).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_simulation_tpu.ops import allpairs as jap
from nbody_simulation_tpu_torch import cuda_build
from nbody_simulation_tpu_torch.config import RCP_MODES
from nbody_simulation_tpu_torch.ops import allpairs as tap
from nbody_simulation_tpu_torch.ops.force import pair_accel
from nbody_simulation_tpu_torch.state import ParticleState

# The suite runs in several worker processes at once: keep torch's CPU
# thread pool small so the workers do not oversubscribe the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUM_RTOL = 1e-5


def cloud(seed, n):
    """Uniform positions in [0, 1e5)², masses 1..99, one 7.5e7 body."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100_000, size=(n, 2)).astype(np.float32)
    mass = rng.integers(1, 100, size=n).astype(np.float32)
    mass[0] = 75_000_000.0
    return pos, mass


def abs_scale(tpos, spos, smass):
    """Σ_j |c_ij| per target and component (float64)."""
    t, s = torch.tensor(tpos, dtype=torch.float64), torch.tensor(
        spos, dtype=torch.float64)
    ax, ay = pair_accel(s[None, :, 0] - t[:, 0:1], s[None, :, 1] - t[:, 1:2],
                        torch.tensor(smass, dtype=torch.float64)[None, :])
    return np.stack([ax.abs().sum(1).numpy(), ay.abs().sum(1).numpy()], 1)


def close_in_sum(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= SUM_RTOL * scale), (err / np.maximum(scale, 1e-300)
                                             ).max()


@pytest.fixture(scope="module")
def cloud768():
    pos, mass = cloud(0, 768)
    return pos, mass, abs_scale(pos, pos, mass)


@pytest.mark.parametrize("tile", [768, 384, 256, 128])  # nt = 1, 2, 3, 6
def test_sym_matches_jax(cloud768, tile):
    """Tile-count parities of the JAX tournament: nt=1 (diagonal only), even
    nt (masked duplicate round), odd nt."""
    pos, mass, scale = cloud768
    want = np.asarray(jap.allpairs_accel_sym(jnp.asarray(pos),
                                             jnp.asarray(mass), tile=tile,
                                             interpret=True))
    got = tap.allpairs_accel_sym(torch.tensor(pos), torch.tensor(mass),
                                 tile=tile)
    close_in_sum(got.numpy(), want, scale)


@pytest.mark.parametrize("tile", [768, 384, 256, 128])  # nt = 1, 2, 3, 6
def test_ordered_matches_jax(cloud768, tile):
    pos, mass, scale = cloud768
    want = np.asarray(jap.allpairs_accel(jnp.asarray(pos), jnp.asarray(mass),
                                         tile_i=tile, tile_j=tile,
                                         interpret=True))
    got = tap.allpairs_accel(torch.tensor(pos), torch.tensor(mass),
                             tile_i=tile, tile_j=tile)
    close_in_sum(got.numpy(), want, scale)


def test_ordered_with_other_sources_matches_jax():
    pos, _ = cloud(1, 256)
    spos, smass = cloud(2, 512)
    want = np.asarray(jap.allpairs_accel(
        jnp.asarray(pos), None, jnp.asarray(spos), jnp.asarray(smass),
        tile_i=128, tile_j=256, interpret=True))
    got = tap.allpairs_accel(torch.tensor(pos), None, torch.tensor(spos),
                             torch.tensor(smass), tile_i=128, tile_j=256)
    close_in_sum(got.numpy(), want, abs_scale(pos, spos, smass))


def test_zero_mass_padding_is_inert():
    pos, mass = cloud(3, 200)
    st = ParticleState.create(pos, np.zeros_like(pos), mass).pad_to(128)
    scale = abs_scale(pos, pos, mass)
    small = tap.allpairs_accel_ref(torch.tensor(pos), torch.tensor(mass))
    sym = tap.allpairs_accel_sym(st.pos, st.mass, tile=128)
    ordered = tap.allpairs_accel(st.pos, st.mass, tile_i=64, tile_j=128)
    assert st.n == 256
    close_in_sum(sym[:200].numpy(), small.numpy(), scale)
    close_in_sum(ordered[:200].numpy(), small.numpy(), scale)
    assert torch.isfinite(sym).all() and torch.isfinite(ordered).all()


@pytest.mark.parametrize("call", [
    lambda p, m: tap.allpairs_accel(p, m, tile_i=128, tile_j=128),
    lambda p, m: tap.allpairs_accel(p, m, tile_i=64, tile_j=96),
    lambda p, m: tap.allpairs_accel_sym(p, m, tile=128),
    lambda p, m: tap.allpairs_accel_sym(p[:192], m[:192], tile=192,
                                        strips=5),
    lambda p, m: tap.allpairs_accel(p, m, tile_i=40, tile_j=40, rcp="fast"),
    lambda p, m: tap.allpairs_accel_sym(p, m, tile=40, rcp="exact+clamp"),
])
def test_indivisible_n_or_unknown_rcp_raises(call):
    pos, mass = cloud(4, 200)
    with pytest.raises(ValueError):
        call(torch.tensor(pos), torch.tensor(mass))


def test_every_rcp_mode_runs_exact_on_the_cpu():
    """As in the JAX package's CPU path, every mode is accepted and the
    plain version computes ``exact``."""
    pos, mass = (torch.tensor(a) for a in cloud(5, 256))
    want_o = tap.allpairs_accel(pos, mass, tile_i=64, tile_j=128,
                                rcp="exact")
    want_s = tap.allpairs_accel_sym(pos, mass, tile=64, rcp="exact")
    for rcp in RCP_MODES:
        assert torch.equal(tap.allpairs_accel(pos, mass, tile_i=64,
                                              tile_j=128, rcp=rcp), want_o)
        assert torch.equal(tap.allpairs_accel_sym(pos, mass, tile=64,
                                                  rcp=rcp), want_s)


@pytest.mark.parametrize("rcp", ["exact", "newton+clamp"])
def test_nan_pattern_matches_jax(rcp):
    """One NaN x-coordinate: the symmetric law's d·(m·0) makes every row's
    x NaN and keeps every y finite (the NaN particle's y at 0); the ordered
    law selects 0 for masked pairs, so every row stays finite and the NaN
    particle's row is 0. On the CPU both packages compute ``exact`` in every
    mode, a +clamp mode included; on a card the +clamp modes propagate the
    NaN to every component instead (chip_smoke.py holds the kernels to
    that)."""
    pos, mass = cloud(6, 256)
    pos[5, 0] = np.nan
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    tp, tm = torch.tensor(pos), torch.tensor(mass)
    want_s = np.asarray(jap.allpairs_accel_sym(jp, jm, tile=64, rcp=rcp,
                                               interpret=True))
    want_o = np.asarray(jap.allpairs_accel(jp, jm, tile_i=64, tile_j=128,
                                           rcp=rcp, interpret=True))
    got_s = tap.allpairs_accel_sym(tp, tm, tile=64, rcp=rcp).numpy()
    got_o = tap.allpairs_accel(tp, tm, tile_i=64, tile_j=128,
                               rcp=rcp).numpy()
    assert np.isnan(want_s[:, 0]).all() and np.isfinite(want_s[:, 1]).all()
    np.testing.assert_array_equal(np.isnan(got_s), np.isnan(want_s))
    assert got_s[5, 1] == want_s[5, 1] == 0.0
    assert np.isfinite(want_o).all() and np.isfinite(got_o).all()
    np.testing.assert_array_equal(got_o[5], want_o[5])
    pos[5, 0] = 0.0
    scale = abs_scale(pos, pos, mass)
    close_in_sum(got_s[:, 1], want_s[:, 1], scale[:, 1])
    close_in_sum(got_o, want_o, scale)


def test_only_cpu_runs_the_plain_version():
    pos, mass = (torch.tensor(a) for a in cloud(7, 128))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tap.allpairs_cuda(pos, pos, mass)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tap.allpairs_sym_cuda(pos, mass)
    meta_p, meta_m = pos.to("meta"), mass.to("meta")
    with pytest.raises(ValueError, match="device meta"):
        tap.allpairs_accel(meta_p, meta_m)
    with pytest.raises(ValueError, match="device meta"):
        tap.allpairs_accel_sym(meta_p, meta_m)
    assert tap.allpairs_cuda.launches == 0
    assert tap.allpairs_sym_cuda.launches == 0


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` changes every library's build key, so a stale
    ``.so`` is never loaded; an unrelated edit elsewhere does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = {n: cuda_build.library_path(n)
              for n in ("allpairs", "grouped_sweep")}
    (tmp_path / "notes.txt").write_text("not a source")
    assert {n: cuda_build.library_path(n) for n in before} == before
    header = csrc / "pair_law.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("allpairs") != after["allpairs"]


def _run_schedule(sch, pos_i, mass_i, pos_j, mass_j, tile, self_pairs):
    """The kernels' schedule played in float64 on tiles of ``tile``
    particles: each block's i-side and j-side sums into its launch's slots
    (NaN where no block wrote), then the fold in round order. Returns the i
    side and the j side."""
    n = len(pos_i)
    nt = sch.fold.shape[1]
    pad = nt * tile - n

    def padded(a):
        a = torch.tensor(a, dtype=torch.float64)
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    pi, mi, pj, mj = (padded(a) for a in (pos_i, mass_i, pos_j, mass_j))
    acc_i = torch.zeros((nt * tile, 2), dtype=torch.float64)
    acc_j = torch.zeros_like(acc_i)
    for first, count, k0, rounds in sch.launches:
        slot_i = torch.full((rounds, nt * tile, 2), float("nan"),
                            dtype=torch.float64)
        slot_j = slot_i.clone()
        for k, a, b, s in sch.blocks[first:first + count]:
            ia, jb = slice(a * tile, (a + 1) * tile), slice(b * tile,
                                                            (b + 1) * tile)
            dx = pj[None, jb, 0] - pi[ia, None, 0]
            dy = pj[None, jb, 1] - pi[ia, None, 1]
            kr = tap.sym_r(dx, dy)
            wi, wj = mj[None, jb] * kr, mi[ia, None] * kr
            slot_i[s, ia] = torch.stack([(dx * wi).sum(1), (dy * wi).sum(1)],
                                        1)
            if not (self_pairs and k == 0):
                slot_j[s, jb] = torch.stack([(dx * wj).sum(0),
                                             (dy * wj).sum(0)], 1)
        for s in range(rounds):
            bits = torch.tensor(sch.fold[k0 + s]).repeat_interleave(tile)
            acc_i += torch.where((bits & 1).bool()[:, None], slot_i[s], 0.0)
            acc_j -= torch.where((bits & 2).bool()[:, None], slot_j[s], 0.0)
    return acc_i[:n].numpy(), acc_j[:n].numpy()


@pytest.mark.parametrize("rounds_per_launch", [1, 3, 64])
@pytest.mark.parametrize("nt", [1, 2, 3, 8, 9, 200])
def test_sym_schedule_pairs_each_tile_pair_once(nt, rounds_per_launch):
    """The table the symmetric round kernel runs (K2: ``self_pairs``; K9):
    every tile pair exactly once (K2: unordered, the diagonal i side only),
    no two blocks of a launch on the same i or j slot entry, the fold bits
    exactly the slots written, and the fold in round order. Up to nt=9,
    the schedule played in float64 on small tiles gives the plain sums."""
    for self_pairs in (True, False):
        sch = tap.sym_schedule(nt, rounds_per_launch, self_pairs)
        k, ti, tj, slot = sch.blocks.T
        diag = (k == 0) if self_pairs else np.zeros(len(k), bool)
        if self_pairs:
            assert (ti[diag] == tj[diag]).all()
            assert np.array_equal(np.sort(ti[diag]), np.arange(nt))
            lo, hi = np.minimum(ti, tj)[~diag], np.maximum(ti, tj)[~diag]
            assert (lo < hi).all()
            a, b = np.triu_indices(nt, 1)
            assert np.array_equal(np.sort(lo * nt + hi), a * nt + b)
        else:
            assert np.array_equal(np.sort(ti * nt + tj), np.arange(nt * nt))
        first, count, k0, rounds = sch.launches.T
        assert np.array_equal(first, np.cumsum(count) - count)
        assert first[-1] + count[-1] == len(k)
        assert np.array_equal(k0, np.cumsum(rounds) - rounds)
        assert k0[-1] + rounds[-1] == len(sch.fold)
        assert (rounds <= rounds_per_launch).all()
        for f, c, r0, r in sch.launches:
            rows = slice(f, f + c)
            # Round order within the launch, and slot = round - first round.
            assert (np.diff(k[rows]) >= 0).all()
            assert np.array_equal(slot[rows], k[rows] - r0)
            assert ((slot[rows] >= 0) & (slot[rows] < r)).all()
            i_entries = slot[rows] * nt + ti[rows]
            j_entries = (slot[rows] * nt + tj[rows])[~diag[rows]]
            assert len(np.unique(i_entries)) == len(i_entries)
            assert len(np.unique(j_entries)) == len(j_entries)
        written = np.zeros_like(sch.fold)
        np.bitwise_or.at(written, (k, ti), 1)
        np.bitwise_or.at(written, (k[~diag], tj[~diag]), 2)
        assert np.array_equal(sch.fold, written)
        if nt > 9:
            continue
        tile = 4
        n = nt * tile - 1  # a ragged last tile
        pos, mass = cloud(nt, n)
        if self_pairs:
            got_i, got_j = _run_schedule(sch, pos, mass, pos, mass, tile,
                                         True)
            close_in_sum(got_i + got_j, tap.allpairs_accel_sym_ref(
                torch.tensor(pos), torch.tensor(mass)).numpy(),
                abs_scale(pos, pos, mass))
        else:
            pos_j, mass_j = cloud(nt + 100, n)
            got = _run_schedule(sch, pos, mass, pos_j, mass_j, tile, False)
            want = tap.allpairs_accel_sym_pair_ref(
                *(torch.tensor(a) for a in (pos, mass, pos_j, mass_j)))
            close_in_sum(got[0], want[0].numpy(),
                         abs_scale(pos, pos_j, mass_j))
            close_in_sum(got[1], want[1].numpy(),
                         abs_scale(pos_j, pos, mass))


@pytest.mark.parametrize("nt, self_pairs, resident, want", [
    # 12 resident blocks per SM on 132 SMs, as the round kernel has on an
    # H100 (chip_smoke.py prints it).
    (592, True, 1584, 43),     # the galaxy: 297 rounds in 7 launches
    (200, False, 1584, 100),   # K9 at L=51,200: 2 launches of 100 rounds
    (4096, True, 1584, 7),     # N=1M: 16 waves in 7 rounds
    (4096, True, 1 << 20, 8),  # bounded by the slots' bytes instead
    (1, True, 1584, 1),
])
def test_sym_rounds_per_launch(nt, self_pairs, resident, want):
    r = tap.sym_rounds_per_launch(nt, self_pairs, resident)
    assert r == want
    assert 2 * r * nt * tap.SYM_TILE * 16 <= max(
        tap.split.SLOT_SCRATCH, 2 * nt * tap.SYM_TILE * 16)
