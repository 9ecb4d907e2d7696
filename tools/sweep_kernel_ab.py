#!/usr/bin/env python3
"""A/B of the monopole Barnes-Hut sweep (K3) on one card, with K1, K4 and K6
held bitwise.

    python3 tools/sweep_kernel_ab.py PARENT_DIR [--mono 4:256 ...]
        [--against DIR ...] [--dump DIR] [--out FILE]

Run from the root of the repository. PARENT_DIR holds a checkout of an
earlier commit (``git archive <commit> | tar -x -C PARENT_DIR``) whose
``csrc/grouped_sweep.cu`` runs K3 as one block per group
(``grouped_sweep_launch`` without the lanes and fast-form arguments, e.g.
commit 3d9ebc3) and whose K4 and K6 have this tree's C interface. The
script builds the parent's two sources, this tree's ``csrc/allpairs.cu``,
and this tree's ``csrc/grouped_sweep.cu`` once for each ``--mono
TARGETS:THREADS[:MIN_BLOCKS]`` (K3's ``kMonoTargets``, ``kMonoThreads``,
``kMonoMinBlocks``; 4:256 by default), and with ``--against DIR ...`` each
DIR's ``grouped_sweep.cu`` as it is (this tree's C interface), all at
once. Each K3 build runs on the grid of ``ops/traversal.py:
mono_sweep_plan``, and on the same inputs the script:

- holds each K3 variant at the galaxy's θ=50 shape (G=1024, S=256, C=1280)
  in all five rcp modes, at ``bh_accel_diff``'s galaxy shape (G=4096, S=64)
  in newton and approx, and at ragged shapes (S of 1, 7, 300 and 2048, C of
  0, 1 and 70): bounded == full, two calls and the general law alone
  (``allow_fast=False``) bitwise, within 1e-5·Σ|c| of the plain version,
  and the outputs that differ from the parent's and their max |Δ|/Σ|c|;
- holds each variant bitwise to its general law alone on special inputs: a
  NaN and an inf coordinate, |x| = 2^50, a coincident pair, a pair whose
  denominator lies in [2^-128, 2^-126), an inf mass, and a tiny softening;
- holds this tree's K1 (the ordered force sweep: the all-pairs galaxy and
  small N, five modes), K4 (the θ=0.5 Plummer shape in five modes, the θ=0.5
  galaxy in newton; full and bounded) and K6 (the galaxy and the P=3 shard)
  bitwise to the parent's;
- times K3 in turns (CUDA events: parent, variants, variants reversed,
  parent) on the galaxy at rcp=approx bounded and full and at exact
  bounded, and at ``bh_accel_diff``'s shape at newton bounded;
- prints each build's registers and spills (``-Xptxas -v``), K3's resident
  blocks per SM and grids, and the hot loop's instructions per pair
  (``cuobjdump -sass``, as chip_smoke.py counts them);
- with ``--dump DIR``, writes each build's SASS to DIR.

Prints one JSON object as its last line and, with ``--out FILE``, writes
it to FILE. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

from _ab_common import (CSRC, MODES, SOFTENING2, build_all, card_log,
                        dump_sass, finish, in_turns, sass_per_pair)

# Kernels whose registers ptxas reports, by their mangled names' stems.
PTXAS_KERNELS = "grouped_sweep_kernelILi[12]E|quad_sweep_kernelILi1E"
SUM_RTOL = 1e-5


def main() -> int:
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.scenarios import galaxy, plummer
    from nbody_simulation_tpu_torch.ops import allpairs as ap
    from nbody_simulation_tpu_torch.ops import energy as en
    from nbody_simulation_tpu_torch.ops import split
    from nbody_simulation_tpu_torch.ops import traversal as tr
    from nbody_simulation_tpu_torch.ops.force import pair_accel
    from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
    from nbody_simulation_tpu_torch.ops.tree import (build_tree,
                                                     summarize_sorted)

    parser = argparse.ArgumentParser()
    parser.add_argument("parent", type=Path)
    parser.add_argument("--mono", nargs="+", default=["4:256"],
                        help="K3 builds as kMonoTargets:kMonoThreads"
                        "[:kMonoMinBlocks]")
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="checkouts whose csrc/ has this tree's C "
                        "interface, built as they are")
    parser.add_argument("--dump", type=Path,
                        help="directory for each build's SASS")
    parser.add_argument("--out", type=Path, help="file for the report")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_kernel_ab: needs a CUDA card")
    card, log = card_log()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- builds ----------------------------------------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="sweep_ab_"))
    parent_csrc = args.parent / "nbody_simulation_tpu_torch" / "csrc"
    jobs = {"sweep:parent": (parent_csrc, "grouped_sweep", {}),
            "allpairs:parent": (parent_csrc, "allpairs", {}),
            "allpairs:new": (CSRC, "allpairs", {})}
    for spec in args.mono:
        keys = ("kMonoTargets", "kMonoThreads", "kMonoMinBlocks")
        subst = dict(zip(keys, (int(v) for v in spec.split(":"))))
        jobs[f"sweep:T{spec.replace(':', 'x', 1).replace(':', '-')}"] = (
            CSRC, "grouped_sweep", subst)
    for d in args.against:
        jobs[f"sweep:@{d.name}"] = (d / "nbody_simulation_tpu_torch" / "csrc",
                                    "grouped_sweep", {})
    built = build_all(jobs, PTXAS_KERNELS, tmp)
    log(f"built {list(built)} in {time.perf_counter() - t_start:.1f} s")
    report = {"card": card, "builds": {}, "checks": {}, "ms": {}}
    for k, (_, info) in built.items():
        report["builds"][k] = {"ptxas": info}
        log(f"{k} ptxas: " + " | ".join(info))

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    libs = {k: ctypes.CDLL(str(v[0])) for k, v in built.items()}
    sweeps = {k.split(":", 1)[1]: tr._bind_sweep(v) for k, v in libs.items()
              if k.startswith("sweep:") and k != "sweep:parent"}
    # The parent's K3 launch has the one-block-per-group signature; its K4
    # launch and shape query have this tree's.
    psweep = libs["sweep:parent"]
    psweep.grouped_sweep_launch.restype = ctypes.c_int
    psweep.grouped_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    ref = next(iter(sweeps.values()))
    for name in ("quad_sweep_launch", "quad_sweep_shape"):
        fn, ours = getattr(psweep, name), getattr(ref, name)
        fn.restype, fn.argtypes = ours.restype, ours.argtypes
    pall, nall = (ap._bind(libs[k]) for k in ("allpairs:parent",
                                              "allpairs:new"))

    def ptr(t):
        return None if t is None else t.data_ptr()

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    # -- the kernels -----------------------------------------------------------
    def parent_k3(tgt, sx, sy, sm, lim, mode):
        g, s, _ = tgt.shape
        out = torch.empty_like(tgt)
        check(psweep.grouped_sweep_launch(
            ptr(tgt), ptr(sx), ptr(sy), ptr(sm), ptr(lim), ptr(out), g, s,
            sx.shape[1], SOFTENING2, mode, 0, stream()), "parent K3")
        return out

    def plan_of(build, g, s, c, mode):
        shape = split.launch_shape(sweeps[build].grouped_sweep_shape, dev, s,
                                   mode)
        return tr.mono_sweep_plan(g, s, c, shape.threads, shape.targets)

    def new_k3(build, tgt, sx, sy, sm, lim, mode, soft2=SOFTENING2,
               fast=True):
        plan = plan_of(build, *tgt.shape[:2], sx.shape[1], mode)
        err, out = tr.mono_sweep(sweeps[build], tgt, sx, sy, sm, lim, soft2,
                                 mode, plan.lanes, allow_fast=fast)
        check(err, f"K3 {build}")
        return out

    def k4(lib, tgt, sx, sy, sm, sq, lim, mode):
        shape = split.launch_shape(lib.quad_sweep_shape, dev, tgt.shape[1],
                                   mode)
        plan = tr.quad_sweep_plan(*tgt.shape[:2], sx.shape[1], shape.threads,
                                  shape.targets, shape.resident_blocks)
        err, out = tr.quad_sweep_chunked(lib, tgt, sx, sy, sm, sq, lim,
                                         SOFTENING2, mode, plan.chunk)
        check(err, "K4")
        return out

    def k1(lib, pos, mass, mode):
        out = torch.empty_like(pos)
        check(lib.allpairs_launch(ptr(pos), ptr(pos), ptr(mass), ptr(out),
                                  pos.shape[0], pos.shape[0], SOFTENING2,
                                  mode, 0, stream()), "K1")
        return out

    def k6(lib, pi, pj, mj):
        shape = split.launch_shape(lib.potential_shape, dev, SOFTENING2)
        plan = en.potential_plan(pi.shape[0], pj.shape[0],
                                 shape.threads * shape.targets,
                                 shape.resident_blocks)
        err, out = en.potential_chunked(lib, pi, pj, mj, SOFTENING2,
                                        plan.chunk)
        check(err, "K6")
        return out

    def same(a, b):
        torch.cuda.synchronize()
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def n_diff(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    def abs_sum(tgt, sx, sy, sm, lim):
        """Σ_j |c_ij| below each group's bound, per target and component."""
        out = torch.empty_like(tgt)
        c = sx.shape[1]
        chunk = max(1, (1 << 24) // max(1, tgt.shape[1] * c))
        cols = torch.arange(c, device=dev)
        for g0 in range(0, tgt.shape[0], chunk):
            sl = slice(g0, g0 + chunk)
            ax, ay = pair_accel(sx[sl, None, :] - tgt[sl, :, 0:1],
                                sy[sl, None, :] - tgt[sl, :, 1:2],
                                sm[sl, None, :], SOFTENING2)
            keep = (cols[None, :] < lim[sl, None])[:, None, :]
            out[sl, :, 0] = torch.where(keep, ax.abs(), 0.0).sum(-1)
            out[sl, :, 1] = torch.where(keep, ay.abs(), 0.0).sum(-1)
        return out

    # -- inputs --------------------------------------------------------------
    def path_inputs(state, c):
        spos, _, smass = morton_sort_state(
            state.pos, state.vel, state.mass, c.world_size,
            bits=c.resolved_morton_bits())
        tree = summarize_sorted(spos, smass, leaf_size=c.leaf_size,
                                unweighted_leaf_com=c.unweighted_leaf_com,
                                quad=c.resolved_multipole() == 2)
        fcap, lcap = c.resolved_caps()
        return tr.sweep_inputs(tree, c.theta, fcap, lcap, arity=c.tree_arity,
                               plan_leaves=c.plan_leaves,
                               multipole=c.resolved_multipole())

    gal0 = galaxy(seed=0).to(dev)
    gtgt, (gx, gy, gm), _, glim = path_inputs(gal0.pad_to(256),
                                              SimConfig(force_path="bh"))
    dtree, _ = build_tree(gal0.pos, gal0.mass, morton_bits=15)
    dx_, dy_, dm_ = tr.bh_plan_sources(dtree, 50.0, 32, 16)
    dtgt = dtree.leaf_pos.contiguous()
    dlim = tr.last_nonzero_columns(dm_)
    rng = np.random.default_rng(4)

    def cloud(g, s, c, zero_tail=True):
        tgt = torch.tensor(rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32),
                           device=dev)
        sx, sy = (torch.tensor(rng.uniform(0, 1e5, (g, c)).astype(
            np.float32), device=dev) for _ in range(2))
        sm = torch.tensor(rng.integers(1, 100, (g, c)).astype(np.float32),
                          device=dev)
        if zero_tail and c:
            for gi in range(g):
                sm[gi, int(rng.integers(0, c + 1)):] = 0.0
        return tgt, sx, sy, sm, tr.last_nonzero_columns(sm)

    cases = {  # label: (inputs, modes)
        "galaxy (1024, 256, 1280)": ((gtgt, gx, gy, gm, glim), MODES),
        f"bh_accel_diff {tuple(dtgt.shape[:2]) + (dx_.shape[1],)}": (
            (dtgt, dx_, dy_, dm_, dlim), ("newton", "approx")),
        "ragged (5, 7, 1)": (cloud(5, 7, 1), MODES),
        "ragged (3, 300, 70)": (cloud(3, 300, 70), MODES),
        "ragged (4, 1, 70)": (cloud(4, 1, 70), MODES),
        "no columns (4, 16, 0)": (cloud(4, 16, 0), ("approx",)),
        "S=2048 (8, 2048, 1280)": (cloud(8, 2048, 1280), MODES),
    }

    def special_inputs():
        """One call's worth of groups, each with one special input; the
        other groups' tiles stay within the bound (the fast form)."""
        g, s, c = 10, 64, 96
        tgt, sx, sy, sm, _ = cloud(g, s, c, zero_tail=False)
        sx[0, 5] = float("nan")                      # NaN coordinate
        sy[1, 6] = float("inf")                      # inf coordinate
        sx[2, 7] = 2.0 ** 50                         # |x| = 2^50
        sx[3, 8], sy[3, 8] = tgt[3, 9, 0], tgt[3, 9, 1]  # coincident, fast
        tgt[4, 0] = 0.0                              # den = 2^-117 * 1e-3,
        sx[4, 0], sy[4, 0] = 2.0 ** -117, 0.0        # in [2^-128, 2^-126)
        sm[5, 3] = float("inf")                      # inf mass
        tgt[6, 3, 0] = float("nan")                  # NaN target
        return tgt, sx, sy, sm, tr.last_nonzero_columns(sm)

    special = special_inputs()

    # -- K3 ------------------------------------------------------------------
    k3 = {}
    for label, ((tgt, sx, sy, sm, lim), modes) in cases.items():
        scale = abs_sum(tgt, sx, sy, sm, lim)
        plain = tr.grouped_force_ref(tgt, sx, sy, sm, SOFTENING2,
                                     col_limit=lim)
        for rcp in modes:
            mode = MODES.index(rcp)
            want = parent_k3(tgt, sx, sy, sm, lim, mode)
            for v in sweeps:
                got = new_k3(v, tgt, sx, sy, sm, lim, mode)
                row = {
                    "bounded_eq_full": same(got, new_k3(v, tgt, sx, sy, sm,
                                                        None, mode)),
                    "two_calls_bitwise": same(got, new_k3(v, tgt, sx, sy, sm,
                                                          lim, mode)),
                    "fast_eq_general": same(got, new_k3(v, tgt, sx, sy, sm,
                                                        lim, mode,
                                                        fast=False)),
                    "differ_from_parent": n_diff(got, want),
                    "outputs": got.numel(),
                    "max_rel_parent": ((got.double() - want.double()).abs()
                                       / scale.double().clamp_min(1e-30)
                                       ).max().item() if got.numel() else 0.0,
                    "max_rel_plain": ((got.double() - plain.double()).abs()
                                      / scale.double().clamp_min(1e-30)
                                      ).max().item() if got.numel() else 0.0}
                row["ok"] = (row["bounded_eq_full"] and row["two_calls_bitwise"]
                             and row["fast_eq_general"]
                             and row["max_rel_plain"] <= SUM_RTOL)
                k3[f"{label} {rcp} {v}"] = row
                log(f"K3 {label} {rcp} {v}: {json.dumps(row)}")
    tgt, sx, sy, sm, lim = special
    for soft2 in (SOFTENING2, 1e-30):
        for rcp in MODES:
            mode = MODES.index(rcp)
            for v in sweeps:
                got = new_k3(v, tgt, sx, sy, sm, lim, mode, soft2=soft2)
                gen = new_k3(v, tgt, sx, sy, sm, lim, mode, soft2=soft2,
                             fast=False)
                row = {"fast_eq_general": same(got, gen),
                       "nonfinite": int((~torch.isfinite(got)).sum())}
                row["ok"] = row["fast_eq_general"]
                k3[f"special eps={soft2:g} {rcp} {v}"] = row
                log(f"K3 special eps={soft2:g} {rcp} {v}: "
                    f"{json.dumps(row)}")
    report["checks"]["K3"] = k3
    report["checks"]["K3_ok_everywhere"] = all(r["ok"] for r in k3.values())
    log(f"K3 holds in every case: {report['checks']['K3_ok_everywhere']}")

    # -- K1, K4, K6: bitwise the parent's --------------------------------------
    held = {}
    pcfg = SimConfig(force_path="pallas")
    gal = galaxy(seed=0).to(dev).pad_to(max(pcfg.tile_i, pcfg.tile_j,
                                            pcfg.sym_tile))
    srng = np.random.default_rng(2)
    small = [(gal.pos, gal.mass)]
    for n in (200, 512, 1280):
        p_ = torch.tensor(srng.uniform(0, 1e5, (n, 2)).astype(np.float32),
                          device=dev)
        m_ = torch.tensor(srng.integers(1, 100, n).astype(np.float32),
                          device=dev)
        m_[0] = 7.5e7
        small.append((p_, m_))
    for mode, rcp in enumerate(MODES):
        for p_, m_ in small:
            held[f"K1 N={p_.shape[0]} {rcp}"] = same(k1(nall, p_, m_, mode),
                                                    k1(pall, p_, m_, mode))
    pst = plummer(65_536, seed=0).to(dev).pad_to(256)
    quad_cases = (
        ("plummer pl=4", path_inputs(pst, SimConfig(
            force_path="bh", theta=0.5, unweighted_leaf_com=False)), MODES),
        ("galaxy theta=0.5", path_inputs(galaxy(seed=0).to(dev).pad_to(256),
                                         SimConfig(force_path="bh",
                                                   theta=0.5)),
         ("newton",)))
    for label, (qt, (qx, qy, qm), qq, ql), modes in quad_cases:
        for rcp in modes:
            mode = MODES.index(rcp)
            for form, lim in (("bounded", ql), ("full", None)):
                held[f"K4 {label} {rcp} {form}"] = same(
                    k4(ref, qt, qx, qy, qm, qq, lim, mode),
                    k4(psweep, qt, qx, qy, qm, qq, lim, mode))
    del quad_cases, pst
    st3 = par.shard_state(galaxy(seed=0), par.LocalMesh(3, dev))
    l3 = st3.n // 3
    for label, (pi, pj, mj) in (
            ("galaxy", (gal.pos, gal.pos, gal.mass)),
            ("P=3 shard", (st3.pos[:l3].contiguous(),
                           st3.pos[l3:2 * l3].contiguous(),
                           st3.mass[l3:2 * l3].contiguous()))):
        held[f"K6 {label}"] = same(k6(nall, pi, pj, mj),
                                   k6(pall, pi, pj, mj))
    report["checks"]["K1_K4_K6_bitwise_parent"] = held
    log(f"K1, K4 and K6 bitwise the parent's in every case: "
        f"{all(held.values())}" + ("" if all(held.values()) else f" {held}"))

    # -- registers, occupancy, grids, SASS -----------------------------------
    for b in sweeps:
        info = report["builds"][f"sweep:{b}"]
        shape = split.launch_shape(sweeps[b].grouped_sweep_shape, dev, 256,
                                   MODES.index("approx"))
        info["blocks_per_sm approx"] = shape.blocks_per_sm
        regs = ctypes.c_int(0)
        check(sweeps[b].grouped_sweep_regs(MODES.index("approx"), 0,
                                           ctypes.byref(regs)), "regs")
        info["registers approx"] = regs.value
        for label, (inp, _) in list(cases.items())[:2]:
            g, s = inp[0].shape[:2]
            info[f"plan {label}"] = plan_of(b, g, s, inp[1].shape[1],
                                            2)._asdict()
    for k in built:
        if not k.startswith("sweep:"):
            continue
        for fn in ("grouped_sweep_kernelILi2EE", "grouped_sweep_kernelILi1EE"):
            report["builds"][k][f"sass_per_pair {fn}"] = sass_per_pair(
                built[k][0], fn)
        log(f"{k}: " + json.dumps(report["builds"][k]))
        if args.dump:
            dump_sass(built[k][0],
                      args.dump / f"sass_{k.replace(':', '_')}.txt")

    # -- times ---------------------------------------------------------------
    approx, exact, newton = (MODES.index(m) for m in ("approx", "exact",
                                                      "newton"))
    for label, (tgt, sx, sy, sm, lim), mode, reps in (
            ("galaxy approx bounded", (gtgt, gx, gy, gm, glim), approx, 200),
            ("galaxy approx full", (gtgt, gx, gy, gm, None), approx, 100),
            ("galaxy exact bounded", (gtgt, gx, gy, gm, glim), exact, 40),
            ("bh_accel_diff newton bounded", (dtgt, dx_, dy_, dm_, dlim),
             newton, 200)):
        fns = {"parent": (lambda tgt=tgt, sx=sx, sy=sy, sm=sm, lim=lim,
                          mode=mode: parent_k3(tgt, sx, sy, sm, lim, mode))}
        for v in sweeps:
            fns[v] = (lambda v=v, tgt=tgt, sx=sx, sy=sy, sm=sm,
                             lim=lim, mode=mode:
                             new_k3(v, tgt, sx, sy, sm, lim, mode))
        report["ms"][f"K3 {label}"] = in_turns(fns, reps)
        log(f"K3 {label} ms: " + ", ".join(
            f"{v} {t:.4f}" for v, t in report["ms"][f"K3 {label}"].items()))

    return finish(report, args.out, t_start, tmp)


if __name__ == "__main__":
    sys.exit(main())
