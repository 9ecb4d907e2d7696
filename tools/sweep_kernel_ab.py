#!/usr/bin/env python3
"""A/B of the quadrupole sweep (K4) and the potential sweep (K6) on one card.

    python3 tools/sweep_kernel_ab.py PARENT_DIR [--quad-targets 2 4]
        [--pot-targets 8 16] [--against DIR ...] [--dump DIR] [--out FILE]

Run from the root of the repository. PARENT_DIR holds a checkout of an
earlier commit (``git archive <commit> | tar -x -C PARENT_DIR``) whose
``csrc/grouped_sweep.cu`` runs K4 as ``grouped_sweep_kernel<MODE, true>``
(one block per group, ``grouped_sweep_launch`` with the three moment
pointers) and whose ``csrc/allpairs.cu`` runs K6 as the ordered kernel
(``potential_launch`` without slots). The script builds those two sources
and this tree's, once for each ``kQuadTargets`` (K4's targets per thread,
2 by default) and ``kPotTargets`` (K6's, 16) given, and with ``--against
DIR ...`` each DIR's two sources as they are (this tree's C interface),
all at once, and on the same inputs:

- holds K3 (the monopole sweep) and K1 (the ordered force sweep) of this
  tree bitwise to the parent's in all five rcp modes: the galaxy's θ=50
  sweep, full and bounded, and the all-pairs galaxy and small N;
- holds each K4 variant run as one chunk per group (``chunk`` ≥ C: the
  in-range reciprocals and the packed, shared columns, without the split)
  bitwise to the parent's K4 in all five rcp modes at the three θ<2 shapes
  (the CLI's θ=0.5 Plummer, ``plan_leaves=1``, the θ=0.5 galaxy), full and
  bounded, and on two small cases: huge and special displacements, and a
  column that acts through its moments alone;
- reports, for each K4 variant on its planned chunks, the outputs that
  differ from the parent and the max |Δ| over K4's own scale
  Σ(|dx·w| + |corr|), with bounded == full and two calls bitwise;
- reports, for each K6 variant, the outputs that differ from the parent,
  the max relative |Δ| from it and from the plain version, two calls
  bitwise, and one NaN x against the plain version's pattern;
- times each (CUDA events, in turns: parent, variants, variants reversed,
  parent) at K4's three θ<2 shapes (newton, bounded), K6 on the galaxy
  (N=151,552) and at the P=3 ring's shard shape (Ni=Nj=51,200), K3 on the
  galaxy (approx, bounded) and K1 on the galaxy (newton);
- prints each build's registers and spills (``-Xptxas -v``), resident
  blocks per SM, its grids (``ops/split.py:chunk_plan``), and the hot
  loops' instructions per pair (``cuobjdump -sass``, as chip_smoke.py
  counts them);
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
PTXAS_KERNELS = ("quad_sweep_kernelILi1E|grouped_sweep_kernelILi[12]E|"
                 "potential_kernel|ordered_kernelILi[01]E")


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
    from nbody_simulation_tpu_torch.ops.morton import morton_sort_state
    from nbody_simulation_tpu_torch.ops.tree import summarize_sorted

    parser = argparse.ArgumentParser()
    parser.add_argument("parent", type=Path)
    parser.add_argument("--quad-targets", type=int, nargs="+", default=[2])
    parser.add_argument("--pot-targets", type=int, nargs="+", default=[16])
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
            "allpairs:parent": (parent_csrc, "allpairs", {})}
    for t in args.quad_targets:
        jobs[f"sweep:Q{t}"] = (CSRC, "grouped_sweep", {"kQuadTargets": t})
    for t in args.pot_targets:
        jobs[f"allpairs:P{t}"] = (CSRC, "allpairs", {"kPotTargets": t})
    for d in args.against:
        csrc = d / "nbody_simulation_tpu_torch" / "csrc"
        jobs[f"sweep:@{d.name}"] = (csrc, "grouped_sweep", {})
        jobs[f"allpairs:@{d.name}"] = (csrc, "allpairs", {})
    built = build_all(jobs, PTXAS_KERNELS, tmp)
    log(f"built {list(built)} in {time.perf_counter() - t_start:.1f} s")
    report = {"card": card, "builds": {}, "checks": {}, "ms": {}}
    for k, (_, info) in built.items():
        report["builds"][k] = {"ptxas": info}
        log(f"{k} ptxas: " + " | ".join(info))

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    libs = {k: ctypes.CDLL(str(v[0])) for k, v in built.items()}
    psweep, pall = libs["sweep:parent"], libs["allpairs:parent"]
    psweep.grouped_sweep_launch.restype = ctypes.c_int
    psweep.grouped_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    pall.allpairs_launch.restype = ctypes.c_int
    pall.allpairs_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    pall.potential_launch.restype = ctypes.c_int
    pall.potential_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    quad_libs = {k.split(":")[1]: tr._bind_sweep(v) for k, v in libs.items()
                 if k.startswith("sweep:") and k != "sweep:parent"}
    pot_libs = {k.split(":")[1]: ap._bind(v) for k, v in libs.items()
                if k.startswith("allpairs:") and k != "allpairs:parent"}

    def ptr(t):
        return None if t is None else t.data_ptr()

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    # -- the kernels, each build by name -------------------------------------
    def parent_sweep(tgt, sx, sy, sm, sq, lim, mode):
        g, s, _ = tgt.shape
        out = torch.empty_like(tgt)
        q = [ptr(a) for a in sq] if sq is not None else [None] * 3
        check(psweep.grouped_sweep_launch(
            ptr(tgt), ptr(sx), ptr(sy), ptr(sm), *q, ptr(lim), ptr(out), g,
            s, sx.shape[1], SOFTENING2, mode, 0, stream()), "parent sweep")
        return out

    def new_k3(lib, tgt, sx, sy, sm, lim, mode):
        g, s, _ = tgt.shape
        out = torch.empty_like(tgt)
        check(lib.grouped_sweep_launch(
            ptr(tgt), ptr(sx), ptr(sy), ptr(sm), ptr(lim), ptr(out), g, s,
            sx.shape[1], SOFTENING2, mode, 0, stream()), "K3")
        return out

    def quad_plan(v, g, s, c, mode):
        shape = split.launch_shape(quad_libs[v].quad_sweep_shape, dev, s,
                                   mode)
        return tr.quad_sweep_plan(g, s, c, shape.threads, shape.targets,
                                  shape.resident_blocks)

    def new_k4(v, tgt, sx, sy, sm, sq, lim, mode, chunk=None):
        """K4 of variant v on its planned chunks, or on ``chunk``; 0 is
        one chunk per group (the parent's split)."""
        c = sx.shape[1]
        if chunk is None:
            chunk = quad_plan(v, tgt.shape[0], tgt.shape[1], c, mode).chunk
        elif chunk == 0:
            chunk = max(32, -(-c // 32) * 32)
        err, out = tr.quad_sweep_chunked(quad_libs[v], tgt, sx, sy, sm, sq,
                                         lim, SOFTENING2, mode, chunk)
        check(err, f"K4 {v}")
        return out

    def k1(lib, pos, mass, mode):
        out = torch.empty_like(pos)
        check(lib.allpairs_launch(ptr(pos), ptr(pos), ptr(mass), ptr(out),
                                  pos.shape[0], pos.shape[0], SOFTENING2,
                                  mode, 0, stream()), "K1")
        return out

    def parent_k6(pi, pj, mj):
        out = torch.empty(pi.shape[0], dtype=torch.float32, device=dev)
        check(pall.potential_launch(ptr(pi), ptr(pj), ptr(mj), ptr(out),
                                    pi.shape[0], pj.shape[0], SOFTENING2, 0,
                                    stream()), "parent K6")
        return out

    def pot_shape(v):
        return split.launch_shape(pot_libs[v].potential_shape, dev,
                                  SOFTENING2)

    def new_k6(v, pi, pj, mj):
        shape = pot_shape(v)
        plan = en.potential_plan(pi.shape[0], pj.shape[0],
                                 shape.threads * shape.targets,
                                 shape.resident_blocks)
        err, out = en.potential_chunked(pot_libs[v], pi, pj, mj, SOFTENING2,
                                        plan.chunk)
        check(err, f"K6 {v}")
        return out

    def same(a, b):
        torch.cuda.synchronize()
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def n_diff(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

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

    pst = plummer(65_536, seed=0).to(dev).pad_to(256)
    shapes = {
        "plummer pl=4": path_inputs(pst, SimConfig(
            force_path="bh", theta=0.5, unweighted_leaf_com=False)),
        "plummer pl=1": path_inputs(pst, SimConfig(
            force_path="bh", theta=0.5, plan_leaves=1,
            unweighted_leaf_com=False)),
        "galaxy": path_inputs(galaxy(seed=0).to(dev).pad_to(256),
                              SimConfig(force_path="bh", theta=0.5)),
    }

    def special_cases():
        """Huge and special displacements (1e20, 3e38, NaN, inf, a
        coincident pair, a subnormal |d|_1), and a column past the last
        mass that acts through its moments alone (tests/test_torch_quad)."""
        rng = np.random.default_rng(9)
        g, s, c = 4, 64, 96
        tgt = rng.uniform(0, 1e5, (g, s, 2)).astype(np.float32)
        sx, sy = rng.uniform(0, 1e5, (2, g, c)).astype(np.float32)
        sm = rng.integers(0, 100, (g, c)).astype(np.float32)
        q = [(sm * rng.uniform(0, 4e6, (g, c))).astype(np.float32)
             for _ in range(3)]
        q[1] = (q[1] - sm * 2e6).astype(np.float32)
        mom = [a.copy() for a in (tgt, sx, sy, sm, *q)]
        sx[0, 5], sx[1, 7], sy[1, 7] = 3e38, 1e20, 1e20
        sx[2, 9], sx[3, 11] = np.nan, np.inf
        sx[0, 0], sy[0, 0] = tgt[0, 0]
        tgt[2, 0] = 0.0
        sx[2, 1], sy[2, 1] = 2e-40, 0.0
        huge = (tgt, sx, sy, sm, *q)
        mom[3][:, 40:] = 0.0
        for a in mom[4:]:
            a[:, 40:] = 0.0
        mom[4][1, 70], mom[5][1, 70], mom[6][1, 70] = 5e9, -2e9, 3e9
        out = {}
        for label, arrs in (("special displacements", huge),
                            ("moment-only column", mom)):
            t = [torch.tensor(a, device=dev) for a in arrs]
            lim = tr.last_nonzero_columns(t[3], t[4:])
            out[label] = (t[0], tuple(t[1:4]), tuple(t[4:]), lim)
        return out

    shapes.update(special_cases())

    # -- K4: bitwise and reassociated --------------------------------------
    def quad_scale(tgt, sx, sy, sm, sq):
        out = torch.empty_like(tgt)
        chunk = max(1, (1 << 25) // (tgt.shape[1] * sx.shape[1]))
        for g0 in range(0, tgt.shape[0], chunk):
            sl = slice(g0, g0 + chunk)
            dx = sx[sl, None, :] - tgt[sl, :, 0:1]
            dy = sy[sl, None, :] - tgt[sl, :, 1:2]
            z = torch.zeros_like(dx)
            mono = tr.quad_tile(dx, dy, sm[sl, None, :], z, z, z, SOFTENING2)
            corr = tr.quad_tile(dx, dy, z, *(q[sl, None, :] for q in sq),
                                SOFTENING2)
            for k in range(2):
                out[sl, :, k] = (mono[k].abs() + corr[k].abs()).sum(-1)
        return out

    k4 = {}
    for label, (tgt, (sx, sy, sm), sq, lim) in shapes.items():
        scale = (quad_scale(tgt, sx, sy, sm, sq)
                 if label in ("plummer pl=4", "plummer pl=1", "galaxy")
                 else None)
        for mode, rcp in enumerate(MODES):
            want_full = parent_sweep(tgt, sx, sy, sm, sq, None, mode)
            want = parent_sweep(tgt, sx, sy, sm, sq, lim, mode)
            for v in quad_libs:
                one = new_k4(v, tgt, sx, sy, sm, sq, lim, mode, chunk=0)
                one_full = new_k4(v, tgt, sx, sy, sm, sq, None, mode,
                                  chunk=0)
                got = new_k4(v, tgt, sx, sy, sm, sq, lim, mode)
                again = new_k4(v, tgt, sx, sy, sm, sq, lim, mode)
                full = new_k4(v, tgt, sx, sy, sm, sq, None, mode)
                row = {"one_chunk_bitwise_parent": same(one, want)
                       and same(one_full, want_full),
                       "split_bounded_eq_full": same(got, full),
                       "split_two_calls_bitwise": same(got, again),
                       "split_differ_from_parent": n_diff(got, want),
                       "outputs": got.numel()}
                if scale is not None:
                    row["split_max_rel_parent"] = (
                        (got.double() - want.double()).abs()
                        / scale.double().clamp_min(1e-30)).max().item()
                k4[f"{label} {rcp} {v}"] = row
                log(f"K4 {label} {rcp} {v}: {json.dumps(row)}")
    report["checks"]["K4"] = k4
    report["checks"]["K4_one_chunk_bitwise_parent_everywhere"] = all(
        r["one_chunk_bitwise_parent"] for r in k4.values())

    # -- K3 and K1: bitwise the parent's -------------------------------------
    g50 = path_inputs(galaxy(seed=0).to(dev).pad_to(256),
                      SimConfig(force_path="bh"))
    gtgt, (gx, gy, gm), _, glim = g50
    any_q = next(iter(quad_libs.values()))
    pcfg = SimConfig(force_path="pallas")
    gal = galaxy(seed=0).to(dev).pad_to(max(pcfg.tile_i, pcfg.tile_j,
                                            pcfg.sym_tile))
    gpos, gmass = gal.pos, gal.mass
    srng = np.random.default_rng(2)
    small = []
    for n in (200, 512, 768, 1000, 1280):
        p_ = torch.tensor(srng.uniform(0, 1e5, (n, 2)).astype(np.float32),
                          device=dev)
        m_ = torch.tensor(srng.integers(1, 100, n).astype(np.float32),
                          device=dev)
        m_[0] = 7.5e7
        small.append((p_, m_))
    any_p = next(iter(pot_libs.values()))
    k31 = {}
    for mode, rcp in enumerate(MODES):
        k31[f"K3 full {rcp}"] = same(new_k3(any_q, gtgt, gx, gy, gm, None,
                                            mode),
                                     parent_sweep(gtgt, gx, gy, gm, None,
                                                  None, mode))
        k31[f"K3 bounded {rcp}"] = same(new_k3(any_q, gtgt, gx, gy, gm, glim,
                                               mode),
                                        parent_sweep(gtgt, gx, gy, gm, None,
                                                     glim, mode))
        k31[f"K1 galaxy {rcp}"] = same(k1(any_p, gpos, gmass, mode),
                                       k1(pall, gpos, gmass, mode))
        for p_, m_ in small:
            k31[f"K1 N={p_.shape[0]} {rcp}"] = same(k1(any_p, p_, m_, mode),
                                                    k1(pall, p_, m_, mode))
    report["checks"]["K3_K1_bitwise_parent"] = k31
    log(f"K3 and K1 bitwise the parent's in every case: {all(k31.values())}"
        + ("" if all(k31.values()) else f" {k31}"))

    # -- K6 ----------------------------------------------------------------
    st3 = par.shard_state(galaxy(seed=0), par.LocalMesh(3, dev))
    l3 = st3.n // 3
    s3 = (st3.pos[:l3].contiguous(), st3.pos[l3:2 * l3].contiguous(),
          st3.mass[l3:2 * l3].contiguous())
    npos = gpos.clone()
    npos[5, 0] = float("nan")
    pot_cases = {"galaxy": (gpos, gpos, gmass), "P=3 shard": s3,
                 "one NaN x": (npos, npos, gmass)}
    pot_cases.update({f"N={p_.shape[0]}": (p_, p_, m_) for p_, m_ in small})
    k6 = {}
    for label, (pi, pj, mj) in pot_cases.items():
        want = parent_k6(pi, pj, mj)
        plain = en.allpairs_potential_ref(pi, None, pj, mj, SOFTENING2)
        for v in pot_libs:
            got = new_k6(v, pi, pj, mj)
            again = new_k6(v, pi, pj, mj)
            rel = ((got.double() - want.double()).abs()
                   / want.double().abs().clamp_min(1e-30))
            relp = ((got.double() - plain.double()).abs()
                    / plain.double().abs().clamp_min(1e-30))
            row = {"two_calls_bitwise": same(got, again),
                   "differ_from_parent": n_diff(got, want),
                   "outputs": got.numel(),
                   "max_rel_parent": rel.max().item(),
                   "max_rel_plain": relp.max().item(),
                   "median_rel_plain": relp.median().item(),
                   "finite_pattern_as_plain": bool(torch.equal(
                       torch.isfinite(got), torch.isfinite(plain))),
                   "zeros_as_plain": bool(torch.equal(got == 0,
                                                      plain == 0))}
            k6[f"{label} {v}"] = row
            log(f"K6 {label} {v}: {json.dumps(row)}")
    report["checks"]["K6"] = k6

    # -- registers, occupancy, SASS ----------------------------------------
    for v in quad_libs:
        info = report["builds"][f"sweep:{v}"]
        for label, (tgt, (sx, *_), _, _) in list(shapes.items())[:3]:
            g, s = tgt.shape[:2]
            p = quad_plan(v, g, s, sx.shape[1], 1)
            info[f"plan {label}"] = p._asdict()
            info[f"blocks_per_sm {label}"] = split.launch_shape(
                quad_libs[v].quad_sweep_shape, dev, s, 1).blocks_per_sm
    for v in pot_libs:
        info = report["builds"][f"allpairs:{v}"]
        info["blocks_per_sm"] = pot_shape(v).blocks_per_sm
        for label, (pi, pj, _) in list(pot_cases.items())[:2]:
            shape = pot_shape(v)
            info[f"plan {label}"] = en.potential_plan(
                pi.shape[0], pj.shape[0], shape.threads * shape.targets,
                shape.resident_blocks)._asdict()
    sass_names = {"sweep:parent": ("grouped_sweep_kernelILi1ELb1E",
                                   "grouped_sweep_kernelILi2ELb0E"),
                  "allpairs:parent": ("ordered_kernelILi0ELb1E",
                                      "ordered_kernelILi1ELb0E")}
    for k in built:
        if k.startswith("sweep:") and k not in sass_names:
            sass_names[k] = ("quad_sweep_kernelILi1EE",
                             "grouped_sweep_kernelILi2EE")
        elif k.startswith("allpairs:") and k not in sass_names:
            sass_names[k] = ("potential_kernelILb1EE", "ordered_kernelILi1EE")
    for k, names in sass_names.items():
        for fn in names:
            report["builds"][k][f"sass_per_pair {fn}"] = sass_per_pair(
                built[k][0], fn)
        log(f"{k}: " + json.dumps(report["builds"][k]))
        if args.dump:
            dump_sass(built[k][0],
                      args.dump / f"sass_{k.replace(':', '_')}.txt")

    # -- times ---------------------------------------------------------------
    newton = MODES.index("newton")
    for label in ("plummer pl=4", "plummer pl=1", "galaxy"):
        tgt, (sx, sy, sm), sq, lim = shapes[label]
        fns = {}
        for v in quad_libs:
            fns[f"{v} one chunk"] = (lambda v=v: new_k4(
                v, tgt, sx, sy, sm, sq, lim, newton, chunk=0))
            fns[f"{v} split"] = (lambda v=v: new_k4(
                v, tgt, sx, sy, sm, sq, lim, newton))
        fns = {"parent": lambda: parent_sweep(tgt, sx, sy, sm, sq, lim,
                                              newton), **fns}
        report["ms"][f"K4 {label}"] = in_turns(
            fns, 5 if label == "galaxy" else 10)
        log(f"K4 {label} newton bounded ms: " + ", ".join(
            f"{v} {t:.4f}" for v, t in report["ms"][f"K4 {label}"].items()))

    for label, (pi, pj, mj) in (("galaxy", (gpos, gpos, gmass)),
                                ("P=3 shard", s3)):
        fns = {"parent": lambda: parent_k6(pi, pj, mj),
               **{v: (lambda v=v: new_k6(v, pi, pj, mj)) for v in pot_libs}}
        report["ms"][f"K6 {label}"] = in_turns(
            fns, 5 if label == "galaxy" else 10)
        log(f"K6 {label} ms: " + ", ".join(
            f"{v} {t:.4f}" for v, t in report["ms"][f"K6 {label}"].items()))

    approx = MODES.index("approx")
    for label, fns in (
            ("K3 galaxy approx bounded",
             {"parent": lambda: parent_sweep(gtgt, gx, gy, gm, None, glim,
                                             approx),
              "new": lambda: new_k3(any_q, gtgt, gx, gy, gm, glim, approx)}),
            ("K1 galaxy newton",
             {"parent": lambda: k1(pall, gpos, gmass, newton),
              "new": lambda: k1(any_p, gpos, gmass, newton)})):
        report["ms"][label] = in_turns(fns, 50 if "K3" in label else 5)
        log(f"{label} ms: " + ", ".join(
            f"{v} {t:.4f}" for v, t in report["ms"][label].items()))

    return finish(report, args.out, t_start, tmp)


if __name__ == "__main__":
    sys.exit(main())
