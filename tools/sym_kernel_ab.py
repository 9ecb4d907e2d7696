#!/usr/bin/env python3
"""A/B of the symmetric round kernel (K2 and K9) on one CUDA card.

    python3 tools/sym_kernel_ab.py PARENT_DIR [--targets 1 2 4]
        [--against DIR ...] [--sweep] [--dump DIR] [--out FILE]

Run from the root of the repository. PARENT_DIR holds a checkout of an
earlier commit (``git archive <commit> | tar -x -C PARENT_DIR``) whose
``csrc/allpairs.cu`` has the earlier C interface: ``allpairs_sym_launch``
and ``allpairs_sym_pair_launch`` taking the f64 accumulators and the output,
one launch per tournament round. The script builds that source, and this
tree's ``csrc/allpairs.cu`` once for each ``kTargets`` given (i targets per
lane; the tree's own value is the shipped kernel), and on the same inputs:

- with ``--against DIR ...``, also builds each DIR's ``csrc/allpairs.cu``
  as it is (this tree's C interface) and holds every variant bitwise to
  it, in the same cases;
- holds the variant with ``kTargets = 1`` bitwise to the parent (its
  in-block arithmetic is the parent's; only the launches, the slots and the
  fold are new) for K2 on the galaxy, at small N and at N=1,048,576, and for
  K9 at both shard shapes, in the rcp modes listed below;
- reports each variant's max |d| from the parent relative to Σ|c| on the
  galaxy, and bitwise equality on two calls;
- times each (CUDA events, alternating parent, variants, variants reversed,
  parent) at K2 on the galaxy (N=151,552) and at L=51,200, K9 at L=51,200
  and L=131,072, and K2 at N=1,048,576;
- prints each build's registers (``-Xptxas -v``), resident blocks per SM,
  rounds per launch, and the hot loop's instructions per pair
  (``cuobjdump -sass``, as chip_smoke.py counts them);
- with ``--sweep``, times the tree's kernel under other ``SYM_WAVES``
  (``ops/allpairs.py``) and ``SLOT_SCRATCH`` (``ops/split.py``) settings;
- with ``--dump DIR``, writes each variant's SASS to DIR.

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
                        dump_sass, finish, in_turns, sass_per_pair, timed_ms)

# The round kernels whose registers ptxas reports (rcp=newton).
PTXAS_KERNELS = r"allpairs_sym_rounds?ILi1E"


def main() -> int:
    import numpy as np
    import torch

    from nbody_simulation_tpu_torch import parallel as par
    from nbody_simulation_tpu_torch.config import SimConfig
    from nbody_simulation_tpu_torch.models.scenarios import (galaxy,
                                                             uniform_disc)
    from nbody_simulation_tpu_torch.ops import allpairs as ap
    from nbody_simulation_tpu_torch.ops import split
    from nbody_simulation_tpu_torch.ops.force import pair_accel

    parser = argparse.ArgumentParser()
    parser.add_argument("parent", type=Path)
    parser.add_argument("--targets", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="checkouts whose csrc/allpairs.cu has this "
                        "tree's C interface, built as they are")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--dump", type=Path,
                        help="directory for each variant's SASS")
    parser.add_argument("--out", type=Path, help="file for the report")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sym_kernel_ab: needs a CUDA card")
    card, log = card_log()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    tmp = Path(tempfile.mkdtemp(prefix="sym_ab_"))
    jobs = {"parent": (args.parent / "nbody_simulation_tpu_torch" / "csrc",
                       "allpairs", {})}
    for t in args.targets:
        jobs[f"T{t}"] = (CSRC, "allpairs", {"kTargets": t})
    for d in args.against:
        jobs[f"@{d.name}"] = (d / "nbody_simulation_tpu_torch" / "csrc",
                              "allpairs", {})
    built = build_all(jobs, PTXAS_KERNELS, tmp)
    log(f"built {list(built)} in {time.perf_counter() - t_start:.1f} s")
    report = {"card": card, "variants": {}}

    parent = ctypes.CDLL(str(built["parent"][0]))
    parent.allpairs_sym_launch.restype = ctypes.c_int
    parent.allpairs_sym_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])
    parent.allpairs_sym_pair_launch.restype = ctypes.c_int
    parent.allpairs_sym_pair_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])
    libs = {k: ap._bind(ctypes.CDLL(str(v[0])))
            for k, v in built.items() if k != "parent"}
    plans = {k: {} for k in libs}

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def parent_k2(pos, mass, rcp):
        n = pos.shape[0]
        acc = torch.zeros((2, n, 2), dtype=torch.float64, device=dev)
        out = torch.empty_like(pos)
        err = parent.allpairs_sym_launch(
            pos.data_ptr(), mass.data_ptr(), acc.data_ptr(), out.data_ptr(),
            n, SOFTENING2, MODES.index(rcp), 0, stream())
        assert err == 0, err
        return out

    def parent_k9(pi, mi, pj, mj, rcp):
        n = pi.shape[0]
        acc = torch.zeros((2, n, 2), dtype=torch.float64, device=dev)
        out = torch.empty((2, n, 2), dtype=torch.float32, device=dev)
        err = parent.allpairs_sym_pair_launch(
            pi.data_ptr(), mi.data_ptr(), pj.data_ptr(), mj.data_ptr(),
            acc.data_ptr(), out.data_ptr(), n, SOFTENING2, MODES.index(rcp),
            0, stream())
        assert err == 0, err
        return out[0], out[1]

    def use(v):
        ap._lib, ap._plans = libs[v], plans[v]

    def k2(v):
        if v == "parent":
            return parent_k2

        def call(pos, mass, rcp):
            use(v)
            return ap.allpairs_sym_cuda(pos, mass, SOFTENING2, rcp)
        return call

    def k9(v):
        if v == "parent":
            return parent_k9

        def call(pi, mi, pj, mj, rcp):
            use(v)
            return ap.allpairs_sym_pair_cuda(pi, mi, pj, mj, SOFTENING2, rcp)
        return call

    # Inputs: the padded galaxy, its P=3 shards, the 1M disc's P=8 shards
    # and bench.py's uniform 1M cloud.
    pcfg = SimConfig(force_path="pallas")
    gal = galaxy(seed=0).to(dev).pad_to(max(pcfg.tile_i, pcfg.tile_j,
                                            pcfg.sym_tile))
    gpos, gmass = gal.pos, gal.mass
    st3 = par.shard_state(galaxy(seed=0), par.LocalMesh(3, dev))
    l3 = st3.n // 3
    s3 = [(st3.pos[i * l3:(i + 1) * l3].contiguous(),
           st3.mass[i * l3:(i + 1) * l3].contiguous()) for i in range(2)]
    st8 = par.shard_state(uniform_disc(1_048_576, seed=0),
                          par.LocalMesh(8, dev))
    l8 = st8.n // 8
    s8 = [(st8.pos[i * l8:(i + 1) * l8].contiguous(),
           st8.mass[i * l8:(i + 1) * l8].contiguous()) for i in (0, 4)]
    del st8
    rng = np.random.default_rng(0)
    bpos = torch.tensor(rng.uniform(0, 1e5, (1_048_576, 2)).astype(
        np.float32), device=dev)
    bmass = torch.tensor(rng.integers(1, 100, 1_048_576).astype(np.float32),
                         device=dev)
    srng = np.random.default_rng(2)
    small = []
    for n in (200, 512, 768, 1000, 1280):
        p_ = torch.tensor(srng.uniform(0, 1e5, (n, 2)).astype(np.float32),
                          device=dev)
        m_ = torch.tensor(srng.integers(1, 100, n).astype(np.float32),
                          device=dev)
        m_[0] = 7.5e7
        small.append((p_, m_))

    def abs_terms(dx, dy, mj, e):
        cx, cy = pair_accel(dx, dy, mj, e)
        return cx.abs(), cy.abs()

    gscale = ap.pair_sums(gpos, gpos, gmass, abs_terms, SOFTENING2)

    cases = [("K2 galaxy", k2, (gpos, gmass), MODES),
             ("K2 L=51200", k2, s3[0], ("newton",)),
             ("K9 L=51200", k9, (*s3[0], *s3[1]), MODES),
             ("K9 L=131072", k9, (*s8[0], *s8[1]), ("newton",)),
             ("K2 N=1M", k2, (bpos, bmass), ("newton",))]
    cases += [(f"K2 N={p_.shape[0]}", k2, (p_, m_), MODES)
              for p_, m_ in small]
    # One NaN x: the NaN patterns (compared bit for bit).
    npos = gpos.clone()
    npos[5, 0] = float("nan")
    npi = s3[0][0].clone()
    npi[5, 0] = float("nan")
    cases += [("K2 galaxy, one NaN x", k2, (npos, gmass), MODES),
              ("K9 L=51200, one NaN x", k9, (npi, s3[0][1], *s3[1]), MODES)]

    def flat(out):
        return torch.cat([o.reshape(-1) for o in out]) if isinstance(
            out, tuple) else out.reshape(-1)

    for v in libs:
        use(v)
        info = {"ptxas": " | ".join(built[v][1])}
        for self_pairs, n in ((True, gpos.shape[0]), (False, l3),
                              (False, l8), (True, l3)):
            plan = ap.sym_launch_plan(n, dev, "newton", self_pairs)
            info[f"{'K2' if self_pairs else 'K9'} n={n}"] = {
                "blocks_per_sm": plan.blocks_per_sm,
                "threads": plan.threads_per_block,
                "rounds_per_launch": plan.rounds_per_launch,
                "launches": len(plan.schedule.launches),
                "blocks_per_launch": int(plan.schedule.launches[:, 1].max())}
        info["sass_per_pair"] = sass_per_pair(built[v][0],
                                              "allpairs_sym_roundsILi1ELb0E")
        bitwise, err = {}, None
        refs = ["parent"] + [k for k in libs if k.startswith("@") and k != v]
        for label, fam, inputs, modes in cases:
            for rcp in modes:
                got = flat(fam(v)(*inputs, rcp))
                again = flat(fam(v)(*inputs, rcp))
                for ref in refs:
                    want = flat(fam(ref)(*inputs, rcp))
                    torch.cuda.synchronize()
                    key = f"{label} {rcp}" + ("" if ref == "parent" else
                                              f" vs {ref}")
                    bitwise[key] = bool(torch.equal(got.view(torch.int32),
                                                    want.view(torch.int32)))
                    if ref == "parent" and label == "K2 galaxy" and (
                            rcp == "newton"):
                        err = ((got.view(-1, 2) - want.view(-1, 2)).abs()
                               / gscale.clamp_min(1e-30)).max().item()
                if not torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)):
                    raise RuntimeError(f"{v} {label} {rcp}: two calls differ")
        for ref in refs[1:]:
            info[f"bitwise_{ref}_in_every_case"] = all(
                b for k, b in bitwise.items() if k.endswith(f" vs {ref}"))
        if args.dump:
            dump_sass(built[v][0], args.dump / f"sass_{v}.txt")
        info["bitwise_parent"] = bitwise
        info["max_rel_parent_galaxy_newton"] = err
        report["variants"][v] = info
        log(f"{v}: {json.dumps(info)}")
    if "T1" in libs:
        report["T1_bitwise_parent"] = all(
            b for k, b in report["variants"]["T1"]["bitwise_parent"].items()
            if " vs " not in k)
        log(f"kTargets=1 bitwise the parent in every case: "
            f"{report['T1_bitwise_parent']}")

    times = {}
    for label, fam, inputs, reps in (
            ("K2 galaxy", k2, (gpos, gmass), 10),
            ("K2 L=51200", k2, s3[0], 20),
            ("K9 L=51200", k9, (*s3[0], *s3[1]), 20),
            ("K9 L=131072", k9, (*s8[0], *s8[1]), 4),
            ("K2 N=1M", k2, (bpos, bmass), 1)):
        times[label] = in_turns(
            {v: (lambda v=v: fam(v)(*inputs, "newton"))
             for v in ["parent", *libs]}, reps)
        log(f"{label} newton ms: " + ", ".join(
            f"{v} {t:.4f}" for v, t in times[label].items()))
    report["ms"] = times

    if args.sweep:
        tree = next(v for v in libs if f"kTargets = {v[1:]};" in (
            CSRC / "allpairs.cu").read_text())
        sweep = {}
        base = (ap.SYM_WAVES, split.SLOT_SCRATCH)
        for waves in (8, 16, 32):
            for mib in (128, 256, 512):
                ap.SYM_WAVES, split.SLOT_SCRATCH = waves, mib << 20
                plans[tree] = {}
                row = {}
                for label, fam, inputs, reps in (
                        ("K2 galaxy", k2, (gpos, gmass), 10),
                        ("K9 L=51200", k9, (*s3[0], *s3[1]), 20)):
                    row[label] = timed_ms(
                        lambda: fam(tree)(*inputs, "newton"), reps)
                sweep[f"waves={waves} scratch={mib}MiB"] = row
                log(f"sweep {tree} waves={waves} scratch={mib} MiB: {row}")
        ap.SYM_WAVES, split.SLOT_SCRATCH = base
        plans[tree] = {}
        report["sweep"] = sweep

    return finish(report, args.out, t_start, tmp)


if __name__ == "__main__":
    sys.exit(main())
