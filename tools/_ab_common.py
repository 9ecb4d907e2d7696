"""What the kernel A/B tools (``sym_kernel_ab.py``, ``sweep_kernel_ab.py``)
share: building a kernel source with some of its constants set, timing in
turns with CUDA events, SASS dumps, and the report. Run on a CUDA card from
the root of the repository; nothing of JAX is imported.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CSRC = ROOT / "nbody_simulation_tpu_torch" / "csrc"
SOFTENING2 = 1e-3
MODES = ("exact", "newton", "approx", "newton+clamp", "approx+clamp")


def card_log():
    """(the card's name and power limit, a logger that prints a line with
    them beside it)."""
    import chip_smoke
    card = chip_smoke.card_line()

    def log(msg):
        print(f"{msg}  [{card}]", flush=True)
    return card, log


def build(src_dir: Path, name: str, out: Path, subst: dict[str, int],
          kernels: str) -> tuple[Path, list[str]]:
    """nvcc ``src_dir/<name>.cu``, with each ``constexpr int <key> = v``
    of ``subst`` set, into ``out``; returns the library and ptxas's lines
    (name, registers, spills) for the kernels whose mangled names match the
    regular expression ``kernels``."""
    from nbody_simulation_tpu_torch.cuda_build import NVCC_FLAGS, _nvcc
    work = out.parent / f"{out.stem}_src"
    work.mkdir(parents=True, exist_ok=True)
    for f in src_dir.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, work / f.name)
    src = work / f"{name}.cu"
    text = src.read_text()
    for key, v in subst.items():
        text, n = re.subn(rf"constexpr int {key} = \d+;",
                          f"constexpr int {key} = {v};", text)
        if n != 1:
            raise RuntimeError(f"{src}: no single {key} to set")
    src.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    info, keep = [], False
    for ln in proc.stderr.splitlines():
        if "Compiling entry function" in ln:
            keep = re.search(kernels, ln) is not None
            if keep:
                info.append(re.search(r"'(\S+?)'", ln).group(1))
        elif keep and ("Used" in ln or "spill" in ln):
            info.append(ln.split(":", 1)[-1].strip())
    return out, info


def build_all(jobs: dict, kernels: str,
              tmp: Path) -> dict[str, tuple[Path, list[str]]]:
    """``build`` every job, name → (source directory, source name, subst),
    all at once into ``tmp``."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build, d, n, tmp / f"lib{k.replace(':', '_')}"
                               ".so", s, kernels)
                for k, (d, n, s) in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def timed_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(fns: dict, reps: int) -> dict[str, float]:
    """Each of ``fns`` (name → callable) timed in turns, the first, the
    others, the others reversed, the first again; the mean of each
    name's turns."""
    names = list(fns)
    order = [names[0], *names[1:], *reversed(names[1:]), names[0]]
    runs = {v: [] for v in names}
    for v in order:
        runs[v].append(timed_ms(fns[v], reps))
    return {v: sum(r) / len(r) for v, r in runs.items()}


def dump_sass(lib: Path, path: Path) -> None:
    import chip_smoke
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(chip_smoke.sass_text(lib))


def sass_per_pair(lib: Path, function: str):
    """chip_smoke.py's count of the hot loop's instructions per pair, or
    why it could not count them."""
    import chip_smoke
    try:
        return chip_smoke.sass_per_pair(lib, function)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"not counted: {e}"


def finish(report: dict, out: Path | None, t_start: float,
           tmp: Path) -> int:
    """Write the report to ``out`` (if given), remove ``tmp``, print the
    report as the last line."""
    report["seconds"] = time.perf_counter() - t_start
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0
