"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
turns ``csrc/<name>.cu`` — a file with a plain C interface and no PyTorch
headers, so it builds in seconds — into ``_build/lib<name>_<hash>.so``,
keyed by a hash of the source and of every shared header ``csrc/*.cuh``,
and ``ctypes`` loads it. The build runs at first use, never at import; two
libraries may build at once from two threads. A failing ``nvcc`` raises
with its stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of nbody_simulation_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its content and that of
    every header in ``csrc/``, so an edited header rebuilds."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build beside, then rename: a concurrent process never loads a
            # half-written library.
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp{so.suffix}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
