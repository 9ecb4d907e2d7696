"""On-demand builder for the native (C++) host-side runtime pieces.

The sources are this package's ``runtime/native/<name>.cpp`` (copies of
the JAX package's, which the port does not read). They compile with g++
into this package's ``_build/`` directory, keyed by a hash of the source.
Without a toolchain ``load_native`` returns None and the callers use their
NumPy / pure-Python fallbacks; both are host code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = _PKG_DIR / "_build"
_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}


def load_native(name: str) -> ctypes.CDLL | None:
    """Compile ``<name>.cpp`` (g++ -O3, content-hashed) and load it; None
    when the source or a toolchain is missing."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src_path = NATIVE_DIR / f"{name}.cpp"
        try:
            tag = hashlib.sha256(src_path.read_bytes()).hexdigest()[:16]
            so = BUILD_DIR / f"lib{name}_{tag}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # Build beside, then rename: a concurrent process never
                # loads a half-written library.
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp{so.suffix}")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", str(tmp), str(src_path)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _cache[name] = lib
        return lib
