"""Native host-side sparse→dense frame reconstruction, with a NumPy
fallback when no C++ toolchain exists."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from nbody_simulation_tpu_torch.runtime.nativelib import load_native

_lock = threading.Lock()
_lib = None
_tried = False


def _frame_lib():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            lib = load_native("frame")
            if lib is not None:
                lib.frame_reconstruct.restype = None
                lib.frame_reconstruct.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t]
                _lib = lib
    return _lib


def reconstruct(idx: np.ndarray, vals: np.ndarray,
                render_size: int) -> np.ndarray:
    """Sparse (idx, packed-RGBA) → dense (H, W, 4) u8 frame. Entries with
    idx >= npix are padding."""
    idx = np.ascontiguousarray(idx, np.int32)
    vals = np.ascontiguousarray(vals, np.uint32)
    if idx.shape != vals.shape:
        raise ValueError(f"idx {idx.shape} and vals {vals.shape} differ")
    npix = render_size * render_size
    lib = _frame_lib()
    if lib is not None:
        out = np.empty(npix, np.uint32)
        lib.frame_reconstruct(idx.ctypes.data, vals.ctypes.data, idx.size,
                              out.ctypes.data, npix)
    else:
        out = np.zeros(npix, np.uint32)
        ok = (idx >= 0) & (idx < npix)
        out[idx[ok]] = vals[ok]
    return out.view(np.uint8).reshape(render_size, render_size, 4)

