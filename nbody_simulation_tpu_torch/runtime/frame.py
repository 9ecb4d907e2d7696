"""Native host-side frame stages: sparse→dense reconstruction and the
alpha-composite over black for the GIF and viewer, with NumPy fallbacks
when no C++ toolchain exists."""

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
                lib.frame_composite_black.restype = None
                lib.frame_composite_black.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
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


def composite_black(frame: np.ndarray) -> np.ndarray:
    """RGBA u8 over black → RGB u8 (the GIF and viewer path):
    rgb = rgb_in · a // 255."""
    frame = np.ascontiguousarray(frame, np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 4:
        raise ValueError(f"frame must be (H, W, 4), got {frame.shape}")
    h, w = frame.shape[:2]
    lib = _frame_lib()
    if lib is not None:
        rgb = np.empty((h, w, 3), np.uint8)
        lib.frame_composite_black(frame.ctypes.data, h * w, rgb.ctypes.data)
        return rgb
    a = frame[..., 3:4].astype(np.uint16)
    return (frame[..., :3].astype(np.uint16) * a // 255).astype(np.uint8)
