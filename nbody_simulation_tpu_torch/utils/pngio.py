"""Framebuffer PNG output — PIL if present, pure-zlib encoder otherwise."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def save_png(path: str | Path, frame: np.ndarray) -> None:
    """frame: (H, W, 4) uint8 RGBA."""
    frame = np.ascontiguousarray(frame, np.uint8)
    try:
        from PIL import Image
        Image.fromarray(frame, "RGBA").save(str(path))
        return
    except ImportError:
        pass
    h, w = frame.shape[:2]
    raw = b"".join(b"\x00" + frame[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)
