"""Framebuffer PNG output — PIL if present, pure-zlib encoder otherwise."""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np


def encode_png(frame: np.ndarray) -> bytes:
    """The PNG file of ``frame``, an (H, W, 4) uint8 RGBA array."""
    frame = np.ascontiguousarray(frame, np.uint8)
    try:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(frame, "RGBA").save(buf, "PNG")
        return buf.getvalue()
    except ImportError:
        pass
    h, w = frame.shape[:2]
    raw = b"".join(b"\x00" + frame[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(path: str | Path, frame: np.ndarray) -> None:
    """Write ``frame``, an (H, W, 4) uint8 RGBA array, as a PNG file."""
    Path(path).write_bytes(encode_png(frame))
