"""On-device framebuffer raster — the reference splat loop, made commutative.

The port of ``nbody_simulation_tpu/ops/raster.py``, which proves the
formulation: the reference's sequential draw (reference src/main.rs:41-72)
has an order-free final frame, because only heavy particles set α=0xff and
they always overwrite. So per pixel it is enough to know whether any heavy
particle hit it (scatter-max of a packed key), how many light ones did
(scatter-add), and the tint of the last light hit in array order (the same
packed max). The frame is pixel-exact against ``oracle.draw_oracle``
(tests/test_torch_raster.py).

torch has no drop-mode scatter: out-of-bounds particles scatter into one
extra slot past the frame, which is cut off. They are masked before the
float→int cast, so the cast only ever sees coordinates in [0, world).
"""

from __future__ import annotations

import numpy as np
import torch


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.int32, device=like.device)


def accumulate_pixels(pos: torch.Tensor, vel: torch.Tensor,
                      mass: torch.Tensor, world_size: float, render_size: int,
                      heavy_weight: float, pack_tint: bool | None = None):
    """The per-pixel reductions: ``(green, count, last, vlast)``, each int32
    flat (npix,). ``last`` is the particle-array index of the last light hit
    (-1 = none).

    ``pack_tint`` (default: N < 2²²) packs ``idx·256 + vterm`` into the max
    key so one scatter-max yields both the last light hit and its tint; the
    other branch scatters the index alone and gathers the tint. At a pixel
    hit by both heavy and light particles the packed branch reports -1/0 for
    ``last``/``vlast``; the frame is identical either way.
    """
    n = pos.shape[0]
    npix = render_size * render_size
    scale = int(world_size) // render_size  # integer scale (src/main.rs:51)
    dev = pos.device

    x, y = pos[:, 0], pos[:, 1]
    # within_bounds (src/main.rs:223-226): NaN fails all comparisons → out.
    in_b = (y < world_size) & (x < world_size) & (y >= 0.0) & (x >= 0.0)
    zero = torch.zeros((), dtype=pos.dtype, device=dev)
    cx = torch.where(in_b, x, zero).to(torch.int64) // scale
    cy = torch.where(in_b, y, zero).to(torch.int64) // scale
    pix = torch.where(in_b, cy * render_size + cx,
                      torch.full((), npix, dtype=torch.int64, device=dev))

    heavy = mass > heavy_weight
    light = ~heavy
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    # Velocity tint term: 0x10 + min(0xef, sat_u8(speed*10))
    # (src/main.rs:61-63; Rust f32→u8 casts saturate, NaN → 0).
    speed = (vel[:, 0].abs() + vel[:, 1].abs()) * 10.0
    speed = torch.nan_to_num(speed, nan=0.0, posinf=255.0, neginf=0.0)
    v8 = torch.clamp(speed, 0.0, 255.0).to(torch.int32)
    vterm = 0x10 + torch.clamp_max(v8, 0xEF)

    count = torch.zeros(npix + 1, dtype=torch.int32, device=dev)
    count.scatter_add_(0, pix, light.to(torch.int32))
    count = count[:npix]
    if pack_tint is None:
        pack_tint = n < (1 << 22)
    if pack_tint and n >= (1 << 22):
        raise ValueError(f"pack_tint needs idx < 2^22, got N={n}")
    key = torch.where(heavy, _i32(1 << 30, idx),
                      idx * 256 + vterm if pack_tint else idx)
    mx = torch.full((npix + 1,), -1, dtype=torch.int32, device=dev)
    mx.scatter_reduce_(0, pix, key, reduce="amax", include_self=True)
    mx = mx[:npix]
    green = (mx >= (1 << 30)).to(torch.int32)
    has_light = (mx >= 0) & (mx < (1 << 30))
    if pack_tint:
        last = torch.where(has_light, mx // 256, _i32(-1, mx))
        vlast = torch.where(has_light, mx % 256, _i32(0, mx))
    else:
        last = torch.where(has_light, mx, _i32(-1, mx))
        vlast = torch.where(has_light, vterm[torch.clamp_min(last, 0).long()],
                            _i32(0, mx))
    return green, count, last, vlast


def colorize_pixels(green: torch.Tensor, count: torch.Tensor,
                    vlast: torch.Tensor, render_size: int) -> torch.Tensor:
    """Per-pixel reductions → RGBA u8 frame (the src/main.rs:55-68 rules)."""
    grn = green > 0
    lit = count > 0
    z, ff = _i32(0, green), _i32(0xFF, green)
    r = torch.where(grn, z, torch.where(lit, ff, z))
    g = torch.where(grn, ff, torch.where(lit, 0xFF - vlast, z))
    b = torch.where(grn, z, torch.where(lit, 0xFF - vlast, z))
    a = torch.where(grn, ff,
                    torch.where(lit, torch.clamp_max(10 * count, 250), z))
    frame = torch.stack([r, g, b, a], dim=-1).to(torch.uint8)
    return frame.reshape(render_size, render_size, 4)


def render_frame(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
                 world_size: float = 100_000.0, render_size: int = 1250,
                 heavy_weight: float = 10.0) -> torch.Tensor:
    """RGBA u8 framebuffer of shape (render_size, render_size, 4)."""
    green, count, _, vlast = accumulate_pixels(
        pos, vel, mass, world_size, render_size, heavy_weight)
    return colorize_pixels(green, count, vlast, render_size)


def render_frame_sparse(pos: torch.Tensor, vel: torch.Tensor,
                        mass: torch.Tensor, cap: int,
                        world_size: float = 100_000.0,
                        render_size: int = 1250, heavy_weight: float = 10.0):
    """Sparse frame: ``(idx int32[cap], rgba int32[cap])`` of lit pixels in
    pixel order, padded with ``idx = npix``, ``rgba = 0``. ``rgba`` holds the
    packed little-endian RGBA bytes as int32 bit patterns (torch's uint32
    support is thin); ``sparse_to_frame`` reads them back as uint32.

    One particle lights at most one pixel, so cap ≥ the real particle count
    is exact. The device→host copy is proportional to the lit pixels, not
    the 6.25 MB framebuffer. The output's size is fixed, so nothing here
    waits for the device.
    """
    frame = render_frame(pos, vel, mass, world_size=world_size,
                         render_size=render_size, heavy_weight=heavy_weight)
    npix = render_size * render_size
    flat = frame.reshape(npix, 4).to(torch.int64)
    packed = (flat[:, 0] | (flat[:, 1] << 8) | (flat[:, 2] << 16)
              | (flat[:, 3] << 24))
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    lit_idx = torch.nonzero_static(flat[:, 3] > 0, size=cap,
                                   fill_value=npix).flatten()
    vals = torch.where(lit_idx < npix, packed[lit_idx.clamp_max(npix - 1)], 0)
    return lit_idx.to(torch.int32), vals.to(torch.int32)


def sparse_to_frame(idx, vals, render_size: int = 1250) -> np.ndarray:
    """Host-side reconstruction of the dense RGBA frame (native C++ stage
    with a NumPy fallback — runtime/frame.py)."""
    from nbody_simulation_tpu_torch.runtime.frame import reconstruct
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    return reconstruct(np.asarray(idx, np.int32),
                       np.asarray(vals).view(np.uint32), render_size)
