// Native frame utilities for the host side of the render pipeline.
//
// The device ships frames as sparse (pixel index, packed RGBA) pairs
// (ops/raster.py render_frame_sparse); reconstructing the dense framebuffer
// is the per-snapshot host hot path (the reference does its splatting on the
// render thread in native code, src/main.rs:41-72 — this is the equivalent
// native stage of our pipeline, after the physics moved on-device).

#include <cstdint>
#include <cstring>

extern "C" {

// Scatter n (idx, rgba) pairs into a zeroed npix-u32 framebuffer.
// Entries with idx >= npix are padding and skipped.
void frame_reconstruct(const int32_t* idx, const uint32_t* vals, size_t n,
                       uint32_t* out, size_t npix) {
  std::memset(out, 0, npix * sizeof(uint32_t));
  for (size_t i = 0; i < n; ++i) {
    uint32_t j = static_cast<uint32_t>(idx[i]);
    if (j < npix) out[j] = vals[i];
  }
}

// Alpha-composite an RGBA8 frame over black into RGB8 (viewer/GIF path):
// rgb = rgb_in * a / 255.
void frame_composite_black(const uint8_t* rgba, size_t npix, uint8_t* rgb) {
  for (size_t i = 0; i < npix; ++i) {
    uint32_t a = rgba[i * 4 + 3];
    rgb[i * 3 + 0] = static_cast<uint8_t>(rgba[i * 4 + 0] * a / 255);
    rgb[i * 3 + 1] = static_cast<uint8_t>(rgba[i * 4 + 1] * a / 255);
    rgb[i * 3 + 2] = static_cast<uint8_t>(rgba[i * 4 + 2] * a / 255);
  }
}

}  // extern "C"
