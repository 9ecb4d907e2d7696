// Fixed-order segmented row sums for sm_90a: the backward of the
// Barnes-Hut planner's gathers (ops/traversal.py, index_add_ordered).
//
// out[r, c] = Σ_{j in [edges[r], edges[r+1])} src[perm[j], c]
//
// perm is a stable sort of the gather's index, so each row's run holds
// its duplicates in index order. Every group of the planner gathers the
// same top-level nodes, so a few runs are as long as the number of groups
// and most are short. Each run is cut into pieces of `piece` entries (the
// last one shorter); offsets[r] is the index of row r's first piece.
// segment_pieces: one block per (piece, tile of 32 columns); warp w adds
// the piece's w-th stretch of piece/kSlices entries in f64, in order, and
// the block adds the warps' partials in warp order into the piece's f64
// slot. segment_fold: one thread per (row, column) adds the row's slots
// in piece order and rounds once to f32 (a row with no entry gets +0).
// The order depends on the run alone, never on the grid or on timing, so
// two calls give the same bits; no atomics. Plain C interface: built by
// nvcc into a shared library, loaded by ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // columns per block: one warp wide
constexpr int kSlices = 8;    // warps per block
constexpr int kFoldThreads = 256;

// The row whose pieces hold piece b: the last r with offsets[r] <= b.
__device__ int64_t row_of_piece(const int64_t* __restrict__ offsets,
                                int64_t n_rows, int64_t b) {
  int64_t lo = 0, hi = n_rows;  // offsets[lo] <= b < offsets[hi]
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (offsets[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kCols * kSlices)
segment_pieces(const float* __restrict__ src, const int64_t* __restrict__ perm,
               const int64_t* __restrict__ edges,
               const int64_t* __restrict__ offsets, int64_t n_rows,
               double* __restrict__ slots, int width, int piece) {
  const int64_t b = blockIdx.x;
  if (b >= offsets[n_rows]) return;  // the grid is an upper bound
  const int64_t r = row_of_piece(offsets, n_rows, b);
  const int64_t start = edges[r] + (b - offsets[r]) * piece;
  const int64_t end = min(start + piece, edges[r + 1]);
  const int per = piece / kSlices;
  const int col = blockIdx.y * kCols + threadIdx.x;
  double acc = 0.0;
  if (col < width) {
    const int64_t lo = start + threadIdx.y * per;
    const int64_t hi = min(lo + per, end);
    int64_t j = lo;
    // Four independent loads in flight, added in order.
    for (; j + 4 <= hi; j += 4) {
      const float v0 = src[perm[j] * width + col];
      const float v1 = src[perm[j + 1] * width + col];
      const float v2 = src[perm[j + 2] * width + col];
      const float v3 = src[perm[j + 3] * width + col];
      acc += static_cast<double>(v0);
      acc += static_cast<double>(v1);
      acc += static_cast<double>(v2);
      acc += static_cast<double>(v3);
    }
    for (; j < hi; ++j) acc += static_cast<double>(src[perm[j] * width + col]);
  }
  __shared__ double part[kSlices][kCols];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    double s = part[0][threadIdx.x];
    for (int k = 1; k < kSlices; ++k) s += part[k][threadIdx.x];
    slots[b * width + col] = s;
  }
}

__global__ void __launch_bounds__(kFoldThreads)
segment_fold(const double* __restrict__ slots,
             const int64_t* __restrict__ offsets, float* __restrict__ out,
             int64_t n_rows, int width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kFoldThreads +
                    threadIdx.x;
  if (i >= n_rows * width) return;
  const int64_t r = i / width;
  const int64_t c = i - r * width;
  double s = 0.0;
  for (int64_t b = offsets[r]; b < offsets[r + 1]; ++b) {
    s += slots[b * width + c];
  }
  out[i] = static_cast<float>(s);
}

}  // namespace

extern "C" {

// src f32[K, width], perm i64[K], edges i64[n_rows + 1], offsets i64[n_rows
// + 1] (row r's first piece; offsets[n_rows] pieces in all), slots
// f64[max_pieces, width], out f32[n_rows, width]; all contiguous on
// `device`. `max_pieces` bounds offsets[n_rows] and sets the grid;
// `piece` is a multiple of 8. Launches both kernels on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
int segment_sum_launch(const void* src, const void* perm, const void* edges,
                       const void* offsets, void* slots, void* out,
                       long long n_rows, long long max_pieces, int width,
                       int piece, int device, void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_pieces > 0) {
    const dim3 grid(static_cast<unsigned>(max_pieces),
                    (width + kCols - 1) / kCols);
    segment_pieces<<<grid, dim3(kCols, kSlices), 0, s>>>(
        static_cast<const float*>(src), static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(edges),
        static_cast<const int64_t*>(offsets), n_rows,
        static_cast<double*>(slots), width, piece);
  }
  const long long n = n_rows * width;
  segment_fold<<<static_cast<unsigned>((n + kFoldThreads - 1) /
                                       kFoldThreads),
                 kFoldThreads, 0, s>>>(
      static_cast<const double*>(slots), static_cast<const int64_t*>(offsets),
      static_cast<float*>(out), n_rows, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
