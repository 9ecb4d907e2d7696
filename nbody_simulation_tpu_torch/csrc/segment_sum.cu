// Fixed-order segmented row sums for sm_90a: the backward of the
// Barnes-Hut planner's gathers (ops/traversal.py, index_add_ordered).
//
// out[r, c] = Σ_{j : key[j] == r} src[perm[j], c], each row's sum in f64
// and rounded once to f32; a row no key names gets +0.
//
// key is the gather's index sorted stably and perm the permutation that
// sorts it, so each row's duplicates form one run of key, in index order.
// It replaces no TPU kernel: XLA differentiates the JAX package's gather
// (nbody_simulation_tpu/ops/traversal.py:367) into a scatter-add. Every
// group of the planner gathers the same top-level nodes, so a few runs
// are as long as the number of groups and most are a few entries. The
// work is bound by bytes: each gathered f32 row is read once.
//
// A reduce-by-key of the sorted order. segment_windows: one block per
// (window of kWindow consecutive entries, tile of 32 columns), whatever
// the runs, so every block is full and the grid depends on K and the width
// alone. Warp w takes the window's w-th stretch of 32 entries, one key and
// one source row per lane; each lane (a column) loads the stretch's 32
// values, then adds them in index order in f64. Run edges come from the
// key (key[j] != key[j-1]): a run that begins and ends inside a stretch is
// written to out at once; the stretch's first and last runs go to shared
// memory, and warp 0 combines the stretches in warp order, resetting at
// run edges. A run that lies inside the window is then written to out; a
// run cut by a window edge (only the first and the last can be) leaves an
// f64 partial, at most two per window. segment_carry: for each run that
// starts in window a and leaves it, one block cuts its partials (a's and
// those of the windows it covers) into kCarryWarps chunks of consecutive
// windows, adds each chunk in window order and the chunks in order, and
// rounds once. The order of every
// sum depends on the sorted key alone, never on the grid or on timing, so
// two calls give the same bits; no atomics. Plain C interface: built by
// nvcc into a shared library, loaded by ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // columns per block: one warp wide
constexpr int kWarps = 8;     // warps per block: stretches per window
constexpr int kStretch = 32;  // entries per stretch: one per lane
constexpr int kWindow = kWarps * kStretch;
constexpr int kCarryWarps = 16;  // warps per block of segment_carry
constexpr unsigned kAll = 0xffffffffu;

// +0 into rows [lo, hi) of this lane's column: rows that no key names.
__device__ void zero_rows(float* __restrict__ out, int64_t lo, int64_t hi,
                         int64_t n_rows, int width, int col) {
  lo = max(lo, int64_t{0});
  hi = min(hi, n_rows);
  if (col < width) {
    for (int64_t r = lo; r < hi; ++r) out[r * width + col] = 0.0f;
  }
}

template <typename Key>
__global__ void __launch_bounds__(kCols * kWarps)
segment_windows(const float* __restrict__ src, const Key* __restrict__ key,
                const int64_t* __restrict__ perm, int64_t k, int64_t n_rows,
                int width, float* __restrict__ out,
                double* __restrict__ slots) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int64_t win = blockIdx.x;
  const int64_t w0 = win * kWindow;
  const int64_t s0 = w0 + static_cast<int64_t>(warp) * kStretch;
  const int n = static_cast<int>(
      max(int64_t{0}, min(static_cast<int64_t>(kStretch), k - s0)));
  const int col = blockIdx.y * kCols + lane;
  const bool live = col < width;

  // Lane i holds entry s0 + i: its key, its source row, the key before it.
  int64_t my_key = 0, my_row = 0;
  if (lane < n) {
    my_key = static_cast<int64_t>(key[s0 + lane]);
    my_row = perm[s0 + lane];
  }
  int64_t up = __shfl_up_sync(kAll, my_key, 1);
  if (lane == 0) up = (n > 0 && s0 > 0) ? static_cast<int64_t>(key[s0 - 1])
                                        : int64_t{-1};
  const bool starts = lane < n && my_key != up;  // a run begins here
  const unsigned edges = __ballot_sync(kAll, starts);

  // Rows between two runs, before the first run and after the last get +0.
  unsigned gaps = __ballot_sync(kAll, starts && my_key > up + 1);
  while (gaps) {
    const int l = __ffs(gaps) - 1;
    gaps &= gaps - 1;
    zero_rows(out, __shfl_sync(kAll, up, l) + 1, __shfl_sync(kAll, my_key, l),
              n_rows, width, col);
  }
  const int64_t first = __shfl_sync(kAll, my_key, 0);
  const int64_t last = __shfl_sync(kAll, my_key, n > 0 ? n - 1 : 0);
  if (n > 0 && s0 + n == k) {
    zero_rows(out, last + 1, n_rows, n_rows, width, col);
  } else if (k == 0 && win == 0 && warp == 0) {
    zero_rows(out, 0, n_rows, n_rows, width, col);
  }

  // All 32 loads in flight, then the adds in index order.
  float v[kStretch];
#pragma unroll
  for (int i = 0; i < kStretch; ++i) {
    const int64_t r = __shfl_sync(kAll, my_row, i);
    v[i] = (live && i < n) ? src[r * width + col] : 0.0f;
  }
  double acc = 0.0, head = 0.0;
  bool open = true;  // still in the stretch's first run
#pragma unroll
  for (int i = 0; i < kStretch; ++i) {
    if (i < n) {
      if (i > 0 && ((edges >> i) & 1u)) {
        if (open) {
          head = acc;
          open = false;
        } else {  // a run that began and ended inside the stretch
          const int64_t r = __shfl_sync(kAll, my_key, i - 1);
          if (live && r >= 0 && r < n_rows) {
            out[r * width + col] = static_cast<float>(acc);
          }
        }
        acc = 0.0;
      }
      acc += static_cast<double>(v[i]);
    }
  }

  __shared__ double s_head[kWarps][kCols];  // the stretch's first run
  __shared__ double s_tail[kWarps][kCols];  // its last run, if another
  __shared__ int64_t s_first[kWarps], s_last[kWarps];
  __shared__ int s_n[kWarps];
  __shared__ bool s_split[kWarps];          // more than one run
  s_head[warp][lane] = open ? acc : head;
  s_tail[warp][lane] = acc;
  if (lane == 0) {
    s_first[warp] = first;
    s_last[warp] = last;
    s_n[warp] = n;
    s_split[warp] = !open;
  }
  __syncthreads();
  if (warp != 0 || s_n[0] == 0) return;

  // Warp 0 joins the stretches in warp order. A run is written to out if
  // it lies inside the window; else its partial goes to slot 0 (it began
  // in an earlier window) or slot 1 (it begins here and goes on).
  const int64_t end = min(w0 + kWindow, k);
  double* slot0 = slots + (2 * win) * width + col;
  double* slot1 = slot0 + width;
  auto emit = [&](int64_t row, double s, bool left, bool right) {
    if (!live) return;
    if (left) {
      *slot0 = s;
    } else if (right) {
      *slot1 = s;
    } else if (row >= 0 && row < n_rows) {
      out[row * width + col] = static_cast<float>(s);
    }
  };
  int64_t ck = s_first[0];
  bool left = w0 > 0 && static_cast<int64_t>(key[w0 - 1]) == ck;
  double cs = 0.0;
  for (int w = 0; w < kWarps && s_n[w] > 0; ++w) {
    if (s_first[w] != ck) {  // a run edge between stretches w-1 and w
      emit(ck, cs, left, false);
      ck = s_first[w];
      cs = 0.0;
      left = false;
    }
    cs += s_head[w][lane];
    if (s_split[w]) {
      emit(ck, cs, left, false);
      ck = s_last[w];
      cs = s_tail[w][lane];
      left = false;
    }
  }
  emit(ck, cs, left, end < k && static_cast<int64_t>(key[end]) == ck);
}

// One block per (window a, tile of 32 columns): if a run begins in window
// a and goes on past it, its partials are a's slot 1 and slot 0 of every
// later window it reaches. Warp w adds the w-th of kCarryWarps equal
// chunks of them in window order, warp 0 adds the chunks' sums in warp
// order and rounds once. The chunks depend on the run's length alone.
template <typename Key>
__global__ void __launch_bounds__(kCols * kCarryWarps)
segment_carry(const double* __restrict__ slots, const Key* __restrict__ key,
              int64_t n_win, int64_t n_rows, int width,
              float* __restrict__ out) {
  const int64_t a = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int col = blockIdx.y * kCols + lane;
  if (a + 1 >= n_win) return;
  const int64_t end = (a + 1) * kWindow;
  const Key rk = key[end - 1];
  if (key[end] != rk) return;                           // ends in a
  if (a > 0 && key[a * kWindow - 1] == rk) return;      // began before a
  // The last window the run reaches, the last whose first key is rk: each
  // step probes 32 windows at once and keeps the span after the last hit.
  int64_t lo = a + 1, hi = n_win;  // key[lo * kWindow] == rk, answer < hi
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + kCols - 1) / kCols;
    const int64_t probe = lo + lane * step;
    const unsigned hit = __ballot_sync(
        kAll, probe < hi && key[probe * kWindow] == rk);
    lo += (31 - __clz(hit)) * step;
    hi = min(hi, lo + step);
  }
  // Partial t of the run: a's slot 1 (t = 0), then slot 0 of window a + t.
  const int64_t m = lo - a + 1;
  const int64_t chunk = (m + kCarryWarps - 1) / kCarryWarps;
  const int64_t t0 = min(m, warp * chunk), t1 = min(m, t0 + chunk);
  double s = 0.0;
  if (col < width) {
    const double* p = slots + 2 * a * width + col;  // window a's slot 0
#pragma unroll 16
    for (int64_t t = t0; t < t1; ++t) s += p[(t == 0 ? 1 : 2 * t) * width];
  }
  __shared__ double part[kCarryWarps][kCols];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < width) {
    double total = part[0][lane];
    for (int w = 1; w < kCarryWarps; ++w) total += part[w][lane];
    const int64_t row = static_cast<int64_t>(rk);
    if (row >= 0 && row < n_rows) {
      out[row * width + col] = static_cast<float>(total);
    }
  }
}

template <typename Key>
void launch(const float* src, const Key* key, const int64_t* perm,
            double* slots, float* out, int64_t k, int64_t n_rows, int width,
            cudaStream_t s) {
  const int64_t n_win = k > 0 ? (k + kWindow - 1) / kWindow : 1;
  const unsigned tiles = (width + kCols - 1) / kCols;
  const dim3 block(kCols, kWarps);
  segment_windows<Key><<<dim3(static_cast<unsigned>(n_win), tiles), block, 0,
                         s>>>(src, key, perm, k, n_rows, width, out, slots);
  segment_carry<Key><<<dim3(static_cast<unsigned>(n_win), tiles),
                       dim3(kCols, kCarryWarps), 0, s>>>(slots, key, n_win,
                                                         n_rows, width, out);
}

}  // namespace

extern "C" {

// Entries per window: the wrapper sizes the slots from it.
int segment_sum_window() { return kWindow; }

// src f32[k, width], key i32 or i64 (key_bytes 4 or 8) [k] sorted, perm
// i64[k], slots f64[max(1, ceil(k / kWindow)), 2, width] (scratch), out
// f32[n_rows, width]; all contiguous on `device`; width below 2^21, n_rows
// below 2^31. Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int segment_sum_launch(const void* src, const void* key, int key_bytes,
                       const void* perm, void* slots, void* out, long long k,
                       long long n_rows, int width, int device, void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(src);
  const auto* p = static_cast<const int64_t*>(perm);
  auto* sl = static_cast<double*>(slots);
  auto* o = static_cast<float*>(out);
  if (key_bytes == 4) {
    launch(f, static_cast<const int32_t*>(key), p, sl, o, k, n_rows, width,
           s);
  } else if (key_bytes == 8) {
    launch(f, static_cast<const int64_t*>(key), p, sl, o, k, n_rows, width,
           s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
