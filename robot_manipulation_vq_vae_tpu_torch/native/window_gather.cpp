// Native host-side data-path kernels.
//
// The hot loop of the HDF5 loader is, per batch sample, a windowed gather
// with edge padding at demo boundaries (reference SequenceDataset
// get_sequence_from_demo, dataset.py:588-632) followed by stacking into a
// contiguous batch. Doing this per-sample in Python costs one slice + pad +
// copy per (sample, key); these kernels do the whole batch for one key in a
// single call, releasing the GIL-equivalent (pure C, no Python objects), so
// loader threads scale.
//
// Layout: src is a [T, row_bytes] contiguous demo array; out is
// [N, W, row_bytes]. For sample n the window covers demo rows
// [start[n], start[n] + W) clamped to [0, T), with out-of-range rows
// replaced by the edge row (pad_same semantics).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread window_gather.cpp -o libwindow_gather.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Batched edge-padded window gather (single source demo).
//   src:       [t_len, row_bytes] bytes
//   out:       [n, window, row_bytes] bytes
//   starts:    [n] window start indices (may be negative / past the end)
void gather_windows(const uint8_t* src, uint8_t* out,
                    const int64_t* starts, int64_t n, int64_t window,
                    int64_t t_len, int64_t row_bytes) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t start = starts[i];
    uint8_t* dst = out + i * window * row_bytes;
    for (int64_t w = 0; w < window; ++w) {
      int64_t t = start + w;
      if (t < 0) t = 0;
      if (t >= t_len) t = t_len - 1;
      std::memcpy(dst + w * row_bytes, src + t * row_bytes, row_bytes);
    }
  }
}

// Scatter variant: like gather_windows, but each sample i writes to row
// dst_idx[i] of out - lets one preallocated batch buffer be filled by
// several per-demo calls with no intermediate copy.
static void gather_at_range(const uint8_t* src, uint8_t* out,
                            const int64_t* dst_idx, const int64_t* starts,
                            int64_t lo, int64_t hi, int64_t window,
                            int64_t t_len, int64_t row_bytes) {
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t start = starts[i];
    uint8_t* dst = out + dst_idx[i] * window * row_bytes;
    for (int64_t w = 0; w < window; ++w) {
      int64_t t = start + w;
      if (t < 0) t = 0;
      if (t >= t_len) t = t_len - 1;
      std::memcpy(dst + w * row_bytes, src + t * row_bytes, row_bytes);
    }
  }
}

void gather_windows_at(const uint8_t* src, uint8_t* out,
                       const int64_t* dst_idx, const int64_t* starts,
                       int64_t n, int64_t window, int64_t t_len,
                       int64_t row_bytes) {
  gather_at_range(src, out, dst_idx, starts, 0, n, window, t_len, row_bytes);
}

// Multithreaded scatter gather: the single-core memcpy loop is the loader's
// bottleneck at flagship image shapes (~300 MB/batch); chunking samples
// across threads scales it toward memory bandwidth. Each sample writes a
// disjoint output row, so threads never overlap.
void gather_windows_at_mt(const uint8_t* src, uint8_t* out,
                          const int64_t* dst_idx, const int64_t* starts,
                          int64_t n, int64_t window, int64_t t_len,
                          int64_t row_bytes, int64_t n_threads) {
  n_threads = std::min<int64_t>(n_threads, n);
  if (n_threads <= 1) {
    gather_at_range(src, out, dst_idx, starts, 0, n, window, t_len,
                    row_bytes);
    return;
  }
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(gather_at_range, src, out, dst_idx, starts, lo, hi,
                         window, t_len, row_bytes);
  }
  for (auto& th : threads) th.join();
}

// Multi-demo variant: each sample selects its own source demo.
//   srcs:      [n] pointers to [t_lens[i], row_bytes] demo arrays
void gather_windows_multi(const uint8_t** srcs, const int64_t* t_lens,
                          uint8_t* out, const int64_t* starts, int64_t n,
                          int64_t window, int64_t row_bytes) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = srcs[i];
    const int64_t t_len = t_lens[i];
    const int64_t start = starts[i];
    uint8_t* dst = out + i * window * row_bytes;
    for (int64_t w = 0; w < window; ++w) {
      int64_t t = start + w;
      if (t < 0) t = 0;
      if (t >= t_len) t = t_len - 1;
      std::memcpy(dst + w * row_bytes, src + t * row_bytes, row_bytes);
    }
  }
}

// Pad-mask fill: mask[i, w] = 1 iff the window row is in-range.
void window_pad_masks(uint8_t* mask, const int64_t* starts,
                      const int64_t* t_lens, int64_t n, int64_t window) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t start = starts[i];
    const int64_t t_len = t_lens[i];
    for (int64_t w = 0; w < window; ++w) {
      const int64_t t = start + w;
      mask[i * window + w] = (t >= 0 && t < t_len) ? 1 : 0;
    }
  }
}

}  // extern "C"
