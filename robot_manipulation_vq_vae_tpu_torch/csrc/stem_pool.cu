// The ResNet stem's 3x3 / stride-2 / pad-1 max pool on NCHW tensors, in fp32
// and bf16: a forward that records which of the 9 window cells won, and a
// backward that routes the gradient through that record.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/stem_pool.py. Those packed two
// columns into one 128-lane vector row so that the stride-2 windows became
// static lane slices; Hopper has no lanes to fill, so the layout here is plain
// NCHW and the stride is an index computation.
//
// Both kernels do a handful of compares or adds per element and are bound by
// device memory on the H100: at the fp32 policy path's [512, 64, 58, 58] the
// forward reads 440.9 MB and writes 110.2 MB of maxima and 27.6 MB of int8
// offsets, 578.7 MB, a bound of 0.1728 ms at 3.35 TB/s, and the backward the
// mirror image; in bf16 at the flagship's [1024, 64, 58, 58] each moves
// 606.3 MB, 0.1810 ms. So each input is read once and each output written
// once, and nothing else reaches device memory:
//
// * pool_fwd_kernel: a block takes a run of whole (n, c) planes, as many as
//   fit kFwdStageBytes of shared memory with their outputs (the stem's
//   58 x 58: 2 planes in fp32, 4 in bf16), so the block's input is one
//   contiguous run of x and its outputs one run of `out` and one of `idx`.
//   A tile per block of a 29 x 29 output plane took four blocks each staging
//   a 17 x 65 patch with a bounds test per scalar load, and stored a 1-byte
//   offset per thread in partial sectors; that per-block work, not the bytes,
//   set its time (bf16 took as long as fp32). Here the input run is copied
//   flat, in its own type, with 16-byte loads (a scalar head up to the first
//   16-byte boundary and a scalar tail), into shared memory at the offset
//   modulo 16 that it has in device memory, so that the vectors land aligned
//   whatever the view's offset (the helpers are stage_run.cuh's, shared with
//   pool_route.cu). Each thread then takes up to kRun adjacent
//   windows of one output row (pool_windows): it reads the 3 input rows'
//   2 kRun + 1 columns once into registers (column 2q + 1 is shared by
//   windows q and q + 1; cells outside the image are -inf, decided by
//   index), and scans each window's 9 taps in row-major order with a strict
//   `>`, so the first maximum wins, as in torch's MaxPool2d and the TPU
//   kernel. bf16 becomes fp32 only to compare: exact, so the compares are
//   bf16's own. The maxima (in the input's type) and the offsets 3 di + dj
//   go to shared memory, again at their device address's offset modulo 16,
//   and after one barrier both runs leave in 16-byte stores with a scalar
//   head and tail.
// * pool_fwd_band_kernel: planes too large for the budget (R3M's stem: a
//   224 x 224 input pools [N, 64, 112, 112], 50,176 B of fp32 input a plane,
//   chip_smoke.py phase 16c) go in full-width bands of R output rows. Output
//   rows [oh0, oh0 + R) need input rows max(0, 2 oh0 - 1) .. min(H - 1,
//   2 (oh0 + R) - 1), whole rows, so a band's input is again one contiguous
//   run of x and its maxima and offsets one run each of `out` and `idx`:
//   the band is staged, scanned by pool_windows and stored exactly as a run
//   of planes is, and each input row is read once more only where two bands
//   share it (one row in 2 R + 1). The bound is the same bytes: at fp32
//   [100, 64, 112, 112] 321.1 MB read and 100.4 MB written, 0.1258 ms at
//   3.35 TB/s. fwd_plan takes the largest R whose band fits kFwdStageBytes
//   (34 rows at fp32 112 x 112), spreads the plane's rows evenly over that
//   many bands (R = 28: 2 bands, 33,424 B), then lowers R until the grid has
//   kFwdMinBlocks blocks, about four per SM (R = 7 at [1, 64, 112, 112]: 512
//   blocks). The tile kernel it replaces staged a 17 x 65 patch per 8 x 32
//   outputs with a scalar load and a bounds test per element, half its
//   blocks the ragged second column tile of a 56-wide output.
//   A row so wide that one band of R = 1 (3 input rows, their maxima and
//   offsets) passes the budget takes dynamic shared memory up to kMaxSmem
//   (227 KB): rows of about 16,000 fp32 or 31,000 bf16 elements. Past that
//   the plan returns cudaErrorInvalidValue and launches nothing.
// * pool_bwd_kernel: a gather with no atomics, a thread per window (p, q).
//   Row i = 2p lies only in window row p, row 2p + 1 in rows p and p + 1,
//   and the same for columns, so the thread owns the 2x2 input quad at rows
//   2p, 2p + 1 and columns 2q, 2q + 1 and needs only windows (p, q),
//   (p, q + 1), (p + 1, q) and (p + 1, q + 1): cell (2p, 2q) takes offset 4
//   of (p, q); (2p, 2q + 1) offsets 3 and 5 of (p, q + 1) and (p, q);
//   (2p + 1, 2q) offsets 1 and 7 of (p + 1, q) and (p, q); (2p + 1, 2q + 1)
//   offsets 0, 2, 6 and 8 of (p + 1, q + 1), (p + 1, q), (p, q + 1), (p, q).
//   That is 9 compares for 4 cells. Each cell adds the g of its matching
//   windows in fp32, from 0, in ascending offset order (the order of the
//   plain version's nine masked adds, so the sums agree bit for bit), rounds
//   once to the gradient's type, as the TPU kernel does, and every cell is
//   written, zeros included. It never reads x.
//   A block takes a tile of the (n, c) plane's windows, the whole plane when
//   its offsets and gradients fit kBwdStageBytes of shared memory (the stem's
//   29 x 29 windows: 4.5 KB in fp32), else a band of rows, or of rows and
//   columns, and stages the tile's offsets and g plus one halo row and column
//   with coalesced loads (cells past the plane get offset -1, which matches
//   nothing), so each offset and gradient leaves device memory once. A thread
//   then writes its quad's two row pairs as one 8-byte float2 (fp32) or one
//   4-byte __nv_bfloat162 (bf16) each where W is even; scalar stores
//   otherwise.
//
// Any H is accepted, and any W up to the band kernel's widest row in the
// forward; the output is floor((H - 1) / 2) + 1 rows by
// floor((W - 1) / 2) + 1 columns. Plane and row offsets are 64-bit; the
// cells of one plane, H * W, must fit an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "stage_run.cuh"

namespace {

constexpr int kFwdThreads = 256;          // forward: threads per block
constexpr int kFwdStageBytes = 40960;     // ... its staged planes or band and outputs at most
constexpr int kRun = 3;                   // ... adjacent windows per thread
constexpr int kFwdMinBlocks = 512;        // band forward: blocks at least, about four per SM
constexpr int kMaxSmem = 232448;          // ... and a band's shared memory at most (227 KB)
constexpr int kBwdThreads = 256;          // backward: threads per block
constexpr int kBwdStageBytes = 16384;     // ... and its staged tile at most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The kRun windows of output row @oh from column @ow0 on (those left of
// column Wo): each one's maximum to so[o + q] and the offset 3 di + dj of
// its first maximum to sk[o + q], o = out0 + oh Wo + ow0. @xp holds the
// plane's input rows from row @row0 on, W elements to a row; cells outside
// the image are -inf, decided by index.
template <typename T>
__device__ __forceinline__ void pool_windows(const T* xp, int row0, int H, int W,
                                             int Wo, int oh, int ow0, T* so,
                                             int8_t* sk, int out0) {
  // rows 2 oh - 1 .. 2 oh + 1, columns 2 ow0 - 1 .. 2 ow0 + 2 kRun - 1
  float v[3][2 * kRun + 1];
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int i = 2 * oh - 1 + di;
    const bool row_in = i >= 0 && i < H;
#pragma unroll
    for (int c = 0; c < 2 * kRun + 1; ++c) {
      const int j = 2 * ow0 - 1 + c;
      v[di][c] = row_in && j >= 0 && j < W ? to_float(xp[(i - row0) * W + j])
                                           : -CUDART_INF_F;
    }
  }
  const int o = out0 + oh * Wo + ow0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    if (ow0 + q < Wo) {
      float best = v[0][2 * q];
      int k_best = 0;
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const float t = v[k / 3][2 * q + k % 3];
        if (t > best) {  // strict: the first maximum in row-major order wins
          best = t;
          k_best = k;
        }
      }
      so[o + q] = from_float<T>(best);
      sk[o + q] = static_cast<int8_t>(k_best);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 4)
    pool_fwd_kernel(const T* __restrict__ x, long long planes, int H, int W,
                    int Ho, int Wo, int planes_per_block, T* __restrict__ out,
                    int8_t* __restrict__ idx) {
  // the block's input run, its maxima and its offsets, each placed at its
  // device address's offset modulo 16
  extern __shared__ __align__(16) unsigned char smem[];
  const long long plane0 = static_cast<long long>(blockIdx.x) * planes_per_block;
  const long long left = planes - plane0;
  const int np = left < planes_per_block ? static_cast<int>(left) : planes_per_block;
  const int hw = H * W, ohw = Ho * Wo;
  const T* xs = x + plane0 * hw;
  T* os = out + plane0 * ohw;
  int8_t* ks = idx + plane0 * ohw;
  const int in_room = stage_room(static_cast<long long>(planes_per_block) * hw * sizeof(T));
  const int out_room = stage_room(static_cast<long long>(planes_per_block) * ohw * sizeof(T));
  T* sx = reinterpret_cast<T*>(smem + mod16(xs));
  T* so = reinterpret_cast<T*>(smem + in_room + mod16(os));
  int8_t* sk = reinterpret_cast<int8_t*>(smem + in_room + out_room + mod16(ks));

  copy_run<kFwdThreads, true>(xs, sx, np * hw);
  __syncthreads();

  const int runs_w = (Wo + kRun - 1) / kRun;
  const int runs = Ho * runs_w;
  for (int e = threadIdx.x; e < np * runs; e += kFwdThreads) {
    const int p = e / runs, r = e - p * runs;
    const int oh = r / runs_w, ow0 = (r - oh * runs_w) * kRun;
    pool_windows(sx + p * hw, 0, H, W, Wo, oh, ow0, so, sk, p * ohw);
  }
  __syncthreads();
  copy_run<kFwdThreads, false>(so, os, np * ohw);
  copy_run<kFwdThreads, false>(sk, ks, np * ohw);
}

// input rows that a band of @R output rows stages at most
__host__ __device__ __forceinline__ long long band_in_rows(long long R, int H) {
  return 2 * R + 1 < H ? 2 * R + 1 : H;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 4)
    pool_fwd_band_kernel(const T* __restrict__ x, int H, int W, int Ho, int Wo,
                         int band_rows, int bands, T* __restrict__ out,
                         int8_t* __restrict__ idx) {
  // the band's input rows, its maxima and its offsets, each placed at its
  // device address's offset modulo 16
  extern __shared__ __align__(16) unsigned char smem[];
  const long long plane = blockIdx.x / bands;
  const int oh0 = static_cast<int>(blockIdx.x - plane * bands) * band_rows;
  const int rows = min(band_rows, Ho - oh0);          // the last band may be short
  const int i0 = max(0, 2 * oh0 - 1);                 // input rows [i0, i1)
  const int i1 = min(H, 2 * (oh0 + rows));
  const T* xs = x + (plane * H + i0) * W;
  T* os = out + (plane * Ho + oh0) * Wo;
  int8_t* ks = idx + (plane * Ho + oh0) * Wo;
  const int in_room = stage_room(band_in_rows(band_rows, H) * W * sizeof(T));
  const int out_room = stage_room(static_cast<long long>(band_rows) * Wo * sizeof(T));
  T* sx = reinterpret_cast<T*>(smem + mod16(xs));
  T* so = reinterpret_cast<T*>(smem + in_room + mod16(os));
  int8_t* sk = reinterpret_cast<int8_t*>(smem + in_room + out_room + mod16(ks));

  copy_run<kFwdThreads, true>(xs, sx, (i1 - i0) * W);
  __syncthreads();

  const int runs_w = (Wo + kRun - 1) / kRun;
  for (int e = threadIdx.x; e < rows * runs_w; e += kFwdThreads) {
    const int r = e / runs_w, ow0 = (e - r * runs_w) * kRun;
    pool_windows(sx, i0, H, W, Wo, oh0 + r, ow0, so, sk, -oh0 * Wo);
  }
  __syncthreads();
  copy_run<kFwdThreads, false>(so, os, rows * Wo);
  copy_run<kFwdThreads, false>(sk, ks, rows * Wo);
}

// two neighbouring cells of a row in one store; @p is 2-element aligned
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    pool_bwd_kernel(const int8_t* __restrict__ idx, const T* __restrict__ g,
                    int H, int W, int Ho, int Wo, int tile_h, int tile_w,
                    int tiles_w, int tiles_per_plane, bool pair_stores,
                    T* __restrict__ dx) {
  // the tile's g, then its offsets, each (tile_h + 1) x (tile_w + 1): the
  // halo row and column hold windows p + 1 and q + 1 of the tile's last
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = tile_w + 1;
  const int staged = (tile_h + 1) * pitch;
  T* sg = reinterpret_cast<T*>(smem);
  int8_t* sk = reinterpret_cast<int8_t*>(sg + staged);

  const long long plane = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x % tiles_per_plane;
  const int p0 = (tile / tiles_w) * tile_h, q0 = (tile % tiles_w) * tile_w;
  const int8_t* kp = idx + plane * Ho * Wo;
  const T* gp = g + plane * Ho * Wo;
#pragma unroll 4
  for (int e = threadIdx.x; e < staged; e += kBwdThreads) {
    const int r = e / pitch, c = e - r * pitch;
    const int p = p0 + r, q = q0 + c;
    const bool in = p < Ho && q < Wo;
    const int o = p * Wo + q;
    sk[e] = in ? kp[o] : static_cast<int8_t>(-1);   // -1 matches no offset
    sg[e] = in ? gp[o] : from_float<T>(0.f);
  }
  __syncthreads();

  const int rows = min(tile_h, Ho - p0), cols = min(tile_w, Wo - q0);
  T* dxp = dx + plane * H * W;
  for (int e = threadIdx.x; e < rows * cols; e += kBwdThreads) {
    const int r = e / cols, c = e - r * cols;
    const int s = r * pitch + c;
    // window (p + a, q + b) is kAB / gAB
    const int k00 = sk[s], k01 = sk[s + 1];
    const int k10 = sk[s + pitch], k11 = sk[s + pitch + 1];
    const float g00 = to_float(sg[s]), g01 = to_float(sg[s + 1]);
    const float g10 = to_float(sg[s + pitch]), g11 = to_float(sg[s + pitch + 1]);
    // cell (2p + a, 2q + b) is dAB; each sums in ascending offset order from 0
    float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
    if (k00 == 4) d00 += g00;
    if (k01 == 3) d01 += g01;
    if (k00 == 5) d01 += g00;
    if (k10 == 1) d10 += g10;
    if (k00 == 7) d10 += g00;
    if (k11 == 0) d11 += g11;
    if (k10 == 2) d11 += g10;
    if (k01 == 6) d11 += g01;
    if (k00 == 8) d11 += g00;

    const int i = 2 * (p0 + r), j = 2 * (q0 + c);
    const bool has_row1 = i + 1 < H, has_col1 = j + 1 < W;
    T* out = dxp + i * W + j;
    if (pair_stores) {   // W even, so column j + 1 exists
      store_pair(out, d00, d01);
      if (has_row1) store_pair(out + W, d10, d11);
    } else {
      out[0] = from_float<T>(d00);
      if (has_col1) out[1] = from_float<T>(d01);
      if (has_row1) {
        out[W] = from_float<T>(d10);
        if (has_col1) out[W + 1] = from_float<T>(d11);
      }
    }
  }
}

// shared memory of a band of @R output rows of W-wide planes of H rows:
// its input rows, maxima and offsets, each in a room of its own
// (stage_room's arithmetic in 64 bits: a row may be far too wide for one)
long long band_bytes(long long R, int H, int W, int elem_bytes) {
  const long long Wo = (W - 1) / 2 + 1;
  const auto room = [](long long bytes) { return (bytes + 15) / 16 * 16 + 16; };
  return room(band_in_rows(R, H) * W * elem_bytes) + room(R * Wo * elem_bytes) +
         room(R * Wo);
}

// How the forward runs on @planes planes of H x W elements of @elem_bytes
// bytes: planes per block of pool_fwd_kernel (0: pool_fwd_band_kernel), the
// blocks, a block's shared memory in bytes, and the output rows of a band
// (0: whole planes). Returns a cudaError_t: cudaErrorInvalidValue for rows
// too wide for one band of a row in kMaxSmem.
int fwd_plan(long long planes, int H, int W, int elem_bytes, long long plan[4]) {
  if (planes < 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long hw = static_cast<long long>(H) * W, ohw = Ho * Wo;
  // a plane's input, maxima and offsets, within the budget less the three
  // runs' alignment slack
  const long long per_plane =
      hw > kFwdStageBytes ? kFwdStageBytes : hw * elem_bytes + ohw * (elem_bytes + 1);
  const long long fit = (kFwdStageBytes - 48) / per_plane;
  if (fit >= 1) {
    const long long per_block = std::max(1LL, std::min(fit, planes));
    plan[0] = per_block;
    plan[1] = (planes + per_block - 1) / per_block;
    plan[2] = stage_room(per_block * hw * elem_bytes) +
              stage_room(per_block * ohw * elem_bytes) + stage_room(per_block * ohw);
    plan[3] = 0;
  } else {
    if (band_bytes(1, H, W, elem_bytes) > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the most rows within the budget, at least one
    long long lo = 1, hi = Ho;
    while (lo < hi) {
      const long long mid = (lo + hi + 1) / 2;
      if (band_bytes(mid, H, W, elem_bytes) <= kFwdStageBytes) lo = mid; else hi = mid - 1;
    }
    // that many bands or more, for kFwdMinBlocks blocks, their rows spread evenly
    const long long want = planes > 0 ? (kFwdMinBlocks + planes - 1) / planes : 1;
    const long long bands = std::max((Ho + lo - 1) / lo, std::min(Ho, want));
    const long long R = (Ho + bands - 1) / bands;
    plan[0] = 0;
    plan[1] = planes * ((Ho + R - 1) / R);
    plan[2] = band_bytes(R, H, W, elem_bytes);
    plan[3] = R;
  }
  return plan[1] > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Lets pool_fwd_band_kernel<T> take up to kMaxSmem of dynamic shared memory,
// once per device: at the launcher's first call there, which runs eagerly,
// before any launch of the band kernel and outside any stream capture.
template <typename T>
int allow_wide_bands() {
  static std::atomic<unsigned long long> done{0};   // bit d: device d
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load() & bit) return 0;
  err = static_cast<int>(cudaFuncSetAttribute(
      pool_fwd_band_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  if (err == 0) done.fetch_or(bit);
  return err;
}

template <typename T>
int launch_fwd(const T* x, long long planes, int H, int W, T* out, int8_t* idx,
               void* stream) {
  if (planes <= 0) return 0;
  long long plan[4];
  int err = fwd_plan(planes, H, W, sizeof(T), plan);
  if (err == 0) err = allow_wide_bands<T>();
  if (err != 0) return err;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const unsigned blocks = static_cast<unsigned>(plan[1]);
  const size_t smem = static_cast<size_t>(plan[2]);
  if (plan[0] > 0) {
    pool_fwd_kernel<T><<<blocks, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, planes, H, W, Ho, Wo, static_cast<int>(plan[0]), out, idx);
  } else {
    const int R = static_cast<int>(plan[3]);
    pool_fwd_band_kernel<T><<<blocks, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, H, W, Ho, Wo, R, (Ho + R - 1) / R, out, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's tiling of dx [planes, H, W] of @elem_bytes-byte elements:
// the largest tile of windows whose staged g and offsets, halo included, fit
// kBwdStageBytes (whole rows where two of them fit, else column tiles).
// @plan gets the tile's window rows and columns, the blocks and a block's
// shared memory in bytes.
int bwd_plan(long long planes, int H, int W, int elem_bytes, long long plan[4]) {
  if (H <= 0 || W <= 0 || static_cast<long long>(H) * W > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int stage_max = kBwdStageBytes / (elem_bytes + 1);
  const int tile_w = std::min(Wo, stage_max / 2 - 1);
  const int tile_h = std::min(Ho, stage_max / (tile_w + 1) - 1);
  const int tiles_w = (Wo + tile_w - 1) / tile_w;
  const long long blocks =
      planes * tiles_w * static_cast<long long>((Ho + tile_h - 1) / tile_h);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = tile_h;
  plan[1] = tile_w;
  plan[2] = blocks;
  plan[3] = static_cast<long long>(tile_h + 1) * (tile_w + 1) * (elem_bytes + 1);
  return 0;
}

template <typename T>
int launch_bwd(const int8_t* idx, const T* g, long long planes, int H, int W,
               T* dx, void* stream) {
  if (planes <= 0) return 0;
  long long plan[4];
  const int err = bwd_plan(planes, H, W, sizeof(T), plan);
  if (err != 0) return err;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tile_h = static_cast<int>(plan[0]), tile_w = static_cast<int>(plan[1]);
  const int tiles_w = (Wo + tile_w - 1) / tile_w;
  const int tiles_per_plane = tiles_w * ((Ho + tile_h - 1) / tile_h);
  const bool pair_stores =
      W % 2 == 0 && reinterpret_cast<uintptr_t>(dx) % (2 * sizeof(T)) == 0;
  pool_bwd_kernel<T><<<static_cast<unsigned>(plan[2]), kBwdThreads,
                       static_cast<size_t>(plan[3]), static_cast<cudaStream_t>(stream)>>>(
      idx, g, H, W, Ho, Wo, tile_h, tile_w, tiles_w, tiles_per_plane,
      pair_stores, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* stem_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward's plan for x [planes, H, W] of @elem_bytes-byte elements (4:
// fp32, 2: bf16), as stem_pool_fwd*_launch takes it: @plan gets the planes
// per block (0: the band kernel of planes past the budget), the blocks, a
// block's shared memory in bytes, and a band's output rows (0: whole
// planes). Returns a cudaError_t, cudaErrorInvalidValue for rows too wide
// for the band kernel; launches nothing.
extern "C" int stem_pool_fwd_plan(long long planes, int H, int W, int elem_bytes,
                                  long long* plan) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_plan(planes, H, W, elem_bytes, plan);
}

// The backward's plan for dx [planes, H, W] (see bwd_plan): the tile's
// window rows and columns (whole planes where they are Ho and Wo), the
// blocks and a block's shared memory in bytes. Launches nothing.
extern "C" int stem_pool_bwd_plan(long long planes, int H, int W, int elem_bytes,
                                  long long* plan) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_plan(planes, H, W, elem_bytes, plan);
}

// x [planes, H, W], contiguous (planes = N * C), at any element offset;
// writes out [planes, Ho, Wo] in x's type and idx [planes, Ho, Wo] int8.
// Launches on @stream and returns cudaGetLastError(), or the plan's error
// without a launch.
extern "C" int stem_pool_fwd_launch(const float* x, long long planes, int H,
                                    int W, float* out, int8_t* idx,
                                    void* stream) {
  return launch_fwd(x, planes, H, W, out, idx, stream);
}

extern "C" int stem_pool_fwd_bf16_launch(const __nv_bfloat16* x,
                                         long long planes, int H, int W,
                                         __nv_bfloat16* out, int8_t* idx,
                                         void* stream) {
  return launch_fwd(x, planes, H, W, out, idx, stream);
}

// idx (int8) and g [planes, Ho, Wo], contiguous; writes every cell of dx
// [planes, H, W] in g's type. Launches on @stream and returns
// cudaGetLastError().
extern "C" int stem_pool_bwd_launch(const int8_t* idx, const float* g,
                                    long long planes, int H, int W, float* dx,
                                    void* stream) {
  return launch_bwd(idx, g, planes, H, W, dx, stream);
}

extern "C" int stem_pool_bwd_bf16_launch(const int8_t* idx,
                                         const __nv_bfloat16* g,
                                         long long planes, int H, int W,
                                         __nv_bfloat16* dx, void* stream) {
  return launch_bwd(idx, g, planes, H, W, dx, stream);
}
