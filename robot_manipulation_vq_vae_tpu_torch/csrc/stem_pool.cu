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
//   windows of one output row: it reads the 3 input rows' 2 kRun + 1 columns
//   once into registers (column 2q + 1 is shared by windows q and q + 1;
//   cells outside the image are -inf, decided by index), and scans each
//   window's 9 taps in row-major order with a strict `>`, so the first
//   maximum wins, as in torch's MaxPool2d and the TPU kernel. bf16 becomes
//   fp32 only to compare: exact, so the compares are bf16's own. The maxima
//   (in the input's type) and the offsets 3 di + dj go to shared memory,
//   again at their device address's offset modulo 16, and after one barrier
//   both runs leave in 16-byte stores with a scalar head and tail.
//   pool_fwd_tile_kernel keeps the tile design for planes too large for the
//   budget; the launcher picks the kernel by plane size (no model path
//   reaches the tile kernel).
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
// Any H and W are accepted; the output is floor((H - 1) / 2) + 1 rows by
// floor((W - 1) / 2) + 1 columns. Plane offsets are 64-bit; in the backward
// the cells of one plane, H * W, must fit an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "stage_run.cuh"

namespace {

constexpr int kFwdThreads = 256;          // forward: threads per block
constexpr int kFwdStageBytes = 40960;     // ... its staged planes and outputs at most
constexpr int kRun = 3;                   // ... adjacent windows per thread
constexpr int kTileW = 32;                // tile forward: output columns per block
constexpr int kTileH = 8;                 // ... output rows per block
constexpr int kThreads = kTileW * kTileH;
constexpr int kPatchH = 2 * kTileH + 1;   // ... input rows of a tile, halo included
constexpr int kPatchW = 2 * kTileW + 1;
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
    const T* xp = sx + p * hw;
    // rows 2 oh - 1 .. 2 oh + 1, columns 2 ow0 - 1 .. 2 ow0 + 2 kRun - 1
    float v[3][2 * kRun + 1];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int i = 2 * oh - 1 + di;
      const bool row_in = i >= 0 && i < H;
#pragma unroll
      for (int c = 0; c < 2 * kRun + 1; ++c) {
        const int j = 2 * ow0 - 1 + c;
        v[di][c] = row_in && j >= 0 && j < W ? to_float(xp[i * W + j]) : -CUDART_INF_F;
      }
    }
    const int o = p * ohw + oh * Wo + ow0;
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
  __syncthreads();
  copy_run<kFwdThreads, false>(so, os, np * ohw);
  copy_run<kFwdThreads, false>(sk, ks, np * ohw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_fwd_tile_kernel(const T* __restrict__ x, int H, int W, int Ho, int Wo,
                         int tiles_w, int tiles_per_plane, T* __restrict__ out,
                         int8_t* __restrict__ idx) {
  // fp32 in shared memory whatever T is: bf16 -> fp32 is exact, so the
  // compares and the maximum are the input type's own
  __shared__ float patch[kPatchH][kPatchW];
  const long long plane = blockIdx.x / tiles_per_plane;
  const int tile = blockIdx.x % tiles_per_plane;
  const int oh0 = (tile / tiles_w) * kTileH;
  const int ow0 = (tile % tiles_w) * kTileW;
  const T* xp = x + plane * H * W;
  const int ih0 = 2 * oh0 - 1, iw0 = 2 * ow0 - 1;
  for (int e = threadIdx.x; e < kPatchH * kPatchW; e += kThreads) {
    const int r = e / kPatchW, c = e % kPatchW;
    const int i = ih0 + r, j = iw0 + c;
    patch[r][c] = (i >= 0 && i < H && j >= 0 && j < W)
                      ? to_float(xp[static_cast<long long>(i) * W + j])
                      : -CUDART_INF_F;
  }
  __syncthreads();

  const int ty = threadIdx.x / kTileW, tx = threadIdx.x % kTileW;
  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh >= Ho || ow >= Wo) return;
  float best = patch[2 * ty][2 * tx];
  int k_best = 0;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float v = patch[2 * ty + k / 3][2 * tx + k % 3];
    if (v > best) {  // strict: the first maximum in row-major order wins
      best = v;
      k_best = k;
    }
  }
  const long long o = plane * Ho * Wo + static_cast<long long>(oh) * Wo + ow;
  out[o] = from_float<T>(best);
  idx[o] = static_cast<int8_t>(k_best);
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

// How the forward runs on @planes planes of H x W elements of @elem_bytes
// bytes: planes per block of pool_fwd_kernel (0: pool_fwd_tile_kernel), the
// blocks, and a block's shared memory in bytes. Returns a cudaError_t.
int fwd_plan(long long planes, int H, int W, int elem_bytes, long long plan[3]) {
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
  } else {
    const long long tiles_w = (Wo + kTileW - 1) / kTileW;
    plan[0] = 0;
    plan[1] = planes * tiles_w * ((Ho + kTileH - 1) / kTileH);
    plan[2] = sizeof(float) * kPatchH * kPatchW;
  }
  return plan[1] > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <typename T>
int launch_fwd(const T* x, long long planes, int H, int W, T* out, int8_t* idx,
               void* stream) {
  if (planes <= 0) return 0;
  long long plan[3];
  const int err = fwd_plan(planes, H, W, sizeof(T), plan);
  if (err != 0) return err;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const unsigned blocks = static_cast<unsigned>(plan[1]);
  if (plan[0] > 0) {
    pool_fwd_kernel<T><<<blocks, kFwdThreads, static_cast<size_t>(plan[2]),
                         static_cast<cudaStream_t>(stream)>>>(
        x, planes, H, W, Ho, Wo, static_cast<int>(plan[0]), out, idx);
  } else {
    const int tiles_w = (Wo + kTileW - 1) / kTileW;
    const int tiles_per_plane = tiles_w * ((Ho + kTileH - 1) / kTileH);
    pool_fwd_tile_kernel<T><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, H, W, Ho, Wo, tiles_w, tiles_per_plane, out, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const int8_t* idx, const T* g, long long planes, int H, int W,
               T* dx, void* stream) {
  if (planes <= 0) return 0;
  if (H <= 0 || W <= 0 || static_cast<long long>(H) * W > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  // the largest tile whose staged g and offsets, halo included, fit
  // kBwdStageBytes: whole rows where two of them fit, else column tiles
  const int stage_max = kBwdStageBytes / static_cast<int>(sizeof(T) + 1);
  const int tile_w = std::min(Wo, stage_max / 2 - 1);
  const int tile_h = std::min(Ho, stage_max / (tile_w + 1) - 1);
  const int tiles_w = (Wo + tile_w - 1) / tile_w;
  const int tiles_per_plane = tiles_w * ((Ho + tile_h - 1) / tile_h);
  const long long blocks = planes * tiles_per_plane;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile_h + 1) * (tile_w + 1) * (sizeof(T) + 1);
  const bool pair_stores =
      W % 2 == 0 && reinterpret_cast<uintptr_t>(dx) % (2 * sizeof(T)) == 0;
  pool_bwd_kernel<T><<<static_cast<unsigned>(blocks), kBwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
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
// per block (0: the tile kernel of planes past the budget), the blocks, and
// a block's shared memory in bytes. Returns a cudaError_t; launches nothing.
extern "C" int stem_pool_fwd_plan(long long planes, int H, int W, int elem_bytes,
                                  long long* plan) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_plan(planes, H, W, elem_bytes, plan);
}

// x [planes, H, W], contiguous (planes = N * C), at any element offset;
// writes out [planes, Ho, Wo] in x's type and idx [planes, Ho, Wo] int8.
// Launches on @stream and returns cudaGetLastError().
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
