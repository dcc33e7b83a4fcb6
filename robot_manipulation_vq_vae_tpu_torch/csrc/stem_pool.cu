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
// offsets, the backward the mirror image, 578.7 MB each, about 0.173 ms at
// 3.35 TB/s; in bf16 at the flagship's [1024, 64, 58, 58] about 606 MB each,
// 0.181 ms. So each input is read once with coalesced loads and each output
// written once, and nothing else reaches device memory:
//
// * pool_fwd_kernel: a block takes a tile of kTileH x kTileW outputs of one
//   (n, c) plane, stages the (2 kTileH + 1) x (2 kTileW + 1) input patch,
//   halo included, in shared memory (row-contiguous loads; cells outside the
//   image become -inf), and each thread scans its 9 taps in row-major order
//   with a strict `>`, so the first maximum wins, as in torch's MaxPool2d and
//   the TPU kernel. It writes the maximum (in the input's type: the max of
//   bf16 values is exact) and the offset 3 di + dj.
// * pool_bwd_kernel: a gather with no atomics. A warp walks one input row,
//   a thread one cell (i, j) at a time, with no 64-bit division in the
//   index arithmetic (the first version divided a 64-bit flat index per
//   cell and ran at 5.5x its bound). Row i = 2m lies only in output row m,
//   row i = 2m + 1 in rows m and m + 1, and the same for columns, so 1, 2
//   or 4 windows cover a cell;
//   the thread adds g[p, q] of each covering window whose recorded offset is
//   this cell's, in fp32 and in ascending offset order (the order of the plain
//   version's nine masked adds, so the sums agree bit for bit), rounds once to
//   the gradient's type, as the TPU kernel does, and writes every cell, zeros
//   included. It never reads x.
//
// Any H and W are accepted; the output is floor((H - 1) / 2) + 1 rows by
// floor((W - 1) / 2) + 1 columns. Element offsets are 64-bit; the number of
// input rows, N * C * H, must fit an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;                // output columns per block: a warp
constexpr int kTileH = 8;                 // output rows per block
constexpr int kThreads = kTileW * kTileH;
constexpr int kPatchH = 2 * kTileH + 1;   // input rows of a tile, halo included
constexpr int kPatchW = 2 * kTileW + 1;
constexpr int kBwdCols = 32;              // backward: a warp per input row
constexpr int kBwdRows = 8;               // ... and 8 rows per block

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
__global__ void __launch_bounds__(kThreads)
    pool_fwd_kernel(const T* __restrict__ x, int H, int W, int Ho, int Wo,
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

template <typename T>
__global__ void __launch_bounds__(kBwdCols * kBwdRows)
    pool_bwd_kernel(const int8_t* __restrict__ idx, const T* __restrict__ g,
                    int rows, int H, int W, int Ho, int Wo,
                    T* __restrict__ dx) {
  const int row = blockIdx.x * kBwdRows + threadIdx.y;   // plane * H + i
  if (row >= rows) return;
  const int i = row % H;
  const long long base = static_cast<long long>(row / H) * Ho * Wo;
  T* dx_row = dx + static_cast<long long>(row) * W;
  // covering windows: p in [i / 2, (i + 1) / 2], q likewise; walking p and q
  // downwards walks di = i - 2p + 1 and dj = j - 2q + 1 upwards
  const int p_lo = i / 2, p_hi = min((i + 1) / 2, Ho - 1);
  for (int j = threadIdx.x; j < W; j += kBwdCols) {
    const int q_lo = j / 2, q_hi = min((j + 1) / 2, Wo - 1);
    float acc = 0.f;
    for (int p = p_hi; p >= p_lo; --p) {
      const int di = i - 2 * p + 1;
      for (int q = q_hi; q >= q_lo; --q) {
        const long long o = base + static_cast<long long>(p) * Wo + q;
        if (__ldg(idx + o) == 3 * di + (j - 2 * q + 1)) acc += to_float(g[o]);
      }
    }
    dx_row[j] = from_float<T>(acc);
  }
}

template <typename T>
int launch_fwd(const T* x, long long planes, int H, int W, T* out, int8_t* idx,
               void* stream) {
  if (planes <= 0) return 0;
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  const int tiles_per_plane = tiles_w * ((Ho + kTileH - 1) / kTileH);
  const long long blocks = planes * tiles_per_plane;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pool_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, H, W, Ho, Wo, tiles_w, tiles_per_plane, out, idx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const int8_t* idx, const T* g, long long planes, int H, int W,
               T* dx, void* stream) {
  if (planes <= 0) return 0;
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long rows = planes * H;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((rows + kBwdRows - 1) / kBwdRows);
  pool_bwd_kernel<T><<<blocks, dim3(kBwdCols, kBwdRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      idx, g, static_cast<int>(rows), H, W, Ho, Wo, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* stem_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [planes, H, W], contiguous (planes = N * C); writes out [planes, Ho, Wo]
// in x's type and idx [planes, Ho, Wo] int8. Launches on @stream and returns
// cudaGetLastError().
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
