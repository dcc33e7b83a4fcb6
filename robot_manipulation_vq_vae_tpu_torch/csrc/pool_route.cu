// The backward of the 3x3 / stride-2 / pad-1 max pool by equality routing,
// on NCHW tensors with H and W even, in fp32 and bf16:
//
//   dx[i, j] = sum over the windows (p, q) covering (i, j)
//              of dz[p, q] * [x[i, j] == z[p, q]]
//
// so a tied cotangent goes to every cell equal to its window's maximum.
//
// Replaces the TPU kernel `_pool_bwd_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/pool_kernel.py (the backward of
// ops/pool.py::max_pool). That kernel packed the column parity into the lane
// dimension and repeated the pooled rows to input resolution in VMEM; here
// the windows of a cell come from index arithmetic. Input row i = 2p + r lies
// in window row p, and for r = 1 also in p + 1; the same for columns. So the
// 2 x 2 quad of cells at rows 2p, 2p + 1 and columns 2q, 2q + 1 needs only
// windows (p, q), (p, q + 1), (p + 1, q) and (p + 1, q + 1): cell (2p, 2q)
// the first, (2p, 2q + 1) the first two, (2p + 1, 2q) the first and third,
// (2p + 1, 2q + 1) all four, 9 compares for 4 cells. Each cell adds its
// terms in the TPU kernel's order, (p, q), (p, q + 1), (p + 1, q),
// (p + 1, q + 1); a term that the cell's parity or the border (decided by
// index: p + 1 < Ho, q + 1 < Wo) leaves out is skipped rather than added as
// +0, which can change only the sign of a zero sum, and -0 == +0. The sum is
// kept in the gradient's type, rounded after each add as the TPU kernel (and
// the plain version) adds: in bf16 the fp32 sum rounded to nearest even. The
// compares run in fp32, which is exact for bf16.
//
// The work is 9 compares and 5 adds per quad against reading x, z and dz
// once and writing dx once: at [3072, 64, 58, 58] that is 6.61 GB in fp32
// and 3.31 GB in bf16, 1.97 and 0.99 ms at 3.35 TB/s, so the kernel is bound
// by device memory, and a design that spends a load instruction or a compare
// per element too many becomes bound by its instructions instead (a warp per
// input row that read its windows through L1 for every cell took 4.6 and
// 4.2 ms, bf16 barely faster than fp32).
//
// * pool_route_kernel: a block takes a run of whole (n, c) planes, as many
//   as fit kStageBytes of shared memory (the stem's 58 x 58: 2 planes in
//   fp32, 4 in bf16), so its x, z and dz are one contiguous run each. They
//   are staged flat in their own type with 16-byte loads, each at its own
//   device address's offset modulo 16 (stage_run.cuh, shared with
//   stem_pool.cu). A thread then takes a strip of kPairs adjacent quads of
//   one window row p: it loads the kPairs + 1 values of z and of dz on rows
//   p and p + 1 into registers once, and writes each cell's dx in place over
//   its x, so that no thread touches another's cells. After one barrier the
//   dx run leaves in 16-byte stores with a scalar head and tail (one
//   element a thread where x's offset modulo 16 differs from dx's). On an
//   H100 at [3072, 64, 58, 58] this takes 2.23 ms in fp32 and 1.24 ms in
//   bf16, 1.13 and 1.25 x the bound; strips of 3 quads were 1-2 % slower,
//   and staging only z and dz while x and dx streamed through registers as
//   16-byte vectors took 2.42 and 1.75 ms (its per-element index stepping).
// * pool_route_row_kernel: the planes whose run does not fit (224 x 224 in
//   fp32, say): a warp per input row, its windows read from device memory.
//
// route_plan picks the kernel by plane size; the launcher, the exported
// pool_route_plan and the tests all read it. Every cell of dx is written
// once, zeros included, with no atomics. Element offsets are 64-bit. The
// plane runs index by plane and take any N * C whose blocks fit the grid
// (2^31 - 1); on the row path the number of input rows, N * C * H, must fit
// an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "stage_run.cuh"

namespace {

constexpr int kThreads = 256;        // threads per block, both kernels
constexpr int kStageBytes = 40960;   // plane runs: a block's staged x, z, dz at most
constexpr int kPairs = 4;            // ... adjacent quads of a window row per thread
constexpr int kRowCols = 32;         // row kernel: a warp per input row
constexpr int kRowsPerBlock = kThreads / kRowCols;

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

// a + b in T, held as a float: in fp32 the sum itself; in bf16 the fp32 sum
// rounded to nearest even, which is what torch's and XLA's bf16 adds give
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return to_float(from_float<T>(a + b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    pool_route_kernel(const T* __restrict__ x, const T* __restrict__ z,
                      const T* __restrict__ dz, long long planes, int H, int W,
                      int planes_per_block, T* __restrict__ dx) {
  // the block's x run (then its dx, in place), z run and dz run, each at
  // its device address's offset modulo 16
  extern __shared__ __align__(16) unsigned char smem[];
  const long long plane0 = static_cast<long long>(blockIdx.x) * planes_per_block;
  const long long left = planes - plane0;
  const int np = left < planes_per_block ? static_cast<int>(left) : planes_per_block;
  const int Ho = H / 2, Wo = W / 2;
  const int hw = H * W, ohw = Ho * Wo;
  const T* xs = x + plane0 * hw;
  const T* zs = z + plane0 * ohw;
  const T* ds = dz + plane0 * ohw;
  T* os = dx + plane0 * hw;
  const int z_room = stage_room(static_cast<long long>(planes_per_block) * ohw * sizeof(T));
  T* sz = reinterpret_cast<T*>(smem + mod16(zs));
  T* sd = reinterpret_cast<T*>(smem + z_room + mod16(ds));
  T* sx = reinterpret_cast<T*>(smem + 2 * z_room + mod16(xs));
  copy_run<kThreads, true>(zs, sz, np * ohw);
  copy_run<kThreads, true>(ds, sd, np * ohw);
  copy_run<kThreads, true>(xs, sx, np * hw);
  __syncthreads();

  const int groups = (Wo + kPairs - 1) / kPairs;   // strips of a window row
  const int strips = Ho * groups;                  // ... of a plane
  for (int e = threadIdx.x; e < np * strips; e += kThreads) {
    const int pl = e / strips, r = e - pl * strips;
    const int p = r / groups, q0 = (r - p * groups) * kPairs;
    const bool row1 = p + 1 < Ho;   // rows 2p + 1 also lie in window row p + 1
    const int o = (pl * Ho + p) * Wo + q0;
    // windows (p, q0 ..) and (p + 1, q0 ..): z0 / d0 and z1 / d1
    float z0[kPairs + 1], d0[kPairs + 1], z1[kPairs + 1], d1[kPairs + 1];
#pragma unroll
    for (int c = 0; c <= kPairs; ++c) {
      const bool in = q0 + c < Wo;
      z0[c] = in ? to_float(sz[o + c]) : 0.f;
      d0[c] = in ? to_float(sd[o + c]) : 0.f;
      z1[c] = in && row1 ? to_float(sz[o + Wo + c]) : 0.f;
      d1[c] = in && row1 ? to_float(sd[o + Wo + c]) : 0.f;
    }
    T* cell = sx + pl * hw + 2 * p * W + 2 * q0;   // row 2p; row 2p + 1 at + W
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      if (q0 + c < Wo) {
        const bool col1 = q0 + c + 1 < Wo;
        T* at = cell + 2 * c;
        // (2p, 2q): window (p, q)
        float v = to_float(at[0]);
        at[0] = from_float<T>(v == z0[c] ? d0[c] : 0.f);
        // (2p, 2q + 1): (p, q), (p, q + 1)
        v = to_float(at[1]);
        float a = v == z0[c] ? d0[c] : 0.f;
        if (col1 && v == z0[c + 1]) a = add<T>(a, d0[c + 1]);
        at[1] = from_float<T>(a);
        // (2p + 1, 2q): (p, q), (p + 1, q)
        v = to_float(at[W]);
        a = v == z0[c] ? d0[c] : 0.f;
        if (row1 && v == z1[c]) a = add<T>(a, d1[c]);
        at[W] = from_float<T>(a);
        // (2p + 1, 2q + 1): all four
        v = to_float(at[W + 1]);
        a = v == z0[c] ? d0[c] : 0.f;
        if (col1 && v == z0[c + 1]) a = add<T>(a, d0[c + 1]);
        if (row1 && v == z1[c]) a = add<T>(a, d1[c]);
        if (row1 && col1 && v == z1[c + 1]) a = add<T>(a, d1[c + 1]);
        at[W + 1] = from_float<T>(a);
      }
    }
  }
  __syncthreads();
  if (mod16(sx) == mod16(os)) {
    copy_run<kThreads, false>(sx, os, np * hw);
  } else {
    for (int k = threadIdx.x; k < np * hw; k += kThreads) os[k] = sx[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_route_row_kernel(const T* __restrict__ x, const T* __restrict__ z,
                          const T* __restrict__ dz, int rows, int H, int W,
                          T* __restrict__ dx) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kRowCols;   // plane * H + i
  if (row >= rows) return;
  const int i = row % H;
  const int Ho = H / 2, Wo = W / 2;
  const int p = i / 2;
  const bool row1 = (i & 1) && p + 1 < Ho;   // also in window row p + 1
  const long long top = static_cast<long long>(row / H) * Ho * Wo +
                        static_cast<long long>(p) * Wo;
  const T* x_row = x + static_cast<long long>(row) * W;
  T* dx_row = dx + static_cast<long long>(row) * W;
  for (int j = threadIdx.x % kRowCols; j < W; j += kRowCols) {
    const int q = j / 2;
    const bool col1 = (j & 1) && q + 1 < Wo;   // also in window column q + 1
    const T* zp = z + top + q;
    const T* dp = dz + top + q;
    const float v = to_float(x_row[j]);
    float a = v == to_float(zp[0]) ? to_float(dp[0]) : 0.f;
    if (col1 && v == to_float(zp[1])) a = add<T>(a, to_float(dp[1]));
    if (row1 && v == to_float(zp[Wo])) a = add<T>(a, to_float(dp[Wo]));
    if (row1 && col1 && v == to_float(zp[Wo + 1])) a = add<T>(a, to_float(dp[Wo + 1]));
    dx_row[j] = from_float<T>(a);
  }
}

// How the backward runs on @planes planes of H x W elements of @elem_bytes
// bytes: planes per block of pool_route_kernel (0: pool_route_row_kernel),
// the blocks, and a block's shared memory in bytes. Returns a cudaError_t.
int route_plan(long long planes, int H, int W, int elem_bytes, long long plan[3]) {
  if (planes < 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hw = static_cast<long long>(H) * W, ohw = hw / 4;
  // a plane's staged runs, within the budget less the three runs' rounding
  // and alignment slack (under 32 B each)
  const long long per_plane = (hw + 2 * ohw) * elem_bytes;
  const long long fit = (kStageBytes - 96) / per_plane;
  if (fit >= 1) {
    const long long per_block = std::max(1LL, std::min(fit, planes));
    plan[0] = per_block;
    plan[1] = (planes + per_block - 1) / per_block;
    plan[2] = stage_room(per_block * hw * elem_bytes) +
              2 * stage_room(per_block * ohw * elem_bytes);
  } else {
    const long long rows = planes * H;
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    plan[0] = 0;
    plan[1] = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    plan[2] = 0;
  }
  return plan[1] > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <typename T>
int launch(const T* x, const T* z, const T* dz, long long planes, int H, int W,
           T* dx, void* stream) {
  if (planes <= 0) return 0;
  long long plan[3];
  const int err = route_plan(planes, H, W, sizeof(T), plan);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>(plan[1]);
  if (plan[0] > 0) {
    pool_route_kernel<T><<<blocks, kThreads, static_cast<size_t>(plan[2]),
                           static_cast<cudaStream_t>(stream)>>>(
        x, z, dz, planes, H, W, static_cast<int>(plan[0]), dx);
  } else {
    pool_route_row_kernel<T><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        x, z, dz, static_cast<int>(planes * H), H, W, dx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pool_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan for x [planes, H, W] of @elem_bytes-byte elements (4: fp32, 2:
// bf16), as pool_route*_launch takes it: @plan gets the planes per block (0:
// the row kernel of planes past the budget), the blocks, and a block's shared
// memory in bytes. Returns a cudaError_t; launches nothing.
extern "C" int pool_route_plan(long long planes, int H, int W, int elem_bytes,
                               long long* plan) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  return route_plan(planes, H, W, elem_bytes, plan);
}

// x [planes, H, W] and z, dz [planes, H / 2, W / 2], contiguous, one type, at
// any element offset; H and W even. Writes every cell of dx [planes, H, W].
// Launches on @stream and returns cudaGetLastError().
extern "C" int pool_route_launch(const float* x, const float* z,
                                 const float* dz, long long planes, int H,
                                 int W, float* dx, void* stream) {
  return launch(x, z, dz, planes, H, W, dx, stream);
}

extern "C" int pool_route_bf16_launch(const __nv_bfloat16* x,
                                      const __nv_bfloat16* z,
                                      const __nv_bfloat16* dz,
                                      long long planes, int H, int W,
                                      __nv_bfloat16* dx, void* stream) {
  return launch(x, z, dz, planes, H, W, dx, stream);
}
