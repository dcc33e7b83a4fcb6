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
// floor((W - 1) / 2) + 1 columns. Plane offsets are 64-bit; in the forward
// the number of input rows, N * C * H, and in the backward the cells of one
// plane, H * W, must fit an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTileW = 32;                // output columns per block: a warp
constexpr int kTileH = 8;                 // output rows per block
constexpr int kThreads = kTileW * kTileH;
constexpr int kPatchH = 2 * kTileH + 1;   // input rows of a tile, halo included
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
