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
// dimension and repeated the pooled rows to input resolution in VMEM; here a
// thread takes one input cell and finds its windows by index arithmetic.
// Input row i = 2p + r lies in window row p, and for r = 1 also in p + 1; the
// same for columns. Each cell adds four terms in the TPU kernel's order:
// window (p, q), then (p, q + 1), then (p + 1, q), then (p + 1, q + 1), a term
// being 0 where the cell's parity or the border leaves that window out. The
// sum is kept in the gradient's type, rounded after each add as the TPU kernel
// (and the plain version) adds; the compares run in fp32, which is exact for
// bf16.
//
// The work is 4 compares and 4 adds per input cell against reading x, z and dz
// once and writing dx once: at [3072, 64, 58, 58] in bf16 that is 3.31 GB,
// about 0.99 ms at 3.35 TB/s, so the kernel is bound by device memory. A warp
// walks one input row with coalesced loads of x and stores of dx; the z and dz
// rows it needs are a quarter of that traffic and come back from L1/L2 for
// the neighbouring threads and the second input row of each window row. No
// atomics: every cell is written once, zeros included. Element offsets are
// 64-bit; the number of input rows, N * C * H, must fit an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;   // a warp per input row
constexpr int kRows = 8;    // 8 rows per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a + b rounded to the type: in fp32 the sum itself; in bf16 the fp32 sum
// rounded to nearest even, which is what torch's and XLA's bf16 adds give
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
    pool_route_kernel(const T* __restrict__ x, const T* __restrict__ z,
                      const T* __restrict__ dz, int rows, int H, int W,
                      T* __restrict__ dx) {
  const int row = blockIdx.x * kRows + threadIdx.y;   // plane * H + i
  if (row >= rows) return;
  const int i = row % H;
  const int Ho = H / 2, Wo = W / 2;
  const int p = i / 2;
  const bool odd_row = (i & 1) && p + 1 < Ho;   // also in window row p + 1
  const long long top = static_cast<long long>(row / H) * Ho * Wo +
                        static_cast<long long>(p) * Wo;
  const long long bot = top + Wo;
  const T* x_row = x + static_cast<long long>(row) * W;
  T* dx_row = dx + static_cast<long long>(row) * W;
  for (int j = threadIdx.x; j < W; j += kCols) {
    const int q = j / 2;
    const bool odd_col = (j & 1) && q + 1 < Wo;   // also in window column q + 1
    const float v = to_float(x_row[j]);
    const T none = zero<T>();
    T acc = v == to_float(z[top + q]) ? dz[top + q] : none;
    acc = add(acc, odd_col && v == to_float(z[top + q + 1]) ? dz[top + q + 1] : none);
    acc = add(acc, odd_row && v == to_float(z[bot + q]) ? dz[bot + q] : none);
    acc = add(acc, odd_row && odd_col && v == to_float(z[bot + q + 1])
                       ? dz[bot + q + 1] : none);
    dx_row[j] = acc;
  }
}

template <typename T>
int launch(const T* x, const T* z, const T* dz, long long planes, int H, int W,
           T* dx, void* stream) {
  if (planes <= 0) return 0;
  if (H <= 0 || W <= 0 || (H & 1) || (W & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = planes * H;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((rows + kRows - 1) / kRows);
  pool_route_kernel<T><<<blocks, dim3(kCols, kRows), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, z, dz, static_cast<int>(rows), H, W, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pool_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [planes, H, W] and z, dz [planes, H / 2, W / 2], contiguous, one type;
// H and W even. Writes every cell of dx [planes, H, W]. Launches on @stream
// and returns cudaGetLastError().
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
