// LipVQ nearest-code assignment + gather: idx[n] = argmin_k ||z_n - C_k||^2,
// z_q[n] = C[idx[n]], in fp32.
//
// Replaces the TPU kernel `_assign_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/lipvq_kernel.py, which kept the
// whole codebook in VMEM and computed the gather as a one-hot matrix product.
// Here a block takes kRows rows of z and a contiguous range of whole code
// tiles, and runs the streaming argmin of lipvq_assign_core.cuh; the gather
// copies the winning codebook rows, one coalesced row at a time. Only idx and
// z_q (and, when the codebook is split, one (min, argmin) per row and range)
// reach device memory: the [N, K] distance matrix never does.
//
// The policy path has few rows (N = 16 per environment), so the row tiles
// alone would leave most SMs idle: the caller splits the codebook into S
// ranges (gridDim.y), each block writes its rows' partial (min, argmin), and
// merge_kernel combines the S partials in ascending range order on
// (value, index), which keeps the first index on a tie, and gathers z_q.
// With S = 1 assign_kernel writes idx and z_q itself.
#include "lipvq_assign_core.cuh"

using namespace lipvq;

__global__ void __launch_bounds__(kThreads)
    assign_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                  const float* __restrict__ c_sq, int N, int D, int K,
                  int codes_per_split, int* __restrict__ idx,
                  float* __restrict__ z_q, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  __shared__ AssignSmem sm;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int k_begin = blockIdx.y * codes_per_split;
  const int k_end = min(K, k_begin + codes_per_split);

  auto load_z = [&](int d0, AssignSmem& s) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int m = e / kChunk, d = e % kChunk;
      const int col = d0 + d;
      s.zs[d][m] = (m < rows && col < D)
                       ? __ldg(z + static_cast<size_t>(row0 + m) * D + col)
                       : 0.f;
    }
  };
  assign_rows(load_z, cb, c_sq, D, k_begin, k_end, sm);

  const int t = threadIdx.x;
  if (gridDim.y == 1) {
    if (t < rows) idx[row0 + t] = sm.best[t];
    gather_rows(cb, sm.best, row0, rows, D, z_q);
  } else if (t < rows) {
    const size_t at = static_cast<size_t>(blockIdx.y) * N + row0 + t;
    part_v[at] = sm.best_v[t];
    part_i[at] = sm.best[t];
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ cb, int N, int D, int splits,
                 const float* __restrict__ part_v,
                 const int* __restrict__ part_i, int* __restrict__ idx,
                 float* __restrict__ z_q) {
  __shared__ int best[kRows];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int t = threadIdx.x;
  if (t < rows) {
    float v = part_v[row0 + t];
    int b = part_i[row0 + t];
    for (int s = 1; s < splits; ++s) {
      const size_t at = static_cast<size_t>(s) * N + row0 + t;
      const float vs = part_v[at];
      const int is = part_i[at];
      if (vs < v || (vs == v && is < b)) {
        v = vs;
        b = is;
      }
    }
    best[t] = b;
    idx[row0 + t] = b;
  }
  __syncthreads();
  gather_rows(cb, best, row0, rows, D, z_q);
}

// z [N, D], cb [K, D], c_sq [K] (= sum of squares of each code), all fp32 and
// contiguous; writes idx [N] int32 and z_q [N, D]. The codebook is searched
// in @splits ranges of @codes_per_split codes (a multiple of 64 covering K);
// with splits > 1, part_v [splits, N] fp32 and part_i [splits, N] int32 are
// the caller's scratch. Launches on @stream and returns cudaGetLastError().
extern "C" int lipvq_assign_launch(const float* z, const float* cb,
                                   const float* c_sq, int N, int D, int K,
                                   int splits, int codes_per_split, int* idx,
                                   float* z_q, float* part_v, int* part_i,
                                   void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || K <= 0 || splits <= 0 || codes_per_split % kCodes != 0 ||
      static_cast<long long>(splits) * codes_per_split < K ||
      static_cast<long long>(splits - 1) * codes_per_split >= K ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (N + kRows - 1) / kRows;
  assign_kernel<<<dim3(row_tiles, splits), kThreads, 0, s>>>(
      z, cb, c_sq, N, D, K, codes_per_split, idx, z_q, part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_kernel<<<row_tiles, kThreads, 0, s>>>(cb, N, D, splits, part_v, part_i,
                                              idx, z_q);
  return static_cast<int>(cudaGetLastError());
}
