// LipVQ nearest-code assignment + gather: idx[n] = argmin_k ||z_n - C_k||^2,
// z_q[n] = C[idx[n]], in fp32.
//
// Replaces the TPU kernel `_assign_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/lipvq_kernel.py, which kept the
// whole codebook in VMEM and computed the gather as a one-hot matrix product.
// On Hopper the search is bound by fp32 FMAs (2 N K D operations); the 4 MB
// codebook of the policy path cannot stay in one SM's shared memory, so a
// block takes 64 rows of z and a contiguous range of whole code tiles, and
// runs the register-tiled tile product of lipvq_assign_core.cuh over each
// tile, staging its z rows and the codes depth-major, 16 deep, double-buffered
// from L2; the argmin epilogue keeps a running (min, argmin) per row in
// registers. The gather copies the winning codebook rows, one coalesced row
// at a time. Only idx and z_q (and, when the codebook is split, one
// (min, argmin) per row and range) reach device memory: the [N, K] distance
// matrix never does.
//
// Tile width: 128 codes where the row tiles give enough blocks (the
// tokenizer-sized N), else 64. The policy path has few rows (N = 16 per
// environment), so the caller also splits the codebook into S ranges
// (gridDim.y), each block writes its rows' partial (min, argmin), and
// merge_kernel combines the S partials in ascending range order on
// (value, index), which keeps the first index on a tie, and gathers z_q.
// With S = 1 assign_kernel writes idx and z_q itself.
//
// The bf16 instance (lipvq_assign_bf16_launch, the mixed-precision paper
// step's) reads the bf16 codebook straight from memory, upcasts it exactly as
// it is staged, and runs the same fp32 search against the step's fp32 z; z_q
// is the exact fp32 upcast of the code, in z's type, as the TPU kernel's
// output is. The fp32 instance is the same code at float.
#include "lipvq_assign_core.cuh"

using namespace lipvq;

template <int kCols>
struct AssignSmem {
  float a[2 * kChunk * kRows];   // z chunks, depth-major
  float b[2 * kChunk * kCols];   // code chunks, depth-major
  Partials red;
  float best_v[kRows];
  int best[kRows];
};

// Tc: the codebook's element type: float, or uint16_t for bf16 bits.
template <int kCols, class Tc>
__global__ void __launch_bounds__(kThreads, 2)
    assign_kernel(const float* __restrict__ z, const Tc* __restrict__ cb,
                  const float* __restrict__ c_sq, int N, int D, int K,
                  int codes_per_split, int* __restrict__ idx,
                  float* __restrict__ z_q, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  __shared__ __align__(16) AssignSmem<kCols> sm;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int k_begin = blockIdx.y * codes_per_split;
  const int k_end = min(K, k_begin + codes_per_split);

  TransposeStager<kRows> za{z, D, row0, N, vector_rows(z, D), sm.a};
  assign_rows<kCols>(za, cb, c_sq, D, k_begin, k_end, sm.b, sm.red, sm.best_v,
                     sm.best);

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

template <class Tc>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const Tc* __restrict__ cb, int N, int D, int splits,
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

template <class Tc>
static int launch_assign(const float* z, const Tc* cb, const float* c_sq,
                         int N, int D, int K, int width, int splits,
                         int codes_per_split, int* idx, float* z_q,
                         float* part_v, int* part_i, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || K <= 0 || (width != 64 && width != 128) || splits <= 0 ||
      codes_per_split % width != 0 ||
      static_cast<long long>(splits) * codes_per_split < K ||
      static_cast<long long>(splits - 1) * codes_per_split >= K ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (N + kRows - 1) / kRows;
  const dim3 grid(row_tiles, splits);
  if (width == 128)
    assign_kernel<128, Tc><<<grid, kThreads, 0, s>>>(
        z, cb, c_sq, N, D, K, codes_per_split, idx, z_q, part_v, part_i);
  else
    assign_kernel<64, Tc><<<grid, kThreads, 0, s>>>(
        z, cb, c_sq, N, D, K, codes_per_split, idx, z_q, part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_kernel<Tc><<<row_tiles, kThreads, 0, s>>>(cb, N, D, splits, part_v,
                                                  part_i, idx, z_q);
  return static_cast<int>(cudaGetLastError());
}

// z [N, D], cb [K, D], c_sq [K] (= sum of squares of each code), all fp32 and
// contiguous; writes idx [N] int32 and z_q [N, D]. @width is the code tile
// (64 or 128); the codebook is searched in @splits ranges of
// @codes_per_split codes (a multiple of @width covering K); with splits > 1,
// part_v [splits, N] fp32 and part_i [splits, N] int32 are the caller's
// scratch. Launches on @stream and returns cudaGetLastError().
extern "C" int lipvq_assign_launch(const float* z, const float* cb,
                                   const float* c_sq, int N, int D, int K,
                                   int width, int splits, int codes_per_split,
                                   int* idx, float* z_q, float* part_v,
                                   int* part_i, void* stream) {
  return launch_assign(z, cb, c_sq, N, D, K, width, splits, codes_per_split,
                       idx, z_q, part_v, part_i, stream);
}

// The bf16 instance: cb [K, D] bf16; z [N, D] and z_q fp32; c_sq [K] fp32,
// summed over the upcast codebook. Otherwise as lipvq_assign_launch.
extern "C" int lipvq_assign_bf16_launch(const float* z, const uint16_t* cb,
                                        const float* c_sq, int N, int D, int K,
                                        int width, int splits,
                                        int codes_per_split, int* idx,
                                        float* z_q, float* part_v,
                                        int* part_i, void* stream) {
  return launch_assign(z, cb, c_sq, N, D, K, width, splits, codes_per_split,
                       idx, z_q, part_v, part_i, stream);
}
