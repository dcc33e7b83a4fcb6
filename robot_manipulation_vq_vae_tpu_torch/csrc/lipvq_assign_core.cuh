// Shared core of the two LipVQ kernels (lipvq_assign.cu, lipvq_roundtrip.cu):
// for a tile of kRows rows of z, the running (min, argmin) over a contiguous
// range of codes of  dist[k] = ||C_k||^2 - 2 z . C_k  (||z||^2 is the same for
// every k, so it cannot move the argmin and is left out, as in the TPU kernel).
//
// The codebook (1024 x 976 fp32 = 4 MB on the policy path, 1024 x 210 on the
// tokenizer path) does not fit one SM's shared memory, so it streams from L2
// in tiles of kCodes codes, with the depth D staged kChunk values at a time;
// every D is allowed and the ragged edge is masked with zeros. Each of the
// 16 x 16 threads keeps a 4 x 4 block of dot products in registers (rows
// ty + 16 i, codes tx + 16 j) and its own running minimum. A thread visits its
// codes in ascending order and replaces its minimum only on a strict `<`, and
// the 16 partial minima of a row are merged lexicographically on
// (value, index), so the first index wins a tie, as jnp.argmin does.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lipvq {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // rows of z per block
constexpr int kCodes = 64;     // codes per codebook tile
constexpr int kChunk = 16;     // depth of one staged D chunk
constexpr int kPer = 4;        // rows and codes per thread

struct AssignSmem {
  float zs[kChunk][kRows + 1];   // z chunk, transposed: zs[d][m]
  float cs[kChunk][kCodes + 1];  // codebook chunk, transposed: cs[d][n]
  float red_v[kRows][17];        // per-thread partial minima, merged at the end
  int red_i[kRows][17];
  float best_v[kRows];           // the result: min and argmin per row
  int best[kRows];
};

// Searches the codes [k_begin, k_end). load_z(d0, sm) must fill
// sm.zs[d][m] = z[row0 + m][d0 + d], with zeros past the last row and past D.
// On return sm.best / sm.best_v hold the argmin and min of every row.
template <class LoadZ>
__device__ void assign_rows(LoadZ load_z, const float* __restrict__ cb,
                            const float* __restrict__ c_sq, int D, int k_begin,
                            int k_end, AssignSmem& sm) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float best_v[kPer];
  int best_i[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kCodes) {
    float acc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kChunk) {
      load_z(d0, sm);
      for (int e = threadIdx.x; e < kCodes * kChunk; e += kThreads) {
        const int n = e / kChunk, d = e % kChunk;
        const int code = k0 + n, col = d0 + d;
        sm.cs[d][n] = (code < k_end && col < D)
                          ? __ldg(cb + static_cast<size_t>(code) * D + col)
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kChunk; ++d) {
        float a[kPer], b[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) a[i] = sm.zs[d][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kPer; ++j) b[j] = sm.cs[d][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int code = k0 + tx + 16 * j;
      if (code < k_end) {
        const float c = __ldg(c_sq + code);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float v = c - 2.f * acc[i][j];
          if (v < best_v[i]) {
            best_v[i] = v;
            best_i[i] = code;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    sm.red_v[ty + 16 * i][tx] = best_v[i];
    sm.red_i[ty + 16 * i][tx] = best_i[i];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int m = threadIdx.x;
    float v = sm.red_v[m][0];
    int b = sm.red_i[m][0];
    for (int t = 1; t < 16; ++t) {
      const float vt = sm.red_v[m][t];
      const int it = sm.red_i[m][t];
      if (vt < v || (vt == v && it < b)) {
        v = vt;
        b = it;
      }
    }
    sm.best_v[m] = v;
    sm.best[m] = b;
  }
  __syncthreads();
}

// z_q[row0 + m] = cb[best[m]] for the first @rows rows, one coalesced row at
// a time.
__device__ inline void gather_rows(const float* __restrict__ cb,
                                   const int* best, int row0, int rows, int D,
                                   float* __restrict__ z_q) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int m = e / D, d = e % D;
    z_q[static_cast<size_t>(row0 + m) * D + d] =
        __ldg(cb + static_cast<size_t>(best[m]) * D + d);
  }
}

}  // namespace lipvq

extern "C" const char* lipvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
