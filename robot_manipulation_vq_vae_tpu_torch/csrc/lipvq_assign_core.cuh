// Shared core of the two LipVQ kernels (lipvq_assign.cu, lipvq_roundtrip.cu):
// one register-tiled fp32 tile product, acc = A B over a tile of 64 rows x
// kCols columns (kCols = 64 or 128), and its two epilogues: the running
// (min, argmin) of the nearest-code search, and a dense layer's bias and
// activation.
//
// What bounds it on Hopper: the work is fp32 FMAs (the argmin alone is
// 2 N K D operations against (2 N D + K D) * 4 bytes). An fp32 SIMT product
// reaches the FMA pipes' rate only if its shared-memory loads per FMA stay
// few and its staging overlaps the FMAs, so:
//  * each of the 16 x 16 threads keeps 4 rows (4 ty + i) x kCols / 16
//    columns (4 tx + j, and 64 + 4 tx + j at 128) in registers;
//  * A is kept in shared memory depth-major, [depth][64], and B as
//    [16][kCols], so one 16-byte load gives a thread its 4 rows and one or
//    two its columns: 3 LDS.128 for 32 FMAs a depth step at kCols = 128;
//  * the operands are staged 16 deep through two buffers: the global loads
//    of chunk c + 1 are in flight in registers while chunk c's FMAs run, then
//    stored into the other buffer, with one __syncthreads a chunk; float4
//    loads where a row is 16-byte aligned and its width a multiple of 4;
//  * a row-major source that is needed depth-major (the codebook [K, D], the
//    z rows) is transposed as it is stored, and a swizzle (swz) spreads those
//    stores over all 32 banks.
//
// Arithmetic: every dot product starts from 0 (the argmin) or from the bias
// (a dense layer) and adds one fmaf per depth step in ascending depth; the
// ragged edge is masked with zeros. Distances are ||C_k||^2 - 2 z . C_k
// (||z||^2 cannot move the argmin, as in the TPU kernel). fp32 SIMT, not
// TF32: TF32 would flip near-tie codes. A thread visits its codes in
// ascending order and replaces its minimum only on a strict `<`, and the 16
// partial minima of a row are merged lexicographically on (value, index), so
// the first index wins a tie, as jnp.argmin does.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace lipvq {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // rows of a tile
constexpr int kChunk = 16;     // depth of one staged chunk
constexpr int kPer = 4;        // rows per thread
constexpr int kMaxCols = 128;  // the wider tile

// Element (k, m) of a depth-major shared array of row length @width lies at
// k * width + (m ^ swz(k)): flipping bits 3-4 of the column by k / 4 puts the
// transposing stores of a warp (8 columns x 4 depth quads) in 32 banks, and
// keeps every aligned group of 4 columns contiguous for the 16-byte loads.
__host__ __device__ constexpr int swz(int k) { return ((k >> 2) & 3) << 3; }

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Column of the tile held in a thread's accumulator j (ascending in j).
__device__ __forceinline__ int tile_col(int j) {
  return 64 * (j >> 2) + 4 * (threadIdx.x & 15) + (j & 3);
}

// A row-major source [rows, D] whose rows r0 .. r0 + W - 1 (masked past
// r_end) are staged depth-major, [16][W], 16 depths at a time: the z rows of
// the assign kernel (W = 64) and the codebook (W = kCols). A thread moves
// W / 64 groups of 4 depths of one row.
template <int W>
struct TransposeStager {
  static constexpr int kSlots = W * 4 / kThreads;
  const float* src;
  int D, r0, r_end;
  bool vec;
  float* smem;  // [2][kChunk * W]
  float r[kSlots][4];

  __device__ void fetch(int d0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int row = r0 + (e >> 2), col = d0 + 4 * (e & 3);
      const float* p = src + static_cast<size_t>(row) * D + col;
      if (vec && row < r_end && col < D) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        r[s][0] = v.x, r[s][1] = v.y, r[s][2] = v.z, r[s][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[s][i] = (row < r_end && col + i < D) ? __ldg(p + i) : 0.f;
      }
    }
  }
  __device__ void put(int buf) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int m = e >> 2, q = e & 3;
      float* b = smem + buf * (kChunk * W);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * q + i;
        b[k * W + (m ^ swz(k))] = r[s][i];
      }
    }
  }
  __device__ const float* chunk(int, int buf) const {
    return smem + buf * (kChunk * W);
  }
};

// A row-major source [IN, OUT] (a dense layer's weight, the JAX [in, out]
// layout) whose columns n0 .. n0 + W - 1 are staged as they are, [16][W].
template <int W>
struct RowStager {
  static constexpr int kSlots = W / 64;
  static constexpr int kQuads = W / 4;  // float4 per staged row
  const float* src;
  int IN, OUT, n0;
  bool vec;
  float* smem;  // [2][kChunk * W]
  float r[kSlots][4];

  __device__ void fetch(int d0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int row = d0 + e / kQuads, col = n0 + 4 * (e % kQuads);
      const float* p = src + static_cast<size_t>(row) * OUT + col;
      if (vec && row < IN && col < OUT) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        r[s][0] = v.x, r[s][1] = v.y, r[s][2] = v.z, r[s][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[s][i] = (row < IN && col + i < OUT) ? __ldg(p + i) : 0.f;
      }
    }
  }
  __device__ void put(int buf) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = threadIdx.x + s * kThreads;
      const int k = e / kQuads, c = 4 * (e % kQuads);
      *reinterpret_cast<float4*>(smem + buf * (kChunk * W) + k * W +
                                 (c ^ swz(k))) =
          make_float4(r[s][0], r[s][1], r[s][2], r[s][3]);
    }
  }
  __device__ const float* chunk(int, int buf) const {
    return smem + buf * (kChunk * W);
  }
};

// An A operand that already lies in shared memory depth-major, [depth][64]
// (swizzled), zero past its depth up to a multiple of 16: a dense layer's
// input or z in the roundtrip kernel.
struct Resident {
  const float* act;
  __device__ void fetch(int) {}
  __device__ void put(int) {}
  __device__ const float* chunk(int c, int) const {
    return act + c * (kChunk * kRows);
  }
};

// acc[i][j] += sum over the depth of A[4 ty + i][d] * B[d][tile_col(j)], one
// fmaf per depth step in ascending depth. The caller initialises acc. Begins
// and ends with a __syncthreads, so shared memory written before the call
// is visible, and the buffers may be reused after it.
template <int kCols, class OpA, class OpB>
__device__ void tile_product(OpA& a, OpB& b, int depth,
                             float (&acc)[kPer][kCols / 16]) {
  constexpr int kJ = kCols / 16;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int chunks = (depth + kChunk - 1) / kChunk;
  a.fetch(0);
  b.fetch(0);
  a.put(0);
  b.put(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) {
      a.fetch((c + 1) * kChunk);
      b.fetch((c + 1) * kChunk);
    }
    const float* as = a.chunk(c, c & 1);
    const float* bs = b.chunk(c, c & 1);
#pragma unroll
    for (int d = 0; d < kChunk; ++d) {
      const float4 av = *reinterpret_cast<const float4*>(
          as + d * kRows + ((4 * ty) ^ swz(d)));
      const float ar[kPer] = {av.x, av.y, av.z, av.w};
      float br[kJ];
#pragma unroll
      for (int h = 0; h < kJ / 4; ++h) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bs + d * kCols + ((64 * h + 4 * tx) ^ swz(d)));
        br[4 * h] = bv.x, br[4 * h + 1] = bv.y, br[4 * h + 2] = bv.z,
               br[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (more) {
      a.put((c + 1) & 1);
      b.put((c + 1) & 1);
    }
    __syncthreads();
  }
}

// The argmin epilogue: dist = c_sq[k] - 2 acc for the codes k0 + tile_col(j)
// below k_end, visited in ascending order, replacing on a strict `<`.
template <int kCols>
__device__ void argmin_update(const float (&acc)[kPer][kCols / 16],
                              const float* __restrict__ c_sq, int k0,
                              int k_end, float (&best_v)[kPer],
                              int (&best_i)[kPer]) {
#pragma unroll
  for (int j = 0; j < kCols / 16; ++j) {
    const int code = k0 + tile_col(j);
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

struct Partials {
  float v[kRows][17];
  int i[kRows][17];
};

// Merges the 16 partial minima of every row lexicographically on
// (value, index) into out_v / out_i. Ends with a __syncthreads.
__device__ inline void merge_rows(const float (&best_v)[kPer],
                                  const int (&best_i)[kPer], Partials& red,
                                  float* out_v, int* out_i) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    red.v[4 * ty + i][tx] = best_v[i];
    red.i[4 * ty + i][tx] = best_i[i];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int m = threadIdx.x;
    float v = red.v[m][0];
    int b = red.i[m][0];
    for (int t = 1; t < 16; ++t) {
      const float vt = red.v[m][t];
      const int it = red.i[m][t];
      if (vt < v || (vt == v && it < b)) {
        v = vt;
        b = it;
      }
    }
    out_v[m] = v;
    out_i[m] = b;
  }
  __syncthreads();
}

// Searches the codes [k_begin, k_end) of cb [K, D] for the rows that @za
// supplies depth-major (a TransposeStager<64> or a Resident), in code tiles
// of kCols. On return out_v / out_i hold the min and argmin of every row.
template <int kCols, class OpA>
__device__ void assign_rows(OpA& za, const float* __restrict__ cb,
                            const float* __restrict__ c_sq, int D, int k_begin,
                            int k_end, float* bbuf, Partials& red,
                            float* out_v, int* out_i) {
  float best_v[kPer];
  int best_i[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
  }
  const bool vec = (D & 3) == 0 && aligned16(cb);
  for (int k0 = k_begin; k0 < k_end; k0 += kCols) {
    TransposeStager<kCols> cs{cb, D, k0, k_end, vec, bbuf};
    float acc[kPer][kCols / 16];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j) acc[i][j] = 0.f;
    tile_product<kCols>(za, cs, D, acc);
    argmin_update<kCols>(acc, c_sq, k0, k_end, best_v, best_i);
  }
  merge_rows(best_v, best_i, red, out_v, out_i);
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
