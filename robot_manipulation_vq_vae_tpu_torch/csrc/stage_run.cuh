// Staging a contiguous run of elements between device memory and shared
// memory in 16-byte vectors, for the kernels whose block takes a run of whole
// (n, c) planes: stem_pool.cu's pool_fwd_kernel and pool_route.cu's
// pool_route_kernel.
//
// A run may start anywhere: the wrappers accept contiguous views at any
// element offset, and a bf16 plane of 58 x 58 (6,728 B) is not a multiple of
// 16 bytes. So a run is placed in shared memory at its own device address
// modulo 16 (mod16), in a room of stage_room bytes, and copy_run moves it
// with scalars up to the first 16-byte boundary, 16-byte vectors, and
// scalars for the tail: the vectors are then aligned on both sides.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kStageLoadBatch = 4;   // 16-byte loads in flight per thread

__device__ __forceinline__ int mod16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// bytes a staged run of @bytes takes in shared memory: whole 16-byte lines,
// and one more for its offset modulo 16
__host__ __device__ __forceinline__ int stage_room(long long bytes) {
  return static_cast<int>((bytes + 15) / 16 * 16 + 16);
}

// the block of @kThreads threads copies @n elements from @src to @dst, which
// lie at the same address modulo 16: scalars up to the first 16-byte
// boundary, 16-byte vectors (kStageLoadBatch of them in flight per thread;
// read through the read-only path where @kFromGlobal), scalars for the tail
template <int kThreads, bool kFromGlobal, typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ src,
                                         T* __restrict__ dst, int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int head = min(n, ((16 - mod16(src)) & 15) / static_cast<int>(sizeof(T)));
  const int vecs = (n - head) / kVec;
  const int tail = head + vecs * kVec;
  const int t = threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (tail + t < n) dst[tail + t] = src[tail + t];
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  for (int v0 = t; v0 < vecs; v0 += kStageLoadBatch * kThreads) {
    uint4 r[kStageLoadBatch];
#pragma unroll
    for (int b = 0; b < kStageLoadBatch; ++b) {
      const int v = v0 + b * kThreads;
      if (v < vecs) {
        if constexpr (kFromGlobal) {
          r[b] = __ldg(vs + v);
        } else {
          r[b] = vs[v];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kStageLoadBatch; ++b) {
      const int v = v0 + b * kThreads;
      if (v < vecs) vd[v] = r[b];
    }
  }
}
