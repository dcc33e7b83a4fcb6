// A host emulation of the CUDA subset that the LipVQ kernels
// (robot_manipulation_vq_vae_tpu_torch/csrc/lipvq_*.cu) use, so that their
// own sources compile with g++ and run on the CPU in the tests: each block's
// threads are std::threads, __syncthreads is a std::barrier, __shared__
// variables are statics and dynamic shared memory is one array, filled with
// garbage before every block. Blocks run one after another. Launches are
// rewritten by the test from `kernel<<<grid, threads, smem, stream>>>(args);`
// to `emu::launch(grid, threads, smem, stream, [&] { kernel(args); });`.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define CUDART_INF_F (__builtin_inff())

struct uint3s {
  unsigned x, y, z;
};
inline thread_local uint3s threadIdx;
inline uint3s blockIdx, gridDim;
inline thread_local std::barrier<>* emu_barrier;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline int min(int a, int b) { return a < b ? a : b; }

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

namespace emu {
constexpr size_t kMaxSmem = 232448;  // a Hopper block's shared memory
alignas(16) inline float dynamic_smem[kMaxSmem / sizeof(float)];
inline size_t smem_limit = 48 * 1024;

inline void launch(dim3 grid, int threads, size_t smem, cudaStream_t,
                   const std::function<void()>& body) {
  if (smem > smem_limit) {  // refused, as the card refuses it
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = {grid.x, grid.y, 1};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::memset(dynamic_smem, 0xff, kMaxSmem);  // NaN, as garbage
      std::barrier<> bar(threads);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx = {unsigned(t), 0, 0};
          emu_barrier = &bar;
          body();
        });
      for (auto& th : ts) th.join();
    }
}
}  // namespace emu

template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
    if (value < 0 || static_cast<size_t>(value) > emu::kMaxSmem)
      return cudaErrorInvalidValue;
    emu::smem_limit = value;
  }
  return cudaSuccess;
}
