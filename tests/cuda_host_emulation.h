// A host emulation of the CUDA subset that the port's kernels
// (robot_manipulation_vq_vae_tpu_torch/csrc/lipvq_*.cu, stem_pool.cu) use, so
// that their own sources compile with g++ and run on the CPU in the tests:
// each block's threads are std::threads (one set per launch, which takes the
// blocks one after another), __syncthreads is a std::barrier, __shared__
// variables are statics and dynamic shared memory is one array, filled with
// garbage before every block.
// Launches are rewritten by the test from
// `kernel<<<grid, threads, smem, stream>>>(args);` to
// `emu::launch(grid, threads, smem, stream, [&] { kernel(args); });`.
// A uint4, uint2, float2 or __nv_bfloat162 read or written at an address that the
// card would refuse (not a multiple of its size) fails the launch with
// cudaErrorMisalignedAddress. The test's stand-in for <cuda_bf16.h> includes
// this file: __nv_bfloat16 is 16 bits, converted as the card converts.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
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

namespace emu {
inline std::atomic<bool> misaligned{false};
// true where @p is a multiple of @size, as the card's vector accesses need;
// else the launch fails (a host build would just read across the boundary)
inline bool aligned(const void* p, size_t size) {
  if (reinterpret_cast<uintptr_t>(p) % size == 0) return true;
  misaligned = true;
  return false;
}
}  // namespace emu

// the base of a vector type: every copy checks both addresses before the
// members are copied. The types keep their members' alignment, so that g++
// assumes none and the checks stay.
template <class V, size_t kSize>
struct CheckedVector {
  CheckedVector() = default;
  CheckedVector(const CheckedVector& o) { emu::aligned(&o, kSize); }
  CheckedVector& operator=(const CheckedVector& o) {
    emu::aligned(this, kSize);
    emu::aligned(&o, kSize);
    return *this;
  }
};
struct uint4 : CheckedVector<uint4, 16> {
  unsigned x, y, z, w;
};
struct float2 : CheckedVector<float2, 8> {
  float x, y;
};
inline float2 make_float2(float a, float b) {
  float2 v;
  v.x = a;
  v.y = b;
  return v;
}
inline uint4 __ldg(const uint4* p) { return *p; }
struct uint2 : CheckedVector<uint2, 8> {
  unsigned x, y;
};
inline uint2 __ldg(const uint2* p) { return *p; }
inline unsigned short __ldg(const unsigned short* p) { return *p; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// <cuda_bf16.h>: the 16 high bits of an fp32
struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 : CheckedVector<__nv_bfloat162, 4> {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  return v;
}
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716
};
typedef void* cudaStream_t;
inline cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline cudaError_t cudaGetDevice(int* device) {  // one card, device 0
  *device = 0;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess                  ? "no error"
         : e == cudaErrorMisalignedAddress ? "misaligned address"
                                           : "invalid argument";
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
  const unsigned blocks = grid.x * grid.y;
  if (blocks == 0) return;
  // one host thread per CUDA thread for the whole launch: the threads take
  // the blocks in turn, and between two blocks the last to finish one sets
  // the next block's index and refills shared memory with garbage
  unsigned block = 0;
  const auto start_block = [&]() noexcept {
    blockIdx = {block % grid.x, block / grid.x, 0};
    std::memset(dynamic_smem, 0xff, kMaxSmem);  // NaN, as garbage
  };
  start_block();
  const auto next_block = [&]() noexcept {
    if (++block < blocks) start_block();
  };
  std::barrier<> bar(threads);
  std::barrier<decltype(next_block)> between(threads, next_block);
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx = {unsigned(t), 0, 0};
      emu_barrier = &bar;
      for (unsigned b = 0; b < blocks; ++b) {
        body();
        between.arrive_and_wait();
      }
    });
  for (auto& th : ts) th.join();
  if (misaligned.exchange(false)) emu_last_error = cudaErrorMisalignedAddress;
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
