// LipVQ tokenize + detokenize in one kernel: encoder MLP (in -> h1 -> hidden,
// tanh-GELU) -> Lipschitz latent sigmoid(h Wl + bl) -> nearest code -> gather
// -> decoder MLP (latent -> h1 -> hidden, tanh-GELU) -> linear output.
//
// Replaces the TPU kernel `_roundtrip_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/lipvq_kernel.py, which pinned every
// weight and the whole codebook in VMEM. On Hopper the work is bound by fp32
// operations (about 0.55 MFLOP per row against 96 bytes of input and output),
// so the design keeps every intermediate of a 64-row tile in shared memory:
// only x goes in and only recon and idx come out. The weights (about 236 KB)
// and the codebook (860 KB at 1024 x 210) are read through L1/L2 by every
// block; the nearest-code search is the streaming argmin shared with the
// assign kernel (lipvq_assign_core.cuh). Each dense layer gives every thread
// 4 rows x ceil(out / 16) columns of the tile in registers.
#include "lipvq_assign_core.cuh"

using namespace lipvq;

namespace {

constexpr int kMaxH1 = 64;       // width of the first encoder / decoder layer
constexpr int kMaxHidden = 128;  // width of the second layer
constexpr int kMaxLatent = 256;
constexpr int kMaxOut = 16;

enum Act { kNone = 0, kGelu = 1, kSigmoid = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// out[m][o] = act(b[o] + sum_k in[m][k] W[k][o]) for the rows m < valid of the
// tile. W is [IN, OUT] row-major (the JAX [in, out] layout), so the 16 threads
// of a row read 16 neighbouring weights; `in` lies in shared memory, `out` in
// shared or device memory.
template <int MAXJ, int ACT>
__device__ void dense_tile(const float* in, int in_stride, int IN,
                           const float* __restrict__ W,
                           const float* __restrict__ b, int OUT, float* out,
                           int out_stride, int valid) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[kPer][MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int o = tx + 16 * j;
    const float bias = (o < OUT) ? __ldg(b + o) : 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i][j] = bias;
  }
  for (int k = 0; k < IN; ++k) {
    float a[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = in[(ty + 16 * i) * in_stride + k];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int o = tx + 16 * j;
      const float w = (o < OUT) ? __ldg(W + static_cast<size_t>(k) * OUT + o) : 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int m = ty + 16 * i;
    if (m >= valid) continue;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int o = tx + 16 * j;
      if (o >= OUT) continue;
      float v = acc[i][j];
      if (ACT == kGelu) v = gelu_tanh(v);
      if (ACT == kSigmoid) v = 1.f / (1.f + expf(-v));
      out[static_cast<size_t>(m) * out_stride + o] = v;
    }
  }
}

struct Weights {
  const float *w1, *b1, *w2, *b2, *wl, *bl, *cb, *c_sq, *w3, *b3, *w4, *b4,
      *w5, *b5;
};

struct Dims {
  int in_dim, h1, hidden, latent, K, out_dim;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Floats of the two shared-memory regions that the stages alternate between.
__host__ __device__ inline int region_a_floats(const Dims& d) {
  const int per_row = imax(imax(d.latent + 1, (d.in_dim + 1) + (d.h1 + 1)),
                           d.hidden + 1);
  return kRows * per_row;
}

__host__ __device__ inline int region_b_floats(const Dims& d) {
  return kRows * imax(d.hidden + 1, d.h1 + 1);
}

__global__ void __launch_bounds__(kThreads)
    roundtrip_kernel(const float* __restrict__ x, int N, Weights w, Dims dm,
                     float* __restrict__ recon, int* __restrict__ idx) {
  extern __shared__ float smem[];
  AssignSmem& sm = *reinterpret_cast<AssignSmem*>(smem);
  float* ra = smem + sizeof(AssignSmem) / sizeof(float);
  float* rb = ra + region_a_floats(dm);
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);

  // stage 0: the x tile (zero rows past N), into region A
  const int xs_stride = dm.in_dim + 1;
  float* xs = ra;
  for (int e = t; e < kRows * dm.in_dim; e += kThreads) {
    const int m = e / dm.in_dim, d = e % dm.in_dim;
    xs[m * xs_stride + d] =
        (m < rows) ? __ldg(x + static_cast<size_t>(row0 + m) * dm.in_dim + d)
                   : 0.f;
  }
  __syncthreads();

  // encoder: x -> h1 (region A, after x) -> hidden (region B) -> z (region A)
  const int h1_stride = dm.h1 + 1, hid_stride = dm.hidden + 1,
            z_stride = dm.latent + 1;
  float* h1s = ra + kRows * xs_stride;
  dense_tile<kMaxH1 / 16, kGelu>(xs, xs_stride, dm.in_dim, w.w1, w.b1, dm.h1,
                                 h1s, h1_stride, kRows);
  __syncthreads();
  dense_tile<kMaxHidden / 16, kGelu>(h1s, h1_stride, dm.h1, w.w2, w.b2,
                                     dm.hidden, rb, hid_stride, kRows);
  __syncthreads();
  float* zs = ra;
  dense_tile<kMaxLatent / 16, kSigmoid>(rb, hid_stride, dm.hidden, w.wl, w.bl,
                                        dm.latent, zs, z_stride, kRows);
  __syncthreads();

  // nearest code of every row, then z_q = C[idx] in place of z
  auto load_z = [&](int d0, AssignSmem& s) {
    for (int e = t; e < kRows * kChunk; e += kThreads) {
      const int m = e % kRows, d = e / kRows;
      s.zs[d][m] = (d0 + d < dm.latent) ? zs[m * z_stride + d0 + d] : 0.f;
    }
  };
  assign_rows(load_z, w.cb, w.c_sq, dm.latent, 0, dm.K, sm);
  if (t < rows) idx[row0 + t] = sm.best[t];
  for (int e = t; e < kRows * dm.latent; e += kThreads) {
    const int m = e / dm.latent, d = e % dm.latent;
    zs[m * z_stride + d] =
        __ldg(w.cb + static_cast<size_t>(sm.best[m]) * dm.latent + d);
  }
  __syncthreads();

  // decoder: z_q -> h1 (region B) -> hidden (region A) -> recon (device memory)
  dense_tile<kMaxH1 / 16, kGelu>(zs, z_stride, dm.latent, w.w3, w.b3, dm.h1,
                                 rb, h1_stride, kRows);
  __syncthreads();
  dense_tile<kMaxHidden / 16, kGelu>(rb, h1_stride, dm.h1, w.w4, w.b4,
                                     dm.hidden, ra, hid_stride, kRows);
  __syncthreads();
  dense_tile<kMaxOut / 16, kNone>(ra, hid_stride, dm.hidden, w.w5, w.b5,
                                  dm.out_dim,
                                  recon + static_cast<size_t>(row0) * dm.out_dim,
                                  dm.out_dim, rows);
}

}  // namespace

// x [N, in_dim]; w1 [in_dim, h1], w2 [h1, hidden], wl [hidden, latent] (the
// Lipschitz weight already row-normalized and transposed), cb [K, latent],
// c_sq [K], w3 [latent, h1], w4 [h1, hidden], w5 [hidden, out_dim], biases
// [out]; all fp32 and contiguous. Writes recon [N, out_dim] and idx [N] int32.
// Launches on @stream and returns cudaGetLastError() of the launch.
extern "C" int lipvq_roundtrip_launch(
    const float* x, int N, int in_dim, const float* w1, const float* b1,
    int h1, const float* w2, const float* b2, int hidden, const float* wl,
    const float* bl, int latent, const float* cb, const float* c_sq, int K,
    const float* w3, const float* b3, const float* w4, const float* b4,
    const float* w5, const float* b5, int out_dim, float* recon, int* idx,
    void* stream) {
  if (N <= 0) return 0;
  if (in_dim <= 0 || h1 <= 0 || h1 > kMaxH1 || hidden <= 0 ||
      hidden > kMaxHidden || latent <= 0 || latent > kMaxLatent || K <= 0 ||
      out_dim <= 0 || out_dim > kMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm{in_dim, h1, hidden, latent, K, out_dim};
  const size_t smem = sizeof(AssignSmem) +
                      sizeof(float) * (region_a_floats(dm) + region_b_floats(dm));
  cudaError_t err = cudaFuncSetAttribute(
      roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights w{w1, b1, w2, b2, wl, bl, cb, c_sq, w3, b3, w4, b4, w5, b5};
  const dim3 grid((N + kRows - 1) / kRows);
  roundtrip_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, N, w, dm, recon, idx);
  return static_cast<int>(cudaGetLastError());
}
