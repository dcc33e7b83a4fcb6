// LipVQ tokenize + detokenize in one kernel: encoder MLP (in -> h1 -> hidden,
// tanh-GELU) -> Lipschitz latent sigmoid(h Wl + bl) -> nearest code -> gather
// -> decoder MLP (latent -> h1 -> hidden, tanh-GELU) -> linear output.
//
// Replaces the TPU kernel `_roundtrip_kernel` of
// robot_manipulation_vq_vae_tpu/ops/pallas/lipvq_kernel.py, which pinned every
// weight and the whole codebook in VMEM. On Hopper the work is bound by fp32
// operations (about 0.55 MFLOP per row against 96 bytes of input and output),
// so a block keeps every intermediate of a 64-row tile in shared memory: only
// x goes in and only recon and idx come out. The weights (about 236 KB) and
// the codebook (860 KB at 1024 x 210) are read through L1/L2 by every block.
// Every stage runs the one register-tiled tile product of
// lipvq_assign_core.cuh, so the five dense layers and the nearest-code search
// share its 16-byte shared-memory loads and its double-buffered staging: a
// layer with at most 64 outputs takes one 64-column pass, a wider one passes
// of 128 columns (the latent's 210 are two, the second masked), and the
// argmin takes 128-code tiles over z. The intermediates (x, h1, hidden, z,
// z_q, h1, hidden) are stored depth-major, [feature][64 rows], zero-padded to
// a multiple of 16 features, so each is the next stage's A operand as it is.
// About 107 KB of shared memory at the tokenizer's widths: two blocks an SM.
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

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kGelu) return gelu_tanh(v);
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// One kCols-wide pass of a dense layer over the tile: acc = b + in W for the
// outputs n0 .. n0 + kCols - 1. W is [IN, OUT] row-major (the JAX [in, out]
// layout), staged as it is; `in` lies in shared memory depth-major. With
// @out_act the pass writes act(acc) depth-major into @out_act (zeros for the
// padding outputs OUT .. pad16(OUT) - 1); else it writes the first @rows rows
// row-major to @out_dev.
template <int kCols, int ACT>
__device__ void dense_pass(const float* in, int IN, const float* __restrict__ W,
                           const float* __restrict__ b, int OUT, int n0,
                           float* bbuf, float* out_act, float* out_dev,
                           int rows) {
  constexpr int kJ = kCols / 16;
  const int ty = threadIdx.x >> 4;
  float acc[kPer][kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int o = n0 + tile_col(j);
    const float bias = (o < OUT) ? __ldg(b + o) : 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i][j] = bias;
  }
  Resident a{in};
  RowStager<kCols> ws{W, IN, OUT, n0, (OUT & 3) == 0 && aligned16(W), bbuf};
  tile_product<kCols>(a, ws, IN, acc);
  if (out_act != nullptr) {
    const int out_rows = pad16(OUT);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int o = n0 + tile_col(j);
      if (o >= out_rows) continue;
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[i] = (o < OUT) ? activate<ACT>(acc[i][j]) : 0.f;
      *reinterpret_cast<float4*>(out_act + o * kRows + ((4 * ty) ^ swz(o))) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int m = 4 * ty + i;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int o = n0 + tile_col(j);
        if (o < OUT)
          out_dev[static_cast<size_t>(m) * OUT + o] = activate<ACT>(acc[i][j]);
      }
    }
  }
}

// out = act(b + in W) over the tile: one 64-column pass where OUT <= 64,
// else passes of 128 columns.
template <int ACT>
__device__ void dense_layer(const float* in, int IN, const float* __restrict__ W,
                            const float* __restrict__ b, int OUT, float* bbuf,
                            float* out_act, float* out_dev = nullptr,
                            int rows = kRows) {
  if (OUT <= 64) {
    dense_pass<64, ACT>(in, IN, W, b, OUT, 0, bbuf, out_act, out_dev, rows);
  } else {
    for (int n0 = 0; n0 < OUT; n0 += kMaxCols)
      dense_pass<kMaxCols, ACT>(in, IN, W, b, OUT, n0, bbuf, out_act, out_dev,
                                rows);
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

// Floats of the staging buffers (the argmin's partial minima share them), of
// best and best_v, and of the two regions that the stages alternate between.
constexpr int kStageFloats = 2 * kChunk * kMaxCols;
static_assert(sizeof(Partials) <= sizeof(float) * kStageFloats,
              "the partial minima must fit the staging buffers");

__host__ __device__ inline int region_a_floats(const Dims& d) {
  return kRows * imax(imax(pad16(d.in_dim) + pad16(d.h1), pad16(d.latent)),
                      pad16(d.hidden));
}

__host__ __device__ inline int region_b_floats(const Dims& d) {
  return kRows * imax(pad16(d.hidden), pad16(d.h1));
}

__global__ void __launch_bounds__(kThreads, 2)
    roundtrip_kernel(const float* __restrict__ x, int N, Weights w, Dims dm,
                     float* __restrict__ recon, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  float* bbuf = smem;
  Partials& red = *reinterpret_cast<Partials*>(smem);
  int* best = reinterpret_cast<int*>(smem + kStageFloats);
  float* best_v = smem + kStageFloats + kRows;
  float* ra = smem + kStageFloats + 2 * kRows;
  float* rb = ra + region_a_floats(dm);
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);

  // stage 0: the x tile, depth-major (zero rows past N), into region A
  const int in_p = pad16(dm.in_dim);
  float* xs = ra;
  for (int e = t; e < kRows * in_p; e += kThreads) {
    const int m = e & (kRows - 1), f = e / kRows;
    xs[f * kRows + (m ^ swz(f))] =
        (m < rows && f < dm.in_dim)
            ? __ldg(x + static_cast<size_t>(row0 + m) * dm.in_dim + f)
            : 0.f;
  }

  // encoder: x -> h1 (region A, after x) -> hidden (region B) -> z (region A)
  float* h1s = ra + kRows * in_p;
  dense_layer<kGelu>(xs, dm.in_dim, w.w1, w.b1, dm.h1, bbuf, h1s);
  dense_layer<kGelu>(h1s, dm.h1, w.w2, w.b2, dm.hidden, bbuf, rb);
  float* zs = ra;
  dense_layer<kSigmoid>(rb, dm.hidden, w.wl, w.bl, dm.latent, bbuf, zs);

  // nearest code of every row, then z_q = C[idx] in place of z
  Resident za{zs};
  assign_rows<kMaxCols>(za, w.cb, w.c_sq, dm.latent, 0, dm.K, bbuf, red,
                        best_v, best);
  if (t < rows) idx[row0 + t] = best[t];
  const int lat_p = pad16(dm.latent);
  for (int e = t; e < kRows * lat_p; e += kThreads) {
    const int m = e & (kRows - 1), f = e / kRows;
    zs[f * kRows + (m ^ swz(f))] =
        (f < dm.latent)
            ? __ldg(w.cb + static_cast<size_t>(best[m]) * dm.latent + f)
            : 0.f;
  }

  // decoder: z_q -> h1 (region B) -> hidden (region A) -> recon (device memory)
  dense_layer<kGelu>(zs, dm.latent, w.w3, w.b3, dm.h1, bbuf, rb);
  dense_layer<kGelu>(rb, dm.h1, w.w4, w.b4, dm.hidden, bbuf, ra);
  dense_layer<kNone>(ra, dm.hidden, w.w5, w.b5, dm.out_dim, bbuf, nullptr,
                     recon + static_cast<size_t>(row0) * dm.out_dim, rows);
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
  const size_t smem =
      sizeof(float) * (kStageFloats + 2 * kRows + region_a_floats(dm) +
                       region_b_floats(dm));
  cudaError_t err = cudaFuncSetAttribute(
      roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's shared memory, so that two blocks fit
  err = cudaFuncSetAttribute(roundtrip_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights w{w1, b1, w2, b2, wl, bl, cb, c_sq, w3, b3, w4, b4, w5, b5};
  const dim3 grid((N + kRows - 1) / kRows);
  roundtrip_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, N, w, dm, recon, idx);
  return static_cast<int>(cudaGetLastError());
}
