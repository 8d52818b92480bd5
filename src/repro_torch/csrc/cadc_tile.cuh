// Shared device code of the CADC kernels for Hopper (sm_90a): the dendritic
// fns and their derivatives, and the segmented forward tile kernel that K1
// and K1g (cadc_matmul.cu) and K3 (cadc_conv.cu) instantiate.
//
// The forward tile kernel computes
//
//     y[M, N] = sum_s f( sum_{k < xbar, s*xbar + k < D} X(m, s*xbar + k) * w[s*xbar + k, n] )
//
// where X is read through a loader: the row-major x of a matmul (K1, K1g)
// or the implicit im2col gather of a convolution (K3). Every psum is fp32,
// f is applied per segment before the cross-segment sum, segments are added
// in order s = 0, 1, ... into an fp32 accumulator, and each output element
// is written once. With kGate the kernel also writes each segment's gate
// f'(psum) from the same fp32 psum, in registers: packed 32 to a uint32
// word along N (bit b of word w = column 32w + b, the JAX bit layout, N
// padded to whole words), or one byte / one fp32 per psum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cadc {

constexpr int kThreads = 256;
constexpr int kBK = 32;
constexpr int kPack = 32;  // gate bits per packed word

// Gate storage kinds (repro_torch/kernels/cadc_matmul.py GATE_KINDS).
enum GateKind : int {
  kGateNone = 0,
  kGatePacked = 1,  // uint32 words [S, M, ceil(N/32)]
  kGateU8 = 2,      // one byte per psum [S, M, N] (torch.bool)
  kGateF32 = 3,     // one fp32 per psum [S, M, N]
  kGateRecompute = 4,  // backward only: f'(x_s @ w_s) recomputed in-kernel
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// fn ids: repro_torch/kernels/cadc_matmul.py FN_IDS. Same forms as
// repro_torch/core/dendritic.py (f(p) = 0 for p <= 0 except identity).
__device__ __forceinline__ float dendritic(int fn, float p) {
  switch (fn) {
    case 0: return p;                                  // identity (vConv)
    case 1: return p > 0.f ? p : 0.f;                  // relu
    case 2: return p > 0.f ? sqrtf(p + 1e-12f) : 0.f;  // sublinear
    case 3: return p > 0.f ? p * p : 0.f;              // supralinear, k = 1
    default: return p > 0.f ? tanhf(p) : 0.f;          // tanh
  }
}

// f'(p), with f'(0) = 0 for every fn but identity (the subgradient
// convention of the JAX kernels' gates).
__device__ __forceinline__ float dendritic_grad(int fn, float p) {
  switch (fn) {
    case 0: return 1.f;
    case 1: return p > 0.f ? 1.f : 0.f;
    case 2: return p > 0.f ? 0.5f / sqrtf(p + 1e-12f) : 0.f;
    case 3: return p > 0.f ? 2.f * p : 0.f;
    default: {
      const float t = tanhf(p);
      return p > 0.f ? 1.f - t * t : 0.f;
    }
  }
}

// Thread (ty, tx) owns rows ty*TM .. ty*TM+TM-1 and columns tx + j*(BN/TN):
// neighbouring threads read neighbouring shared-memory words of w and
// write neighbouring addresses of y.
//
// The block walks T = (segments it owns) x (k-tiles per segment) tiles.
// Each thread stages its share of the next tile in registers while the
// current tile computes, so a tile's global loads are in flight together
// and overlap the FMAs.
//
// split == 0: the block owns all S segments and writes y.
// split == 1: the block owns segment blockIdx.z alone and writes its
// f(psum) tile to y + z*M*N (scratch); segment_sum_kernel then adds the
// S tiles in order s = 0, 1, ... — the same additions in the same order
// as the single pass, so the result is bitwise the same.
//
// XLoad: `float operator()(int m, int d) const` returns X(m, d) for
// m < M, d < D (the caller masks both).
template <typename T, int BM, int BN, int TM, int TN, bool kGate,
          typename XLoad>
__global__ void __launch_bounds__(kThreads, 2)  // <= 128 registers a thread
fwd_tile_kernel(XLoad xl, const T* __restrict__ w, float* __restrict__ y,
                void* __restrict__ gate, int M, int N, int D, int S,
                int xbar, int fn, int split, int gate_kind) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile per thread");
  constexpr int kCols = BN / TN;
  static_assert(!kGate || ((kCols == 32 || kCols == 16) && BN % kPack == 0),
                "packed gates need 32 or 16 thread columns");
  constexpr int kXL = BM * kBK / kThreads;  // x elements staged per thread
  constexpr int kWL = kBK * BN / kThreads;  // w elements staged per thread
  static_assert(kXL * kThreads == BM * kBK && kWL * kThreads == kBK * BN,
                "tiles split evenly over the threads");
  __shared__ float xs[kBK][BM + 1];  // transposed; +1 breaks bank conflicts
  __shared__ float ws[kBK][BN];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int s_first = split ? blockIdx.z : 0;
  const int kt_per_seg = (xbar + kBK - 1) / kBK;
  const int n_tiles = (split ? 1 : S) * kt_per_seg;
  float* out = y + (split ? static_cast<size_t>(blockIdx.z) * M * N : 0);

  float xr[kXL], wr[kWL];
  auto stage = [&](int t) {
    const int k0 = (t % kt_per_seg) * kBK;
    const int seg = (s_first + t / kt_per_seg) * xbar;
#pragma unroll
    for (int r = 0; r < kXL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int m = m0 + e / kBK, k = k0 + e % kBK;
      xr[r] = (m < M && k < xbar && seg + k < D) ? xl(m, seg + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kWL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int n = n0 + e % BN, k = k0 + e / BN;
      wr[r] = (n < N && k < xbar && seg + k < D)
                  ? to_f32(w[static_cast<size_t>(seg + k) * N + n])
                  : 0.f;
    }
  };

  float acc[TM][TN], ps[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  stage(0);
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int r = 0; r < kXL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      xs[e % kBK][e / kBK] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < kWL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      ws[e / BN][e % BN] = wr[r];
    }
    __syncthreads();
    if (t + 1 < n_tiles) stage(t + 1);  // in flight while this tile computes

    const int kt = t % kt_per_seg;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) ps[i][j] = 0.f;
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * kCols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) ps[i][j] = fmaf(a[i], b[j], ps[i][j]);
    }
    __syncthreads();
    if (kt == kt_per_seg - 1) {  // segment done: f in registers, add in order
      if constexpr (kGate) {
        const int s = s_first + t / kt_per_seg;
        if (gate_kind == kGatePacked) {
          // A warp holds 32 consecutive columns of a row (kCols == 32), or
          // 16 columns of two rows (kCols == 16): ballots give the words.
          const int nw_all = (N + kPack - 1) / kPack;
          uint32_t* gw = static_cast<uint32_t*>(gate) +
                         static_cast<size_t>(s) * M * nw_all;
          const int lane = threadIdx.x % 32;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty * TM + i;
#pragma unroll
            for (int q = 0; q < BN / kPack; ++q) {
              uint32_t word;
              bool writer;
              if constexpr (kCols == 32) {
                word = __ballot_sync(0xffffffffu,
                                     dendritic_grad(fn, ps[i][q]) != 0.f);
                writer = lane == 0;
              } else {
                const uint32_t lo = __ballot_sync(
                    0xffffffffu, dendritic_grad(fn, ps[i][2 * q]) != 0.f);
                const uint32_t hi = __ballot_sync(
                    0xffffffffu, dendritic_grad(fn, ps[i][2 * q + 1]) != 0.f);
                // lanes 0-15 hold the even row, lanes 16-31 the odd one
                word = lane < 16 ? ((lo & 0xffffu) | (hi << 16))
                                 : ((lo >> 16) | (hi & 0xffff0000u));
                writer = (lane & 15) == 0;
              }
              const int nw = n0 / kPack + q;
              if (writer && m < M && nw < nw_all)
                gw[static_cast<size_t>(m) * nw_all + nw] = word;
            }
          }
        } else {
          const size_t base = static_cast<size_t>(s) * M * N;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty * TM + i;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int n = n0 + tx + j * kCols;
              if (m >= M || n >= N) continue;
              const float gv = dendritic_grad(fn, ps[i][j]);
              const size_t at = base + static_cast<size_t>(m) * N + n;
              if (gate_kind == kGateU8)
                static_cast<uint8_t*>(gate)[at] = gv != 0.f;
              else
                static_cast<float*>(gate)[at] = gv;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += dendritic(fn, ps[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * kCols;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// y[i] = scratch[0][i] + scratch[1][i] + ... in segment order.
__global__ void segment_sum_kernel(const float* __restrict__ scratch,
                                   float* __restrict__ y, int S, size_t mn) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int s = 0; s < S; ++s) a += scratch[s * mn + i];
  y[i] = a;
}

}  // namespace cadc
