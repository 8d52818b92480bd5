// K2: the segmented backward of the CADC matmul, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cadc_matmul.py
// `_segmented_bwd` — `_bwd_dx_kernel`, `_bwd_dx_kernel_nomask`,
// `_bwd_dx_kernel_recompute` and the three `_bwd_dw_kernel*` twins. With
// p_s = x_s @ w_s and y = sum_s f(p_s), for the cotangent g [M, N]:
//
//     dx[:, s-th xbar columns] = (g ⊙ f'(p_s)) @ w_sᵀ     (contract over N)
//     dw[s-th xbar rows, :]    = x_sᵀ @ (g ⊙ f'(p_s))     (contract over M)
//
// x [M, D], w [D, N] and g are fp32; D need not be a multiple of xbar (the
// last segment is partial: the conv backward passes im2col patches). The
// gate f'(p_s) comes from the forward (K1g / K3) as packed uint32 words
// [S, M, ceil(N/32)], one byte or one fp32 per psum [S, M, N]; or it is
// absent (identity: f' = 1, g is used as it is); or it is recomputed here
// (save_gate="recompute": no residual) as f'(x_s @ w_s) in fp32, summed in
// the same order as the forward kernels, so the recomputed gate is bitwise
// the forward's.
//
// Bound on this card: at ResNet-18's stage-0 conv (M = B*OH*OW = 131072,
// D = 576, N = 64) each of dx and dw does 2*M*D*N = 9.7 GFLOP on ~0.4 GB
// of fp32 operands (x = the patches, g, the gate): bound by fp32 CUDA-core
// operations. Recompute adds the forward's 2*M*D*N per kernel.
//
// Design (simple before fast): both kernels are 64x64-tile CUDA-core GEMMs
// with 4x4 register micro-tiles, staging 32-deep slices through shared
// memory; the gate multiplies g as it is staged (bits unpacked there).
//  * dx: a block owns 64 rows of M and 64 columns of one segment, and
//    contracts over all of N. The grid is (M/64, S * xbar/64): blocks
//    enough wherever M is.
//  * dw: contracting over M gives few output tiles (S = 9, N = 64: 9 tiles
//    on 132 SMs at ResNet's first stage), so M is split across blocks:
//    each split writes its own fp32 partial [D, N], and a second kernel
//    sums the splits in a fixed order. No atomics, so dw is the same bits
//    from run to run.
//  * recompute: before each 32-wide slice of the contraction, the block
//    recomputes the psums it needs (an xbar-deep product of its x rows and
//    w columns) and keeps f'(psum) in shared memory.
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;
constexpr int kBK = 32;
constexpr int kT = 64;  // output tile edge; 16 x 16 threads of 4 x 4

// f'(p_s) at (s, m, n) from a saved gate.
template <int kKind>
__device__ __forceinline__ float saved_gate(const void* gate, int s, int m,
                                            int n, int M, int N) {
  const size_t row = static_cast<size_t>(s) * M + m;
  if constexpr (kKind == cadc::kGatePacked) {
    const int nw = (N + cadc::kPack - 1) / cadc::kPack;
    const uint32_t word =
        static_cast<const uint32_t*>(gate)[row * nw + n / cadc::kPack];
    return static_cast<float>((word >> (n % cadc::kPack)) & 1u);
  } else if constexpr (kKind == cadc::kGateU8) {
    return static_cast<float>(
        static_cast<const uint8_t*>(gate)[row * N + n]);
  } else {
    return static_cast<const float*>(gate)[row * N + n];
  }
}

// Shared-memory floats of recompute_gate<R, C>, and where its gate starts.
template <int R, int C>
struct RecomputeLayout {
  static constexpr int kGateAt = kBK * (R + 1) + kBK * C;
  static constexpr int kFloats = kGateAt + R * (C + 1);
};

// gs[r][c] (row stride C + 1) = f'(p) with p = sum over k < xbar of
// x[r0 + r, seg + k] * w[seg + k, c0 + c], accumulated with one fmaf per k
// in increasing k from 0 — the forward kernels' order. Rows at or past
// m_end and columns past N are masked to 0 inputs.
template <int R, int C>
__device__ __forceinline__ void recompute_gate(
    const float* __restrict__ x, const float* __restrict__ w, float* buf,
    int r0, int m_end, int c0, int seg, int xbar, int N, int D, int fn) {
  constexpr int kG = kThreads / C;  // row groups
  constexpr int kQ = R / kG;        // rows per thread
  static_assert(kG * C == kThreads && kQ * kG == R, "even split");
  float* xs = buf;                                   // [kBK][R + 1]
  float* wsm = xs + kBK * (R + 1);                   // [kBK][C]
  float* gs = buf + RecomputeLayout<R, C>::kGateAt;  // [R][C + 1]
  const int c = threadIdx.x % C, rg = threadIdx.x / C;
  float p[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) p[q] = 0.f;
  for (int k0 = 0; k0 < xbar; k0 += kBK) {
    for (int e = threadIdx.x; e < R * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int m = r0 + r, kk = k0 + k;
      xs[k * (R + 1) + r] = (m < m_end && kk < xbar && seg + kk < D)
                                ? x[static_cast<size_t>(m) * D + seg + kk]
                                : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * C; e += kThreads) {
      const int k = e / C, cc = e % C;
      const int n = c0 + cc, kk = k0 + k;
      wsm[k * C + cc] = (n < N && kk < xbar && seg + kk < D)
                            ? w[static_cast<size_t>(seg + kk) * N + n]
                            : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float b = wsm[k * C + c];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        p[q] = fmaf(xs[k * (R + 1) + rg + q * kG], b, p[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    gs[(rg + q * kG) * (C + 1) + c] = cadc::dendritic_grad(fn, p[q]);
  __syncthreads();
}

// The 64x64 tile product of one 32-deep slice: acc[i][j] +=
// sum_k a[k][ty*4 + i] * b[k][tx + 16*j].
__device__ __forceinline__ void tile_fma(const float (*a)[kT + 1],
                                         const float (*b)[kT + 1],
                                         float (&acc)[4][4], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dx block: rows m0 .. m0+63 of M, columns c0 .. c0+63 of segment s.
template <int kKind>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ w, const void* __restrict__ gate,
              float* __restrict__ dx, int M, int N, int D, int xbar,
              int fn) {
  constexpr bool kRe = kKind == cadc::kGateRecompute;
  __shared__ float as[kBK][kT + 1];  // as[n][m] = g * gate
  __shared__ float bs[kBK][kT + 1];  // bs[n][c] = w[seg + c0 + c, n]
  __shared__ float rbuf[kRe ? RecomputeLayout<kT, kBK>::kFloats : 1];
  const int ctiles = (xbar + kT - 1) / kT;
  const int s = blockIdx.y / ctiles, c0 = (blockIdx.y % ctiles) * kT;
  const int seg = s * xbar, m0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kBK) {
    if constexpr (kRe)
      recompute_gate<kT, kBK>(x, w, rbuf, m0, M, n0, seg, xbar, N, D, fn);
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int ml = e / kBK, k = e % kBK;
      const int m = m0 + ml, n = n0 + k;
      float v = 0.f;
      if (m < M && n < N) {
        v = g[static_cast<size_t>(m) * N + n];
        if constexpr (kRe)
          v *= rbuf[RecomputeLayout<kT, kBK>::kGateAt + ml * (kBK + 1) + k];
        else if constexpr (kKind != cadc::kGateNone)
          v *= saved_gate<kKind>(gate, s, m, n, M, N);
      }
      as[k][ml] = v;
    }
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int c = e / kBK, k = e % kBK;
      const int d = seg + c0 + c, n = n0 + k;
      bs[k][c] = (c0 + c < xbar && d < D && n < N)
                     ? w[static_cast<size_t>(d) * N + n]
                     : 0.f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < xbar && seg + c < D)
        dx[static_cast<size_t>(m) * D + seg + c] = acc[i][j];
    }
  }
}

// dw block: rows c0 .. c0+63 of segment s, columns n0 .. n0+63, over the
// M rows of split blockIdx.z; writes out + z * D * N.
template <int kKind>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ w, const void* __restrict__ gate,
              float* __restrict__ out, int M, int N, int D, int xbar, int fn,
              int rows_per_split) {
  constexpr bool kRe = kKind == cadc::kGateRecompute;
  __shared__ float as[kBK][kT + 1];  // as[m][c] = x[m, seg + c0 + c]
  __shared__ float bs[kBK][kT + 1];  // bs[m][n] = g * gate
  __shared__ float rbuf[kRe ? RecomputeLayout<kBK, kT>::kFloats : 1];
  const int ctiles = (xbar + kT - 1) / kT;
  const int s = blockIdx.y / ctiles, c0 = (blockIdx.y % ctiles) * kT;
  const int seg = s * xbar, n0 = blockIdx.x * kT;
  const int m_lo = blockIdx.z * rows_per_split;
  const int m_hi = min(M, m_lo + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  out += static_cast<size_t>(blockIdx.z) * D * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int mk0 = m_lo; mk0 < m_hi; mk0 += kBK) {
    if constexpr (kRe)
      recompute_gate<kBK, kT>(x, w, rbuf, mk0, m_hi, n0, seg, xbar, N, D,
                              fn);
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int c = e % kT, k = e / kT;
      const int m = mk0 + k, d = seg + c0 + c;
      as[k][c] = (m < m_hi && c0 + c < xbar && d < D)
                     ? x[static_cast<size_t>(m) * D + d]
                     : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int nl = e % kT, k = e / kT;
      const int m = mk0 + k, n = n0 + nl;
      float v = 0.f;
      if (m < m_hi && n < N) {
        v = g[static_cast<size_t>(m) * N + n];
        if constexpr (kRe)
          v *= rbuf[RecomputeLayout<kBK, kT>::kGateAt + k * (kT + 1) + nl];
        else if constexpr (kKind != cadc::kGateNone)
          v *= saved_gate<kKind>(gate, s, m, n, M, N);
      }
      bs[k][nl] = v;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= xbar || seg + c >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<size_t>(seg + c) * N + n] = acc[i][j];
    }
  }
}

// dw[i] = parts[0][i] + parts[1][i] + ... in split order.
__global__ void split_sum_kernel(const float* __restrict__ parts,
                                 float* __restrict__ dw, int splits,
                                 size_t dn) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (i >= dn) return;
  float a = 0.f;
  for (int p = 0; p < splits; ++p) a += parts[p * dn + i];
  dw[i] = a;
}

template <int kKind>
int launch(const float* g, const float* x, const float* w, const void* gate,
           float* dx, float* dw, float* scratch, int splits,
           int rows_per_split, int M, int N, int D, int xbar, int fn,
           cudaStream_t stream) {
  const int S = (D + xbar - 1) / xbar;
  const int ctiles = (xbar + kT - 1) / kT;
  if (dx != nullptr) {
    dim3 grid((M + kT - 1) / kT, S * ctiles);
    bwd_dx_kernel<kKind><<<grid, kThreads, 0, stream>>>(g, x, w, gate, dx, M,
                                                        N, D, xbar, fn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    dim3 grid((N + kT - 1) / kT, S * ctiles, splits);
    bwd_dw_kernel<kKind><<<grid, kThreads, 0, stream>>>(
        g, x, w, gate, splits > 1 ? scratch : dw, M, N, D, xbar, fn,
        rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t dn = static_cast<size_t>(D) * N;
    split_sum_kernel<<<static_cast<unsigned>((dn + 255) / 256), 256, 0,
                       stream>>>(scratch, dw, splits, dn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g [M, N], x [M, D], w [D, N] fp32, row-major; gate as gate_kind says
// (0 none, 1 packed uint32 [S, M, ceil(N/32)], 2 uint8 [S, M, N], 3 fp32
// [S, M, N], 4 recompute: NULL). dx [M, D] and dw [D, N] fp32, either may
// be NULL (not wanted). dw sums `splits` partials of `rows_per_split` rows
// of M each; scratch is fp32 [splits, D, N] when splits > 1, else NULL.
// Returns the CUDA error code after the launches (0 = success).
extern "C" int cadc_bwd_launch(const void* g, const void* x, const void* w,
                               const void* gate, void* dx, void* dw,
                               void* scratch, int splits, int rows_per_split,
                               int M, int N, int D, int xbar, int fn,
                               int gate_kind, void* stream) {
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* dxp = static_cast<float*>(dx);
  float* dwp = static_cast<float*>(dw);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CADC_BWD(kind)                                                      \
  return launch<kind>(gp, xp, wp, gate, dxp, dwp, sc, splits,               \
                      rows_per_split, M, N, D, xbar, fn, st)
  switch (gate_kind) {
    case cadc::kGateNone: CADC_BWD(cadc::kGateNone);
    case cadc::kGatePacked: CADC_BWD(cadc::kGatePacked);
    case cadc::kGateU8: CADC_BWD(cadc::kGateU8);
    case cadc::kGateF32: CADC_BWD(cadc::kGateF32);
    case cadc::kGateRecompute: CADC_BWD(cadc::kGateRecompute);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CADC_BWD
}

extern "C" const char* cadc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
