// CADC segmented matmul with fused dendritic f(), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cadc_matmul.py `_kernel`
// (launched by `_fwd_pallas`, the forward of `cadc_matmul_pallas`):
//
//     y[M, N] = sum_s f( x[:, s*xbar:(s+1)*xbar] @ w[s*xbar:(s+1)*xbar, :] )
//
// with every psum in fp32, f applied per segment before the cross-segment
// sum, segments added in order s = 0, 1, ... into an fp32 accumulator, and
// one write per output element. In the single pass the psums never leave
// the block.
//
// Bound on this card: at decode (M = serve slots, 8) each weight element
// is read once and used for 2*M flops, so the kernel is bound by the bytes
// of w over HBM bandwidth (gemma3-1b: ~1.5 GB of bf16 segmented weights per
// decode step). At prefill (M = slots x prompt bucket) it is bound by
// operations.
//
// Design (simple before fast): one block owns a BM x BN tile of y and walks
// its segments in order. Inside a segment it stages 32-row slices of x and
// w through shared memory, converted to fp32, prefetching the next slice
// into registers while the current one computes, and builds the psum with
// CUDA-core FMAs (exact fp32 for fp32 inputs: no TF32); then it applies f
// in registers and adds into the accumulator. The ragged M and N edges are
// masked here, so the host pads nothing but D to S*xbar. BM follows M: 8
// rows for decode-sized M (no wasted rows at 8 slots), 64 otherwise.
//
// At decode a single pass has too few blocks to stream the weights (w_down,
// N = 1152, gives 18 column tiles), so for small M the wrapper asks for the
// split form: one block per (column tile, segment), each writing its
// f(psum) tile to an fp32 scratch, and a second kernel summing the
// segments in order — bitwise the single pass's result. Tensor cores
// (wgmma) and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;

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
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)  // <= 128 registers a thread
cadc_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ y, int M, int N, int S, int xbar,
                   int fn, int split) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile per thread");
  constexpr int kCols = BN / TN;
  constexpr int kXL = BM * kBK / kThreads;  // x elements staged per thread
  constexpr int kWL = kBK * BN / kThreads;  // w elements staged per thread
  static_assert(kXL * kThreads == BM * kBK && kWL * kThreads == kBK * BN,
                "tiles split evenly over the threads");
  __shared__ float xs[kBK][BM + 1];  // transposed; +1 breaks bank conflicts
  __shared__ float ws[kBK][BN];

  const size_t D = static_cast<size_t>(S) * xbar;
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
    const size_t seg = static_cast<size_t>(s_first + t / kt_per_seg) * xbar;
#pragma unroll
    for (int r = 0; r < kXL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int m = m0 + e / kBK, k = k0 + e % kBK;
      xr[r] = (m < M && k < xbar)
                  ? to_f32(x[static_cast<size_t>(m) * D + seg + k])
                  : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kWL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int n = n0 + e % BN, k = k0 + e / BN;
      wr[r] = (n < N && k < xbar)
                  ? to_f32(w[(seg + k) * static_cast<size_t>(N) + n])
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

template <typename T, int BM, int BN, int TM, int TN>
int launch(const void* x, const void* w, void* y, float* scratch, int M,
           int N, int S, int xbar, int fn, cudaStream_t stream) {
  const int split = scratch != nullptr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split ? S : 1);
  cadc_matmul_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      split ? scratch : static_cast<float*>(y), M, N, S, xbar, fn, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  segment_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                       stream>>>(scratch, static_cast<float*>(y), S, mn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, float* scratch, int M,
             int N, int S, int xbar, int fn, cudaStream_t stream) {
  if (M <= 8)
    return launch<T, 8, 64, 1, 2>(x, w, y, scratch, M, N, S, xbar, fn, stream);
  return launch<T, 64, 64, 4, 4>(x, w, y, scratch, M, N, S, xbar, fn, stream);
}

}  // namespace

// x [M, S*xbar] and w [S*xbar, N], row-major, both fp32 (dtype 0) or bf16
// (dtype 1); y [M, N] fp32. scratch: NULL for the single pass, or an fp32
// [S, M, N] buffer for the per-segment split. Returns the CUDA error code
// after the launches (0 = success).
extern "C" int cadc_matmul_launch(const void* x, const void* w, void* y,
                                  void* scratch, int M, int N, int S,
                                  int xbar, int fn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float>(x, w, y, sc, M, N, S, xbar, fn, st);
  return dispatch<__nv_bfloat16>(x, w, y, sc, M, N, S, xbar, fn, st);
}

extern "C" const char* cadc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
