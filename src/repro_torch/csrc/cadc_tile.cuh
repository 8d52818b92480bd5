// Shared device code of the CADC kernels for Hopper (sm_90a): the dendritic
// fns and their derivatives, the segmented forward tile kernel that K1
// and K1g (cadc_matmul.cu) and the gather kernels of K3 and K5
// (cadc_conv.cu) instantiate, the ordered segment sum that ends a launch
// split over segments (the tile kernel's split, and cadc_matmul.cu's
// stream kernel), the int8 tensor-core pieces of K4 (cadc_matmul.cu)
// and K5's tap kernel (cadc_conv.cu), and the bf16 ones of K1 / K1g's
// tensor-core kernel (cadc_matmul.cu) and K2's (cadc_bwd.cu).
//
// The forward tile kernel computes
//
//     y[M, N] = sum_s f( sum_{k < xbar, s*xbar + k < D} X(m, s*xbar + k) * w[s*xbar + k, n] )
//
// where X is read through a loader: the row-major x of a matmul (K1,
// K1g) or the implicit im2col gather of a convolution (K3, K5). f is applied
// per segment before the cross-segment sum, segments are added in order
// s = 0, 1, ... into an fp32 accumulator, and each output element of y is
// written once. With kGate the kernel also writes each segment's gate
// f'(psum) from the same fp32 psum, in registers: packed 32 to a uint32
// word along N (bit b of word w = column 32w + b, the JAX bit layout, N
// padded to whole words), or one byte / one fp32 per psum.
//
// Acc is the psum's type. float (K1, K1g, K3): fp32 operands (bf16
// widened), fp32 FMAs. int (K5's gather kernel): int8 operands widened
// to int32, exact int32 multiply-adds — so the order of the psum's terms
// is free — and at the end of each segment the psum is dequantized once,
// float(p) * scale with scale read from device memory. In the q8 kernels
// every rounding after that is explicit (__int2float_rn, __fmul_rn,
// __fadd_rn, __fsqrt_rn): nvcc contracts a * b + c into one fmaf by
// default, which rounds once where PyTorch rounds twice, and the q8
// kernels are bitwise their plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

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

// An operand widened to the psum's type: fp32 (bf16 converted), or int32.
template <typename Acc, typename T>
__device__ __forceinline__ Acc widen(T v) {
  if constexpr (std::is_same_v<Acc, int>)
    return static_cast<int>(v);
  else
    return to_f32(v);
}

__device__ __forceinline__ float mac(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

// The fp32 psum of an accumulator: itself, or an int32 psum dequantized.
__device__ __forceinline__ float psum_f32(float p, float) { return p; }
__device__ __forceinline__ float psum_f32(int p, float scale) {
  return __fmul_rn(__int2float_rn(p), scale);
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

// dendritic() with every rounding explicit, as PyTorch rounds (the q8
// kernels): no fmaf contraction of the dequantization or of the sum.
__device__ __forceinline__ float dendritic_rn(int fn, float p) {
  switch (fn) {
    case 0: return p;
    case 1: return p > 0.f ? p : 0.f;
    case 2: return p > 0.f ? __fsqrt_rn(__fadd_rn(p, 1e-12f)) : 0.f;
    case 3: return p > 0.f ? __fmul_rn(p, p) : 0.f;
    default: return p > 0.f ? tanhf(p) : 0.f;
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

// 16 bytes (or 4) from global to shared memory by cp.async; with !pred no
// byte is read and zeros are written (src-size 0).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void copy4(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// The memory clobber keeps the compiler from reading shared memory that
// the awaited copies write before the wait.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 1.0f where bit b of word is set, else 0.0f, by integer ops alone.
__device__ __forceinline__ float bit_f(uint32_t word, int b) {
  return __uint_as_float((0u - ((word >> b) & 1u)) & 0x3f800000u);
}

// Four 8 x 8 matrices of 16-bit elements (here: 8 rows of 16 bytes each)
// from shared memory; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four 8 x 8 matrices of 16-bit elements, each transposed on the way in
// (ldmatrix .trans): from a k-major tile, the col-major B fragments.
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4],
                                        const unsigned char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (m16 x k16, row) * b (k16 x n8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bits of one bf16 in global memory, through the read-only path.
__device__ __forceinline__ unsigned short ld_bf16_bits(
    const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// d += a (m16 x k32, row) * b (k32 x n8, col), int8 in, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An int32 psum that starts at the bits of 1.5 * 2^23 holds kMagicBits + p;
// for |p| <= 2^22 (int8 codes, xbar <= kMagicMaxXbar: 256 * 128 * 128)
// those are the bits of the float 1.5 * 2^23 + p, exactly, so one
// subtraction of kMagicF gives float(p) with no rounding — the result of
// __int2float_rn, which issues at 16 a clock per SM where the subtraction
// issues at 128.
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagicF = 12582912.f;
constexpr int kMagicMaxXbar = 256;

// Set a kernel's dynamic shared-memory opt-in once per device (host).
template <typename Kernel>
int opt_in(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(done.load() >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done.fetch_or(uint64_t{1} << dev);
  }
  return 0;
}

// The ordered segment sum of a split launch, run by every thread of a
// block at its end. Each of the S blocks of an output tile (rows m0 ..
// m0+rows-1, columns n0 .. n0+cols-1, rows*cols <= kPer * blockDim.x) has
// written its f(psum) tile to scratch [S, M, N]; after a barrier one thread
// adds one to the tile's arrival counter with a GPU-scope acquire-release
// atomic, which publishes the block's writes (the same release pattern as
// a CUTLASS semaphore). The block
// that arrives last reads the S tiles through L2, kPer elements a thread
// and up to 64 loads in flight, adds them in order s = 0, 1, ...
// from an fp32 zero — the single pass's additions in its order — writes y
// and resets the counter to 0, so the counters are zero between launches.
// One launch per split call, and no second kernel.
//
// arrive_last is its first half, for sums of other layouts (the conv
// backward's wgrad): whether this block is the last of S to arrive at the
// counter, every block's writes before the call then visible to it.
__device__ __forceinline__ bool arrive_last(int* counter, int S) {
  __shared__ int last;
  __syncthreads();  // the block's tile is written (CTA scope)
  if (threadIdx.x == 0) {
    // acq_rel at GPU scope: releases the tile (cumulative over the
    // barrier) and acquires the other blocks' tiles for the whole block.
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counter) : "memory");
    last = old == S - 1;
  }
  __syncthreads();
  return last;
}

template <int kPer>
__device__ __forceinline__ void ordered_segment_sum(
    const float* scratch, float* __restrict__ y, int* counter, int S, int M,
    int N, int m0, int rows, int n0, int cols) {
  if (!arrive_last(counter, S)) return;
  // segments whose loads are in flight together: 32 or 64 loads a thread
  constexpr int kSeg = kPer >= 16 ? 2 : kPer >= 4 ? 64 / kPer : 16;
  const size_t mn = static_cast<size_t>(M) * N;  // a split has M*N < 2^31
  int at[kPer];
  bool ok[kPer];
  float a[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    const int m = m0 + e / cols, n = n0 + e % cols;
    ok[i] = e < rows * cols && m < M && n < N;
    at[i] = ok[i] ? m * N + n : 0;
    a[i] = 0.f;
  }
  int s = 0;
  for (; s + kSeg <= S; s += kSeg) {
    float v[kSeg][kPer];
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[j][i] = ok[i] ? __ldcg(scratch + (s + j) * mn + at[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] += v[j][i];
  }
  for (; s < S; ++s) {
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      v[i] = ok[i] ? __ldcg(scratch + s * mn + at[i]) : 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (ok[i]) y[at[i]] = a[i];
  if (threadIdx.x == 0) *counter = 0;
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
// !kSplit (the single pass): the block owns all S segments and writes y.
// kSplit: the block owns segment blockIdx.z alone,
// writes its f(psum) tile to scratch + z*M*N, and the last of the S blocks
// of its output tile to arrive adds the S tiles into y in order s = 0, 1,
// ... (ordered_segment_sum) — the single pass's additions in its order, so
// the result is bitwise the same. Every thread's psum runs over k in order
// whatever BM and BN are, so every tile shape and split gives the same
// bits, gate included.
//
// XLoad: `Acc operator()(int m, int d) const` returns X(m, d) for
// m < M, d < D (the caller masks both). scale: the q8 kernels' fp32
// dequantization factor in device memory (read once); unused for float.
template <typename T, typename Acc, int BM, int BN, int TM, int TN,
          bool kGate, bool kSplit, typename XLoad>
__global__ void __launch_bounds__(kThreads, 2)  // <= 128 registers a thread
fwd_tile_kernel(XLoad xl, const T* __restrict__ w, float* __restrict__ y,
                float* __restrict__ scratch, int* __restrict__ counters,
                void* __restrict__ gate, int M, int N, int D, int S,
                int xbar, int fn, int gate_kind,
                const float* __restrict__ scale) {
  constexpr bool kQ8 = std::is_same_v<Acc, int>;
  static_assert((BM / TM) * (BN / TN) == kThreads, "one micro-tile per thread");
  constexpr int kCols = BN / TN;
  static_assert(!kGate || ((kCols == 32 || kCols == 16) && BN % kPack == 0),
                "packed gates need 32 or 16 thread columns");
  constexpr int kXL = BM * kBK / kThreads;  // x elements staged per thread
  constexpr int kWL = kBK * BN / kThreads;  // w elements staged per thread
  static_assert(kXL * kThreads == BM * kBK && kWL * kThreads == kBK * BN,
                "tiles split evenly over the threads");
  __shared__ Acc xs[kBK][BM + 1];  // transposed; +1 breaks bank conflicts
  __shared__ Acc ws[kBK][BN];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int s_first = kSplit ? blockIdx.z : 0;
  const int kt_per_seg = (xbar + kBK - 1) / kBK;
  const int n_tiles = (kSplit ? 1 : S) * kt_per_seg;
  float* out =
      kSplit ? scratch + static_cast<size_t>(blockIdx.z) * M * N : y;
  float sc = 1.f;
  if constexpr (kQ8) sc = *scale;

  Acc xr[kXL], wr[kWL];
  auto stage = [&](int t) {
    const int k0 = (t % kt_per_seg) * kBK;
    const int seg = (s_first + t / kt_per_seg) * xbar;
#pragma unroll
    for (int r = 0; r < kXL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int m = m0 + e / kBK, k = k0 + e % kBK;
      xr[r] = (m < M && k < xbar && seg + k < D) ? xl(m, seg + k) : Acc(0);
    }
#pragma unroll
    for (int r = 0; r < kWL; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int n = n0 + e % BN, k = k0 + e / BN;
      wr[r] = (n < N && k < xbar && seg + k < D)
                  ? widen<Acc>(w[static_cast<size_t>(seg + k) * N + n])
                  : Acc(0);
    }
  };

  float acc[TM][TN];
  Acc ps[TM][TN];
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
        for (int j = 0; j < TN; ++j) ps[i][j] = Acc(0);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * kCols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) ps[i][j] = mac(a[i], b[j], ps[i][j]);
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
                word = __ballot_sync(
                    0xffffffffu,
                    dendritic_grad(fn, psum_f32(ps[i][q], sc)) != 0.f);
                writer = lane == 0;
              } else {
                const uint32_t lo = __ballot_sync(
                    0xffffffffu,
                    dendritic_grad(fn, psum_f32(ps[i][2 * q], sc)) != 0.f);
                const uint32_t hi = __ballot_sync(
                    0xffffffffu,
                    dendritic_grad(fn, psum_f32(ps[i][2 * q + 1], sc)) != 0.f);
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
              const float gv = dendritic_grad(fn, psum_f32(ps[i][j], sc));
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
        for (int j = 0; j < TN; ++j) {
          if constexpr (kQ8)
            acc[i][j] = __fadd_rn(acc[i][j],
                                  dendritic_rn(fn, psum_f32(ps[i][j], sc)));
          else
            acc[i][j] += dendritic(fn, ps[i][j]);
        }
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
  if constexpr (kSplit)
    ordered_segment_sum<BM * BN / kThreads>(
        scratch, y, counters + blockIdx.y * gridDim.x + blockIdx.x, S, M, N,
        m0, BM, n0, BN);
}

}  // namespace cadc
