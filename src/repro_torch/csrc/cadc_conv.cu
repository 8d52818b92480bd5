// K3: fused im2col CADC conv2d, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cadc_conv.py `_kernel`
// and `_kernel_with_gate` (launched by `_conv_pallas`, with `_tap_psum`
// building each segment's psum over its taps):
//
//     y[b, oh, ow, n] = sum_s f( sum_{d in segment s} P(b, oh, ow, d) * w2d[d, n] )
//
// x NHWC, w HWIO = w2d [D = K1*K2*Cin, Cout] row-major, and
// P(b, oh, ow, (i*K2 + j)*Cin + c) = x[b, oh*s1 + i - pt, ow*s2 + j - pl, c]
// (0 in the padding): the unrolled contraction runs taps outer, channels
// fastest, and is cut into contiguous xbar-row segments, the last one
// partial — the segmentation of `_segment_taps`, where a segment may span
// several taps. Each segment's psum is accumulated in fp32 over all its
// taps before f.
//
// Bound on this card: a conv of ResNet-18 at batch 128 does 2*M*D*Cout
// flops (M = B*OH*OW) on 4*(B*H*W*Cin + D*Cout + M*Cout) bytes, e.g.
// 9.7 GFLOP on 67 MB for a 64-channel 3x3 stage-0 conv (0.14 ms of
// fp32 CUDA-core peak against 0.02 ms of bytes): bound by operations, so
// what counts is the share of the SMs' issue slots that are FFMAs.
//
// Two kernels; kernels/cadc_conv.py `plan_conv` picks one, and its tile,
// from the shapes (one launch either way):
//
//  * the tap-aligned kernel (`tap_tile_kernel` below), for Cin % 32 == 0
//    and xbar % 32 == 0 — every ResNet-18 conv but the stem, every VGG-16
//    conv but the first. Every 32-row k-tile of D then lies inside one tap
//    (i, j) and one segment, so a pixel's 32 rows of the tile are 128
//    contiguous bytes of x (or zeros in the halo): (i, j, c0) are computed
//    once per k-tile, a pixel's (b, ih0, iw0) once per block. x rows and w
//    rows move by 16-byte cp.async (src-size 0 zero-fills the halo and the
//    ragged edges) into a 2- or 3-stage ring in dynamic shared memory;
//    stride and padding come in by indexing, so neither patches nor a
//    padded image are written. A thread owns an 8 x 8 (128 x 64 tiles) or
//    8 x 4 (64 x 64 tiles) micro-tile — rows strided by the thread rows,
//    columns in groups of 4 — read as 16- or 8-byte shared loads: x rows
//    are padded to 36 floats, so the 4 thread rows of a warp hit distinct
//    banks, and the 8 thread columns of a warp read 128 contiguous bytes
//    of w. Each output needs two accumulators (the segment's psum and the
//    sum of f(psum)), so a thread of an 8 x 8 tile holds 128 of them: two
//    128-thread blocks an SM, up to 255 registers a thread, no spills
//    (chip_smoke.py prints ptxas and fails on a spill). f is applied at a
//    segment's end in a copy of that code per dendritic fn, so the
//    segment end (every two k-tiles at xbar 64) runs no switch. Measured
//    on an H100 80GB HBM3 at 700 W against 8 x 4 tiles on 256 threads
//    (registers capped at 128: spills), 8 x 8 on 256 threads, the sums of
//    f(psum) or the pixel rows' offsets in shared memory, segments as an
//    outer loop, and 2 / 3 / 4 stages: all slower or spilling (PERF.md).
//  * the gather kernel (`ConvGather` on cadc_tile.cuh's tile kernel, 64 x
//    64 tiles), for the other shapes (the stems, LeNet-5, the SNN's
//    conv1): it decomposes each element's (m, d) and loads 4 bytes at a
//    time. K5 runs on it too.
//
// Both compute every psum as one fmaf per d, in increasing d from the
// segment's first row, from 0; f at the segment's end; the segments added
// in order s = 0, 1, ... into an fp32 zero — K2's recompute repeats that
// chain — so every plan gives the same bits, gate included. The gate
// variant writes [S, B, OH, OW, ceil(Cout/32)] uint32 words (bit b of word
// w = column 32w + b), or one byte / fp32 per psum, as K1g does. In the
// tap kernel the 8 lanes of a thread row hold a word's 8 groups of 4
// columns for each of their 8 rows; an 8 x 8 transpose of those groups
// across the lanes (three 64-bit shuffle rounds) leaves each lane with one
// row's words, written in one store — where one OR-reduction of shuffles
// per word and 16 narrow stores a thread had cost the gate variant 15% of
// its time (PERF.md). Dilation is 1.
//
// K5 replaces the q8 bodies of the same launcher, `_q8_kernel` and
// `_q8_kernel_with_gate` (`_tap_psum` with acc_dtype int32; entry
// `cadc_conv2d_q8_pallas`): x_q int8 NHWC codes and w int8 HWIO codes give
// an exact int32 psum per segment, summed over the segment's taps before
// it is dequantized once (float(p) * scale, scale read from device memory)
// and f applied; then the sequential fp32 sum, and the gate
// [S, B, OH, OW, ceil(Cout/32)] from the dequantized psum. It is the same
// implicit GEMM over int8 gathers with int32 multiply-adds, every rounding
// after the dequantization explicit (cadc_tile.cuh), so bitwise its plain
// version. The first conv of a model has Cin = 3 (or 2): its patch rows are
// not aligned, and the gather reads them a byte at a time. Bound on this
// card: 1 byte per input element and 4 per fp32 output make every VGG-16
// conv at batch 128 bound by bytes at the data-sheet rates (its first 3x3
// 64-channel conv: 42 MB, 12.5 us at 3.35 TB/s, against 9.7 G int8
// operations, 4.9 us at the int8 tensor-core peak). This kernel runs them
// as int32 multiply-adds on CUDA cores; the int8 tensor cores are later
// work.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "cadc_tile.cuh"

namespace {

using cadc::kBK;
using cadc::kPack;
using cadc::kThreads;

// ---------------------------------------------------------------------------
// the gather kernel (K3's generic plan, and K5)
// ---------------------------------------------------------------------------

// X(m, d) = the im2col patch element of output pixel m = (b, oh, ow) and
// contraction row d = (i*K2 + j)*Cin + c, widened to the psum's type.
template <typename T, typename Acc>
struct ConvGather {
  const T* x;
  int H, W, Cin, K2, OH, OW, s1, s2, pt, pl;
  __device__ __forceinline__ Acc operator()(int m, int d) const {
    const int ow = m % OW;
    const int t = m / OW;
    const int oh = t % OH;
    const int b = t / OH;
    const int tap = d / Cin;
    const int c = d - tap * Cin;
    const int i = tap / K2;
    const int j = tap - i * K2;
    const int ih = oh * s1 + i - pt;
    const int iw = ow * s2 + j - pl;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return Acc(0);
    return cadc::widen<Acc>(
        x[((static_cast<size_t>(b) * H + ih) * W + iw) * Cin + c]);
  }
};

template <typename T, typename Acc, bool kGate>
int launch(const ConvGather<T, Acc>& g, const T* w, const float* scale,
           float* y, void* gate, int M, int N, int D, int xbar, int fn,
           int gate_kind, cudaStream_t stream) {
  const int S = (D + xbar - 1) / xbar;
  dim3 grid((N + 63) / 64, (M + 63) / 64, 1);
  cadc::fwd_tile_kernel<T, Acc, 64, 64, 4, 4, kGate, /*kSplit=*/false,
                        ConvGather<T, Acc>>
      <<<grid, kThreads, 0, stream>>>(g, w, y, /*scratch=*/nullptr,
                                      /*counters=*/nullptr, gate, M, N, D, S,
                                      xbar, fn, gate_kind, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int by_gate(const void* x, const void* w, const void* scale, void* y,
            void* gate, int B, int H, int W, int Cin, int K1, int K2,
            int Cout, int OH, int OW, int s1, int s2, int pt, int pl,
            int xbar, int fn, int gate_kind, void* stream) {
  const ConvGather<T, Acc> g{static_cast<const T*>(x), H, W, Cin, K2, OH, OW,
                             s1, s2, pt, pl};
  const int M = B * OH * OW, D = K1 * K2 * Cin;
  const T* wp = static_cast<const T*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate_kind == cadc::kGateNone)
    return launch<T, Acc, false>(g, wp, sp, yp, nullptr, M, Cout, D, xbar, fn,
                                 gate_kind, st);
  return launch<T, Acc, true>(g, wp, sp, yp, gate, M, Cout, D, xbar, fn,
                              gate_kind, st);
}

// ---------------------------------------------------------------------------
// the tap-aligned kernel (K3's fast plan)
// ---------------------------------------------------------------------------

// 16 bytes (or 4) from global to shared memory by cp.async; with !pred no
// byte is read and zeros are written (src-size 0).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The conv a tap-aligned launch computes (x, w 16-byte aligned, Cin and
// xbar multiples of 32, so D = K1*K2*Cin is one too).
struct TapConv {
  const float* x;
  const float* w;
  float* y;
  void* gate;
  int M, N, D, xbar, H, W, Cin, K2, OH, OW, s1, s2, pt, pl, fn, gate_kind;
};

// A block of BM output pixels x BN output channels; (BM/TM) x (BN/TN)
// threads, each owning TM rows (ty + i*kNTY) and TN columns in groups of 4
// (g*kSpan + tx*4 + c). A warp holds 4 thread rows x 8 thread columns. kAK:
// depth of a thread's x fragment (4: 16-byte loads, 2: 8-byte loads).
template <int BM, int BN, int TM, int TN, int kAK, int kStages>
struct TapCfg {
  static constexpr int kNTY = BM / TM, kNTX = BN / TN;
  static constexpr int kThreads = kNTY * kNTX;
  static constexpr int kGroups = TN / 4;
  static constexpr int kSpan = BN / kGroups;  // = kNTX * 4
  static constexpr int kAStride = kBK + 4;    // 9 x 16 bytes a pixel row
  static constexpr int kAFloats = BM * kAStride;
  static constexpr int kStageFloats = kAFloats + kBK * BN;
  static constexpr int kXL = BM * (kBK / 4) / kThreads;  // x copies a thread
  static constexpr int kWL = kBK * (BN / 4) / kThreads;  // w copies a thread
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kStages * kStageFloats;
  static_assert(TN % 4 == 0 && kNTX % 8 == 0 && kNTY % 4 == 0,
                "warps of 4 x 8 threads, columns in groups of 4");
  static_assert(kSpan % kPack == 0, "a packed word lies in one group");
  static_assert(kXL * kThreads == BM * (kBK / 4) &&
                    kWL * kThreads == kBK * (BN / 4),
                "copies split evenly over the threads");
  static_assert((kAK == 4 || kAK == 2) && kStages >= 2, "fragment, ring");
};

// Units of kU bits: unit j of v = bits kU*j .. kU*j + kU-1. After the
// call, unit j of lane q's v is unit q of lane j's v, for the 8 lanes of
// each aligned group of 8 (three butterfly rounds of an 8 x 8 transpose).
template <int kU>
__device__ __forceinline__ uint64_t transpose8(uint64_t v, int q) {
#pragma unroll
  for (int d = 4; d >= 1; d >>= 1) {
    uint64_t lo = 0;  // the units whose index has bit d clear
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(j & d)) lo |= ((uint64_t{1} << kU) - 1) << (kU * j);
    const bool upper = q & d;
    const uint64_t recv =
        __shfl_xor_sync(0xffffffffu, upper ? (v & lo) : (v & ~lo), d);
    v = upper ? ((v & ~lo) | (recv >> (kU * d)))
              : ((v & lo) | (recv << (kU * d)));
  }
  return v;
}

// The low nibble of each byte of v, in order, as 32 bits.
__device__ __forceinline__ uint32_t pack_nibbles(uint64_t v) {
  v &= 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v >> 4)) & 0x00FF00FF00FF00FFull;
  v = (v | (v >> 8)) & 0x0000FFFF0000FFFFull;
  return static_cast<uint32_t>(v | (v >> 16));
}

template <int kAK>
struct Frag;
template <>
struct Frag<4> {
  using V = float4;
  static __device__ __forceinline__ float at(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <>
struct Frag<2> {
  using V = float2;
  static __device__ __forceinline__ float at(const float2& v, int k) {
    return k == 0 ? v.x : v.y;
  }
};

// Two 128-thread blocks an SM: up to 255 registers a thread.
template <int BM, int BN, int TM, int TN, int kAK, int kStages, bool kGate>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)
tap_tile_kernel(const TapConv p) {
  using C = TapCfg<BM, BN, TM, TN, kAK, kStages>;
  using F = Frag<kAK>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  constexpr int kWX = C::kNTX / 8;  // warps across the columns
  const int tx = (warp % kWX) * 8 + lane % 8;
  const int ty = (warp / kWX) * 4 + lane / 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = p.D / kBK, kts = p.xbar / kBK;
  const float* __restrict__ x = p.x;
  const float* __restrict__ w = p.w;
  const bool wvec = p.N % 4 == 0;

  // The x copies of this thread: 16 bytes (channels chunk*4 ..) of pixel
  // rows tid/8 + r*(kThreads/8). pix = the pixel index of x[b, ih0, iw0]
  // (x has < 2^31 pixels: at Cin >= 32 more would not fit a card).
  const int chunk = tid % 8;
  int ih0[C::kXL], iw0[C::kXL], pix[C::kXL];
#pragma unroll
  for (int r = 0; r < C::kXL; ++r) {
    const int m = m0 + tid / 8 + r * (C::kThreads / 8);
    const int ow = m % p.OW, t = m / p.OW;
    const int oh = t % p.OH, b = t / p.OH;
    const int ih = oh * p.s1 - p.pt;
    iw0[r] = ow * p.s2 - p.pl;
    pix[r] = (b * p.H + ih) * p.W + iw0[r];
    ih0[r] = m < p.M ? ih : -(1 << 29);  // rows past M read as halo
  }

  // k-tile t (rows 32t .. 32t + 31 of D, inside one tap) into ring slot.
  auto load = [&](int t, int slot) {
    float* as = smem + slot * C::kStageFloats;
    float* bs = as + C::kAFloats;
    const int d0 = t * kBK;
    const int tap = d0 / p.Cin;
    const int c0 = d0 - tap * p.Cin;
    const int i = tap / p.K2, j = tap - i * p.K2;
    const int toff = i * p.W + j;
#pragma unroll
    for (int r = 0; r < C::kXL; ++r) {
      const bool ok = static_cast<unsigned>(ih0[r] + i) <
                          static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(iw0[r] + j) <
                          static_cast<unsigned>(p.W);
      const float* src =
          ok ? x + static_cast<long long>(pix[r] + toff) * p.Cin + c0 +
                   chunk * 4
             : x;
      copy16(as + (tid / 8 + r * (C::kThreads / 8)) * C::kAStride +
                 chunk * 4,
             src, ok);
    }
#pragma unroll
    for (int r = 0; r < C::kWL; ++r) {
      const int e = tid + r * C::kThreads;
      const int kr = e / (BN / 4), q = e % (BN / 4);
      const int n = n0 + 4 * q;
      const float* src = w + static_cast<size_t>(d0 + kr) * p.N + n;
      float* dst = bs + kr * BN + 4 * q;
      if (wvec) {
        copy16(dst, n < p.N ? src : w, n < p.N);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          copy4(dst + c, n + c < p.N ? src + c : w, n + c < p.N);
      }
    }
  };

  float acc[TM][TN], ps[TM][TN];  // sum of f(psum); the segment's psum
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ps[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load(s, s);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    if (t + kStages - 1 < T) load(t + kStages - 1, (t + kStages - 1) % kStages);
    copy_commit();

    const float* as = smem + (t % kStages) * C::kStageFloats;
    const float* bs = as + C::kAFloats;
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += kAK) {
      typename F::V a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const typename F::V*>(
            as + (ty + i * C::kNTY) * C::kAStride + k0);
#pragma unroll
      for (int k = 0; k < kAK; ++k) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (k0 + k) * BN + g * C::kSpan + tx * 4);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            ps[i][j] = fmaf(F::at(a[i], k), b[j], ps[i][j]);
      }
    }

    if ((t + 1) % kts != 0 && t + 1 != T) continue;
    // segment t / kts done: its gate, then f in registers, added in order;
    // f's id is a constant in each copy of this code (seg_end<kFn>).
    const auto seg_end = [&](auto fn_id) {
      constexpr int kFn = decltype(fn_id)::value;
      if constexpr (kGate) {
        const int s = t / kts;
        if (p.gate_kind == cadc::kGatePacked) {
          // Each lane's bits, a unit of kGroups nibbles per row i; a
          // transpose across the 8 lanes of its thread row leaves lane q
          // with row q's units from every lane: row q's words.
          constexpr int kU = 4 * C::kGroups;
          static_assert(TM == 8 && kU <= 8, "8 rows, one unit of <= 8 bits");
          uint64_t v = 0;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              if (cadc::dendritic_grad(kFn, ps[i][j]) != 0.f)
                v |= uint64_t{1} << (kU * i + j);
          v = transpose8<kU>(v, lane % 8);
          const int nw_all = (p.N + kPack - 1) / kPack;
          const int m = m0 + ty + (lane % 8) * C::kNTY;
          uint32_t* row = static_cast<uint32_t*>(p.gate) +
                          (static_cast<size_t>(s) * p.M + m) * nw_all;
          const int nw = n0 / kPack + tx / 8;  // group g: nw + g * kSpan/32
          if (m < p.M) {
            if constexpr (C::kGroups == 1) {
              if (nw < nw_all) row[nw] = static_cast<uint32_t>(v);
            } else {
              static_assert(C::kGroups == 2 && C::kSpan == kPack,
                            "two groups of adjacent words");
              const uint32_t w0 = pack_nibbles(v), w1 = pack_nibbles(v >> 4);
              if (nw + 1 < nw_all &&
                  reinterpret_cast<uintptr_t>(row + nw) % 8 == 0) {
                *reinterpret_cast<uint2*>(row + nw) = make_uint2(w0, w1);
              } else {
                if (nw < nw_all) row[nw] = w0;
                if (nw + 1 < nw_all) row[nw + 1] = w1;
              }
            }
          }
        } else {
          const size_t base = static_cast<size_t>(s) * p.M * p.N;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty + i * C::kNTY;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int n = n0 + (j / 4) * C::kSpan + tx * 4 + j % 4;
              if (m >= p.M || n >= p.N) continue;
              const float gv = cadc::dendritic_grad(kFn, ps[i][j]);
              const size_t at = base + static_cast<size_t>(m) * p.N + n;
              if (p.gate_kind == cadc::kGateU8)
                static_cast<uint8_t*>(p.gate)[at] = gv != 0.f;
              else
                static_cast<float*>(p.gate)[at] = gv;
            }
          }
        }
      }
      // acc + f(psum), rounded once (no contraction into an fma)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], cadc::dendritic(kFn, ps[i][j]));
          ps[i][j] = 0.f;
        }
    };
    switch (p.fn) {
      case 0: seg_end(std::integral_constant<int, 0>{}); break;
      case 1: seg_end(std::integral_constant<int, 1>{}); break;
      case 2: seg_end(std::integral_constant<int, 2>{}); break;
      case 3: seg_end(std::integral_constant<int, 3>{}); break;
      default: seg_end(std::integral_constant<int, 4>{}); break;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * C::kNTY;
    if (m >= p.M) continue;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      const int n = n0 + g * C::kSpan + tx * 4;
      float* dst = p.y + static_cast<size_t>(m) * p.N + n;
      if (wvec) {
        if (n < p.N)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < p.N) dst[c] = acc[i][4 * g + c];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int kAK, int kStages, bool kGate>
int launch_tap(const TapConv& p, cudaStream_t stream) {
  using C = TapCfg<BM, BN, TM, TN, kAK, kStages>;
  // The shared-memory opt-in is set once per device and instantiation.
  static std::atomic<uint64_t> opted_in{0};  // bit d: device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in.load() >> dev & 1)) {
    e = cudaFuncSetAttribute(
        tap_tile_kernel<BM, BN, TM, TN, kAK, kStages, kGate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in.fetch_or(uint64_t{1} << dev);
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, 1);
  tap_tile_kernel<BM, BN, TM, TN, kAK, kStages, kGate>
      <<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tap kernel's tiles (kernels/cadc_conv.py TAP_TILES), two 128-thread
// blocks an SM each: 128 x 64 with 8 x 8 micro-tiles and a 2-stage ring
// (53 KB), 64 x 64 with 8 x 4 and a 3-stage ring (52 KB).
template <bool kGate>
int tap_by_tile(const TapConv& p, int bm, int bn, cudaStream_t stream) {
  if (bm == 128 && bn == 64)
    return launch_tap<128, 64, 8, 8, 4, 2, kGate>(p, stream);
  if (bm == 64 && bn == 64)
    return launch_tap<64, 64, 8, 4, 2, 3, kGate>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3. x [B, H, W, Cin] and w [K1, K2, Cin, Cout] fp32, y [B, OH, OW, Cout]
// fp32. gate: NULL (gate_kind 0) or [S, B, OH, OW, ...] as gate_kind says
// (1: uint32 words of ceil(Cout/32); 2: uint8 per psum; 3: fp32 per psum).
// Plan: kernel 0 = the gather kernel (bm = bn = 64), 1 = the tap-aligned
// kernel with a bm x bn tile (Cin and xbar multiples of 32; x, w and y
// 16-byte aligned). Returns the CUDA error code after the launch (0 =
// success).
extern "C" int cadc_conv_launch(const void* x, const void* w, void* y,
                                void* gate, int B, int H, int W, int Cin,
                                int K1, int K2, int Cout, int OH, int OW,
                                int s1, int s2, int pt, int pl, int xbar,
                                int fn, int gate_kind, int kernel, int bm,
                                int bn, void* stream) {
  if (kernel == 0)
    return bm == 64 && bn == 64
               ? by_gate<float, float>(x, w, nullptr, y, gate, B, H, W, Cin,
                                       K1, K2, Cout, OH, OW, s1, s2, pt, pl,
                                       xbar, fn, gate_kind, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(y);
  if (kernel != 1 || Cin % kBK || xbar % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const TapConv p{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<float*>(y), gate, B * OH * OW, Cout,
                  K1 * K2 * Cin, xbar, H, W, Cin, K2, OH, OW, s1, s2, pt, pl,
                  fn, gate_kind};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate_kind == cadc::kGateNone) return tap_by_tile<false>(p, bm, bn, st);
  return tap_by_tile<true>(p, bm, bn, st);
}

// K5 (gate_kind 0) and its gate variant: x_q and w int8 in K3's layouts,
// scale one fp32 in device memory, y and gate as K3's (the gather kernel).
extern "C" int cadc_conv_q8_launch(const void* x, const void* w,
                                   const void* scale, void* y, void* gate,
                                   int B, int H, int W, int Cin, int K1,
                                   int K2, int Cout, int OH, int OW, int s1,
                                   int s2, int pt, int pl, int xbar, int fn,
                                   int gate_kind, void* stream) {
  return by_gate<int8_t, int>(x, w, scale, y, gate, B, H, W, Cin, K1, K2,
                              Cout, OH, OW, s1, s2, pt, pl, xbar, fn,
                              gate_kind, stream);
}

extern "C" const char* cadc_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
