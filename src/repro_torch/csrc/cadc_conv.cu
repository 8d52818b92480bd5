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
//    time. K5's plans that are not tap-aligned run on it too.
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
// [S, B, OH, OW, ceil(Cout/32)] from the dequantized psum. The products
// are exact and an int32 sum does not depend on the order of its terms,
// and every rounding after the dequantization is explicit (__fmul_rn,
// dendritic_rn, __fadd_rn in segment order, as cadc_tile.cuh's q8 branch),
// so every plan is bitwise the plain version. kernels/cadc_conv.py
// `plan_conv_q8` picks one of two kernels:
//
//  * the tap-aligned int8 kernel (`q8_tap_kernel` below) where Cin and
//    xbar are multiples of 32 (12 of VGG-16's 13 convs, 19 of ResNet-18's
//    20, the SNN's conv2), with x, the weights and y on 16 bytes. A k-tile
//    is 32 channels of one tap (64 where Cin and xbar are multiples of
//    64): 32 or 64 contiguous bytes of a pixel's row, brought in by 16-byte
//    cp.async (src-size 0 zero-fills the halo and the rows past M; stride
//    and padding come in by indexing) into a 3-stage ring in dynamic shared
//    memory; the tap and channel of the next k-tile step along with the
//    loads, with no division. mma's B operand is K-major, so the wrapper
//    passes the codes as [Cout, D] (one PyTorch copy of at most 2.4 MB a
//    conv), brought in the same way. Rows are padded to 48 or 80 bytes,
//    so the 8 rows of each ldmatrix land on distinct banks. Warps of
//    64 x 32 (128 x 64 tiles without a gate, 255 registers, two blocks an
//    SM) or 32 x 32 outputs run mma.sync m16n8k32 s8 x s8 -> s32 (the int8
//    tensor cores) into int32 accumulators holding the segment's psum; at
//    a segment's end (every xbar/32 k-steps) each psum is dequantized, f
//    applied (a copy of that code per fn) and added to an fp32 sum in
//    registers. The psums start at the bits of 1.5 * 2^23 (0x4B400000), so
//    the fp32 value of a psum |p| <= 2^22 (xbar <= 256: |p| <= 256 * 128 *
//    128) is one exact subtraction from those bits, which is
//    __int2float_rn's result (the conversion issues at 16 a clock per SM,
//    the subtraction at 128); at xbar > 256 the psums start at 0 and take
//    __int2float_rn. The loads and their barriers bound it, then the
//    segment epilogues (PERF.md, tools/profile_k5_variants.py). The packed
//    gate: a lane holds two columns of each n8 tile, so a 32-column word
//    is four n8 tiles of a quad of lanes, ORed by two shuffles and stored
//    by one lane; bytes and fp32 gates are stored directly.
//  * the gather kernel (`ConvGather` on cadc_tile.cuh's tile kernel, int32
//    multiply-adds on the CUDA cores) for the rest: the first convs (Cin 3,
//    the SNN's Cin 2), whose rows are not aligned.
//
// Bound on this card: 1 byte per input element and 4 per fp32 output make
// every VGG-16 conv at batch 128 bound by bytes at the data-sheet rates (a
// q8 eval batch: 0.054 ms of bytes against 80.2 G int8 operations, 0.04 ms
// at the int8 tensor-core peak). Each segment's psum also needs its
// epilogue on the CUDA cores (subtract, times scale, f, add: 0.63 G
// (pixel, channel, segment) triples a VGG-16 batch at xbar 64, roughly
// 0.06-0.17 ms at fp32 issue rates), a floor besides the bytes that
// neither int8 operands nor the tensor cores remove.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "cadc_tile.cuh"

namespace {

using cadc::kBK;
using cadc::kPack;
using cadc::kMagicBits;
using cadc::kMagicF;
using cadc::kThreads;
using cadc::ldsm4;
using cadc::mma_s8;

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
__device__ __forceinline__ void copy16(void* dst, const void* src,
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

// The dynamic shared-memory opt-in of a kernel, set once per device: `done`
// is the caller's (one per instantiation), bit d for device d. Returns the
// CUDA error code (0 = success).
template <typename Kernel>
int opt_in_smem(std::atomic<uint64_t>& done, Kernel kernel, int bytes) {
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

template <int BM, int BN, int TM, int TN, int kAK, int kStages, bool kGate>
int launch_tap(const TapConv& p, cudaStream_t stream) {
  using C = TapCfg<BM, BN, TM, TN, kAK, kStages>;
  static std::atomic<uint64_t> opted_in{0};
  if (const int e = opt_in_smem(
          opted_in, tap_tile_kernel<BM, BN, TM, TN, kAK, kStages, kGate>,
          C::kSmem))
    return e;
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

// ---------------------------------------------------------------------------
// the tap-aligned int8 kernel (K5's fast plan)
// ---------------------------------------------------------------------------

// The q8 conv a tap-aligned launch computes: x int8 NHWC codes, wt the HWIO
// codes as [N, D] int8 (a channel's D codes contiguous: mma's B operand is
// K-major), y fp32, scale one fp32 in device memory. x, wt and y lie on 16
// bytes; Cin and xbar are multiples of 32 x kKT.
struct TapConvQ8 {
  const int8_t* x;
  const int8_t* wt;
  const float* scale;
  float* y;
  void* gate;
  int M, N, D, xbar, H, W, Cin, K2, OH, OW, s1, s2, pt, pl, fn, gate_kind;
};

// A block of BM pixels x BN channels in warps of WM x WN outputs, each warp
// WM/16 x WN/8 mma tiles (m16 x n8); a ring of kStages k-tiles of kKT x 32
// bytes (channels of one tap inside one segment). A row of a k-tile is
// padded by 16 bytes: the 8 rows an ldmatrix reads then start 48 or 80
// bytes apart, on 8 distinct 16-byte bank groups.
template <int BM, int BN, int WM, int WN, int kKT, int kStages>
struct Q8Cfg {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;  // mma tiles of a warp
  static constexpr int kRow = 32 * kKT;      // bytes of a row in a k-tile
  static constexpr int kStride = kRow + 16;  // padded row in shared memory
  static constexpr int kChunks = kRow / 16;  // 16-byte copies a row
  static constexpr int kABytes = BM * kStride;
  static constexpr int kStageBytes = (BM + BN) * kStride;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kXL = (BM * kChunks + kThreads - 1) / kThreads;
  static constexpr int kWL = (BN * kChunks + kThreads - 1) / kThreads;
  // up to 255 registers a thread for 64-row warps, 192 for 32-row ones
  static constexpr int kMinBlocks =
      65536 / (kThreads * (WM == 64 ? 255 : 192));
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 &&
                    WN % kPack == 0,
                "whole mma tiles; a warp's columns are whole gate words");
  static_assert((kKT == 1 || kKT == 2) && kStages >= 2, "k-tile, ring");
  static_assert(kMinBlocks >= 1, "registers");
};

template <int BM, int BN, int WM, int WN, int kKT, int kStages, bool kGate>
__global__ void __launch_bounds__(
    (Q8Cfg<BM, BN, WM, WN, kKT, kStages>::kThreads),
    (Q8Cfg<BM, BN, WM, WN, kKT, kStages>::kMinBlocks))
q8_tap_kernel(const TapConvQ8 p) {
  using C = Q8Cfg<BM, BN, WM, WN, kKT, kStages>;
  extern __shared__ __align__(16) unsigned char smem8[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;  // an mma fragment's row, column pair
  const int wm0 = (warp / C::kWarpsN) * WM, wn0 = (warp % C::kWarpsN) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = p.D / C::kRow, kts = p.xbar / C::kRow;
  const int8_t* __restrict__ x = p.x;
  const int8_t* __restrict__ wt = p.wt;

  // The x copies of this thread: 16 bytes (chunk) of pixel rows
  // (tid + r * kThreads) / kChunks; pix = the pixel index of x[b, ih0, iw0].
  const int chunk = tid % C::kChunks;
  int ih0[C::kXL], iw0[C::kXL], pix[C::kXL];
#pragma unroll
  for (int r = 0; r < C::kXL; ++r) {
    const int m = m0 + (tid + r * C::kThreads) / C::kChunks;
    const int ow = m % p.OW, t = m / p.OW;
    const int oh = t % p.OH, b = t / p.OH;
    const int ih = oh * p.s1 - p.pt;
    iw0[r] = ow * p.s2 - p.pl;
    pix[r] = (b * p.H + ih) * p.W + iw0[r];
    ih0[r] = m < p.M ? ih : -(1 << 29);  // rows past M read as halo
  }

  // k-tile t (bytes kRow*t .. of D, inside one tap) into ring slot. Tiles
  // are loaded in order t = 0, 1, ..., so the tap (i, j) and the channel
  // c0 of this thread's chunk step along with them (no divisions).
  int i = 0, j = 0, c0 = chunk * 16;
  auto load = [&](int t, int slot) {
    unsigned char* as = smem8 + slot * C::kStageBytes;
    unsigned char* bs = as + C::kABytes;
    const int d0 = t * C::kRow;
    const int toff = i * p.W + j;
#pragma unroll
    for (int r = 0; r < C::kXL; ++r) {
      const int e = tid + r * C::kThreads;
      if (C::kXL * C::kThreads > BM * C::kChunks && e >= BM * C::kChunks)
        break;
      const bool ok = static_cast<unsigned>(ih0[r] + i) <
                          static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(iw0[r] + j) <
                          static_cast<unsigned>(p.W);
      const int8_t* src =
          ok ? x + static_cast<long long>(pix[r] + toff) * p.Cin + c0 : x;
      copy16(as + (e / C::kChunks) * C::kStride + chunk * 16, src, ok);
    }
#pragma unroll
    for (int r = 0; r < C::kWL; ++r) {
      const int e = tid + r * C::kThreads;
      if (C::kWL * C::kThreads > BN * C::kChunks && e >= BN * C::kChunks)
        break;
      const int n = n0 + e / C::kChunks;
      const int8_t* src =
          n < p.N ? wt + static_cast<size_t>(n) * p.D + d0 + chunk * 16 : wt;
      copy16(bs + (e / C::kChunks) * C::kStride + chunk * 16, src, n < p.N);
    }
    c0 += C::kRow;
    if (c0 >= p.Cin) {
      c0 -= p.Cin;
      if (++j == p.K2) {
        j = 0;
        ++i;
      }
    }
  };

  const bool magic = p.xbar <= cadc::kMagicMaxXbar;
  const int ps0 = magic ? kMagicBits : 0;
  int ps[C::kMT][C::kNT][4];      // the segment's psum (+ kMagicBits)
  float acc[C::kMT][C::kNT][4];   // the sum of f(psum * scale)
#pragma unroll
  for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ps[mi][ni][e] = ps0;
        acc[mi][ni][e] = 0.f;
      }
  const float sc = *p.scale;
  int s = 0, ks = 0;  // the segment, and the k-tile inside it

#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    if (r < T) load(r, r);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with t - 1
    if (t + kStages - 1 < T) load(t + kStages - 1, (t + kStages - 1) % kStages);
    copy_commit();

    const unsigned char* as = smem8 + (t % kStages) * C::kStageBytes;
    const unsigned char* bs = as + C::kABytes;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      // A: rows 0-15 x bytes 0-15 / 16-31 (a0 a1 / a2 a3); B: channels
      // 0-7 / 8-15 of a pair of n8 tiles x bytes 0-15 / 16-31.
      uint32_t a[C::kMT][4], b[C::kNT][2];
#pragma unroll
      for (int mi = 0; mi < C::kMT; ++mi)
        ldsm4(a[mi], as + (wm0 + mi * 16 + lane % 16) * C::kStride +
                         kk * 32 + (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < C::kNT / 2; ++np) {
        uint32_t r[4];
        ldsm4(r, bs + (wn0 + np * 16 + lane % 8 + (lane / 16) * 8) *
                          C::kStride +
                     kk * 32 + (lane / 8 % 2) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni)
          mma_s8(ps[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }

    if (++ks != kts && t + 1 != T) continue;
    // segment s done: v = float(psum) * scale, exactly as
    // __fmul_rn(__int2float_rn(p), scale); then its gate, f, the sum.
    float v[C::kMT][C::kNT][4];
    if (magic) {
#pragma unroll
      for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[mi][ni][e] = __fmul_rn(
                __fsub_rn(__int_as_float(ps[mi][ni][e]), kMagicF), sc);
    } else {
#pragma unroll
      for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[mi][ni][e] = __fmul_rn(__int2float_rn(ps[mi][ni][e]), sc);
    }
    // f's id is a constant in each copy of this code (seg_end<kFn>).
    const auto seg_end = [&](auto fn_id) {
      constexpr int kFn = decltype(fn_id)::value;
      if constexpr (kGate) {
        if (p.gate_kind == cadc::kGatePacked) {
          // Lane (g, q) holds columns 2q, 2q+1 of each n8 tile of rows g
          // and g+8: a word's 32 columns are 4 n8 tiles of the quad's lanes.
          const int nw_all = (p.N + kPack - 1) / kPack;
          uint32_t* words = static_cast<uint32_t*>(p.gate) +
                            static_cast<size_t>(s) * p.M * nw_all;
#pragma unroll
          for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + wm0 + mi * 16 + h * 8 + g;
#pragma unroll
              for (int wd = 0; wd < WN / kPack; ++wd) {
                uint32_t bits = 0;
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    if (cadc::dendritic_grad(
                            kFn, v[mi][4 * wd + u][2 * h + c]) != 0.f)
                      bits |= 1u << (8 * u + 2 * q + c);
                bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
                bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
                const int nw = (n0 + wn0) / kPack + wd;
                if (q == 0 && m < p.M && nw < nw_all)
                  words[static_cast<size_t>(m) * nw_all + nw] = bits;
              }
            }
        } else {
          const size_t base = static_cast<size_t>(s) * p.M * p.N;
#pragma unroll
          for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
            for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm0 + mi * 16 + (e / 2) * 8 + g;
                const int n = n0 + wn0 + ni * 8 + 2 * q + e % 2;
                if (m >= p.M || n >= p.N) continue;
                const float gv = cadc::dendritic_grad(kFn, v[mi][ni][e]);
                const size_t at = base + static_cast<size_t>(m) * p.N + n;
                if (p.gate_kind == cadc::kGateU8)
                  static_cast<uint8_t*>(p.gate)[at] = gv != 0.f;
                else
                  static_cast<float*>(p.gate)[at] = gv;
              }
        }
      }
#pragma unroll
      for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e],
                                       cadc::dendritic_rn(kFn, v[mi][ni][e]));
    };
    switch (p.fn) {
      case 0: seg_end(std::integral_constant<int, 0>{}); break;
      case 1: seg_end(std::integral_constant<int, 1>{}); break;
      case 2: seg_end(std::integral_constant<int, 2>{}); break;
      case 3: seg_end(std::integral_constant<int, 3>{}); break;
      default: seg_end(std::integral_constant<int, 4>{}); break;
    }
    // the next segment's psums start again (after seg_end: v is dead)
#pragma unroll
    for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[mi][ni][e] = ps0;
    ++s;
    ks = 0;
  }

  const bool vec = p.N % 2 == 0;  // then (m, n even) is on 8 bytes
#pragma unroll
  for (int mi = 0; mi < C::kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mi * 16 + h * 8 + g;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < C::kNT; ++ni) {
        const int n = n0 + wn0 + ni * 8 + 2 * q;
        float* dst = p.y + static_cast<size_t>(m) * p.N + n;
        const float lo = acc[mi][ni][2 * h], hi = acc[mi][ni][2 * h + 1];
        if (vec) {
          if (n < p.N) *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          if (n < p.N) dst[0] = lo;
          if (n + 1 < p.N) dst[1] = hi;
        }
      }
    }
}

template <int BM, int BN, int WM, int WN, int kKT, int kStages, bool kGate>
int launch_q8_tap(const TapConvQ8& p, cudaStream_t stream) {
  using C = Q8Cfg<BM, BN, WM, WN, kKT, kStages>;
  static std::atomic<uint64_t> opted_in{0};
  if (const int e = opt_in_smem(
          opted_in, q8_tap_kernel<BM, BN, WM, WN, kKT, kStages, kGate>,
          C::kSmem))
    return e;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, 1);
  q8_tap_kernel<BM, BN, WM, WN, kKT, kStages, kGate>
      <<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The int8 tap kernel's tiles (kernels/cadc_conv.py Q8_TAP_TILES), each
// with its warp tile: 128 x 64 (4 warps of 64 x 32; with a gate 8 of
// 32 x 32, as the gate's epilogue does not fit 255 registers beside 64 x 32
// psums and sums), 64 x 64 (4 of 32 x 32), 64 x 32 (2 of 32 x 32); a
// 3-stage ring. Measured on an H100 80GB HBM3 at 700 W (PERF.md): 32 x 32
// warps on 128 x 64 without a gate, 128 x 128 tiles, a 32 x 32 tile, and 4
// or 6 stages are slower or no faster.
template <int kKT, bool kGate>
int q8_tap_by_tile(const TapConvQ8& p, int bm, int bn, cudaStream_t stream) {
  if (bm == 128 && bn == 64)
    return launch_q8_tap<128, 64, kGate ? 32 : 64, 32, kKT, 3, kGate>(
        p, stream);
  if (bm == 64 && bn == 64)
    return launch_q8_tap<64, 64, 32, 32, kKT, 3, kGate>(p, stream);
  if (bm == 64 && bn == 32)
    return launch_q8_tap<64, 32, 32, 32, kKT, 3, kGate>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kGate>
int q8_tap_by_depth(const TapConvQ8& p, int bm, int bn, cudaStream_t stream) {
  if (p.Cin % 64 == 0 && p.xbar % 64 == 0)
    return q8_tap_by_tile<2, kGate>(p, bm, bn, stream);
  return q8_tap_by_tile<1, kGate>(p, bm, bn, stream);
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

// K5 (gate_kind 0) and its gate variant: x_q and w int8 in K3's layouts, wt
// the same codes as [Cout, D] (the tap kernel's B operand; NULL for the
// gather kernel), scale one fp32 in device memory, y and gate as K3's.
// Plan: kernel 0 = the gather kernel (bm = bn = 64), 1 = the tap-aligned
// int8 kernel with a bm x bn tile (Cin and xbar multiples of 32; x, wt and
// y 16-byte aligned). Returns the CUDA error code after the launch.
extern "C" int cadc_conv_q8_launch(const void* x, const void* w,
                                   const void* wt, const void* scale,
                                   void* y, void* gate, int B, int H, int W,
                                   int Cin, int K1, int K2, int Cout, int OH,
                                   int OW, int s1, int s2, int pt, int pl,
                                   int xbar, int fn, int gate_kind,
                                   int kernel, int bm, int bn, void* stream) {
  if (kernel == 0)
    return bm == 64 && bn == 64
               ? by_gate<int8_t, int>(x, w, scale, y, gate, B, H, W, Cin, K1,
                                      K2, Cout, OH, OW, s1, s2, pt, pl, xbar,
                                      fn, gate_kind, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(wt) |
                          reinterpret_cast<uintptr_t>(y);
  if (kernel != 1 || Cin % kBK || xbar % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const TapConvQ8 p{static_cast<const int8_t*>(x),
                    static_cast<const int8_t*>(wt),
                    static_cast<const float*>(scale),
                    static_cast<float*>(y),
                    gate, B * OH * OW, Cout, K1 * K2 * Cin, xbar, H, W, Cin,
                    K2, OH, OW, s1, s2, pt, pl, fn, gate_kind};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate_kind == cadc::kGateNone)
    return q8_tap_by_depth<false>(p, bm, bn, st);
  return q8_tap_by_depth<true>(p, bm, bn, st);
}

extern "C" const char* cadc_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
