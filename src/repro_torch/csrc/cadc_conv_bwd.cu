// K2 for the tap-aligned conv: the dgrad (dx) and wgrad (dw) kernels of the
// fp32 CADC conv backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cadc_matmul.py
// `_segmented_bwd` (bodies `_bwd_dx_kernel*` and `_bwd_dw_kernel*`) as
// src/repro/kernels/cadc_conv.py `_diff_conv_op.op_bwd` reaches them: over
// the im2col patches P [M, D] of x (M = B*OH*OW output pixels, D = K1*K2*Cin
// taps outer, channels fastest, cut into xbar-row segments s(d) = d / xbar)
// and gg_s = g ⊙ f'(p_s),
//
//     dpatch[m, d] = sum_n gg_{s(d)}[m, n] * w2d[d, n],   dx = col2im(dpatch)
//     dw[d, n]     = sum_m P[m, d] * gg_{s(d)}[m, n]
//
// Neither kernel builds patches, dpatches or a padded image: both read x
// [B, H, W, Cin], g [B, OH, OW, N] and w2d [D, N] where they lie, and K3's
// saved gate — packed uint32 words [S, M, ceil(N/32)], one byte or one
// fp32 per psum [S, M, N], or none (identity). They run where
// kernels/cadc_conv.py `plan_conv_bwd` says "tap": Cin and xbar multiples
// of 32 (so a 32-channel group of one tap lies in one segment), N a
// multiple of 4 and every operand 16-byte aligned (16-byte copies of g, w
// and x rows, and of an fp32 gate). The recompute gate stays on the
// patches route (K2 over im2col patches, then `_col2im`).
//
// Bound on this card: each kernel does the forward's 2*M*D*N flops (9.7
// GFLOP at ResNet-18's 64-channel stage-0 conv at batch 128: 0.14 ms of
// fp32 CUDA-core peak) on ~70 MB (0.02 ms of HBM): bound by operations.
// fp32 CUDA cores, no tensor cores: TF32 or bf16 operands would change the
// numerics the reference holds.
//
// Both are K3's tap-aligned implicit GEMM turned around: 32-deep k-tiles
// moved by 16-byte cp.async (src-size 0 zero-fills halos, dead taps and
// ragged edges) into a ring in dynamic shared memory, register micro-tiles
// of CUDA-core FMAs, no float atomics.
//
//  * dx (`dgrad_kernel`): a GEMM over input pixels (rows) x Cin (columns),
//    contracting over (tap, n). A pixel (h, w) is reached by tap (i, j)
//    from output pixel ((h + pt - i) / s1, (w + pl - j) / s2) where that
//    divides and lies in range. Pixels are grouped by (h + pt) mod s1 and
//    (w + pl) mod s2 (blockIdx.z), so a block's live taps are fixed —
//    i = (h + pt) mod s1 + s1*ii — and it visits only those: a stride-2
//    3x3 conv visits 4, 2, 2 or 1 taps a class instead of zero-filling 3
//    of 4 (pixel, tap) pairs; the 1x1 stride-2 projection's three dead
//    classes write zeros. A k-tile is 32 n of one live tap: g rows by
//    cp.async (zeros where the tap is dead for that pixel) and the gate
//    beside them (the packed word of a row copied once, by one lane of the
//    8 that copy the row), w2d rows [d, n0:n0+32] of the block's channels.
//    The gate multiplies g in shared memory, each thread over the chunks it
//    copied, before the barrier that publishes the tile. BN (64 or 32)
//    divides Cin and xbar, so a block's channels lie in one segment at every
//    tap. Each thread owns an 8 x 8 (128 x 64 tiles) or 8 x 4 micro-tile,
//    rows and columns strided by the thread rows and columns; A and B rows
//    are 36 floats apart, so both are read as 16-byte loads along n
//    without bank conflicts. `plan_conv_bwd` picks the tile by its work and
//    its longest block (a 4-tap class). Bitwise the patches route (K2's
//    dx, then `_col2im`): each tap's dot over n is one fmaf chain in
//    increasing n from 0 (zero-padded to whole k-tiles, as K2's),
//    and at the tap's end it is added into the pixel's sum with __fadd_rn,
//    taps in (i, j) order from an fp32 zero, as `_col2im`'s slice-adds —
//    two accumulators an output, as K3's psum and sum of f(psum).
//  * dw (`wgrad_kernel`): a GEMM over D rows (BM channels of one tap and
//    one segment) x N columns, contracting over M. A k-tile is 32 output
//    pixels: x rows of the block's tap straight from the image (K3's halo
//    zero-fill; each thread maps its one pixel with a multiply-shift
//    division), and g rows times the gate, applied in shared memory as in
//    dx; 8 x 8 micro-tiles on 64 x 128 tiles, 8 x 4 on 64 x 64, three
//    blocks an SM. M is split over blockIdx.z so that the grid fills a
//    wave of the card (9 64 x 64 tiles at stage 0); each split writes its
//    partial to a scratch [splits, D, N], and the last block of a tile to
//    arrive (the device's arrival counters and cadc_tile.cuh
//    `arrive_last`, the protocol of `ordered_segment_sum`) adds the
//    partials in split order from an fp32 zero, 16 bytes at a time, and
//    resets its counter: one launch, the same bits on every run.
#include <stdint.h>

#include <atomic>

#include "cadc_tile.cuh"

namespace {

using cadc::bit_f;
using cadc::copy16;
using cadc::copy4;
using cadc::copy_commit;
using cadc::copy_wait;
using cadc::kBK;
using cadc::kPack;
using cadc::opt_in;

// n / d for n < 2^31 by a multiply-high and a shift (PyTorch's IntDivider).
struct FastDiv {
  uint32_t d, mul, shift;
  static FastDiv of(uint32_t div) {
    FastDiv f{div, 0, 0};
    while (f.shift < 32 && (uint32_t{1} << f.shift) < div) ++f.shift;
    const uint64_t one = 1;
    f.mul = static_cast<uint32_t>(
        ((one << 32) * ((one << f.shift) - div)) / div + 1);
    return f;
  }
  __device__ __forceinline__ int div(int n) const {
    const uint32_t t = __umulhi(static_cast<uint32_t>(n), mul);
    return static_cast<int>((t + static_cast<uint32_t>(n)) >> shift);
  }
};

// The conv backward a launch computes (every pointer 16-byte aligned, Cin
// and xbar multiples of 32, N of 4).
struct ConvBwd {
  const float* g;     // [B, OH, OW, N]
  const float* x;     // [B, H, W, Cin]
  const float* w;     // [D, N]
  const void* gate;   // [S, Mo, ceil(N/32)] words, or [S, Mo, N] u8 / fp32
  float* dx;          // [B, H, W, Cin]
  float* dw;          // [D, N]
  float* scratch;     // [splits, D, N] when splits > 1
  int* counters;      // one per dw tile, zero between launches
  int B, H, W, Cin, K2, N, OH, OW, s1, s2, pt, pl, xbar, Mo, D;
  int rows_per_split;
  FastDiv by_ow, by_oh;
};

// Gate bytes staged per 16-byte chunk of g a thread copies: the packed
// word goes in once per row (kRowWord), a byte gate as 4 bytes, an fp32
// gate as 16.
template <int kKind>
struct GateStage {
  static constexpr bool kRowWord = kKind == cadc::kGatePacked;
  static constexpr int kChunkFloats =
      kKind == cadc::kGateF32 ? 4 : kKind == cadc::kGateU8 ? 1 : 0;
};

// v *= f'(p) for the 4 columns of a chunk: bits 0-3 of a shifted packed
// word, the 4 bytes of a uint32, or 4 fp32 (the product K2 forms).
template <int kKind>
__device__ __forceinline__ void gate4(float4& v, const float* slot,
                                      uint32_t word) {
  if constexpr (kKind == cadc::kGatePacked) {
    v.x *= bit_f(word, 0);
    v.y *= bit_f(word, 1);
    v.z *= bit_f(word, 2);
    v.w *= bit_f(word, 3);
  } else if constexpr (kKind == cadc::kGateU8) {
    const uint32_t b = *reinterpret_cast<const uint32_t*>(slot);
    v.x *= static_cast<float>(b & 0xffu);
    v.y *= static_cast<float>((b >> 8) & 0xffu);
    v.z *= static_cast<float>((b >> 16) & 0xffu);
    v.w *= static_cast<float>(b >> 24);
  } else if constexpr (kKind == cadc::kGateF32) {
    const float4 f = *reinterpret_cast<const float4*>(slot);
    v.x *= f.x;
    v.y *= f.y;
    v.z *= f.z;
    v.w *= f.w;
  }
}

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

// A block of BM input pixels (one stride class) x BN input channels;
// (BM/8) x (BN/TN) threads, each owning 8 rows (ty + i*kNTY) and TN
// columns (tx + j*kNTX). A warp holds 4 thread rows x 8 thread columns.
// Each thread copies 16 bytes (chunk q = tid % 8) of kXL g rows (tid/8 +
// r*kThreads/8) per k-tile.
template <int BM, int BN, int TN, int kStages, int kKind>
struct DxCfg {
  static constexpr int kNTY = BM / 8, kNTX = BN / TN;
  static constexpr int kThreads = kNTY * kNTX;
  static constexpr int kXL = BM * 8 / kThreads;  // g rows a thread
  static constexpr int kRow = kBK + 4;  // floats a row: 9 x 16 bytes
  static constexpr int kAFloats = BM * kRow, kBFloats = BN * kRow;
  using G = GateStage<kKind>;
  static constexpr int kGFloats =
      G::kRowWord ? BM : BM * 8 * G::kChunkFloats;
  static constexpr int kStageFloats = kAFloats + kBFloats + kGFloats;
  static constexpr int kWL = BN * 8 / kThreads;  // w copies a thread
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kStages * kStageFloats;
  static_assert(kNTY % 4 == 0 && kNTX % 8 == 0 && kXL <= 8,
                "warps of 4 x 8 threads; a row's word from one of 8 lanes");
  static_assert(kWL * kThreads == BN * 8 && kXL * kThreads == BM * 8,
                "copies split evenly");
};

template <int BM, int BN, int TN, int kStages, int kKind>
__global__ void __launch_bounds__((BM / 8) * (BN / TN),
                                  256 / ((BM / 8) * (BN / TN)))
dgrad_kernel(const ConvBwd p) {
  using C = DxCfg<BM, BN, TN, kStages, kKind>;
  constexpr int kXL = C::kXL, kRS = C::kThreads / 8;  // row stride
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWX = C::kNTX / 8;  // warps across the columns
  const int tx = (warp % kWX) * 8 + lane % 8;
  const int ty = (warp / kWX) * 4 + lane / 8;
  const int q = tid % 8;  // the chunk of n this thread copies

  // the block's stride class: pixels with (h + pt) % s1 == ph, (w + pl) %
  // s2 == pw; their first row / column, counts and live taps
  const int ph = blockIdx.z / p.s2, pw = blockIdx.z % p.s2;
  const int hf = ((ph - p.pt) % p.s1 + p.s1) % p.s1;
  const int wf = ((pw - p.pl) % p.s2 + p.s2) % p.s2;
  const int hc = hf < p.H ? (p.H - hf + p.s1 - 1) / p.s1 : 0;
  const int wc = wf < p.W ? (p.W - wf + p.s2 - 1) / p.s2 : 0;
  const int rows = p.B * hc * wc, r0 = blockIdx.x * BM;
  if (r0 >= rows) return;
  const int K1 = p.D / (p.K2 * p.Cin);
  const int ni = ph < K1 ? (K1 - ph + p.s1 - 1) / p.s1 : 0;
  const int nj = pw < p.K2 ? (p.K2 - pw + p.s2 - 1) / p.s2 : 0;
  const int KT = (p.N + kBK - 1) / kBK;  // k-tiles a tap
  const int T = ni * nj * KT;
  const int c0 = blockIdx.y * BN;
  const int nw_all = (p.N + kPack - 1) / kPack;
  const float* __restrict__ g = p.g;
  const float* __restrict__ w = p.w;

  // The g rows this thread copies: output pixel (oh0, ow0) reached by the
  // class's first live tap, and its index obase; tap (ii, jj) reaches
  // (oh0 - ii, ow0 - jj). Rows past the class read as dead.
  int oh0[kXL], ow0[kXL], obase[kXL];
#pragma unroll
  for (int r = 0; r < kXL; ++r) {
    const int rg = r0 + tid / 8 + r * kRS;
    const int b = rg / (hc * wc), rem = rg - b * (hc * wc);
    const int a = rem / wc;
    const int h = hf + p.s1 * a, wi = wf + p.s2 * (rem - a * wc);
    const int oh = (h + p.pt - ph) / p.s1, ow = (wi + p.pl - pw) / p.s2;
    oh0[r] = rg < rows ? oh : -(1 << 29);
    ow0[r] = ow;
    obase[r] = (b * p.OH + oh) * p.OW + ow;
  }
  // lane q < kXL of a row group also copies the packed word of its row q
  int woh0 = -(1 << 29), wow0 = 0, wobase = 0;
  if constexpr (kKind == cadc::kGatePacked) {
#pragma unroll
    for (int r = 0; r < kXL; ++r)
      if (r == q) {
        woh0 = oh0[r];
        wow0 = ow0[r];
        wobase = obase[r];
      }
  }

  // k-tile t (32 n of live tap t / KT) into ring slot
  auto load = [&](int t, int slot) {
    float* as = smem + slot * C::kStageFloats;
    float* bs = as + C::kAFloats;
    float* gs = bs + C::kBFloats;
    const int tt = t / KT, n0 = (t - tt * KT) * kBK;
    const int ii = tt / nj, jj = tt - ii * nj;
    const int tap = (ph + ii * p.s1) * p.K2 + pw + jj * p.s2;
    const int d0 = tap * p.Cin + c0;
    const size_t seg_rows = static_cast<size_t>(d0 / p.xbar) * p.Mo;
    const int n = n0 + 4 * q;
#pragma unroll
    for (int r = 0; r < kXL; ++r) {
      const int row = tid / 8 + r * kRS;
      const bool live = static_cast<unsigned>(oh0[r] - ii) <
                            static_cast<unsigned>(p.OH) &&
                        static_cast<unsigned>(ow0[r] - jj) <
                            static_cast<unsigned>(p.OW);
      const int o = obase[r] - ii * p.OW - jj;
      const bool ok = live && n < p.N;
      copy16(as + row * C::kRow + 4 * q,
             ok ? g + static_cast<size_t>(o) * p.N + n : g, ok);
      if constexpr (kKind == cadc::kGateU8) {
        copy4(gs + row * 8 + q,
              ok ? static_cast<const uint8_t*>(p.gate) +
                       (seg_rows + o) * p.N + n
                 : p.gate,
              ok);
      } else if constexpr (kKind == cadc::kGateF32) {
        copy16(gs + (row * 8 + q) * 4,
               ok ? static_cast<const float*>(p.gate) +
                        (seg_rows + o) * p.N + n
                  : p.gate,
               ok);
      }
    }
    if constexpr (kKind == cadc::kGatePacked) {
      if (q < kXL) {
        const bool live = static_cast<unsigned>(woh0 - ii) <
                              static_cast<unsigned>(p.OH) &&
                          static_cast<unsigned>(wow0 - jj) <
                              static_cast<unsigned>(p.OW);
        const int o = wobase - ii * p.OW - jj;
        copy4(gs + tid / 8 + q * kRS,
              live ? static_cast<const uint32_t*>(p.gate) +
                         (seg_rows + o) * nw_all + n0 / kPack
                   : p.gate,
              live);
      }
    }
#pragma unroll
    for (int e = 0; e < C::kWL; ++e) {
      const int idx = tid + e * C::kThreads;
      const int col = idx / 8, nn = n0 + 4 * (idx % 8);
      const bool ok = nn < p.N;
      copy16(bs + col * C::kRow + 4 * (idx % 8),
             ok ? w + static_cast<size_t>(d0 + col) * p.N + nn : w, ok);
    }
  };

  float acc[8][TN], ps[8][TN];  // the pixel's sum over taps; the tap's dot
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ps[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load(s, s);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<kStages - 2>();
    float* as = smem + (t % kStages) * C::kStageFloats;
    const float* bs = as + C::kAFloats;
    if constexpr (kKind != cadc::kGateNone) {
      // g ⊙ f'(p) over the chunks this thread copied; the packed words of
      // its rows were copied by the other lanes of its 8
      const float* gs = bs + C::kBFloats;
      if constexpr (kKind == cadc::kGatePacked) __syncwarp();
#pragma unroll
      for (int r = 0; r < kXL; ++r) {
        const int row = tid / 8 + r * kRS;
        float4* v = reinterpret_cast<float4*>(as + row * C::kRow + 4 * q);
        float4 val = *v;
        uint32_t word = 0;
        if constexpr (kKind == cadc::kGatePacked)
          word = reinterpret_cast<const uint32_t*>(gs)[row] >> (4 * q);
        gate4<kKind>(val, gs + (row * 8 + q) * C::G::kChunkFloats, word);
        *v = val;
      }
    }
    __syncthreads();  // tile t landed and gated; all are done with t - 1
    if (t + kStages - 1 < T)
      load(t + kStages - 1, (t + kStages - 1) % kStages);
    copy_commit();

#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + i * C::kNTY) * C::kRow + k0);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + (tx + j * C::kNTX) * C::kRow + k0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ps[i][j] = fmaf(a[i].x, b.x, ps[i][j]);
          ps[i][j] = fmaf(a[i].y, b.y, ps[i][j]);
          ps[i][j] = fmaf(a[i].z, b.z, ps[i][j]);
          ps[i][j] = fmaf(a[i].w, b.w, ps[i][j]);
        }
      }
    }
    if ((t + 1) % KT == 0) {  // the tap's dot is whole: add it, in order
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], ps[i][j]);
          ps[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rg = r0 + ty + i * C::kNTY;
    if (rg >= rows) continue;
    const int b = rg / (hc * wc), rem = rg - b * (hc * wc);
    const int a = rem / wc;
    const int h = hf + p.s1 * a, wi = wf + p.s2 * (rem - a * wc);
    float* dst = p.dx +
                 ((static_cast<size_t>(b) * p.H + h) * p.W + wi) * p.Cin +
                 c0 + tx;
#pragma unroll
    for (int j = 0; j < TN; ++j) dst[j * C::kNTX] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// A block of BM rows of D (channels c0 .. of one tap, in one segment) x BN
// columns of N, over the output pixels of split blockIdx.z; 128 threads,
// each owning TM = BM/8 rows (in groups of 4: r*32 + ty*4 + ..) and TN =
// BN/16 columns (in groups of 4: c*64 + tx*4 + ..): 8 x 8 micro-tiles at
// 64 x 128, 8 x 4 at 64 x 64. Each thread copies the k-tile's pixel tid / 4:
// chunks part + 4e (part = tid % 4) of its x row and of its g row, and the
// BN/32 packed words of its g row. Rows are BM + 16 and BN + 16 floats
// apart, so the 8 lanes of a quarter warp (two pixels, four parts) copy,
// gate and read distinct banks.
template <int BM, int BN, int kStages, int kKind>
struct DwCfg {
  static constexpr int kThreads = 128, TM = BM / 8, TN = BN / 16;
  static constexpr int kRowA = BM + 16, kRowB = BN + 16;
  static constexpr int kAFloats = kBK * kRowA, kBFloats = kBK * kRowB;
  static constexpr int kAL = BM / 16, kBL = BN / 16;  // copies a thread
  static constexpr int kWords = BN / kPack;           // packed words a row
  using G = GateStage<kKind>;
  static constexpr int kGFloats =
      G::kRowWord ? kWords * kThreads : kThreads * kBL * G::kChunkFloats;
  static constexpr int kStageFloats = kAFloats + kBFloats + kGFloats;
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kStages * kStageFloats;
  static_assert((BM == 64 || BM == 32) && (BN == 128 || BN == 64),
                "TM = 8 or 4, TN = 8 or 4");
};

// Three 128-thread blocks an SM: up to 168 registers a thread.
template <int BM, int BN, int kStages, int kKind>
__global__ void __launch_bounds__(128, 3)
wgrad_kernel(const ConvBwd p) {
  using C = DwCfg<BM, BN, kStages, kKind>;
  constexpr int TM = C::TM, TN = C::TN;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;
  const int n0 = blockIdx.x * BN, d0 = blockIdx.y * BM;
  const int tap = d0 / p.Cin, c0 = d0 - tap * p.Cin;
  const int i = tap / p.K2, j = tap - i * p.K2;
  const size_t seg_rows = static_cast<size_t>(d0 / p.xbar) * p.Mo;
  const int m_lo = blockIdx.z * p.rows_per_split;
  const int m_hi = min(p.Mo, m_lo + p.rows_per_split);
  const int T = (m_hi - m_lo + kBK - 1) / kBK;
  const int part = tid % 4;  // chunks part + 4e of this thread's rows
  const int nw_all = (p.N + kPack - 1) / kPack;
  const float* __restrict__ x = p.x;
  const float* __restrict__ g = p.g;

  auto load = [&](int t, int slot) {
    float* as = smem + slot * C::kStageFloats;
    float* bs = as + C::kAFloats;
    float* gs = bs + C::kBFloats;
    const int mr = tid / 4, m = m_lo + t * kBK + mr;
    const bool mok = m < m_hi;
    const int t1 = p.by_ow.div(m), ow = m - t1 * p.OW;
    const int b = p.by_oh.div(t1), oh = t1 - b * p.OH;
    const int ih = oh * p.s1 + i - p.pt, iw = ow * p.s2 + j - p.pl;
    const bool xok = mok &&
                     static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                     static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
    const float* xrow =
        x + ((static_cast<size_t>(b) * p.H + ih) * p.W + iw) * p.Cin + c0;
#pragma unroll
    for (int e = 0; e < C::kAL; ++e) {
      const int ch = 4 * (part + 4 * e);
      copy16(as + mr * C::kRowA + ch, xok ? xrow + ch : x, xok);
    }
    const float* grow = g + static_cast<size_t>(m) * p.N;
#pragma unroll
    for (int e = 0; e < C::kBL; ++e) {
      const int nl = 4 * (part + 4 * e), n = n0 + nl;
      const bool ok = mok && n < p.N;
      copy16(bs + mr * C::kRowB + nl, ok ? grow + n : g, ok);
      if constexpr (kKind == cadc::kGateU8)
        copy4(gs + tid * C::kBL + e,
              ok ? static_cast<const uint8_t*>(p.gate) +
                       (seg_rows + m) * p.N + n
                 : p.gate,
              ok);
      else if constexpr (kKind == cadc::kGateF32)
        copy16(gs + (tid * C::kBL + e) * 4,
               ok ? static_cast<const float*>(p.gate) +
                        (seg_rows + m) * p.N + n
                  : p.gate,
               ok);
    }
    if constexpr (kKind == cadc::kGatePacked) {
#pragma unroll
      for (int h = 0; h < C::kWords; ++h) {  // columns n0 + 32h ..
        const bool ok = mok && n0 + h * kPack < p.N;
        copy4(gs + tid * C::kWords + h,
              ok ? static_cast<const uint32_t*>(p.gate) +
                       (seg_rows + m) * nw_all + n0 / kPack + h
                 : p.gate,
              ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load(s, s);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<kStages - 2>();
    const float* as = smem + (t % kStages) * C::kStageFloats;
    float* bs = const_cast<float*>(as) + C::kAFloats;
    if constexpr (kKind != cadc::kGateNone) {
      // g ⊙ f'(p) over the chunks this thread copied
      const float* gs = bs + C::kBFloats;
#pragma unroll
      for (int e = 0; e < C::kBL; ++e) {
        const int nl = 4 * (part + 4 * e);
        float4* v = reinterpret_cast<float4*>(bs + (tid / 4) * C::kRowB + nl);
        float4 val = *v;
        uint32_t word = 0;
        if constexpr (kKind == cadc::kGatePacked)
          word = reinterpret_cast<const uint32_t*>(
                     gs)[tid * C::kWords + nl / kPack] >>
                 (nl % kPack);
        gate4<kKind>(val, gs + (tid * C::kBL + e) * C::G::kChunkFloats,
                     word);
        *v = val;
      }
    }
    __syncthreads();  // tile t landed and gated; all are done with t - 1
    if (t + kStages - 1 < T)
      load(t + kStages - 1, (t + kStages - 1) % kStages);
    copy_commit();

#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float bv[TN];
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + k * C::kRowB + c * 64 + tx * 4);
        bv[4 * c] = b.x;
        bv[4 * c + 1] = b.y;
        bv[4 * c + 2] = b.z;
        bv[4 * c + 3] = b.w;
      }
#pragma unroll
      for (int gr = 0; gr < TM / 4; ++gr) {
        const float4 a = *reinterpret_cast<const float4*>(
            as + k * C::kRowA + gr * 32 + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[gr * 4 + r][c] = fmaf(av[r], bv[c], acc[gr * 4 + r][c]);
      }
    }
  }

  const bool split = gridDim.z > 1;
  float* out = split ? p.scratch + static_cast<size_t>(blockIdx.z) * p.D * p.N
                     : p.dw;
#pragma unroll
  for (int c = 0; c < TN / 4; ++c) {
    const int n = n0 + c * 64 + tx * 4;
    if (n >= p.N) continue;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int d = d0 + (r / 4) * 32 + ty * 4 + r % 4;
      *reinterpret_cast<float4*>(out + static_cast<size_t>(d) * p.N + n) =
          make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                      acc[r][4 * c + 3]);
    }
  }
  if (!split ||
      !cadc::arrive_last(p.counters + blockIdx.y * gridDim.x + blockIdx.x,
                         gridDim.z))
    return;
  // the last block of the tile: the splits' partials added in split order
  // from an fp32 zero, 16 bytes at a time, two splits in flight, 8 float4s
  // a thread at once
  constexpr int kV = 8;
  const size_t dn = static_cast<size_t>(p.D) * p.N;
  const auto add = [](float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  };
  const int S = gridDim.z;
#pragma unroll 1
  for (int e0 = 0; e0 < BM * BN / 4; e0 += kV * C::kThreads) {
    size_t at[kV];
    bool ok[kV];
    float4 sum[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int e = e0 + tid + v * C::kThreads;
      const int nn = n0 + 4 * (e % (BN / 4));
      ok[v] = e < BM * BN / 4 && nn < p.N;
      at[v] = static_cast<size_t>(d0 + e / (BN / 4)) * p.N + nn;
      sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int z = 0; z < S; z += 2) {
      float4 v0[kV], v1[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float* src = p.scratch + z * dn + at[v];
        v0[v] = ok[v] ? __ldcg(reinterpret_cast<const float4*>(src))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        v1[v] = ok[v] && z + 1 < S
                    ? __ldcg(reinterpret_cast<const float4*>(src + dn))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        add(sum[v], v0[v]);
        if (z + 1 < S) add(sum[v], v1[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (ok[v]) *reinterpret_cast<float4*>(p.dw + at[v]) = sum[v];
  }
  if (tid == 0) p.counters[blockIdx.y * gridDim.x + blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int BM, int BN, int TN, int kKind>
int launch_dx(const ConvBwd& p, cudaStream_t stream) {
  constexpr int kStages = 2;
  using C = DxCfg<BM, BN, TN, kStages, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = dgrad_kernel<BM, BN, TN, kStages, kKind>;
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const long long rows = static_cast<long long>(p.B) *
                         ((p.H + p.s1 - 1) / p.s1) * ((p.W + p.s2 - 1) / p.s2);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), p.Cin / BN,
                  p.s1 * p.s2);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int kKind>
int launch_dw(const ConvBwd& p, int splits, cudaStream_t stream) {
  constexpr int kStages = BN == 128 ? 2 : 3;  // three blocks an SM
  using C = DwCfg<BM, BN, kStages, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = wgrad_kernel<BM, BN, kStages, kKind>;
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const dim3 grid((p.N + BN - 1) / BN, p.D / BM, splits);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The plan's tiles (kernels/cadc_conv.py DX_TILES, DW_TILES): dx 128 x 64
// with 8 x 8 micro-tiles, the others 8 x 4, 128 threads but at 64 x 32; dw
// 8 x 8 at 64 x 128, 8 x 4 at 64 x 64, 4 x 8 and 4 x 4 at 32 rows.
template <int kKind>
int by_tile(const ConvBwd& p, int dx_bm, int dx_bn, int dw_bm, int dw_bn,
            int splits, cudaStream_t st) {
  if (p.dx != nullptr) {
    int e = static_cast<int>(cudaErrorInvalidValue);
    if (dx_bm == 128 && dx_bn == 64) e = launch_dx<128, 64, 8, kKind>(p, st);
    if (dx_bm == 64 && dx_bn == 64) e = launch_dx<64, 64, 4, kKind>(p, st);
    if (dx_bm == 128 && dx_bn == 32) e = launch_dx<128, 32, 4, kKind>(p, st);
    if (dx_bm == 64 && dx_bn == 32) e = launch_dx<64, 32, 4, kKind>(p, st);
    if (e) return e;
  }
  if (p.dw != nullptr) {
    if (dw_bm == 64 && dw_bn == 128)
      return launch_dw<64, 128, kKind>(p, splits, st);
    if (dw_bm == 64 && dw_bn == 64)
      return launch_dw<64, 64, kKind>(p, splits, st);
    if (dw_bm == 32 && dw_bn == 128)
      return launch_dw<32, 128, kKind>(p, splits, st);
    if (dw_bm == 32 && dw_bn == 64)
      return launch_dw<32, 64, kKind>(p, splits, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// The tap-aligned conv backward. g [B, OH, OW, Cout], x [B, H, W, Cin],
// w [K1, K2, Cin, Cout] fp32; gate: NULL (gate_kind 0) or K3's [S, B, OH,
// OW, ...] (1: uint32 words of ceil(Cout/32); 2: uint8 per psum; 3: fp32 per
// psum). dx [B, H, W, Cin] and dw [K1, K2, Cin, Cout] fp32, either NULL (not
// wanted). Plan: dx tile dx_bm x dx_bn (128 or 64 pixels x 64 or 32
// channels, dx_bn dividing Cin and xbar); dw tile dw_bm x dw_bn (64 or 32
// rows of D dividing Cin and xbar, 128 or 64 columns), M split into
// `splits` ranges of rows_per_split output pixels; with splits > 1, scratch
// is fp32 [splits, D, Cout] and counters int32 zeros, one per dw tile.
// Returns the CUDA error code after the launches (0 = success).
extern "C" int cadc_conv_bwd_launch(
    const void* g, const void* x, const void* w, const void* gate, void* dx,
    void* dw, void* scratch, void* counters, int B, int H, int W, int Cin,
    int K1, int K2, int Cout, int OH, int OW, int s1, int s2, int pt, int pl,
    int xbar, int gate_kind, int dx_bm, int dx_bn, int dw_bm, int dw_bn,
    int splits, int rows_per_split, void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(x) |
      reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(gate) |
      reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dw) |
      reinterpret_cast<uintptr_t>(scratch);
  if (Cin % kBK || xbar % kBK || Cout % 4 || splits < 1 ||
      (dw != nullptr && splits > 1 &&
       (scratch == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const ConvBwd p{static_cast<const float*>(g),
                  static_cast<const float*>(x),
                  static_cast<const float*>(w),
                  gate,
                  static_cast<float*>(dx),
                  static_cast<float*>(dw),
                  static_cast<float*>(scratch),
                  static_cast<int*>(counters),
                  B, H, W, Cin, K2, Cout, OH, OW, s1, s2, pt, pl, xbar,
                  B * OH * OW, K1 * K2 * Cin, rows_per_split,
                  FastDiv::of(static_cast<uint32_t>(OW)),
                  FastDiv::of(static_cast<uint32_t>(OH))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gate_kind) {
    case cadc::kGateNone:
      return by_tile<cadc::kGateNone>(p, dx_bm, dx_bn, dw_bm, dw_bn, splits,
                                      st);
    case cadc::kGatePacked:
      return by_tile<cadc::kGatePacked>(p, dx_bm, dx_bn, dw_bm, dw_bn, splits,
                                        st);
    case cadc::kGateU8:
      return by_tile<cadc::kGateU8>(p, dx_bm, dx_bn, dw_bm, dw_bn, splits,
                                    st);
    case cadc::kGateF32:
      return by_tile<cadc::kGateF32>(p, dx_bm, dx_bn, dw_bm, dw_bn, splits,
                                     st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cadc_conv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
