// K2 over matrices: the segmented backward of the CADC matmul, for Hopper
// (sm_90a).
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
// (save_gate="recompute": no residual) as f'(scale * (x_s @ w_s)) in fp32,
// summed in the same order as the forward kernels, so the recomputed gate is
// bitwise the forward's. scale, one fp32 in device memory, is 1 on the
// float path and the q8 path's dequantization factor.
//
// Bound on this card: where the matrix form runs on a train step — the
// stems' im2col patches (ResNet-18 and VGG-16: M = 131072, D = 27, N = 64),
// LeNet-5's convs and the FC layers — each of dx and dw moves far more
// bytes than it does multiply-adds per byte: at the ResNet-18 stem dw reads
// g (33.5 MB), the patches (14.2 MB) and the packed gate (1 MB) for 0.23
// G multiply-adds, 0.015 ms of HBM against 0.007 of fp32 CUDA-core peak:
// bound by bytes. The FC layers (M <= 128) are bound by latency.
//
// Design. The tiles and splits come from the shapes (kernels/cadc_matmul.py
// `plan_bwd`), so a 27-wide segment takes a 32-wide tile, not a 64-wide
// one. Operands move by cp.async into a ring in dynamic shared memory (16
// bytes where rows allow: N a multiple of 4 for g, w and an fp32 gate, D
// and xbar of 4 for x; else 4 bytes an element, a warp along a row). The
// gate multiplies g in shared memory, each thread over the chunks of 4
// columns it copied, before the barrier that publishes the k-tile; a
// packed word is copied once per (row, 32 columns), by the lane that
// copies the word's first chunk, and read by the lanes of its warp.
//  * dx (`bwd_dx_kernel`): tiles of BM (128 or 32) rows of M x CW (32 or
//    64) columns of one segment, contracting over N in 32-deep k-tiles of
//    g ⊙ f' and of w's segment rows. About two blocks an SM, each taking
//    every gridDim.x-th row tile of its column tile, the k-tiles of all of
//    them one stream through the ring. Each thread owns TM x 4 outputs
//    (rows strided by the thread rows, columns by the thread columns);
//    rows of A and B are 36 floats apart and read as float4 along n. Every
//    output is one fmaf chain over n = 0 .. N-1 in increasing order from
//    +0 (zero-padded to whole k-tiles), whatever the tile: bitwise the same
//    under every plan and bitwise the tap dgrad's per-tap dot
//    (csrc/cadc_conv_bwd.cu).
//  * dw (`bwd_dw_kernel`): a block owns RW (32 or 64) rows of D in one
//    segment and NW (16, 32 or 64) columns of N and contracts over the M
//    rows of its split in 64-row k-tiles. Its 256 threads form kG groups,
//    each thread an 8 x 4 micro-tile; group i takes rows i, i + kG, ... of
//    each k-tile, and at the end the groups' sums are added in group order
//    through shared memory. Where one segment spans D (the stems), a
//    k-tile's x rows are one contiguous run of 64 * D floats, copied 16
//    bytes at a time. With several splits each block writes its partial
//    tile to scratch [splits, tiles, RW * NW]; the last block of a tile to
//    arrive (cadc_tile.cuh `arrive_last` on the device's arrival counters)
//    adds the partials in split order from an fp32 zero, writes dw and
//    resets the counter: one launch, the same bits on every run of a plan.
//    That last block's sum takes about a microsecond a batch of 16 splits,
//    so narrow tiles (more tiles, fewer splits each) keep it short; the
//    planner weighs it against the main loop's time.
//  * recompute (on no main path): the psums a tile needs are recomputed
//    (an xbar-deep product of its x rows and w columns, the forward's
//    order) and f'(psum) kept in shared memory. dx
//    (`bwd_dx_recompute_kernel`): 64x64 tiles with 4x4 register
//    micro-tiles staging 32-deep slices, the same fmaf chains as above.
//    dw (`bwd_dw_recompute_kernel`): dw's kernel body with that gate, under
//    the saved gates' plan: bitwise their dw.
//
// bf16 operands (the LM train steps' K2) under a gate of 0s and 1s (relu's
// packed words or bytes; none for identity) run the tensor-core kernels,
// `bf16_bwd_dx_kernel` and `bf16_bwd_dw_kernel` (`cadc_bwd_mma_launch`;
// plan kernel "mma"), which replace the TPU bodies `_bwd_dx_kernel` :251,
// `_bwd_dx_kernel_nomask` :271, `_bwd_dw_kernel` :312 and
// `_bwd_dw_kernel_nomask` :332 of src/repro/kernels/cadc_matmul.py, which
// widen their bf16 operands to fp32 in the body. g ⊙ f' is then bf16
// exactly, so the operands go to the tensor cores as they are: no fp32
// copies (the CUDA-core kernels above ran the LM shapes on fp32 copies made
// by the autograd Function, ~18 TFLOP/s at gemma3-1b's w_gate). The
// fp32-gate fns and the recompute gate stay on those kernels (their g ⊙ f'
// is no bf16 value).
//
// Bound on this card: at a train micro (M = 2048) by operations, 4 M D N
// at the bf16 tensor-core peak (gemma3-1b's w_gate, 72.5 GFLOP: 0.073 ms;
// its bytes, 106 MB, 0.032 ms).
//
// Design. Both are one R x 128 output tile a block, 8 warps (2 x 4, each
// R/2 x 32: R/32 x 4 tiles of m16n8), walking their contraction in 64-deep
// slices through a 4-stage ring in dynamic shared memory (16-byte cp.async,
// zero-filled past the edges; rows padded by 16 bytes against bank
// conflicts; 2-byte loads through registers where rows are off 16 bytes,
// as the sLSTM's N = 2730), mma.sync m16n8k16.row.col.f32.bf16.bf16.f32.
//  * dx: R (128 or 64) rows of M x 128 columns of one segment, over N. A =
//    g ⊙ f' (k-contiguous: ldmatrix.x4); B = w's segment rows, already
//    mma's "col" operand as w [D, N] lies (ldmatrix.x4, no transpose).
//  * dw: 128 rows of one segment x 128 columns of N, over the M rows of its
//    split. A = x_sᵀ and B = g ⊙ f', both k-major: ldmatrix.x4.trans. Where
//    its tiles are few M is split in whole slices: each block writes its
//    fp32 partial tile to scratch, the tile's last block to arrive
//    (cadc_tile.cuh arrive_last, the device's arrival counters) adds them
//    in split order from an fp32 zero, writes dw and resets the counter:
//    one launch, the same bits on every run of a plan.
//  * The gate multiplies g in shared memory: each thread ANDs the chunks
//    it copied (8 bf16 a chunk, a 0xffff half per set bit) after its own
//    cp.async wait and before the barrier that publishes the slice — the
//    packed word copied by the lane that copies its first chunk, read by
//    its warp's next three lanes; a chunk's 8 gate bytes by its own lane.
//    Once a block (a thread's few chunks) rather than once a warp that
//    reads the fragment: applied to the fragments in registers instead (a
//    copy tools/profile_k2_matrix.py --set gate builds) it measured slower
//    at w_gate (M 2048, D 1280, N 6912; H100 80GB HBM3, 700 W): packed dx
//    0.42 ms against 0.35, dw 0.29-0.30 both; bytes dx 0.63 against 0.34,
//    dw 0.40 against 0.26.
//  * Each slice's four k16 steps build a fresh fp32 partial, added into
//    the tile's sums with __fadd_rn: each output is one chain of slices in
//    increasing k from 0 whatever the tile, so dx is bitwise the same under
//    every plan. mma.sync's fp32 accumulation is not specified as
//    round-to-nearest (earlier tensor cores were measured to truncate);
//    the slice partials keep any such bias to four k16 steps before a
//    round-to-nearest add, over contractions up to 152 064 deep
//    (qwen2-moe-a2.7b's head). The second fragment set needs the
//    registers of one block an SM (238-255 at 128 rows, no spills).
//  * dx and dw are written in fp32, and the autograd Function rounds them
//    to the operands' dtype, as it did the CUDA-core kernels' (the same
//    bits as one rounding of the fp32 sums in the kernel; the kernel is
//    held to its plain version in fp32, at 1e-4 of scale).
// The planner (kernels/cadc_matmul.py plan_bwd with dtype=bf16) picks dx's
// row tile and dw's splits from a model fitted to tools/profile_k2_matrix.py
// --set lm. At gemma3-1b's shapes (M 2048, crossbar 256; waves = blocks
// over 132 SMs, one an SM): wq dx 64 rows, 320 blocks (2.42 waves), dw 3
// splits, 240 (1.82); wk and wv dx 320 (2.42), dw 4 splits, 80 (0.61); wo
// dx 128 rows, 128 (0.97), dw 3 splits, 216 (1.64); w_gate and w_up dx 64
// rows, 320 (2.42), dw unsplit, 540 (4.09); w_down dx 128 rows, 864
// (6.55), dw unsplit, 486 (3.68). Measured there (PERF.md;
// tools/profile_k2_matrix.py --set lm): w_gate 0.66 ms (dx 0.35, dw 0.30:
// 110 TFLOP/s) against 4.09 for the CUDA-core route on fp32 copies and
// 0.10 for the bf16 torch.matmul pair; w_down 0.48 (136 TFLOP/s).
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
using cadc::kThreads;
using cadc::opt_in;

// The backward a launch computes.
struct Bwd {
  const float* g;      // [M, N]
  const float* x;      // [M, D]
  const float* w;      // [D, N]
  const void* gate;    // [S, M, ceil(N/32)] words, [S, M, N] u8 / fp32
  const float* scale;  // recompute's psum factor in device memory, or null
  float* dx;           // [M, D], or null
  float* dw;           // [D, N], or null
  float* scratch;      // [splits, dw tiles, dw tile] when splits > 1
  int* counters;       // one per dw tile, zero between launches
  int M, N, D, xbar, fn, rows_per_split;
  bool vec_n;  // g, w (and an fp32 gate) rows by 16-byte copies
  bool vec_d;  // x rows by 16-byte copies
  bool one_seg;  // one segment spans D and x lies on 16 bytes
};

// ---------------------------------------------------------------------------
// staging g ⊙ f'(p)
// ---------------------------------------------------------------------------

// Shared-memory floats of a chunk's gate slot: 4 bytes (a byte gate's 4
// columns) or 16 (an fp32 gate's); the packed word has its own slot a row.
template <int kKind>
constexpr int kSlotFloats =
    kKind == cadc::kGateF32 ? 4 : kKind == cadc::kGateU8 ? 1 : 0;

// Columns n .. n+3 of g's row m to dst (zeros past N and where !ok), and
// of a byte or fp32 gate of segment s to its slot. A byte gate off 4 bytes
// (N not a multiple of 4) is read when the chunk is gated instead.
template <int kKind>
__device__ __forceinline__ void copy_g_chunk(const Bwd& p, float* dst,
                                             float* slot, int s, int m,
                                             int n, bool ok) {
  const size_t row = static_cast<size_t>(m) * p.N;
  const size_t grow = (static_cast<size_t>(s) * p.M + m) * p.N;
  if (p.vec_n) {
    const bool in = ok && n < p.N;
    copy16(dst, in ? p.g + row + n : p.g, in);
    if constexpr (kKind == cadc::kGateU8)
      copy4(slot, in ? static_cast<const uint8_t*>(p.gate) + grow + n : p.gate,
            in);
    else if constexpr (kKind == cadc::kGateF32)
      copy16(slot, in ? static_cast<const float*>(p.gate) + grow + n : p.gate,
             in);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = ok && n + i < p.N;
    copy4(dst + i, in ? p.g + row + n + i : p.g, in);
    if constexpr (kKind == cadc::kGateF32)
      copy4(slot + i,
            in ? static_cast<const float*>(p.gate) + grow + n + i : p.gate,
            in);
  }
}

// The packed word of columns 32 * (n / 32) .. of segment s's row m.
__device__ __forceinline__ void copy_word(const Bwd& p, uint32_t* dst, int s,
                                          int m, int n, bool ok) {
  const int nw = (p.N + kPack - 1) / kPack;
  const bool in = ok && n < p.N;
  copy4(dst,
        in ? static_cast<const uint32_t*>(p.gate) +
                 (static_cast<size_t>(s) * p.M + m) * nw + n / kPack
           : p.gate,
        in);
}

// v *= f'(p) over the chunk at v (columns n .. n+3 of row m): bits 0-3 of
// `word` (the packed word shifted to column n), the slot's 4 bytes or 4
// fp32, or the 4 recomputed f' at `slot` — the product K2's plain version
// forms, rounded once.
template <int kKind>
__device__ __forceinline__ void gate_chunk(const Bwd& p, float* v,
                                           const float* slot, uint32_t word,
                                           int s, int m, int n, bool ok) {
  float4 a = *reinterpret_cast<float4*>(v);
  if constexpr (kKind == cadc::kGatePacked) {
    a.x *= bit_f(word, 0);
    a.y *= bit_f(word, 1);
    a.z *= bit_f(word, 2);
    a.w *= bit_f(word, 3);
  } else if constexpr (kKind == cadc::kGateU8) {
    uint32_t b = 0;
    if (p.vec_n) {
      b = *reinterpret_cast<const uint32_t*>(slot);
    } else {
      const uint8_t* gb = static_cast<const uint8_t*>(p.gate) +
                          (static_cast<size_t>(s) * p.M + m) * p.N + n;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok && n + i < p.N) b |= static_cast<uint32_t>(gb[i]) << (8 * i);
    }
    a.x *= static_cast<float>(b & 0xffu);
    a.y *= static_cast<float>((b >> 8) & 0xffu);
    a.z *= static_cast<float>((b >> 16) & 0xffu);
    a.w *= static_cast<float>(b >> 24);
  } else if constexpr (kKind == cadc::kGateF32) {
    const float4 f = *reinterpret_cast<const float4*>(slot);
    a.x *= f.x;
    a.y *= f.y;
    a.z *= f.z;
    a.w *= f.w;
  } else if constexpr (kKind == cadc::kGateRecompute) {
    a.x *= slot[0];
    a.y *= slot[1];
    a.z *= slot[2];
    a.w *= slot[3];
  }
  *reinterpret_cast<float4*>(v) = a;
}

// A [R][C] tile (rows lds floats apart in shared memory) of a row-major
// matrix (rows ld floats apart): rows r0 + r where r0 + r < rows, columns
// c0 + c where c0 + c < cols, zeros elsewhere. 16 bytes a copy where `vec`
// (base, ld and c0 on 16 bytes); else 4 bytes, a warp copying a row's
// consecutive elements.
template <int R, int C>
__device__ __forceinline__ void copy_tile(float* dst, int lds,
                                          const float* base, int ld, int r0,
                                          int rows, int c0, int cols,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < (R * C / 4 + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (R * C / 4 % kThreads && e >= R * C / 4) break;
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      const bool ok = r0 + r < rows && c0 + c < cols;
      copy16(dst + r * lds + c,
             ok ? base + static_cast<size_t>(r0 + r) * ld + c0 + c : base,
             ok);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < (R * C + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (R * C % kThreads && e >= R * C) break;
    const int r = e / C, c = e % C;
    const bool ok = r0 + r < rows && c0 + c < cols;
    copy4(dst + r * lds + c,
          ok ? base + static_cast<size_t>(r0 + r) * ld + c0 + c : base, ok);
  }
}

// The last block of dw tile `tile` to arrive adds the splits' partials
// (scratch [splits, tiles, kT]) in split order from an fp32 zero: each
// thread adds kV consecutive elements, 8 bytes a load, with kIF splits'
// loads (at most 16, at most 64 floats) in flight at a time;
// partial element e is dw[d0 + e / kCols, n0 + e % kCols], written where
// d < d_end and inside N. Resets the tile's counter.
template <int kT, int kCols>
__device__ __forceinline__ void add_splits(const Bwd& p, int tile, int d0,
                                           int d_end, int n0) {
  constexpr int kV = kT / kThreads;  // 2, 4, 8 or 16 floats a thread
  constexpr int kIF = 64 / kV < 16 ? 64 / kV : 16;
  static_assert(kV * kThreads == kT && kV % 2 == 0, "whole float2s");
  const int S = gridDim.z;
  if (!cadc::arrive_last(p.counters + tile, S)) return;
  const size_t stride = static_cast<size_t>(gridDim.x) * gridDim.y * kT;
  const float* src =
      p.scratch + static_cast<size_t>(tile) * kT + threadIdx.x * kV;
  float sum[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) sum[i] = 0.f;
  for (int z0 = 0; z0 < S; z0 += kIF) {
    float2 v[kIF][kV / 2];
#pragma unroll
    for (int j = 0; j < kIF; ++j)
#pragma unroll
      for (int i = 0; i < kV / 2; ++i)
        v[j][i] = z0 + j < S ? __ldcg(reinterpret_cast<const float2*>(
                                   src + (z0 + j) * stride) + i)
                             : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kIF; ++j) {
      if (z0 + j >= S) break;
#pragma unroll
      for (int i = 0; i < kV / 2; ++i) {
        sum[2 * i] += v[j][i].x;
        sum[2 * i + 1] += v[j][i].y;
      }
    }
  }
  const int e = threadIdx.x * kV;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int d = d0 + (e + i) / kCols, n = n0 + (e + i) % kCols;
    if (d < d_end && n < p.N) p.dw[static_cast<size_t>(d) * p.N + n] = sum[i];
  }
  if (threadIdx.x == 0) p.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// recompute
// ---------------------------------------------------------------------------

// Shared-memory floats of recompute_gate<R, C>, and where its gate starts.
template <int R, int C>
struct RecomputeLayout {
  static constexpr int kGateAt = kBK * (R + 1) + kBK * C;
  static constexpr int kFloats = kGateAt + R * (C + 1);
};

// gs[r][c] (row stride C + 1) = f'(p * sc) with p = sum over k < xbar of
// x[r0 + r, seg + k] * w[seg + k, c0 + c], accumulated with one fmaf per k
// in increasing k from 0 — the forward kernels' order. Rows at or past
// m_end and columns past N are masked to 0 inputs. buf: the x and w slices
// (RecomputeLayout<R, C>::kGateAt floats).
template <int R, int C>
__device__ __forceinline__ void recompute_gate(
    const float* __restrict__ x, const float* __restrict__ w, float* buf,
    float* gs, int r0, int m_end, int c0, int seg, int xbar, int N, int D,
    int fn, float sc) {
  constexpr int kGr = kThreads / C;  // row groups
  constexpr int kQ = R / kGr;        // rows per thread
  static_assert(kGr * C == kThreads && kQ * kGr == R, "even split");
  float* xs = buf;                  // [kBK][R + 1]
  float* wsm = xs + kBK * (R + 1);  // [kBK][C]
  const int c = threadIdx.x % C, rg = threadIdx.x / C;
  float p[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) p[q] = 0.f;
  for (int k0 = 0; k0 < xbar; k0 += kBK) {
#pragma unroll 1
    for (int e = threadIdx.x; e < R * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int m = r0 + r, kk = k0 + k;
      xs[k * (R + 1) + r] = (m < m_end && kk < xbar && seg + kk < D)
                                ? x[static_cast<size_t>(m) * D + seg + kk]
                                : 0.f;
    }
#pragma unroll 1
    for (int e = threadIdx.x; e < kBK * C; e += kThreads) {
      const int k = e / C, cc = e % C;
      const int n = c0 + cc, kk = k0 + k;
      wsm[k * C + cc] = (n < N && kk < xbar && seg + kk < D)
                            ? w[static_cast<size_t>(seg + kk) * N + n]
                            : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kBK; ++k) {
      const float b = wsm[k * C + c];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        p[q] = fmaf(xs[k * (R + 1) + rg + q * kGr], b, p[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    gs[(rg + q * kGr) * (C + 1) + c] =
        cadc::dendritic_grad(fn, __fmul_rn(p[q], sc));
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dx
// ---------------------------------------------------------------------------

// Tiles of BM rows x CW segment columns; 256 threads, thread (ty, tx)
// owning rows ty + i*kNTY (i < TM) and columns tx + j*kNTX (j < 4). A warp
// holds 4 thread rows x 8 thread columns. Thread tid copies chunk q = tid
// % 8 (4 n) of g rows tid / 8 + r*32. A block takes row tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of its column tile, its k-tiles of all of
// them one stream through the ring, so the next tile's loads overlap this
// one's multiply-adds.
template <int BM, int CW, int kKind>
struct DxCfg {
  static constexpr int kNTX = CW / 4, kNTY = kThreads / kNTX;
  static constexpr int TM = BM / kNTY;
  static constexpr int kRow = kBK + 4;  // floats a row of A and B
  static constexpr int kAFloats = BM * kRow, kBFloats = CW * kRow;
  static constexpr int kGL = BM * 8 / kThreads;  // g rows a thread
  static constexpr int kGFloats =
      kKind == cadc::kGatePacked ? BM : BM * 8 * kSlotFloats<kKind>;
  static constexpr int kStages = kKind == cadc::kGateF32 ? 2 : 3;
  static constexpr int kStageFloats = kAFloats + kBFloats + kGFloats;
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) * kStages * kStageFloats;
  static_assert(TM * kNTY == BM && kNTX % 8 == 0 && kNTY % 4 == 0 &&
                    kGL >= 1,
                "warps of 4 x 8 threads; copies split evenly");
};

template <int BM, int CW, int kKind>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const Bwd p) {
  using C = DxCfg<BM, CW, kKind>;
  constexpr int TM = C::TM, kRow = C::kRow;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWX = C::kNTX / 8;  // warps across the columns
  const int tx = (warp % kWX) * 8 + lane % 8;
  const int ty = (warp / kWX) * 4 + lane / 8;
  const int q = tid % 8;
  const int per = (p.xbar + CW - 1) / CW;  // column tiles a whole segment
  const int s = blockIdx.y / per, c0 = (blockIdx.y % per) * CW;
  const int seg = s * p.xbar, width = min(p.xbar, p.D - seg);
  const int KT = (p.N + kBK - 1) / kBK;  // k-tiles a row tile
  const int row_tiles = (p.M + BM - 1) / BM;
  const int T = KT * ((row_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // the first row of k-tile t's row tile
  auto row0 = [&](int t) { return (blockIdx.x + t / KT * gridDim.x) * BM; };

  auto load = [&](int t, int slot) {
    float* as = smem + slot * C::kStageFloats;
    float* bs = as + C::kAFloats;
    float* gs = bs + C::kBFloats;
    const int m0 = row0(t), n0 = t % KT * kBK, n = n0 + 4 * q;
#pragma unroll
    for (int r = 0; r < C::kGL; ++r) {
      const int row = tid / 8 + r * (kThreads / 8), m = m0 + row;
      copy_g_chunk<kKind>(p, as + row * kRow + 4 * q,
                          gs + (row * 8 + q) * kSlotFloats<kKind>, s, m, n,
                          m < p.M);
      if constexpr (kKind == cadc::kGatePacked)
        if (q == 0)
          copy_word(p, reinterpret_cast<uint32_t*>(gs) + row, s, m, n0,
                    m < p.M);
    }
    copy_tile<CW, kBK>(bs, kRow, p.w, p.N, seg + c0, seg + width, n0, p.N,
                       p.vec_n);
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < T) load(st, st);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<C::kStages - 2>();
    float* as = smem + (t % C::kStages) * C::kStageFloats;
    const float* bs = as + C::kAFloats;
    const int m0 = row0(t);
    if constexpr (kKind != cadc::kGateNone) {
      const float* gs = bs + C::kBFloats;
      if constexpr (kKind == cadc::kGatePacked) __syncwarp();
#pragma unroll
      for (int r = 0; r < C::kGL; ++r) {
        const int row = tid / 8 + r * (kThreads / 8), m = m0 + row;
        uint32_t word = 0;
        if constexpr (kKind == cadc::kGatePacked)
          word = reinterpret_cast<const uint32_t*>(gs)[row] >> (4 * q);
        gate_chunk<kKind>(p, as + row * kRow + 4 * q,
                          gs + (row * 8 + q) * kSlotFloats<kKind>, word, s, m,
                          t % KT * kBK + 4 * q, m < p.M);
      }
    }
    __syncthreads();  // tile t landed and gated; all are done with t - 1
    if (t + C::kStages - 1 < T)
      load(t + C::kStages - 1, (t + C::kStages - 1) % C::kStages);
    copy_commit();

#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + i * C::kNTY) * kRow + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + (tx + j * C::kNTX) * kRow + k0);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    if (t % KT != KT - 1) continue;
    // the row tile's dot products are whole: store them, start the next
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * C::kNTY;
      float* dst = p.dx + static_cast<size_t>(m) * p.D + seg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + j * C::kNTX;
        if (m < p.M && c < width) dst[c] = acc[i][j];
        acc[i][j] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dw
// ---------------------------------------------------------------------------

// A block of RW rows of D (columns c0 .. of segment s) x NW columns of N
// (n0 ..), over the M rows of split blockIdx.z. 256 threads in kG groups
// of (RW/8) x (NW/4) threads, each owning rows ty*8 .. +7 and columns tx*4
// .. +3. A k-tile holds 32 rows of M: x [32][RW] and g ⊙ f' [32][NW], g
// in chunks of 4 columns (chunk e: row e / (NW/4)), the packed words of a
// row in kWords slots. Where one segment spans D and the tile covers it
// (the stems), the k-tile's x rows are one contiguous run of 32 * D floats,
// copied 16 bytes at a time and kept D floats a row. Under the recompute
// gate, recompute_gate's buffer follows the ring: f' of the k-tile's 32 x
// NW psums.
template <int RW, int NW, int kKind>
struct DwCfg {
  static constexpr int kMK = 64;  // rows of M a k-tile
  static constexpr int kNTY = RW / 8, kNTX = NW / 4;
  static constexpr int kGroup = kNTY * kNTX, kG = kThreads / kGroup;
  static constexpr int kGChunks = kMK * NW / 4;
  static constexpr int kGL = (kGChunks + kThreads - 1) / kThreads;
  static constexpr int kWords = (NW + kPack - 1) / kPack;
  static constexpr int kAFloats = kMK * RW, kBFloats = kMK * NW;
  static constexpr int kGFloats = kKind == cadc::kGatePacked
                                      ? kMK * kWords
                                      : kGChunks * kSlotFloats<kKind>;
  static constexpr int kStages = 4;
  static constexpr int kStageFloats = kAFloats + kBFloats + kGFloats;
  static constexpr int kRing = kStages * kStageFloats;
  static constexpr int kRed = kThreads * 32;  // the groups' sums
  static constexpr int kBase = kRing > kRed ? kRing : kRed;
  // the recompute gate: recompute_gate's slices, then f' [kMK][NW + 1]
  static constexpr int kReSlices = RecomputeLayout<kBK, NW>::kGateAt;
  static constexpr int kReFloats = kReSlices + kMK * (NW + 1);
  static constexpr int kSmem =
      static_cast<int>(sizeof(float)) *
      (kBase + (kKind == cadc::kGateRecompute ? kReFloats : 0));
  static_assert(kG * kGroup == kThreads && kMK % kG == 0,
                "groups split the threads and the k-tile evenly");
};

template <int RW, int NW, int kKind>
__device__ __forceinline__ void dw_block(const Bwd& p) {
  using C = DwCfg<RW, NW, kKind>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int grp = tid / C::kGroup, lt = tid % C::kGroup;
  const int ty = lt / C::kNTX, tx = lt % C::kNTX;
  const int per = (p.xbar + RW - 1) / RW;  // D tiles a whole segment
  const int s = blockIdx.y / per, c0 = (blockIdx.y % per) * RW;
  const int seg = s * p.xbar, width = min(p.xbar, p.D - seg);
  const int n0 = blockIdx.x * NW;
  const int m_lo = blockIdx.z * p.rows_per_split;
  const int m_hi = min(p.M, m_lo + p.rows_per_split);
  const int T = (m_hi - m_lo + C::kMK - 1) / C::kMK;
  constexpr bool kRe = kKind == cadc::kGateRecompute;
  const float sc = (kRe && p.scale != nullptr) ? *p.scale : 1.f;

  // x rows `lda` floats apart in shared memory: D where the k-tile's rows are
  // copied as one run (rows past m_hi are x's next rows, or zeros past M:
  // their g is zero), RW otherwise
  const bool dense = p.one_seg && p.D <= RW;
  const int lda = dense ? p.D : RW;

  auto load = [&](int t, int slot) {
    float* as = smem + slot * C::kStageFloats;
    float* bs = as + C::kAFloats;
    float* gs = bs + C::kBFloats;
    const int mk0 = m_lo + t * C::kMK;
    if (dense) {
      const float* src = p.x + static_cast<size_t>(mk0) * p.D;
      const long long left = static_cast<long long>(p.M - mk0) * p.D;
      for (int e = tid; e < C::kMK / 4 * p.D; e += kThreads) {
        const int f = 4 * e;
        if (f + 4 <= left) {
          copy16(as + f, src + f, true);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            copy4(as + f + i, f + i < left ? src + f + i : p.x, f + i < left);
        }
      }
    } else {
      copy_tile<C::kMK, RW>(as, RW, p.x + seg, p.D, mk0, m_hi, c0, width,
                         p.vec_d);
    }
#pragma unroll
    for (int r = 0; r < C::kGL; ++r) {
      const int e = tid + r * kThreads;
      if (C::kGChunks % kThreads && e >= C::kGChunks) break;
      const int row = e / (NW / 4), qc = e % (NW / 4), m = mk0 + row;
      const int n = n0 + 4 * qc;
      copy_g_chunk<kKind>(p, bs + row * NW + 4 * qc,
                          gs + e * kSlotFloats<kKind>, s, m, n, m < m_hi);
      if constexpr (kKind == cadc::kGatePacked)
        if (qc % 8 == 0)
          copy_word(p, reinterpret_cast<uint32_t*>(gs) + row * C::kWords +
                           qc / 8,
                    s, m, n, m < m_hi);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < T) load(st, st);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<C::kStages - 2>();
    const float* as = smem + (t % C::kStages) * C::kStageFloats;
    float* bs = const_cast<float*>(as) + C::kAFloats;
    if constexpr (kRe) {  // f' of this k-tile's psums, the forward's order
#pragma unroll 1
      for (int h = 0; h < C::kMK / kBK; ++h)
        recompute_gate<kBK, NW>(
            p.x, p.w, smem + C::kBase,
            smem + C::kBase + C::kReSlices + h * kBK * (NW + 1),
            m_lo + t * C::kMK + h * kBK, m_hi, n0, seg, p.xbar, p.N, p.D,
            p.fn, sc);
    }
    if constexpr (kKind != cadc::kGateNone) {
      const float* gs = bs + C::kBFloats;
      if constexpr (kKind == cadc::kGatePacked) __syncwarp();
#pragma unroll
      for (int r = 0; r < C::kGL; ++r) {
        const int e = tid + r * kThreads;
        if (C::kGChunks % kThreads && e >= C::kGChunks) break;
        const int row = e / (NW / 4), qc = e % (NW / 4);
        const int m = m_lo + t * C::kMK + row, n = n0 + 4 * qc;
        uint32_t word = 0;
        if constexpr (kKind == cadc::kGatePacked)
          word = reinterpret_cast<const uint32_t*>(
                     gs)[row * C::kWords + qc / 8] >>
                 (n % kPack);
        const float* slot =
            kRe ? smem + C::kBase + C::kReSlices + row * (NW + 1) + 4 * qc
                : gs + e * kSlotFloats<kKind>;
        gate_chunk<kKind>(p, bs + row * NW + 4 * qc, slot, word, s, m, n,
                          m < m_hi);
      }
    }
    __syncthreads();  // tile t landed and gated; all are done with t - 1
    if (t + C::kStages - 1 < T)
      load(t + C::kStages - 1, (t + C::kStages - 1) % C::kStages);
    copy_commit();

#pragma unroll
    for (int i = 0; i < C::kMK / C::kG; ++i) {
      const int k = grp + i * C::kG;
      const float* a = as + k * lda + ty * 8;  // past D: unused rows
      const float4 b = *reinterpret_cast<const float4*>(bs + k * NW + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = a[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
      }
    }
  }

  // the groups' sums, added in group order from an fp32 zero
  copy_wait<0>();
  __syncthreads();  // the ring is free
  float* red = smem;  // [kG][RW][NW]
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<float4*>(red + grp * RW * NW + (ty * 8 + r) * NW +
                               tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const bool split = gridDim.z > 1;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* part = p.scratch +
                (static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y +
                 tile) * (RW * NW);
  for (int e = tid; e < RW * NW; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < C::kG; ++i) v += red[i * RW * NW + e];
    const int d = c0 + e / NW, n = n0 + e % NW;
    if (split)
      part[e] = v;
    else if (d < width && n < p.N)
      p.dw[static_cast<size_t>(seg + d) * p.N + n] = v;
  }
  if (split) add_splits<RW * NW, NW>(p, tile, seg + c0, seg + width, n0);
}

template <int RW, int NW, int kKind>
__global__ void __launch_bounds__(kThreads) bwd_dw_kernel(const Bwd p) {
  dw_block<RW, NW, kKind>(p);
}

// The recompute gate's dw: the recomputed psums beside the tile's sums
// need more than the 128 registers ptxas aims for unbidden.
template <int RW, int NW>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dw_recompute_kernel(const Bwd p) {
  dw_block<RW, NW, cadc::kGateRecompute>(p);
}

// ---------------------------------------------------------------------------
// dx under the recompute gate
// ---------------------------------------------------------------------------

constexpr int kT = 64;  // the tile edge: 16 x 16 threads of 4 x 4

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
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_recompute_kernel(const Bwd p) {
  using L = RecomputeLayout<kT, kBK>;
  __shared__ float as[kBK][kT + 1];  // as[n][m] = g * gate
  __shared__ float bs[kBK][kT + 1];  // bs[n][c] = w[seg + c0 + c, n]
  __shared__ float rbuf[L::kFloats];
  const int ctiles = (p.xbar + kT - 1) / kT;
  const int s = blockIdx.y / ctiles, c0 = (blockIdx.y % ctiles) * kT;
  const int seg = s * p.xbar, m0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float sc = p.scale != nullptr ? *p.scale : 1.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < p.N; n0 += kBK) {
    recompute_gate<kT, kBK>(p.x, p.w, rbuf, rbuf + L::kGateAt, m0, p.M, n0,
                            seg, p.xbar, p.N, p.D, p.fn, sc);
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int ml = e / kBK, k = e % kBK;
      const int m = m0 + ml, n = n0 + k;
      float v = 0.f;
      if (m < p.M && n < p.N)
        v = p.g[static_cast<size_t>(m) * p.N + n] *
            rbuf[L::kGateAt + ml * (kBK + 1) + k];
      as[k][ml] = v;
    }
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int c = e / kBK, k = e % kBK;
      const int d = seg + c0 + c, n = n0 + k;
      bs[k][c] = (c0 + c < p.xbar && d < p.D && n < p.N)
                     ? p.w[static_cast<size_t>(d) * p.N + n]
                     : 0.f;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < p.xbar && seg + c < p.D)
        p.dx[static_cast<size_t>(m) * p.D + seg + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: the tensor-core kernels
// ---------------------------------------------------------------------------

// A bf16 K2 launch (cadc_bwd_mma_launch): g [M, N], x [M, D], w [D, N]
// bf16, row-major; the gate (none, packed words [S, M, ceil(N/32)] or one
// byte a psum [S, M, N]: f' is 0 or 1, so g ⊙ f' is bf16 exactly); dx
// [M, D] and dw [D, N] fp32, either null (not wanted); scratch [splits,
// dw tiles, kMmaR * kMmaC] fp32 and the arrival counters when dw's M is
// split (grid z > 1).
struct BwdMma {
  const __nv_bfloat16* g;
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const void* gate;
  float* dx;
  float* dw;
  float* scratch;
  int* counters;
  int M, N, D, xbar, rows_per_split;
  bool gvec;  // g (and a byte gate) by 16-byte (8-byte) cp.async
  bool wvec;  // w by 16-byte cp.async
  bool xvec;  // x by 16-byte cp.async
};

constexpr int kMmaC = 128;  // columns of a block tile (a warp: 32)
constexpr int kMmaK = 64;   // k of a staged slice: four k16 steps
constexpr int kMmaR = 128;  // dw's rows of D a tile

// dx (kDw false): A = g ⊙ f' [R rows of M][kMmaK of N], B = w's segment
// rows [kMmaC][kMmaK of N] — both k-contiguous, read by ldmatrix.x4 (w
// [D, N] is already mma's "col" B). dw (kDw): A = x [kMmaK of M][R of D]
// and B = g ⊙ f' [kMmaK of M][kMmaC of N] — both k-major, read by
// ldmatrix.x4.trans. Rows padded by 16 bytes (no bank conflicts). The
// gate's slots follow each stage: packed words [rows][cols / 32], or a
// byte a column.
template <bool kDw, int R, int kKind>
struct MmaBwdCfg {
  static_assert(R == 128 || R == 64, "row tiles of 128 or 64");
  static constexpr int kMT = R / 32;  // m16 tiles a warp (2 warp rows)
  static constexpr int kAStride = (kDw ? R : kMmaK) * 2 + 16;
  static constexpr int kBStride = (kDw ? kMmaC : kMmaK) * 2 + 16;
  static constexpr int kABytes = (kDw ? kMmaK : R) * kAStride;
  static constexpr int kBBytes = (kDw ? kMmaK : kMmaC) * kBStride;
  static constexpr int kGRows = kDw ? kMmaK : R;   // g ⊙ f' rows (M)
  static constexpr int kGCols = kDw ? kMmaC : kMmaK;  // its columns (N)
  static constexpr int kGateBytes =
      kKind == cadc::kGatePacked ? kGRows * (kGCols / kPack) * 4
      : kKind == cadc::kGateU8   ? kGRows * kGCols
                                 : 0;
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = kABytes + kBBytes + kGateBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ void copy8(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 8 : 0));
}

// A [kRows][kCols] tile of a row-major bf16 matrix (rows ld elements
// apart) to shared memory (rows `stride` bytes apart): rows r0 + r < rmax,
// columns c0 + c < cmax, zeros elsewhere. 16 bytes a cp.async where `vec`
// (base and ld on 16 bytes, cmax - c0 a multiple of 8 or past the tile),
// else 2-byte loads through registers.
template <int kRows, int kCols>
__device__ __forceinline__ void mma_tile(unsigned char* dst, int stride,
                                         const __nv_bfloat16* base,
                                         size_t ld, int r0, int rmax,
                                         int c0, int cmax, bool vec) {
  constexpr int kV = kCols / 8;  // 16-byte chunks a row
  if (vec) {
#pragma unroll
    for (int i = 0; i < kRows * kV / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kV, c = 8 * (e % kV);
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      copy16(dst + r * stride + 2 * c,
             ok ? base + static_cast<size_t>(r0 + r) * ld + c0 + c : base,
             ok);
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    reinterpret_cast<unsigned short*>(dst + r * stride)[c] =
        r0 + r < rmax && c0 + c < cmax
            ? cadc::ld_bf16_bits(base + static_cast<size_t>(r0 + r) * ld +
                                 c0 + c)
            : 0;
  }
}

// The [kRows][kCols] tile of g ⊙ f'(p_s) at rows (of M) r0 .. < rmax and
// columns (of N) c0 .., zeros elsewhere. With gvec, g's 16-byte chunks by
// cp.async and the gate beside them in `slot`: a packed word by the lane
// that copies its first chunk (the word's other chunks are its warp's next
// three lanes), a chunk's 8 bytes by its own lane; mma_gate then applies
// it. Else 2-byte loads through registers, gated as they are stored.
template <int kRows, int kCols, int kKind>
__device__ __forceinline__ void mma_gm(const BwdMma& p, unsigned char* dst,
                                       int stride, unsigned char* slot,
                                       int s, int r0, int rmax, int c0) {
  constexpr int kV = kCols / 8;
  const int nw = (p.N + kPack - 1) / kPack;
  const size_t gbase = static_cast<size_t>(s) * p.M;
  if (p.gvec) {
#pragma unroll
    for (int i = 0; i < kRows * kV / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kV, cc = e % kV, m = r0 + r, n = c0 + 8 * cc;
      const bool ok = m < rmax && n < p.N;
      copy16(dst + r * stride + 16 * cc,
             ok ? p.g + static_cast<size_t>(m) * p.N + n : p.g, ok);
      if constexpr (kKind == cadc::kGatePacked) {
        if (cc % 4 == 0)
          copy4(slot + 4 * (r * (kCols / kPack) + cc / 4),
                ok ? static_cast<const uint32_t*>(p.gate) +
                         (gbase + m) * nw + n / kPack
                   : p.gate,
                ok);
      } else if constexpr (kKind == cadc::kGateU8) {
        copy8(slot + r * kCols + 8 * cc,
              ok ? static_cast<const uint8_t*>(p.gate) +
                       (gbase + m) * p.N + n
                 : p.gate,
              ok);
      }
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols, m = r0 + r, n = c0 + c;
    unsigned short v = 0;
    if (m < rmax && n < p.N) {
      v = cadc::ld_bf16_bits(p.g + static_cast<size_t>(m) * p.N + n);
      if constexpr (kKind == cadc::kGatePacked) {
        const uint32_t word = __ldg(static_cast<const uint32_t*>(p.gate) +
                                    (gbase + m) * nw + n / kPack);
        if (!(word >> (n % kPack) & 1u)) v = 0;
      } else if constexpr (kKind == cadc::kGateU8) {
        if (!__ldg(static_cast<const uint8_t*>(p.gate) + (gbase + m) * p.N +
                   n))
          v = 0;
      }
    }
    reinterpret_cast<unsigned short*>(dst + r * stride)[c] = v;
  }
}

// The 32-bit mask of two bf16 columns: each half kept where its gate is set.
__device__ __forceinline__ uint32_t pair_mask(bool lo, bool hi) {
  return (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

// g ⊙ f' in shared memory over the chunks this thread copied (mma_gm with
// gvec), once they have landed: 8 columns a chunk, one AND a bf16 pair.
template <int kRows, int kCols, int kKind>
__device__ __forceinline__ void mma_gate(unsigned char* tile, int stride,
                                         const unsigned char* slot) {
  constexpr int kV = kCols / 8;
  if constexpr (kKind == cadc::kGatePacked) __syncwarp();  // its lanes' words
#pragma unroll
  for (int i = 0; i < kRows * kV / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kV, cc = e % kV;
    uint4* v = reinterpret_cast<uint4*>(tile + r * stride + 16 * cc);
    uint4 a = *v;
    if constexpr (kKind == cadc::kGatePacked) {
      const uint32_t bits =
          reinterpret_cast<const uint32_t*>(slot)[r * (kCols / kPack) +
                                                  cc / 4] >>
          (8 * (cc % 4));
      a.x &= pair_mask(bits & 1u, bits & 2u);
      a.y &= pair_mask(bits & 4u, bits & 8u);
      a.z &= pair_mask(bits & 16u, bits & 32u);
      a.w &= pair_mask(bits & 64u, bits & 128u);
    } else {
      const uint2 b =
          *reinterpret_cast<const uint2*>(slot + r * kCols + 8 * cc);
      a.x &= pair_mask(b.x & 0xffu, b.x & 0xff00u);
      a.y &= pair_mask(b.x & 0xff0000u, b.x & 0xff000000u);
      a.z &= pair_mask(b.y & 0xffu, b.y & 0xff00u);
      a.w &= pair_mask(b.y & 0xff0000u, b.y & 0xff000000u);
    }
    *v = a;
  }
}

// One block of dx or dw (see the note at the top). Warp (wm, wn) of the 2
// x 4 owns rows wm*R/2 .. and columns 32*wn .. of the block's R x kMmaC
// tile: kMT x 4 mma tiles of m16 x n8. The block walks its kMmaK-deep
// slices of the contraction in order through a kStages ring in dynamic
// shared memory (kStages - 1 in flight while one computes); each slice's
// four k16 steps of mma.sync build a fresh fp32 partial, which is added
// into the block's sums with __fadd_rn: one chain of slices, in
// increasing k from 0, an element, whatever the tile.
template <bool kDw, int R, int kKind>
__device__ __forceinline__ void mma_bwd_block(const BwdMma& p) {
  using C = MmaBwdCfg<kDw, R, kKind>;
  constexpr int kMT = C::kMT, kNT = 4;
  extern __shared__ __align__(16) unsigned char msmem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, q = lane % 4;  // an mma fragment's row, col pair
  // dx: blockIdx (row tile of M, column tile of the segments); dw: (column
  // tile of N, row tile of the segments, split of M)
  const int cols = kDw ? R : kMmaC;  // the segment's span of a tile
  const int per = (p.xbar + cols - 1) / cols;
  const int s = blockIdx.y / per, off = (blockIdx.y % per) * cols;
  const int seg = s * p.xbar, width = min(p.xbar, p.D - seg);
  const int m0 = kDw ? 0 : blockIdx.x * R;
  const int n0 = kDw ? blockIdx.x * kMmaC : 0;
  const int m_lo = kDw ? blockIdx.z * p.rows_per_split : 0;
  const int m_hi = kDw ? min(p.M, m_lo + p.rows_per_split) : p.M;
  const int T = kDw ? (max(m_hi - m_lo, 0) + kMmaK - 1) / kMmaK
                    : (p.N + kMmaK - 1) / kMmaK;
  constexpr bool kGated = kKind != cadc::kGateNone;

  const auto stage = [&](int t) {
    return msmem + (t % C::kStages) * C::kStageBytes;
  };
  const auto load = [&](int t) {
    if (t >= T) return;
    unsigned char* as = stage(t);
    unsigned char* bs = as + C::kABytes;
    unsigned char* slot = bs + C::kBBytes;
    if constexpr (kDw) {
      const int mk = m_lo + t * kMmaK;
      mma_tile<kMmaK, R>(as, C::kAStride, p.x, p.D, mk, m_hi, seg + off,
                         seg + width, p.xvec);
      mma_gm<kMmaK, kMmaC, kKind>(p, bs, C::kBStride, slot, s, mk, m_hi, n0);
    } else {
      const int nk = t * kMmaK;
      mma_gm<R, kMmaK, kKind>(p, as, C::kAStride, slot, s, m0, p.M, nk);
      mma_tile<kMmaC, kMmaK>(bs, C::kBStride, p.w, p.N, seg + off,
                             seg + width, nk, p.N, p.wvec);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int j = 0; j < C::kStages - 1; ++j) {
    load(j);
    copy_commit();
  }
  for (int t = 0; t < T; ++t) {
    copy_wait<C::kStages - 2>();
    const unsigned char* as = stage(t);
    const unsigned char* bs = as + C::kABytes;
    if constexpr (kGated) {
      if (p.gvec)
        mma_gate<C::kGRows, C::kGCols, kKind>(
            const_cast<unsigned char*>(kDw ? bs : as),
            kDw ? C::kBStride : C::kAStride, bs + C::kBBytes);
    }
    __syncthreads();  // slice t landed and gated; every warp done with t - 1
    load(t + C::kStages - 1);  // into t - 1's slot
    copy_commit();

    float ps[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaK / 16; ++kk) {
      // B's k rows 0-7 / 8-15 (b0 / b1) of n8 tiles 2np and 2np + 1, then
      // A's rows 0-15 x k 0-7 / 8-15 (a0 a1 / a2 a3) of each m16 tile
      uint32_t b[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];
        if constexpr (kDw)
          cadc::ldsm4_t(r, bs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) *
                                    C::kBStride +
                               (wn * 32 + np * 16 + (lane / 16) * 8) * 2);
        else
          cadc::ldsm4(r, bs + (wn * 32 + np * 16 + (lane / 16) * 8 +
                               lane % 8) * C::kBStride +
                             kk * 32 + (lane / 8 % 2) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
        if constexpr (kDw)
          cadc::ldsm4_t(a, as + (kk * 16 + (lane / 16) * 8 + lane % 8) *
                                    C::kAStride +
                               (wm * (R / 2) + i * 16 + (lane / 8 % 2) * 8) *
                                   2);
        else
          cadc::ldsm4(a, as + (wm * (R / 2) + i * 16 + lane % 16) *
                                  C::kAStride +
                             kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          cadc::mma_bf16(ps[i][j], a, b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], ps[i][j][e]);
  }
  copy_wait<0>();

  // element (i, j, e) of the fragments: tile row rr(i, e), column cc(j, e)
  const auto rr = [&](int i, int e) {
    return wm * (R / 2) + i * 16 + (e / 2) * 8 + g;
  };
  const auto cc = [&](int j, int e) { return wn * 32 + j * 8 + 2 * q + e % 2; };
  // a fragment's column pair (c, c + 1) of row `row` (c even), columns
  // below `end`: one float2 where the row's pairs lie on 8 bytes
  const auto put2 = [](float* row, int c, int end, bool even, float v0,
                       float v1) {
    if (even && c + 1 < end) {
      *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    } else {
      if (c < end) row[c] = v0;
      if (c + 1 < end) row[c + 1] = v1;
    }
  };
  if constexpr (!kDw) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + rr(i, 2 * h);
          if (m < p.M)
            put2(p.dx + static_cast<size_t>(m) * p.D + seg, off + cc(j, 0),
                 width, p.D % 2 == 0, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = off + rr(i, 2 * h);
          if (r < width)
            put2(p.dw + static_cast<size_t>(seg + r) * p.N, n0 + cc(j, 0),
                 p.N, p.N % 2 == 0, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }
  // a split of M: this block's partial tile to scratch, then the tile's
  // last block to arrive adds the splits' partials in split order
  constexpr int kTile = R * kMmaC;
  float* part = p.scratch +
                (static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y +
                 tile) * kTile;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + rr(i, 2 * h) * kMmaC +
                                   cc(j, 0)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  const int S = gridDim.z;
  if (!cadc::arrive_last(p.counters + tile, S)) return;
  const size_t stride = static_cast<size_t>(gridDim.x) * gridDim.y * kTile;
  const float4* src =
      reinterpret_cast<const float4*>(p.scratch + static_cast<size_t>(tile) *
                                                      kTile) + tid;
  constexpr int kF = kTile / 4 / kThreads;  // float4s a thread
  constexpr int kU = 4;                  // of them at a time
  constexpr int kZ = 4;                  // splits' loads in flight
#pragma unroll 1
  for (int f0 = 0; f0 < kF; f0 += kU) {
    float4 sum[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int z0 = 0; z0 < S; z0 += kZ) {
      float4 v[kZ][kU];
#pragma unroll
      for (int z = 0; z < kZ; ++z)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          v[z][u] = z0 + z < S ? __ldcg(src + (z0 + z) * (stride / 4) +
                                        (f0 + u) * kThreads)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < kZ; ++z) {
        if (z0 + z >= S) break;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          sum[u].x += v[z][u].x;
          sum[u].y += v[z][u].y;
          sum[u].z += v[z][u].z;
          sum[u].w += v[z][u].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = 4 * (tid + (f0 + u) * kThreads);
      const int r = off + e / kMmaC, n = n0 + e % kMmaC;
      if (r >= width) continue;
      float* dst = p.dw + static_cast<size_t>(seg + r) * p.N + n;
      const float o[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n + k < p.N) dst[k] = o[k];
    }
  }
  if (tid == 0) p.counters[tile] = 0;
}

// One block an SM (up to 255 registers a thread): the slice's partials
// beside the sums are two fragment sets, 64 fp32 each at 128 rows.
template <int R, int kKind>
__global__ void __launch_bounds__(kThreads, 1)
bf16_bwd_dx_kernel(const BwdMma p) {
  mma_bwd_block<false, R, kKind>(p);
}

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
bf16_bwd_dw_kernel(const BwdMma p) {
  mma_bwd_block<true, kMmaR, kKind>(p);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Column (or row) tiles of `cols` over the segments of D.
inline unsigned seg_tiles(int D, int xbar, int cols) {
  const int S = (D + xbar - 1) / xbar;
  const int last = D - (S - 1) * xbar;
  return static_cast<unsigned>((S - 1) * ((xbar + cols - 1) / cols) +
                               (last + cols - 1) / cols);
}
inline unsigned seg_tiles(const Bwd& p, int cols) {
  return seg_tiles(p.D, p.xbar, cols);
}

template <int BM, int CW, int kKind>
int launch_dx(const Bwd& p, int blocks, cudaStream_t st) {
  using C = DxCfg<BM, CW, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = bwd_dx_kernel<BM, CW, kKind>;
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const dim3 grid(static_cast<unsigned>(blocks), seg_tiles(p, CW));
  kernel<<<grid, kThreads, C::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int RW, int NW, int kKind>
int launch_dw(const Bwd& p, int splits, cudaStream_t st) {
  using C = DwCfg<RW, NW, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = [] {
    if constexpr (kKind == cadc::kGateRecompute)
      return bwd_dw_recompute_kernel<RW, NW>;
    else
      return bwd_dw_kernel<RW, NW, kKind>;
  }();
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const dim3 grid(static_cast<unsigned>((p.N + NW - 1) / NW),
                  seg_tiles(p, RW), static_cast<unsigned>(splits));
  kernel<<<grid, kThreads, C::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

template <int kKind>
int dx_by_tile(const Bwd& p, int rows, int cols, int blocks,
               cudaStream_t st) {
  if (blocks < 1 || blocks > (p.M + rows - 1) / rows) return kBad;
  if (rows == 128 && cols == 32)
    return launch_dx<128, 32, kKind>(p, blocks, st);
  if (rows == 32 && cols == 32) return launch_dx<32, 32, kKind>(p, blocks, st);
  if (rows == 128 && cols == 64)
    return launch_dx<128, 64, kKind>(p, blocks, st);
  if (rows == 32 && cols == 64) return launch_dx<32, 64, kKind>(p, blocks, st);
  return kBad;
}

template <int kKind>
int dw_by_tile(const Bwd& p, int rows, int cols, int splits,
               cudaStream_t st) {
#define CADC_DW(r, c) \
  if (rows == r && cols == c) return launch_dw<r, c, kKind>(p, splits, st)
  CADC_DW(32, 16);
  CADC_DW(32, 32);
  CADC_DW(32, 64);
  CADC_DW(64, 16);
  CADC_DW(64, 32);
  CADC_DW(64, 64);
#undef CADC_DW
  return kBad;
}

template <int kKind>
int by_tile(const Bwd& p, int dx_rows, int dx_cols, int dx_blocks,
            int dw_rows, int dw_cols, int splits, cudaStream_t st) {
  if (p.dx != nullptr)
    if (const int e = dx_by_tile<kKind>(p, dx_rows, dx_cols, dx_blocks, st))
      return e;
  if (p.dw != nullptr) return dw_by_tile<kKind>(p, dw_rows, dw_cols, splits, st);
  return 0;
}

// The recompute gate: dx by the 64 x 64 kernel, dw by the planned tile.
int recompute(const Bwd& p, int dx_rows, int dx_cols, int dw_rows,
              int dw_cols, int splits, cudaStream_t st) {
  if (p.dx != nullptr) {
    if (dx_rows != kT || dx_cols != kT) return kBad;
    bwd_dx_recompute_kernel<<<dim3((p.M + kT - 1) / kT, seg_tiles(p, kT)),
                              kThreads, 0, st>>>(p);
    if (const int e = static_cast<int>(cudaGetLastError())) return e;
  }
  if (p.dw != nullptr)
    return dw_by_tile<cadc::kGateRecompute>(p, dw_rows, dw_cols, splits, st);
  return 0;
}

template <int R, int kKind>
int launch_mma_dx(const BwdMma& p, cudaStream_t st) {
  using C = MmaBwdCfg<false, R, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = bf16_bwd_dx_kernel<R, kKind>;
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const dim3 grid(static_cast<unsigned>((p.M + R - 1) / R),
                  seg_tiles(p.D, p.xbar, kMmaC));
  kernel<<<grid, kThreads, C::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind>
int launch_mma_dw(const BwdMma& p, int splits, cudaStream_t st) {
  using C = MmaBwdCfg<true, kMmaR, kKind>;
  static std::atomic<uint64_t> opted{0};
  auto kernel = bf16_bwd_dw_kernel<kKind>;
  if (const int e = opt_in(kernel, C::kSmem, opted)) return e;
  const dim3 grid(static_cast<unsigned>((p.N + kMmaC - 1) / kMmaC),
                  seg_tiles(p.D, p.xbar, kMmaR),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kThreads, C::kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind>
int mma_by_tile(const BwdMma& p, int dx_rows, int splits, cudaStream_t st) {
  if (p.dx != nullptr) {
    const int e = dx_rows == 128  ? launch_mma_dx<128, kKind>(p, st)
                  : dx_rows == 64 ? launch_mma_dx<64, kKind>(p, st)
                                  : kBad;
    if (e) return e;
  }
  if (p.dw != nullptr) return launch_mma_dw<kKind>(p, splits, st);
  return 0;
}

}  // namespace

// g [M, N], x [M, D], w [D, N] fp32, row-major; gate as gate_kind says
// (0 none, 1 packed uint32 [S, M, ceil(N/32)], 2 uint8 [S, M, N], 3 fp32
// [S, M, N], 4 recompute: NULL). scale: NULL (1) or one fp32 in device
// memory, the recompute's psum factor. dx [M, D] and dw [D, N] fp32, either
// may be NULL (not wanted). The plan (kernels/cadc_matmul.py plan_bwd): the
// dx tile dx_rows x dx_cols (128 or 32 rows of M, 32 or 64 segment
// columns) over dx_blocks blocks a column tile, each striding over the row
// tiles; the dw tile dw_rows x dw_cols (32 or 64 segment rows, 16, 32 or
// 64 columns of N), dw over `splits` ranges of rows_per_split rows of M;
// under the recompute gate dx takes 64 x 64. With splits > 1, scratch is fp32
// [splits, dw tiles, dw_rows * dw_cols] and counters int32 zeros, one per
// dw tile. Returns the CUDA error code after the launches (0 = success).
extern "C" int cadc_bwd_launch(const void* g, const void* x, const void* w,
                               const void* gate, const void* scale, void* dx,
                               void* dw, void* scratch, void* counters, int M,
                               int N, int D, int xbar, int fn, int gate_kind,
                               int dx_rows, int dx_cols, int dx_blocks,
                               int dw_rows, int dw_cols, int splits,
                               int rows_per_split, void* stream) {
  if (dw != nullptr &&
      (splits < 1 || rows_per_split < 1 ||
       (splits > 1 && (scratch == nullptr || counters == nullptr))))
    return kBad;
  const auto addr = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr);
  };
  const Bwd p{static_cast<const float*>(g),
              static_cast<const float*>(x),
              static_cast<const float*>(w),
              gate,
              static_cast<const float*>(scale),
              static_cast<float*>(dx),
              static_cast<float*>(dw),
              static_cast<float*>(scratch),
              static_cast<int*>(counters),
              M, N, D, xbar, fn, rows_per_split,
              N % 4 == 0 && (addr(g) | addr(w) | addr(gate)) % 16 == 0,
              D % 4 == 0 && xbar % 4 == 0 && addr(x) % 16 == 0,
              D <= xbar && addr(x) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gate_kind) {
#define CADC_BWD(kind) \
  case kind:           \
    return by_tile<kind>(p, dx_rows, dx_cols, dx_blocks, dw_rows, dw_cols, \
                         splits, st)
    CADC_BWD(cadc::kGateNone);
    CADC_BWD(cadc::kGatePacked);
    CADC_BWD(cadc::kGateU8);
    CADC_BWD(cadc::kGateF32);
#undef CADC_BWD
    case cadc::kGateRecompute:
      return recompute(p, dx_rows, dx_cols, dw_rows, dw_cols, splits, st);
    default:
      return kBad;
  }
}

extern "C" const char* cadc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The bf16 route: g [M, N], x [M, D], w [D, N] bf16, row-major; gate_kind
// 0 none, 1 packed uint32 [S, M, ceil(N/32)], 2 uint8 [S, M, N] (f' is 0
// or 1). dx [M, D] and dw [D, N] fp32, either may be NULL (not wanted). The
// plan (kernels/cadc_matmul.py plan_bwd, kernel "mma"): dx in tiles of
// dx_rows (128 or 64) rows of M x 128 segment columns; dw in tiles of 128
// segment rows x 128 columns of N over `splits` ranges of rows_per_split
// rows of M; with splits > 1, scratch is fp32 [splits, dw tiles, 128 * 128]
// and counters int32 zeros, one per dw tile. xbar must be a multiple of 16.
// Returns the CUDA error code after the launches (0 = success).
extern "C" int cadc_bwd_mma_launch(const void* g, const void* x,
                                   const void* w, const void* gate, void* dx,
                                   void* dw, void* scratch, void* counters,
                                   int M, int N, int D, int xbar,
                                   int gate_kind, int dx_rows, int splits,
                                   int rows_per_split, void* stream) {
  if (xbar < 16 || xbar % 16 || gate_kind < cadc::kGateNone ||
      gate_kind > cadc::kGateU8 ||
      (gate_kind != cadc::kGateNone && gate == nullptr) ||
      (dw != nullptr &&
       (splits < 1 || rows_per_split < 1 ||
        (splits > 1 && (scratch == nullptr || counters == nullptr)))))
    return kBad;
  const auto addr = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr);
  };
  const BwdMma p{static_cast<const __nv_bfloat16*>(g),
                 static_cast<const __nv_bfloat16*>(x),
                 static_cast<const __nv_bfloat16*>(w),
                 gate,
                 static_cast<float*>(dx),
                 static_cast<float*>(dw),
                 static_cast<float*>(scratch),
                 static_cast<int*>(counters),
                 M, N, D, xbar, rows_per_split,
                 N % 8 == 0 && addr(g) % 16 == 0 &&
                     (gate_kind != cadc::kGateU8 || addr(gate) % 8 == 0),
                 N % 8 == 0 && addr(w) % 16 == 0,
                 D % 8 == 0 && addr(x) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gate_kind) {
    case cadc::kGateNone:
      return mma_by_tile<cadc::kGateNone>(p, dx_rows, splits, st);
    case cadc::kGatePacked:
      return mma_by_tile<cadc::kGatePacked>(p, dx_rows, splits, st);
    default:
      return mma_by_tile<cadc::kGateU8>(p, dx_rows, splits, st);
  }
}
