// CADC segmented matmul with fused dendritic f(), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cadc_matmul.py `_kernel`
// (K1, launched by `_fwd_pallas`, the forward of `cadc_matmul_pallas`) and
// its `_kernel_with_gate` (K1g, the forward under jax.grad):
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
// Design. A small planner in kernels/cadc_matmul.py (`plan_fwd`) picks,
// from the shapes alone, one of two kernel bodies and whether to split the
// segments over blocks; the plan is an argument of the launch functions
// below, and every plan launches one kernel.
//
// The tile kernel (cadc_tile.cuh): one block owns a BM x 64 tile of y and
// walks its segments in order, staging 32-row slices of x and w through
// shared memory as fp32 and building the psum with CUDA-core FMAs (exact
// fp32 for fp32 inputs: no TF32), then f in registers and the add into
// the accumulator. BM is 64, or 8 where M is small. The ragged M and N
// edges are masked here, so the host pads nothing but D to S*xbar. The
// planner takes the single pass when the 64-row grid already has a block
// per SM (prefill); otherwise one block per (tile, segment), and 8-row
// tiles where that is still short of 132 blocks (the FC layers: ResNet-18's
// fc at 128 x 512 x 10 gets 128 blocks instead of 2). A split block writes
// its f(psum) tile to an fp32 scratch and the last block of each output
// tile adds the S tiles in order (ordered_segment_sum): bitwise the single
// pass, and every plan is bitwise every other.
//
// The stream kernel (K1 at decode: M <= 8, no gate, fp32 or bf16, xbar <=
// 512): at decode the bytes of w are the whole cost, so the kernel is
// built around bytes in flight. One block of 128 threads per (column strip
// of w, segment); the strip is 8 sixteen-byte vectors wide where that
// still gives 132 blocks, else 4. The block's x segment goes to shared
// memory once, as fp32, transposed to [xbar][8], so two float4 reads give
// the 8 rows of one k. w moves in 16-byte vectors (8 bf16 or 4 fp32
// columns; a warp reads 64 or 128 contiguous bytes of each of 4 or 8 rows)
// by cp.async into each thread's own slots of a ring in shared memory, 8
// rows a thread in flight (16 KB a block), never through registers or a
// barrier; each weight then feeds 8 FMAs, one per row of x. A thread
// accumulates an 8 x (its columns) psum over every (128 / lanes)-th row
// of the segment; the row groups of a warp are combined by an xor
// reduce-scatter and the warps in shared memory in a fixed order, so every
// run gives the same bits. Then f, and the ordered segment sum as above.
// N or xbar not a multiple of the vector, or x or w not 16-byte aligned,
// fill the same ring by scalar loads. It is launched as a programmatic
// dependent (PDL): its blocks may be scheduled while the previous kernel
// on the stream finishes, and wait for it before touching memory; it lets
// its own successor start once its weights are read. What it costs on the
// card, and why (the epilogue's latency chain), is in PERF.md.
//
// K1g is the same kernel with a gate epilogue (cadc_tile.cuh): at the end
// of each segment it writes f'(psum) from the fp32 psum in registers —
// a warp's __ballot_sync over 32 consecutive columns gives one packed
// uint32 word in the JAX bit layout (column tiles are whole words, N is
// padded to whole words), or one byte (relu) / one fp32 (curved fns) per
// psum. Its extra bytes are the gate's: S*M*N/8 packed, S*M*N bytes or
// 4*S*M*N fp32. On fp32 operands it runs the tile kernel under every plan.
//
// bf16 operands (K1 but at decode, and K1g: the LM train micro at M = 2048,
// prefill at M = 512 / 1024, the speculative verify step at M = 32) run
// the tensor-core kernel, `bf16_mma_kernel`, which replaces the same TPU
// bodies (`_kernel` :188 and `_kernel_with_gate` :199, psum by `_seg_psum`
// :142 with preferred_element_type=f32). Bound on this card: at a train
// micro it is bound by operations, 2*M*D*N at the bf16 tensor-core peak
// (gemma3-1b's w_gate, 36.2 GFLOP: 0.037 ms); at the verify step by the
// bytes of w (w_gate's 17.7 MB: 5.3 us). The tile kernel ran these products
// on the CUDA cores at ~12 TFLOP/s (~1.2 % of that peak), widening every
// bf16 operand to fp32.
//
// Design. A block of 8 warps owns a BM x 128 tile of y (BM = 128 or 32;
// warps 2 x 4, each 32 columns and BM/2 rows: kMT x 4 m16n8 tiles) and
// walks its segments' 64-wide k slices in order through a 4-stage ring in
// dynamic shared memory: x and w move by 16-byte cp.async (w by 4-byte
// copies where its rows are off 16 bytes, as the sLSTM's N = 2730; by
// 2-byte loads where N is odd or w is off 4 bytes; x by 2-byte loads where
// it is off 16 bytes), zero-filled past M, N and the segment's end; rows
// padded by 16 bytes, so ldmatrix is free of bank conflicts. A is read by
// ldmatrix.x4, B — w is k-major — by ldmatrix.x4.trans (16-bit types
// allow it: no transpose pass, unlike K4's int8), and mma.sync
// m16n8k16.row.col.f32.bf16.bf16.f32 builds each segment's psum in fp32
// fragments, one chain of k16 steps in increasing k (xbar must be a
// multiple of 16; other xbars stay on the tile kernel). At a segment's
// end the warp writes the gate from the fp32 psums (the packed word from
// the quad's fragments by two shuffles, as K4), applies f (one copy of the
// epilogue per fn) and adds f(psum) into a second set of fp32 fragments
// with __fadd_rn, in segment order from 0; then the psums restart. The
// two sets are what bound the tile: at 128 x 128 both would take 128 of a
// thread's 255 registers, so that tile keeps the chain in shared memory
// (one block an SM; 32 rows, two). A 64-row tile measured between the two
// and the fitted planner never picked it, so it went.
// The planner (kernels/cadc_matmul.py `plan_fwd` with dtype=bf16) picks
// the row tile and a split of the segments into groups, as `plan_fwd_q8`
// does, from a fitted model of the launch (`_mma_seconds`): in a split,
// group 0 keeps the chain over its segments and stores it to scratch slice
// 0, each later group stores every segment's f(psum) to a slice of its
// own, and the tile's last block to arrive continues the chain from slice
// 0 over the later segments in order — so every plan gives the single pass's
// bits, gate included, and a split of M (micros, data parallelism) gives
// each row the same bits. One launch a call. At gemma3-1b's seven shapes
// (M = 2048, crossbar 256; waves = blocks over 132 SMs x blocks an SM) it
// plans wq 128 rows, 128 blocks (0.97 waves); wk and wv 32 rows in 2
// groups, 256 blocks (0.97, two an SM); wo and w_down 128 rows, 144 blocks
// (1.09); w_gate and w_up 128 rows, 864 blocks (6.55). Measured on an H100
// 80GB HBM3 at 700 W (tools/profile_k1_mma.py; PERF.md): 0.28 ms at
// w_gate, 130 TFLOP/s, against 3.06 for the tile kernel and 0.054 for
// torch.matmul.
//
// K4 replaces the q8 bodies of the same launcher, `_q8_kernel` and
// `_q8_kernel_with_gate` (`_seg_psum_q8`; entry `cadc_matmul_q8_pallas`):
// x_q int8 [M, D] activation codes times w int8 codes ({-1, 0, 1} ternary
// in the models) give an exact int32 psum per segment, dequantized once as
// float(p) * scale — scale fp32, read from device memory, so no host sync
// is needed per layer — then f, then the sequential fp32 sum; K4g adds the
// gate epilogue, from the dequantized psum, in K1g's layouts. Every
// rounding after the dequantization is explicit (__fmul_rn, dendritic_rn,
// __fadd_rn in segment order), so the result is bitwise the plain
// version's under every plan.
//
// Bound on this card: at the models' FC shapes (M = the eval batch 128 or
// 32, D <= 4096, N <= 512) the bytes (int8 x and w, fp32 y: 0.18 us at
// VGG-16's f1) and the int8 operations (2*M*D*N at the int8 tensor-core
// peak: 0.03 us) are far below the launch itself (~1.3 us for a one-element
// kernel under graph replay) and one round trip to memory: K4 is bound by
// latency.
//
// Design (`q8_mma_kernel`, kernels/cadc_matmul.py `plan_fwd_q8`). A block
// owns a 16 x 32 tile of y (one m16 row of mma tiles, one packed gate
// word of columns) and 8 warps; each warp computes the whole tile for its
// own segments, so the segments of a tile run in parallel instead of one
// after another: warp w takes segments w, w + 8, ... in rounds. A warp
// stages each 64-code chunk of its segment through its own 3-stage ring
// (16-byte cp.async of x's rows and of w's rows where they lie on 16
// bytes; 4-byte copies where N is a multiple of 4; for N <= 32, as the
// class counts 10 and 11 are, the chunk's rows of w are one contiguous
// span of 64*N bytes, copied 16 bytes at a time; byte loads otherwise;
// everything past the segment's end, M or N zero-filled). w [D, N] is
// row-major, and mma's B operand wants each column's codes contiguous:
// the warp transposes its chunk in shared memory (4 x 4 byte blocks by
// __byte_perm; the span gathered column by column), reads x and w^T by
// ldmatrix.x4 and runs mma.sync m16n8k32 s8 x s8 -> s32 into psums that
// start at the bits of 1.5 * 2^23, so one exact fp32 subtraction gives
// float(p) while |p| <= 2^22 (xbar <= 256; K5's trick, cadc_conv.cu), else
// __int2float_rn. At a segment's end the warp dequantizes, writes the gate
// (the packed word by two quad shuffles) and applies f (one copy of the
// epilogue per fn). The planner picks, from the shapes alone, the single
// pass — every segment in one block; after each round the warps' f(psum)
// tiles are added in segment order in shared memory, no scratch — or a
// split of the segments over blocks in groups, whose f(psum) tiles go to
// an fp32 [S, M, N] scratch and are added in order by the last block of
// the tile to arrive (cadc_tile.cuh `arrive_last`). Both are the plain
// version's chain of additions, so every plan gives the same bits. The
// single pass takes VGG-16's and ResNet-18's FCs (8 segments at xbar 64:
// one round); the SNN's 64 segments split into groups. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md; tools/profile_k4.py): 3.8 us at
// VGG-16's f1 against 20.9 for the int8 tile kernel this replaced and
// 21.6 for torch._int_mm, of which the launch and the loads' round trip
// take 3.6 (a copy that only loads); the transpose of a narrow span costs
// ~0.8 us at ResNet-18's fc, the merge of a split ~2 us at the SNN's.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "cadc_tile.cuh"

namespace {

using cadc::kMagicBits;
using cadc::kMagicF;
using cadc::kMagicMaxXbar;
using cadc::kThreads;
using cadc::ld_bf16_bits;
using cadc::ldsm4;
using cadc::ldsm4_t;
using cadc::mma_bf16;
using cadc::mma_s8;

// Plan kernels (kernels/cadc_matmul.py PLAN_KERNELS).
enum PlanKernel : int { kTile = 0, kStream = 1, kMma = 2 };

constexpr int kStreamRows = 8;      // rows of x the stream kernel holds
constexpr int kStreamThreads = 128;  // threads of a stream-kernel block
constexpr int kStreamDepth = 8;      // rows of w a thread keeps in flight
constexpr int kStreamPdl = 1;        // launch as a programmatic dependent

// X(m, d) of a row-major x [M, D], widened to the psum's type.
template <typename T, typename Acc>
struct RowMajor {
  const T* x;
  size_t D;
  __device__ __forceinline__ Acc operator()(int m, int d) const {
    return cadc::widen<Acc>(x[static_cast<size_t>(m) * D + d]);
  }
};

// The 16 bytes at p = &row[c] of a row of N elements (w, or x's segment):
// one vector load (kVec: every row starts 16-byte aligned), or the same
// elements as scalars with the columns >= N masked to 0, packed alike.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load16(const T* p, int c, int N) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t u[4];
    if constexpr (sizeof(T) == 2) {
      const unsigned short* b = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = c + 2 * j < N ? b[2 * j] : 0u;
        const uint32_t hi = c + 2 * j + 1 < N ? b[2 * j + 1] : 0u;
        u[j] = lo | (hi << 16);
      }
    } else {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = c + j < N ? b[j] : 0u;
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// 16 bytes of w as fp32 columns (bf16 widened exactly by its bits).
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[16 / sizeof(T)]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 2) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    } else {
      f[j] = __uint_as_float(u[j]);
    }
  }
}

// A select between two registers by bits, which the compiler cannot turn
// into an indexed (local-memory) access of the array they come from.
__device__ __forceinline__ float pick(bool hi, float a, float b) {
  const unsigned mask = hi ? 0xffffffffu : 0u;
  return __uint_as_float((__float_as_uint(a) & ~mask) |
                         (__float_as_uint(b) & mask));
}

// 16 bytes from global to shared memory without passing through
// registers (cp.async, L2 only); 0 bytes read and zeros written when !pred.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void copy16_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void copy16_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One round of a warp's reduce-scatter: lanes that differ in bit `off` swap
// halves of their kHalf*2 psums; each keeps its half, summed with the
// partner's (its own first, in a fixed order).
template <int kHalf, int kN>
__device__ __forceinline__ void scatter_round(float (&acc)[kN], bool upper,
                                              int off) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = pick(upper, acc[i + kHalf], acc[i]);
    const float keep = pick(upper, acc[i], acc[i + kHalf]);
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// K1 at decode. Block (strip, 0, segment s): columns n0 .. n0 + kLanes*V - 1
// of y for M <= 8 rows. Thread (group, lane) owns the V columns of its
// 16-byte vector and rows k = group, group + kGroups, ... of the segment;
// it keeps the next kStreamDepth of them in flight in its own slots of a
// ring in shared memory (cp.async; kVec) and reads back only its own
// slots, so the ring needs no barrier. Without kVec the same ring is filled
// by scalar loads. Shared memory: x's segment as fp32 [xbar][8], the ring,
// and afterwards (reused) the warps' psums [warp][lane][8 * V].
template <typename T, int kLanes, bool kVec>
__global__ void __launch_bounds__(kStreamThreads, 4)  // <= 128 registers
stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
              float* __restrict__ y, float* __restrict__ scratch,
              int* __restrict__ counters, int M, int N, int S, int xbar,
              int fn) {
  constexpr int kT = kStreamThreads;
  constexpr int kB = kStreamDepth;
  constexpr int V = 16 / sizeof(T);
  constexpr int R = kStreamRows;
  constexpr int RV = R * V;  // psums a thread holds
  constexpr int kGroups = kT / kLanes;
  constexpr int kStrip = kLanes * V;
  constexpr int kWarps = kT / 32;
  static_assert(kLanes == 4 || kLanes == 8, "strips of 4 or 8 vectors");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint4* ring = reinterpret_cast<uint4*>(smem + xbar * R);

  const int s = blockIdx.z;
  const int n0 = blockIdx.x * kStrip;
  const int lane = threadIdx.x % 32;
  const int group = threadIdx.x / kLanes;
  const int c = n0 + (threadIdx.x % kLanes) * V;
  const bool live = c < N;
  const size_t D = static_cast<size_t>(S) * xbar;
  const T* wp = w + static_cast<size_t>(s) * xbar * N + c;
  const T* xs = x + static_cast<size_t>(s) * xbar;
  const int rows = (xbar - group + kGroups - 1) / kGroups;  // this thread's
  // Launched as a programmatic dependent: wait here, before any memory
  // access, until the previous kernel on the stream has finished and its
  // writes are visible (its blocks may have let this grid start early).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  auto refill = [&](int j) {  // row j of this thread into ring slot j % kB
    uint4* slot = ring + (j % kB) * kT + threadIdx.x;
    const bool ok = live && j < rows;
    const T* src = wp + static_cast<size_t>(group + j * kGroups) * N;
    if constexpr (kVec) {
      copy16(slot, ok ? static_cast<const void*>(src)
                      : static_cast<const void*>(w), ok);
      copy16_commit();
    } else {
      *slot = ok ? load16<T, false>(src, c, N) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // x's segment -> fp32 [xbar][8] (rows >= M zero), 16 bytes a load, four
  // loads a thread at a time, m fastest (few bank conflicts).
  const int nvec = R * ((xbar + V - 1) / V);
  uint4 xv[4];
  auto load_x = [&](int e0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kT;
      const int m = e % R, k = e / R * V;
      xv[j] = e < nvec && m < M
                  ? load16<T, kVec>(xs + m * D + k, k, xbar)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_x = [&](int e0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kT;
      if (e >= nvec) break;
      const int m = e % R, k = e / R * V;
      float f[V];
      unpack16<T>(xv[j], f);
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (k + v < xbar) smem[(k + v) * R + m] = f[v];
    }
  };
  load_x(threadIdx.x);  // x (from L2) first, then the ring (from HBM)
#pragma unroll
  for (int j = 0; j < kB; ++j) refill(j);
  store_x(threadIdx.x);
  for (int e0 = threadIdx.x + 4 * kT; e0 < nvec; e0 += 4 * kT) {
    load_x(e0);
    store_x(e0);
  }
  __syncthreads();

  float acc[RV];
#pragma unroll
  for (int i = 0; i < RV; ++i) acc[i] = 0.f;
  for (int j = 0; j < rows; ++j) {
    if constexpr (kVec) copy16_wait<kB - 1>();  // row j has landed
    const int k = group + j * kGroups;
    const float4 lo = *reinterpret_cast<const float4*>(smem + k * R);
    const float4 hi = *reinterpret_cast<const float4*>(smem + k * R + 4);
    const float xr[R] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float wv[V];
    unpack16<T>(ring[(j % kB) * kT + threadIdx.x], wv);
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[m * V + v] = fmaf(xr[m], wv[v], acc[m * V + v]);
    refill(j + kB);  // into the slot just read
  }
  if constexpr (kVec) copy16_wait<0>();
  // Let the next kernel's blocks be scheduled (they wait at their top).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The row groups of a warp: a reduce-scatter over xor partners (each
  // round halves the psums a lane holds; each sum is formed in one lane,
  // in a fixed order). Lane ends with RV >> kRounds psums from `first`.
  constexpr int kRounds = kLanes == 8 ? 2 : 3;
  const bool up0 = lane & kLanes, up1 = lane & (kLanes << 1),
             up2 = lane & (kLanes << 2);
  scatter_round<RV / 2>(acc, up0, kLanes);
  scatter_round<RV / 4>(acc, up1, kLanes << 1);
  if constexpr (kRounds == 3) scatter_round<RV / 8>(acc, up2, kLanes << 2);
  const int first = (up0 ? RV / 2 : 0) + (up1 ? RV / 4 : 0) +
                    (kRounds == 3 && up2 ? RV / 8 : 0);
  __syncthreads();  // x and the ring are no longer read: reuse them
  {
    float* r = smem + (threadIdx.x / 32 * kLanes + lane % kLanes) * RV + first;
#pragma unroll
    for (int i = 0; i < (RV >> kRounds); ++i) r[i] = acc[i];
  }
  __syncthreads();
  // The warps in order; then f.
  float* out = scratch ? scratch + static_cast<size_t>(s) * M * N : y;
  for (int e = threadIdx.x; e < R * kStrip; e += kT) {
    const int m = e / kStrip, col = e % kStrip;
    const int n = n0 + col;
    if (m >= M || n >= N) continue;
    const float* r = smem + (col / V) * RV + m * V + col % V;
    float p = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) p += r[wi * kLanes * RV];
    out[static_cast<size_t>(m) * N + n] = cadc::dendritic(fn, p);
  }
  if (scratch)
    cadc::ordered_segment_sum<R * kStrip / kT>(
        scratch, y, counters + blockIdx.x, S, M, N, 0, R, n0, kStrip);
}

template <typename T, int kLanes>
int launch_stream(const void* x, const void* w, void* y, float* scratch,
                  int* counters, int M, int N, int S, int xbar, int fn,
                  cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int x_bytes =
      xbar * kStreamRows * 4 + kStreamDepth * kStreamThreads * 16;
  const int red_bytes = (kStreamThreads / 32) * kLanes * kStreamRows * V * 4;
  const int smem = x_bytes > red_bytes ? x_bytes : red_bytes;
  if (M > kStreamRows || smem > 32 * 1024 ||
      (S > 1) != (scratch != nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kLanes * V - 1) / (kLanes * V), 1, S);
  const bool vec = N % V == 0 && xbar % V == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  float* yp = static_cast<float*>(y);
  // Programmatic dependent launch: the grid may be scheduled while the
  // previous kernel's last blocks finish (the kernel waits for it).
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = kStreamPdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kStreamThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, stream_kernel<T, kLanes, true>, xp, wp,
                               yp, scratch, counters, M, N, S, xbar, fn)
          : cudaLaunchKernelEx(&cfg, stream_kernel<T, kLanes, false>, xp, wp,
                               yp, scratch, counters, M, N, S, xbar, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stream_by_lanes(const void* x, const void* w, void* y, float* scratch,
                    int* counters, int M, int N, int S, int xbar, int fn,
                    int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 4:
      return launch_stream<T, 4>(x, w, y, scratch, counters, M, N, S,
                                         xbar, fn, stream);
    case 8:
      return launch_stream<T, 8>(x, w, y, scratch, counters, M, N, S,
                                         xbar, fn, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename Acc, int BM, int BN, int TM, int TN,
          bool kGate>
int launch_tile(const void* x, const void* w, const float* scale, void* y,
                float* scratch, int* counters, void* gate, int M, int N,
                int S, int xbar, int fn, int gate_kind, cudaStream_t stream) {
  const int D = S * xbar;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, scratch ? S : 1);
  const RowMajor<T, Acc> xl{static_cast<const T*>(x), static_cast<size_t>(D)};
  const T* wp = static_cast<const T*>(w);
  float* yp = static_cast<float*>(y);
  if (scratch)
    cadc::fwd_tile_kernel<T, Acc, BM, BN, TM, TN, kGate, true,
                          RowMajor<T, Acc>>
        <<<grid, kThreads, 0, stream>>>(xl, wp, yp, scratch, counters, gate,
                                        M, N, D, S, xbar, fn, gate_kind,
                                        scale);
  else
    cadc::fwd_tile_kernel<T, Acc, BM, BN, TM, TN, kGate, false,
                          RowMajor<T, Acc>>
        <<<grid, kThreads, 0, stream>>>(xl, wp, yp, nullptr, nullptr, gate,
                                        M, N, D, S, xbar, fn, gate_kind,
                                        scale);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel with BM = rows (8 or 64) x 64 columns.
template <typename T, typename Acc, bool kGate>
int tile_by_rows(const void* x, const void* w, const float* scale, void* y,
                 float* scratch, int* counters, void* gate, int M, int N,
                 int S, int xbar, int fn, int gate_kind, int rows,
                 cudaStream_t stream) {
  if (rows == 8)
    return launch_tile<T, Acc, 8, 64, 1, 2, kGate>(
        x, w, scale, y, scratch, counters, gate, M, N, S, xbar, fn, gate_kind,
        stream);
  if (rows == 64)
    return launch_tile<T, Acc, 64, 64, 4, 4, kGate>(
        x, w, scale, y, scratch, counters, gate, M, N, S, xbar, fn, gate_kind,
        stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename Acc>
int tile_by_gate(const void* x, const void* w, const void* scale, void* y,
                 void* scratch, void* counters, void* gate, int M, int N,
                 int S, int xbar, int fn, int gate_kind, int rows,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* scr = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  if (gate_kind == cadc::kGateNone)
    return tile_by_rows<T, Acc, false>(x, w, sc, y, scr, cnt, nullptr, M, N,
                                       S, xbar, fn, gate_kind, rows, st);
  return tile_by_rows<T, Acc, true>(x, w, sc, y, scr, cnt, gate, M, N, S,
                                    xbar, fn, gate_kind, rows, st);
}

// ---------------------------------------------------------------------------
// K1 / K1g on bf16 operands: the tensor-core kernel
// ---------------------------------------------------------------------------

// How a slice of w's rows is staged (MmaMat::wmode): 16-byte cp.async (w
// on 16 bytes, N a multiple of 8), 4-byte cp.async (w on 4 bytes, N even:
// the sLSTM's N = 2730), or 2-byte loads through registers.
enum MmaWMode : int { kMmaW16 = 0, kMmaW4 = 1, kMmaW2 = 2 };

// A bf16 K1 / K1g launch: x [M, S*xbar] and w [S*xbar, N] bf16, row-major;
// y [M, N] fp32; scratch [S - per + 1, M, N] fp32 (per = ceil(S / groups):
// group 0's chain, then each later segment) and the arrival counters when
// the segments are split over blocks in groups (grid z > 1), else NULL.
// xvec: x's rows are read by 16-byte cp.async (x on 16 bytes), else by
// 2-byte loads.
struct MmaMat {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  float* y;
  float* scratch;
  int* counters;
  void* gate;
  int M, N, S, xbar, fn, gate_kind, xvec, wmode;
};

constexpr int kMmaThreads = 256;   // 8 warps: 2 rows x 4 columns of warps
constexpr int kMmaCols = 128;      // columns of a block tile (a warp: 32)
constexpr int kMmaBK = 64;         // k of a staged slice: four k16 steps
constexpr int kMmaStages = 4;      // slices in the ring
constexpr int kMmaAStride = kMmaBK * 2 + 16;    // bytes of a staged x row
constexpr int kMmaBStride = kMmaCols * 2 + 16;  // bytes of a staged w row
constexpr int kMmaBBytes = kMmaBK * kMmaBStride;
constexpr int kMmaMergeLoads = 32;  // loads a thread keeps in flight merging

template <int BM>
struct MmaTile {
  static_assert(BM == 128 || BM == 32, "row tiles of 128 or 32");
  static constexpr int kMT = BM / 32;  // m16 tiles of a warp (2 warp rows)
  static constexpr int kABytes = BM * kMmaAStride;
  static constexpr int kStageBytes = kABytes + kMmaBBytes;
  // 128 rows keep the chain of f(psum) sums in shared memory (each thread
  // its own float4s), not in registers: 64 fp32 a thread fewer, which is
  // what keeps the gate's epilogue from spilling at 255 registers
  static constexpr bool kAccSmem = BM >= 128;
  static constexpr int kAccBytes = kAccSmem ? BM * kMmaCols * 4 : 0;
  static constexpr int kSmem = kMmaStages * kStageBytes + kAccBytes;
  static constexpr int kPer = BM * kMmaCols / kMmaThreads;  // merged a thread
  // the register cap of __launch_bounds__: 255 a thread, 128 for 32 rows
  static constexpr int kBlocksPerSm = BM >= 128 ? 1 : 2;
};

// Block (n tile, m tile, group z) computes the BM x 128 tile of y at (m0,
// n0) over its segments: all S (gridDim.z == 1, the single pass) or group
// z's ceil(S / gridDim.z). Warp (wm, wn) owns rows wm*BM/2 .. and columns
// 32*wn .. of the tile: kMT x 4 mma tiles of m16 x n8. The block walks its
// segments' kMmaBK-wide k slices in order through a kMmaStages ring in shared
// memory (cp.async by all threads; past M, N or the segment's end
// zero-filled; three slices in flight while one computes); each warp reads
// x by ldmatrix.x4 and w, k-major, by ldmatrix.x4.trans, and runs
// mma.sync m16n8k16 bf16 -> fp32 into its psum fragments: each psum one
// chain of k16 steps in increasing k. At a segment's end the warp writes
// the gate from the fp32 psums (the packed word by two quad shuffles, as
// K4), applies f (one copy of the epilogue per fn) and adds f(psum) into
// its accumulator fragments with __fadd_rn, in segment order from 0. In a
// split, group 0 keeps that chain over its segments and stores it to
// scratch slice 0; every later group stores each segment s's f(psum) to
// slice s - per + 1; the tile's last block to arrive (cadc_tile.cuh
// arrive_last) continues the chain from slice 0 over slices 1 .. in order.
// Every
// plan is thus the single pass's chain of additions: the same bits.
template <int BM, bool kGate>
__global__ void __launch_bounds__(kMmaThreads, MmaTile<BM>::kBlocksPerSm)
bf16_mma_kernel(const MmaMat p) {
  using Tile = MmaTile<BM>;
  constexpr int kMT = Tile::kMT, kNT = 4;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, q = lane % 4;  // an mma fragment's row, col pair
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kMmaCols;
  const size_t D = static_cast<size_t>(p.S) * p.xbar;
  const int kps = (p.xbar + kMmaBK - 1) / kMmaBK;  // slices a segment
  const int per = (p.S + gridDim.z - 1) / gridDim.z;
  const int lo = min(p.S, static_cast<int>(blockIdx.z) * per);
  const int hi = min(p.S, lo + per);
  const int n_slices = (hi - lo) * kps;
  const bool chain = blockIdx.z == 0;  // the single pass, or group 0

  // A thread's 16-byte copies of a slice sit at fixed places: x's at
  // column xc of rows xr, xr + kXStep, ...; w's at column wc of rows wr,
  // wr + kWStep, ... — each an add and a predicate a slice.
  constexpr int kXV = kMmaBK / 8;              // 16-byte chunks an x row
  constexpr int kXStep = kMmaThreads / kXV;
  constexpr int kXN = BM * kXV / kMmaThreads;  // x chunks a thread
  constexpr int kWV = kMmaCols / 8;            // 16-byte chunks a w row
  constexpr int kWStep = kMmaThreads / kWV;
  constexpr int kWN = kMmaBK / kWStep;         // w chunks a thread
  static_assert(kXN * kMmaThreads == BM * kXV && kWN * kWStep == kMmaBK,
                "a slice splits evenly over the threads");
  const int xr = tid / kXV, xc = 8 * (tid % kXV);
  const int wr = tid / kWV, wc = 8 * (tid % kWV);
  const __nv_bfloat16* xsrc = p.x + static_cast<size_t>(m0 + xr) * D + xc;
  const bool wcol = n0 + wc < p.N;

  // slice t of this block (segment lo + t / kps, k from (t % kps) * kMmaBK)
  // into ring slot t % kMmaStages; nothing past its last.
  const auto load = [&](int t) {
    if (t >= n_slices) return;
    unsigned char* as = mma_smem + (t % kMmaStages) * Tile::kStageBytes;
    unsigned char* bs = as + Tile::kABytes;
    const int k0 = (t % kps) * kMmaBK;
    const int kmax = p.xbar - k0;  // k < kmax lies in the segment
    const size_t d0 = static_cast<size_t>(lo + t / kps) * p.xbar + k0;
    if (p.xvec) {
#pragma unroll
      for (int j = 0; j < kXN; ++j) {
        const int r = xr + j * kXStep;
        const bool ok = m0 + r < p.M && xc < kmax;
        cadc::copy16(as + r * kMmaAStride + 2 * xc,
                     ok ? xsrc + j * kXStep * D + d0 : p.x, ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < BM * kMmaBK; e += kMmaThreads) {
        const int r = e / kMmaBK, c = e % kMmaBK;
        reinterpret_cast<unsigned short*>(as + r * kMmaAStride)[c] =
            m0 + r < p.M && c < kmax ? ld_bf16_bits(p.x + (m0 + r) * D + d0 + c)
                                     : 0;
      }
    }
    if (p.wmode == kMmaW16) {
      const __nv_bfloat16* wsrc = p.w + (d0 + wr) * p.N + n0 + wc;
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int r = wr + j * kWStep;
        const bool ok = r < kmax && wcol;
        cadc::copy16(bs + r * kMmaBStride + 2 * wc,
                     ok ? wsrc + static_cast<size_t>(j) * kWStep * p.N : p.w,
                     ok);
      }
    } else if (p.wmode == kMmaW4) {
      const int r0 = tid / 64, c = 2 * (tid % 64);
      const __nv_bfloat16* wsrc = p.w + (d0 + r0) * p.N + n0 + c;
#pragma unroll 4
      for (int j = 0; j < kMmaBK / 4; ++j) {
        const int r = r0 + 4 * j;
        const bool ok = r < kmax && n0 + c < p.N;
        cadc::copy4(bs + r * kMmaBStride + 2 * c,
                    ok ? wsrc + static_cast<size_t>(4 * j) * p.N : p.w, ok);
      }
    } else {
      const __nv_bfloat16* wrow = p.w + d0 * p.N + n0;
#pragma unroll 4
      for (int e = tid; e < kMmaBK * kMmaCols; e += kMmaThreads) {
        const int r = e / kMmaCols, c = e % kMmaCols;
        reinterpret_cast<unsigned short*>(bs + r * kMmaBStride)[c] =
            r < kmax && n0 + c < p.N
                ? ld_bf16_bits(wrow + static_cast<size_t>(r) * p.N + c)
                : 0;
      }
    }
  };

  float ps[kMT][kNT][4];   // the segment's psums
  // the chain of f(psum) over segments: in registers, or (kAccSmem) the
  // float4 of fragment (i, j) at acc4[(i * kNT + j) * 32]
  float acc[kMT][kNT][4];
  float4* acc4 = reinterpret_cast<float4*>(
                     mma_smem + kMmaStages * Tile::kStageBytes) +
                 warp * kMT * kNT * 32 + lane;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if constexpr (Tile::kAccSmem) {
        acc4[(i * kNT + j) * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }

#pragma unroll
  for (int j = 0; j < kMmaStages - 1; ++j) {
    load(j);
    cadc::copy_commit();
  }
  for (int t = 0; t < n_slices; ++t) {
    cadc::copy_wait<kMmaStages - 2>();
    __syncthreads();  // slice t landed; every warp is done with t - 1
    load(t + kMmaStages - 1);  // into t - 1's slot
    cadc::copy_commit();
    const int kt = t % kps;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[i][j][e] = 0.f;
    }
    const unsigned char* as = mma_smem + (t % kMmaStages) * Tile::kStageBytes;
    const unsigned char* bs = as + Tile::kABytes;
    // one k16 step: B's k rows 0-7 / 8-15 (b0 / b1) of n8 tiles 2np and
    // 2np + 1, then A's rows 0-15 x k 0-7 / 8-15 (a0 a1 / a2 a3) of each
    // m16 tile and its four mma
    const auto k16 = [&](int kk) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];
        ldsm4_t(r, bs + (kk * 16 + lane % 8 + (lane / 8 % 2) * 8) *
                           kMmaBStride +
                       (wn * 32 + np * 16 + (lane / 16) * 8) * 2);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
        cadc::ldsm4(a, as + (wm * (BM / 2) + i * 16 + lane % 16) *
                                kMmaAStride +
                           kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(ps[i][j], a, b[j][0], b[j][1]);
      }
    };
    const int steps = min(kMmaBK, p.xbar - kt * kMmaBK) / 16;
    if (steps == kMmaBK / 16) {
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) k16(kk);
    } else {  // the segment ends inside this slice
#pragma unroll 1
      for (int kk = 0; kk < steps; ++kk) k16(kk);
    }
    if (kt != kps - 1) continue;
    // segment s done: its gate, f, and the chain or its scratch slice
    const int s = lo + t / kps;
    const auto seg_done = [&](auto fn_id) {
      constexpr int kFn = decltype(fn_id)::value;
      if constexpr (kGate) {
        if (p.gate_kind == cadc::kGatePacked) {
          // lane (g, q) holds columns 2q, 2q+1 of each n8 tile of rows g
          // and g+8: a warp's 32 columns are one word a row
          const int nw_all = (p.N + cadc::kPack - 1) / cadc::kPack;
          const int word = n0 / cadc::kPack + wn;
          uint32_t* words = static_cast<uint32_t*>(p.gate) +
                            static_cast<size_t>(s) * p.M * nw_all;
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + wm * (BM / 2) + i * 16 + h * 8 + g;
              uint32_t bits = 0;
#pragma unroll
              for (int j = 0; j < kNT; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  if (cadc::dendritic_grad(kFn, ps[i][j][2 * h + c]) != 0.f)
                    bits |= 1u << (8 * j + 2 * q + c);
              bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
              bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
              if (q == 0 && m < p.M && word < nw_all)
                words[static_cast<size_t>(m) * nw_all + word] = bits;
            }
        } else {
          const size_t base = static_cast<size_t>(s) * p.M * p.N;
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm * (BM / 2) + i * 16 + (e / 2) * 8 + g;
                const int n = n0 + wn * 32 + j * 8 + 2 * q + e % 2;
                if (m >= p.M || n >= p.N) continue;
                const float gv = cadc::dendritic_grad(kFn, ps[i][j][e]);
                const size_t at = base + static_cast<size_t>(m) * p.N + n;
                if (p.gate_kind == cadc::kGateU8)
                  static_cast<uint8_t*>(p.gate)[at] = gv != 0.f;
                else
                  static_cast<float*>(p.gate)[at] = gv;
              }
        }
      }
      if (chain) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if constexpr (Tile::kAccSmem) {
              float4 a = acc4[(i * kNT + j) * 32];
              a.x = __fadd_rn(a.x, cadc::dendritic(kFn, ps[i][j][0]));
              a.y = __fadd_rn(a.y, cadc::dendritic(kFn, ps[i][j][1]));
              a.z = __fadd_rn(a.z, cadc::dendritic(kFn, ps[i][j][2]));
              a.w = __fadd_rn(a.w, cadc::dendritic(kFn, ps[i][j][3]));
              acc4[(i * kNT + j) * 32] = a;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][j][e] = __fadd_rn(acc[i][j][e],
                                         cadc::dendritic(kFn, ps[i][j][e]));
            }
          }
      } else {
        float* dst =
            p.scratch + static_cast<size_t>(s - per + 1) * p.M * p.N;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = m0 + wm * (BM / 2) + i * 16 + (e / 2) * 8 + g;
              const int n = n0 + wn * 32 + j * 8 + 2 * q + e % 2;
              if (m < p.M && n < p.N)
                dst[static_cast<size_t>(m) * p.N + n] =
                    cadc::dendritic(kFn, ps[i][j][e]);
            }
      }
    };
    switch (p.fn) {
      case 0: seg_done(std::integral_constant<int, 0>{}); break;
      case 1: seg_done(std::integral_constant<int, 1>{}); break;
      case 2: seg_done(std::integral_constant<int, 2>{}); break;
      case 3: seg_done(std::integral_constant<int, 3>{}); break;
      default: seg_done(std::integral_constant<int, 4>{}); break;
    }
  }
  cadc::copy_wait<0>();

  if (chain) {  // y, or in a split slice 0: the chain over group 0
    float* out = gridDim.z > 1 ? p.scratch : p.y;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if constexpr (Tile::kAccSmem) {
          const float4 a = acc4[(i * kNT + j) * 32];
          acc[i][j][0] = a.x;
          acc[i][j][1] = a.y;
          acc[i][j][2] = a.z;
          acc[i][j][3] = a.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * (BM / 2) + i * 16 + (e / 2) * 8 + g;
          const int n = n0 + wn * 32 + j * 8 + 2 * q + e % 2;
          if (m < p.M && n < p.N)
            out[static_cast<size_t>(m) * p.N + n] = acc[i][j][e];
        }
      }
  }
  if (gridDim.z == 1) return;
  // the tile's last block to arrive continues the chain over the later
  // groups' segments, in order
  int* tile_counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (!cadc::arrive_last(tile_counter, gridDim.z)) return;
  // kChunk outputs a thread at a time, kSeg segments' loads in flight
  constexpr int kChunk = 16;
  constexpr int kSeg = kMmaMergeLoads / kChunk;
  static_assert(Tile::kPer % kChunk == 0, "whole chunks a thread");
  const size_t mn = static_cast<size_t>(p.M) * p.N;  // a split: < 2^31
#pragma unroll 1
  for (int c0 = 0; c0 < Tile::kPer; c0 += kChunk) {
    bool ok[kChunk];
    int at[kChunk];
    float a[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int e = tid + (c0 + i) * kMmaThreads;
      const int m = m0 + e / kMmaCols, n = n0 + e % kMmaCols;
      ok[i] = m < p.M && n < p.N;
      at[i] = ok[i] ? m * p.N + n : 0;
      a[i] = ok[i] ? __ldcg(p.scratch + at[i]) : 0.f;
    }
    for (int s0 = per; s0 < p.S; s0 += kSeg) {
      float v[kSeg][kChunk];
#pragma unroll
      for (int u = 0; u < kSeg; ++u)
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          v[u][i] = ok[i] && s0 + u < p.S
                        ? __ldcg(p.scratch + (s0 + u - per + 1) * mn + at[i])
                        : 0.f;
#pragma unroll
      for (int u = 0; u < kSeg; ++u)
        if (s0 + u < p.S)
#pragma unroll
          for (int i = 0; i < kChunk; ++i) a[i] = __fadd_rn(a[i], v[u][i]);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (ok[i]) p.y[at[i]] = a[i];
  }
  if (tid == 0) *tile_counter = 0;
}

template <int BM, bool kGate>
int launch_mma(const MmaMat& p, int groups, cudaStream_t stream) {
  static std::atomic<uint64_t> opted_in{0};
  constexpr int smem = MmaTile<BM>::kSmem;
  if (const int e = cadc::opt_in(bf16_mma_kernel<BM, kGate>, smem, opted_in))
    return e;
  const dim3 grid((p.N + kMmaCols - 1) / kMmaCols, (p.M + BM - 1) / BM,
                  groups);
  bf16_mma_kernel<BM, kGate><<<grid, kMmaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tensor-core kernel with `rows` (128 or 32) rows a block tile
// over `groups` segment groups (1: the single pass, scratch NULL; more:
// scratch [S - ceil(S / groups) + 1, M, N] and the counters, 1 < groups <=
// S). xbar must be a multiple of 16 (whole k16 steps a segment).
int mma_launch(const void* x, const void* w, void* y, void* scratch,
               void* counters, void* gate, int M, int N, int S, int xbar,
               int fn, int gate_kind, int rows, int groups, void* stream) {
  if (xbar % 16 || groups < 1 || groups > S ||
      (groups > 1) != (scratch != nullptr) || (scratch && !counters) ||
      (scratch && static_cast<size_t>(M) * N >= (size_t{1} << 31)) ||
      gate_kind < cadc::kGateNone || gate_kind > cadc::kGateF32 ||
      (gate_kind != cadc::kGateNone && !gate))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const MmaMat p{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const __nv_bfloat16*>(w),
                 static_cast<float*>(y),
                 static_cast<float*>(scratch),
                 static_cast<int*>(counters),
                 gate, M, N, S, xbar, fn, gate_kind,
                 reinterpret_cast<uintptr_t>(x) % 16 == 0,
                 wa % 16 == 0 && N % 8 == 0  ? kMmaW16
                 : wa % 4 == 0 && N % 2 == 0 ? kMmaW4
                                             : kMmaW2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gate_kind != cadc::kGateNone;
  switch (rows) {
    case 128:
      return g ? launch_mma<128, true>(p, groups, st)
               : launch_mma<128, false>(p, groups, st);
    case 32:
      return g ? launch_mma<32, true>(p, groups, st)
               : launch_mma<32, false>(p, groups, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K4 / K4g: the int8 tensor-core kernel
// ---------------------------------------------------------------------------

// How a chunk of w's rows is staged (Q8Mat::wmode): 16-byte or 4-byte
// cp.async of each row's 32 columns (w on that many bytes, N a multiple of
// it); the rows' whole span, N <= 32 bytes a row, packed, by 16-byte
// cp.async (w on 16 bytes, xbar % 16 == 0: the class counts, N = 10, 11);
// or byte loads.
enum Q8WMode : int { kW16 = 0, kWSpan = 1, kW4 = 2, kWBytes = 3 };

// A K4 launch: x [M, S*xbar] and w [S*xbar, N] int8 codes, row-major, as
// the caller holds them; scale one fp32 in device memory; y [M, N] fp32;
// scratch [S, M, N] fp32 and the arrival counters when the segments are
// split over blocks (grid z > 1), else NULL. xvec: x's rows are read by
// 16-byte cp.async (x on 16 bytes, xbar % 16 == 0), else by byte loads.
struct Q8Mat {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  float* y;
  float* scratch;
  int* counters;
  void* gate;
  int M, N, S, xbar, fn, gate_kind, xvec, wmode;
};

constexpr int kQ8Rows = 16;     // rows of a tile (one m16 mma tile)
constexpr int kQ8Cols = 32;     // columns of a tile: one packed gate word
constexpr int kQ8Warps = 8;     // warps of a block, each on its segments
constexpr int kQ8Threads = 32 * kQ8Warps;
constexpr int kQ8Chunk = 64;    // codes of a segment a warp stages at once
constexpr int kQ8Stages = 3;    // chunks in a warp's ring
constexpr int kQ8XStride = kQ8Chunk + 16;  // bytes of a staged x row
constexpr int kQ8WStride = kQ8Cols + 16;   // bytes of a staged w row (k)
constexpr int kQ8TStride = kQ8Chunk + 16;  // bytes of a transposed w row (n)
constexpr int kQ8SumStride = kQ8Cols + 8;  // floats of a row of f(psum)
constexpr int kQ8XBytes = kQ8Rows * kQ8XStride;
constexpr int kQ8StageBytes = kQ8XBytes + kQ8Chunk * kQ8WStride;
constexpr int kQ8WarpBytes = kQ8Stages * kQ8StageBytes + kQ8Cols * kQ8TStride;
constexpr int kQ8RingBytes = kQ8Warps * kQ8WarpBytes;
constexpr int kQ8SumBytes = kQ8Warps * kQ8Rows * kQ8SumStride * 4;
constexpr int kQ8Per = kQ8Rows * kQ8Cols / kQ8Threads;  // outputs a thread
constexpr int kQ8MergeSegs = 32;  // segments whose loads the merge overlaps
static_assert(kQ8Per * kQ8Threads == kQ8Rows * kQ8Cols, "outputs split");
static_assert(kQ8RingBytes % 16 == 0, "f(psum) rows on 16 bytes");

// 4 bytes of a row of x or w from byte `at` on, those at >= `end` zero:
// the unaligned loader.
__device__ __forceinline__ uint32_t bytes4(const int8_t* src, int at,
                                           int end) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (at + b < end)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + b)))
           << (8 * b);
  return v;
}

// A staged chunk of w, [64 codes k][32 columns n] (rows kQ8WStride bytes
// apart), into the [32 n][64 k] layout mma's B operand is read from (rows
// kQ8TStride apart): lane (r, h) takes the 4 x 16 bytes of rows 4r .. 4r+3,
// columns 16h .. 16h+15, and writes them back as 16 words of 4 k each, four
// 4 x 4 byte transposes of two __byte_perm rounds.
__device__ __forceinline__ void transpose_w(const unsigned char* ws,
                                            unsigned char* wt, int lane) {
  const int r = lane / 2, h = lane % 2;
  uint4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = *reinterpret_cast<const uint4*>(ws + (4 * r + j) * kQ8WStride +
                                           16 * h);
  const auto word = [](const uint4& u, int i) {
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  };
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t a = word(v[0], c), b = word(v[1], c), cc = word(v[2], c),
                   d = word(v[3], c);
    const uint32_t t0 = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
    const uint32_t t1 = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
    const uint32_t t2 = __byte_perm(cc, d, 0x5140);  // c0 d0 c1 d1
    const uint32_t t3 = __byte_perm(cc, d, 0x7362);  // c2 d2 c3 d3
    unsigned char* col = wt + (16 * h + 4 * c) * kQ8TStride + 4 * r;
    *reinterpret_cast<uint32_t*>(col) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(col + kQ8TStride) =
        __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(col + 2 * kQ8TStride) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(col + 3 * kQ8TStride) =
        __byte_perm(t1, t3, 0x7632);
  }
}

// The same from a packed span ([64 k][N] bytes, N <= 32): lane n gathers
// column n's 64 codes, 4 k a word, every load before the first store (the
// stores could alias them: interleaved, each word waited for its loads);
// columns n >= N are zero.
__device__ __forceinline__ void transpose_span(const unsigned char* ws,
                                               unsigned char* wt, int lane,
                                               int N) {
  uint32_t v[kQ8Chunk / 4];
#pragma unroll
  for (int kg = 0; kg < kQ8Chunk / 4; ++kg) {
    const unsigned char* src = ws + 4 * kg * N + lane;
    v[kg] = lane < N ? src[0] | (src[N] << 8) | (src[2 * N] << 16) |
                           (static_cast<uint32_t>(src[3 * N]) << 24)
                     : 0u;
  }
  uint4* row = reinterpret_cast<uint4*>(wt + lane * kQ8TStride);
#pragma unroll
  for (int i = 0; i < kQ8Chunk / 16; ++i)
    row[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Block (m tile, n tile, group z) computes the 16 x 32 tile at (m0, n0)
// over its segments: every segment (gridDim.z == 1, the single pass) or
// group z's ceil(S / gridDim.z). Warp w takes the group's segments w,
// w + 8, ... in rounds of 8; for each it walks the segment's 64-code
// chunks through its own 3-stage ring (cp.async where aligned, zero-filled
// past the segment's end and past M and N, the next two chunks in flight
// while one computes), transposes w's chunk in shared memory, and runs
// mma.sync m16n8k32 over it into int32 psums. At the segment's end the
// warp dequantizes, writes the gate, applies f (a copy of that code per
// fn) and stores f(psum): the single pass into its row of the block's
// f(psum) tiles, which after a barrier every thread adds to its outputs'
// sums in segment order (round by round, __fadd_rn, from 0); a split block
// into scratch[s], the tile's last block to arrive then adding the S tiles
// in order, 32 segments' loads in flight. Either way each output is the
// plain version's chain of additions, so every plan gives its bits.
template <bool kGate>
__global__ void __launch_bounds__(kQ8Threads, 1)
q8_mma_kernel(const Q8Mat p) {
  constexpr int kNT = kQ8Cols / 8;  // n8 mma tiles
  extern __shared__ __align__(16) unsigned char smem8[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;  // an mma fragment's row, column pair
  const int m0 = blockIdx.x * kQ8Rows, n0 = blockIdx.y * kQ8Cols;
  const size_t D = static_cast<size_t>(p.S) * p.xbar;
  const int kc = (p.xbar + kQ8Chunk - 1) / kQ8Chunk;  // chunks a segment
  const bool split = p.scratch != nullptr;
  const int per_group = (p.S + gridDim.z - 1) / gridDim.z;
  const int lo = blockIdx.z * per_group;
  const int hi = min(p.S, lo + per_group);
  const int rounds = hi > lo ? (hi - lo + kQ8Warps - 1) / kQ8Warps : 0;
  const int mine =
      lo + warp < hi ? (hi - lo - warp + kQ8Warps - 1) / kQ8Warps : 0;
  unsigned char* ring = smem8 + warp * kQ8WarpBytes;
  unsigned char* wt = ring + kQ8Stages * kQ8StageBytes;
  float* sums = reinterpret_cast<float*>(smem8 + kQ8RingBytes);

  // chunk j of this warp (segment lo + warp + (j / kc) * 8, codes from
  // (j % kc) * 64) into ring slot j % kQ8Stages; nothing past its last.
  const auto load = [&](int j) {
    if (j >= mine * kc) return;
    unsigned char* xs = ring + (j % kQ8Stages) * kQ8StageBytes;
    unsigned char* ws = xs + kQ8XBytes;
    const int s = lo + warp + (j / kc) * kQ8Warps;
    const int k0 = (j % kc) * kQ8Chunk;
    const int8_t* xseg = p.x + static_cast<size_t>(s) * p.xbar + k0;
    if (p.xvec) {
#pragma unroll
      for (int e = lane; e < kQ8Rows * 4; e += 32) {
        const int r = e / 4, part = 16 * (e % 4);
        const bool ok = m0 + r < p.M && k0 + part < p.xbar;
        cadc::copy16(xs + r * kQ8XStride + part,
                     ok ? xseg + (m0 + r) * D + part : p.x, ok);
      }
    } else {
      uint32_t v[kQ8Rows * 16 / 32];  // every load in flight, then stored
#pragma unroll
      for (int i = 0; i < kQ8Rows * 16 / 32; ++i) {
        const int e = lane + 32 * i, r = e / 16, at = 4 * (e % 16);
        v[i] = m0 + r < p.M ? bytes4(xseg + (m0 + r) * D + at, k0 + at,
                                     p.xbar)
                            : 0u;
      }
#pragma unroll
      for (int i = 0; i < kQ8Rows * 16 / 32; ++i) {
        const int e = lane + 32 * i;
        *reinterpret_cast<uint32_t*>(xs + (e / 16) * kQ8XStride +
                                     4 * (e % 16)) = v[i];
      }
    }
    const size_t row0 = static_cast<size_t>(s) * p.xbar + k0;  // of w
    const int8_t* wseg = p.w + row0 * p.N + n0;
    if (p.wmode == kWSpan) {
      // rows k0 .. k0+63 of all N columns, one contiguous span
      const int valid = min(kQ8Chunk, p.xbar - k0) * p.N;  // 16 | valid
      for (int e = lane; e < kQ8Chunk * p.N / 16; e += 32)
        cadc::copy16(ws + 16 * e, 16 * e < valid ? wseg + 16 * e : p.w,
                     16 * e < valid);
    } else if (p.wmode == kW16) {
#pragma unroll
      for (int e = lane; e < kQ8Chunk * 2; e += 32) {
        const int r = e / 2, c = 16 * (e % 2);
        const bool ok = k0 + r < p.xbar && n0 + c < p.N;
        cadc::copy16(ws + r * kQ8WStride + c,
                     ok ? wseg + static_cast<size_t>(r) * p.N + c : p.w, ok);
      }
    } else if (p.wmode == kW4) {
#pragma unroll 4
      for (int e = lane; e < kQ8Chunk * 8; e += 32) {
        const int r = e / 8, c = 4 * (e % 8);
        const bool ok = k0 + r < p.xbar && n0 + c < p.N;
        cadc::copy4(ws + r * kQ8WStride + c,
                    ok ? wseg + static_cast<size_t>(r) * p.N + c : p.w, ok);
      }
    } else {
#pragma unroll 1
      for (int i0 = 0; i0 < kQ8Chunk * 8 / 32; i0 += 8) {
        uint32_t v[8];  // 8 words' loads in flight, then stored
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = lane + 32 * (i0 + i), r = e / 8, c = 4 * (e % 8);
          v[i] = k0 + r < p.xbar
                     ? bytes4(wseg + static_cast<size_t>(r) * p.N + c,
                              n0 + c, p.N)
                     : 0u;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = lane + 32 * (i0 + i);
          *reinterpret_cast<uint32_t*>(ws + (e / 8) * kQ8WStride +
                                       4 * (e % 8)) = v[i];
        }
      }
    }
  };

  const bool magic = p.xbar <= kMagicMaxXbar;
  const int ps0 = magic ? kMagicBits : 0;
  const float sc = *p.scale;
  int ps[kNT][4];        // the segment's psum (+ kMagicBits)
  float acc[kQ8Per];     // the single pass: this thread's sums
#pragma unroll
  for (int i = 0; i < kQ8Per; ++i) acc[i] = 0.f;

#pragma unroll
  for (int j = 0; j < kQ8Stages - 1; ++j) {
    load(j);
    cadc::copy_commit();
  }
  int j = 0;  // the warp's chunk
  for (int rd = 0; rd < rounds; ++rd) {
    if (rd < mine) {
      const int s = lo + warp + rd * kQ8Warps;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[ni][e] = ps0;
      for (int c = 0; c < kc; ++c, ++j) {
        cadc::copy_wait<kQ8Stages - 2>();
        __syncwarp();  // chunk j landed; every lane is done with j - 1
        load(j + kQ8Stages - 1);
        cadc::copy_commit();
        const unsigned char* xs = ring + (j % kQ8Stages) * kQ8StageBytes;
        if (p.wmode == kWSpan)
          transpose_span(xs + kQ8XBytes, wt, lane, p.N);
        else
          transpose_w(xs + kQ8XBytes, wt, lane);
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kQ8Chunk / 32; ++kk) {
          if (c * kQ8Chunk + kk * 32 >= p.xbar) break;  // all zeros
          // A: rows 0-15 x bytes 0-15 / 16-31 (a0 a1 / a2 a3); B: columns
          // 0-7 / 8-15 of a pair of n8 tiles x bytes 0-15 / 16-31.
          uint32_t a[4], b[kNT][2];
          ldsm4(a, xs + (lane % 16) * kQ8XStride + kk * 32 + (lane / 16) * 16);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t r[4];
            ldsm4(r, wt + (np * 16 + lane % 8 + (lane / 16) * 8) * kQ8TStride +
                         kk * 32 + (lane / 8 % 2) * 16);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
            mma_s8(ps[ni], a, b[ni][0], b[ni][1]);
        }
      }
      // segment s done: v = float(psum) * scale, exactly as
      // __fmul_rn(__int2float_rn(p), scale); then its gate and f(v).
      float v[kNT][4];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[ni][e] = __fmul_rn(
              magic ? __fsub_rn(__int_as_float(ps[ni][e]), kMagicF)
                    : __int2float_rn(ps[ni][e]),
              sc);
      // f's id is a constant in each copy of this code (seg_end<kFn>).
      const auto seg_end = [&](auto fn_id) {
        constexpr int kFn = decltype(fn_id)::value;
        if constexpr (kGate) {
          if (p.gate_kind == cadc::kGatePacked) {
            // Lane (g, q) holds columns 2q, 2q+1 of each n8 tile of rows g
            // and g+8: the tile's 32-column word is the quad's 4 n8 tiles.
            const int nw_all = (p.N + cadc::kPack - 1) / cadc::kPack;
            uint32_t* words = static_cast<uint32_t*>(p.gate) +
                              static_cast<size_t>(s) * p.M * nw_all;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + h * 8 + g;
              uint32_t bits = 0;
#pragma unroll
              for (int u = 0; u < kNT; ++u)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  if (cadc::dendritic_grad(kFn, v[u][2 * h + c]) != 0.f)
                    bits |= 1u << (8 * u + 2 * q + c);
              bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
              bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
              if (q == 0 && m < p.M)
                words[static_cast<size_t>(m) * nw_all + n0 / cadc::kPack] =
                    bits;
            }
          } else {
            const size_t base = static_cast<size_t>(s) * p.M * p.N;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = m0 + (e / 2) * 8 + g;
                const int n = n0 + ni * 8 + 2 * q + e % 2;
                if (m >= p.M || n >= p.N) continue;
                const float gv = cadc::dendritic_grad(kFn, v[ni][e]);
                const size_t at = base + static_cast<size_t>(m) * p.N + n;
                if (p.gate_kind == cadc::kGateU8)
                  static_cast<uint8_t*>(p.gate)[at] = gv != 0.f;
                else
                  static_cast<float*>(p.gate)[at] = gv;
              }
          }
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[ni][e] = cadc::dendritic_rn(kFn, v[ni][e]);
      };
      switch (p.fn) {
        case 0: seg_end(std::integral_constant<int, 0>{}); break;
        case 1: seg_end(std::integral_constant<int, 1>{}); break;
        case 2: seg_end(std::integral_constant<int, 2>{}); break;
        case 3: seg_end(std::integral_constant<int, 3>{}); break;
        default: seg_end(std::integral_constant<int, 4>{}); break;
      }
      // f(psum): the split into scratch[s], the single pass into this
      // warp's row of tiles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h * 8 + g;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int col = ni * 8 + 2 * q;
          const float f0 = v[ni][2 * h], f1 = v[ni][2 * h + 1];
          if (split) {
            const int m = m0 + r, n = n0 + col;
            float* dst =
                p.scratch + (static_cast<size_t>(s) * p.M + m) * p.N + n;
            if (m < p.M && n < p.N) dst[0] = f0;
            if (m < p.M && n + 1 < p.N) dst[1] = f1;
          } else {
            *reinterpret_cast<float2*>(
                sums + (warp * kQ8Rows + r) * kQ8SumStride + col) =
                make_float2(f0, f1);
          }
        }
      }
    }
    if (!split) {
      // the round's segments lo + rd*8 .. added in order, 8 at most
      __syncthreads();
      const int live = min(kQ8Warps, hi - lo - rd * kQ8Warps);
#pragma unroll
      for (int i = 0; i < kQ8Per; ++i) {
        const int e = tid + i * kQ8Threads;
        const float* col =
            sums + (e / kQ8Cols) * kQ8SumStride + e % kQ8Cols;
        for (int w2 = 0; w2 < live; ++w2)
          acc[i] = __fadd_rn(acc[i], col[w2 * kQ8Rows * kQ8SumStride]);
      }
      __syncthreads();  // the tiles are read before the next round writes
    }
  }

  bool ok[kQ8Per];
  size_t at[kQ8Per];
#pragma unroll
  for (int i = 0; i < kQ8Per; ++i) {
    const int e = tid + i * kQ8Threads;
    const int m = m0 + e / kQ8Cols, n = n0 + e % kQ8Cols;
    ok[i] = m < p.M && n < p.N;
    at[i] = ok[i] ? static_cast<size_t>(m) * p.N + n : 0;
  }
  if (split) {
    // the last block of the tile to arrive adds its S tiles in order
    int* counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (!cadc::arrive_last(counter, gridDim.z)) return;
    const size_t mn = static_cast<size_t>(p.M) * p.N;
    for (int s0 = 0; s0 < p.S; s0 += kQ8MergeSegs) {
      float v[kQ8MergeSegs][kQ8Per];
#pragma unroll
      for (int t = 0; t < kQ8MergeSegs; ++t)
#pragma unroll
        for (int i = 0; i < kQ8Per; ++i)
          v[t][i] = ok[i] && s0 + t < p.S
                        ? __ldcg(p.scratch + (s0 + t) * mn + at[i])
                        : 0.f;
#pragma unroll
      for (int t = 0; t < kQ8MergeSegs; ++t)
        if (s0 + t < p.S)
#pragma unroll
          for (int i = 0; i < kQ8Per; ++i)
            acc[i] = __fadd_rn(acc[i], v[t][i]);
    }
    if (tid == 0) *counter = 0;
  }
#pragma unroll
  for (int i = 0; i < kQ8Per; ++i)
    if (ok[i]) p.y[at[i]] = acc[i];
}

template <bool kGate>
int launch_q8(const Q8Mat& p, int groups, cudaStream_t stream) {
  static std::atomic<uint64_t> opted_in{0};
  if (const int e = cadc::opt_in(q8_mma_kernel<kGate>,
                                 kQ8RingBytes + kQ8SumBytes, opted_in))
    return e;
  const dim3 grid((p.M + kQ8Rows - 1) / kQ8Rows,
                  (p.N + kQ8Cols - 1) / kQ8Cols, groups);
  const int smem = kQ8RingBytes + (p.scratch ? 0 : kQ8SumBytes);
  q8_mma_kernel<kGate><<<grid, kQ8Threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plan arguments: `scratch` NULL for the single pass, else an fp32
// [S, M, N] buffer for the split over segments, with `counters` the
// device's zeroed int32 arrival counters (one per output tile; the kernel
// leaves them zero). Each function returns the CUDA error code after its
// one launch (0 = success).

// K1. x [M, S*xbar] and w [S*xbar, N], row-major, both fp32 (dtype 0) or
// bf16 (dtype 1); y [M, N] fp32. kernel 0: the tile kernel with `width`
// (8 or 64) rows; kernel 1: the stream kernel (M <= 8, xbar <= 512) with
// `width` (4 or 8) 16-byte vectors per strip; kernel 2: the bf16
// tensor-core kernel with `width` (128 or 32) rows a tile over `groups`
// segment groups (the other kernels take groups = S where split, else 1).
extern "C" int cadc_matmul_launch(const void* x, const void* w, void* y,
                                  void* scratch, void* counters, int M,
                                  int N, int S, int xbar, int fn, int dtype,
                                  int kernel, int width, int groups,
                                  void* stream) {
  if (kernel == kMma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return mma_launch(x, w, y, scratch, counters, nullptr, M, N, S, xbar, fn,
                      cadc::kGateNone, width, groups, stream);
  }
  if (groups != (scratch ? S : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == kStream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* scr = static_cast<float*>(scratch);
    int* cnt = static_cast<int*>(counters);
    if (dtype == 0)
      return stream_by_lanes<float>(x, w, y, scr, cnt, M, N, S, xbar, fn,
                                    width, st);
    return stream_by_lanes<__nv_bfloat16>(x, w, y, scr, cnt, M, N, S, xbar,
                                          fn, width, st);
  }
  if (dtype == 0)
    return tile_by_gate<float, float>(x, w, nullptr, y, scratch, counters,
                                      nullptr, M, N, S, xbar, fn,
                                      cadc::kGateNone, width, stream);
  return tile_by_gate<__nv_bfloat16, float>(x, w, nullptr, y, scratch,
                                            counters, nullptr, M, N, S, xbar,
                                            fn, cadc::kGateNone, width,
                                            stream);
}

// K1g: K1 plus the gate, on the tile kernel (kernel 0) or, bf16 only, the
// tensor-core kernel (kernel 2; `width`, `groups` as K1's). gate_kind 1:
// uint32 words [S, M, ceil(N/32)]; 2: uint8 [S, M, N]; 3: fp32 [S, M, N].
extern "C" int cadc_matmul_gate_launch(const void* x, const void* w, void* y,
                                       void* scratch, void* counters,
                                       void* gate, int M, int N, int S,
                                       int xbar, int fn, int dtype,
                                       int gate_kind, int kernel, int width,
                                       int groups, void* stream) {
  if (gate_kind == cadc::kGateNone || !gate)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == kMma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return mma_launch(x, w, y, scratch, counters, gate, M, N, S, xbar, fn,
                      gate_kind, width, groups, stream);
  }
  if (kernel != kTile || groups != (scratch ? S : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return tile_by_gate<float, float>(x, w, nullptr, y, scratch, counters,
                                      gate, M, N, S, xbar, fn, gate_kind,
                                      width, stream);
  return tile_by_gate<__nv_bfloat16, float>(x, w, nullptr, y, scratch,
                                            counters, gate, M, N, S, xbar, fn,
                                            gate_kind, width, stream);
}

// K4 (gate_kind 0, gate NULL) and K4g (gate_kind 1-3, K1g's layouts):
// x_q [M, S*xbar] and w [S*xbar, N] int8, row-major; scale: one fp32 in
// device memory; y [M, N] fp32; the int8 tensor-core kernel over `groups`
// segment groups (1: the single pass, scratch NULL; more: scratch
// [S, M, N] and the counters, 1 < groups <= S).
extern "C" int cadc_matmul_q8_launch(const void* x, const void* w,
                                     const void* scale, void* y,
                                     void* scratch, void* counters,
                                     void* gate, int M, int N, int S,
                                     int xbar, int fn, int gate_kind,
                                     int groups, void* stream) {
  if (groups < 1 || groups > S || (groups > 1) != (scratch != nullptr) ||
      (scratch && !counters) || gate_kind < cadc::kGateNone ||
      gate_kind > cadc::kGateF32 || (gate_kind != cadc::kGateNone && !gate))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int wmode = wa % 16 == 0 && N % 16 == 0         ? kW16
                    : wa % 16 == 0 && N <= kQ8Cols && xbar % 16 == 0 ? kWSpan
                    : wa % 4 == 0 && N % 4 == 0           ? kW4
                                                          : kWBytes;
  const Q8Mat p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                static_cast<const float*>(scale), static_cast<float*>(y),
                static_cast<float*>(scratch), static_cast<int*>(counters),
                gate, M, N, S, xbar, fn, gate_kind,
                xa % 16 == 0 && xbar % 16 == 0, wmode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate_kind == cadc::kGateNone) return launch_q8<false>(p, groups, st);
  return launch_q8<true>(p, groups, st);
}

extern "C" const char* cadc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
