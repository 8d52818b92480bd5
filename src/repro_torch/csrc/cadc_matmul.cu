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
// 4*S*M*N fp32. It runs the tile kernel under every plan.
//
// K4 replaces the q8 bodies of the same launcher, `_q8_kernel` and
// `_q8_kernel_with_gate` (`_seg_psum_q8`; entry `cadc_matmul_q8_pallas`):
// x_q int8 [M, D] activation codes times w int8 codes ({-1, 0, 1} ternary
// in the models) give an exact int32 psum per segment, dequantized once as
// float(p) * scale — scale fp32, read from device memory, so no host sync
// is needed per layer — then f, then the sequential fp32 sum; K4g adds the
// gate epilogue, from the dequantized psum, in K1g's layouts. It is the same
// tile kernel (and plan) over int8 loads with int32 multiply-adds on CUDA
// cores, and every rounding after the dequantization is explicit
// (cadc_tile.cuh): the result is bitwise the plain version's. Bound on
// this card: at the models' FC shapes (M = the eval batch, D and N <=
// 4096) the bytes (int8 x and w, fp32 y) and the int8 operations (2*M*D*N
// at the int8 tensor-core peak) each take well under a microsecond: bound
// by bytes, so by launch and tail effects in practice; int8 `mma.sync` /
// `wgmma` is later work.
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;

// Plan kernels (kernels/cadc_matmul.py PLAN_KERNELS).
enum PlanKernel : int { kTile = 0, kStream = 1 };

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

}  // namespace

// Plan arguments: `scratch` NULL for the single pass, else an fp32
// [S, M, N] buffer for the split over segments, with `counters` the
// device's zeroed int32 arrival counters (one per output tile; the kernel
// leaves them zero). Each function returns the CUDA error code after its
// one launch (0 = success).

// K1. x [M, S*xbar] and w [S*xbar, N], row-major, both fp32 (dtype 0) or
// bf16 (dtype 1); y [M, N] fp32. kernel 0: the tile kernel with `width`
// (8 or 64) rows; kernel 1: the stream kernel (M <= 8, xbar <= 512) with
// `width` (4 or 8) 16-byte vectors per strip.
extern "C" int cadc_matmul_launch(const void* x, const void* w, void* y,
                                  void* scratch, void* counters, int M,
                                  int N, int S, int xbar, int fn, int dtype,
                                  int kernel, int width, void* stream) {
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

// K1g: K1's tile kernel plus the gate. gate_kind 1: uint32 words
// [S, M, ceil(N/32)]; 2: uint8 [S, M, N]; 3: fp32 [S, M, N].
extern "C" int cadc_matmul_gate_launch(const void* x, const void* w, void* y,
                                       void* scratch, void* counters,
                                       void* gate, int M, int N, int S,
                                       int xbar, int fn, int dtype,
                                       int gate_kind, int rows,
                                       void* stream) {
  if (dtype == 0)
    return tile_by_gate<float, float>(x, w, nullptr, y, scratch, counters,
                                      gate, M, N, S, xbar, fn, gate_kind,
                                      rows, stream);
  return tile_by_gate<__nv_bfloat16, float>(x, w, nullptr, y, scratch,
                                            counters, gate, M, N, S, xbar, fn,
                                            gate_kind, rows, stream);
}

// K4 (gate_kind 0, gate NULL) and K4g (gate_kind 1-3, K1g's layouts):
// x_q [M, S*xbar] and w [S*xbar, N] int8, row-major; scale: one fp32 in
// device memory; y [M, N] fp32; the tile kernel with `rows` rows.
extern "C" int cadc_matmul_q8_launch(const void* x, const void* w,
                                     const void* scale, void* y,
                                     void* scratch, void* counters,
                                     void* gate, int M, int N, int S,
                                     int xbar, int fn, int gate_kind,
                                     int rows, void* stream) {
  return tile_by_gate<int8_t, int>(x, w, scale, y, scratch, counters, gate,
                                   M, N, S, xbar, fn, gate_kind, rows,
                                   stream);
}

extern "C" const char* cadc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
