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
//
// K1g is the same kernel with a gate epilogue (cadc_tile.cuh): at the end
// of each segment it writes f'(psum) from the fp32 psum in registers —
// a warp's __ballot_sync over 32 consecutive columns gives one packed
// uint32 word in the JAX bit layout (column tiles are whole words, N is
// padded to whole words), or one byte (relu) / one fp32 (curved fns) per
// psum. Its extra bytes are the gate's: S*M*N/8 packed, S*M*N bytes or
// 4*S*M*N fp32. Both K1 paths (single pass and the M <= 64 split) take it.
//
// K4 replaces the q8 bodies of the same launcher, `_q8_kernel` and
// `_q8_kernel_with_gate` (`_seg_psum_q8`; entry `cadc_matmul_q8_pallas`):
// x_q int8 [M, D] activation codes times w int8 codes ({-1, 0, 1} ternary
// in the models) give an exact int32 psum per segment, dequantized once as
// float(p) * scale — scale fp32, read from device memory, so no host sync
// is needed per layer — then f, then the sequential fp32 sum; K4g adds the
// gate epilogue, from the dequantized psum, in K1g's layouts. It is the same
// tile kernel over int8 loads with int32 multiply-adds on CUDA cores, and
// every rounding after the dequantization is explicit (cadc_tile.cuh): the
// result is bitwise the plain version's. Bound on this card: at the models'
// FC shapes (M = the eval batch, D and N <= 4096) the bytes (int8 x and
// w, fp32 y) and the int8 operations (2*M*D*N at the int8 tensor-core
// peak) each take well under a microsecond: bound by bytes, so by launch
// and tail effects in practice; int8 `mma.sync` / `wgmma` is later work.
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;

// X(m, d) of a row-major x [M, D], widened to the psum's type.
template <typename T, typename Acc>
struct RowMajor {
  const T* x;
  size_t D;
  __device__ __forceinline__ Acc operator()(int m, int d) const {
    return cadc::widen<Acc>(x[static_cast<size_t>(m) * D + d]);
  }
};

template <typename T, typename Acc, int BM, int BN, int TM, int TN,
          bool kGate>
int launch(const void* x, const void* w, const float* scale, void* y,
           float* scratch, void* gate, int M, int N, int S, int xbar, int fn,
           int gate_kind, cudaStream_t stream) {
  const int split = scratch != nullptr;
  const int D = S * xbar;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split ? S : 1);
  cadc::fwd_tile_kernel<T, Acc, BM, BN, TM, TN, kGate, RowMajor<T, Acc>>
      <<<grid, kThreads, 0, stream>>>(
          RowMajor<T, Acc>{static_cast<const T*>(x), static_cast<size_t>(D)},
          static_cast<const T*>(w), split ? scratch : static_cast<float*>(y),
          gate, M, N, D, S, xbar, fn, split, gate_kind, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  cadc::segment_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                             stream>>>(scratch, static_cast<float*>(y), S, mn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc, bool kGate>
int dispatch(const void* x, const void* w, const float* scale, void* y,
             float* scratch, void* gate, int M, int N, int S, int xbar,
             int fn, int gate_kind, cudaStream_t stream) {
  if (M <= 8)
    return launch<T, Acc, 8, 64, 1, 2, kGate>(x, w, scale, y, scratch, gate,
                                              M, N, S, xbar, fn, gate_kind,
                                              stream);
  return launch<T, Acc, 64, 64, 4, 4, kGate>(x, w, scale, y, scratch, gate,
                                             M, N, S, xbar, fn, gate_kind,
                                             stream);
}

template <typename T, typename Acc>
int by_gate(const void* x, const void* w, const void* scale, void* y,
            void* scratch, void* gate, int M, int N, int S, int xbar, int fn,
            int gate_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* sc = static_cast<float*>(scratch);
  if (gate_kind == cadc::kGateNone)
    return dispatch<T, Acc, false>(x, w, s, y, sc, nullptr, M, N, S, xbar, fn,
                                   gate_kind, st);
  return dispatch<T, Acc, true>(x, w, s, y, sc, gate, M, N, S, xbar, fn,
                                gate_kind, st);
}

int by_dtype(const void* x, const void* w, void* y, void* scratch, void* gate,
             int M, int N, int S, int xbar, int fn, int dtype, int gate_kind,
             void* stream) {
  if (dtype == 0)
    return by_gate<float, float>(x, w, nullptr, y, scratch, gate, M, N, S,
                                 xbar, fn, gate_kind, stream);
  return by_gate<__nv_bfloat16, float>(x, w, nullptr, y, scratch, gate, M, N,
                                       S, xbar, fn, gate_kind, stream);
}

}  // namespace

// K1. x [M, S*xbar] and w [S*xbar, N], row-major, both fp32 (dtype 0) or
// bf16 (dtype 1); y [M, N] fp32. scratch: NULL for the single pass, or an
// fp32 [S, M, N] buffer for the per-segment split. Returns the CUDA error
// code after the launches (0 = success).
extern "C" int cadc_matmul_launch(const void* x, const void* w, void* y,
                                  void* scratch, int M, int N, int S,
                                  int xbar, int fn, int dtype, void* stream) {
  return by_dtype(x, w, y, scratch, nullptr, M, N, S, xbar, fn, dtype,
                  cadc::kGateNone, stream);
}

// K1g: K1 plus the gate. gate_kind 1: uint32 words [S, M, ceil(N/32)];
// 2: uint8 [S, M, N]; 3: fp32 [S, M, N].
extern "C" int cadc_matmul_gate_launch(const void* x, const void* w, void* y,
                                       void* scratch, void* gate, int M,
                                       int N, int S, int xbar, int fn,
                                       int dtype, int gate_kind,
                                       void* stream) {
  return by_dtype(x, w, y, scratch, gate, M, N, S, xbar, fn, dtype, gate_kind,
                  stream);
}

// K4 (gate_kind 0, gate NULL) and K4g (gate_kind 1-3, K1g's layouts):
// x_q [M, S*xbar] and w [S*xbar, N] int8, row-major; scale: one fp32 in
// device memory; y [M, N] fp32; scratch as K1's.
extern "C" int cadc_matmul_q8_launch(const void* x, const void* w,
                                     const void* scale, void* y,
                                     void* scratch, void* gate, int M, int N,
                                     int S, int xbar, int fn, int gate_kind,
                                     void* stream) {
  return by_gate<int8_t, int>(x, w, scale, y, scratch, gate, M, N, S, xbar,
                              fn, gate_kind, stream);
}

extern "C" const char* cadc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
