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
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;

// X(m, d) of a row-major x [M, D].
template <typename T>
struct RowMajor {
  const T* x;
  size_t D;
  __device__ __forceinline__ float operator()(int m, int d) const {
    return cadc::to_f32(x[static_cast<size_t>(m) * D + d]);
  }
};

template <typename T, int BM, int BN, int TM, int TN, bool kGate>
int launch(const void* x, const void* w, void* y, float* scratch, void* gate,
           int M, int N, int S, int xbar, int fn, int gate_kind,
           cudaStream_t stream) {
  const int split = scratch != nullptr;
  const int D = S * xbar;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split ? S : 1);
  cadc::fwd_tile_kernel<T, BM, BN, TM, TN, kGate, RowMajor<T>>
      <<<grid, kThreads, 0, stream>>>(
          RowMajor<T>{static_cast<const T*>(x), static_cast<size_t>(D)},
          static_cast<const T*>(w), split ? scratch : static_cast<float*>(y),
          gate, M, N, D, S, xbar, fn, split, gate_kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  cadc::segment_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                             stream>>>(scratch, static_cast<float*>(y), S, mn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kGate>
int dispatch(const void* x, const void* w, void* y, float* scratch,
             void* gate, int M, int N, int S, int xbar, int fn, int gate_kind,
             cudaStream_t stream) {
  if (M <= 8)
    return launch<T, 8, 64, 1, 2, kGate>(x, w, y, scratch, gate, M, N, S,
                                         xbar, fn, gate_kind, stream);
  return launch<T, 64, 64, 4, 4, kGate>(x, w, y, scratch, gate, M, N, S,
                                        xbar, fn, gate_kind, stream);
}

template <bool kGate>
int by_dtype(const void* x, const void* w, void* y, void* scratch, void* gate,
             int M, int N, int S, int xbar, int fn, int dtype, int gate_kind,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float, kGate>(x, w, y, sc, gate, M, N, S, xbar, fn,
                                  gate_kind, st);
  return dispatch<__nv_bfloat16, kGate>(x, w, y, sc, gate, M, N, S, xbar, fn,
                                        gate_kind, st);
}

}  // namespace

// K1. x [M, S*xbar] and w [S*xbar, N], row-major, both fp32 (dtype 0) or
// bf16 (dtype 1); y [M, N] fp32. scratch: NULL for the single pass, or an
// fp32 [S, M, N] buffer for the per-segment split. Returns the CUDA error
// code after the launches (0 = success).
extern "C" int cadc_matmul_launch(const void* x, const void* w, void* y,
                                  void* scratch, int M, int N, int S,
                                  int xbar, int fn, int dtype, void* stream) {
  return by_dtype<false>(x, w, y, scratch, nullptr, M, N, S, xbar, fn, dtype,
                         cadc::kGateNone, stream);
}

// K1g: K1 plus the gate. gate_kind 1: uint32 words [S, M, ceil(N/32)];
// 2: uint8 [S, M, N]; 3: fp32 [S, M, N].
extern "C" int cadc_matmul_gate_launch(const void* x, const void* w, void* y,
                                       void* scratch, void* gate, int M,
                                       int N, int S, int xbar, int fn,
                                       int dtype, int gate_kind,
                                       void* stream) {
  return by_dtype<true>(x, w, y, scratch, gate, M, N, S, xbar, fn, dtype,
                        gate_kind, stream);
}

extern "C" const char* cadc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
