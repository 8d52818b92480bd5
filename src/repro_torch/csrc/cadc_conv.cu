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
// fp32 CUDA-core peak against 0.02 ms of bytes): bound by operations.
//
// Design (simple before fast): an implicit GEMM on the segmented forward
// tile kernel of cadc_tile.cuh. A block owns 64 output pixels x 64 output
// channels and walks the segments in order, 32 rows of D at a time; the
// loader below gathers each pixel's patch elements straight from x in
// global memory — halo and padding masked, stride by indexing — so neither
// the im2col patches nor the padded image is ever materialized, and no
// image has to fit in shared memory (the TPU kernel held one padded image
// in VMEM). The gate variant writes [S, B, OH, OW, ceil(Cout/32)] uint32
// words, or one byte / fp32 per psum, as K1g does. Dilation is 1.
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
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;

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

}  // namespace

// K3. x [B, H, W, Cin] and w [K1, K2, Cin, Cout] fp32, y [B, OH, OW, Cout]
// fp32. gate: NULL (gate_kind 0) or [S, B, OH, OW, ...] as gate_kind says
// (1: uint32 words of ceil(Cout/32); 2: uint8 per psum; 3: fp32 per psum).
// Returns the CUDA error code after the launch (0 = success).
extern "C" int cadc_conv_launch(const void* x, const void* w, void* y,
                                void* gate, int B, int H, int W, int Cin,
                                int K1, int K2, int Cout, int OH, int OW,
                                int s1, int s2, int pt, int pl, int xbar,
                                int fn, int gate_kind, void* stream) {
  return by_gate<float, float>(x, w, nullptr, y, gate, B, H, W, Cin, K1, K2,
                               Cout, OH, OW, s1, s2, pt, pl, xbar, fn,
                               gate_kind, stream);
}

// K5 (gate_kind 0) and its gate variant: x_q and w int8 in K3's layouts,
// scale one fp32 in device memory, y and gate as K3's.
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
