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
#include "cadc_tile.cuh"

namespace {

using cadc::kThreads;

// X(m, d) = the im2col patch element of output pixel m = (b, oh, ow) and
// contraction row d = (i*K2 + j)*Cin + c.
struct ConvGather {
  const float* x;
  int H, W, Cin, K2, OH, OW, s1, s2, pt, pl;
  __device__ __forceinline__ float operator()(int m, int d) const {
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
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    return x[((static_cast<size_t>(b) * H + ih) * W + iw) * Cin + c];
  }
};

template <bool kGate>
int launch(const ConvGather& g, const float* w, float* y, void* gate, int M,
           int N, int D, int xbar, int fn, int gate_kind,
           cudaStream_t stream) {
  const int S = (D + xbar - 1) / xbar;
  dim3 grid((N + 63) / 64, (M + 63) / 64, 1);
  cadc::fwd_tile_kernel<float, 64, 64, 4, 4, kGate, ConvGather>
      <<<grid, kThreads, 0, stream>>>(g, w, y, gate, M, N, D, S, xbar, fn,
                                      /*split=*/0, gate_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, Cin] and w [K1, K2, Cin, Cout] fp32, y [B, OH, OW, Cout] fp32.
// gate: NULL (gate_kind 0) or [S, B, OH, OW, ...] as gate_kind says
// (1: uint32 words of ceil(Cout/32); 2: uint8 per psum; 3: fp32 per psum).
// Returns the CUDA error code after the launch (0 = success).
extern "C" int cadc_conv_launch(const void* x, const void* w, void* y,
                                void* gate, int B, int H, int W, int Cin,
                                int K1, int K2, int Cout, int OH, int OW,
                                int s1, int s2, int pt, int pl, int xbar,
                                int fn, int gate_kind, void* stream) {
  const ConvGather g{static_cast<const float*>(x), H, W, Cin, K2, OH, OW,
                     s1, s2, pt, pl};
  const int M = B * OH * OW, D = K1 * K2 * Cin;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gate_kind == cadc::kGateNone)
    return launch<false>(g, static_cast<const float*>(w),
                         static_cast<float*>(y), nullptr, M, Cout, D, xbar,
                         fn, gate_kind, st);
  return launch<true>(g, static_cast<const float*>(w), static_cast<float*>(y),
                      gate, M, Cout, D, xbar, fn, gate_kind, st);
}

extern "C" const char* cadc_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
