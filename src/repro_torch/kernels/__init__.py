# The port's kernels. Each module holds hand-written CUDA kernels' wrappers
# (sources under ../csrc/, built at first use by _build.py) and, beside
# each, the plain PyTorch version of the same function:
#   cadc_matmul.py      — CADC segmented matmul: K1 forward, K1g forward
#                         with the saved gate, K2 segmented backward
#                         (replace the Pallas `_kernel`, `_kernel_with_gate`
#                         and `_segmented_bwd` of repro/kernels/
#                         cadc_matmul.py); its autograd Function
#   cadc_conv.py        — K3 fused im2col CADC conv (replaces `_conv_pallas`
#                         of repro/kernels/cadc_conv.py); its autograd
#                         Function (backward: K2 over im2col patches)
#   paged_attention.py  — K6 flash decoding over block tables (replaces the
#                         Pallas `_flash_kernel` of repro/kernels/
#                         paged_attention.py)
#   ref.py              — sequential-order fp32 oracles
# ops.py dispatches between them: 'cuda' = kernel, 'torch' = plain,
# 'auto' = kernel for CUDA tensors, plain for CPU tensors.
