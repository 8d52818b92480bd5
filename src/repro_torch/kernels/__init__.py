# The port's kernels. Each module holds hand-written CUDA kernels' wrappers
# (sources under ../csrc/, built at first use by _build.py) and, beside
# each, the plain PyTorch version of the same function:
#   cadc_matmul.py      — CADC segmented matmul: K1 forward, K1g forward
#                         with the saved gate, K2 segmented backward, K4 /
#                         K4g the int8 q8 forward (replace the Pallas
#                         `_kernel`, `_kernel_with_gate`, `_segmented_bwd`
#                         and the `_q8_kernel` bodies of repro/kernels/
#                         cadc_matmul.py); its autograd Functions
#   cadc_conv.py        — K3 fused im2col CADC conv and K5 its q8 form
#                         (replace `_conv_pallas` of repro/kernels/
#                         cadc_conv.py, fp32 and q8 bodies); their autograd
#                         Functions (backward: K2 over im2col patches)
#   paged_attention.py  — K6 flash decoding over block tables (replaces the
#                         Pallas `_flash_kernel` of repro/kernels/
#                         paged_attention.py)
#   ref.py              — sequential-order fp32 and q8 oracles
# ops.py dispatches between them: 'cuda' = kernel, 'torch' = plain,
# 'auto' = kernel for CUDA tensors, plain for CPU tensors.
