# The port's kernels. Each module holds a hand-written CUDA kernel's
# wrapper (sources under ../csrc/, built at first use by _build.py) and,
# beside it, the plain PyTorch version of the same function:
#   cadc_matmul.py      — CADC segmented matmul forward (replaces the
#                         Pallas `_kernel` of repro/kernels/cadc_matmul.py)
#   paged_attention.py  — flash decoding over block tables (replaces the
#                         Pallas `_flash_kernel` of repro/kernels/
#                         paged_attention.py)
# ops.py dispatches between them: 'cuda' = kernel, 'torch' = plain,
# 'auto' = kernel for CUDA tensors, plain for CPU tensors.
