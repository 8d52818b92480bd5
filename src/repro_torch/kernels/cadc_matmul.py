"""CADC segmented matmul with fused dendritic f(): CUDA kernel and its
plain PyTorch version.

Port of the forward of repro.kernels.cadc_matmul (`_kernel`, launched by
`_fwd_pallas`):

    y[M, N] = sum_s f( x[:, s*xbar:(s+1)*xbar] @ w[s*xbar:(s+1)*xbar, :] )

x [M, S*xbar] and w [S*xbar, N] (the flattened segmented weight), both
fp32 or both bf16; y fp32. psums are fp32, f is applied per segment, and
segments are summed in order s = 0, 1, ... (the order of
repro.kernels.ref.cadc_matmul_ref).

  * cadc_matmul_cuda  — the kernel (csrc/cadc_matmul.cu); CUDA tensors
                        only. Its source note gives the bound and design.
  * cadc_matmul_torch — the plain version: a per-segment loop of fp32
                        matmuls, f, and a sequential sum.

kernels/ops.py picks between them. The kernel takes only the five
built-in dendritic fns (FN_IDS); a fn added with dendritic.register()
runs on the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import dendritic
from repro_torch.kernels import _build

Tensor = torch.Tensor

FN_IDS = {"identity": 0, "relu": 1, "sublinear": 2, "supralinear": 3,
          "tanh": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "cadc_matmul.cu"
# Up to this M (decode: M = serve slots) the kernel runs one block per
# (column tile, segment) into an [S, M, N] fp32 scratch, summed in segment
# order by a second kernel: bitwise the single pass, with S times the
# blocks to stream the weights.
SPLIT_MAX_M = 64


def _check_shapes(x: Tensor, w: Tensor, crossbar_size: int) -> int:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x [M, D] @ w [D, N]; got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    d = x.shape[1]
    if d % crossbar_size:
        raise ValueError(f"D={d} is not a multiple of crossbar_size="
                         f"{crossbar_size}; pad to segments first")
    return d // crossbar_size


def cadc_matmul_torch(x: Tensor, w: Tensor, *, crossbar_size: int,
                      fn: str) -> Tensor:
    """Plain version: fp32 psum per segment, f, and a sequential sum from
    an fp32 zero, as the kernel adds. fp32 out."""
    n_seg = _check_shapes(x, w, crossbar_size)
    f = dendritic.get(fn)
    x32, w32 = x.float(), w.float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for s in range(n_seg):
        seg = slice(s * crossbar_size, (s + 1) * crossbar_size)
        acc = acc + f(x32[:, seg] @ w32[seg])
    return acc


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.cadc_matmul_launch.restype = ctypes.c_int
    lib.cadc_matmul_error_string.argtypes = [ctypes.c_int]
    lib.cadc_matmul_error_string.restype = ctypes.c_char_p
    return lib


def cadc_matmul_cuda(x: Tensor, w: Tensor, *, crossbar_size: int,
                     fn: str) -> Tensor:
    """The CUDA kernel. x [M, S*xbar], w [S*xbar, N] on one CUDA device,
    both fp32 or both bf16 -> fp32 [M, N]. Raises on anything else.
    Counts its launches in `cadc_matmul_cuda.launches`."""
    n_seg = _check_shapes(x, w, crossbar_size)
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError("cadc_matmul_cuda needs x and w on one CUDA device")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"cadc_matmul_cuda takes fp32 or bf16 (one dtype "
                         f"for x and w); got {x.dtype}, {w.dtype}")
    if fn not in FN_IDS:
        raise ValueError(f"dendritic fn {fn!r} has no CUDA kernel id; "
                         f"the kernel takes {sorted(FN_IDS)}")
    m, n = x.shape[0], w.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    scratch = (torch.empty((n_seg, m, n), dtype=torch.float32,
                           device=x.device)
               if 1 < n_seg and m <= SPLIT_MAX_M else None)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, "cadc_matmul", lib.cadc_matmul_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), m, n, n_seg,
        crossbar_size, FN_IDS[fn], _DTYPES[x.dtype], stream))
    cadc_matmul_cuda.launches += 1
    return y


cadc_matmul_cuda.launches = 0
