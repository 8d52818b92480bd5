"""Dispatch between the port's CUDA kernels and their plain versions.

`impl` resolution (the port's counterpart of repro.kernels.ops):
  * "cuda"  — the hand-written kernel; raises for CPU tensors
  * "torch" — the plain PyTorch version (the counterpart of JAX's "xla")
  * "auto"  — the kernel for CUDA tensors, the plain version for CPU ones

There is no silent fallback: "auto" on a CUDA tensor launches the kernel
or raises. The CADC ops are differentiable: under autograd their forward
saves the dendritic gate in the format `save_gate` picks ("auto" |
"packed" | "bytes" | "recompute"; kernels/cadc_matmul.py) and their
backward is the segmented backward kernel K2 (or its plain version); with
no gradient wanted the forward is the gate-free K1 / K3. The one plain
fallback the JAX package's dispatch has that the port keeps is the empty
batch of cadc_conv2d; it keeps no feature-map budget fallback (the JAX
rule exists because a TPU block holds a whole padded image, and K3 does
not).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cadc as _core
from repro_torch.core import conv as _conv
from repro_torch.kernels import cadc_conv as _cc
from repro_torch.kernels import cadc_matmul as _cm
from repro_torch.kernels import paged_attention as _pa

Tensor = torch.Tensor
IMPLS = ("auto", "cuda", "torch")


def resolve(impl: str, t: Tensor) -> str:
    """'cuda' or 'torch' for a call on tensor `t`."""
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{t.device}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    return impl


def _wants_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def cadc_matmul(x: Tensor, w: Tensor, *, crossbar_size: int = 256,
                fn: str = "relu", impl: str = "auto",
                save_gate: str = "auto") -> Tensor:
    """y = sum_s f(x_s @ w_s). x [..., D], w [D, N] -> [..., N] in x.dtype
    (accumulated in fp32). A D that is not a multiple of crossbar_size is
    zero-padded to whole segments. Differentiable; `save_gate` picks the
    gradient residual (module docstring)."""
    *lead, d = x.shape
    n = w.shape[1]
    if w.shape[0] != d:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    mode = _cm.gate_mode(save_gate, fn)
    use_cuda = resolve(impl, x) == "cuda"
    x2 = _core.pad_to_segments(x.reshape(-1, d), -1, crossbar_size)
    wp = _core.pad_to_segments(w, 0, crossbar_size)
    if _wants_grad(x, w) and _cm._resolve_gate(fn)[1] is not None:
        y = _cm.CadcMatmulFn.apply(x2, wp, crossbar_size, fn, mode, use_cuda)
    else:
        run = _cm.cadc_matmul_cuda if use_cuda else _cm.cadc_matmul_torch
        y = run(x2, wp, crossbar_size=crossbar_size, fn=fn)
    return y.reshape(*lead, n).to(x.dtype)


def cadc_conv2d(x: Tensor, w: Tensor, *, crossbar_size: int = 256,
                fn: str = "relu", stride=(1, 1), padding="SAME",
                impl: str = "auto", save_gate: str = "auto") -> Tensor:
    """Fused im2col + segmented conv: x [B, H, W, Cin] NHWC, w [K1, K2, Cin,
    Cout] HWIO -> [B, OH, OW, Cout] in x.dtype. An empty batch takes the
    core im2col path (a zero-size grid is no launch). Differentiable, as
    cadc_matmul."""
    mode = _cm.gate_mode(save_gate, fn)
    if x.shape[0] == 0:
        return _conv.cadc_conv2d(x, w, crossbar_size=crossbar_size, fn=fn,
                                 stride=stride, padding=padding)
    use_cuda = resolve(impl, x) == "cuda"
    if _wants_grad(x, w) and _cm._resolve_gate(fn)[1] is not None:
        y = _cc.CadcConv2dFn.apply(x, w, crossbar_size, fn, stride, padding,
                                   mode, use_cuda)
    else:
        run = _cc.cadc_conv2d_cuda if use_cuda else _cc.cadc_conv2d_torch
        y, _ = run(x, w, crossbar_size=crossbar_size, fn=fn, stride=stride,
                   padding=padding)
    return y.to(x.dtype)


def paged_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                    block_table: Tensor, positions: Tensor, *, kind: str,
                    window: int, ring_len: Optional[int] = None,
                    softcap: Optional[float] = None,
                    impl: str = "auto") -> Tensor:
    """Paged-attention decode. q [B, Q, H, hd] (rope'd), pools
    [n_blocks, bs, K, hd], block_table [B, nb] (-1 = unallocated),
    positions [B] -> [B, Q, H, hd] in q.dtype."""
    run = (_pa.paged_attention_cuda if resolve(impl, q) == "cuda"
           else _pa.paged_attention_torch)
    return run(q, k_pool, v_pool, block_table, positions, kind=kind,
               window=window, ring_len=ring_len, softcap=softcap)
