"""CADC core: crossbar-partitioned contraction with per-segment dendritic f().

Port of repro.core.cadc. The paper's eq. (4):
y[k] = sum_s f( sum_i w^s[i,k] x^s[i] ). The contraction dim D is padded to
S * N (N = crossbar size) and reshaped to (S, N); segment s holds rows
[s*N, (s+1)*N) of W. Partial sums are computed in float32 and f() is applied
per segment BEFORE the cross-segment sum.

This module is the port's reference math (no kernels): the CADC-matmul
kernel and its plain version (kernels/cadc_matmul.py) are held against it.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

from repro_torch.core import dendritic

Tensor = torch.Tensor
FnOrName = Union[str, Callable[[Tensor], Tensor]]


def _resolve_fn(fn: FnOrName) -> Callable[[Tensor], Tensor]:
    return dendritic.get(fn) if isinstance(fn, str) else fn


def num_segments(contract_dim: int, crossbar_size: int) -> int:
    """S = ceil(D / N) — number of crossbars the contraction spans."""
    if crossbar_size <= 0:
        raise ValueError(f"crossbar_size must be positive, got {crossbar_size}")
    return -(-contract_dim // crossbar_size)


def pad_to_segments(x: Tensor, axis: int, crossbar_size: int) -> Tensor:
    """Zero-pad `axis` of x up to a multiple of crossbar_size (exact for
    vConv and CADC: padded rows add 0 to every psum)."""
    axis = axis % x.ndim
    d = x.shape[axis]
    pad = num_segments(d, crossbar_size) * crossbar_size - d
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def cadc_matmul(x: Tensor, w: Tensor, *, crossbar_size: int,
                fn: FnOrName = "relu") -> Tensor:
    """y = sum_s f( x_s @ w_s ). x [..., D], w [D, N] -> [..., N] in
    x.dtype; psums in fp32."""
    f = _resolve_fn(fn)
    d, n = w.shape
    if x.shape[-1] != d:
        raise ValueError(f"contraction mismatch: x[...,{x.shape[-1]}] @ w[{d},{n}]")
    s = num_segments(d, crossbar_size)
    xs = pad_to_segments(x, -1, crossbar_size).reshape(
        *x.shape[:-1], s, crossbar_size)
    ws = pad_to_segments(w, 0, crossbar_size).reshape(s, crossbar_size, n)
    psums = torch.einsum("...sk,skn->...sn", xs.float(), ws.float())
    return f(psums).sum(dim=-2).to(x.dtype)


def vconv_matmul(x: Tensor, w: Tensor, *, crossbar_size: int) -> Tensor:
    """Vanilla crossbar-partitioned matmul: identical partitioning, no
    dendritic nonlinearity."""
    return cadc_matmul(x, w, crossbar_size=crossbar_size, fn="identity")
