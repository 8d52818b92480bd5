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

import functools
from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import dendritic, work

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


class CadcOut(NamedTuple):
    y: Tensor                 # accumulated output, x.dtype
    psums: Optional[Tensor]   # per-segment psums AFTER f(), fp32


def cadc_matmul(x: Tensor, w: Tensor, *, crossbar_size: int,
                fn: FnOrName = "relu", return_psums: bool = False,
                psum_transform: Optional[Callable[[Tensor], Tensor]] = None,
                ) -> Union[Tensor, CadcOut]:
    """y = sum_s f( x_s @ w_s ). x [..., D], w [D, N] -> [..., N] in
    x.dtype; psums in fp32.

    return_psums also returns the [..., S, N] post-f psums (for sparsity
    statistics and the cost model); psum_transform is applied to the RAW
    psums before f() (the hook of the ADC model)."""
    f = _resolve_fn(fn)
    d, n = w.shape
    if x.shape[-1] != d:
        raise ValueError(f"contraction mismatch: x[...,{x.shape[-1]}] @ w[{d},{n}]")
    s = num_segments(d, crossbar_size)
    xs = pad_to_segments(x, -1, crossbar_size).reshape(
        *x.shape[:-1], s, crossbar_size)
    ws = pad_to_segments(w, 0, crossbar_size).reshape(s, crossbar_size, n)
    psums = torch.einsum("...sk,skn->...sn", xs.float(), ws.float())
    if psum_transform is not None:
        psums = psum_transform(psums)
    fps = f(psums)
    y = fps.sum(dim=-2).to(x.dtype)
    return CadcOut(y=y, psums=fps) if return_psums else y


def vconv_matmul(x: Tensor, w: Tensor, *, crossbar_size: int,
                 return_psums: bool = False,
                 psum_transform: Optional[Callable[[Tensor], Tensor]] = None,
                 ) -> Union[Tensor, CadcOut]:
    """Vanilla crossbar-partitioned matmul: identical partitioning, no
    dendritic nonlinearity."""
    return cadc_matmul(x, w, crossbar_size=crossbar_size, fn="identity",
                       return_psums=return_psums,
                       psum_transform=psum_transform)


def cadc_einsum_segments(x_seg: Tensor, w_seg: Tensor,
                         fn: FnOrName = "relu",
                         psum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """Pre-segmented form: x_seg [..., S, K], w_seg [S, K, N] -> [..., N]
    in x_seg.dtype (fp32 psums; `psum_dtype` rounds them to that dtype
    first, as the LM's bf16_wire stores them). The local work of the
    tensor-parallel CADC linear (parallel/tp_cadc.py), whose segments stay
    on their device: no collective before f(). One CADC product to a work
    tally (core/work.py), forward and backward."""
    return work.product(_einsum_segments, _einsum_cost, x_seg, w_seg, fn=fn,
                        psum_dtype=psum_dtype)


def _einsum_segments(x_seg: Tensor, w_seg: Tensor, *, fn: FnOrName,
                     psum_dtype: Optional[torch.dtype]) -> Tensor:
    f = _resolve_fn(fn)
    psums = torch.einsum("...sk,skn->...sn", x_seg.float(), w_seg.float())
    if psum_dtype is not None:
        psums = psums.to(psum_dtype).float()
    return f(psums).sum(dim=-2).to(x_seg.dtype)


def _einsum_cost(x_seg: Tensor, w_seg: Tensor, *, fn: FnOrName, **_):
    """The unit of K1g / K2 on the same product, the gate of save_gate
    'auto' (a fn given as a callable: as identity, no gate)."""
    from repro_torch.kernels import cadc_matmul  # the gate formats

    return cadc_matmul.linear_cost(
        x_seg, w_seg, crossbar_size=w_seg.shape[1],
        fn=fn if isinstance(fn, str) else "identity", save_gate="auto")


def make_cadc_linear(crossbar_size: int, fn: FnOrName = "relu"
                     ) -> Callable[[Tensor, Tensor], Tensor]:
    """A (x, w) -> y closure over cadc_matmul: a drop-in for torch.matmul
    in model definitions."""
    return functools.partial(cadc_matmul, crossbar_size=crossbar_size, fn=fn)
