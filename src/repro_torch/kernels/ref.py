"""Plain oracles for the kernels (independent of core/).

Port of repro.kernels.ref. Segment accumulation is SEQUENTIAL (a Python
loop over S, s = 0 first), the order every CADC kernel adds its segments
in; a sum over a segment axis reduces in another fp32 order. The q8
oracles compute their segment psums in int32: integer psums have one true
answer, so the q8 kernels and their plain versions must match these
bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dendritic

Tensor = torch.Tensor


def _seq_sum(fps: Tensor) -> Tensor:
    """Sum [..., S, N] over S in the kernels' sequential order."""
    acc = fps[..., 0, :]
    for s in range(1, fps.shape[-2]):
        acc = acc + fps[..., s, :]
    return acc


def _segments(x: Tensor, w: Tensor, xbar: int):
    """x [..., D], w [D, N] -> x [..., S, xbar], w [S, xbar, N], zero-padded."""
    d = x.shape[-1]
    s = -(-d // xbar)
    pad = s * xbar - d
    if pad:
        x = F.pad(x, (0, pad))
        w = F.pad(w, (0, 0, 0, pad))
    return x.reshape(*x.shape[:-1], s, xbar), w.reshape(s, xbar, w.shape[1])


def cadc_matmul_ref(x: Tensor, w: Tensor, *, crossbar_size: int,
                    fn: str) -> Tensor:
    """Oracle: per-segment fp32 psums -> f -> sequential sum. fp32 out."""
    f = dendritic.get(fn)
    xs, ws = _segments(x.float(), w.float(), crossbar_size)
    return _seq_sum(f(torch.einsum("...sk,skn->...sn", xs, ws)))


def cadc_matmul_q8_ref(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                       crossbar_size: int, fn: str) -> Tensor:
    """Oracle for the quantized kernel: int32 psums, rescale, f, sum."""
    f = dendritic.get(fn)
    xs, ws = _segments(x_q.to(torch.int32), w_codes.to(torch.int32),
                       crossbar_size)
    psums_i = torch.einsum("...sk,skn->...sn", xs, ws)
    psums = psums_i.float() * scale.float()
    return _seq_sum(f(psums))


def cadc_conv2d_q8_ref(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                       crossbar_size: int, fn: str, stride=(1, 1),
                       padding="SAME") -> Tensor:
    """Oracle for the fused q8 conv: im2col patches (exact integers) ->
    per-segment int32 psums -> rescale -> f -> SEQUENTIAL segment sum.
    x_q int8 [B,H,W,Cin], w_codes int8 [K1,K2,Cin,Cout] -> fp32
    [B,OH,OW,Cout]."""
    from repro_torch.core.conv import im2col

    k1, k2, cin, cout = w_codes.shape
    patches = im2col(x_q.to(torch.int32), (k1, k2), stride=tuple(stride),
                     padding=padding)
    return cadc_matmul_q8_ref(patches, w_codes.reshape(k1 * k2 * cin, cout),
                              scale, crossbar_size=crossbar_size, fn=fn)
