"""Plain oracles for the kernels (independent of core/).

Port of the fp32 part of repro.kernels.ref. Segment accumulation is
SEQUENTIAL (a Python loop over S, s = 0 first), the order every CADC
kernel adds its segments in; a sum over a segment axis reduces in another
fp32 order. The q8 oracles come with the q8 kernels.
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
