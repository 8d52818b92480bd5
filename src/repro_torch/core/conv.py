"""CADC 2-D convolution via explicit im2col -> segmented matmul.

Port of repro.core.conv. Paper Fig. 2: a (Cin=64, K1=3, K2=3, Cout=64)
kernel on 64x64 crossbars is unrolled so that each crossbar holds ONE
spatial tap's 64 input channels — the unrolled contraction index is
((k1*K2 + k2)*Cin + cin): taps outer, channels fastest. torch's F.unfold
orders channels outer, which would put other rows into each crossbar
segment and so compute a different function; im2col below keeps the JAX
order.

Layouts: activations NHWC, weights HWIO (K1, K2, Cin, Cout) — reshaping
HWIO to (K1*K2*Cin, Cout) is already channels-fastest, so weights and
patches agree without any transpose. SAME pads k-1 per axis, split
low-first (floor on the low side), whatever the stride, as JAX does.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import cadc

Tensor = torch.Tensor
Padding = Union[str, Sequence[Tuple[int, int]]]


def _norm_padding(padding: Padding, kernel: Tuple[int, int],
                  dilation: Tuple[int, int]
                  ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) for 'SAME', 'VALID' or explicit pads."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return (0, 0), (0, 0)
        if p == "SAME":
            pads = []
            for k, d in zip(kernel, dilation):
                total = (k - 1) * d
                pads.append((total // 2, total - total // 2))
            return tuple(pads)  # type: ignore[return-value]
        raise ValueError(f"unknown padding {padding!r}")
    (p1, p2) = padding
    return (tuple(p1), tuple(p2))  # type: ignore[return-value]


def _out_hw(hp: int, wp: int, kernel, stride, dilation) -> Tuple[int, int]:
    oh = (hp - ((kernel[0] - 1) * dilation[0] + 1)) // stride[0] + 1
    ow = (wp - ((kernel[1] - 1) * dilation[1] + 1)) // stride[1] + 1
    return oh, ow


def im2col(x: Tensor, kernel: Tuple[int, int], *,
           stride: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
           dilation: Tuple[int, int] = (1, 1)) -> Tensor:
    """x [B,H,W,C] -> patches [B, OH, OW, K1*K2*C], channels fastest.

    One strided slice per tap, stacked taps-outer (the JAX order)."""
    k1, k2 = kernel
    s1, s2 = stride
    d1, d2 = dilation
    (pt, pb), (pl, pr) = _norm_padding(padding, kernel, dilation)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    b, hp, wp, c = xp.shape
    oh, ow = _out_hw(hp, wp, kernel, stride, dilation)
    taps = []
    for i in range(k1):
        for j in range(k2):
            taps.append(xp[:, i * d1: i * d1 + (oh - 1) * s1 + 1: s1,
                           j * d2: j * d2 + (ow - 1) * s2 + 1: s2, :])
    return torch.stack(taps, dim=3).reshape(b, oh, ow, k1 * k2 * c)


def cadc_conv2d(x: Tensor, w: Tensor, *, crossbar_size: int,
                fn: Union[str, Callable[[Tensor], Tensor]] = "relu",
                stride: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
                dilation: Tuple[int, int] = (1, 1),
                return_psums: bool = False,
                psum_transform: Optional[Callable[[Tensor], Tensor]] = None,
                ) -> Union[Tensor, cadc.CadcOut]:
    """CADC convolution: im2col then crossbar-segmented matmul with f().

    x: [B, H, W, Cin] NHWC.  w: [K1, K2, Cin, Cout] HWIO."""
    k1, k2, cin, cout = w.shape
    if x.shape[-1] != cin:
        raise ValueError(f"Cin mismatch: x has {x.shape[-1]}, w has {cin}")
    patches = im2col(x, (k1, k2), stride=stride, padding=padding,
                     dilation=dilation)
    return cadc.cadc_matmul(patches, w.reshape(k1 * k2 * cin, cout),
                            crossbar_size=crossbar_size, fn=fn,
                            return_psums=return_psums,
                            psum_transform=psum_transform)


def vconv_conv2d(x: Tensor, w: Tensor, *, crossbar_size: int,
                 stride: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
                 dilation: Tuple[int, int] = (1, 1),
                 return_psums: bool = False,
                 psum_transform: Optional[Callable[[Tensor], Tensor]] = None,
                 ) -> Union[Tensor, cadc.CadcOut]:
    """Baseline crossbar-partitioned conv (identity f)."""
    return cadc_conv2d(x, w, crossbar_size=crossbar_size, fn="identity",
                       stride=stride, padding=padding, dilation=dilation,
                       return_psums=return_psums,
                       psum_transform=psum_transform)


def conv_output_positions(in_hw: Tuple[int, int], kernel: Tuple[int, int],
                          stride: Tuple[int, int] = (1, 1),
                          padding: Padding = "SAME",
                          dilation: Tuple[int, int] = (1, 1)) -> int:
    """OH*OW — used by the psum-count accounting in the cost model."""
    (pt, pb), (pl, pr) = _norm_padding(padding, kernel, dilation)
    oh, ow = _out_hw(in_hw[0] + pt + pb, in_hw[1] + pl + pr, kernel, stride,
                     dilation)
    return oh * ow
