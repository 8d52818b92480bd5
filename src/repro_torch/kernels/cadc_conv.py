"""Fused im2col CADC conv2d: the CUDA kernel K3, its plain PyTorch version,
and the conv's autograd Function.

Port of repro.kernels.cadc_conv (fp32 part). x [B, H, W, Cin] NHWC, w
[K1, K2, Cin, Cout] HWIO -> y [B, OH, OW, Cout] fp32. The unrolled
contraction D = K1*K2*Cin (taps outer, channels fastest — core/conv.py's
order) is cut into S = ceil(D / xbar) contiguous crossbar segments; a
segment may span several taps (`_segment_taps`), and its psum is summed
over all of them before f(). Dilation is 1.

  * cadc_conv2d_cuda  — K3 (csrc/cadc_conv.cu; replaces the Pallas
                        `_kernel` / `_kernel_with_gate` of `_conv_pallas`):
                        an implicit GEMM that gathers patches from x as it
                        goes, optionally writing the gate
                        [S, B, OH, OW, ceil(Cout/32)] words or
                        [S, B, OH, OW, Cout] bytes / fp32, as K1g.
  * cadc_conv2d_torch — the plain version: im2col, then the per-segment
                        loop of K1g's plain version (f, sequential sum,
                        the gate).
  * CadcConv2dFn      — forward K3; backward as the JAX `_diff_conv_op`:
                        im2col patches again, K2 over them (dpatches and
                        dw), then `_col2im` folds dpatches back to dx.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core import cadc as core_cadc
from repro_torch.core import dendritic
from repro_torch.core.conv import _norm_padding, im2col
from repro_torch.kernels import _build
from repro_torch.kernels import cadc_matmul as _cm

Tensor = torch.Tensor
_SOURCE = "cadc_conv.cu"


def _segment_taps(k1: int, k2: int, c: int, xbar: int
                  ) -> List[List[Tuple[int, int, int, int, int]]]:
    """For each segment s: list of (tap_i, tap_j, c_lo, c_sz, d_off), d_off
    the row offset inside the segment's xbar-row window."""
    d = k1 * k2 * c
    segs = []
    for s in range(-(-d // xbar)):
        lo, hi = s * xbar, min((s + 1) * xbar, d)
        taps = []
        for t in range(lo // c, (hi - 1) // c + 1):
            i, j = divmod(t, k2)
            c_lo = max(lo - t * c, 0)
            c_hi = min(hi - t * c, c)
            taps.append((i, j, c_lo, c_hi - c_lo, t * c + c_lo - lo))
        segs.append(taps)
    return segs


def _col2im(dp: Tensor, x_shape: Tuple[int, int, int, int],
            kernel: Tuple[int, int], stride: Tuple[int, int],
            padding) -> Tensor:
    """Adjoint of core.conv.im2col (dilation 1): add each tap's dpatch
    slice back onto the padded image, then crop the conv padding."""
    k1, k2 = kernel
    s1, s2 = stride
    b, h, w, c = x_shape
    (pt, pb), (pl, pr) = _norm_padding(padding, kernel, (1, 1))
    oh, ow = dp.shape[1], dp.shape[2]
    dp5 = dp.reshape(b, oh, ow, k1 * k2, c)
    dx = torch.zeros((b, h + pt + pb, w + pl + pr, c), dtype=dp.dtype,
                     device=dp.device)
    for i in range(k1):
        for j in range(k2):
            dx[:, i: i + (oh - 1) * s1 + 1: s1,
               j: j + (ow - 1) * s2 + 1: s2, :] += dp5[:, :, :, i * k2 + j]
    return dx[:, pt: pt + h, pl: pl + w, :]


def _geometry(x: Tensor, w: Tensor, stride, padding):
    """(pt, pl, OH, OW) of the conv."""
    k1, k2 = w.shape[0], w.shape[1]
    (pt, pb), (pl, pr) = _norm_padding(padding, (k1, k2), (1, 1))
    oh = (x.shape[1] + pt + pb - k1) // stride[0] + 1
    ow = (x.shape[2] + pl + pr - k2) // stride[1] + 1
    return pt, pl, oh, ow


def cadc_conv2d_torch(x: Tensor, w: Tensor, *, crossbar_size: int, fn: str,
                      stride=(1, 1), padding="SAME", mode: str = "none"
                      ) -> Tuple[Tensor, Optional[Tensor]]:
    """K3's plain version -> (y [B, OH, OW, Cout] fp32, gate or None)."""
    k1, k2, cin, cout = w.shape
    patches = im2col(x.float(), (k1, k2), stride=tuple(stride),
                     padding=padding)
    b, oh, ow, d = patches.shape
    y, gate = _cm.cadc_matmul_gate_torch(
        core_cadc.pad_to_segments(patches.reshape(-1, d), -1, crossbar_size),
        core_cadc.pad_to_segments(w.float().reshape(d, cout), 0,
                                  crossbar_size),
        crossbar_size=crossbar_size, fn=fn, mode=mode)
    if gate is not None:
        gate = gate.reshape(gate.shape[0], b, oh, ow, -1)
    return y.reshape(b, oh, ow, cout), gate


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_conv_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    lib.cadc_conv_launch.restype = ctypes.c_int
    lib.cadc_conv_error_string.argtypes = [ctypes.c_int]
    lib.cadc_conv_error_string.restype = ctypes.c_char_p
    return lib


def cadc_conv2d_cuda(x: Tensor, w: Tensor, *, crossbar_size: int, fn: str,
                     stride=(1, 1), padding="SAME", mode: str = "none"
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    """K3: x [B, H, W, Cin], w [K1, K2, Cin, Cout] fp32 on one CUDA device
    -> (y [B, OH, OW, Cout] fp32, gate of `mode` or None). Raises on
    anything else. Counts its launches in `cadc_conv2d_cuda.launches`."""
    _cm._check_cuda("cadc_conv2d_cuda", fn, x, w,
                    dtypes={torch.float32: 0})
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"want x [B, H, W, Cin] and w [K1, K2, Cin, Cout]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if mode in ("packed", "bytes") and dendritic.gate_dtype(fn) is None:
        raise ValueError(f"dendritic fn {fn!r} has no gate to save")
    b, h, wd, cin = x.shape
    k1, k2, _, cout = w.shape
    pt, pl, oh, ow = _geometry(x, w, stride, padding)
    m, d = b * oh * ow, k1 * k2 * cin
    n_seg = -(-d // crossbar_size)
    if -(-m // 64) > 65535:
        raise ValueError(f"B*OH*OW={m} exceeds the kernel's grid")
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    gate = None
    if mode in ("packed", "bytes"):
        gate = _cm._empty_gate(n_seg, m, cout, mode, fn, x.device)
    if m == 0 or cout == 0:
        return y, (None if gate is None
                   else gate.reshape(n_seg, b, oh, ow, -1))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, "cadc_conv", lib.cadc_conv_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if gate is None else gate.data_ptr(), b, h, wd, cin, k1, k2,
        cout, oh, ow, int(stride[0]), int(stride[1]), pt, pl, crossbar_size,
        _cm.FN_IDS[fn], _cm._gate_kind(mode if gate is not None else "none",
                                       fn), stream))
    cadc_conv2d_cuda.launches += 1
    return y, (None if gate is None else gate.reshape(n_seg, b, oh, ow, -1))


cadc_conv2d_cuda.launches = 0


class CadcConv2dFn(torch.autograd.Function):
    """The CADC conv with K3 forward (saving the gate of `mode`) and the
    backward of the JAX `_diff_conv_op`: patches = im2col(x), K2 over them,
    `_col2im` — or the plain versions when use_cuda is False."""

    @staticmethod
    def forward(ctx, x, w, crossbar_size: int, fn: str, stride, padding,
                mode: str, use_cuda: bool):
        run = cadc_conv2d_cuda if use_cuda else cadc_conv2d_torch
        y, gate = run(x, w, crossbar_size=crossbar_size, fn=fn,
                      stride=stride, padding=padding,
                      mode=mode if mode in ("packed", "bytes") else "none")
        ctx.save_for_backward(x, w, gate)
        ctx.cfg = (crossbar_size, fn, stride, padding, mode, use_cuda)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, gate = ctx.saved_tensors
        crossbar_size, fn, stride, padding, mode, use_cuda = ctx.cfg
        k1, k2, cin, cout = w.shape
        b, oh, ow, _ = g.shape
        m, d = b * oh * ow, k1 * k2 * cin
        patches = im2col(x.float(), (k1, k2), stride=stride, padding=padding)
        need_dx = ctx.needs_input_grad[0]
        dpat, dw2d = _cm.segmented_bwd(use_cuda)(
            g.float().reshape(m, cout), patches.reshape(m, d),
            w.float().reshape(d, cout),
            None if gate is None else gate.reshape(gate.shape[0], m, -1),
            crossbar_size=crossbar_size, fn=fn, mode=mode, need_dx=need_dx,
            need_dw=ctx.needs_input_grad[1])
        dx = None
        if need_dx:
            dx = _col2im(dpat.reshape(b, oh, ow, d), tuple(x.shape),
                         (k1, k2), stride, padding).to(x.dtype)
        dw = None if dw2d is None else dw2d.reshape(w.shape).to(w.dtype)
        return dx, dw, None, None, None, None, None, None
