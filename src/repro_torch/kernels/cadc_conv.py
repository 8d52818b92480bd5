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
                        an implicit GEMM that reads patches from x as it
                        goes, optionally writing the gate
                        [S, B, OH, OW, ceil(Cout/32)] words or
                        [S, B, OH, OW, Cout] bytes / fp32, as K1g. One
                        launch under the plan `plan_conv` picks from the
                        shapes: the tap-aligned kernel (Cin and xbar
                        multiples of 32) with a tile that fills the card,
                        or the gather kernel; every plan gives the same
                        bits.
  * cadc_conv2d_torch — the plain version: im2col, then the per-segment
                        loop of K1g's plain version (f, sequential sum,
                        the gate).
  * CadcConv2dFn      — forward K3; backward as the JAX `_diff_conv_op`:
                        im2col patches again, K2 over them (dpatches and
                        dw), then `_col2im` folds dpatches back to dx.
  * cadc_conv2d_q8_cuda — K5 (csrc/cadc_conv.cu; replaces the Pallas
                        `_q8_kernel` / `_q8_kernel_with_gate`): int8 codes,
                        an int32 psum per segment over its taps, one fp32
                        scale read from device memory, f, the sequential
                        sum; the gate as K3's.
  * cadc_conv2d_q8_torch — its plain version: im2col of the codes, then K4's
                        plain version (exact fp32 psums of the codes).
  * CadcConv2dQ8Fn    — forward K5; the straight-through backward of
                        `_diff_conv_q8_op`: K2 over the codes' patches,
                        times scale, `_col2im`; d(scale) = <dw_unscaled, w>.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cadc as core_cadc
from repro_torch.core import dendritic
from repro_torch.core.conv import _norm_padding, im2col
from repro_torch.kernels import _build
from repro_torch.kernels import cadc_matmul as _cm

Tensor = torch.Tensor
_SOURCE = "cadc_conv.cu"
# K3's launch plans (`plan_conv`; csrc/cadc_conv.cu `cadc_conv_launch`).
PLAN_KERNELS = ("gather", "tap")
GATHER_TILE = (64, 64)
# The tap kernel's (BM, BN) tiles, preferred first: 8 x 8 micro-tiles on
# 128 threads, then 8 x 4 on 128 threads; two blocks an SM.
TAP_TILES = ((128, 64), (64, 64))
TAP_ALIGN = 32   # rows of a k-tile: Cin and xbar multiples of it
_GRID_X_MAX, _GRID_YZ_MAX = 2 ** 31 - 1, 65535


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


def cadc_conv2d_q8_torch(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                         crossbar_size: int, fn: str, stride=(1, 1),
                         padding="SAME", mode: str = "none"
                         ) -> Tuple[Tensor, Optional[Tensor]]:
    """K5's plain version: x_q [B, H, W, Cin], w_codes [K1, K2, Cin, Cout]
    integer codes (int8, or floats holding them), scale one fp32 ->
    (y [B, OH, OW, Cout] fp32, gate or None)."""
    k1, k2, cin, cout = w_codes.shape
    patches = im2col(x_q.float(), (k1, k2), stride=tuple(stride),
                     padding=padding)
    b, oh, ow, d = patches.shape
    y, gate = _cm.cadc_matmul_q8_gate_torch(
        core_cadc.pad_to_segments(patches.reshape(-1, d), -1, crossbar_size),
        core_cadc.pad_to_segments(w_codes.float().reshape(d, cout), 0,
                                  crossbar_size),
        scale, crossbar_size=crossbar_size, fn=fn, mode=mode)
    if gate is not None:
        gate = gate.reshape(gate.shape[0], b, oh, ow, -1)
    return y.reshape(b, oh, ow, cout), gate


class ConvPlan(NamedTuple):
    """A K3 launch: `kernel` 'tap' (the tap-aligned kernel) or 'gather';
    `tile` (BM output pixels, BN output channels) of a block; `grid` (x, y,
    z) of the one launch: pixel tiles on x for the tap kernel, channel
    tiles on x for the gather kernel."""
    kernel: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def fits(self) -> bool:
        """The grid is within CUDA's limits."""
        return (self.grid[0] <= _GRID_X_MAX
                and max(self.grid[1:]) <= _GRID_YZ_MAX)


def tap_aligned(cin: int, crossbar_size: int) -> bool:
    """Every 32-row k-tile of the contraction lies in one tap and one
    segment: the tap kernel applies."""
    return cin % TAP_ALIGN == 0 and crossbar_size % TAP_ALIGN == 0


def _make_conv_plan(kernel: str, tile: Tuple[int, int], m: int,
                    n: int) -> ConvPlan:
    bm, bn = tile
    rows, cols = -(-m // bm), -(-n // bn)
    grid = (rows, cols, 1) if kernel == "tap" else (cols, rows, 1)
    return ConvPlan(kernel, tile, grid)


def plan_conv(m: int, n: int, cin: int, crossbar_size: int, *,
              _force=None) -> ConvPlan:
    """K3's launch plan for M = B*OH*OW output pixels, N = Cout, from the
    shapes alone (never the gate mode):

      * the tap kernel where `tap_aligned(cin, crossbar_size)`: the first
        tile of TAP_TILES whose grid has SMS blocks, else the smallest;
      * else the gather kernel with 64 x 64 tiles.

    There is no split over segments. Every plan computes the same psums in
    the same order, so every plan gives the same bits. `_force` = (kernel,
    tile) builds that plan instead, for tests."""
    aligned = tap_aligned(cin, crossbar_size)
    if _force is not None:
        kernel, tile = _force[0], tuple(_force[1])
        ok = ((kernel == "tap" and aligned and tile in TAP_TILES)
              or (kernel == "gather" and tile == GATHER_TILE))
        if not ok:
            raise ValueError(f"no such plan {_force} for M={m} N={n} "
                             f"Cin={cin} xbar={crossbar_size}")
        return _make_conv_plan(kernel, tile, m, n)
    if not aligned:
        return _make_conv_plan("gather", GATHER_TILE, m, n)
    plans = [_make_conv_plan("tap", t, m, n) for t in TAP_TILES]
    return next((p for p in plans if p.blocks >= _cm.SMS), plans[-1])


def conv_plans(m: int, n: int, cin: int, crossbar_size: int
               ) -> List[ConvPlan]:
    """Every plan the shape admits: the gather kernel, and the tap kernel
    at each of its tiles where the shape is tap-aligned."""
    forces = [("gather", GATHER_TILE)]
    if tap_aligned(cin, crossbar_size):
        forces += [("tap", t) for t in TAP_TILES]
    return [plan_conv(m, n, cin, crossbar_size, _force=f) for f in forces]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_conv_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [ctypes.c_void_p])
    lib.cadc_conv_launch.restype = ctypes.c_int
    lib.cadc_conv_q8_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    lib.cadc_conv_q8_launch.restype = ctypes.c_int
    lib.cadc_conv_error_string.argtypes = [ctypes.c_int]
    lib.cadc_conv_error_string.restype = ctypes.c_char_p
    return lib


def _conv_launch(name: str, x: Tensor, w: Tensor, crossbar_size: int,
                 fn: str, stride, padding, mode: str,
                 scale: Optional[Tensor], plan: Optional[ConvPlan] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """K3 (scale None) or K5 on checked CUDA tensors. K3 runs one launch
    under `plan` (default: plan_conv's, or the gather kernel where x or w
    does not start on 16 bytes; a given tap plan then raises); K5 runs the
    gather kernel."""
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
    x, w = x.contiguous(), w.contiguous()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if scale is not None:
        if plan is not None:
            raise ValueError(f"{name} runs the gather kernel only")
        plan = _make_conv_plan("gather", GATHER_TILE, m, cout)
    elif plan is None:
        plan = plan_conv(m, cout, cin, crossbar_size)
        if plan.kernel == "tap" and not aligned:
            plan = _make_conv_plan("gather", GATHER_TILE, m, cout)
    elif plan != plan_conv(m, cout, cin, crossbar_size,
                           _force=(plan.kernel, plan.tile)):
        raise ValueError(f"{name}: plan {plan} is not one of this shape's")
    elif plan.kernel == "tap" and not aligned:
        raise ValueError(f"{name}: the tap kernel needs x and w on 16-byte "
                         f"boundaries")
    if not plan.fits():
        raise ValueError(f"{name}: B*OH*OW={m}, Cout={cout} exceed the "
                         f"grid of {plan}")
    y = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    gate = None
    if mode in ("packed", "bytes"):
        gate = _cm._empty_gate(n_seg, m, cout, mode, fn, x.device)
    if m and cout:
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        geo = (b, h, wd, cin, k1, k2, cout, oh, ow, int(stride[0]),
               int(stride[1]), pt, pl, crossbar_size, _cm.FN_IDS[fn],
               _cm._gate_kind(mode if gate is not None else "none", fn))
        gptr = None if gate is None else gate.data_ptr()
        if scale is None:
            code = lib.cadc_conv_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), gptr, *geo,
                PLAN_KERNELS.index(plan.kernel), *plan.tile, stream)
        else:
            code = lib.cadc_conv_q8_launch(x.data_ptr(), w.data_ptr(),
                                           scale.data_ptr(), y.data_ptr(),
                                           gptr, *geo, stream)
        _build.check(lib, "cadc_conv", code)
    return y, (None if gate is None else gate.reshape(n_seg, b, oh, ow, -1))


def cadc_conv2d_cuda(x: Tensor, w: Tensor, *, crossbar_size: int, fn: str,
                     stride=(1, 1), padding="SAME", mode: str = "none"
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    """K3: x [B, H, W, Cin], w [K1, K2, Cin, Cout] fp32 on one CUDA device
    -> (y [B, OH, OW, Cout] fp32, gate of `mode` or None). Raises on
    anything else. Counts its launches in `cadc_conv2d_cuda.launches`."""
    _cm._check_cuda("cadc_conv2d_cuda", fn, x, w,
                    dtypes={torch.float32: 0})
    y, gate = _conv_launch("cadc_conv2d_cuda", x, w, crossbar_size, fn,
                           stride, padding, mode, None)
    if y.numel():
        cadc_conv2d_cuda.launches += 1
    return y, gate


cadc_conv2d_cuda.launches = 0


def cadc_conv2d_q8_cuda(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                        crossbar_size: int, fn: str, stride=(1, 1),
                        padding="SAME", mode: str = "none"
                        ) -> Tuple[Tensor, Optional[Tensor]]:
    """K5: x_q [B, H, W, Cin], w_codes [K1, K2, Cin, Cout] int8 on one CUDA
    device, scale one fp32 there -> (y [B, OH, OW, Cout] fp32, gate of
    `mode` or None). Raises on anything else. Counts its launches in
    `cadc_conv2d_q8_cuda.launches`."""
    _cm._check_cuda("cadc_conv2d_q8_cuda", fn, x_q, w_codes,
                    dtypes={torch.int8: 2})
    scale = _cm._check_scale("cadc_conv2d_q8_cuda", scale, x_q.device)
    y, gate = _conv_launch("cadc_conv2d_q8_cuda", x_q, w_codes,
                           crossbar_size, fn, stride, padding, mode, scale)
    if y.numel():
        cadc_conv2d_q8_cuda.launches += 1
    return y, gate


cadc_conv2d_q8_cuda.launches = 0


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


class CadcConv2dQ8Fn(torch.autograd.Function):
    """The q8 conv on integer codes (int8, or floats holding codes: QAT)
    with K5 forward (saving the gate of `mode`) and the straight-through
    backward of the JAX `_diff_conv_q8_op`: K2 over the codes' im2col
    patches as fp32, times scale, `_col2im`; d(scale) = <dw_unscaled, w>.
    An integer primal gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, scale, crossbar_size: int, fn: str, stride,
                padding, mode: str, use_cuda: bool):
        fmode = mode if mode in ("packed", "bytes") else "none"
        kw = dict(crossbar_size=crossbar_size, fn=fn, stride=stride,
                  padding=padding, mode=fmode)
        if use_cuda:
            y, gate = cadc_conv2d_q8_cuda(_cm._as_codes(x), _cm._as_codes(w),
                                          scale, **kw)
        else:
            y, gate = cadc_conv2d_q8_torch(x, w, scale, **kw)
        ctx.save_for_backward(x, w, scale, gate)
        ctx.cfg = (crossbar_size, fn, stride, padding, mode, use_cuda)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, gate = ctx.saved_tensors
        crossbar_size, fn, stride, padding, mode, use_cuda = ctx.cfg
        k1, k2, cin, cout = w.shape
        b, oh, ow, _ = g.shape
        m, d = b * oh * ow, k1 * k2 * cin
        s32 = scale.float().reshape(())
        w2d = w.float().reshape(d, cout)
        patches = im2col(x.float(), (k1, k2), stride=stride, padding=padding)
        need_dx = ctx.needs_input_grad[0]
        dpat, dw2d = _cm.segmented_bwd(use_cuda)(
            g.float().reshape(m, cout), patches.reshape(m, d), w2d,
            None if gate is None else gate.reshape(gate.shape[0], m, -1),
            crossbar_size=crossbar_size, fn=fn, mode=mode, need_dx=need_dx,
            need_dw=True, scale=s32 if mode == "recompute" else None)
        dscale = (dw2d * w2d).sum().reshape(scale.shape).to(scale.dtype)
        dx = dw = None
        if need_dx:
            dx = _col2im((s32 * dpat).reshape(b, oh, ow, d), tuple(x.shape),
                         (k1, k2), stride, padding).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (s32 * dw2d).reshape(w.shape).to(w.dtype)
        return dx, dw, dscale, None, None, None, None, None, None
