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
  * cadc_conv2d_bwd_cuda — K2 for the tap-aligned conv
                        (csrc/cadc_conv_bwd.cu; replaces the Pallas
                        `_segmented_bwd` bodies as the JAX
                        `_diff_conv_op` reaches them): a dgrad and a
                        wgrad kernel that read x, g, w and K3's gate where
                        they lie — no patches, no dpatches, no `_col2im` —
                        under the plan `plan_conv_bwd` picks from the shapes
                        and the gate mode. dx is bitwise the patches route;
                        dw sums its M-splits in order inside the launch.
  * cadc_conv2d_bwd_torch — its plain version, the patches route: im2col
                        patches, K2's plain version over them (dpatches and
                        dw), then `_col2im` folds dpatches back to dx.
  * CadcConv2dFn      — forward K3; backward as the JAX `_diff_conv_op`:
                        the tap kernels where `plan_conv_bwd` says "tap",
                        else the patches route with K2 (the stems, LeNet-5,
                        recompute, N not a multiple of 4, operands off 16
                        bytes).
  * cadc_conv2d_q8_cuda — K5 (csrc/cadc_conv.cu; replaces the Pallas
                        `_q8_kernel` / `_q8_kernel_with_gate`): int8 codes,
                        an int32 psum per segment over its taps, one fp32
                        scale read from device memory, f, the sequential
                        sum; the gate as K3's. One launch under the plan
                        `plan_conv_q8` picks from the shapes: the
                        tap-aligned int8 tensor-core kernel (Cin and xbar
                        multiples of 32; it reads the codes as [Cout, D],
                        `q8_tap_weights`) with a tile that fills the card,
                        or the gather kernel; every plan gives the plain
                        version's bits.
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
_BWD_SOURCE = "cadc_conv_bwd.cu"
# K3's launch plans (`plan_conv`; csrc/cadc_conv.cu `cadc_conv_launch`).
PLAN_KERNELS = ("gather", "tap")
GATHER_TILE = (64, 64)
# The tap kernel's (BM, BN) tiles, preferred first: 8 x 8 micro-tiles on
# 128 threads, then 8 x 4 on 128 threads; two blocks an SM.
TAP_TILES = ((128, 64), (64, 64))
TAP_ALIGN = 32   # rows of a k-tile: Cin and xbar multiples of it
# K5's tap kernel (`plan_conv_q8`; csrc/cadc_conv.cu `q8_tap_kernel`): its
# (BM, BN) tiles, preferred first — warps of 64 x 32 outputs on 128 x 64,
# 32 x 32 on the others. 128 x 128 is slower at VGG-16's and ResNet-18's
# convs (tools/profile_k5_variants.py; PERF.md).
Q8_TAP_TILES = ((128, 64), (64, 64), (64, 32))


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


def _geometry(x_shape, w_shape, stride, padding):
    """(pt, pl, OH, OW) of a conv from the shapes of x and w."""
    k1, k2 = w_shape[0], w_shape[1]
    (pt, pb), (pl, pr) = _norm_padding(padding, (k1, k2), (1, 1))
    oh = (x_shape[1] + pt + pb - k1) // stride[0] + 1
    ow = (x_shape[2] + pl + pr - k2) // stride[1] + 1
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
        return (self.grid[0] <= _cm._GRID_X_MAX
                and max(self.grid[1:]) <= _cm._GRID_YZ_MAX)


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


def _plan(tiles, m: int, n: int, cin: int, crossbar_size: int, force,
          what: str) -> ConvPlan:
    """The plan of a forward conv kernel with tap tiles `tiles` (preferred
    first): see plan_conv."""
    aligned = tap_aligned(cin, crossbar_size)
    if force is not None:
        kernel, tile = force[0], tuple(force[1])
        ok = ((kernel == "tap" and aligned and tile in tiles)
              or (kernel == "gather" and tile == GATHER_TILE))
        if not ok:
            raise ValueError(f"no such {what} plan {force} for M={m} N={n} "
                             f"Cin={cin} xbar={crossbar_size}")
        return _make_conv_plan(kernel, tile, m, n)
    if not aligned:
        return _make_conv_plan("gather", GATHER_TILE, m, n)
    narrow = min(t[1] for t in tiles)
    plans = [_make_conv_plan("tap", t, m, n) for t in tiles
             if t[1] <= max(n, narrow)]
    return next((p for p in plans if p.blocks >= _cm.SMS), plans[-1])


def plan_conv(m: int, n: int, cin: int, crossbar_size: int, *,
              _force=None) -> ConvPlan:
    """K3's launch plan for M = B*OH*OW output pixels, N = Cout, from the
    shapes alone (never the gate mode):

      * the tap kernel where `tap_aligned(cin, crossbar_size)`: of the
        tiles of TAP_TILES no wider than N (or the narrowest), the first
        whose grid has SMS blocks, else the last;
      * else the gather kernel with 64 x 64 tiles.

    There is no split over segments. Every plan computes the same psums in
    the same order, so every plan gives the same bits. `_force` = (kernel,
    tile) builds that plan instead, for tests."""
    return _plan(TAP_TILES, m, n, cin, crossbar_size, _force, "K3")


def plan_conv_q8(m: int, n: int, cin: int, crossbar_size: int, *,
                 _force=None) -> ConvPlan:
    """K5's launch plan, as plan_conv with the int8 tap kernel's tiles
    Q8_TAP_TILES: the tap kernel where `tap_aligned(cin, crossbar_size)`
    (the first of its tiles no wider than N whose grid has SMS blocks, else
    the last), else the gather kernel. No split over segments: a bitwise
    split would keep every segment's f(psum) ([S, M, N] fp32 scratch); the
    tile fills the card instead. Every plan gives the plain version's
    bits. `_force` = (kernel, tile) builds that plan instead, for tests."""
    return _plan(Q8_TAP_TILES, m, n, cin, crossbar_size, _force, "K5")


def conv_plans(m: int, n: int, cin: int, crossbar_size: int, *,
               q8: bool = False) -> List[ConvPlan]:
    """Every plan the shape admits, K3's (or with q8, K5's): the gather
    kernel, and the tap kernel at each of its tiles where the shape is
    tap-aligned."""
    tiles, planner = ((Q8_TAP_TILES, plan_conv_q8) if q8
                      else (TAP_TILES, plan_conv))
    forces = [("gather", GATHER_TILE)]
    if tap_aligned(cin, crossbar_size):
        forces += [("tap", t) for t in tiles]
    return [planner(m, n, cin, crossbar_size, _force=f) for f in forces]


def q8_tap_weights(w_codes: Tensor) -> Tensor:
    """The HWIO codes w [K1, K2, Cin, Cout] as the [Cout, D] int8 matrix
    the int8 tap kernel reads (D = K1*K2*Cin, taps outer, channels
    fastest): mma's B operand wants each channel's D codes contiguous."""
    k1, k2, cin, cout = w_codes.shape
    return w_codes.reshape(k1 * k2 * cin, cout).t().contiguous()


# The conv backward's plans (`plan_conv_bwd`; csrc/cadc_conv_bwd.cu). dx
# tiles are (input pixels, input channels), dw tiles (rows of D, columns of
# Cout), each preferred first. A tile's channels (dx) or rows (dw) must
# divide Cin and xbar, so they lie in one segment at every tap.
DX_TILES = ((128, 64), (64, 64), (128, 32), (64, 32))
DW_TILES = ((64, 128), (64, 64), (32, 128), (32, 64))
# A dx tile's time per multiply-add against 128 x 64's (8 x 8 micro-tiles),
# from tools/profile_k2_conv.py at ResNet-18's stage-0 conv, where every
# tile fills the card evenly (H100 80GB HBM3, 700 W; PERF.md).
_DX_TILE_COST = {(128, 64): 1.0, (64, 64): 1.14, (128, 32): 1.24,
                 (64, 32): 1.26}
# dx runs two blocks an SM, dw three. dw splits M into as many ranges as
# keep the grid within one wave of _DW_TARGET_BLOCKS, each at least
# _DW_MIN_ROWS output pixels (a multiple of 32), at most _DW_MAX_SPLITS: the
# last block of a tile adds them all.
_DX_SLOTS = 2 * _cm.SMS
_DW_TARGET_BLOCKS = 3 * _cm.SMS
_DW_MIN_ROWS = 256
_DW_MAX_SPLITS = 64


class ConvBwdPlan(NamedTuple):
    """A conv backward: `kernel` 'tap' (the dgrad and wgrad kernels) or
    'patches' (im2col, K2, `_col2im`; `why` says what rules the tap kernels
    out). For 'tap': the dx tile and grid (pixel tiles of the largest
    stride class, channel tiles, classes), the dw tile and grid (Cout
    tiles, D tiles, splits) and the output pixels of each split."""
    kernel: str
    why: str = ""
    dx_tile: Tuple[int, int] = (0, 0)
    dx_grid: Tuple[int, int, int] = (0, 0, 0)
    dw_tile: Tuple[int, int] = (0, 0)
    dw_grid: Tuple[int, int, int] = (0, 0, 0)
    dw_rows: int = 0

    @property
    def dx_blocks(self) -> int:
        return self.dx_grid[0] * self.dx_grid[1] * self.dx_grid[2]

    @property
    def dw_blocks(self) -> int:
        return self.dw_grid[0] * self.dw_grid[1] * self.dw_grid[2]

    @property
    def dw_splits(self) -> int:
        return self.dw_grid[2]

    def fits(self) -> bool:
        """Both grids are within CUDA's limits."""
        return all(gr[0] <= _cm._GRID_X_MAX
                   and max(gr[1:]) <= _cm._GRID_YZ_MAX
                   for gr in (self.dx_grid, self.dw_grid))


def _in_segment(channels: int, cin: int, crossbar_size: int) -> bool:
    """Every aligned group of `channels` channels of a tap lies in one
    segment."""
    return cin % channels == 0 and crossbar_size % channels == 0


def _bwd_tap_plan(x_shape, w_shape, stride, m, dx_tile, dw_tile,
                  split) -> ConvBwdPlan:
    b, h, wd, cin = x_shape
    k1, k2, _, cout = w_shape
    s1, s2 = stride
    px = b * -(-h // s1) * -(-wd // s2)
    dx_grid = (-(-px // dx_tile[0]), cin // dx_tile[1], s1 * s2)
    rows = _split_rows(m, split)
    dw_grid = (-(-cout // dw_tile[1]), k1 * k2 * cin // dw_tile[0],
               -(-m // rows))
    return ConvBwdPlan("tap", "", dx_tile, dx_grid, dw_tile, dw_grid, rows)


def plan_conv_bwd(x_shape, w_shape, stride, padding, crossbar_size: int,
                  mode: str, *, _force=None) -> ConvBwdPlan:
    """The conv backward's plan from the shapes (x [B, H, W, Cin], w [K1, K2,
    Cin, Cout]) and the resolved gate mode:

      * 'patches' where the tap kernels do not apply: Cin or xbar not a
        multiple of 32 (the stems, LeNet-5), the recompute gate, Cout not a
        multiple of 4;
      * else 'tap'. dx: the tile of DX_TILES whose channels divide Cin and
        xbar with the least `_dx_makespan` (ties: the first);
        dw: 64 rows of D where 64 divides Cin and xbar, else 32; 128 or 64
        columns (128 only where Cout is at least 128), whichever fills its
        waves of _DW_TARGET_BLOCKS block slots best (then more blocks,
        then 128); M split so that at most _DW_TARGET_BLOCKS blocks run, at
        least _DW_MIN_ROWS output pixels a split, at most _DW_MAX_SPLITS
        splits.

    dx is bitwise the same under every plan; dw sums each plan's splits in
    order (the same bits on every run of a plan). `_force` = (dx tile, dw
    tile, splits) builds that tap plan instead, for tests. Plans are
    cached: the backward of every conv asks for one each step."""
    if not isinstance(padding, str):
        padding = tuple(tuple(int(v) for v in pad) for pad in padding)
    if _force is not None:
        _force = (tuple(_force[0]), tuple(_force[1]), int(_force[2]))
    return _plan_conv_bwd(tuple(int(v) for v in x_shape),
                          tuple(int(v) for v in w_shape),
                          tuple(int(v) for v in stride), padding,
                          int(crossbar_size), mode, _force)


@functools.lru_cache(maxsize=4096)
def _plan_conv_bwd(x_shape, w_shape, stride, padding, crossbar_size, mode,
                   _force) -> ConvBwdPlan:
    k1, k2, cin, cout = w_shape
    _, _, oh, ow = _geometry(x_shape, w_shape, stride, padding)
    m = x_shape[0] * oh * ow
    why = ("Cin or xbar not a multiple of 32"
           if not tap_aligned(cin, crossbar_size)
           else "the recompute gate" if mode == "recompute"
           else "Cout not a multiple of 4" if cout % 4 else "")
    if _force is not None:
        dx_tile, dw_tile, split = _force
        if (why or dx_tile not in DX_TILES or dw_tile not in DW_TILES
                or not _in_segment(dx_tile[1], cin, crossbar_size)
                or not _in_segment(dw_tile[0], cin, crossbar_size)
                or not 1 <= split <= max(1, -(-m // 32))):
            raise ValueError(f"no such plan {_force} for x {tuple(x_shape)}"
                             f" w {tuple(w_shape)} xbar={crossbar_size} "
                             f"mode={mode!r}" + (f" ({why})" if why else ""))
        return _bwd_tap_plan(x_shape, w_shape, stride, m, dx_tile, dw_tile,
                             split)
    if why:
        return ConvBwdPlan("patches", why)
    rows = next(t[0] for t in DW_TILES
                if _in_segment(t[0], cin, crossbar_size))
    dw = [_dw_split((rows, cols), cout, k1 * k2 * cin, m)
          for cols in sorted({t[1] for t in DW_TILES}, reverse=True)
          if cols == 64 or cout >= cols]
    dw_tile, split = max(dw, key=lambda ts: _dw_fill(ts, cout, k1 * k2 * cin))
    plans = [_bwd_tap_plan(x_shape, w_shape, stride, m, t, dw_tile, split)
             for t in DX_TILES if _in_segment(t[1], cin, crossbar_size)]
    return min(plans, key=lambda p: _dx_makespan(x_shape, w_shape, stride,
                                                 padding, p.dx_tile))


def _dx_makespan(x_shape, w_shape, stride, padding, tile) -> float:
    """dx's time under a tile, in multiply-adds of 128 x 64 tiles: the work
    spread over _DX_SLOTS blocks at a time, or the longest block's (a stride
    class with every live tap), whichever is more. Stride classes of a
    stride-2 3 x 3 conv have 4, 2, 2 and 1 live taps: large tiles there leave
    the card waiting for the 4-tap blocks."""
    b, h, wd, cin = x_shape
    k1, k2 = w_shape[0], w_shape[1]
    s1, s2 = stride
    pt, pl, _, _ = _geometry(x_shape, w_shape, stride, padding)
    bm, bn = tile
    total = longest = 0
    for ph in range(s1):
        for pw in range(s2):
            rows = (b * len(range((ph - pt) % s1, h, s1))
                    * len(range((pw - pl) % s2, wd, s2)))
            taps = len(range(ph, k1, s1)) * len(range(pw, k2, s2))
            blocks = -(-rows // bm) * (cin // bn)
            total += blocks * bm * bn * taps
            if blocks:
                longest = max(longest, bm * bn * taps)
    return _DX_TILE_COST[tile] * max(total / _DX_SLOTS, longest)


def _split_rows(m: int, split: int) -> int:
    """Output pixels of each of `split` ranges of M: whole 32-pixel
    k-tiles (the last range may be shorter; there may be fewer ranges)."""
    per_split = -(-m // split)
    return max(32, -(-per_split // 32) * 32)


def _dw_split(tile, cout: int, d: int, m: int) -> Tuple[Tuple[int, int], int]:
    """(tile, splits of M) for a dw tile: as many splits as keep the grid
    within _DW_TARGET_BLOCKS, within the row and split limits."""
    tiles = -(-cout // tile[1]) * (d // tile[0])
    split = max(1, min(_DW_TARGET_BLOCKS // tiles, -(-m // _DW_MIN_ROWS),
                       _DW_MAX_SPLITS))
    if tiles > _cm.N_COUNTERS:
        split = 1
    return tile, max(1, -(-m // _split_rows(m, split)))


def _dw_fill(tile_split, cout: int, d: int) -> Tuple[float, int, int]:
    """How well a dw tile and split fill the card: the share of the last
    wave's block slots (_DW_TARGET_BLOCKS a wave) in use, then the blocks,
    then the wider tile."""
    (rows, cols), split = tile_split
    blocks = -(-cout // cols) * (d // rows) * split
    waves = -(-blocks // _DW_TARGET_BLOCKS)
    return blocks / (waves * _DW_TARGET_BLOCKS), blocks, cols


def conv_bwd_plans(x_shape, w_shape, stride, padding, crossbar_size: int,
                   mode: str) -> List[ConvBwdPlan]:
    """The planner's plan, then every other dx tile and dw tile the shape
    admits (with the planner's split), then the planner's tiles with dw
    unsplit and at twice the planner's splits (tests hold every dx to the
    planner's bits)."""
    plan = plan_conv_bwd(x_shape, w_shape, stride, padding, crossbar_size,
                         mode)
    if plan.kernel != "tap":
        return []
    cin = w_shape[2]
    forces = [(t, plan.dw_tile, plan.dw_splits) for t in DX_TILES
              if _in_segment(t[1], cin, crossbar_size)]
    forces += [(plan.dx_tile, t, plan.dw_splits) for t in DW_TILES
               if _in_segment(t[0], cin, crossbar_size)]
    forces += [(plan.dx_tile, plan.dw_tile, s)
               for s in (1, 2 * plan.dw_splits)]
    out = [plan]
    for f in forces:
        try:
            p = plan_conv_bwd(x_shape, w_shape, stride, padding,
                              crossbar_size, mode, _force=f)
        except ValueError:  # more splits than M has k-tiles
            continue
        if p not in out:
            out.append(p)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_conv_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [ctypes.c_void_p])
    lib.cadc_conv_launch.restype = ctypes.c_int
    lib.cadc_conv_q8_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19 + [ctypes.c_void_p])
    lib.cadc_conv_q8_launch.restype = ctypes.c_int
    lib.cadc_conv_error_string.argtypes = [ctypes.c_int]
    lib.cadc_conv_error_string.restype = ctypes.c_char_p
    return lib


def _conv_launch(name: str, x: Tensor, w: Tensor, crossbar_size: int,
                 fn: str, stride, padding, mode: str,
                 scale: Optional[Tensor], plan: Optional[ConvPlan] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """K3 (scale None) or K5 on checked CUDA tensors: one launch under
    `plan` (default: plan_conv's or plan_conv_q8's, or the gather kernel
    where an operand the tap kernel reads does not start on 16 bytes; a
    given tap plan then raises)."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"want x [B, H, W, Cin] and w [K1, K2, Cin, Cout]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if mode in ("packed", "bytes") and dendritic.gate_dtype(fn) is None:
        raise ValueError(f"dendritic fn {fn!r} has no gate to save")
    b, h, wd, cin = x.shape
    k1, k2, _, cout = w.shape
    pt, pl, oh, ow = _geometry(x.shape, w.shape, stride, padding)
    m, d = b * oh * ow, k1 * k2 * cin
    n_seg = -(-d // crossbar_size)
    x, w = x.contiguous(), w.contiguous()
    # K5's tap kernel reads the codes from a fresh [Cout, D] copy
    aligned = x.data_ptr() % 16 == 0 and (scale is not None
                                          or w.data_ptr() % 16 == 0)
    planner = plan_conv if scale is None else plan_conv_q8
    if plan is None:
        plan = planner(m, cout, cin, crossbar_size)
        if plan.kernel == "tap" and not aligned:
            plan = _make_conv_plan("gather", GATHER_TILE, m, cout)
    elif plan != planner(m, cout, cin, crossbar_size,
                         _force=(plan.kernel, plan.tile)):
        raise ValueError(f"{name}: plan {plan} is not one of this shape's")
    elif plan.kernel == "tap" and not aligned:
        raise ValueError(f"{name}: the tap kernel needs x"
                         f"{' and w' if scale is None else ''} on 16-byte "
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
        kernel = PLAN_KERNELS.index(plan.kernel)
        if scale is None:
            code = lib.cadc_conv_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), gptr, *geo,
                kernel, *plan.tile, stream)
        else:
            wt = q8_tap_weights(w) if plan.kernel == "tap" else None
            code = lib.cadc_conv_q8_launch(
                x.data_ptr(), w.data_ptr(),
                None if wt is None else wt.data_ptr(), scale.data_ptr(),
                y.data_ptr(), gptr, *geo, kernel, *plan.tile, stream)
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
    `mode` or None), one launch under plan_conv_q8's plan. Raises on
    anything else. Counts its launches in `cadc_conv2d_q8_cuda.launches`."""
    _cm._check_cuda("cadc_conv2d_q8_cuda", fn, x_q, w_codes,
                    dtypes={torch.int8: 2})
    scale = _cm._check_scale("cadc_conv2d_q8_cuda", scale, x_q.device)
    y, gate = _conv_launch("cadc_conv2d_q8_cuda", x_q, w_codes,
                           crossbar_size, fn, stride, padding, mode, scale)
    if y.numel():
        cadc_conv2d_q8_cuda.launches += 1
    return y, gate


cadc_conv2d_q8_cuda.launches = 0


def _bwd_patches(bwd, g: Tensor, x: Tensor, w: Tensor,
                 gate: Optional[Tensor], *, crossbar_size: int, fn: str,
                 stride, padding, mode: str, need_dx: bool = True,
                 need_dw: bool = True
                 ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """The conv backward over patches: P = im2col(x), `bwd` (K2 or its
    plain version) over P, then `_col2im` of the dpatches."""
    k1, k2, cin, cout = w.shape
    b, oh, ow, _ = g.shape
    m, d = b * oh * ow, k1 * k2 * cin
    stride = tuple(stride)
    patches = im2col(x.float(), (k1, k2), stride=stride, padding=padding)
    dpat, dw2d = bwd(
        g.float().reshape(m, cout), patches.reshape(m, d),
        w.float().reshape(d, cout),
        None if gate is None else gate.reshape(gate.shape[0], m, -1),
        crossbar_size=crossbar_size, fn=fn, mode=mode, need_dx=need_dx,
        need_dw=need_dw)
    dx = None
    if need_dx:
        dx = _col2im(dpat.reshape(b, oh, ow, d), tuple(x.shape), (k1, k2),
                     stride, padding)
    return dx, None if dw2d is None else dw2d.reshape(w.shape)


def cadc_conv2d_bwd_torch(g: Tensor, x: Tensor, w: Tensor,
                          gate: Optional[Tensor], *, crossbar_size: int,
                          fn: str, stride=(1, 1), padding="SAME",
                          mode: str = "none", need_dx: bool = True,
                          need_dw: bool = True
                          ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """The conv backward's plain version (the patches route): g [B, OH, OW,
    Cout], x [B, H, W, Cin], w [K1, K2, Cin, Cout], the gate K3 saved for
    `mode` (a resolved gate mode) or None -> (dx [B, H, W, Cin], dw [K1, K2,
    Cin, Cout]) fp32, None where not wanted."""
    return _bwd_patches(_cm.cadc_segmented_bwd_torch, g, x, w, gate,
                        crossbar_size=crossbar_size, fn=fn, stride=stride,
                        padding=padding, mode=mode, need_dx=need_dx,
                        need_dw=need_dw)


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library(_BWD_SOURCE)
    lib.cadc_conv_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 21 + [ctypes.c_void_p])
    lib.cadc_conv_bwd_launch.restype = ctypes.c_int
    lib.cadc_conv_bwd_error_string.argtypes = [ctypes.c_int]
    lib.cadc_conv_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _aligned16(*ts: Optional[Tensor]) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def cadc_conv2d_bwd_cuda(g: Tensor, x: Tensor, w: Tensor,
                         gate: Optional[Tensor], *, crossbar_size: int,
                         fn: str, stride=(1, 1), padding="SAME",
                         mode: str = "none", need_dx: bool = True,
                         need_dw: bool = True,
                         plan: Optional[ConvBwdPlan] = None
                         ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """K2 for the tap-aligned conv: (dx, dw) as cadc_conv2d_bwd_torch from
    fp32 g, x, w on one CUDA device and K3's gate of `mode`, by the dgrad
    and wgrad kernels under `plan` (default: plan_conv_bwd's), one launch
    each. Raises where the plan names the patches route, on another
    shape's plan, and on operands off 16 bytes. dx is bitwise the patches
    route; dw sums its splits in order (the same bits on every run).
    Counts its calls in `cadc_conv2d_bwd_cuda.launches`."""
    name = "cadc_conv2d_bwd_cuda"
    _cm._check_cuda(name, fn, g, x, w, dtypes={torch.float32: 0})
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"want x [B, H, W, Cin] and w [K1, K2, Cin, Cout]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    stride = tuple(int(s) for s in stride)
    b, h, wd, cin = x.shape
    k1, k2, _, cout = w.shape
    pt, pl, oh, ow = _geometry(x.shape, w.shape, stride, padding)
    if tuple(g.shape) != (b, oh, ow, cout):
        raise ValueError(f"want g {(b, oh, ow, cout)}; got {tuple(g.shape)}")
    m, d = b * oh * ow, k1 * k2 * cin
    if plan is None:
        plan = plan_conv_bwd(x.shape, w.shape, stride, padding,
                             crossbar_size, mode)
    elif plan != plan_conv_bwd(
            x.shape, w.shape, stride, padding, crossbar_size, mode,
            _force=(plan.dx_tile, plan.dw_tile, plan.dw_splits)):
        raise ValueError(f"{name}: plan {plan} is not one of this shape's")
    if plan.kernel != "tap":
        raise ValueError(f"{name}: the plan names the patches route "
                         f"({plan.why})")
    kind = _cm._gate_kind(mode, fn)
    if kind != _cm._GATE_NONE:
        n_seg = -(-d // crossbar_size)
        words = kind == _cm._GATE_PACKED
        want_dt = {_cm._GATE_PACKED: torch.int32, _cm._GATE_U8: torch.bool,
                   _cm._GATE_F32: torch.float32}[kind]
        shape = (n_seg, m, _cm._n_words(cout) if words else cout)
        if (gate is None or gate.numel() != n_seg * m * shape[2]
                or gate.dtype != want_dt or gate.device != x.device):
            raise ValueError(f"mode {mode!r} wants a {want_dt} gate of "
                             f"shape {shape} on {x.device}")
        gate = gate.contiguous().reshape(shape)
    else:
        gate = None
    g, x, w = g.contiguous(), x.contiguous(), w.contiguous()
    if not _aligned16(g, x, w, gate):
        raise ValueError(f"{name}: the tap kernels need g, x, w and the gate "
                         f"on 16-byte boundaries")
    if not plan.fits():
        raise ValueError(f"{name}: {plan} exceeds CUDA's grid")
    dx = torch.empty(x.shape, device=x.device) if need_dx else None
    dw = torch.empty(w.shape, device=x.device) if need_dw else None
    if not (need_dx or need_dw):
        return dx, dw
    if m == 0 or 0 in x.shape:
        for t in (dx, dw):
            if t is not None:
                t.zero_()
        return dx, dw
    scratch = counters = None
    if need_dw and plan.dw_splits > 1:
        scratch = torch.empty((plan.dw_splits, d, cout), device=x.device)
        counters = _cm._counters(x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, "cadc_conv_bwd", lib.cadc_conv_bwd_launch(
        g.data_ptr(), x.data_ptr(), w.data_ptr(), ptr(gate), ptr(dx),
        ptr(dw), ptr(scratch), ptr(counters), b, h, wd, cin, k1, k2, cout,
        oh, ow, stride[0], stride[1], pt, pl, crossbar_size, kind,
        *plan.dx_tile, *plan.dw_tile, plan.dw_splits, plan.dw_rows,
        stream))
    cadc_conv2d_bwd_cuda.launches += 1
    return dx, dw


cadc_conv2d_bwd_cuda.launches = 0


class CadcConv2dFn(torch.autograd.Function):
    """The CADC conv with K3 forward (saving the gate of `mode`) and the
    backward of the JAX `_diff_conv_op`: the tap kernels
    (`cadc_conv2d_bwd_cuda`) where `plan_conv_bwd` says "tap" and the
    operands lie on 16 bytes, else the patches route with K2 — or the plain
    version when use_cuda is False."""

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
        kw = dict(crossbar_size=crossbar_size, fn=fn, stride=stride,
                  padding=padding, mode=mode,
                  need_dx=ctx.needs_input_grad[0],
                  need_dw=ctx.needs_input_grad[1])
        g = g.float().contiguous()
        if use_cuda and not _aligned16(g):
            g = g.clone()
        tap = use_cuda and _aligned16(x, w, gate) and plan_conv_bwd(
            x.shape, w.shape, stride, padding, crossbar_size,
            mode).kernel == "tap"
        if tap:
            dx, dw = cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
        else:
            dx, dw = _bwd_patches(_cm.segmented_bwd(use_cuda), g, x, w, gate,
                                  **kw)
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype),
                None, None, None, None, None, None)


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
