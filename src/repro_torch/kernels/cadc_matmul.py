"""CADC segmented matmul with fused dendritic f(), its gate-saving forward
and its segmented backward: CUDA kernels and their plain PyTorch versions.

Port of repro.kernels.cadc_matmul:

    y[M, N] = sum_s f( x[:, s*xbar:(s+1)*xbar] @ w[s*xbar:(s+1)*xbar, :] )

psums are fp32, f is applied per segment, and segments are summed in order
s = 0, 1, ... (the order of kernels/ref.py `cadc_matmul_ref`). Because f
acts per segment the op is not a plain matmul under autodiff: with
p_s = x_s @ w_s and the output cotangent g,

    dx_s = (g ⊙ f'(p_s)) @ w_sᵀ      dw_s = x_sᵀ @ (g ⊙ f'(p_s)).

The forward under autograd saves the per-segment gate f'(p_s) in the
format `save_gate` picks (resolved per dendritic fn):
  * "packed"    — indicator gates (dendritic.gate_packing: relu's p > 0)
                  as uint32 words [S, M, ceil(N/32)], bit b of word w =
                  column 32w + b (the JAX bit layout), N padded to whole
                  words; stored in an int32 tensor (same bits);
  * "bytes"     — one dendritic.gate_dtype element per psum [S, M, N]
                  (torch.bool for relu, float32 for curved fns);
  * "recompute" — nothing: the backward recomputes f'(x_s @ w_s);
  * "auto"      — packed where the fn allows it, else bytes.
identity saves nothing in every mode. `gate_residual_nbytes` gives the
bytes a mode saves.

  * cadc_matmul_cuda / _torch          — K1, the forward (replaces the
                                         Pallas `_kernel`);
  * cadc_matmul_gate_cuda / _torch     — K1g, the forward that also writes
                                         the gate (`_kernel_with_gate`);
  * cadc_segmented_bwd_cuda / _torch   — K2, dx and dw (`_segmented_bwd`
                                         and its six kernel bodies);
  * cadc_matmul_q8_cuda / _torch       — K4, the quantized forward (the
                                         `_q8_kernel` body): int8 codes,
                                         int32 segment psums, one fp32
                                         scale (read from device memory);
  * cadc_matmul_q8_gate_cuda / _torch  — K4g, K4 that also writes the gate
                                         of the dequantized psum
                                         (`_q8_kernel_with_gate`).
The sources are csrc/cadc_matmul.cu (K1, K1g, K4, K4g) and
csrc/cadc_bwd.cu (K2); their notes give the bounds and designs. Each
forward is one launch. K1 and K1g run under the plan `plan_fwd` picks from
the shapes and the operand dtype: for K1 at M <= 8 the stream kernel,
which streams w in 16-byte vectors; else, on bf16 operands, the
tensor-core kernel (`mma.sync` bf16 -> fp32; a row tile and segment
groups, every plan bitwise the single pass); else the tile kernel (single
pass, or split over segments and summed in order by the last block of
each output tile, bitwise the single pass). K4 and K4g run the int8
tensor-core kernel (`mma.sync` s8 ->
s32) under `plan_fwd_q8`: the single pass, or the segments split over
blocks in groups, bitwise the single pass. K2 is at
most two launches (dx, dw) under the plan `plan_bwd` picks from the
shapes, the operands' dtype and the gate: on bf16 operands with a gate of
0s and 1s (relu, identity) the tensor-core kernels ('mma': `mma.sync`
bf16 -> fp32 on the operands as they are), else the CUDA-core kernels on
fp32 operands ('tile' or 'recompute'; bf16 operands copied up first):
tiles narrowed to the segments, dw's M-splits added in order by the last
block of each tile.
K1, K1g and K2 and their plain versions each count as one unit of work
(`product_cost`) to an open work tally (core/work.py; the dry run's
count_cost). `CadcMatmulFn` and `CadcMatmulQ8Fn` are the autograd
Functions around them; kernels/ops.py picks kernel or plain version by the tensors'
device. The kernels take only the five built-in dendritic fns (FN_IDS); a
fn added with dendritic.register() runs on the plain versions. K1, K1g
and K2 take fp32 or bf16, K4 int8.

The q8 plain versions compute each segment's psum as an fp32 product of
the codes: every partial sum is an integer below 2^24 (|code| <= 128 and
xbar <= Q8_MAX_XBAR), so it is exact and equals the kernels' int32 psum —
PyTorch has no int32 matrix product on CUDA. The q8 backward is K2 on the
codes as fp32 (the straight-through estimator of `_diff_matmul_q8_op`),
then scaled by `scale`; d(scale) = <dw_unscaled, w>.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dendritic, work
from repro_torch.kernels import _build

Tensor = torch.Tensor

FN_IDS = {"identity": 0, "relu": 1, "sublinear": 2, "supralinear": 3,
          "tanh": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "cadc_matmul.cu"
_BWD_SOURCE = "cadc_bwd.cu"
# The forward's launch plan (`plan_fwd`) aims for one block per SM of an
# H100 SXM.
SMS = 132
PLAN_KERNELS = ("tile", "stream", "mma")  # csrc/cadc_matmul.cu PlanKernel
_TILE_N = 64                  # columns of a tile-kernel block
_TILE_ROWS = (64, 8)          # its rows, preferred first
_STREAM_MAX_M = 8             # the stream kernel holds 8 rows of x
_STREAM_MAX_XBAR = 512        # its x segment in shared memory: 16 KB
_STREAM_LANES = (8, 4)        # 16-byte vectors per strip, widest first
# The bf16 tensor-core kernel (csrc/cadc_matmul.cu `bf16_mma_kernel`): a
# block owns MMA_ROWS[i] x MMA_COLS outputs of y and walks its segments in
# k16 steps of mma.sync, so xbar must be a multiple of MMA_K; `groups` > 1
# splits the segments over blocks (group 0 keeps the chain of f(psum) sums,
# every later segment's f(psum) goes through an fp32 scratch, and the last
# block of the tile continues the chain in order).
MMA_ROWS = (128, 32)
MMA_COLS = 128
MMA_K = 16
_MMA_BK = 64                  # k of a staged slice
# The planner's model of an mma launch (seconds, `_mma_seconds`), fitted by
# tools/profile_k1_mma.py --refit to its sweep on an H100 80GB HBM3 at
# 700 W: the blocks run in rounds of _MMA_OCC[r] blocks an SM (r rows a
# tile), a block taking _MMA_SLICE_S[r] a _MMA_BK-deep slice of its
# segments; a split's last block of each tile then reads the tile's kept
# slices (group 0's chain and each later segment) at _MMA_MERGE_BYTES, the
# tiles' merges in rounds of SMS; the launch moves x, w, y and a split's
# scratch (written, then read) through HBM at _HBM_BYTES_PER_S at least.
_MMA_OCC = {128: 1, 32: 2}
_MMA_SLICE_S = {128: 1.81e-6, 32: 1.25e-6}
_MMA_MERGE_BYTES = 1.67e10
_HBM_BYTES_PER_S = 3.35e12
# Arrival counters of the ordered segment sum, per device: one per output
# tile of a split plan (the planner never plans more).
N_COUNTERS = 1 << 16
_COUNTERS: dict = {}

# Gate bits per packed word (uint32 lane packing along N).
GATE_PACK_WIDTH = 32
SAVE_GATE_MODES = ("auto", "packed", "bytes", "recompute")
# Resolved gate modes -> the kernels' gate kinds (csrc/cadc_tile.cuh).
_GATE_NONE, _GATE_PACKED, _GATE_U8, _GATE_F32, _GATE_RECOMPUTE = range(5)
# K2's launch plan (`plan_bwd`; csrc/cadc_bwd.cu). A dx tile is rows of M x
# columns of one segment, a dw tile rows of D (columns of one segment) x
# columns of N. The segment width of both is the narrowest of
# BWD_SEG_COLS that covers the widest segment, min(xbar, D); a segment
# wider than 64 takes several tiles. Under the recompute gate dx keeps the
# 64 x 64 kernel and dw takes the saved gates' plan (the same sums).
BWD_SEG_COLS = (32, 64)
# dx tiles (rows, columns), the second of a width where the rows are too
# few to fill the card
BWD_DX_TILES = ((128, 32), (32, 32), (128, 64), (32, 64))
BWD_DW_COLS = (16, 32, 64)
BWD_RECOMPUTE_DX = (64, 64)
# dw splits M into ranges of whole 32-row k-tiles, at least _BWD_MIN_ROWS
# rows each, until about one wave runs (_BWD_SLOTS: two blocks an SM); the
# last block of a tile adds the splits' partials in order. The planner's
# model of dw's time, fitted to tools/profile_k2_matrix.py's times on an
# H100 (80GB HBM3, 700 W): a block takes _KTILE_S[j] + _KTILE_S_OUT[j] x
# (tile outputs) a 64-row k-tile of M, j = 0 with one block on its SM and
# 1 with two (each then slower, together faster); then the tile's last
# block adds the partials: _TAIL_S[0] + splits x (_TAIL_S[1] + _TAIL_S[2] x
# tile outputs) — narrow tiles and fewer splits keep that short.
_BWD_SLOTS = 2 * SMS
_BWD_MIN_ROWS = 256
_KTILE_S = (2.5e-7, 2e-7)
_KTILE_S_OUT = (8.5e-10, 1.6e-9)
_TAIL_S = (1.5e-6, 3.5e-8, 5e-11)
# K2's bf16 route (csrc/cadc_bwd.cu `bf16_bwd_dx_kernel`,
# `bf16_bwd_dw_kernel`; plan kernel "mma"): bf16 g, x, w under a gate of
# 0s and 1s (none, packed words, bytes) at an xbar of whole k16 steps. dx
# in tiles of MMA_BWD_DX_TILES (rows of M, segment columns), a block a
# tile, contracting over N; dw in tiles of MMA_BWD_DW_TILE (segment rows,
# columns of N) over splits of M into whole _MMA_BWD_BK-row slices, added
# in split order by the last block of each tile. The planner's model of a
# launch (`_mma_dx_seconds`, `_mma_dw_seconds`), fitted by
# tools/profile_k2_matrix.py --fit to its --set lm times on an H100 80GB
# HBM3 at 700 W: blocks run in rounds of one an SM, each taking
# _MMA_BWD_SLICE_S[r] (dx, r rows a tile) or _MMA_BWD_DW_SLICE_S (dw) a
# slice of its contraction; a split dw then takes _MMA_BWD_MERGE_S[0] +
# _MMA_BWD_MERGE_S[1] x splits a round of tiles (each tile's last block
# reads the splits' partials); the launch moves its operands and outputs
# through HBM at _HBM_BYTES_PER_S at least.
MMA_BWD_DX_TILES = ((128, 128), (64, 128))
MMA_BWD_DW_TILE = (128, 128)
_MMA_BWD_BK = 64
_MMA_BWD_SLICE_S = {128: 1.88e-6, 64: 1.25e-6}
_MMA_BWD_DW_SLICE_S = 2.12e-6
_MMA_BWD_MERGE_S = (2.2e-6, 4.4e-6)
# dw's splits the planner weighs keep their blocks within this many waves
_MMA_BWD_SPLIT_WAVES = 4
_GRID_X_MAX, _GRID_YZ_MAX = 2**31 - 1, 65535  # CUDA's grid: x; y and z
# The q8 plain versions' fp32 psums are exact while xbar * 128 * 128 <= 2^24.
Q8_MAX_XBAR = 1024
# K4's launch plan (`plan_fwd_q8`; csrc/cadc_matmul.cu `q8_mma_kernel`): a
# block owns Q8_ROWS x Q8_COLS outputs of y and each of its Q8_WARPS warps
# computes that tile for its own segments; `groups` > 1 splits the segments
# over blocks, whose f(psum) tiles the last block of the tile adds in
# order.
Q8_ROWS, Q8_COLS, Q8_WARPS = 16, 32, 8
# The kernel's psums start at the bits of 1.5 * 2^23 (Q8_MAGIC_BITS) up to
# this xbar, where |psum| <= xbar * 128 * 128 <= 2^22 keeps them exact.
Q8_MAGIC_BITS, Q8_MAGIC_MAX_XBAR = 0x4B400000, 256


def _check_shapes(x: Tensor, w: Tensor, crossbar_size: int) -> int:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x [M, D] @ w [D, N]; got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    d = x.shape[1]
    if d % crossbar_size:
        raise ValueError(f"D={d} is not a multiple of crossbar_size="
                         f"{crossbar_size}; pad to segments first")
    return d // crossbar_size


# ---------------------------------------------------------------------------
# gates: packing, modes, residual bytes
# ---------------------------------------------------------------------------

def _n_words(n: int) -> int:
    return -(-n // GATE_PACK_WIDTH)


def _pack_mask(gate: Tensor) -> Tensor:
    """[..., n] gate -> [..., ceil(n/32)] int32 words: bit b of word w is
    set when gate column 32*w + b is nonzero (padded columns: 0)."""
    n = gate.shape[-1]
    nw = _n_words(n)
    bits = (gate != 0).to(torch.int32)
    if nw * GATE_PACK_WIDTH != n:
        bits = torch.nn.functional.pad(bits, (0, nw * GATE_PACK_WIDTH - n))
    shifts = torch.arange(GATE_PACK_WIDTH, dtype=torch.int32,
                          device=gate.device)
    # bits are disjoint per lane, so an int32 sum is the bitwise or
    return (bits.reshape(*gate.shape[:-1], nw, GATE_PACK_WIDTH)
            << shifts).sum(-1, dtype=torch.int32)


def _unpack_mask(words: Tensor, n: int) -> Tensor:
    """[..., nw] words -> [..., n] fp32 {0, 1} gate (inverse of _pack_mask)."""
    shifts = torch.arange(GATE_PACK_WIDTH, dtype=torch.int32,
                          device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].float()


def _resolve_gate(fn: str):
    """(f, f' or None, gate dtype or None) of a registered fn; f' is None
    when the fn has no registered derivative (forward only)."""
    f = dendritic.get(fn)
    try:
        return f, dendritic.grad(fn), dendritic.gate_dtype(fn)
    except ValueError:
        return f, None, None


def gate_mode(save_gate: str, fn: str) -> str:
    """The save_gate knob -> the resolved mode of `fn`: 'none' (identity,
    or a fn without a derivative: nothing to save or recompute) |
    'packed' | 'bytes' | 'recompute'. N is padded to whole words here, so
    unlike JAX no block size limits packing."""
    if save_gate not in SAVE_GATE_MODES:
        raise ValueError(f"save_gate={save_gate!r}; choose from "
                         f"{SAVE_GATE_MODES}")
    _, gate_fn, gate_dt = _resolve_gate(fn)
    if gate_fn is None or gate_dt is None:
        return "none"
    if save_gate == "recompute":
        return "recompute"
    packable = dendritic.gate_packing(fn)
    if save_gate == "packed":
        if not packable:
            raise ValueError(
                f"save_gate='packed' needs an indicator gate "
                f"(dendritic.gate_packing({fn!r}) is False)")
        return "packed"
    if save_gate == "bytes":
        return "bytes"
    return "packed" if packable else "bytes"


def gate_residual_nbytes(m: int, d: int, n: int, *, crossbar_size: int,
                         fn: str, save_gate: str = "auto") -> int:
    """Bytes of the gate the forward saves for an [m, d] @ [d, n] CADC
    matmul (or a conv with m = B*OH*OW, d = K1*K2*Cin): exactly the
    gate tensor's nbytes."""
    mode = gate_mode(save_gate, fn)
    s = -(-d // crossbar_size)
    if mode == "packed":
        return s * m * _n_words(n) * 4
    if mode == "bytes":
        return s * m * n * dendritic.gate_dtype(fn).itemsize
    return 0


def bwd_kernel(dtype: torch.dtype, mode: str, fn: Optional[str],
               crossbar_size: int) -> str:
    """The kernel K2 runs for operands of `dtype` under the resolved gate
    `mode`: 'mma' (the tensor-core kernels, on the bf16 operands as they
    are) for bf16 with a gate of 0s and 1s — none, packed words, or bytes
    of a bool gate (relu, identity): g ⊙ f' is then bf16 exactly — and an
    xbar of whole k16 steps; else 'recompute' under the recompute gate and
    'tile' otherwise (the CUDA-core kernels, on fp32 copies of bf16
    operands). The dtype, the gate and xbar decide it, never the shapes."""
    if mode == "recompute":
        return "recompute"
    if dtype != torch.bfloat16 or crossbar_size % MMA_K:
        return "tile"
    if mode == "bytes":
        if fn is None:
            raise ValueError("K2 on bf16 under save_gate='bytes' needs the "
                             "fn: its gate's dtype decides the kernel")
        return "mma" if dendritic.gate_dtype(fn) == torch.bool else "tile"
    return "mma"


def product_cost(m: int, d: int, n: int, *, x_size: int, w_size: int,
                 crossbar_size: int, fn: str, mode: str,
                 need_dx: bool = True, need_dw: bool = True,
                 dtype: Optional[torch.dtype] = None) -> work.Cost:
    """work.product_work of an [m, d] @ [d, n] CADC product under the
    resolved gate `mode` ('none' | 'packed' | 'bytes' | 'recompute'): the
    unit every route of it counts (core/work.py). `dtype`, the operands'
    (default fp32), decides K2's operand bytes as it decides its kernel
    (`bwd_kernel`): bf16 read as they are by 'mma', fp32 copies by the
    others."""
    gate = (gate_residual_nbytes(m, d, n, crossbar_size=crossbar_size,
                                 fn=fn, save_gate=mode)
            if mode in ("packed", "bytes") else 0)
    mma = bwd_kernel(dtype or torch.float32, mode, fn,
                     crossbar_size) == "mma"
    return work.product_work(m, d, n, x_size=x_size, w_size=w_size,
                             gate_bytes=gate, need_dx=need_dx,
                             need_dw=need_dw, recompute=mode == "recompute",
                             bwd_size=2 if mma else 4)


def linear_cost(x: Tensor, w: Tensor, *, crossbar_size: int, fn: str,
                save_gate: str, dtype: Optional[torch.dtype] = None
                ) -> work.Cost:
    """The unit of a CADC linear at a place where the routes split: w
    [D, N] or [S, xbar, N] (D = S * xbar), x of m * D elements ([..., D]
    or [..., S, xbar]), both run in `dtype` (default their own); the gate
    mode kernels/ops.cadc_matmul takes (none where no gradient is
    wanted)."""
    n = w.shape[-1]
    d = w.numel() // n
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    mode = gate_mode(save_gate, fn) if grad else "none"
    x_size, w_size = ((x.element_size(), w.element_size()) if dtype is None
                      else (dtype.itemsize, dtype.itemsize))
    if dtype is None and x.dtype == w.dtype:
        dtype = x.dtype
    return product_cost(x.numel() // d, d, n, x_size=x_size,
                        w_size=w_size, crossbar_size=crossbar_size, fn=fn,
                        mode=mode, need_dx=x.requires_grad,
                        need_dw=w.requires_grad, dtype=dtype)


def _fwd_cost(x: Tensor, w: Tensor, *_, crossbar_size: int, fn: str,
              mode: str = "none", **__) -> Tuple[int, int]:
    return product_cost(x.shape[0], x.shape[1], w.shape[1],
                        x_size=x.element_size(), w_size=w.element_size(),
                        crossbar_size=crossbar_size, fn=fn, mode=mode)[0]


def _bwd_cost(g: Tensor, x: Tensor, w: Tensor, gate, *, crossbar_size: int,
              fn: str, mode: str, need_dx: bool = True,
              need_dw: bool = True, **_) -> Tuple[int, int]:
    return product_cost(x.shape[0], x.shape[1], w.shape[1], x_size=4,
                        w_size=4, crossbar_size=crossbar_size, fn=fn,
                        mode=mode, need_dx=need_dx, need_dw=need_dw,
                        dtype=x.dtype if x.dtype == w.dtype else None)[1]


def _gate_kind(mode: str, fn: str) -> int:
    if mode == "packed":
        return _GATE_PACKED
    if mode == "bytes":
        return (_GATE_U8 if dendritic.gate_dtype(fn) == torch.bool
                else _GATE_F32)
    if mode == "recompute":
        return _GATE_RECOMPUTE
    return _GATE_NONE


def _gate_of(psum: Tensor, gate_fn: Callable, mode: str, fn: str) -> Tensor:
    """One segment's saved gate from its fp32 psum [M, N]."""
    if mode == "packed":
        return _pack_mask(gate_fn(psum))
    return gate_fn(psum).to(dendritic.gate_dtype(fn))


def _empty_gate(s: int, m: int, n: int, mode: str, fn: str,
                device) -> Tensor:
    if mode == "packed":
        return torch.empty((s, m, _n_words(n)), dtype=torch.int32,
                           device=device)
    return torch.empty((s, m, n), dtype=dendritic.gate_dtype(fn),
                       device=device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

@work.counted("cadc_fwd", _fwd_cost)
def cadc_matmul_torch(x: Tensor, w: Tensor, *, crossbar_size: int,
                      fn: str) -> Tensor:
    """K1's plain version: fp32 psum per segment, f, and a sequential sum
    from an fp32 zero, as the kernel adds. fp32 out."""
    return cadc_matmul_gate_torch(x, w, crossbar_size=crossbar_size, fn=fn,
                                  mode="none")[0]


@work.counted("cadc_fwd", _fwd_cost)
def cadc_matmul_gate_torch(x: Tensor, w: Tensor, *, crossbar_size: int,
                           fn: str, mode: str) -> Tuple[Tensor,
                                                        Optional[Tensor]]:
    """K1g's plain version: K1's sum, plus the gate of each segment's
    psum when mode is 'packed' or 'bytes' (else None)."""
    n_seg = _check_shapes(x, w, crossbar_size)
    f, gate_fn, _ = _resolve_gate(fn)
    x32, w32 = x.float(), w.float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    gates = []
    for s in range(n_seg):
        seg = slice(s * crossbar_size, (s + 1) * crossbar_size)
        p = x32[:, seg] @ w32[seg]
        if mode in ("packed", "bytes"):
            gates.append(_gate_of(p, gate_fn, mode, fn))
        acc = acc + f(p)
    return acc, (torch.stack(gates) if gates else None)


@work.counted("cadc_bwd", _bwd_cost)
def cadc_segmented_bwd_torch(g: Tensor, x: Tensor, w: Tensor,
                             gate: Optional[Tensor], *, crossbar_size: int,
                             fn: str, mode: str, need_dx: bool = True,
                             need_dw: bool = True,
                             scale: Optional[Tensor] = None
                             ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """K2's plain version. g [M, N], x [M, D], w [D, N] (D in whole or
    partial segments of crossbar_size rows); gate as the forward saved it
    for `mode` ('packed' | 'bytes'), or None ('none' | 'recompute').
    `scale` (one fp32, default 1) multiplies the recomputed psum before
    f' — the q8 forward's dequantization. Returns (dx [M, D], dw [D, N]) in
    fp32, None where not wanted."""
    m, d = x.shape
    n = w.shape[1]
    g32, x32, w32 = g.float(), x.float(), w.float()
    gate_fn = dendritic.grad(fn) if mode == "recompute" else None
    dx = torch.empty((m, d), device=x.device) if need_dx else None
    dw = torch.empty((d, n), device=x.device) if need_dw else None
    for s in range(-(-d // crossbar_size)):
        seg = slice(s * crossbar_size, min((s + 1) * crossbar_size, d))
        if mode == "packed":
            gm = g32 * _unpack_mask(gate[s], n)
        elif mode == "bytes":
            gm = g32 * gate[s].float()
        elif mode == "recompute":
            p = x32[:, seg] @ w32[seg]
            gm = g32 * gate_fn(p if scale is None else p * scale.float())
        else:
            gm = g32
        if need_dx:
            dx[:, seg] = gm @ w32[seg].T
        if need_dw:
            dw[seg] = x32[:, seg].T @ gm
    return dx, dw


def _check_q8_xbar(crossbar_size: int) -> None:
    if crossbar_size > Q8_MAX_XBAR:
        raise ValueError(f"crossbar_size={crossbar_size} > {Q8_MAX_XBAR}: "
                         f"an int8 psum could exceed 2^24 and its fp32 "
                         f"value would not be exact")


def cadc_matmul_q8_torch(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                         crossbar_size: int, fn: str) -> Tensor:
    """K4's plain version: x_q [M, S*xbar], w_codes [S*xbar, N] integer
    codes (int8, or floats holding them), scale one fp32 -> fp32 [M, N]."""
    return cadc_matmul_q8_gate_torch(x_q, w_codes, scale,
                                     crossbar_size=crossbar_size, fn=fn,
                                     mode="none")[0]


def cadc_matmul_q8_gate_torch(x_q: Tensor, w_codes: Tensor, scale: Tensor,
                              *, crossbar_size: int, fn: str, mode: str
                              ) -> Tuple[Tensor, Optional[Tensor]]:
    """K4g's plain version: per segment the exact psum of the codes (fp32),
    times scale, its gate when mode is 'packed' or 'bytes', f, and the
    sequential sum from an fp32 zero, as the kernel adds."""
    n_seg = _check_shapes(x_q, w_codes, crossbar_size)
    _check_q8_xbar(crossbar_size)
    f, gate_fn, _ = _resolve_gate(fn)
    x32, w32 = x_q.float(), w_codes.float()
    s32 = scale.float().reshape(())
    acc = torch.zeros(x_q.shape[0], w_codes.shape[1], dtype=torch.float32,
                      device=x_q.device)
    gates = []
    for s in range(n_seg):
        seg = slice(s * crossbar_size, (s + 1) * crossbar_size)
        p = (x32[:, seg] @ w32[seg]) * s32
        if mode in ("packed", "bytes"):
            gates.append(_gate_of(p, gate_fn, mode, fn))
        acc = acc + f(p)
    return acc, (torch.stack(gates) if gates else None)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.cadc_matmul_launch.restype = ctypes.c_int
    lib.cadc_matmul_gate_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.cadc_matmul_gate_launch.restype = ctypes.c_int
    lib.cadc_matmul_q8_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.cadc_matmul_q8_launch.restype = ctypes.c_int
    lib.cadc_matmul_error_string.argtypes = [ctypes.c_int]
    lib.cadc_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library(_BWD_SOURCE)
    lib.cadc_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.cadc_bwd_launch.restype = ctypes.c_int
    lib.cadc_bwd_mma_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.cadc_bwd_mma_launch.restype = ctypes.c_int
    lib.cadc_bwd_error_string.argtypes = [ctypes.c_int]
    lib.cadc_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(name: str, fn: str, *ts: Tensor, dtypes=_DTYPES) -> None:
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if any(t.dtype != ts[0].dtype for t in ts) or ts[0].dtype not in dtypes:
        raise ValueError(f"{name} takes {sorted(map(str, dtypes))} (one "
                         f"dtype); got {[t.dtype for t in ts]}")
    if fn not in FN_IDS:
        raise ValueError(f"dendritic fn {fn!r} has no CUDA kernel id; the "
                         f"kernels take {sorted(FN_IDS)}")


def _check_scale(name: str, scale: Tensor, dev) -> Tensor:
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != dev):
        raise ValueError(f"{name} wants scale as one fp32 on {dev}; got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    return scale.contiguous()


class Plan(NamedTuple):
    """A forward launch: `kernel` 'tile' (`width` = block rows, 8 or 64),
    'stream' (`width` = 16-byte vectors per column strip, 4 or 8) or 'mma'
    (bf16 only; `width` = block rows, one of MMA_ROWS); `split`: the
    segments over blocks — one per (output tile, segment) for 'tile' and
    'stream', one per (output tile, segment group) for 'mma' —, summed in
    order by the last block of each tile; `grid` (x, y, z) of the one
    launch, z the segments or groups."""
    kernel: str
    width: int
    split: bool
    grid: Tuple[int, int, int]

    @property
    def tiles(self) -> int:
        """Output tiles: the arrival counters a split launch uses."""
        return self.grid[0] * self.grid[1]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def groups(self) -> int:
        """Blocks a tile: the segment groups (segments where 'tile' or
        'stream' split), 1 for a single pass."""
        return self.grid[2]

    def fits(self) -> bool:
        return _fits(self)


def _fits(plan) -> bool:
    """A Plan's or Q8Plan's grid is within CUDA's limits, and a split's
    tiles within the device's arrival counters."""
    return (plan.grid[0] <= _GRID_X_MAX
            and max(plan.grid[1:]) <= _GRID_YZ_MAX
            and (not plan.split or plan.tiles <= N_COUNTERS))


def _make_plan(kernel: str, width: int, split: bool, m: int, n: int,
               n_seg: int, vec: int) -> Plan:
    z = n_seg if split else 1
    if kernel == "stream":
        return Plan(kernel, width, split, (-(-n // (width * vec)), 1, z))
    return Plan(kernel, width, split, (-(-n // _TILE_N), -(-m // width), z))


def _mma_plan(rows: int, groups: int, m: int, n: int) -> Plan:
    return Plan("mma", rows, groups > 1,
                (-(-n // MMA_COLS), -(-m // rows), groups))


def _mma_ok(plan: Plan, m: int, n: int, n_seg: int) -> bool:
    """A legal mma plan: a known tile, no empty segment group, a grid that
    fits, and a split's scratch indexable by 32-bit offsets."""
    return (plan.width in MMA_ROWS and _q8_group_ok(n_seg, plan.groups)
            and plan.fits() and (not plan.split or m * n < 2**31))


def _mma_seconds(plan: Plan, m: int, n: int, n_seg: int,
                 crossbar_size: int) -> float:
    """The planner's model of an mma launch's time (seconds)."""
    rows = plan.width
    per = -(-n_seg // plan.groups)
    slices = per * -(-crossbar_size // _MMA_BK)
    t = (-(-plan.blocks // (SMS * _MMA_OCC[rows])) * slices
         * _MMA_SLICE_S[rows])
    d = n_seg * crossbar_size
    hbm = (m * d + d * n) * 2 + m * n * 4
    if plan.split:
        kept = 1 + n_seg - per  # group 0's chain, then each later segment
        hbm += 2 * kept * m * n * 4
        t += (-(-plan.tiles // SMS) * kept * rows * MMA_COLS * 4
              / _MMA_MERGE_BYTES)
    return max(t, hbm / _HBM_BYTES_PER_S)


@functools.lru_cache(maxsize=4096)
def _plan_mma(m: int, n: int, n_seg: int, crossbar_size: int) -> Plan:
    cands = [(_mma_seconds(p, m, n, n_seg, crossbar_size), p.groups,
              -p.width, p)
             for p in (_mma_plan(r, gr, m, n) for r in MMA_ROWS
                       for gr in _q8_groups(n_seg))
             if _mma_ok(p, m, n, n_seg)]
    if not cands:
        raise ValueError(f"the mma kernel: M={m} N={n} exceed CUDA's grid")
    return min(cands)[-1]


def plan_fwd(m: int, n: int, n_seg: int, crossbar_size: int, *,
             vec: int = 0, dtype: torch.dtype = torch.float32,
             _force=None) -> Plan:
    """The launch plan of an [m, n_seg*xbar] @ [n_seg*xbar, n] forward with
    operands of `dtype`, from the shapes alone. `vec`: columns per 16-byte
    vector of w (4 fp32, 8 bf16) where the stream kernel may run (K1
    without a gate), else 0.

      * the stream kernel for m <= 8 (decode): the wider strip (8 vectors)
        where it gives SMS blocks over (strip, segment), else the narrower
        (4); split over segments when there are several;
      * else, bf16 with xbar a multiple of MMA_K: the tensor-core kernel,
        the row tile of MMA_ROWS and the segment groups (1, 2, 4, ... and
        n_seg: `_q8_groups`) `_mma_seconds` rates fastest (ties: fewer
        groups, then the larger tile);
      * else the tile kernel: the single pass with 64-row tiles (8 for m <=
        8) when that grid already has SMS blocks (prefill); else split
        over segments, with 8-row tiles where 64-row ones fall short.

    So the kernel follows the dtype, m <= 8 with vec, and xbar alone: a
    split of M or of the segments never moves a bf16 product between the
    tile and mma kernels. Every plan of a kernel computes the same sums in
    the same order (the tile and mma kernels are bitwise under every plan).
    `_force` = (kernel, width, split) builds that plan instead, for tests
    (for 'mma': (kernel, rows, groups)); a bf16 plan that is not 'mma' is
    the tile or stream kernel on bf16 operands."""
    mma = (dtype == torch.bfloat16 and crossbar_size % MMA_K == 0)
    if _force is not None and _force[0] == "mma":
        _, rows, groups = _force
        plan = _mma_plan(int(rows), int(groups), m, n)
        if not mma or not _mma_ok(plan, m, n, n_seg):
            raise ValueError(f"no such plan {_force} for M={m} N={n} "
                             f"S={n_seg} xbar={crossbar_size} {dtype}")
        return plan
    if _force is not None:
        kernel, width, split = _force
        ok = (width in _TILE_ROWS if kernel == "tile" else
              kernel == "stream" and vec and width in _STREAM_LANES
              and m <= _STREAM_MAX_M and crossbar_size <= _STREAM_MAX_XBAR)
        if not ok or (split and n_seg < 2) or (
                kernel == "stream" and split != (n_seg > 1)):
            raise ValueError(f"no such plan {_force} for M={m} N={n} "
                             f"S={n_seg} xbar={crossbar_size} vec={vec}")
        return _make_plan(kernel, width, split, m, n, n_seg, vec)
    split = n_seg > 1
    if vec and m <= _STREAM_MAX_M and crossbar_size <= _STREAM_MAX_XBAR:
        plans = [_make_plan("stream", lanes, split, m, n, n_seg, vec)
                 for lanes in _STREAM_LANES]
        plan = next((p for p in plans if p.blocks >= SMS), plans[-1])
        if not split or plan.tiles <= N_COUNTERS:
            return plan
    if mma:
        return _plan_mma(int(m), int(n), int(n_seg), int(crossbar_size))
    rows = 8 if m <= 8 else 64
    single = _make_plan("tile", rows, False, m, n, n_seg, vec)
    if single.blocks >= SMS:
        return single
    plan = _make_plan("tile", rows, split, m, n, n_seg, vec)
    return (plan if plan.blocks >= SMS
            else _make_plan("tile", 8, split, m, n, n_seg, vec))


def mma_plans(m: int, n: int, n_seg: int, crossbar_size: int) -> list:
    """The planner's bf16 plan (K1g's: no stream), then every other mma
    plan (each row tile at each segment group count `_q8_groups` lists
    that leaves no group empty and fits): the plans tests and tools hold to
    each other, bitwise."""
    out = [plan_fwd(m, n, n_seg, crossbar_size, dtype=torch.bfloat16)]
    for rows in MMA_ROWS:
        for groups in _q8_groups(n_seg):
            p = _mma_plan(rows, groups, m, n)
            if _mma_ok(p, m, n, n_seg) and p not in out:
                out.append(p)
    return out


class Q8Plan(NamedTuple):
    """A K4 launch: the segments in `groups` groups (1: the single pass;
    more: one block per (tile, group), the groups' f(psum) tiles added in
    order by the last block of each tile); `grid` (M tiles, N tiles,
    groups) of the one launch, tiles of Q8_ROWS x Q8_COLS."""
    groups: int
    grid: Tuple[int, int, int]

    @property
    def split(self) -> bool:
        return self.groups > 1

    @property
    def tiles(self) -> int:
        """Output tiles: the arrival counters a split launch uses."""
        return self.grid[0] * self.grid[1]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def fits(self) -> bool:
        return _fits(self)


# The planner's model of a K4 launch (us, `_q8_seconds`), fitted by
# tools/profile_k4.py --refit to its --set plans sweep on an H100 80GB HBM3
# at 700 W: _Q8_FIXED, then per wave of blocks (one block an SM)
# _Q8_ROUND per round of segments (one a warp) and _Q8_LOAD per segment a
# block holds at once (its warps' loads share the SM), each per 64-code
# chunk of a segment; a split adds the last block's ordered sum,
# _Q8_MERGE[0] + _Q8_MERGE[1] per Q8_MERGE_SEGS segments (the loads it
# keeps in flight: csrc/cadc_matmul.cu kQ8MergeSegs).
_Q8_FIXED = 1.606
_Q8_ROUND = 1.297
_Q8_LOAD = 0.074
_Q8_MERGE = (0.811, 1.393)
Q8_MERGE_SEGS = 32


def _q8_plan(groups: int, m: int, n: int) -> Q8Plan:
    return Q8Plan(groups, (-(-m // Q8_ROWS), -(-n // Q8_COLS), groups))


def _q8_seconds(plan: Q8Plan, n_seg: int, crossbar_size: int) -> float:
    """The planner's model of a launch's time (us)."""
    chunks = -(-crossbar_size // 64)
    held = -(-n_seg // plan.groups)           # segments a block takes
    rounds = -(-held // Q8_WARPS)
    per_block = chunks * (rounds * _Q8_ROUND + min(held, Q8_WARPS) * _Q8_LOAD)
    t = _Q8_FIXED + -(-plan.blocks // SMS) * per_block
    if plan.split:
        t += _Q8_MERGE[0] + _Q8_MERGE[1] * -(-n_seg // Q8_MERGE_SEGS)
    return t


def _q8_groups(n_seg: int) -> list:
    """The segment groups the planner weighs: 1, 2, 4, ... and n_seg."""
    return [1 << i for i in range(n_seg.bit_length())
            if 1 << i < n_seg] + [n_seg]


def _q8_group_ok(n_seg: int, groups: int) -> bool:
    """groups of ceil(n_seg / groups) segments leave none empty."""
    return (1 <= groups <= n_seg
            and -(-n_seg // -(-n_seg // groups)) == groups)


def plan_fwd_q8(m: int, n: int, n_seg: int, crossbar_size: int, *,
                _force=None) -> Q8Plan:
    """K4's launch plan for x [m, n_seg*xbar] @ w [n_seg*xbar, n], from the
    shapes alone: of the segment groups `_q8_groups` lists (1 is the single
    pass), the one `_q8_seconds` rates fastest (ties: fewer groups) whose
    grid fits. Every plan computes each output as the plain version's chain
    of additions, so every plan gives the same bits. `_force` = groups
    builds that plan instead, for tests, and raises on one the shape does
    not admit (past n_seg, leaving a group empty, or a grid that does not
    fit). Cached."""
    return _plan_fwd_q8(int(m), int(n), int(n_seg), int(crossbar_size),
                        None if _force is None else int(_force))


@functools.lru_cache(maxsize=4096)
def _plan_fwd_q8(m, n, n_seg, crossbar_size, _force) -> Q8Plan:
    if min(m, n, n_seg, crossbar_size) < 1:
        raise ValueError(f"K4 plans M, N, S, xbar >= 1; got {m}, {n}, "
                         f"{n_seg}, {crossbar_size}")
    if _force is not None:
        plan = _q8_plan(_force, m, n)
        if not _q8_group_ok(n_seg, _force) or not plan.fits():
            raise ValueError(f"K4: no plan of {_force} groups for M={m} "
                             f"N={n} S={n_seg} xbar={crossbar_size}")
        return plan
    cands = [(_q8_seconds(p, n_seg, crossbar_size), p.groups, p)
             for p in (_q8_plan(gr, m, n) for gr in _q8_groups(n_seg))
             if _q8_group_ok(n_seg, p.groups) and p.fits()]
    if not cands:
        raise ValueError(f"K4: M={m} N={n} exceed CUDA's grid")
    return min(cands)[-1]


def q8_plans(m: int, n: int, n_seg: int, crossbar_size: int) -> list:
    """The planner's plan, then every other group count `_q8_groups` lists:
    the plans tests and tools hold to each other, bitwise."""
    out = [plan_fwd_q8(m, n, n_seg, crossbar_size)]
    for groups in _q8_groups(n_seg):
        try:
            p = plan_fwd_q8(m, n, n_seg, crossbar_size, _force=groups)
        except ValueError:
            continue
        if p not in out:
            out.append(p)
    return out


def _counters(device) -> Tensor:
    """The device's arrival counters (zeroed int32 [N_COUNTERS]), made at
    the first split launch, which must not be inside a CUDA graph capture.
    The kernels leave them zero again. Split launches on one device use
    them one at a time: run those on one stream (every caller in the port
    does)."""
    buf = _COUNTERS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the first split CADC matmul on a device is inside a CUDA "
                "graph capture; call it once before capturing")
        buf = _COUNTERS[device] = torch.zeros(N_COUNTERS, dtype=torch.int32,
                                              device=device)
    return buf


def _fwd_launch(x: Tensor, w: Tensor, crossbar_size: int, fn: str,
                mode: str, scale: Optional[Tensor] = None,
                plan=None) -> Tuple[Tensor, Optional[Tensor]]:
    """K1 (mode 'none') or K1g on CUDA tensors; K4 / K4g with `scale`. One
    launch under `plan` (default: plan_fwd's, or with `scale` plan_fwd_q8's;
    a q8 plan of another shape raises)."""
    n_seg = _check_shapes(x, w, crossbar_size)
    m, n = x.shape[0], w.shape[1]
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    gate = (_empty_gate(n_seg, m, n, mode, fn, x.device)
            if mode in ("packed", "bytes") else None)
    if m == 0 or n == 0:
        return y, gate
    if scale is not None:
        if plan is None:
            plan = plan_fwd_q8(m, n, n_seg, crossbar_size)
        elif not isinstance(plan, Q8Plan) or plan != plan_fwd_q8(
                m, n, n_seg, crossbar_size, _force=plan.groups):
            raise ValueError(f"K4: plan {plan} is not one of this shape's")
    else:
        if plan is None:
            vec = 16 // x.element_size() if gate is None else 0
            plan = plan_fwd(m, n, n_seg, crossbar_size, vec=vec,
                            dtype=x.dtype)
        if max(plan.grid[1:]) > 65535:
            raise ValueError(f"M={m}, S={n_seg} exceed the kernel's grid")
        if plan.kernel == "stream" and gate is not None:
            raise ValueError("the stream kernel runs K1 only")
        if plan.kernel == "mma" and plan != plan_fwd(
                m, n, n_seg, crossbar_size, dtype=x.dtype,
                _force=("mma", plan.width, plan.groups)):
            raise ValueError(f"the mma kernel: plan {plan} is not one of "
                             f"this shape's (M={m} N={n} S={n_seg} "
                             f"xbar={crossbar_size} {x.dtype})")
    scratch = counters = None
    if plan.split:
        # the mma kernel keeps group 0's chain and each later segment
        mma = isinstance(plan, Plan) and plan.kernel == "mma"
        slices = n_seg - -(-n_seg // plan.groups) + 1 if mma else n_seg
        scratch = torch.empty((slices, m, n), dtype=torch.float32,
                              device=x.device)
        counters = _counters(x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (y.data_ptr(), ptr(scratch), ptr(counters))
    if scale is not None:
        code = lib.cadc_matmul_q8_launch(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), *args, ptr(gate),
            m, n, n_seg, crossbar_size, FN_IDS[fn],
            _gate_kind(mode if gate is not None else "none", fn),
            plan.groups, stream)
    elif gate is None:
        code = lib.cadc_matmul_launch(
            x.data_ptr(), w.data_ptr(), *args, m, n, n_seg, crossbar_size,
            FN_IDS[fn], _DTYPES[x.dtype], PLAN_KERNELS.index(plan.kernel),
            plan.width, plan.groups, stream)
    else:
        code = lib.cadc_matmul_gate_launch(
            x.data_ptr(), w.data_ptr(), *args, gate.data_ptr(), m, n, n_seg,
            crossbar_size, FN_IDS[fn], _DTYPES[x.dtype], _gate_kind(mode, fn),
            PLAN_KERNELS.index(plan.kernel), plan.width, plan.groups, stream)
    _build.check(lib, "cadc_matmul", code)
    return y, gate


@work.counted("cadc_fwd", _fwd_cost)
def cadc_matmul_cuda(x: Tensor, w: Tensor, *, crossbar_size: int,
                     fn: str) -> Tensor:
    """K1. x [M, S*xbar], w [S*xbar, N] on one CUDA device, both fp32 or
    both bf16 -> fp32 [M, N]. Raises on anything else. Counts its launches
    in `cadc_matmul_cuda.launches`."""
    _check_cuda("cadc_matmul_cuda", fn, x, w)
    y, _ = _fwd_launch(x, w, crossbar_size, fn, "none")
    if y.numel():
        cadc_matmul_cuda.launches += 1
    return y


cadc_matmul_cuda.launches = 0


@work.counted("cadc_fwd", _fwd_cost)
def cadc_matmul_gate_cuda(x: Tensor, w: Tensor, *, crossbar_size: int,
                          fn: str, mode: str) -> Tuple[Tensor, Tensor]:
    """K1g: K1 that also writes the gate of `mode` ('packed' | 'bytes'),
    [S, M, ceil(N/32)] int32 words or [S, M, N] of the fn's gate dtype.
    Counts its launches in `cadc_matmul_gate_cuda.launches`."""
    _check_cuda("cadc_matmul_gate_cuda", fn, x, w)
    if mode not in ("packed", "bytes"):
        raise ValueError(f"K1g writes a 'packed' or 'bytes' gate, not "
                         f"{mode!r}")
    if dendritic.gate_dtype(fn) is None:
        raise ValueError(f"dendritic fn {fn!r} has no gate to save")
    y, gate = _fwd_launch(x, w, crossbar_size, fn, mode)
    if y.numel():
        cadc_matmul_gate_cuda.launches += 1
    return y, gate


cadc_matmul_gate_cuda.launches = 0


def cadc_matmul_q8_cuda(x_q: Tensor, w_codes: Tensor, scale: Tensor, *,
                        crossbar_size: int, fn: str) -> Tensor:
    """K4. x_q [M, S*xbar], w_codes [S*xbar, N] int8 on one CUDA device,
    scale one fp32 there -> fp32 [M, N]. Raises on anything else. Counts
    its launches in `cadc_matmul_q8_cuda.launches`."""
    _check_cuda("cadc_matmul_q8_cuda", fn, x_q, w_codes,
                dtypes={torch.int8: 2})
    scale = _check_scale("cadc_matmul_q8_cuda", scale, x_q.device)
    y, _ = _fwd_launch(x_q, w_codes, crossbar_size, fn, "none", scale)
    if y.numel():
        cadc_matmul_q8_cuda.launches += 1
    return y


cadc_matmul_q8_cuda.launches = 0


def cadc_matmul_q8_gate_cuda(x_q: Tensor, w_codes: Tensor, scale: Tensor,
                             *, crossbar_size: int, fn: str, mode: str
                             ) -> Tuple[Tensor, Tensor]:
    """K4g: K4 that also writes the gate of `mode` ('packed' | 'bytes') of
    each dequantized psum, in K1g's layouts. Counts its launches in
    `cadc_matmul_q8_gate_cuda.launches`."""
    _check_cuda("cadc_matmul_q8_gate_cuda", fn, x_q, w_codes,
                dtypes={torch.int8: 2})
    scale = _check_scale("cadc_matmul_q8_gate_cuda", scale, x_q.device)
    if mode not in ("packed", "bytes"):
        raise ValueError(f"K4g writes a 'packed' or 'bytes' gate, not "
                         f"{mode!r}")
    if dendritic.gate_dtype(fn) is None:
        raise ValueError(f"dendritic fn {fn!r} has no gate to save")
    y, gate = _fwd_launch(x_q, w_codes, crossbar_size, fn, mode, scale)
    if y.numel():
        cadc_matmul_q8_gate_cuda.launches += 1
    return y, gate


cadc_matmul_q8_gate_cuda.launches = 0


class BwdPlan(NamedTuple):
    """K2's launches: `kernel` 'tile' (saved gates or none) or 'recompute'
    (dx by the 64 x 64 recompute kernel) — the CUDA-core kernels, which read
    fp32 (bf16 operands copied up) — or 'mma' (the tensor-core kernels on
    bf16 operands); the dx tile (rows of M, segment columns) and grid
    (blocks a column tile, column tiles, 1: under 'tile' each block takes
    every grid[0]-th row tile, under 'recompute' and 'mma' one); the dw
    tile (segment rows, columns of N) and grid (N tiles, D tiles, splits of
    M) and the rows of M of each split. A grid of zeros is a launch not
    wanted."""
    kernel: str
    dx_tile: Tuple[int, int]
    dx_grid: Tuple[int, int, int]
    dw_tile: Tuple[int, int]
    dw_grid: Tuple[int, int, int]
    dw_rows: int

    @property
    def dw_splits(self) -> int:
        return self.dw_grid[2]

    @property
    def dw_tiles(self) -> int:
        """dw's output tiles: the arrival counters a split launch uses."""
        return self.dw_grid[0] * self.dw_grid[1]

    @property
    def launches(self) -> int:
        return sum(1 for gr in (self.dx_grid, self.dw_grid) if gr[0])

    def fits(self) -> bool:
        """Both grids are within CUDA's limits."""
        return all(gr[0] <= _GRID_X_MAX and max(gr[1:]) <= _GRID_YZ_MAX
                   for gr in (self.dx_grid, self.dw_grid))


def _seg_tiles(d: int, crossbar_size: int, cols: int) -> int:
    """Tiles of `cols` segment columns over D: ceil(width / cols) a
    segment, the last one possibly narrower."""
    n_seg = -(-d // crossbar_size)
    last = d - (n_seg - 1) * crossbar_size
    return (n_seg - 1) * -(-crossbar_size // cols) + -(-last // cols)


def _seg_cols(d: int, crossbar_size: int) -> int:
    """The narrowest segment width of BWD_SEG_COLS covering the widest
    segment, else the widest."""
    width = min(crossbar_size, d)
    return next((c for c in BWD_SEG_COLS if c >= width), BWD_SEG_COLS[-1])


def _split_rows(m: int, splits: int) -> int:
    """Rows of M of each of `splits` ranges: whole 32-row k-tiles (the last
    range may be shorter; there may be fewer ranges)."""
    return max(32, -(-(-(-m // splits)) // 32) * 32)


def _wave_splits(m: int, tiles: int) -> int:
    """Splits of M that make about one wave of _BWD_SLOTS blocks, each at
    least _BWD_MIN_ROWS rows; 1 where the tiles outnumber the counters."""
    if tiles > N_COUNTERS:
        return 1
    return max(1, min(_BWD_SLOTS // tiles, -(-m // _BWD_MIN_ROWS)))


def _dw_seconds(m: int, tile, tiles: int, splits: int) -> float:
    """The planner's model of dw's time under a tile and split."""
    rows = _split_rows(m, splits)
    splits = -(-m // rows)
    per_sm = -(-tiles * splits // SMS)
    two = int(per_sm > 1)
    outs = tile[0] * tile[1]
    main = (-(-per_sm // (1 + two)) * -(-rows // 64)
            * (_KTILE_S[two] + _KTILE_S_OUT[two] * outs))
    tail = (_TAIL_S[0] + splits * (_TAIL_S[1] + _TAIL_S[2] * outs)
            if splits > 1 else 0.0)
    return main + tail


def _mma_split_rows(m: int, splits: int) -> int:
    """Rows of M of each of `splits` ranges of the mma route's dw: whole
    _MMA_BWD_BK-row slices (the last range may be shorter; there may be
    fewer ranges)."""
    return max(_MMA_BWD_BK,
               -(-(-(-m // splits)) // _MMA_BWD_BK) * _MMA_BWD_BK)


def _make_bwd_plan(kernel, m, n, d, crossbar_size, dx_tile, dw_tile,
                   splits, need_dx, need_dw) -> BwdPlan:
    col_tiles = _seg_tiles(d, crossbar_size, dx_tile[1])
    row_tiles = -(-m // dx_tile[0])
    if kernel == "tile":  # a wave of blocks, each striding over row tiles
        row_tiles = min(row_tiles, -(-_BWD_SLOTS // col_tiles))
    dx_grid = (row_tiles, col_tiles, 1) if need_dx else (0, 0, 0)
    rows = (_mma_split_rows if kernel == "mma" else _split_rows)(m, splits)
    dw_grid = ((-(-n // dw_tile[1]), _seg_tiles(d, crossbar_size,
                                                 dw_tile[0]), -(-m // rows))
               if need_dw else (0, 0, 0))
    return BwdPlan(kernel, dx_tile, dx_grid, dw_tile, dw_grid,
                   rows if need_dw else 0)


def _mma_dx_seconds(rows: int, m: int, n: int, d: int,
                    crossbar_size: int) -> float:
    """The planner's model of the mma route's dx launch (seconds): blocks
    of `rows` x MMA_COLS each over N's slices, in rounds."""
    blocks = -(-m // rows) * _seg_tiles(d, crossbar_size,
                                        MMA_BWD_DX_TILES[0][1])
    t = -(-blocks // SMS) * -(-n // _MMA_BWD_BK) * _MMA_BWD_SLICE_S[rows]
    return max(t, (2 * (m * n + d * n) + 4 * m * d) / _HBM_BYTES_PER_S)


def _mma_dw_seconds(splits: int, m: int, n: int, d: int,
                    crossbar_size: int) -> float:
    """The planner's model of the mma route's dw launch (seconds): a block
    a tile and split, one an SM, each over its split's slices, in rounds;
    then each tile's last block reads the splits' partials."""
    rows, cols = MMA_BWD_DW_TILE
    tiles = -(-n // cols) * _seg_tiles(d, crossbar_size, rows)
    depth = _mma_split_rows(m, splits)
    splits = -(-m // depth)
    t = (-(-tiles * splits // SMS) * -(-depth // _MMA_BWD_BK)
         * _MMA_BWD_DW_SLICE_S)
    hbm = 2 * (m * n + m * d) + 4 * d * n
    if splits > 1:
        hbm += 2 * splits * tiles * rows * cols * 4
        t += (_MMA_BWD_MERGE_S[0]
              + _MMA_BWD_MERGE_S[1] * splits * -(-tiles // SMS))
    return max(t, hbm / _HBM_BYTES_PER_S)


def _mma_split_counts(m: int, tiles: int) -> list:
    """dw's splits of M the planner weighs on the mma route: 1, and each
    count of whole slices a split that keeps the blocks within
    _MMA_BWD_SPLIT_WAVES waves and the tiles within the counters."""
    out = [1]
    if tiles > N_COUNTERS:
        return out
    slices = -(-m // _MMA_BWD_BK)
    for s in range(2, slices + 1):
        s = -(-m // _mma_split_rows(m, s))
        if tiles * s > _MMA_BWD_SPLIT_WAVES * SMS:
            break
        if s not in out:
            out.append(s)
    return out


def plan_bwd(m: int, n: int, d: int, crossbar_size: int, mode: str,
             need_dx: bool = True, need_dw: bool = True, *,
             dtype: torch.dtype = torch.float32, fn: Optional[str] = None,
             _force=None) -> BwdPlan:
    """K2's launch plan for g [m, n], x [m, d], w [d, n] of `dtype` under a
    resolved gate mode, from the shapes alone. The kernel is
    `bwd_kernel(dtype, mode, fn, crossbar_size)` (`fn` needed for bf16
    under 'bytes'): 'mma' plans the tensor-core kernels —

      * dx: the row tile of MMA_BWD_DX_TILES `_mma_dx_seconds` rates
        fastest (ties: the larger), a block a tile; dw: the splits of M
        (whole slices; `_mma_split_counts`) `_mma_dw_seconds` rates fastest
        (ties: fewer), a block a tile and split;

    dx is bitwise the same under every mma plan (one chain of 64-deep
    slices over n from 0 an element, whatever the tile), dw the same bits
    on every run of a plan. 'tile' and 'recompute' (fp32 operands, or fp32
    copies of bf16 ones) plan the CUDA-core kernels:

      * dx: the segment width of `_seg_cols` (32 for the stems' 27-, 25-
        and 18-wide segments), the first of its BWD_DX_TILES where that
        gives half of SMS row and column tiles, else the second; about
        _BWD_SLOTS blocks, each taking every so many row tiles;
        64 x 64 under the recompute gate ('recompute', a block a tile);
      * dw: rows of D as dx's segment width, or 32; of those, the widths
        of BWD_DW_COLS that N allows (16, and each wider one whose half N
        exceeds) and one or half a wave of splits, the triple `_dw_seconds`
        rates fastest (ties: the larger tile, then more splits) — whatever
        the gate mode.

    dx is bitwise the same under every plan (one fmaf chain over n from 0
    an element, whatever the tile); dw adds each plan's splits in order,
    the same bits on every run of the plan, and the recompute gate's dw is
    bitwise the saved gate's under one plan. At most two launches, one
    where only dx or dw is wanted. `_force` = (dx tile, dw tile, splits)
    builds that plan of the kernel instead, for tests, and raises on one
    the shape does not admit. Cached: every layer's backward asks each
    step."""
    if mode not in ("none", "packed", "bytes", "recompute"):
        raise ValueError(f"mode {mode!r} is not a resolved gate mode")
    if _force is not None:
        _force = (tuple(int(v) for v in _force[0]),
                  tuple(int(v) for v in _force[1]), int(_force[2]))
    return _plan_bwd(int(m), int(n), int(d), int(crossbar_size), mode,
                     bool(need_dx), bool(need_dw),
                     bwd_kernel(dtype, mode, fn, int(crossbar_size)),
                     _force)


@functools.lru_cache(maxsize=4096)
def _plan_bwd(m, n, d, crossbar_size, mode, need_dx, need_dw, kernel,
              _force) -> BwdPlan:
    if min(m, n, d, crossbar_size) < 1:
        raise ValueError(f"K2 plans M, N, D, xbar >= 1; got {m}, {n}, {d}, "
                         f"{crossbar_size}")
    if kernel == "mma":
        return _plan_bwd_mma(m, n, d, crossbar_size, need_dx, need_dw,
                             _force)
    if _force is not None:
        dx_tile, dw_tile, splits = _force
        ok = ((dx_tile == BWD_RECOMPUTE_DX if kernel == "recompute" else
               dx_tile in BWD_DX_TILES)
              and dw_tile[0] in BWD_SEG_COLS and dw_tile[1] in BWD_DW_COLS)
        plan = _make_bwd_plan(kernel, m, n, d, crossbar_size, dx_tile,
                              dw_tile, max(1, splits), need_dx, need_dw)
        if (not ok or not 1 <= splits <= -(-m // 32) or not plan.fits()
                or (plan.dw_splits > 1 and plan.dw_tiles > N_COUNTERS)):
            raise ValueError(f"no such plan {_force} for M={m} N={n} D={d} "
                             f"xbar={crossbar_size} mode={mode!r}")
        return plan
    cols = _seg_cols(d, crossbar_size)
    col_tiles = _seg_tiles(d, crossbar_size, cols)
    big, small = (t for t in BWD_DX_TILES if t[1] == cols)
    dx_tile = big if 2 * -(-m // big[0]) * col_tiles >= SMS else small
    cands = []
    for rw, nw in itertools.product(sorted({BWD_SEG_COLS[0], cols}),
                                    BWD_DW_COLS):
        if nw > BWD_DW_COLS[0] and 2 * n <= nw:
            continue  # half the tile past N
        tiles = -(-n // nw) * _seg_tiles(d, crossbar_size, rw)
        wave = _wave_splits(m, tiles)
        for s in {wave, -(-wave // 2)}:
            cost = _dw_seconds(m, (rw, nw), tiles, s)
            cands.append((cost, -rw * nw, -s, (rw, nw), s))
    _, _, _, dw_tile, splits = min(cands)
    plan = _make_bwd_plan(
        kernel, m, n, d, crossbar_size,
        BWD_RECOMPUTE_DX if kernel == "recompute" else dx_tile,
        dw_tile, splits, need_dx, need_dw)
    if not plan.fits():
        raise ValueError(f"K2: M={m} N={n} D={d} xbar={crossbar_size} "
                         f"exceed CUDA's grid")
    return plan


def _plan_bwd_mma(m, n, d, crossbar_size, need_dx, need_dw,
                  _force) -> BwdPlan:
    def make(dx_tile, splits):
        return _make_bwd_plan("mma", m, n, d, crossbar_size, dx_tile,
                              MMA_BWD_DW_TILE, splits, need_dx, need_dw)

    if _force is not None:
        dx_tile, dw_tile, splits = _force
        plan = make(dx_tile, max(1, splits))
        if (dx_tile not in MMA_BWD_DX_TILES or dw_tile != MMA_BWD_DW_TILE
                or not 1 <= splits <= -(-m // _MMA_BWD_BK)
                or not plan.fits()
                or (plan.dw_splits > 1 and plan.dw_tiles > N_COUNTERS)):
            raise ValueError(f"no such plan {_force} for M={m} N={n} D={d} "
                             f"xbar={crossbar_size} on the mma kernels")
        return plan
    tiles = -(-n // MMA_BWD_DW_TILE[1]) * _seg_tiles(
        d, crossbar_size, MMA_BWD_DW_TILE[0])
    splits = min(_mma_split_counts(m, tiles), key=lambda s: (
        _mma_dw_seconds(s, m, n, d, crossbar_size), s))
    dx_tile = min(MMA_BWD_DX_TILES, key=lambda t: (
        _mma_dx_seconds(t[0], m, n, d, crossbar_size), -t[0]))
    plan = make(dx_tile, splits)
    if not plan.fits():
        raise ValueError(f"K2: M={m} N={n} D={d} xbar={crossbar_size} "
                         f"exceed CUDA's grid")
    return plan


def bwd_plans(m: int, n: int, d: int, crossbar_size: int, mode: str,
              need_dx: bool = True, need_dw: bool = True, *,
              dtype: torch.dtype = torch.float32,
              fn: Optional[str] = None) -> list:
    """The planner's plan, then every other dx tile (none under the
    recompute gate) and dw tile (with the planner's splits), then the
    planner's tiles with dw unsplit and with twice the planner's splits:
    the plans tests and tools hold to the planner's (dx bitwise). On the
    mma kernels: each dx tile, dw unsplit, halved and twice split."""
    kw = dict(dtype=dtype, fn=fn)
    plan = plan_bwd(m, n, d, crossbar_size, mode, need_dx, need_dw, **kw)
    splits = max(1, plan.dw_splits)
    if plan.kernel == "mma":
        forces = [(t, plan.dw_tile, splits) for t in MMA_BWD_DX_TILES]
        forces += [(plan.dx_tile, plan.dw_tile, s)
                   for s in (1, -(-splits // 2), 2 * splits)]
    else:
        tiles = ([] if plan.kernel == "recompute" else
                 [(t, plan.dw_tile) for t in BWD_DX_TILES])
        tiles += [(plan.dx_tile, (r, c)) for r in BWD_SEG_COLS
                  for c in BWD_DW_COLS]
        forces = [(dx, dw, splits) for dx, dw in tiles]
        forces += [(plan.dx_tile, plan.dw_tile, s) for s in (1, 2 * splits)]
    out = [plan]
    for f in forces:
        try:
            p = plan_bwd(m, n, d, crossbar_size, mode, need_dx, need_dw,
                         _force=f, **kw)
        except ValueError:  # more splits than M has k-tiles
            continue
        if p not in out:
            out.append(p)
    return out


@work.counted("cadc_bwd", _bwd_cost)
def cadc_segmented_bwd_cuda(g: Tensor, x: Tensor, w: Tensor,
                            gate: Optional[Tensor], *, crossbar_size: int,
                            fn: str, mode: str, need_dx: bool = True,
                            need_dw: bool = True,
                            scale: Optional[Tensor] = None,
                            plan: Optional[BwdPlan] = None
                            ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """K2: (dx [M, D], dw [D, N]) fp32 from g [M, N], x [M, D], w [D, N]
    on one CUDA device, all fp32 or all bf16, and the gate of `mode`, as
    cadc_segmented_bwd_torch (`scale`, one fp32 on the device, multiplies
    the recomputed psum), under `plan` (default: plan_bwd's for the dtype):
    one launch for dx and one for dw, which adds its M-splits in order
    itself (no atomics on the values: the same bits on every run). The
    plan's kernel 'mma' reads the bf16 operands as they are; 'tile' and
    'recompute' read fp32, so bf16 operands are copied up first. Raises on
    another shape's or kernel's plan. Counts its calls in
    `cadc_segmented_bwd_cuda.launches`."""
    _check_cuda("cadc_segmented_bwd_cuda", fn, g, x, w)
    m, d = x.shape
    n = w.shape[1]
    if g.shape != (m, n) or w.shape[0] != d:
        raise ValueError(f"want g [M, N], x [M, D], w [D, N]; got "
                         f"{tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    kind = _gate_kind(mode, fn)
    n_seg = -(-d // crossbar_size)
    if kind in (_GATE_PACKED, _GATE_U8, _GATE_F32):
        want = ((n_seg, m, _n_words(n)) if kind == _GATE_PACKED
                else (n_seg, m, n))
        want_dt = {_GATE_PACKED: torch.int32, _GATE_U8: torch.bool,
                   _GATE_F32: torch.float32}[kind]
        if (gate is None or tuple(gate.shape) != want
                or gate.dtype != want_dt or gate.device != x.device):
            raise ValueError(f"mode {mode!r} wants a {want_dt} gate of "
                             f"shape {want} on {x.device}")
        gate = gate.contiguous()
    else:
        gate = None
    if scale is not None:
        scale = _check_scale("cadc_segmented_bwd_cuda", scale, x.device)
    dx = torch.empty((m, d), device=x.device) if need_dx else None
    dw = torch.empty((d, n), device=x.device) if need_dw else None
    if 0 in (m, n, d) or not (need_dx or need_dw):
        for t in (dx, dw):
            if t is not None:
                t.zero_()
        return dx, dw
    rmode = "none" if kind == _GATE_NONE else mode
    kw = dict(dtype=x.dtype, fn=fn)
    planned = plan_bwd(m, n, d, crossbar_size, rmode, need_dx, need_dw, **kw)
    if plan is None:
        plan = planned
    elif plan.kernel != planned.kernel or plan != plan_bwd(
            m, n, d, crossbar_size, rmode, need_dx, need_dw,
            _force=(plan.dx_tile, plan.dw_tile, max(1, plan.dw_splits)),
            **kw):
        raise ValueError(f"cadc_segmented_bwd_cuda: plan {plan} is not one "
                         f"of this shape's")
    mma = plan.kernel == "mma"
    if not mma:  # the CUDA-core kernels read fp32
        g, x, w = g.float(), x.float(), w.float()
    g, x, w = g.contiguous(), x.contiguous(), w.contiguous()
    scratch = counters = None
    if need_dw and plan.dw_splits > 1:
        scratch = torch.empty(
            (plan.dw_splits, plan.dw_tiles, plan.dw_tile[0] * plan.dw_tile[1]),
            device=x.device)
        counters = _counters(x.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if mma:
        code = lib.cadc_bwd_mma_launch(
            g.data_ptr(), x.data_ptr(), w.data_ptr(), ptr(gate), ptr(dx),
            ptr(dw), ptr(scratch), ptr(counters), m, n, d, crossbar_size,
            kind, plan.dx_tile[0], max(1, plan.dw_splits), plan.dw_rows,
            stream)
    else:
        code = lib.cadc_bwd_launch(
            g.data_ptr(), x.data_ptr(), w.data_ptr(), ptr(gate), ptr(scale),
            ptr(dx), ptr(dw), ptr(scratch), ptr(counters), m, n, d,
            crossbar_size, FN_IDS[fn], kind, *plan.dx_tile, plan.dx_grid[0],
            *plan.dw_tile, max(1, plan.dw_splits), plan.dw_rows, stream)
    _build.check(lib, "cadc_bwd", code)
    cadc_segmented_bwd_cuda.launches += 1
    return dx, dw


cadc_segmented_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def segmented_bwd(use_cuda: bool):
    return cadc_segmented_bwd_cuda if use_cuda else cadc_segmented_bwd_torch


class CadcMatmulFn(torch.autograd.Function):
    """y = sum_s f(x_s @ w_s) on x [M, S*xbar], w [S*xbar, N] with K1g (or
    K1 when the mode saves nothing) forward and K2 backward — or their
    plain versions when use_cuda is False. mode: a resolved gate mode."""

    @staticmethod
    def forward(ctx, x, w, crossbar_size: int, fn: str, mode: str,
                use_cuda: bool):
        if mode in ("packed", "bytes"):
            run = cadc_matmul_gate_cuda if use_cuda else cadc_matmul_gate_torch
            y, gate = run(x, w, crossbar_size=crossbar_size, fn=fn, mode=mode)
        else:
            run = cadc_matmul_cuda if use_cuda else cadc_matmul_torch
            y, gate = run(x, w, crossbar_size=crossbar_size, fn=fn), None
        ctx.save_for_backward(x, w, gate)
        ctx.cfg = (crossbar_size, fn, mode, use_cuda)
        # y in x's dtype, so that the backward's g arrives in it: K2 takes
        # a bf16 g as it is (the plain version widens it to fp32)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, gate = ctx.saved_tensors
        crossbar_size, fn, mode, use_cuda = ctx.cfg
        dx, dw = segmented_bwd(use_cuda)(
            g, x, w, gate, crossbar_size=crossbar_size, fn=fn, mode=mode,
            need_dx=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1])
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None, None,
                None)


def _as_codes(t: Tensor) -> Tensor:
    """int8 codes of a tensor holding them (floats from fake-quant: the
    cast truncates toward zero, as the JAX kernel's astype)."""
    return t if t.dtype == torch.int8 else t.to(torch.int8)


class CadcMatmulQ8Fn(torch.autograd.Function):
    """y = sum_s f(scale * (x_s @ w_s)) on integer codes x [M, S*xbar], w
    [S*xbar, N] (int8, or floats holding codes: QAT) with K4g (or K4) forward
    and the straight-through backward of `_diff_matmul_q8_op`: K2 on the
    codes as fp32, times scale; d(scale) = <dw_unscaled, w>. An integer
    primal gets no gradient (the torch counterpart of float0)."""

    @staticmethod
    def forward(ctx, x, w, scale, crossbar_size: int, fn: str, mode: str,
                use_cuda: bool):
        xq, wq = (_as_codes(x), _as_codes(w)) if use_cuda else (x, w)
        kw = dict(crossbar_size=crossbar_size, fn=fn)
        if mode in ("packed", "bytes"):
            run = (cadc_matmul_q8_gate_cuda if use_cuda
                   else cadc_matmul_q8_gate_torch)
            y, gate = run(xq, wq, scale, mode=mode, **kw)
        else:
            run = cadc_matmul_q8_cuda if use_cuda else cadc_matmul_q8_torch
            y, gate = run(xq, wq, scale, **kw), None
        ctx.save_for_backward(x, w, scale, gate)
        ctx.cfg = (crossbar_size, fn, mode, use_cuda)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, gate = ctx.saved_tensors
        crossbar_size, fn, mode, use_cuda = ctx.cfg
        s32 = scale.float().reshape(())
        w32 = w.float()
        need_dx = ctx.needs_input_grad[0]
        dxu, dwu = segmented_bwd(use_cuda)(
            g.float(), x.float(), w32, gate, crossbar_size=crossbar_size,
            fn=fn, mode=mode, need_dx=need_dx, need_dw=True,
            scale=s32 if mode == "recompute" else None)
        dscale = (dwu * w32).sum().reshape(scale.shape).to(scale.dtype)
        dx = (s32 * dxu).to(x.dtype) if need_dx else None
        dw = (s32 * dwu).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, dscale, None, None, None, None
