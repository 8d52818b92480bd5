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
                                         and its six kernel bodies).
The sources are csrc/cadc_matmul.cu (K1, K1g) and csrc/cadc_bwd.cu (K2);
their notes give the bounds and designs. `CadcMatmulFn` is the autograd
Function around them; kernels/ops.py picks kernel or plain version by
the tensors' device. The kernels take only the five built-in dendritic
fns (FN_IDS); a fn added with dendritic.register() runs on the plain
versions. K1 and K1g take fp32 or bf16, K2 fp32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import dendritic
from repro_torch.kernels import _build

Tensor = torch.Tensor

FN_IDS = {"identity": 0, "relu": 1, "sublinear": 2, "supralinear": 3,
          "tanh": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "cadc_matmul.cu"
_BWD_SOURCE = "cadc_bwd.cu"
# Up to this M (decode: M = serve slots) the kernel runs one block per
# (column tile, segment) into an [S, M, N] fp32 scratch, summed in segment
# order by a second kernel: bitwise the single pass, with S times the
# blocks to stream the weights.
SPLIT_MAX_M = 64

# Gate bits per packed word (uint32 lane packing along N).
GATE_PACK_WIDTH = 32
SAVE_GATE_MODES = ("auto", "packed", "bytes", "recompute")
# Resolved gate modes -> the kernels' gate kinds (csrc/cadc_tile.cuh).
_GATE_NONE, _GATE_PACKED, _GATE_U8, _GATE_F32, _GATE_RECOMPUTE = range(5)
# dw of K2 splits M over blocks until about this many are in flight
# (two per SM of an H100), with at least this many rows per split.
_DW_TARGET_BLOCKS = 264
_DW_MIN_ROWS = 256


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
        dt = dendritic.gate_dtype(fn)
        return s * m * n * torch.empty((), dtype=dt).element_size()
    return 0


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

def cadc_matmul_torch(x: Tensor, w: Tensor, *, crossbar_size: int,
                      fn: str) -> Tensor:
    """K1's plain version: fp32 psum per segment, f, and a sequential sum
    from an fp32 zero, as the kernel adds. fp32 out."""
    return cadc_matmul_gate_torch(x, w, crossbar_size=crossbar_size, fn=fn,
                                  mode="none")[0]


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


def cadc_segmented_bwd_torch(g: Tensor, x: Tensor, w: Tensor,
                             gate: Optional[Tensor], *, crossbar_size: int,
                             fn: str, mode: str, need_dx: bool = True,
                             need_dw: bool = True
                             ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """K2's plain version. g [M, N], x [M, D], w [D, N] (D in whole or
    partial segments of crossbar_size rows); gate as the forward saved it
    for `mode` ('packed' | 'bytes'), or None ('none' | 'recompute').
    Returns (dx [M, D], dw [D, N]) in fp32, None where not wanted."""
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
            gm = g32 * gate_fn(x32[:, seg] @ w32[seg])
        else:
            gm = g32
        if need_dx:
            dx[:, seg] = gm @ w32[seg].T
        if need_dw:
            dw[seg] = x32[:, seg].T @ gm
    return dx, dw


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.cadc_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.cadc_matmul_launch.restype = ctypes.c_int
    lib.cadc_matmul_gate_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.cadc_matmul_gate_launch.restype = ctypes.c_int
    lib.cadc_matmul_error_string.argtypes = [ctypes.c_int]
    lib.cadc_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library(_BWD_SOURCE)
    lib.cadc_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.cadc_bwd_launch.restype = ctypes.c_int
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


def _fwd_launch(x: Tensor, w: Tensor, crossbar_size: int, fn: str,
                mode: str) -> Tuple[Tensor, Optional[Tensor]]:
    """K1 (mode 'none') or K1g on CUDA tensors."""
    n_seg = _check_shapes(x, w, crossbar_size)
    m, n = x.shape[0], w.shape[1]
    if -(-m // 64) > 65535:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    gate = (_empty_gate(n_seg, m, n, mode, fn, x.device)
            if mode in ("packed", "bytes") else None)
    if m == 0 or n == 0:
        return y, gate
    scratch = (torch.empty((n_seg, m, n), dtype=torch.float32,
                           device=x.device)
               if 1 < n_seg and m <= SPLIT_MAX_M else None)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    if gate is None:
        code = lib.cadc_matmul_launch(*args, m, n, n_seg, crossbar_size,
                                      FN_IDS[fn], _DTYPES[x.dtype], stream)
    else:
        code = lib.cadc_matmul_gate_launch(
            *args, gate.data_ptr(), m, n, n_seg, crossbar_size, FN_IDS[fn],
            _DTYPES[x.dtype], _gate_kind(mode, fn), stream)
    _build.check(lib, "cadc_matmul", code)
    return y, gate


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


def _dw_splits(m: int, n: int, d: int, crossbar_size: int) -> Tuple[int, int]:
    """(splits, rows per split) of K2's dw over M: enough blocks to fill the
    card, each split at least _DW_MIN_ROWS rows (a multiple of 32)."""
    base = -(-n // 64) * -(-d // crossbar_size) * -(-crossbar_size // 64)
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // base), -(-m // _DW_MIN_ROWS)))
    rows = -(-m // splits)
    rows = -(-rows // 32) * 32
    return -(-m // rows), rows


def cadc_segmented_bwd_cuda(g: Tensor, x: Tensor, w: Tensor,
                            gate: Optional[Tensor], *, crossbar_size: int,
                            fn: str, mode: str, need_dx: bool = True,
                            need_dw: bool = True
                            ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """K2: (dx [M, D], dw [D, N]) fp32 from g [M, N], x [M, D], w [D, N]
    fp32 on one CUDA device and the gate of `mode`, as
    cadc_segmented_bwd_torch. dw sums its M-splits in a fixed order (no
    atomics): the same bits on every run. Counts its launches in
    `cadc_segmented_bwd_cuda.launches`."""
    _check_cuda("cadc_segmented_bwd_cuda", fn, g, x, w,
                dtypes={torch.float32: 0})
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
    if n_seg * -(-crossbar_size // 64) > 65535:
        raise ValueError("D / crossbar_size exceeds the kernel's grid")
    g, x, w = g.contiguous(), x.contiguous(), w.contiguous()
    dx = torch.empty((m, d), device=x.device) if need_dx else None
    dw = torch.empty((d, n), device=x.device) if need_dw else None
    if 0 in (m, n, d) or not (need_dx or need_dw):
        for t in (dx, dw):
            if t is not None:
                t.zero_()
        return dx, dw
    splits, rows = _dw_splits(m, n, d, crossbar_size)
    scratch = (torch.empty((splits, d, n), device=x.device)
               if need_dw and splits > 1 else None)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check(lib, "cadc_bwd", lib.cadc_bwd_launch(
        g.data_ptr(), x.data_ptr(), w.data_ptr(), ptr(gate), ptr(dx),
        ptr(dw), ptr(scratch), splits, rows, m, n, d, crossbar_size,
        FN_IDS[fn], kind, stream))
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
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, gate = ctx.saved_tensors
        crossbar_size, fn, mode, use_cuda = ctx.cfg
        dx, dw = segmented_bwd(use_cuda)(
            g.float(), x.float(), w.float(), gate,
            crossbar_size=crossbar_size, fn=fn, mode=mode,
            need_dx=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1])
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None, None,
                None)
