"""Shared LM layers: CADC-routable Linear, RMSNorm, embedding, RoPE.

Port of repro.models.lm.layers. Linear weights are stored SEGMENTED
([S, xbar, d_out]) when cfg.linear_impl == 'cadc': the crossbar/segment
axis is a real tensor axis, so f() is applied per segment before the
cross-segment sum. Parameters are plain dicts of tensors with the JAX
package's names.

Tensor parallelism (inside parallel.act_sharding's context, the LM train
step's): `column_linear` runs a rank's block of output columns,
`row_linear` a rank's block of input features (segments, under CADC)
followed by the all-reduce; `embed` and `lm_head` split the padded vocab
over "model" (`vocab_split`). Outside the context every layer runs whole.

Sequence parallelism (the context's `seq`): the residual stream is each
rank's block of the sequence [b, S / T, d]. A tensor-parallel region is
entered by `tp_in` (an all-gather along S, reduce-scatter backward, in
place of copy_to) and left by `tp_out` (a reduce-scatter along S,
all-gather backward, in place of the row-parallel all-reduce); a
fallback row-parallel linear runs its whole weight on the rank's S block
of the gathered features; `whole_seq` runs a part every rank computes
alike (a recurrent block, a replicated attention or FFN, an MoE block)
on the gathered sequence and keeps the rank's block of its output.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cadc as cadc_lib
from repro_torch.core import dendritic, work
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops as kops
from repro_torch.parallel import act_sharding as sa
from repro_torch.parallel import comm
from repro_torch.parallel import tp_cadc

Tensor = torch.Tensor
Params = Dict[str, Any]


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# psum-sparsity tap (serve telemetry)
# ---------------------------------------------------------------------------
# The paper's buffer/accumulation savings are driven by the fraction of
# crossbar psums the dendritic gate zeroes. While a tap is open, every
# segmented-CADC linear_apply on the plain path appends one record. The
# CUDA kernel never materializes psums (that is its point), so the serve
# telemetry probe runs with kernel_impl='torch'.
#
# `rows` restricts the statistics to the batch rows of active slots. (The
# JAX package's tap averages every row, so an idle slot's garbage-in
# attention output enters its serving metric; the port counts served
# traffic only.)

_PSUM_TAP: Optional[List[Dict[str, Any]]] = None
_TAP_ROWS: Optional[Tensor] = None
_TAP_SCOPE: List[str] = []


@contextlib.contextmanager
def psum_stats_tap(rows: Optional[Tensor] = None):
    """Collect per-linear psum sparsity records while open, over the batch
    rows selected by the bool mask `rows` [B] (all rows when None)."""
    global _PSUM_TAP, _TAP_ROWS
    prev = _PSUM_TAP, _TAP_ROWS
    _PSUM_TAP, _TAP_ROWS = [], rows
    try:
        yield _PSUM_TAP
    finally:
        _PSUM_TAP, _TAP_ROWS = prev


@contextlib.contextmanager
def tap_scope(label: str):
    """Label tap records emitted inside (layer name in the decode loop)."""
    _TAP_SCOPE.append(label)
    try:
        yield
    finally:
        _TAP_SCOPE.pop()


def _tap_record(psums32: Tensor, fn: str, segments: int) -> None:
    if _PSUM_TAP is None:
        return
    psums32 = psums32.detach()  # the records hold no autograd graph
    if _TAP_ROWS is not None:
        psums32 = psums32[_TAP_ROWS]
    gate = dendritic.grad(fn)(psums32)
    scope = _TAP_SCOPE[-1] if _TAP_SCOPE else "linear"
    n = sum(1 for r in _PSUM_TAP if r["label"].startswith(scope))
    _PSUM_TAP.append({
        "label": f"{scope}/{n}",
        "gate_off": (gate == 0).float().mean(),
        "exact_zero": (psums32 == 0).float().mean(),
        "segments": segments,
    })


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                cfg: ArchConfig, device: torch.device, *,
                bias: bool = False) -> Params:
    std = 1.0 / math.sqrt(d_in)
    if cfg.linear_impl == "cadc":
        xbar = cfg.crossbar_size
        s = cadc_lib.num_segments(d_in, xbar)
        w = torch.randn(s * xbar, d_out, generator=gen, device=device) * std
        w[d_in:] = 0.0  # padded rows see zero-padded activations anyway
        p = {"w": w.reshape(s, xbar, d_out)}
    else:
        p = {"w": torch.randn(d_in, d_out, generator=gen, device=device)
             * std}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def linear_apply(p: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    """x [..., d_in] -> [..., d_out] through the dense or CADC path, plus
    the bias "b" where the layer has one, added in the compute dtype after
    the product (after K1's output on the kernel path, as the JAX package
    adds it after its kernel's).

    Plain segmented path: psums are stored in the compute dtype when
    bf16_wire (the JAX package's choice, so that tensor-parallel partial
    sums travel in bf16), fp32 otherwise. The kernel path accumulates in
    fp32 throughout."""
    w = p["w"]
    dt = cdtype(cfg)
    if w.ndim == 3:  # segmented CADC weight [S, xbar, d_out]
        xp = cadc_lib.pad_to_segments(x, -1, w.shape[1]).to(dt)
        y = work.product(_cadc_product, _cadc_cost, xp, w, cfg=cfg)
    else:
        y = torch.matmul(x.to(dt), w.to(dt))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _cadc_product(xp: Tensor, w: Tensor, cfg: ArchConfig) -> Tensor:
    """The CADC product of xp [..., S * xbar] (compute dtype) and a
    segmented weight [S, xbar, d_out], where the routes split: K1g / K2 on
    the card, the plain einsum otherwise."""
    s, xbar, d_out = w.shape
    dt = cdtype(cfg)
    if kops.resolve(cfg.kernel_impl, xp) == "cuda":
        return kops.cadc_matmul(
            xp, w.reshape(s * xbar, d_out).to(dt), crossbar_size=xbar,
            fn=cfg.dendritic_fn, impl=cfg.kernel_impl,
            save_gate=cfg.kernel_save_gate)
    xs = xp.reshape(*xp.shape[:-1], s, xbar)
    psums = torch.einsum("...sk,skn->...sn", xs.float(), w.to(dt).float())
    if cfg.bf16_wire:
        psums = psums.to(dt)
    ps32 = psums.float()
    _tap_record(ps32, cfg.dendritic_fn, s)
    return dendritic.get(cfg.dendritic_fn)(ps32).sum(dim=-2).to(dt)


def _cadc_cost(xp: Tensor, w: Tensor, cfg: ArchConfig):
    return cm.linear_cost(xp, w, crossbar_size=w.shape[1],
                          fn=cfg.dendritic_fn,
                          save_gate=cfg.kernel_save_gate, dtype=cdtype(cfg))


# ---------------------------------------------------------------------------
# tensor-parallel forms
# ---------------------------------------------------------------------------

def seq_split() -> bool:
    """Whether the residual stream is this rank's block of the sequence
    (the TP context's `seq`)."""
    ctx = sa.current()
    return ctx is not None and ctx.seq


def tp_in(x: Tensor) -> Tensor:
    """x [b, S, ...] into a tensor-parallel region over "model": comm.copy_to,
    or, under sequence parallelism (x this rank's block [b, S / T, ...]),
    the ranks' blocks gathered along S with a reduce-scatter backward."""
    ctx = sa.current()
    if ctx.seq:
        return comm.gather_to(x, 1, ctx.group)
    return comm.copy_to(x, ctx.group)


def tp_out(y: Tensor) -> Tensor:
    """A row-parallel region's partial outputs y [b, S, ...] summed over
    "model": comm.reduce_from, or, under sequence parallelism, this rank's
    block along S of the sum (a reduce-scatter, all-gather backward)."""
    ctx = sa.current()
    if ctx.seq:
        return comm.reduce_scatter_from(y, 1, ctx.group)
    return comm.reduce_from(y, ctx.group)


def whole_seq(fn, x: Tensor):
    """fn(x) where the stream is seq-split: x [b, S / T, ...] gathered
    along S (comm.gather_from), fn run on it with sequence parallelism off
    (tensor-parallel regions inside it stay), and this rank's block of its
    output cut out with an all-gather backward (comm.split_to). Every rank
    computes fn alike, so its leaves' gradients are whole on every rank,
    as without sequence parallelism. fn may return (y, extra...): y is
    cut. Elsewhere fn on a view of x: fn's uses of x then add their
    gradients before x's other uses do, in the order the gather's
    backward adds them (so one rank's form is bitwise this one)."""
    ctx = sa.current()
    if ctx is None or not ctx.seq:
        return fn(x.view_as(x))
    with sa.tp_context(ctx.sizes, ctx.group, ctx.rank):
        out = fn(comm.gather_from(x, 1, ctx.group))
    if isinstance(out, tuple):
        return (comm.split_to(out[0], 1, ctx.group),) + out[1:]
    return comm.split_to(out, 1, ctx.group)


def segment_local(cfg: ArchConfig, features: int, model: int) -> bool:
    """Whether a row-parallel linear over `features` inputs, split over
    `model` ranks by its producer, runs on each rank's block: the features
    divide, and under CADC each rank's slice is whole segments (so S
    divides too). A crossbar never spans ranks: otherwise the activation
    is gathered and the layer runs whole (`row_linear`'s fallback)."""
    if features % model:
        return False
    return (cfg.linear_impl != "cadc"
            or (features // model) % cfg.crossbar_size == 0)


def column_linear(p: Params, x: Tensor, cfg: ArchConfig,
                  cols: Optional[Tuple[int, int]] = None) -> Tensor:
    """A column-parallel linear on x, already passed through comm.copy_to:
    p["w"] is this rank's block of output columns, p["b"] (where the layer
    has one) the whole bias, of which the block's columns are added.
    `cols` = (lo, hi): p["w"] is the whole weight and the rank computes its
    columns [lo, hi) (the bias likewise)."""
    ctx = sa.current()
    w = p["w"]
    if cols is not None:
        w = w[..., cols[0]:cols[1]]
    q = {"w": w}
    if "b" in p:
        q["b"] = (p["b"][cols[0]:cols[1]] if cols is not None
                  else comm.block(p["b"], 0, ctx.rank, ctx.sizes["model"]))
    return linear_apply(q, x, cfg)


def row_linear(p: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    """A row-parallel linear: x [..., F / T] is this rank's block of the
    input features, p["w"] its block of the weight's rows (segments
    [S / T, xbar, N] under CADC, which must be whole: segment_local).
    Each rank's partial product (K1g / K2 over its local segments on the
    card: tp_cadc.tp_cadc_row_linear) is all-reduced in the compute dtype
    (comm.reduce_from; under sequence parallelism reduce-scattered along
    S, tp_out), then the bias is added."""
    ctx = sa.current()
    w, dt = p["w"], cdtype(cfg)
    if w.ndim == 3:
        y = tp_cadc.tp_cadc_row_linear(
            x.to(dt), w.to(dt), group=ctx.group, fn=cfg.dendritic_fn,
            impl=cfg.kernel_impl, save_gate=cfg.kernel_save_gate,
            psum_dtype=dt if cfg.bf16_wire else None,
            scatter_dim=1 if ctx.seq else None)
    else:
        y = tp_out(torch.matmul(x.to(dt), w.to(dt)))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def row_or_gathered(p: Params, x: Tensor, cfg: ArchConfig,
                    local: bool) -> Tensor:
    """row_linear where the layer is segment-local, else the activation
    gathered over "model" (comm.gather_from) through the whole weight.
    Under sequence parallelism the fallback gathers the features with a
    reduce-scatter backward (each rank's gradient covers its S block only)
    and runs the whole weight on this rank's S block of them."""
    if local:
        return row_linear(p, x, cfg)
    ctx = sa.current()
    if ctx.seq:
        x = comm.gather_to(x, -1, ctx.group)
        return linear_apply(p, comm.block(x, 1, ctx.rank,
                                          ctx.sizes["model"]), cfg)
    return linear_apply(p, comm.gather_from(x, -1, ctx.group), cfg)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"scale": torch.zeros(d, device=device)}  # gemma-style (1 + scale)


def rmsnorm_apply(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + p["scale"])).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   device: torch.device) -> Params:
    return {"table": torch.randn(vocab, d, generator=gen, device=device) * 0.02}


def vocab_split(cfg: ArchConfig, sizes: Optional[Dict[str, int]] = None
                ) -> bool:
    """Whether the table, the head and the loss split the padded vocab over
    "model" (the JAX package's logits constraint, layers.py:199)."""
    return sa.splits(cfg.padded_vocab, sizes=sizes,
                     enabled=cfg.act_sharding)


def vocab_range(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(lo, rows, valid): this rank's first padded-vocab row, its row
    count, and how many of them are real tokens (< vocab_size)."""
    ctx = sa.current()
    rows = cfg.padded_vocab // ctx.sizes["model"]
    lo = ctx.rank * rows
    return lo, rows, max(0, min(rows, cfg.vocab_size - lo))


def embed(p: Params, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    """Token embeddings. Vocab-parallel (vocab_split, in the TP context):
    p["table"] is this rank's rows; ids outside them read zeros and one
    all-reduce sums the ranks' rows (exact: one rank holds each id), or,
    under sequence parallelism, one reduce-scatter along S (tp_out). Else
    the whole table, of which a seq-split stream keeps this rank's block
    (comm.split_to)."""
    dt = cdtype(cfg)
    ctx = sa.current()
    if ctx is not None and vocab_split(cfg):
        lo, rows, _ = vocab_range(cfg)
        local = tokens - lo
        inside = (local >= 0) & (local < rows)
        x = p["table"].to(dt)[local.clamp(0, rows - 1)]
        x = tp_out(torch.where(inside[..., None], x, x.new_zeros(())))
    else:
        x = split_seq(p["table"].to(dt)[tokens])
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(dt)
    return x


def lm_head(p_head: Optional[Params], p_emb: Params, x: Tensor,
            cfg: ArchConfig) -> Tensor:
    """fp32 logits over the logical vocab. Tied: x @ table^T. Untied:
    linear_apply through `p_head` (a segmented linear through K1 under
    CADC). Either product ends in the compute dtype: a bf16 run rounds the
    logits to bf16 before the fp32 cast, as the JAX package's untied head
    does (so greedy picks break bf16 ties at the first index, as there);
    fp32 runs are exact.

    Vocab-parallel (vocab_split, in the TP context): the rank's block of
    the table or of the head's columns gives the logits of its vocab rows,
    of which the real ones (vocab_range) are returned; lm_loss reduces
    over the ranks. Under sequence parallelism x is this rank's S block:
    gathered along S (tp_in), or, where the vocab is whole, with
    comm.gather_from (every rank then computes the whole logits)."""
    ctx = sa.current()
    tp = ctx is not None and vocab_split(cfg)
    if tp:
        x = tp_in(x)
    elif seq_split():
        x = comm.gather_from(x, 1, ctx.group)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p_emb["table"].to(x.dtype).t()).float()
    else:
        logits = linear_apply(p_head, x, cfg).float()
    return logits[..., : vocab_range(cfg)[2] if tp else cfg.vocab_size]


def split_seq(x: Tensor) -> Tensor:
    """x [b, S, ...], the same on every rank, as the stream holds it: this
    rank's block along S under sequence parallelism (comm.split_to: its
    gradient gathered, so each rank's is whole), else x."""
    if not seq_split():
        return x
    return comm.split_to(x, 1, sa.current().group)


def gather_logits(logits: Tensor, cfg: ArchConfig) -> Tensor:
    """The logical [..., vocab_size] logits from lm_head's: in the TP
    context, where the vocab is split, each rank's real rows padded to its
    block of the padded vocab, all-gathered over "model" in rank order and
    cut to vocab_size (the last ranks hold fewer real rows, or none); else
    `logits` as they are."""
    ctx = sa.current()
    if ctx is None or not vocab_split(cfg):
        return logits
    _, rows, valid = vocab_range(cfg)
    block = torch.nn.functional.pad(logits, (0, rows - valid))
    return comm.all_gather(block, block.ndim - 1,
                           ctx.group)[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x [..., S, H, hd], positions [..., S] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs      # [..., S, half]
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
