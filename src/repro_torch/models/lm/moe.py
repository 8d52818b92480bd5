"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

Port of repro.models.lm.moe. Dispatch is the sort formulation (no
[T, E, C] one-hot):
  1. top-k expert ids per token -> flat (token, expert) pairs;
  2. stable-sort the pairs by expert;
  3. position within the expert by searchsorted; pairs past capacity C
     are dropped;
  4. write into a dense [E, C, d] buffer -> batched expert products;
  5. gather back, weight and add each token's k contributions.

Experts are SwiGLU; their weights take the CADC segmented layout
[E, S, xbar, d_out] when cfg.linear_impl == 'cadc' (the paper's technique
per expert crossbar bank). The router stays fp32 and dense. The expert
products are batched PyTorch GEMMs with fp32 psums, as the JAX package's
are an einsum outside its kernels; the shared experts are an ordinary FFN
(CADC linears, K1 on the card).

Three choices keep the port bitwise run to run on the card, and equal to
the JAX package's order of operations on the CPU:
  * top-k is a stable descending sort, so a tied router row puts the
    lower expert first, as jax.lax.top_k does (torch.topk does not);
  * the buffer has one sink row past E * C for dropped pairs (the JAX
    scatter's mode="drop"), and the gather reads zeros there
    (mode="fill");
  * the combine adds no atomics: each token's k contributions are added
    in ascending expert order from zero — the order of the JAX package's
    scatter-add over the expert-sorted pairs — where a CUDA index_add_
    would add them in an order that changes from run to run.
The load-balance aux loss is returned as in the JAX package; the serve
path drops it. Under the data-parallel train step the block routes over
the whole batch (moe_apply's token_group). Under the TP context
(parallel.act_sharding; the JAX package's `_etp` constraint) the block
is split over "model" (`tp_mode`): expert parallelism where E divides the
axis — each rank runs its E / T experts on the whole dispatch and the
ranks' combine rows are summed (one holds each pair: exact) — else
within-expert TP, gate / up column-parallel and down row-parallel over
d_expert (or over the gathered hidden where a rank's block is not whole
segments). The router, the capacity and the aux loss are computed alike
on every rank of the group.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cadc as cadc_lib
from repro_torch.core import dendritic
from repro_torch.models.lm import ffn as ffn_lib
from repro_torch.models.lm import layers as ll
from repro_torch.parallel import act_sharding as sa
from repro_torch.parallel import comm

Tensor = torch.Tensor


def _expert_linear_init(gen: torch.Generator, n_e: int, d_in: int,
                        d_out: int, cfg: ArchConfig,
                        device: torch.device) -> Tensor:
    std = 1.0 / math.sqrt(d_in)
    if cfg.linear_impl == "cadc":
        xbar = cfg.crossbar_size
        s = cadc_lib.num_segments(d_in, xbar)
        w = torch.randn(n_e, s * xbar, d_out, generator=gen,
                        device=device) * std
        w[:, d_in:] = 0.0  # padded rows see zero-padded activations anyway
        return w.reshape(n_e, s, xbar, d_out)
    return torch.randn(n_e, d_in, d_out, generator=gen, device=device) * std


class _Bmm32Fn(torch.autograd.Function):
    """torch.bmm(a, b, out_dtype=float32) on CUDA operands of a narrower
    dtype, differentiable: torch 2.11 defines no derivative for it. The
    backward is the CPU path's (a.float() @ b.float() under autograd) and
    the JAX package's transpose of its fp32-output einsum: the fp32
    cotangent against fp32 copies of the operands, each gradient rounded
    to its operand's dtype. The forward keeps no fp32 copy of the bank."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def _bmm32(a: Tensor, b: Tensor) -> Tensor:
    """a [B, M, K] @ b [B, K, N] -> fp32 [B, M, N]: the products of the
    compute-dtype operands summed in fp32 (the JAX package's
    preferred_element_type=float32). bf16 on the card takes cuBLAS's fp32
    output directly, with no fp32 copy of the expert bank."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _Bmm32Fn.apply(a, b)
    return torch.bmm(a.float(), b.float())  # bf16 products are exact in fp32


def _expert_linear(w: Tensor, x: Tensor, cfg: ArchConfig) -> Tensor:
    """w [E, d_in, d_out] or [E, S, xbar, d_out]; x [E, C, d_in] ->
    [E, C, d_out] in the compute dtype."""
    dt = ll.cdtype(cfg)
    if w.ndim == 4:  # CADC segmented: f per (expert, segment) psum
        e, s, xbar, d_out = w.shape
        c = x.shape[1]
        xs = cadc_lib.pad_to_segments(x, -1, xbar).to(dt)
        xs = xs.reshape(e, c, s, xbar).transpose(1, 2).reshape(e * s, c, xbar)
        psums = _bmm32(xs, w.to(dt).reshape(e * s, xbar, d_out))
        f = dendritic.get(cfg.dendritic_fn)
        return f(psums.reshape(e, s, c, d_out)).sum(dim=1).to(dt)
    return _bmm32(x.to(dt), w.to(dt)).to(dt)


def _shared_cfg(cfg: ArchConfig) -> ArchConfig:
    return cfg.with_overrides(ffn_type="swiglu")


def moe_init(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": torch.randn(d, m.n_experts, generator=gen, device=device)
        * d ** -0.5,
        "w_gate": _expert_linear_init(gen, m.n_experts, d, m.d_expert, cfg,
                                      device),
        "w_up": _expert_linear_init(gen, m.n_experts, d, m.d_expert, cfg,
                                    device),
        "w_down": _expert_linear_init(gen, m.n_experts, m.d_expert, d, cfg,
                                      device),
    }
    if m.n_shared > 0:
        p["shared"] = ffn_lib.ffn_init(gen, _shared_cfg(cfg), device,
                                       d_ff=m.d_shared)
        p["shared_gate"] = torch.randn(d, 1, generator=gen,
                                       device=device) * 0.02
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)  # multiple of 8, >= 8


def tp_mode(cfg: ArchConfig, sizes=None):
    """"ep" (experts over "model"), "etp" (d_expert over "model") or None
    (the block runs whole)."""
    m, on = cfg.moe, cfg.act_sharding
    if sa.splits(m.n_experts, sizes=sizes, enabled=on):
        return "ep"
    if sa.splits(m.d_expert, sizes=sizes, enabled=on):
        return "etp"
    return None


def down_local(cfg: ArchConfig, model: int) -> bool:
    """Whether the within-expert TP down product runs on each rank's block
    of d_expert (whole segments on every rank)."""
    return ll.segment_local(cfg, cfg.moe.d_expert, model)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """jax.lax.top_k: the k largest, ties to the lower index first."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], e[..., :k]


def moe_apply(p: Dict, x: Tensor, cfg: ArchConfig,
              token_group=None) -> Tuple[Tensor, Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar). Capacity follows
    the token count B * S, padded rows included, as in the JAX package.

    token_group: a process group whose ranks hold the other rows of one
    batch, in rank order (the data-parallel train step's "data" group).
    Routing, capacity and the aux loss then run over the whole batch, as
    the JAX package's one global program runs them: every rank computes
    the block over the gathered rows (world x the block's work) and keeps
    its own; the gather's backward sums each row's gradient over the
    ranks."""
    if token_group is not None:
        b, r = x.shape[0], dist.get_rank(token_group)
        y, aux = moe_apply(p, comm.gather_to(x, 0, token_group), cfg)
        return y[r * b:(r + 1) * b], aux
    m = cfg.moe
    e_n, k = m.n_experts, m.top_k
    b, s_, d = x.shape
    t = b * s_
    dev = x.device
    tokens = x.reshape(t, d)

    probs = torch.softmax(tokens.float() @ p["router"].float(), dim=-1)
    top_w, top_e = _top_k(probs, k)                        # [T, k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)        # renormalize

    # load-balance aux (Switch): E * sum_e f_e * P_e (a token's k experts
    # are distinct, so the scatter of ones is its one-hot sum, with no
    # range check that would wait for the device)
    f_e = torch.zeros(t, e_n, device=dev).scatter_(1, top_e, 1.0).mean(dim=0)
    aux = e_n * (f_e * probs.mean(dim=0)).sum()

    # ---- sort-based dispatch ----
    c = capacity(t, cfg)
    flat_e = top_e.reshape(-1)                             # [T*k]
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(t * k, device=dev) - first          # within expert
    sink = e_n * c                                         # dropped pairs
    dest = torch.where(pos < c, se * c + pos, sink)

    # the shared experts' gate, replicated over "model", before the TP
    # region: its gradient and the router's join the region's sum last,
    # in the order the one-process step adds them
    if m.n_shared > 0:
        gate = torch.sigmoid(tokens.float() @ p["shared_gate"].float())
    dt = ll.cdtype(cfg)
    ctx = sa.current()
    mode = tp_mode(cfg) if ctx is not None else None
    shared_tp = (ctx is not None and m.n_shared > 0
                 and ffn_lib.hidden_split(_shared_cfg(cfg), m.d_shared))
    # one copy_to for the experts and the shared experts: each reads
    # `region` where it runs tensor-parallel, `tokens` where replicated
    region = (comm.copy_to(tokens, ctx.group) if mode or shared_tp
              else tokens)
    src = region if mode else tokens
    buf = torch.zeros(sink + 1, d, dtype=dt, device=dev)
    buf[dest] = src[st_].to(dt)
    ein = buf[:sink].reshape(e_n, c, d)

    partial = False
    if mode == "ep":          # this rank's experts [lo, lo + e_loc)
        e_loc = e_n // ctx.sizes["model"]
        lo = ctx.rank * e_loc
        ein = ein[lo:lo + e_loc]
    g = F.silu(_expert_linear(p["w_gate"], ein, cfg))
    u = _expert_linear(p["w_up"], ein, cfg)
    if mode == "etp" and not down_local(cfg, ctx.sizes["model"]):
        eout = _expert_linear(p["w_down"],
                              comm.gather_from(g * u, -1, ctx.group), cfg)
    else:
        eout = _expert_linear(p["w_down"], g * u, cfg)     # [E, C, d]
        partial = mode is not None
    if mode == "ep":
        eout = torch.cat([eout.new_zeros(lo, c, d), eout,
                          eout.new_zeros(e_n - lo - e_loc, c, d)])

    gathered = torch.cat([eout.reshape(sink, d), eout.new_zeros(1, d)])[dest]
    if partial:               # the ranks' rows (EP) or partial sums
        gathered = comm.reduce_from(gathered, ctx.group)
    pairs = torch.empty(t * k, d, dtype=torch.float32, device=dev)
    pairs[order] = gathered.float() * sw[:, None]          # pair t*k + j
    by_expert = torch.argsort(top_e, dim=1)
    pairs = torch.gather(pairs.reshape(t, k, d), 1,
                         by_expert[..., None].expand(t, k, d))
    y = torch.zeros(t, d, dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + pairs[:, j]

    if m.n_shared > 0:
        sh = ffn_lib.ffn_apply(p["shared"], region if shared_tp else tokens,
                               _shared_cfg(cfg), d_ff=m.d_shared,
                               copied=shared_tp)
        y = y + sh.float() * gate

    return y.reshape(b, s_, d).to(x.dtype), aux
