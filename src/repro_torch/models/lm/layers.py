"""Shared LM layers: CADC-routable Linear, RMSNorm, embedding, RoPE.

Port of repro.models.lm.layers. Linear weights are stored SEGMENTED
([S, xbar, d_out]) when cfg.linear_impl == 'cadc': the crossbar/segment
axis is a real tensor axis, so f() is applied per segment before the
cross-segment sum. Parameters are plain dicts of tensors with the JAX
package's names.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cadc as cadc_lib
from repro_torch.core import dendritic
from repro_torch.kernels import ops as kops

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
        s, xbar, d_out = w.shape
        xp = cadc_lib.pad_to_segments(x, -1, xbar).to(dt)
        if kops.resolve(cfg.kernel_impl, x) == "cuda":
            y = kops.cadc_matmul(
                xp, w.reshape(s * xbar, d_out).to(dt), crossbar_size=xbar,
                fn=cfg.dendritic_fn, impl=cfg.kernel_impl,
                save_gate=cfg.kernel_save_gate)
        else:
            xs = xp.reshape(*x.shape[:-1], s, xbar)
            psums = torch.einsum("...sk,skn->...sn", xs.float(),
                                 w.to(dt).float())
            if cfg.bf16_wire:
                psums = psums.to(dt)
            ps32 = psums.float()
            _tap_record(ps32, cfg.dendritic_fn, s)
            y = dendritic.get(cfg.dendritic_fn)(ps32).sum(dim=-2).to(dt)
    else:
        y = torch.matmul(x.to(dt), w.to(dt))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


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


def embed(p: Params, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    dt = cdtype(cfg)
    x = p["table"].to(dt)[tokens]
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
    fp32 runs are exact."""
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p_emb["table"].to(x.dtype).t()).float()
    else:
        logits = linear_apply(p_head, x, cfg).float()
    return logits[..., : cfg.vocab_size]


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
