"""Griffin / RecurrentGemma recurrent block [arXiv:2402.19427].

RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), r_t / i_t input-dependent
sigmoids. Port of repro.models.lm.rglru. Decode carries (h, conv buffer)
per slot, and serving runs the decode cell over time, prefill included
(transformer.py). Training (rglru_apply) runs the diagonal recurrence over
the whole sequence as a log-depth scan (_linear_scan).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm.xlstm import (_causal_conv1d, _causal_conv1d_init,
                                        _conv1d_step)

Tensor = torch.Tensor
C_RGLRU = 8.0


class RGLRUState(NamedTuple):
    h: Tensor      # [B, rnn_width]
    conv: Tensor   # [B, width-1, rnn_width]


def rglru_init(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Dict:
    d, rw = cfg.d_model, cfg.rnn_width or cfg.d_model
    # Lambda such that a = exp(-c*softplus(L)*r) lands in [0.9, 0.999] at
    # r = 0.5: softplus(L) in [-ln(.999)*2/c, -ln(.9)*2/c]
    lo, hi = -math.log(0.999) * 2 / C_RGLRU, -math.log(0.9) * 2 / C_RGLRU
    sp = torch.rand(rw, generator=gen, device=device) * (hi - lo) + lo
    lam = torch.log(torch.expm1(sp))  # inverse softplus
    return {
        "w_x": ll.linear_init(gen, d, rw, cfg, device),
        "w_gate": ll.linear_init(gen, d, rw, cfg, device),
        "conv": _causal_conv1d_init(gen, cfg.conv1d_width, rw, device),
        "w_r": ll.linear_init(gen, rw, rw, cfg, device, bias=True),
        "w_i": ll.linear_init(gen, rw, rw, cfg, device, bias=True),
        "lam": lam,
        "w_out": ll.linear_init(gen, rw, d, cfg, device),
    }


def _rglru_coeffs(p: Dict, u: Tensor, cfg: ArchConfig
                  ) -> Tuple[Tensor, Tensor]:
    """u: conv output [..., rw] -> (a, b) of the diagonal recurrence, fp32."""
    r = torch.sigmoid(ll.linear_apply(p["w_r"], u, cfg).float())
    i = torch.sigmoid(ll.linear_apply(p["w_i"], u, cfg).float())
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i * u.float())
    return a, b


def _linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along dim 1 of a, b [B, S,
    C] (fp32): ceil(log2 S) rounds of Hillis-Steele doubling with the JAX
    package's combine, (a1, b1) then (a2, b2) -> (a1 * a2, a2 * b1 + b2).
    Round k leaves positions t < k as they are and combines t >= k with
    t - k. Each round is built out of place (the untouched head cat the
    combined tail), so autograd saves what its backward needs. The sums
    run in another order than jax.lax.associative_scan's odd / even
    recursion and than the decode cell's: equal within fp32 rounding, not
    bitwise."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        if 2 * k < s:  # the last round's products of a are never read
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def rglru_apply(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Training path, x [B, S, d] -> [B, S, d]: the tanh-gelu gate, w_x,
    the causal conv, the recurrence's coefficients (fp32), the scan over S
    from h = 0, h rounded to the compute dtype before the gate multiply,
    and w_out."""
    xg = F.gelu(ll.linear_apply(p["w_gate"], x, cfg), approximate="tanh")
    xi = ll.linear_apply(p["w_x"], x, cfg)
    u = _causal_conv1d(p["conv"], xi)
    a, b = _rglru_coeffs(p, u, cfg)
    h = _linear_scan(a, b)
    return ll.linear_apply(p["w_out"], h.to(x.dtype) * xg, cfg)


def rglru_init_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> RGLRUState:
    rw = cfg.rnn_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros(batch, rw, device=device),
        conv=torch.zeros(batch, cfg.conv1d_width - 1, rw, device=device),
    )


def rglru_decode(p: Dict, x: Tensor, cfg: ArchConfig,
                 state: RGLRUState) -> Tuple[Tensor, RGLRUState]:
    """x [B, 1, d] one token -> (y [B, 1, d], the new state). The conv
    buffer is kept in fp32 and rounded to the compute dtype for the step,
    and h is rounded to it before the gate multiply, as in the JAX
    package."""
    xg = F.gelu(ll.linear_apply(p["w_gate"], x[:, 0], cfg),
                approximate="tanh")
    xi = ll.linear_apply(p["w_x"], x[:, 0], cfg)
    u, new_buf = _conv1d_step(p["conv"], state.conv.to(xi.dtype), xi)
    a, bterm = _rglru_coeffs(p, u, cfg)
    h = a * state.h + bterm
    y = h.to(x.dtype) * xg
    y = ll.linear_apply(p["w_out"], y, cfg)[:, None, :]
    return y, RGLRUState(h, new_buf.float())
