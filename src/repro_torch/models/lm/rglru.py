"""Griffin / RecurrentGemma recurrent block [arXiv:2402.19427].

RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), r_t / i_t input-dependent
sigmoids. Port of repro.models.lm.rglru. Decode carries (h, conv buffer)
per slot, and serving runs the decode cell over time, prefill included
(transformer.py). Training (rglru_apply) runs the diagonal recurrence over
the whole sequence as a log-depth scan (_linear_scan).

Under the TP context (parallel.act_sharding) with rnn_width divisible by
"model" (`channels_split`), the block runs channel-parallel along the
sharding rules' splits (parallel/sharding.py: w_gate, w_x, w_r, w_i
column-parallel, w_out row-parallel, the depthwise conv's w by channel,
lam and the biases whole): each rank computes its block of the rnn
channels, w_r and w_i reading every channel of the conv output (gathered
over "model"), the conv, the gates and the scan per channel, exact on a
rank's block; w_out is row-parallel on whole local segments
(layers.segment_local, `out_local`) or runs on the gathered channels.
Decode runs the block whole.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll
from repro_torch.parallel import act_sharding as sa
from repro_torch.parallel import comm
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


def _coeffs(r_pre: Tensor, i_pre: Tensor, lam: Tensor, u: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """(a, b) of the diagonal recurrence, fp32, from the gates'
    pre-activations, Lambda and the conv output u, channel by channel."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    log_a = -C_RGLRU * F.softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i * u.float())
    return a, b


def _rglru_coeffs(p: Dict, u: Tensor, cfg: ArchConfig
                  ) -> Tuple[Tensor, Tensor]:
    """u: conv output [..., rw] -> (a, b) of the diagonal recurrence, fp32."""
    return _coeffs(ll.linear_apply(p["w_r"], u, cfg),
                   ll.linear_apply(p["w_i"], u, cfg), p["lam"], u)


def channels_split(cfg: ArchConfig, sizes=None) -> bool:
    """Whether the training block runs channel-parallel over "model"
    (rnn_width divides the axis)."""
    return sa.splits(cfg.rnn_width or cfg.d_model, sizes=sizes,
                     enabled=cfg.act_sharding)


def out_local(cfg: ArchConfig, model: int) -> bool:
    """Whether w_out runs row-parallel on each rank's channels (whole
    segments on every rank)."""
    return ll.segment_local(cfg, cfg.rnn_width or cfg.d_model, model)


def _channels(t: Tensor) -> Tensor:
    """This rank's block of a whole per-channel leaf [..., rw] (lam, the
    conv's bias) in the channel-parallel form."""
    ctx = sa.current()
    return comm.block(t, t.ndim - 1, ctx.rank, ctx.sizes["model"])


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
    and w_out. w_r and w_i read u through one view, as the
    channel-parallel form reads it through one gather, so the two forms
    sum u's gradient in the same order.

    Under the TP context the channel-parallel form (module docstring)
    where channels_split holds, else the block whole on every rank (on
    the gathered sequence under sequence parallelism: layers.whole_seq).
    Under sequence parallelism x is this rank's S block: the
    channel-parallel form gathers it (layers.tp_in) and reduce-scatters
    w_out's output along S."""
    ctx = sa.current()
    if ctx is not None and channels_split(cfg):
        return _rglru_tp(p, x, cfg)
    return ll.whole_seq(lambda h: _rglru_whole(p, h, cfg), x)


def _rglru_whole(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    xg = F.gelu(ll.linear_apply(p["w_gate"], x, cfg), approximate="tanh")
    xi = ll.linear_apply(p["w_x"], x, cfg)
    u = _causal_conv1d(p["conv"], xi)
    uw = u.view_as(u)
    a, b = _coeffs(ll.linear_apply(p["w_r"], uw, cfg),
                   ll.linear_apply(p["w_i"], uw, cfg), p["lam"], u)
    h = _linear_scan(a, b)
    return ll.linear_apply(p["w_out"], h.to(x.dtype) * xg, cfg)


def _rglru_tp(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """The channel-parallel form: p's split leaves are this rank's blocks
    (w_gate, w_x, w_r, w_i its output channels, the conv's w its channels,
    w_out its input rows where out_local), lam, the conv's bias and the
    gates' biases whole."""
    ctx = sa.current()
    x = ll.tp_in(x)
    xg = F.gelu(ll.column_linear(p["w_gate"], x, cfg), approximate="tanh")
    xi = ll.column_linear(p["w_x"], x, cfg)
    u = _causal_conv1d({"w": p["conv"]["w"],
                        "b": _channels(p["conv"]["b"])}, xi)
    uw = comm.gather_to(u, -1, ctx.group)   # w_r, w_i read every channel
    a, b = _coeffs(ll.column_linear(p["w_r"], uw, cfg),
                   ll.column_linear(p["w_i"], uw, cfg),
                   _channels(p["lam"]), u)
    h = _linear_scan(a, b)
    return ll.row_or_gathered(p["w_out"], h.to(x.dtype) * xg, cfg,
                              out_local(cfg, ctx.sizes["model"]))


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
