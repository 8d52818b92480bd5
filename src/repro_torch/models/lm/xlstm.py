"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, pre-up-projection
block) and sLSTM (scalar memory with recurrent gate weights), the decode
half.

Port of the serving part of repro.models.lm.xlstm: the causal-conv step,
the one-token mLSTM and sLSTM cells with the paper's stabilized
exponential gating (the max-state m starts at -inf), and their per-slot
states. The training forms (the causal conv over a sequence, mlstm_apply
with its chunkwise-parallel form, slstm_apply) are not ported: serving
runs the decode cell over time, prefill included (transformer.py).

Every weight product goes through layers.linear_apply (CADC-able, K1 on
the card); the recurrence itself is element-wise and outer-product state
arithmetic in fp32, with no weight crossbar.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll

Tensor = torch.Tensor
PROJ_FACTOR_M = 2.0       # mLSTM up-projection factor
PROJ_FACTOR_S = 4.0 / 3.0  # sLSTM post-projection factor


def _causal_conv1d_init(gen: torch.Generator, width: int, ch: int,
                        device: torch.device) -> Dict:
    return {"w": torch.randn(width, ch, generator=gen, device=device) / width,
            "b": torch.zeros(ch, device=device)}


def _conv1d_step(p: Dict, buf: Tensor, x_t: Tensor) -> Tuple[Tensor, Tensor]:
    """Decode step of the depthwise causal conv. buf [B, width-1, C] holds
    the previous inputs, x_t [B, C]; returns (y [B, C], the new buffer)."""
    w = p["w"].to(x_t.dtype)
    window = torch.cat([buf, x_t[:, None, :]], dim=1)  # [B, width, C]
    y = torch.einsum("bwc,wc->bc", window, w) + p["b"].to(x_t.dtype)
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: Tensor       # [B, H, dh, dh]
    n: Tensor       # [B, H, dh]
    m: Tensor       # [B, H]
    conv: Tensor    # [B, width-1, d_inner]


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    """(d_inner, head size): the up-projected width split over the heads
    (not cfg.head_dim)."""
    di = int(PROJ_FACTOR_M * cfg.d_model)
    return di, di // cfg.n_heads


def mlstm_init(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Dict:
    d = cfg.d_model
    di, _ = _mlstm_dims(cfg)
    return {
        "norm": ll.rmsnorm_init(d, device),
        "w_up": ll.linear_init(gen, d, 2 * di, cfg, device),
        "conv": _causal_conv1d_init(gen, cfg.conv1d_width, di, device),
        "w_q": ll.linear_init(gen, di, di, cfg, device),
        "w_k": ll.linear_init(gen, di, di, cfg, device),
        "w_v": ll.linear_init(gen, di, di, cfg, device),
        "w_if": ll.linear_init(gen, di, 2 * cfg.n_heads, cfg, device,
                               bias=True),
        "out_norm": ll.rmsnorm_init(di, device),
        "w_down": ll.linear_init(gen, di, d, cfg, device),
    }


def _mlstm_cell(state: Tuple[Tensor, Tensor, Tensor], qkvif, *, dh: int):
    """One timestep of the stabilized mLSTM recurrence. q, k, v [B, H, dh];
    i_raw, f_raw [B, H]. From m = -inf the forget term is exp(-inf) = 0."""
    C, n, m = state
    q, k, v, i_raw, f_raw = qkvif
    f_log = F.logsigmoid(f_raw.float())
    i_log = i_raw.float()
    m_new = torch.maximum(f_log + m, i_log)
    f_p = torch.exp(f_log + m - m_new)[..., None]
    i_p = torch.exp(i_log - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    k32 = k32 / math.sqrt(dh)
    C_new = f_p[..., None] * C + i_p[..., None] * (
        v32[..., :, None] * k32[..., None, :])
    n_new = f_p * n + i_p * k32
    num = torch.einsum("bhij,bhj->bhi", C_new, q32)
    den = torch.maximum(
        torch.einsum("bhj,bhj->bh", n_new, q32).abs(), torch.exp(-m_new)
    )[..., None]
    return (C_new, n_new, m_new), num / den


def mlstm_init_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> MLSTMState:
    di, dh = _mlstm_dims(cfg)
    h = cfg.n_heads
    return MLSTMState(
        C=torch.zeros(batch, h, dh, dh, device=device),
        n=torch.zeros(batch, h, dh, device=device),
        m=torch.full((batch, h), -math.inf, device=device),
        conv=torch.zeros(batch, cfg.conv1d_width - 1, di, device=device),
    )


def mlstm_decode(p: Dict, x: Tensor, cfg: ArchConfig,
                 state: MLSTMState) -> Tuple[Tensor, MLSTMState]:
    """x [B, 1, d] one token -> (y [B, 1, d], the new state). The conv
    buffer is kept in fp32 and rounded to the compute dtype for the step,
    as in the JAX package."""
    b = x.shape[0]
    h_heads = cfg.n_heads
    di, dh = _mlstm_dims(cfg)
    xn = ll.rmsnorm_apply(p["norm"], x, cfg.norm_eps)[:, 0]
    up = ll.linear_apply(p["w_up"], xn, cfg)
    x_in, z = up[:, :di], up[:, di:]
    conv_out, new_buf = _conv1d_step(p["conv"], state.conv.to(x_in.dtype),
                                     x_in)
    conv_out = F.silu(conv_out)
    q = ll.linear_apply(p["w_q"], conv_out, cfg).reshape(b, h_heads, dh)
    k = ll.linear_apply(p["w_k"], conv_out, cfg).reshape(b, h_heads, dh)
    v = ll.linear_apply(p["w_v"], x_in, cfg).reshape(b, h_heads, dh)
    if_g = ll.linear_apply(p["w_if"], x_in, cfg).reshape(b, 2, h_heads)
    (C, n, m), h = _mlstm_cell((state.C, state.n, state.m),
                               (q, k, v, if_g[:, 0], if_g[:, 1]), dh=dh)
    h = h.reshape(b, di).to(x.dtype)
    h = ll.rmsnorm_apply(p["out_norm"], h, cfg.norm_eps)
    h = h * F.silu(z)
    y = ll.linear_apply(p["w_down"], h, cfg)[:, None, :]
    return y, MLSTMState(C, n, m, new_buf.float())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: Tensor   # [B, H, dh]
    n: Tensor
    m: Tensor   # [B, H, dh] (per-unit stabilizer)
    h: Tensor


def slstm_init(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Dict:
    d, h_heads = cfg.d_model, cfg.n_heads
    dh = d // h_heads
    dp = int(PROJ_FACTOR_S * d)
    return {
        "norm": ll.rmsnorm_init(d, device),
        "w_gates": ll.linear_init(gen, d, 4 * d, cfg, device, bias=True),
        # recurrent weights: block-diagonal per head [4, H, dh, dh]
        "r_gates": torch.randn(4, h_heads, dh, dh, generator=gen,
                               device=device) / math.sqrt(dh),
        "out_norm": ll.rmsnorm_init(d, device),
        "w_up_gate": ll.linear_init(gen, d, dp, cfg, device),
        "w_up": ll.linear_init(gen, d, dp, cfg, device),
        "w_down": ll.linear_init(gen, dp, d, cfg, device),
    }


def _slstm_cell(state: SLSTMState, wx: Tensor, r: Tensor
                ) -> Tuple[SLSTMState, Tensor]:
    """wx [B, 4, H, dh] pre-activations from the input; r [4, H, dh, dh]
    (in the compute dtype, widened to fp32 as the JAX einsum promotes
    it)."""
    c, n, m, h_prev = state
    rec = torch.einsum("ghij,bhj->bghi", r.float(), h_prev)  # [B,4,H,dh]
    pre = wx.float() + rec
    i_raw, f_raw, z_raw, o_raw = pre.unbind(dim=1)
    f_log = F.logsigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_raw)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c_new, n_new, m_new, h_new), h_new


def slstm_init_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> SLSTMState:
    dh = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.n_heads, dh)
    return SLSTMState(torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device),
                      torch.full(shape, -math.inf, device=device),
                      torch.zeros(shape, device=device))


def slstm_decode(p: Dict, x: Tensor, cfg: ArchConfig,
                 state: SLSTMState) -> Tuple[Tensor, SLSTMState]:
    """x [B, 1, d] one token -> (y [B, 1, d], the new state)."""
    b, _, d = x.shape
    h_heads = cfg.n_heads
    dh = d // h_heads
    xn = ll.rmsnorm_apply(p["norm"], x, cfg.norm_eps)[:, 0]
    wx = ll.linear_apply(p["w_gates"], xn, cfg).reshape(b, 4, h_heads, dh)
    new_state, h = _slstm_cell(state, wx, p["r_gates"])
    h = h.reshape(b, d).to(x.dtype)
    h = ll.rmsnorm_apply(p["out_norm"], h, cfg.norm_eps)
    # post up/down projection (GeGLU, PF 4/3)
    u = F.gelu(ll.linear_apply(p["w_up_gate"], h, cfg), approximate="tanh")
    v = ll.linear_apply(p["w_up"], h, cfg)
    y = ll.linear_apply(p["w_down"], u * v, cfg)[:, None, :]
    return y, new_state
