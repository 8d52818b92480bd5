"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, pre-up-projection
block) and sLSTM (scalar memory with recurrent gate weights).

Port of repro.models.lm.xlstm. Serving: the causal-conv step, the
one-token mLSTM and sLSTM cells with the paper's stabilized exponential
gating (the max-state m starts at -inf), and their per-slot states; the
serving prefill runs the decode cell over time (transformer.py).
Training: the causal conv over a sequence, mlstm_apply (the chunkwise
parallel form, or the sequential cell over time) and slstm_apply (the
sLSTM cell over time: h feeds the recurrent weights, so the recurrence
is not associative and the loop is forced, as lax.scan is in JAX).

Every weight product goes through layers.linear_apply (CADC-able: K1 on
the card, K1g / K2 under autograd); the recurrence itself is element-wise
and outer-product state arithmetic in fp32, with no weight crossbar.
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


def _causal_conv1d(p: Dict, x: Tensor) -> Tensor:
    """Depthwise causal conv over x [B, S, C], in x's dtype: the taps
    added in order from 0 (a Python sum), then the bias, as the JAX
    package adds them."""
    w = p["w"].to(x.dtype)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return y + p["b"].to(x.dtype)


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


def _mlstm_qkvif(p: Dict, x: Tensor, cfg: ArchConfig):
    """The mLSTM block up to the recurrence, over x [B, S, d]: q, k, v
    [B, S, H, dh], the i and f gate pre-activations [B, S, H] (in the
    compute dtype), the output gate's z [B, S, d_inner], dh, d_inner."""
    b, s, _ = x.shape
    h_heads = cfg.n_heads
    di, dh = _mlstm_dims(cfg)
    xn = ll.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    up = ll.linear_apply(p["w_up"], xn, cfg)
    x_in, z = up[..., :di], up[..., di:]
    conv_out = F.silu(_causal_conv1d(p["conv"], x_in))
    q = ll.linear_apply(p["w_q"], conv_out, cfg).reshape(b, s, h_heads, dh)
    k = ll.linear_apply(p["w_k"], conv_out, cfg).reshape(b, s, h_heads, dh)
    v = ll.linear_apply(p["w_v"], x_in, cfg).reshape(b, s, h_heads, dh)
    if_gates = ll.linear_apply(p["w_if"], x_in, cfg).reshape(b, s, 2,
                                                             h_heads)
    return q, k, v, if_gates[:, :, 0], if_gates[:, :, 1], z, dh, di


def _mlstm_out(p: Dict, h: Tensor, z: Tensor, cfg: ArchConfig) -> Tensor:
    h = ll.rmsnorm_apply(p["out_norm"], h, cfg.norm_eps)
    h = h * F.silu(z)
    return ll.linear_apply(p["w_down"], h, cfg)


def mlstm_apply(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Training path, x [B, S, d] -> [B, S, d], in the JAX package's two
    forms: the chunkwise-parallel one (_mlstm_chunkwise) when
    cfg.mlstm_chunk divides S and S > chunk, else the sequential cell
    from the init state (m = -inf), a Python loop over S.

    The sequential form is the oracle, not a form for the card: autograd
    saves the matrix memory C [B, H, dh, dh] fp32 of every token, 16 MB a
    batch row a token at xlstm-1.3b's H 4, dh 1024, so 32 GB for one
    layer at B = 2, S = 1024 (and ~20 launches a token each way). The
    chunkwise form keeps C once a chunk."""
    b, s, _ = x.shape
    q, k, v, i_raw, f_raw, z, dh, di = _mlstm_qkvif(p, x, cfg)
    chunk = cfg.mlstm_chunk
    if chunk and s % chunk == 0 and s > chunk:
        h = _mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=chunk, dh=dh)
    else:
        h = _mlstm_sequential(q, k, v, i_raw, f_raw, dh=dh)
    h = h.reshape(b, s, di).to(x.dtype)
    return _mlstm_out(p, h, z, cfg)


def _mlstm_init_carry(b: int, h: int, dh: int, device: torch.device):
    """(C, n, m) of an empty memory: zeros, and the stabilizer at -inf."""
    return (torch.zeros(b, h, dh, dh, device=device),
            torch.zeros(b, h, dh, device=device),
            torch.full((b, h), -math.inf, device=device))


def _mlstm_sequential(q: Tensor, k: Tensor, v: Tensor, i_raw: Tensor,
                      f_raw: Tensor, *, dh: int) -> Tensor:
    """The decode cell run over S from the init state (the JAX package's
    lax.scan): q / k / v [B, S, H, dh], i / f [B, S, H] -> h [B, S, H, dh]
    fp32."""
    b, s, h, _ = q.shape
    state = _mlstm_init_carry(b, h, dh, q.device)
    hs = []
    for t in range(s):
        state, ht = _mlstm_cell(state, (q[:, t], k[:, t], v[:, t],
                                        i_raw[:, t], f_raw[:, t]), dh=dh)
        hs.append(ht)
    return torch.stack(hs, dim=1)


def _mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, i_raw: Tensor,
                     f_raw: Tensor, *, chunk: int, dh: int) -> Tensor:
    """Stabilized chunkwise mLSTM: q / k / v [B, S, H, dh], i / f [B, S, H]
    -> h [B, S, H, dh] fp32 (S a multiple of chunk).

    The sequential recurrence (_mlstm_cell)
        m_t = max(f_t + m_{t-1}, i_t)                      (log space)
        C_t = e^{f_t + m_{t-1} - m_t} C_{t-1} + e^{i_t - m_t} v_t k_t^T
        n_t likewise;  h_t = C_t q_t / max(|n_t q_t|, e^{-m_t})
    telescopes over a chunk (b_j the within-chunk cumsum of the f logs):
        m_j = max(b_j + m_0, max_{tau <= j} a_{j tau}),
        a_{j tau} = b_j - b_tau + i_tau,
        C_j = e^{b_j + m_0 - m_j} C_0 + sum_tau e^{a_{j tau} - m_j} v k^T,
    so a chunk is products: the inter-chunk term (scaled q) C_0 and the
    intra-chunk (D o Q K^T) V with D_{j tau} = e^{a_{j tau} - m_j}. A
    Python loop over the chunks carries (C, n, m) from m = -inf, where
    e^{b_j + m_0 - m_j} is exp(-inf) = 0 with a zero gradient. The maxima
    are torch.amax / torch.maximum, which split a tie's gradient evenly,
    as jnp.max / jnp.maximum do. The products stay torch.einsum, as the
    JAX package computes them outside any Pallas kernel."""
    b, s, h, _ = q.shape
    nc = s // chunk

    def resh(t: Tensor) -> Tensor:  # [B, S, H, *r] -> [B, nc, H, L, *r]
        return t.reshape(b, nc, chunk, h, *t.shape[3:]).movedim(3, 2) \
            .float()

    qf = resh(q)
    kf = resh(k) / math.sqrt(dh)
    vf = resh(v)
    i_log = resh(i_raw)                            # [B, nc, H, L]
    f_log = F.logsigmoid(resh(f_raw))

    bcum = torch.cumsum(f_log, dim=-1)             # b_j
    b_tot = bcum[..., -1]                          # the whole chunk's decay
    # intra-chunk decay exponents a[j, tau] = b_j - b_tau + i_tau, tau <= j
    a = bcum[..., :, None] - bcum[..., None, :] + i_log[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    a = torch.where(causal, a, -math.inf)          # [B, nc, H, L, L]
    a_max = torch.amax(a, dim=-1)

    C, n, m = _mlstm_init_carry(b, h, dh, q.device)
    hs = []
    for c in range(nc):
        qc, kc, vc = qf[:, c], kf[:, c], vf[:, c]
        bc, ac = bcum[:, c], a[:, c]
        m_j = torch.maximum(bc + m[:, :, None], a_max[:, c])   # [B, H, L]
        inter_scale = torch.exp(bc + m[:, :, None] - m_j)
        D = torch.exp(ac - m_j[..., None])                     # [B,H,L,L]
        scores = torch.einsum("bhld,bhtd->bhlt", qc, kc) * D
        num = (torch.einsum("bhlt,bhtd->bhld", scores, vc)
               + inter_scale[..., None]
               * torch.einsum("bhld,bhed->bhle", qc, C))  # C's k axis
        nvec = (torch.einsum("bhlt,bhtd->bhld", D, kc)
                + inter_scale[..., None] * n[:, :, None, :])
        den = torch.maximum(torch.einsum("bhld,bhld->bhl", nvec, qc).abs(),
                            torch.exp(-m_j))
        hs.append(num / den[..., None])                        # [B,H,L,dh]

        # the carry into the next chunk: the telescopes' row j = L
        m_last = m_j[..., -1]
        w_in = torch.exp(ac[..., -1, :] - m_last[..., None])  # [B, H, L]
        decay = torch.exp(b_tot[:, c] + m - m_last)
        C = (decay[..., None, None] * C
             + torch.einsum("bhtd,bhte->bhde", w_in[..., None] * vc, kc))
        n = decay[..., None] * n + torch.einsum("bht,bhtd->bhd", w_in, kc)
        m = m_last
    hs = torch.stack(hs, dim=2)                    # [B, H, nc, L, dh]
    return hs.reshape(b, h, s, dh).transpose(1, 2)


def mlstm_init_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> MLSTMState:
    di, dh = _mlstm_dims(cfg)
    return MLSTMState(
        *_mlstm_init_carry(batch, cfg.n_heads, dh, device),
        conv=torch.zeros(batch, cfg.conv1d_width - 1, di, device=device))


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


def slstm_apply(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Training path, x [B, S, d] -> [B, S, d]: the rmsnorm and the gate
    pre-activations of the whole sequence (one linear), then the decode
    cell in a Python loop over S from the init state (m = -inf): h feeds
    the recurrent weights, so the recurrence is not associative and has no
    parallel form, as in the JAX package's lax.scan. Then out_norm and the
    GeGLU up / down projection over the sequence.

    The loop's cost is per token: on an H100, 21 device operations
    forward, the same again in a remat recompute and 51 in the backward,
    each on tens of KB (chip_smoke.py's rec_forms counts them). The
    recurrent weights and the gate pre-activations are widened to fp32
    once, not a token at a time (the cell's own casts are then no-ops)."""
    b, s, d = x.shape
    h_heads = cfg.n_heads
    dh = d // h_heads
    xn = ll.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    wx = ll.linear_apply(p["w_gates"], xn, cfg).reshape(
        b, s, 4, h_heads, dh).float()
    r = p["r_gates"].float()
    state = slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state, ht = _slstm_cell(state, wx[:, t], r)
        hs.append(ht)
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    h = ll.rmsnorm_apply(p["out_norm"], h, cfg.norm_eps)
    u = F.gelu(ll.linear_apply(p["w_up_gate"], h, cfg), approximate="tanh")
    v = ll.linear_apply(p["w_up"], h, cfg)
    return ll.linear_apply(p["w_down"], u * v, cfg)


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
