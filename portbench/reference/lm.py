"""Plain PyTorch reference of the decoder LM the phi4-mini configuration
describes, under CADC: training steps and the serving prefill.

No kernel, cache or batching of the port; it imports neither the port
nor JAX. It computes what the configuration states:

* every linear is a CADC product: D split into crossbar segments of
  `crossbar_size` rows, each segment's partial sum (psum) from bf16
  operands accumulated in fp32, f = relu on each psum, the segments'
  f(psum) summed in fp32 in segment order, the result rounded to bf16;
  its backward dx = sum_s (g ⊙ [psum_s > 0]) w_s^T, dw_s = x_s^T (g ⊙
  [psum_s > 0]) in fp32 from the bf16 operands, rounded to bf16;
* bf16 on the wire (the configuration's `dtype`; float32 computes the
  same in fp32): the fp32 masters cast to bf16 for the step,
  activations held in bf16 between operations, RMSNorm x · rsqrt(mean
  x² + eps) · (1 + scale) in fp32, rounded to bf16; RoPE (rotate-half,
  every dimension) in fp32; causal GQA attention with fp32 scores and
  softmax, probabilities rounded to bf16 before an fp32 PV product;
  SwiGLU; the tied head x · E^T in fp32 from bf16 operands, rounded to
  bf16, the loss in fp32: cross-entropy + 1e-4 · logsumexp²;
* the step: microbatches' gradients summed in fp32 and averaged, global
  norm clipped to `max_grad_norm`, AdamW (the JAX formulas, fp32
  moments) at a linear warm-up of `lr` over `warmup` steps, weight decay.

Departures from the published Phi-4-mini (the port's, kept here): RoPE
on every dimension (published: 75 %), no LongRoPE rescaling, the norm's
(1 + scale) form, the z-loss term, CADC on every linear.

`rnd`, where given, rounds every product's operands (the control: fp8
e4m3 with a per-tensor scale).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -2.0 ** 30
Rnd = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    s = t.abs().amax().float().clamp(min=1e-30) / 448.0
    return (t.float() / s).to(torch.float8_e4m3fn).float() * s


def weights(draw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's fp32 masters from the benchmark's draw (leaf name
    -> tensor; linears [d_in, d_out])."""
    return {k: v.detach() for k, v in draw.items()}


class _Cadc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, xbar, rnd):
        d, n = w.shape
        x2, w2 = x.reshape(-1, d).float(), w.float()
        if rnd is not None:
            x2, w2 = rnd(x2), rnd(w2)
        acc = torch.zeros(x2.shape[0], n, device=x.device)
        for j in range(0, d, xbar):
            p = x2[:, j:j + xbar] @ w2[j:j + xbar]
            acc = acc + torch.where(p > 0, p, torch.zeros_like(p))
        ctx.save_for_backward(x, w)
        ctx.xbar, ctx.rnd = xbar, rnd
        return acc.to(x.dtype).reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d, n = w.shape
        x2, w2 = x.reshape(-1, d).float(), w.float()
        g2 = g.reshape(-1, n).float()
        if ctx.rnd is not None:
            x2, w2, g2 = ctx.rnd(x2), ctx.rnd(w2), ctx.rnd(g2)
        dx, dw = torch.empty_like(x2), torch.empty_like(w2)
        for j in range(0, d, ctx.xbar):
            s = slice(j, j + ctx.xbar)
            gg = g2 * ((x2[:, s] @ w2[s]) > 0)
            dx[:, s] = gg @ w2[s].t()
            dw[s] = x2[:, s].t() @ gg
        return (dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype), None,
                None)


def cadc(x, w, xbar: int, rnd: Rnd = None):
    return _Cadc.apply(x, w, xbar, rnd)


def rms(x, scale, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def rope(x, positions, theta: float):
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v):
    """q [b, s, H, hd], k / v [b, s, K, hd], causal -> [b, s, H·hd]."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos[None, :] <= pos[:, None], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, s, h * hd).to(q.dtype)


def layer(x, w: Dict[str, torch.Tensor], c: dict, rnd: Rnd,
          kv_out: Optional[list] = None):
    """One decoder layer; kv_out gets its rope'd (k, v) [b, s, K, hd]."""
    b, s, _ = x.shape
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim", c["hidden_size"] // h)
    xb, eps = c["crossbar_size"], c["rms_norm_eps"]
    pos = torch.arange(s, device=x.device)
    a = rms(x, w["ln1"], eps)
    q = rope(cadc(a, w["wq"], xb, rnd).reshape(b, s, h, hd), pos,
             c["rope_theta"])
    k = rope(cadc(a, w["wk"], xb, rnd).reshape(b, s, kv, hd), pos,
             c["rope_theta"])
    v = cadc(a, w["wv"], xb, rnd).reshape(b, s, kv, hd)
    if kv_out is not None:
        kv_out.append((k, v))
    x = x + cadc(attention(q, k, v), w["wo"], xb, rnd)
    a = rms(x, w["ln2"], eps)
    up = F.silu(cadc(a, w["w_gate"], xb, rnd)) * cadc(a, w["w_up"], xb, rnd)
    return x + cadc(up, w["w_down"], xb, rnd)


def _layer_weights(w: Dict[str, torch.Tensor], i: int) -> dict:
    p = f"layers.{i}."
    return {k[len(p):]: v for k, v in w.items() if k.startswith(p)}


def head(x, table, rnd: Rnd):
    """fp32 logits [.., V]: x · E^T accumulated in fp32, rounded to bf16."""
    a, e = x.float(), table.float()
    if rnd is not None:
        a, e = rnd(a), rnd(e)
    return (a @ e.t()).to(x.dtype).float()


def forward(w: Dict[str, torch.Tensor], tokens, c: dict, rnd: Rnd = None,
            remat: bool = True):
    """Logits fp32 [b, s, V] of bf16 weights `w`."""
    x = w["embed"][tokens]
    for i in range(c["num_hidden_layers"]):
        lw = _layer_weights(w, i)
        if remat:
            x = checkpoint(layer, x, lw, c, rnd, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, lw, c, rnd)
    x = rms(x, w["final_norm"], c["rms_norm_eps"])
    return head(x, w["embed"], rnd)


def lm_loss(logits, labels, z_loss: float = 1e-4):
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((lse - picked) + z_loss * lse.square()).mean()


def _lr(c: dict, step: int) -> float:
    t = c["train"]
    return t["lr"] * min(step / max(1.0, t["warmup"]), 1.0)


def train(w: Dict[str, torch.Tensor], blocks: List[torch.Tensor], c: dict,
          *, micro: int, rnd: Rnd = None, half: bool = False,
          regen: Callable[[], Dict[str, torch.Tensor]]) -> dict:
    """len(blocks) AdamW steps from fp32 masters `w` over token blocks
    [rows, seq + 1]. Returns {"loss": [each step's mean micro loss],
    "grad": [each leaf's norm of step 1's clipped gradient], "delta":
    [each leaf's norm of its change over the steps]}, leaves in `w`'s
    order. `regen` draws the initial masters again (for the change)."""
    t = c["train"]
    b1, b2, eps, wd = t["b1"], t["b2"], t["eps"], t["weight_decay"]
    dt = getattr(torch, c["dtype"])
    names = list(w)
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad1 = [], None
    for step, block in enumerate(blocks):
        rows = block.shape[0] // micro
        gsum = {k: torch.zeros_like(v) for k, v in w.items()}
        lsum = torch.zeros((), device=block.device)
        for i in range(micro):
            mb = block[i * rows:(i + 1) * rows]
            if half:
                mb = mb[: max(1, rows // 2)]
            live = {k: p.detach().requires_grad_() for k, p in w.items()}
            cast = {k: p.to(dt) for k, p in live.items()}
            loss = lm_loss(forward(cast, mb[:, :-1], c, rnd), mb[:, 1:])
            grads = torch.autograd.grad(loss, list(live.values()))
            for k, g in zip(names, grads):
                gsum[k] += g.float()
            lsum += loss.detach()
            del loss, grads, live, cast
        with torch.no_grad():
            g = {k: s / micro for k, s in gsum.items()}
            del gsum
            norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            scale = torch.clamp(t["max_grad_norm"] / (norm + 1e-9), max=1.0)
            g = {k: x * scale for k, x in g.items()}
            if grad1 is None:
                grad1 = [torch.linalg.vector_norm(g[k]) for k in names]
            tt = torch.tensor(step + 1.0)
            mh = 1.0 / (1.0 - torch.pow(torch.tensor(b1), tt))
            vh = 1.0 / (1.0 - torch.pow(torch.tensor(b2), tt))
            mh, vh = mh.to(block.device), vh.to(block.device)
            lr = _lr(c, step)
            for k in names:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k].square()
                u = -lr * ((m[k] * mh) / (torch.sqrt(v2[k] * vh) + eps)
                           + wd * w[k])
                w[k] = w[k] + u
            del g
        losses.append(lsum / micro)
    del m, v2
    w0 = regen()
    delta = [torch.linalg.vector_norm(w[k] - w0[k]) for k in names]
    return {"loss": torch.stack(losses).tolist(),
            "grad": torch.stack(grad1).tolist(),
            "delta": torch.stack(delta).tolist()}


@torch.no_grad()
def prefill(w: Dict[str, torch.Tensor], prompt, c: dict, rnd: Rnd = None):
    """One prompt [s] through bf16 weights: (the last position's fp32
    logits [V], each layer's rope'd (k, v) [s, K, hd])."""
    x = w["embed"][prompt[None]]
    kv: list = []
    for i in range(c["num_hidden_layers"]):
        x = layer(x, _layer_weights(w, i), c, rnd, kv_out=kv)
    x = rms(x[:, -1:], w["final_norm"], c["rms_norm_eps"])
    return head(x, w["embed"], rnd)[0, 0], [(k[0], v[0]) for k, v in kv]
