"""Plain PyTorch reference of ResNet-18 (CIFAR variant) under CADC: the
fp32 training step and the 4/2/4b int8 inference of the configuration.

No kernel of the port; it imports neither the port nor JAX. Layouts as
the configuration states them: NHWC activations, HWIO conv weights,
[in, out] dense weights.

* A conv is im2col (SAME padding, (k - 1) // 2 before, the rest after;
  taps outer, channels fastest) then a CADC product: the contraction
  split into crossbar segments of `crossbar_size` rows, each segment's
  psum in fp32, relu on each psum, the f(psums) summed in fp32 in segment
  order; backward dx = sum_s (g ⊙ [psum_s > 0]) w_s^T and dw_s = x_s^T
  (g ⊙ [psum_s > 0]). The FC layer is the same product plus its bias.
* BatchNorm in training: the batch's mean and biased variance over N, H,
  W, eps 1e-5; running statistics m·old + (1 - m)·new, m = 0.9.
* The step: mean cross-entropy, AdamW (the JAX formulas, fp32 moments)
  at a constant learning rate.
* Inference at 4/2/4b: each layer's input quantized per tensor to 4-bit
  codes (round half to even of clip(x / max|x|, -1, 1) · 7), its weight
  ternarized by the TWN rule (delta = 0.7 mean|w|, codes sign(w) where
  |w| > delta, alpha the mean |w| over them); each segment's psum of the
  codes is exact, scaled by (max|x| / 7) · alpha, relu, and summed in
  segment order in fp32; BatchNorm from the running statistics.

`tf32` (the training control) lets every product run in TF32;
`bf16` (the inference control) rounds every fp32 stage's output to
bfloat16.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


class _Cadc(torch.autograd.Function):
    """y = sum_s relu(x_s @ w_s), fp32."""

    @staticmethod
    def forward(ctx, x, w, xbar):
        acc = torch.zeros(x.shape[0], w.shape[1], device=x.device)
        for j in range(0, w.shape[0], xbar):
            p = x[:, j:j + xbar] @ w[j:j + xbar]
            acc = acc + torch.where(p > 0, p, torch.zeros_like(p))
        ctx.save_for_backward(x, w)
        ctx.xbar = xbar
        return acc

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        for j in range(0, w.shape[0], ctx.xbar):
            s = slice(j, j + ctx.xbar)
            gg = g * ((x[:, s] @ w[s]) > 0)
            dx[:, s] = gg @ w[s].t()
            dw[s] = x[:, s].t() @ gg
        return dx, dw, None


def im2col(x, k: int, stride: int):
    """x [B, H, W, C] -> [B, OH, OW, k·k·C], taps outer, channels fastest."""
    lo = (k - 1) // 2
    xp = F.pad(x, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    b, hp, wp, c = xp.shape
    oh, ow = (hp - k) // stride + 1, (wp - k) // stride + 1
    taps = [xp[:, i:i + (oh - 1) * stride + 1:stride,
               j:j + (ow - 1) * stride + 1:stride, :]
            for i in range(k) for j in range(k)]
    return torch.stack(taps, dim=3).reshape(b, oh, ow, k * k * c)


def conv(x, w, stride: int, xbar: int):
    k, cout = w.shape[0], w.shape[3]
    p = im2col(x, k, stride)
    b, oh, ow, d = p.shape
    y = _Cadc.apply(p.reshape(-1, d), w.reshape(d, cout), xbar)
    return y.reshape(b, oh, ow, cout)


def bn_train(p, s, x, momentum: float, eps: float):
    mean = x.mean((0, 1, 2))
    var = (x - mean).square().mean((0, 1, 2))
    new = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
           "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"], new


def stages(c: dict):
    """(block name, stride, whether it has a projection) in order."""
    cin = c["width"]
    for si, n in enumerate(c["stages"]):
        cout = c["width"] * 2 ** si
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            yield f"s{si}b{bi}", stride, stride != 1 or cin != cout
            cin = cout


def forward_train(p: dict, s: dict, x, c: dict):
    """(logits, new BN state) in training mode."""
    xb, t = c["crossbar_size"], c["train"]
    m, eps = t["bn_momentum"], t["bn_eps"]
    new: Dict = {}
    h = conv(x, p["stem"]["w"], 1, xb)
    h, new["bn_stem"] = bn_train(p["bn_stem"], s["bn_stem"], h, m, eps)
    h = torch.relu(h)
    for name, stride, proj in stages(c):
        bp, bs, ns = p[name], s[name], {}
        y = conv(h, bp["conv1"]["w"], stride, xb)
        y, ns["bn1"] = bn_train(bp["bn1"], bs["bn1"], y, m, eps)
        y = conv(torch.relu(y), bp["conv2"]["w"], 1, xb)
        y, ns["bn2"] = bn_train(bp["bn2"], bs["bn2"], y, m, eps)
        sc = h
        if proj:
            sc = conv(h, bp["proj"]["w"], stride, xb)
            sc, ns["bnp"] = bn_train(bp["bnp"], bs["bnp"], sc, m, eps)
        h = torch.relu(y + sc)
        new[name] = ns
    pooled = h.mean(dim=(1, 2))
    logits = _Cadc.apply(pooled, p["fc"]["w"], xb) + p["fc"]["b"]
    return logits, new


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield ".".join(path), tree


def _rebuild(tree, flat: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in tree.items()}
    return flat[".".join(path)]


def train(p: dict, s: dict, batches: List[dict], c: dict, *,
          tf32: bool = False, half: bool = False,
          regen: Callable[[], tuple]) -> dict:
    """len(batches) AdamW steps. Returns {"loss", "grad" (each leaf's norm
    of step 1's gradient), "delta" (each leaf's change), "state" (each
    running statistic's change)}, leaves in the tree's order."""
    t = c["train"]
    b1, b2, eps, wd, lr = t["b1"], t["b2"], t["eps"], t["weight_decay"], \
        t["lr"]
    w = dict(_leaves(p))
    names = list(w)
    mom = {k: torch.zeros_like(v) for k, v in w.items()}
    vel = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad1 = [], None
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for step, batch in enumerate(batches):
            x, y = batch["image"], batch["label"]
            if half:
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            live = {k: v.detach().requires_grad_() for k, v in w.items()}
            logits, s = forward_train(_rebuild(p, live), s, x, c)
            loss = -torch.log_softmax(logits.float(), -1).gather(
                1, y[:, None]).mean()
            grads = torch.autograd.grad(loss, list(live.values()))
            with torch.no_grad():
                g = dict(zip(names, grads))
                if grad1 is None:
                    grad1 = [torch.linalg.vector_norm(g[k]) for k in names]
                tt = torch.tensor(step + 1.0)
                mh = (1.0 / (1.0 - torch.pow(torch.tensor(b1), tt))).to(
                    x.device)
                vh = (1.0 / (1.0 - torch.pow(torch.tensor(b2), tt))).to(
                    x.device)
                for k in names:
                    mom[k] = b1 * mom[k] + (1 - b1) * g[k]
                    vel[k] = b2 * vel[k] + (1 - b2) * g[k].square()
                    w[k] = w[k] - lr * ((mom[k] * mh)
                                        / (torch.sqrt(vel[k] * vh) + eps)
                                        + wd * w[k])
            losses.append(loss.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    p0, s0 = regen()
    w0, st0 = dict(_leaves(p0)), dict(_leaves(s0))
    return {"loss": torch.stack(losses).tolist(),
            "grad": torch.stack(grad1).tolist(),
            "delta": torch.stack([torch.linalg.vector_norm(w[k] - w0[k])
                                  for k in names]).tolist(),
            "state": torch.stack([torch.linalg.vector_norm(v - st0[k])
                                  for k, v in _leaves(s)]).tolist()}


# ---------------------------------------------------------------------------
# 4/2/4b inference
# ---------------------------------------------------------------------------

def codes(x, bits: int):
    """(4-bit codes as fp32, lsb) of x, per tensor."""
    levels = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().max(), min=1e-8)
    return torch.round(torch.clamp(x / scale, -1.0, 1.0) * levels), \
        scale / levels


def ternary(w):
    """(codes {-1, 0, 1} as fp32, alpha) by the TWN rule."""
    a = w.abs()
    mask = a > 0.7 * a.mean()
    alpha = (a * mask).sum() / torch.clamp(mask.sum().to(w.dtype), min=1.0)
    return torch.sign(w) * mask, alpha


def q8_product(xc, wc, scale, xbar: int):
    """sum_s relu(scale · (x_s @ w_s)) in segment order, fp32; the psums
    of codes are exact integers."""
    acc = torch.zeros(xc.shape[0], wc.shape[1], device=xc.device)
    for j in range(0, wc.shape[0], xbar):
        p = (xc[:, j:j + xbar] @ wc[j:j + xbar]) * scale
        acc = acc + torch.where(p > 0, p, torch.zeros_like(p))
    return acc


def q8_conv(x, w, stride: int, xbar: int, bits: int):
    xc, lsb = codes(x, bits)
    wc, alpha = ternary(w)
    k, cout = w.shape[0], w.shape[3]
    p = im2col(xc, k, stride)
    b, oh, ow, d = p.shape
    return q8_product(p.reshape(-1, d), wc.reshape(d, cout), lsb * alpha,
                      xbar).reshape(b, oh, ow, cout)


@torch.no_grad()
def forward_q8(p: dict, s: dict, x, c: dict, bf16: bool = False):
    """Logits [B, classes] at the 4/2/4b point."""
    xb, bits = c["crossbar_size"], c["q8"]["input_bits"]
    eps = c["train"]["bn_eps"]

    def r(t):
        return t.to(BF16).float() if bf16 else t

    def bn(pp, ss, t):
        return r((t - ss["mean"]) * torch.rsqrt(ss["var"] + eps)
                 * pp["scale"] + pp["bias"])

    h = r(q8_conv(x, p["stem"]["w"], 1, xb, bits))
    h = torch.relu(bn(p["bn_stem"], s["bn_stem"], h))
    for name, stride, proj in stages(c):
        bp, bs = p[name], s[name]
        y = r(q8_conv(h, bp["conv1"]["w"], stride, xb, bits))
        y = torch.relu(bn(bp["bn1"], bs["bn1"], y))
        y = bn(bp["bn2"], bs["bn2"], r(q8_conv(y, bp["conv2"]["w"], 1, xb,
                                               bits)))
        sc = h
        if proj:
            sc = bn(bp["bnp"], bs["bnp"],
                    r(q8_conv(h, bp["proj"]["w"], stride, xb, bits)))
        h = r(torch.relu(y + sc))
    pooled = r(h.mean(dim=(1, 2)))
    xc, lsb = codes(pooled, bits)
    wc, alpha = ternary(p["fc"]["w"])
    return r(q8_product(xc, wc, lsb * alpha, xb)) + p["fc"]["b"]
