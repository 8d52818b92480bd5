"""Spiking CNN (paper benchmark #4, DVS Gesture).

Port of repro.models.cnn.snn: two 3x3 conv layers and one FC, LIF neurons
(decay 0.5, threshold 1, soft reset), trained by backpropagation through
the T time steps with an arctan surrogate gradient. The paper finds the
sublinear f() (sqrt) best for this model. Input: event frames
[B, T, H, W, 2] (on / off polarities). The time loop is a Python loop
(JAX scans it); the spike is an autograd.Function (JAX: a custom_jvp).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import common as cm

THRESH = 1.0
DECAY = 0.5


class _Spike(torch.autograd.Function):
    """Heaviside spike v > THRESH; backward: the arctan surrogate
    1 / (1 + (pi (v - THRESH))^2)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return (v > THRESH).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * (1.0 / (1.0 + (math.pi * (v - THRESH)) ** 2))


def spike(v: torch.Tensor) -> torch.Tensor:
    return _Spike.apply(v)


def init(gen: torch.Generator, *, num_classes: int = 11, in_ch: int = 2,
         width: int = 32, hw: int = 32, device=None):
    device = device or gen.device
    c1, c2 = width, width * 2
    feat_hw = hw // 4  # two 2x2 pools
    params = {
        "c1": cm.conv_init(gen, 3, 3, in_ch, c1, device),
        "c2": cm.conv_init(gen, 3, 3, c1, c2, device),
        "fc": cm.dense_init(gen, feat_hw * feat_hw * c2, num_classes,
                            device=device),
    }
    return params, {}


def apply(params, state, x, ctx: cm.Ctx, *, train: bool = False):
    """x: [B, T, H, W, C] event frames -> rate-accumulated logits."""
    b, t, h, w, _ = x.shape
    c1 = params["c1"]["w"].shape[-1]
    c2 = params["c2"]["w"].shape[-1]
    n_cls = params["fc"]["w"].shape[-1]
    v1 = torch.zeros((b, h // 2, w // 2, c1), device=x.device)
    v2 = torch.zeros((b, h // 4, w // 4, c2), device=x.device)
    acc = torch.zeros((b, n_cls), device=x.device)
    for ti in range(t):
        h1 = cm.avg_pool(cm.conv_forward(params["c1"], x[:, ti], ctx,
                                         name="conv1"))
        v1 = DECAY * v1 + h1
        s1 = spike(v1)
        v1 = v1 - s1 * THRESH  # soft reset

        h2 = cm.avg_pool(cm.conv_forward(params["c2"], s1, ctx,
                                         name="conv2"))
        v2 = DECAY * v2 + h2
        s2 = spike(v2)
        v2 = v2 - s2 * THRESH

        acc = acc + cm.linear_forward(params["fc"], s2.reshape(b, -1), ctx,
                                      name="fc")
    return acc / t, state
