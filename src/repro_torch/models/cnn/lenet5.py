"""LeNet-5 (paper benchmark #1, MNIST).

Port of repro.models.cnn.lenet5. Classic topology on 32x32 (28x28 inputs
are padded): C1 5x5x6 -> P -> C2 5x5x16 -> P -> FC 400-120-84-classes.
Conv-1 fits a single 64x64 crossbar (5*5*1 = 25 rows) and generates no
psums — the paper's "Conv-1 excluded" note for Fig. 5. The flatten before
f1 is over NHWC, as in JAX, so weights carried across keep their meaning.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def init(gen: torch.Generator, *, num_classes: int = 10, in_ch: int = 1,
         width: int = 1, device=None):
    c1, c2 = 6 * width, 16 * width
    params = {
        "c1": cm.conv_init(gen, 5, 5, in_ch, c1, device),
        "c2": cm.conv_init(gen, 5, 5, c1, c2, device),
        "f1": cm.dense_init(gen, c2 * 25, 120 * width, device=device),
        "f2": cm.dense_init(gen, 120 * width, 84 * width, device=device),
        "f3": cm.dense_init(gen, 84 * width, num_classes, device=device),
    }
    state: Dict[str, Any] = {}
    return params, state


def apply(params, state, x, ctx: cm.Ctx, *, train: bool = False):
    """x: [B, 28, 28, C] or [B, 32, 32, C]."""
    if x.shape[1] == 28:
        x = F.pad(x, (0, 0, 2, 2, 2, 2))
    h = cm.conv_forward(params["c1"], x, ctx, padding="VALID", name="conv1")
    h = cm.avg_pool(torch.relu(h))
    h = cm.conv_forward(params["c2"], h, ctx, padding="VALID", name="conv2")
    h = cm.avg_pool(torch.relu(h))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(cm.linear_forward(params["f1"], h, ctx, name="fc1"))
    h = torch.relu(cm.linear_forward(params["f2"], h, ctx, name="fc2"))
    logits = cm.linear_forward(params["f3"], h, ctx, name="fc3")
    return logits, state
