"""VGG-16 with BN, CIFAR variant (paper benchmark #3, CIFAR-100).

Port of repro.models.cnn.vgg16: 13 3x3 convs in five stages (64, 128, 256,
512, 512 channels; 2-2-3-3-3 convs), each conv followed by BN and relu, a
2x2 max-pool after each stage, then three FC layers (512-512-classes).
`width_div` divides every width (1 is the published width, ~15.3 M
parameters at 100 classes); no width falls below 8.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import common as cm

# (channels, n_convs) per stage; max-pooling after each stage.
CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def init(gen: torch.Generator, *, num_classes: int = 100, in_ch: int = 3,
         width_div: int = 1, device=None):
    device = device or gen.device
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    cin = in_ch
    for si, (c, n) in enumerate(CFG):
        c = max(8, c // width_div)
        for bi in range(n):
            params[f"c{si}_{bi}"] = cm.conv_init(gen, 3, 3, cin, c, device)
            params[f"bn{si}_{bi}"], state[f"bn{si}_{bi}"] = cm.bn_init(
                c, device)
            cin = c
    fc_dim = max(8, 512 // width_div)
    params["f1"] = cm.dense_init(gen, cin, fc_dim, device=device)
    params["f2"] = cm.dense_init(gen, fc_dim, fc_dim, device=device)
    params["f3"] = cm.dense_init(gen, fc_dim, num_classes, device=device)
    return params, state


def apply(params, state, x, ctx: cm.Ctx, *, train: bool = False):
    """x: [B, 32, 32, C] NHWC. The flatten before f1 is over NHWC, as in
    JAX (after five pools a 32x32 input is 1x1)."""
    new_state: Dict[str, Any] = {}
    h = x
    for si, (_, n) in enumerate(CFG):
        for bi in range(n):
            h = cm.conv_forward(params[f"c{si}_{bi}"], h, ctx,
                                name=f"c{si}_{bi}")
            h, new_state[f"bn{si}_{bi}"] = cm.bn_forward(
                params[f"bn{si}_{bi}"], state[f"bn{si}_{bi}"], h,
                train=train)
            h = torch.relu(h)
        h = cm.max_pool(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(cm.linear_forward(params["f1"], h, ctx, name="fc1"))
    h = torch.relu(cm.linear_forward(params["f2"], h, ctx, name="fc2"))
    logits = cm.linear_forward(params["f3"], h, ctx, name="fc3")
    return logits, new_state
