"""ResNet-18, CIFAR variant (paper benchmark #2).

Port of repro.models.cnn.resnet18. Stem 3x3/64 (no maxpool), stages
[2,2,2,2] BasicBlocks at 64/128/256/512 channels, global-avg-pool, FC.
`width` scales the channels (64 is the published width).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import common as cm

STAGES = (2, 2, 2, 2)


def _block_init(gen, cin, cout, stride, device):
    p = {"conv1": cm.conv_init(gen, 3, 3, cin, cout, device),
         "conv2": cm.conv_init(gen, 3, 3, cout, cout, device)}
    p["bn1"], bn1s = cm.bn_init(cout, device)
    p["bn2"], bn2s = cm.bn_init(cout, device)
    s = {"bn1": bn1s, "bn2": bn2s}
    if stride != 1 or cin != cout:
        p["proj"] = cm.conv_init(gen, 1, 1, cin, cout, device)
        p["bnp"], s["bnp"] = cm.bn_init(cout, device)
    return p, s


def init(gen: torch.Generator, *, num_classes: int = 10, in_ch: int = 3,
         width: int = 64, device=None):
    device = device or gen.device
    chans = [width, width * 2, width * 4, width * 8]
    params: Dict[str, Any] = {
        "stem": cm.conv_init(gen, 3, 3, in_ch, width, device)}
    params["bn_stem"], bns = cm.bn_init(width, device)
    state: Dict[str, Any] = {"bn_stem": bns}
    cin = width
    for si, (n_blocks, cout) in enumerate(zip(STAGES, chans)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = _block_init(
                gen, cin, cout, stride, device)
            cin = cout
    params["fc"] = cm.dense_init(gen, cin, num_classes, device=device)
    return params, state


def _block_apply(p, s, x, ctx, *, stride, train, name):
    ns = {}
    h = cm.conv_forward(p["conv1"], x, ctx, stride=(stride, stride),
                        name=f"{name}.conv1")
    h, ns["bn1"] = cm.bn_forward(p["bn1"], s["bn1"], h, train=train)
    h = torch.relu(h)
    h = cm.conv_forward(p["conv2"], h, ctx, name=f"{name}.conv2")
    h, ns["bn2"] = cm.bn_forward(p["bn2"], s["bn2"], h, train=train)
    if "proj" in p:
        sc = cm.conv_forward(p["proj"], x, ctx, stride=(stride, stride),
                             name=f"{name}.proj")
        sc, ns["bnp"] = cm.bn_forward(p["bnp"], s["bnp"], sc, train=train)
    else:
        sc = x
    return torch.relu(h + sc), ns


def apply(params, state, x, ctx: cm.Ctx, *, train: bool = False):
    new_state: Dict[str, Any] = {}
    h = cm.conv_forward(params["stem"], x, ctx, name="stem")
    h, new_state["bn_stem"] = cm.bn_forward(params["bn_stem"],
                                            state["bn_stem"], h, train=train)
    h = torch.relu(h)
    for si, n_blocks in enumerate(STAGES):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            h, new_state[name] = _block_apply(
                params[name], state[name], h, ctx,
                stride=2 if (si > 0 and bi == 0) else 1, train=train,
                name=name)
    logits = cm.linear_forward(params["fc"], cm.global_avg_pool(h), ctx,
                               name="fc")
    return logits, new_state
