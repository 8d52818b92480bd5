"""What the ResNet-18 drivers share: the weights and the images, which
the benchmark makes itself from the seed, and the model's shapes.

Weights: one fp32 draw on the device (Generator seeded by the seed) cut
into the tree `models/cnn/resnet18.py` `init` makes (HWIO convs He-scaled
by sqrt(2 / fan_in), the FC [in, out] likewise; BN scale 1 + 0.1·N, BN
and FC biases 0.1·N; BN running mean 0.1·N and variance 1 + 0.25·tanh N).
Images: the benchmark's copy of `data/synthetic.py`'s classification
proxy (smooth low-rank class templates from a CPU Generator seeded by the
seed, plus Gaussian noise drawn on the device).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def blocks(c: dict) -> List[Tuple[str, int, int, int]]:
    """(name, cin, cout, stride) of every BasicBlock."""
    out, cin = [], c["width"]
    for si, n in enumerate(c["stages"]):
        cout = c["width"] * 2 ** si
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            out.append((f"s{si}b{bi}", cin, cout, stride))
            cin = cout
    return out


def convs(c: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, input size, cin, cout, k, stride) of every conv, in order."""
    hw = c["image_hw"]
    out = [("stem", hw, c["channels"], c["width"], 3, 1)]
    for name, cin, cout, stride in blocks(c):
        out.append((f"{name}.conv1", hw, cin, cout, 3, stride))
        hw2 = -(-hw // stride)
        out.append((f"{name}.conv2", hw2, cout, cout, 3, 1))
        if stride != 1 or cin != cout:
            out.append((f"{name}.proj", hw, cin, cout, 1, stride))
        hw = hw2
    return out


def fc_in(c: dict) -> int:
    return c["width"] * 2 ** (len(c["stages"]) - 1)


def draw(c: dict, seed: int, device) -> Tuple[dict, dict]:
    """(params, BN state) of `seed`, in resnet18.init's tree."""
    specs = []   # (path, shape, kind)

    def bn(path):
        for k in ("scale", "bias"):
            specs.append((path + (k,), (None,), "bn_" + k))

    specs.append((("stem", "w"), (3, 3, c["channels"], c["width"]), "he"))
    bn(("bn_stem",))
    for name, cin, cout, stride in blocks(c):
        specs.append(((name, "conv1", "w"), (3, 3, cin, cout), "he"))
        specs.append(((name, "conv2", "w"), (3, 3, cout, cout), "he"))
        for b in ("bn1", "bn2"):
            bn((name, b))
        if stride != 1 or cin != cout:
            specs.append(((name, "proj", "w"), (1, 1, cin, cout), "he"))
            bn((name, "bnp"))
    specs.append((("fc", "w"), (fc_in(c), c["num_classes"]), "he"))
    specs.append((("fc", "b"), (c["num_classes"],), "bias"))

    sizes = []
    for path, shape, kind in specs:
        if shape == (None,):
            shape = (_bn_channels(c, path),)
        sizes.append(shape)
    n_state = sum(2 * s[0] for (p, _, k), s in zip(specs, sizes)
                  if k == "bn_scale")
    total = sum(math.prod(s) for s in sizes) + n_state
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    params: dict = {}
    state: dict = {}
    at = 0

    def take(shape):
        nonlocal at
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        return t

    for (path, _, kind), shape in zip(specs, sizes):
        t = take(shape)
        if kind == "he":
            fan_in = math.prod(shape[:-1])
            t.mul_(math.sqrt(2.0 / fan_in))
        elif kind == "bn_scale":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        _put(params, path, t)
        if kind == "bn_scale":
            mean = take(shape).mul_(0.1)
            var = take(shape).tanh_().mul_(0.25).add_(1.0)
            _put(state, path[:-1] + ("mean",), mean)
            _put(state, path[:-1] + ("var",), var)
    return params, state


def _bn_channels(c: dict, path: tuple) -> int:
    if path[0] == "bn_stem":
        return c["width"]
    for name, _, cout, _ in blocks(c):
        if path[0] == name:
            return cout
    raise KeyError(path)


def _put(tree: dict, path: tuple, t) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = t


def leaves(tree) -> list:
    """(path, tensor) in insertion order (the port's `_flatten` order)."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out.append((".".join(path), t))

    walk(tree, ())
    return out


def norms(tree) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.detach().float())
                        for _, t in leaves(tree)])


def delta_norms(tree, base) -> torch.Tensor:
    b = dict(leaves(base))
    return torch.stack([torch.linalg.vector_norm((t.detach() - b[k]).float())
                        for k, t in leaves(tree)])


def _smooth(a: torch.Tensor) -> torch.Tensor:
    k = torch.tensor([[[0.25, 0.5, 0.25]]], dtype=a.dtype)
    return F.conv1d(a.reshape(-1, 1, a.shape[-1]), k, padding=1).reshape(
        a.shape)


def templates(c: dict, t: dict, seed: int) -> torch.Tensor:
    """Class templates [C, H, W, ch] (a copy of data/synthetic.py's)."""
    gen = torch.Generator().manual_seed(seed)
    n, r, hw = c["num_classes"], t["template_rank"], c["image_hw"]
    u = _smooth(torch.randn(n, r, hw, generator=gen))
    v = _smooth(torch.randn(n, r, hw, generator=gen))
    tt = torch.einsum("crh,crw->chw", u, v) / r ** 0.5
    ch = torch.randn(n, 1, 1, c["channels"], generator=gen) * 0.3 + 1.0
    return tt[..., None] * ch


def images(c: dict, t: dict, seed: int, device) -> List[Dict]:
    """The traffic's replay set: `batches` batches of `batch` images
    {"image" [B, H, W, ch] fp32, "label" [B] int64} on the device."""
    temp = templates(c, t, seed).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = []
    for _ in range(t["batches"]):
        labels = torch.randint(0, c["num_classes"], (t["batch"],),
                               generator=gen, device=device)
        x = temp[labels]
        x = x + t["noise"] * torch.randn(x.shape, generator=gen,
                                         device=device)
        out.append({"image": x, "label": labels})
    return out


def forward_flops(c: dict) -> float:
    """2·MACs of one image's convs and FC (contractions unpadded)."""
    total = 0.0
    for _, hw, cin, cout, k, stride in convs(c):
        oh = -(-hw // stride)
        total += 2.0 * oh * oh * k * k * cin * cout
    return total + 2.0 * fc_in(c) * c["num_classes"]
