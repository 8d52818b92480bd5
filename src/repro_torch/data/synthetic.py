"""Deterministic synthetic classification data (MNIST / CIFAR proxies).

Port of repro.data.synthetic's classification part. No dataset is
downloaded: the generator draws LEARNABLE class-conditional images (smooth
low-rank class templates plus Gaussian noise) so CADC-vs-vConv accuracy and
convergence are measurable. Every batch is a pure function of (seed, step),
drawn from a torch.Generator seeded from both. torch's generators cannot
give jax.random's bits, so the numbers differ from the JAX package's for
the same spec; tests that compare the two feed JAX-made batches to both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClassificationSpec:
    n_classes: int = 10
    hw: int = 28
    channels: int = 1
    noise: float = 0.7        # higher -> harder
    template_rank: int = 4    # low-rank class templates (CNN-friendly)
    seed: int = 0


def _smooth(a: Tensor) -> Tensor:
    """[..., L] convolved with [0.25, 0.5, 0.25], 'same' (zero ends)."""
    k = torch.tensor([[[0.25, 0.5, 0.25]]], dtype=a.dtype)
    return F.conv1d(a.reshape(-1, 1, a.shape[-1]), k, padding=1).reshape(
        a.shape)


def _templates(spec: ClassificationSpec) -> Tensor:
    """Low-rank smooth class templates [C, H, W, ch]: sums of outer
    products of smooth 1-D profiles, so a conv has structure to find."""
    gen = torch.Generator().manual_seed(spec.seed)
    c, r, hw = spec.n_classes, spec.template_rank, spec.hw
    u = _smooth(torch.randn(c, r, hw, generator=gen))
    v = _smooth(torch.randn(c, r, hw, generator=gen))
    t = torch.einsum("crh,crw->chw", u, v) / r ** 0.5
    ch = torch.randn(c, 1, 1, spec.channels, generator=gen) * 0.3 + 1.0
    return t[..., None] * ch


def make_classification_dataset(spec: ClassificationSpec, device="cuda"
                                ) -> Callable[[int, int], Dict[str, Tensor]]:
    """batch_fn(step, batch_size) -> {'image' [B, H, W, ch] fp32,
    'label' [B] int64} on `device`."""
    dev = resolve(device)
    templates = _templates(spec).to(dev)

    def batch_fn(step: int, batch_size: int) -> Dict[str, Tensor]:
        gen = torch.Generator(device=dev).manual_seed(
            (spec.seed + 1) * 1_000_003 + step)
        labels = torch.randint(0, spec.n_classes, (batch_size,),
                               generator=gen, device=dev)
        x = templates[labels]
        x = x + spec.noise * torch.randn(x.shape, generator=gen, device=dev)
        return {"image": x, "label": labels}

    return batch_fn
