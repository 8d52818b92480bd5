"""Deterministic synthetic data: classification images (MNIST / CIFAR
proxies) and event streams (a DVS Gesture proxy).

Port of repro.data.synthetic's CNN part. No dataset is downloaded: the
generators draw LEARNABLE class-conditional inputs (smooth low-rank class
templates plus Gaussian noise; class-dependent Bernoulli firing-rate maps)
so CADC-vs-vConv accuracy and convergence are measurable. Every batch is a pure function of (seed, step),
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


def make_event_dataset(n_classes: int = 11, hw: int = 32, t_steps: int = 8,
                       seed: int = 0, rate_contrast: float = 0.35,
                       device="cuda") -> Callable[[int, int],
                                                  Dict[str, Tensor]]:
    """DVS-Gesture-like synthetic event streams: class-dependent Bernoulli
    firing-rate maps over 2 polarities. batch_fn(step, batch_size) ->
    {'events' [B, T, H, W, 2] fp32 0/1, 'label' [B] int64} on `device`."""
    dev = resolve(device)
    gen = torch.Generator().manual_seed(seed)
    base = (torch.sigmoid(torch.randn(n_classes, hw, hw, 2, generator=gen)
                          * 1.5) * rate_contrast + 0.02).to(dev)

    def batch_fn(step: int, batch_size: int) -> Dict[str, Tensor]:
        g = torch.Generator(device=dev).manual_seed(
            (seed + 1) * 1_000_003 + step)
        labels = torch.randint(0, n_classes, (batch_size,), generator=g,
                               device=dev)
        rates = base[labels][:, None]  # [B, 1, H, W, 2]
        u = torch.rand((batch_size, t_steps, hw, hw, 2), generator=g,
                       device=dev)
        return {"events": (u < rates).float(), "label": labels}

    return batch_fn
