"""Deterministic synthetic data: classification images (MNIST / CIFAR
proxies), event streams (a DVS Gesture proxy) and LM token streams.

Port of repro.data.synthetic. No dataset is downloaded: the
generators draw LEARNABLE class-conditional inputs (smooth low-rank class
templates plus Gaussian noise; class-dependent Bernoulli firing-rate maps;
a hash-chained token language) so CADC-vs-vConv accuracy and convergence
are measurable. Every batch is a pure function of (seed, step),
drawn from a torch.Generator seeded from both. torch's generators cannot
give jax.random's bits, so the numbers differ from the JAX package's for
the same spec; tests that compare the two feed JAX-made batches to both
(for the LM streams: JAX-drawn starts and noise to the port's chain).
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


@dataclasses.dataclass(frozen=True)
class LMTokenSpec:
    vocab_size: int = 32768
    seq_len: int = 1024
    seed: int = 0
    order: int = 2  # markov order of the synthetic language


_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


def _mul_u32(h: Tensor, mult: int) -> Tensor:
    """(h * mult) mod 2**32 for h in [0, 2**32) held in int64, without an
    int64 overflow: h's 16-bit halves are multiplied apart."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * mult + (((hi * mult) & 0xFFFF) << 16)) & _U32


def lm_chain(first: Tensor, noise: Tensor, vocab_size: int) -> Tensor:
    """The language of make_lm_dataset: first [B, order] start tokens,
    noise [B, L] uniform in [0, 1) -> tokens [B, L] int32. Token t is the
    hash of the `order` tokens before it, h = ((h ^ tok) * 2654435761) mod
    2**32 over them from h = 0, taken mod vocab_size — or, where noise[t] <
    0.1, int(noise[t] * vocab_size): a 10 % uniform resample."""
    ctx = [first[:, i].to(torch.int64) for i in range(first.shape[1])]
    out = []
    for t in range(noise.shape[1]):
        h = torch.zeros_like(ctx[0])
        for c in ctx:
            h = _mul_u32(h ^ c, _HASH_MULT)
        eps = noise[:, t]
        rnd = (eps * vocab_size).to(torch.int64)
        nxt = torch.where(eps < 0.1, rnd, h % vocab_size)
        ctx = ctx[1:] + [nxt]
        out.append(nxt)
    return torch.stack(out, dim=1).to(torch.int32)


def make_lm_dataset(spec: LMTokenSpec, device="cuda"
                    ) -> Callable[[int, int], Dict[str, Tensor]]:
    """Synthetic token streams with local structure (hash-chained next-token
    distribution) so an LM's loss decreases measurably. batch_fn(step, bs)
    -> {'tokens': [B, L + 1] int32} on `device` (shift for inputs / labels
    downstream). The starts and the noise come from a CPU torch.Generator
    seeded by (seed, step) and the chain runs on the CPU, so a batch is the
    same on every device."""
    dev = resolve(device)

    def batch_fn(step: int, batch_size: int) -> Dict[str, Tensor]:
        gen = torch.Generator().manual_seed(
            (spec.seed + 1) * 1_000_003 + step)
        first = torch.randint(0, spec.vocab_size, (batch_size, spec.order),
                              generator=gen)
        noise = torch.rand((batch_size, spec.seq_len + 1), generator=gen)
        return {"tokens": lm_chain(first, noise, spec.vocab_size).to(dev)}

    return batch_fn
