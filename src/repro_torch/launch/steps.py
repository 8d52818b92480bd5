"""Serving step functions. Port of the serving part of repro.launch.steps.

The JAX package casts the fp32 master parameters to the compute dtype at
the top of every step (`cast_compute`). Serving takes no gradient, so the
port casts once, when the engine is built (`cast_compute` below), and the
steps take the cast parameters: every product sees the same values as
with a per-step cast, so the numbers are the same.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf

Tensor = torch.Tensor


def cast_compute(params, cfg: ArchConfig):
    """fp32 parameters cast to the compute dtype (bf16_wire: the JAX
    package's one cast per step; here one cast at load)."""
    if not cfg.bf16_wire:
        return params
    return tf.cast_params(params, ll.cdtype(cfg))


def make_batched_prefill_step(cfg: ArchConfig) -> Callable:
    """Serving prefill over left-aligned ragged prompts. lengths [B] picks
    each slot's own last-token logits and freezes its recurrent states at
    its own length. Returns (next_tokens [B], last_logits [B, V], cache
    contributions)."""

    def batched_prefill_step(params, batch: Dict[str, Tensor],
                             lengths: Tensor):
        logits, contribs = tf.forward_prefill(params, batch, cfg,
                                              lengths=lengths)
        idx = (lengths - 1).clamp(min=0).to(torch.int64)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        return torch.argmax(last, dim=-1).to(torch.int32), last, contribs

    return batched_prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step against dense caches (updated in place). `position`
    is a scalar or a [B] vector of per-slot offsets."""

    def serve_step(params, tokens: Tensor, position, caches):
        logits = tf.decode_step(params, tokens, position, caches, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return serve_step
