"""Step functions. Port of repro.launch.steps.

train_step: microbatched gradient accumulation -> AdamW update, as the JAX
package's make_train_step (fp32 master parameters, cast to the compute
dtype inside the differentiated loss, so the gradients reach the masters
through the cast).
prefill_step: the full-sequence forward, last-position logits.
batched_prefill_step / serve_step (decode): the serving steps. Serving
takes no gradient, so there the port casts the parameters once, when the
engine is built (`cast_compute`), and the steps take the cast parameters:
every product sees the values a per-step cast would give.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.train import optimizer as opt_lib

Tensor = torch.Tensor


def make_optimizer(cfg: ArchConfig) -> opt_lib.Optimizer:
    return opt_lib.adamw(
        lr=opt_lib.cosine_warmup_schedule(3e-4, 2000, 100_000),
        weight_decay=0.1,
        max_grad_norm=1.0,
    )


def cast_compute(params, cfg: ArchConfig):
    """fp32 parameters cast to the compute dtype (bf16_wire), the JAX
    package's cast at the top of a step. Differentiable: in the train step
    it runs inside the loss, so the gradients of the cast copies flow to
    the fp32 masters (as fp32)."""
    if not cfg.bf16_wire:
        return params
    dt = ll.cdtype(cfg)
    return tf.tree_map(
        lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)


def _leaves(tree) -> list:
    """The leaves of nested dicts / lists, in tf.tree_map's order."""
    return list(opt_lib._leaves(tree))


def _rebuild(like, leaves: list):
    """`leaves` (in _leaves order) in the structure of `like`."""
    it = iter(leaves)
    return tf.tree_map(lambda _: next(it), like)


def make_train_step(cfg: ArchConfig,
                    optimizer: Optional[opt_lib.Optimizer] = None,
                    n_micro: Optional[int] = None) -> Callable:
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss"}). The batch's leading axis is cut into n_micro contiguous
    microbatches (micro i takes rows [i * B / n_micro, (i + 1) * B /
    n_micro)); each one's loss (lm_loss + 0.01 * the MoE aux loss) is
    differentiated, the gradients are summed in fp32 in micro order from
    zero and divided by n_micro, then optimizer.update and apply_updates.
    "loss" is the mean of the micros' losses. New tensors are returned;
    the inputs are left as they were."""
    optimizer = optimizer or make_optimizer(cfg)
    n_micro = n_micro or cfg.n_microbatches

    def loss_fn(params, micro_batch):
        logits, aux = tf.forward_train(cast_compute(params, cfg),
                                       micro_batch, cfg)
        loss, metrics = tf.lm_loss(logits, micro_batch["labels"])
        return loss + 0.01 * aux, metrics

    def train_step(params, opt_state, batch: Dict[str, Tensor], step: int):
        masters = [p.detach() for p in _leaves(params)]
        gsum = [torch.zeros(p.shape, device=p.device) for p in masters]
        lsum = torch.zeros((), device=masters[0].device)
        for i in range(n_micro):
            micro = {k: v.reshape(n_micro, -1, *v.shape[1:])[i]
                     for k, v in batch.items()}
            live = [p.requires_grad_() for p in
                    (m.detach() for m in masters)]
            loss, _ = loss_fn(_rebuild(params, live), micro)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            gsum = [a if g is None else a + g.float()
                    for a, g in zip(gsum, grads)]
            lsum = lsum + loss.detach()
            del loss, grads, live
        with torch.no_grad():
            grads = _rebuild(params, [g / n_micro for g in gsum])
            plain = _rebuild(params, masters)
            updates, opt_state = optimizer.update(grads, opt_state, plain,
                                                  step)
            params = opt_lib.apply_updates(plain, updates)
        return params, opt_state, {"loss": lsum / n_micro}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """prefill_step(params, batch) -> next-token logits [B, V] of the
    full-sequence forward (no gradient: K1 on the card)."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Tensor]):
        logits, _ = tf.forward_train(cast_compute(params, cfg), batch, cfg)
        return logits[:, -1, :]

    return prefill_step


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
