"""Minimal functional optimizers over nested dicts of tensors.

Port of repro.train.optimizer: AdamW and SGD-momentum as (init, update)
pairs with global-norm clipping and schedules, in the JAX formulas (not
torch.optim, whose update order and bias correction differ). State and
updates are new tensors; nothing is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

PyTree = Any
Tensor = torch.Tensor


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    # update(grads, opt_state, params, step, *, sq_norm=None)
    #   -> (updates, new_state); sq_norm: clip_by_global_norm's


def _tmap(f, *trees):
    """tree_map over nested dicts, lists and tuples (the first tree gives
    the structure)."""
    if isinstance(trees[0], dict):
        return {k: _tmap(f, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_tmap(f, *xs) for xs in zip(*trees))
    return f(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        sq_norm: Optional[Tensor] = None
                        ) -> Tuple[PyTree, Tensor]:
    """grads scaled to a global norm of at most max_norm. sq_norm: the
    squared global norm, given where `grads` are one rank's shards of the
    gradient (the data-parallel step sums the shards' squares over the
    ranks); by default the leaves' own."""
    if sq_norm is None:
        sq_norm = sum(g.float().square().sum() for g in _leaves(grads))
    gnorm = torch.sqrt(sq_norm)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return _tmap(lambda g: g * scale, grads), gnorm


def cosine_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, min_ratio: float = 0.1
                           ) -> Callable[[int], float]:
    def sched(step):
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        frac = min(max((step - warmup_steps)
                       / max(1.0, total_steps - warmup_steps), 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * frac)))

    return sched


def _lr_fn(lr) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda _: lr)


def adamw(lr: Union[float, Callable] = 1e-3, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: Optional[float] = None) -> Optimizer:
    """AdamW with fp32 moments."""
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, device=p.device)  # noqa: E731
        return {"m": _tmap(zeros, params), "v": _tmap(zeros, params)}

    def update(grads, state, params, step, *, sq_norm=None):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, sq_norm)
        g32 = _tmap(lambda g: g.float(), grads)
        m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g32)
        v = _tmap(lambda v_, g: b2 * v_ + (1 - b2) * g.square(), state["v"],
                  g32)
        # bias corrections in fp32, as the JAX formulas compute them
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        mhat_scale = 1.0 / (1.0 - torch.pow(torch.tensor(b1), t))
        vhat_scale = 1.0 / (1.0 - torch.pow(torch.tensor(b2), t))
        lr_t = lr_fn(step)
        on_device = {}   # the corrections copied to each device once

        def upd(m_, v_, p):
            if p.device not in on_device:
                on_device[p.device] = (mhat_scale.to(p.device, copy=True),
                                       vhat_scale.to(p.device, copy=True))
            ms, vs = on_device[p.device]
            u = -lr_t * ((m_ * ms) / (torch.sqrt(v_ * vs) + eps)
                         + weight_decay * p.float())
            return u.to(p.dtype)

        return _tmap(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def sgd(lr: Union[float, Callable] = 0.1, momentum: float = 0.9,
        weight_decay: float = 0.0, nesterov: bool = False,
        max_grad_norm: Optional[float] = None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mom": _tmap(torch.zeros_like, params)}

    def update(grads, state, params, step, *, sq_norm=None):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, sq_norm)
        g = (_tmap(lambda g_, p: g_ + weight_decay * p, grads, params)
             if weight_decay else grads)
        mom = _tmap(lambda m_, g_: momentum * m_ + g_, state["mom"], g)
        eff = (_tmap(lambda m_, g_: g_ + momentum * m_, mom, g) if nesterov
               else mom)
        lr_t = lr_fn(step)
        return _tmap(lambda e: -lr_t * e, eff), {"mom": mom}

    return Optimizer(init, update)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _tmap(lambda p, u: p + u.to(p.dtype), params, updates)
