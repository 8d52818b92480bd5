"""Training loop for the CNN (paper) models.

Port of repro.train.loop: TrainConfig, cross_entropy, accuracy, the train
and eval steps, `train` and `evaluate`. The data contract is the JAX one
(batch = batch_fn(step, batch_size); held-out eval batches at steps
10_000_000 + i). Gradients come from torch autograd through the layers of
models/common.py, so with a CUDA device and kernel 'auto' every CADC layer
trains through the CUDA kernels (K3 / K1g forward, K2 backward). Params
are nested dicts; a step returns new ones and leaves its inputs as they
were. Checkpointing (`ckpt_dir`) comes with a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve
from repro_torch.models.common import Ctx, LayerMode
from repro_torch.train import optimizer as opt_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    batch_size: int = 64
    eval_every: int = 50
    eval_batches: int = 4
    ckpt_dir: Optional[str] = None   # a later slice; set -> NotImplementedError
    seed: int = 0
    # Kernel backend override for every weight-bearing layer: None keeps
    # the LayerMode's own setting; 'auto' | 'cuda' | 'torch' force it.
    kernel: Optional[str] = None
    # Gradient-residual override of the kernels: None keeps the
    # LayerMode's; 'auto' | 'packed' | 'bytes' | 'recompute' force it.
    save_gate: Optional[str] = None


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def accuracy(logits: Tensor, labels: Tensor) -> Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _flatten(tree) -> List[Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(tree)


def make_train_step(apply_fn: Callable, mode: LayerMode,
                    optimizer: opt_lib.Optimizer, *,
                    input_key: str = "image"):
    def train_step(params, model_state, opt_state, batch, step: int):
        flat = [p.detach().requires_grad_(True) for p in _flatten(params)]
        live = _unflatten(params, flat)
        logits, new_state = apply_fn(live, model_state, batch[input_key],
                                     Ctx(mode), train=True)
        loss = cross_entropy(logits, batch["label"])
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = _unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(flat, grads)])
        with torch.no_grad():
            plain = _unflatten(params, [p.detach() for p in flat])
            updates, opt_state = optimizer.update(grads, opt_state, plain,
                                                  step)
            params = opt_lib.apply_updates(plain, updates)
            metrics = {"loss": loss.detach(),
                       "acc": accuracy(logits.detach(), batch["label"])}
        return params, new_state, opt_state, metrics

    return train_step


def make_eval_step(apply_fn: Callable, mode: LayerMode, *,
                   input_key: str = "image"):
    @torch.no_grad()
    def eval_step(params, model_state, batch):
        logits, _ = apply_fn(params, model_state, batch[input_key],
                             Ctx(mode), train=False)
        return {"loss": cross_entropy(logits, batch["label"]),
                "acc": accuracy(logits, batch["label"])}

    return eval_step


def train(*, apply_fn: Callable,
          batch_fn: Callable[[int, int], Dict[str, Tensor]],
          init_fn: Optional[Callable] = None,
          initial: Optional[Tuple[Any, Any]] = None,
          mode: LayerMode = LayerMode(),
          optimizer: Optional[opt_lib.Optimizer] = None,
          cfg: TrainConfig = TrainConfig(), input_key: str = "image",
          eval_mode: Optional[LayerMode] = None,
          init_kwargs: Optional[Dict[str, Any]] = None,
          device="cuda") -> Dict[str, Any]:
    """Returns {'params', 'state', 'history', 'eval'}. Starts from
    `initial` = (params, model_state), or from init_fn(generator,
    device=..., **init_kwargs) with a generator seeded by cfg.seed on
    `device`."""
    if cfg.ckpt_dir:
        raise NotImplementedError("checkpointing (ckpt/) comes with a later "
                                  "slice of the port")
    optimizer = optimizer or opt_lib.adamw(1e-3)
    overrides = {k: v for k, v in (("kernel", cfg.kernel),
                                   ("save_gate", cfg.save_gate))
                 if v is not None}
    if overrides:
        mode = dataclasses.replace(mode, **overrides)
        if eval_mode is not None:
            eval_mode = dataclasses.replace(eval_mode, **overrides)
    if initial is None:
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        initial = init_fn(gen, device=dev, **(init_kwargs or {}))
    params, model_state = initial
    opt_state = optimizer.init(params)

    train_step = make_train_step(apply_fn, mode, optimizer,
                                 input_key=input_key)
    ev_mode = eval_mode or mode
    eval_step = make_eval_step(apply_fn, ev_mode, input_key=input_key)

    history: List[Dict[str, float]] = []
    for step in range(cfg.steps):
        batch = batch_fn(step, cfg.batch_size)
        params, model_state, opt_state, metrics = train_step(
            params, model_state, opt_state, batch, step)
        if step % cfg.eval_every == 0 or step == cfg.steps - 1:
            history.append({"step": step,
                            **{k: float(v) for k, v in metrics.items()}})

    ev = evaluate(apply_fn, params, model_state, batch_fn, ev_mode,
                  n_batches=cfg.eval_batches, batch_size=cfg.batch_size,
                  input_key=input_key, eval_step=eval_step)
    return {"params": params, "state": model_state, "history": history,
            "eval": ev}


def evaluate(apply_fn, params, model_state, batch_fn, mode, *,
             n_batches: int = 4, batch_size: int = 64,
             input_key: str = "image", eval_step=None) -> Dict[str, float]:
    eval_step = eval_step or make_eval_step(apply_fn, mode,
                                            input_key=input_key)
    accs, losses = [], []
    for i in range(n_batches):
        batch = batch_fn(10_000_000 + i, batch_size)  # held-out step range
        m = eval_step(params, model_state, batch)
        accs.append(float(m["acc"]))
        losses.append(float(m["loss"]))
    return {"acc": sum(accs) / len(accs), "loss": sum(losses) / len(losses)}
