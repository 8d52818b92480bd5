"""Activation sharding over "model": the tensor-parallel (TP) context of the
LM train step. Port of repro.parallel.act_sharding.

The JAX package pins the TP dims of a few activations and lets GSPMD pick
column- and row-parallel products around them:

    FFN hidden        [..., d_ff]      -> d_ff over "model"
    q / k / v         [B, S, H, hd]    -> heads over "model"
    logits            [B, S, V_padded] -> vocab over "model"
    MoE expert hidden [E, C, d_e]      -> experts over "model" (EP) when E
                                          divides the axis, else d_e

Eager PyTorch has no compiler to do that, so the port's layers make the
collectives themselves (Megatron's column / row pairs, models/lm/): they
ask `splits(dim)` whether a dim is split over "model", and it applies
shard_act's guards. The context (`tp_context`), entered by the train step
(launch/steps.make_fsdp_train_step), holds the mesh's axis sizes, the
"model" group and this rank's index in it; outside it every layer runs
whole, as the serving paths and the one-process step do.

Sequence parallelism (the JAX package's `_seq_shard`: the residual stream
[B, S, d] seq-sharded over "model" between the train layers, under
cfg.seq_sharding) is the context's `seq`: the train step sets it where
`splits(S)` holds, and the layers then carry the residual as this rank's
block of the sequence, entering a tensor-parallel region by an all-gather
along S and leaving it by a reduce-scatter (Megatron-SP; models/lm/layers
`tp_in` / `tp_out`).

`shard_act` keeps the JAX function's signature and guards and returns x
untouched: eager PyTorch places no constraint.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

Tensor = torch.Tensor
U = "unconstrained"   # the JAX package's P.UNCONSTRAINED


class TPContext(NamedTuple):
    sizes: Dict[str, int]   # the mesh's axis sizes
    group: object           # the "model" process group
    rank: int               # this rank's index in it
    seq: bool = False       # the residual stream is this rank's S block


_CTX: Optional[TPContext] = None


@contextlib.contextmanager
def tp_context(sizes: Dict[str, int], group, rank: int, seq: bool = False):
    """Run the LM's train layers tensor-parallel over `group` (the "model"
    group of a mesh with axis sizes `sizes`; this rank is its `rank`-th),
    sequence-parallel too where `seq`."""
    global _CTX
    prev, _CTX = _CTX, TPContext(dict(sizes), group, rank, seq)
    try:
        yield _CTX
    finally:
        _CTX = prev


def current() -> Optional[TPContext]:
    return _CTX


def current_axis_sizes() -> Dict[str, int]:
    """Axis sizes of the context ({} outside it)."""
    return dict(_CTX.sizes) if _CTX is not None else {}


def _fits(dim: int, names, sizes: Dict[str, int]) -> bool:
    total = 1
    for n in names:
        if n not in sizes:
            return False
        total *= sizes[n]
    return dim % total == 0


def shard_act(x: Tensor, *axes, enabled: bool = True) -> Tensor:
    """The JAX package's shard_act: `axes` (one entry a dim: U, None or an
    axis name or tuple of names) name the dims to pin; a named entry is
    dropped when its axis is missing from the context, its size is 1, or
    the dim does not divide it, and the call is a no-op outside a context
    or when disabled. Returns x itself: the layers make the split."""
    return x


def splits(dim: int, axis: str = "model", *,
           sizes: Optional[Dict[str, int]] = None,
           enabled: bool = True) -> bool:
    """Whether a layer splits a dim of this size over `axis`: the context
    (or `sizes`) has the axis and the dim divides it. Past size 1 this is
    shard_act's guard exactly; at size 1 it answers True (a group of one
    holds the whole dim, and the split form runs with its collectives over
    one rank), where shard_act drops the constraint as a no-op."""
    sizes = current_axis_sizes() if sizes is None else sizes
    return enabled and _fits(dim, (axis,), sizes)
