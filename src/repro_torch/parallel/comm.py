"""The collectives the port's parallel paths make, over a process group.

all_gather / reduce_scatter along any tensor dim (rank r's block is the
r-th along it: DTensor's Shard(dim) layout), all_reduce (sum, max or
min; `all_reduce_coalesced`: many tensors in a few flat buckets), and the
differentiable forms the train step's layers use:

  * Megatron's conjugate pair around a tensor-parallel region:
    `copy_to` (identity forward, all-reduce backward) in front of a
    column-parallel layer, `reduce_from` (all-reduce forward, identity
    backward) after a row-parallel one;
  * its sequence-parallel form (Megatron-SP), where each rank holds its
    block of the input along a dim: `gather_to` (all-gather forward,
    reduce-scatter backward: the sum over ranks of each rank's gradient of
    the whole, cut to the rank's block) in front of the region,
    `reduce_scatter_from` (reduce-scatter forward, all-gather backward)
    after it; gather_to along dim 0 also gathers the rows an MoE block
    routes over;
  * `gather_from`: all-gather along a dim, backward this rank's block of
    the gradient (each rank holds the whole gradient already), and its
    conjugate `split_to`: this rank's block forward, the gradient
    all-gathered backward (every rank then holds the whole one).

Every collective goes through `all_gather` / `reduce_scatter` /
`all_reduce` here, which add its wire bytes per rank to the open
`record()` tallies, with the ring formulas of the JAX package's dry run
(`parse_collective_bytes`): all-gather result x (g-1)/g, all-reduce 2 x
result x (g-1)/g, reduce-scatter the scattered block x (g-1).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import work

Tensor = torch.Tensor

# torch 2.13 renamed the single-tensor collectives (the old names warn)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

KINDS = ("all-gather", "all-reduce", "reduce-scatter")
_TALLIES: List[Dict[str, float]] = []


@contextlib.contextmanager
def record():
    """Yield a {kind: wire bytes per rank} dict ("total" added on exit)
    that every collective made while it is open adds to (records nest:
    each open one counts)."""
    tally = {k: 0.0 for k in KINDS}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES[:] = [t for t in _TALLIES if t is not tally]
        tally["total"] = sum(tally[k] for k in KINDS)


def _count(kind: str, t: Tensor, world: int) -> None:
    if not _TALLIES:
        return
    size = t.numel() * t.element_size()
    size *= {"all-gather": (world - 1) / world,
             "all-reduce": 2 * (world - 1) / world,
             "reduce-scatter": world - 1}[kind]
    for tally in _TALLIES:
        tally[kind] += size


def all_gather(t: Tensor, dim: int, group=None) -> Tensor:
    """The ranks' blocks of `t` concatenated along `dim`, in rank order.
    The collective fills a [world, *block] buffer; the blocks are laid
    along `dim` by a view where dim is 0 or the group has one rank, else
    by one copy."""
    world = dist.get_world_size(group)
    src = t.contiguous()
    buf = src.new_empty((world, *src.shape))
    with work.quiet():  # gloo: the concat form
        _all_gather(buf.flatten(0, 1), src, group=group)
    _count("all-gather", buf, world)
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter(t: Tensor, dim: int, group=None) -> Tensor:
    """Rank r's block along `dim` of the sum of `t` over the ranks (the
    blocks are stacked into the collective's input by a view where dim is
    0 or the group has one rank, else by one copy)."""
    world = dist.get_world_size(group)
    src = t.unflatten(dim, (world, t.shape[dim] // world)).movedim(
        dim, 0).contiguous()
    out = src.new_empty(src.shape[1:])
    with work.quiet():
        _reduce_scatter(out, src.flatten(0, 1), group=group)
    _count("reduce-scatter", out, world)
    return out


def all_reduce(t: Tensor, group=None, op=dist.ReduceOp.SUM) -> Tensor:
    """t reduced over the group's ranks, in place; returns t."""
    with work.quiet():
        dist.all_reduce(t, op=op, group=group)
    _count("all-reduce", t, dist.get_world_size(group))
    return t


def all_reduce_coalesced(ts: List[Tensor], group=None,
                         bucket_bytes: int = 2 ** 28) -> None:
    """Each tensor of `ts` summed over the ranks, in place, by one
    all_reduce a bucket: the tensors of one dtype copied end to end into
    flat buckets of at most `bucket_bytes` and the sums copied back (a
    contiguous tensor alone in its bucket, as one larger than that is, is
    reduced where it lies); an elementwise sum, so each tensor ends as its
    own all_reduce would leave it. A tensor listed twice is summed once."""
    by_dtype: Dict[torch.dtype, List[Tensor]] = {}
    for t in {id(t): t for t in ts}.values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        buckets, size = [[]], 0
        for t in group_ts:
            n = t.numel() * t.element_size()
            if buckets[-1] and size + n > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += n
        for bucket in buckets:
            if len(bucket) == 1 and bucket[0].is_contiguous():
                all_reduce(bucket[0], group)     # alone: no copy
                continue
            flat = all_reduce(torch.cat([t.reshape(-1) for t in bucket]),
                              group)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view(t.shape))


def block(t: Tensor, dim: Optional[int], rank: int, world: int) -> Tensor:
    """Rank `rank`'s block of t along `dim` (a view; t where dim is
    None)."""
    if dim is None:
        return t
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n)


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def gather_to(x: Tensor, dim: int, group) -> Tensor:
    """The ranks' blocks of x along `dim`, whole; the gradient is this
    rank's block of the sum over the ranks of their gradients (in front of
    layers whose ranks each compute part of the output from the whole)."""
    return _GatherTo.apply(x, dim % x.ndim, group)


def reduce_scatter_from(x: Tensor, dim: int, group) -> Tensor:
    """This rank's block along `dim` of the sum of the ranks' x; the
    gradient is the ranks' blocks of it gathered (each rank's partial x
    gets the whole output's gradient)."""
    return _ReduceScatterFrom.apply(x, dim % x.ndim, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        grp = ctx.group
        return (block(g, ctx.dim, dist.get_rank(grp),
                      dist.get_world_size(grp)), None, None)


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block(x, dim, dist.get_rank(group), dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def copy_to(x: Tensor, group) -> Tensor:
    """x as is; its gradient is the sum of the ranks' gradients (in front
    of a layer whose ranks each compute part of the output)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: Tensor, group) -> Tensor:
    """The sum of the ranks' x; the gradient passes through unchanged (each
    rank's partial output gets the whole output's gradient)."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: Tensor, dim: int, group) -> Tensor:
    """The ranks' blocks of x along `dim`, whole; the gradient is this
    rank's block of the whole gradient (every rank holds the same one)."""
    return _GatherFrom.apply(x, dim % x.ndim, group)


def split_to(x: Tensor, dim: int, group) -> Tensor:
    """This rank's block of x along `dim` (x the same on every rank); the
    gradient is the ranks' blocks of it gathered, so each rank holds the
    whole gradient of x."""
    return _SplitTo.apply(x, dim % x.ndim, group)
