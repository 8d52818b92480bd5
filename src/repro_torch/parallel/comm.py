"""The collectives the port's parallel paths make, over a process group.

all_gather / reduce_scatter along any tensor dim (rank r's block is the
r-th along it: DTensor's Shard(dim) layout), and `gather_rows`, an
all-gather along dim 0 whose backward is the reduce-scatter of the
gradient (the sum over ranks of each rank's gradient of its rows).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# torch 2.13 renamed the single-tensor collectives (the old names warn)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather(t: Tensor, dim: int, group=None) -> Tensor:
    """The ranks' blocks of `t` concatenated along `dim`, in rank order.
    The collective fills a [world, *block] buffer; the blocks are laid
    along `dim` by a view where dim is 0 or the group has one rank, else
    by one copy."""
    world = dist.get_world_size(group)
    src = t.contiguous()
    buf = src.new_empty((world, *src.shape))
    _all_gather(buf.flatten(0, 1), src, group=group)  # gloo: the concat form
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter(t: Tensor, dim: int, group=None) -> Tensor:
    """Rank r's block along `dim` of the sum of `t` over the ranks (the
    blocks are stacked into the collective's input by a view where dim is
    0 or the group has one rank, else by one copy)."""
    world = dist.get_world_size(group)
    src = t.unflatten(dim, (world, t.shape[dim] // world)).movedim(
        dim, 0).contiguous()
    out = src.new_empty(src.shape[1:])
    _reduce_scatter(out, src.flatten(0, 1), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, 0, ctx.group), None


def gather_rows(x: Tensor, group=None) -> Tensor:
    """Every rank's x [b, ...] stacked along dim 0 ([world * b, ...]),
    differentiable: the backward hands each rank the sum over ranks of the
    gradient of its own rows."""
    return _GatherRows.apply(x, group)
