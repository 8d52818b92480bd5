"""Fully sharded storage over the "data" axis (ZeRO-3 style): each rank
holds its block of every parameter leaf along the dim the sharding rules
give "data" (parallel/sharding.py), whole copies of the leaves they leave
unsharded over "data"; the optimizer state inherits the layout. Rank r's
block is the r-th along that dim (DTensor's Shard(dim)); the rules'
divisibility guard makes the blocks equal. On a mesh with a "model" axis a
leaf is also cut along the dim the rules give "model" (`model_dims`,
`mesh_block`); "pod" holds whole copies.

Trees are the port's params: nested dicts and lists of tensors, flattened
in launch/steps._leaves order. The data-parallel train step
(launch/steps.make_fsdp_train_step) gathers the blocks for each micro and
reduce-scatters the gradients back onto them.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import comm
from repro_torch.parallel import sharding

Tensor = torch.Tensor


def _spec_leaves(specs):
    """The specs of a params or caches tree (dicts, lists and NamedTuples
    — a cache entry's fields —; a spec is a plain tuple)."""
    if isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    elif isinstance(specs, list) or hasattr(specs, "_fields"):
        for v in specs:
            yield from _spec_leaves(v)
    else:
        yield specs


def axis_dims(params_shape: Any, cfg: ArchConfig, mesh: Mesh,
              axis: str) -> List[Optional[int]]:
    """Each leaf's dim sharded over `axis` under `mesh` (None: a whole copy
    on every rank of that axis), in leaf order."""
    specs = sharding.param_specs(params_shape, cfg, mesh)
    return [sharding.data_dim(s, axis) for s in _spec_leaves(specs)]


def data_dims(params_shape: Any, cfg: ArchConfig,
              mesh: Mesh) -> List[Optional[int]]:
    """Each leaf's dim sharded over "data" under `mesh` (None: a whole copy
    on every rank), in leaf order."""
    return axis_dims(params_shape, cfg, mesh, "data")


def model_dims(params_shape: Any, cfg: ArchConfig,
               mesh: Mesh) -> List[Optional[int]]:
    """Each leaf's dim sharded over "model" under `mesh`, in leaf order."""
    return axis_dims(params_shape, cfg, mesh, "model")


def shard(t: Tensor, dim: Optional[int], rank: int, world: int) -> Tensor:
    """Rank `rank`'s block of t along `dim` (a new tensor; t itself where
    dim is None)."""
    if dim is None:
        return t
    return t.chunk(world, dim)[rank].clone()


def mesh_block(t: Tensor, data_dim: Optional[int],
               model_dim: Optional[int], coords, sizes) -> Tensor:
    """The block of t a rank at mesh coordinates `coords` (axis sizes
    `sizes`) stores: its "data" block, then its "model" block of that (a
    new tensor)."""
    t = shard(t, data_dim, coords["data"], sizes["data"])
    return shard(t, model_dim, coords["model"], sizes["model"])


def spec_block(t: Tensor, spec, coords, sizes) -> Tensor:
    """The block of t a rank at mesh coordinates `coords` stores under a
    sharding spec (sharding.P): a dim split over several axes takes their
    combined index, the first axis major (the data-parallel rank over
    ("pod", "data")). A new tensor where any dim is split."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = 0, 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            index = index * sizes.get(a, 1) + coords.get(a, 0)
            count *= sizes.get(a, 1)
        t = shard(t, dim, index, count)
    return t


def gather(t: Tensor, dim: Optional[int], group=None) -> Tensor:
    """The whole leaf from every rank's block (t itself where dim is
    None)."""
    return t if dim is None else comm.all_gather(t, dim, group)
