"""Per-architecture sharding rules (DP + FSDP + TP + EP). Port of
repro.parallel.sharding.

Name-based rules over the params tree. Scheme (single-pod ("data",
"model"); multi-pod prepends "pod" to the DP group):

  * column-parallel weights (QKV, up / gate projections): contraction dim
    FSDP-sharded over "data", output dim TP-sharded over "model";
  * row-parallel weights (O, down projections): contraction dim over
    "model" (the TP all-reduce), output dim FSDP over "data";
  * CADC segmented weights [S, xbar, N]: the SEGMENT axis takes the place
    of the contraction dim; the xbar axis is NEVER sharded — a crossbar
    never spans devices, so the dendritic f() needs no collective and only
    the (linear) cross-segment sum enters the TP all-reduce (tp_cadc.py);
  * MoE experts: EP (the expert axis over "model") when the expert count
    divides the model axis, else within-expert TP;
  * xLSTM blocks: FSDP / DP only (4 heads < the model axis);
  * the optimizer state inherits the parameter sharding.

A spec is a tuple with one entry a tensor dim: None (not sharded), an axis
name, or a tuple of axis names (the dim split over several mesh axes, in
the mesh's order) — the JAX PartitionSpec's entries, in its order.
`placements` maps a spec onto a DeviceMesh's dims as DTensor placements.

The port keeps its layers as a list ({"layers": [...]},
models/lm/transformer.py), where the JAX package stacks each pattern
position's layers under "units" (a leading scan axis) and keeps the rest
under "tail". The rules see a layer's own shape either way, so the spec of
the port's layer r * len(pattern) + j is the JAX spec of units[j] without
its leading None (JAX: P(None, *spec)), and a tail layer's is the same in
both; a cache entry maps the same way.

Elasticity: the rules are pure functions of (path, shape, mesh) — a
checkpoint saved under one mesh restores under any other by running them
again (launch/train.py).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import Mesh

Spec = Tuple[Any, ...]

# key names -> role
_COLUMN = {"wq", "wk", "wv", "w_up", "w_gate", "w_up_gate", "w_x", "w_if",
           "w_gates", "w_q", "w_k", "w_v", "w_r", "w_i"}
_ROW = {"wo", "w_down", "w_out"}
_EXPERT = {"w_gate", "w_up", "w_down"}  # when under a "moe" subtree


def P(*entries) -> Spec:
    """A spec, written as the JAX package writes PartitionSpecs (which
    hold a one-axis tuple as that axis's name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _map_with_path(fn, tree, path=()):
    """fn(names, leaf) over nested dicts, lists, tuples and NamedTuples;
    names are dict keys, "[i]" for a sequence item and the field name of a
    NamedTuple (KVCache .k / .v, the recurrent states)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _spec_for(names: Tuple[str, ...], ndim: int, cfg: ArchConfig,
              dp: Tuple[str, ...], in_xlstm_block: bool,
              model_size: int) -> Spec:
    leaf = names[-1]
    # linear_init nests weights as {"wq": {"w": ...}}: the ROLE lives one
    # level up
    if leaf == "w" and len(names) >= 2:
        leaf = names[-2]
    under_moe = "moe" in names
    fsdp = dp[-1]  # "data"

    if leaf == "table":  # embedding [V, d] — V is cfg.padded_vocab
        return P("model", None)
    if leaf in ("lam", "scale", "b"):
        return P(None)
    if leaf in ("router", "shared_gate"):
        return P(None, None)
    if leaf == "r_gates":  # sLSTM [4, H, dh, dh] — small, replicate
        return P(*([None] * ndim))

    if under_moe and leaf in _EXPERT and ndim >= 3:
        ep_ok = cfg.moe.n_experts % model_size == 0
        is_down = leaf == "w_down"
        if ndim == 3:   # [E, d_in, d_out]
            if ep_ok:
                return P("model", fsdp, None)
            return P(None, "model", fsdp) if is_down else P(None, fsdp, "model")
        # CADC segmented [E, S, xbar, d_out]: crossbars never span devices
        if ep_ok:
            return P("model", fsdp, None, None)
        return (P(None, "model", None, fsdp) if is_down
                else P(None, fsdp, None, "model"))

    if in_xlstm_block:
        if leaf == "conv" or "conv" in names:
            # depthwise causal conv1d [width, d_inner]: shard channels only
            return P(None, fsdp)
        if ndim == 2:
            return P(fsdp, None)
        if ndim == 3:  # CADC segmented
            return P(fsdp, None, None)
        return P(*([None] * ndim))

    if leaf in _COLUMN:
        if ndim == 2:   # [d_in, d_out]
            return P(fsdp, "model")
        if ndim == 3:   # CADC [S, xbar, d_out]
            return P(fsdp, None, "model")
    if leaf in _ROW:
        if ndim == 2:
            return P("model", fsdp)
        if ndim == 3:   # CADC [S, xbar, d_out]: segments over model
            return P("model", None, fsdp)
    if ndim == 2 and "conv" in names:
        return P(None, "model")  # depthwise conv over TP-sharded channels

    if "head" in names:
        if ndim == 2:
            return P(fsdp, "model")
        if ndim == 3:
            return P(fsdp, None, "model")
    return P(*([None] * ndim))


def _guard_divisible(spec: Spec, shape, sizes: Dict[str, int]) -> Spec:
    """Elasticity guard: drop any sharded dim the tensor doesn't divide
    (odd segment counts, tiny widths), replicating that dim instead."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        total = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            total *= sizes.get(a, 1)
        out.append(entry if shape[i] % total == 0 else None)
    return P(*out)


def param_specs(params_shape: Any, cfg: ArchConfig, mesh: Mesh) -> Any:
    """The spec tree matching `params_shape` (the port's params, or
    abstract ones on the meta device: anything with .shape and .ndim)."""
    dp = mesh_lib.data_axes(mesh)
    sizes = mesh_lib.axis_sizes(mesh)
    model_size = sizes.get("model", 1)

    def rule(names, leaf):
        spec = _spec_for(names, leaf.ndim, cfg, dp, "block" in names,
                         model_size)
        return _guard_divisible(spec, leaf.shape, sizes)

    return _map_with_path(rule, params_shape)


def batch_specs(cfg: ArchConfig, mesh: Mesh, kind: str) -> Dict[str, Spec]:
    dp = mesh_lib.data_axes(mesh)
    if cfg.frontend == "audio":
        specs = {"frames": P(dp, None, None)}
    else:
        specs = {"tokens": P(dp, None)}
        if cfg.frontend == "vit":
            specs["patches"] = P(dp, None, None)
    if kind == "train":
        specs["labels"] = P(dp, None)
    return specs


def activation_spec(cfg: ArchConfig, mesh: Mesh) -> Spec:
    return P(mesh_lib.data_axes(mesh), None, None)


def _dp_size(mesh: Mesh) -> int:
    n = 1
    for a in mesh_lib.data_axes(mesh):
        n *= mesh_lib.axis_size(mesh, a)
    return n


def cache_specs(cache_shape: Any, cfg: ArchConfig, mesh: Mesh,
                batch: int) -> Any:
    """Dense caches: batch over DP when divisible; kv-heads over "model"
    when divisible, else the cache LENGTH dim over "model" (length-parallel
    attention, the fallback for GQA archs whose kv-head count is below the
    TP degree). Recurrent states follow batch."""
    dp = mesh_lib.data_axes(mesh)
    dp_size = _dp_size(mesh)
    model = mesh_lib.axis_size(mesh, "model")
    b_ax = dp if batch % dp_size == 0 and batch >= dp_size else None
    h_ax = "model" if cfg.n_kv_heads % model == 0 else None

    def rule(names, leaf):
        nd = leaf.ndim
        if names[-1] in ("k", "v") and nd == 4:      # [B, L, K, hd]
            l_ax = ("model" if h_ax is None and leaf.shape[1] % model == 0
                    else None)
            return P(b_ax, l_ax, h_ax, None)
        if nd >= 1:
            return P(b_ax, *([None] * (nd - 1)))     # recurrent [B, ...]
        return P()

    return _map_with_path(rule, cache_shape)


def paged_cache_specs(cache_shape: Any, cfg: ArchConfig, mesh: Mesh) -> Any:
    """The serve engine's paged caches. KV pools [n_blocks, block_size, K,
    hd]: kv-heads over "model" when divisible; the BLOCK axis stays
    unsharded (any slot's table row must name any physical block), and
    pools replicate when kv-heads don't divide the axis. Recurrent state
    rows [n_slots, ...] follow the dense rule: slots over the DP axes when
    divisible."""
    dp = mesh_lib.data_axes(mesh)
    dp_size = _dp_size(mesh)
    model = mesh_lib.axis_size(mesh, "model")
    h_ax = "model" if cfg.n_kv_heads % model == 0 else None

    def rule(names, leaf):
        nd = leaf.ndim
        if names[-1] in ("k", "v") and nd == 4:  # [n_blocks, bs, K, hd]
            return P(None, None, h_ax, None)
        if nd >= 1:                              # recurrent rows [n_slots..]
            n_slots = leaf.shape[0]
            b_ax = (dp if n_slots % dp_size == 0 and n_slots >= dp_size
                    else None)
            return P(b_ax, *([None] * (nd - 1)))
        return P()

    return _map_with_path(rule, cache_shape)


def block_table_specs(tables: Any, cfg: ArchConfig, mesh: Mesh) -> Any:
    """Block tables [n_slots, nb] are replicated: the paged-attention
    kernel reads a slot's whole table row, and under the head-parallel
    pool layout every shard holds all blocks."""
    del cfg, mesh
    return _map_with_path(lambda names, t: P(None, None), tables)


def placements(spec: Spec, mesh: Mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`'s dims: Shard(i) on a mesh
    dim whose axis shards tensor dim i (a tuple of axes shards dim i over
    each of them, in the mesh's order), Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def data_dim(spec: Spec, axis: str = "data"):
    """The tensor dim `axis` shards in `spec`, or None."""
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None
