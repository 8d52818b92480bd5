"""The LM stack: embedding -> pattern-cycled blocks -> norm -> head.

Port of repro.models.lm.transformer: the attention layer kinds ('global',
'local', each with a dense FFN or an MoE block), the RG-LRU kind ('rglru',
a recurrent block and an FFN) and the xLSTM kinds ('mlstm', 'slstm', a
block with no FFN); tied or untied heads, the ViT patch prefix and the
audio frontend (an encoder's frames through frontend_proj). An unknown
kind raises as the JAX package's _layer_init does. Serving and training
(`forward_train`, `lm_loss`) run every kind. The JAX
package stacks each pattern position's parameters over the unit repeats
and runs them as one lax.scan; here the stack is a Python list of layers,
layer i having kind cfg.pattern_for_layers[i], and the scan is a loop.

Parameters: {"embed": {"table"}, "final_norm": {"scale"}, "head": {"w"}
(untied heads), "frontend_proj": {"w", "b"} (vit, audio), "layers": [...]} with
one dict a layer, the JAX names: an attention layer {"ln1", "attn": {"wq",
"wk", "wv", "wo"} (+ "b" with qkv bias), "ln2", "ffn": {"w_gate", "w_up",
"w_down"} ({"w_up", "w_down"} with biases for gelu) or "moe": {...}};
an rglru layer {"ln1", "rec": {"w_x",
"w_gate", "conv": {"w", "b"}, "w_r", "w_i", "lam", "w_out"}, "ln2",
"ffn"}; an xLSTM layer {"block": {...}} (xlstm.py). `params_from_numpy`
takes the JAX package's `tf.init` pytree (as numpy arrays) and returns
this layout; `params_to_numpy` is its inverse.

Caches: a list with one entry per layer. Attention layers hold
attention.KVCache rings (dense) or attention.PagedKV pools (paged),
written in place; recurrent layers hold their per-slot state
(rglru.RGLRUState, xlstm.MLSTMState / SLSTMState: batch == the slots), the
same in both layouts, and a step replaces the list entry with the new
state. `decode_step_spec` is the speculative verify step: Q tokens a slot
in one multi-token paged append on attention layers; recurrent layers run
the one-token cell Q times and leave their per-token states stacked
[Q, ...] in the list for the caller to select (serve.backends).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_lib
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import rglru as rglru_lib
from repro_torch.models.lm import xlstm as xlstm_lib
from repro_torch.parallel import act_sharding
from repro_torch.parallel import comm

Tensor = torch.Tensor
Params = Dict[str, Any]
ATTN_KINDS = ("global", "local")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def layout(cfg: ArchConfig) -> Tuple[str, ...]:
    """Kind of every layer, in stack order. Refuses an unknown kind, as the
    JAX package's _layer_init does."""
    kinds = cfg.pattern_for_layers
    for kind in kinds:
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
    return kinds


def _layer_init(gen: torch.Generator, kind: str, cfg: ArchConfig,
                device: torch.device) -> Params:
    if kind in ATTN_KINDS:
        p = {
            "ln1": ll.rmsnorm_init(cfg.d_model, device),
            "attn": attn.attn_init(gen, cfg, device),
            "ln2": ll.rmsnorm_init(cfg.d_model, device),
        }
        if cfg.moe.n_experts > 0:
            p["moe"] = moe_lib.moe_init(gen, cfg, device)
        elif cfg.ffn_type != "none":
            p["ffn"] = ffn_lib.ffn_init(gen, cfg, device)
        return p
    if kind == "mlstm":
        return {"block": xlstm_lib.mlstm_init(gen, cfg, device)}
    if kind == "slstm":
        return {"block": xlstm_lib.slstm_init(gen, cfg, device)}
    if kind == "rglru":
        return {
            "ln1": ll.rmsnorm_init(cfg.d_model, device),
            "rec": rglru_lib.rglru_init(gen, cfg, device),
            "ln2": ll.rmsnorm_init(cfg.d_model, device),
            "ffn": ffn_lib.ffn_init(gen, cfg, device),
        }
    raise ValueError(f"unknown layer kind {kind!r}")


def init(cfg: ArchConfig, *, seed: int = 0,
         device=device_lib.DEFAULT_DEVICE,
         dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters from a seeded torch.Generator on `device`: fp32,
    or cast to `dtype` leaf group by leaf group as they are drawn (the
    same draws in the same order, so init(dtype=d) is bitwise
    cast_params(init(), d), without holding the whole fp32 model). The JAX
    package's jax.random draws cannot be reproduced here; parity tests
    load JAX-initialised parameters with params_from_numpy. On the "meta"
    device the tree has the shapes and dtypes and no storage
    (launch/steps.abstract_params)."""
    dev = device_lib.resolve(device)
    kinds = layout(cfg)
    # a meta tensor draws nothing; torch has no meta Generator
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)

    def cast(tree):
        return tree if dtype is None else cast_params(tree, dtype)

    params: Params = {
        "embed": cast(ll.embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                        dev)),
        "final_norm": cast(ll.rmsnorm_init(cfg.d_model, dev)),
    }
    if not cfg.tie_embeddings:
        params["head"] = cast(ll.linear_init(gen, cfg.d_model,
                                             cfg.padded_vocab, cfg, dev))
    if cfg.frontend is not None:
        params["frontend_proj"] = cast(ll.linear_init(
            gen, cfg.frontend_dim, cfg.d_model, cfg, dev, bias=True))
    params["layers"] = [cast(_layer_init(gen, kind, cfg, dev))
                        for kind in kinds]
    return params


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Params, cfg: ArchConfig,
                      device=device_lib.DEFAULT_DEVICE) -> Params:
    """The JAX package's `tf.init(key, cfg)` pytree, as numpy arrays, in the
    port's layout. units[j] is stacked over the reps of the pattern: its
    row r becomes layer r * len(pattern) + j; tail[i] becomes layer
    reps * len(pattern) + i (an MoE layer's expert banks slice the same
    way, [reps, E, S, xbar, N] rows to [E, S, xbar, N]). Segmented weights
    stay [S, xbar, d_out]; "head", "frontend_proj", every bias "b" and the
    recurrent layers' raw leaves ("lam", "conv" {"w", "b"}, "r_gates") are
    carried over where the pytree has them."""
    dev = device_lib.resolve(device)
    kinds = layout(cfg)
    p = len(cfg.pattern)
    units, tail = tree.get("units", ()), tree["tail"]
    reps = (len(kinds) - len(tail)) // p
    if units and reps * p + len(tail) != len(kinds):
        raise ValueError("pytree layout does not match cfg.n_layers")
    layers: List[Any] = []
    for r in range(reps):
        for j in range(p):
            layers.append(tree_map(lambda a, r=r: a[r], units[j]))
    layers.extend(tail)
    to_t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    out = {k: tree_map(to_t, tree[k])
           for k in ("embed", "final_norm", "head", "frontend_proj")
           if k in tree}
    out["layers"] = [tree_map(to_t, layer) for layer in layers]
    return out


def params_to_numpy(params: Params, cfg: ArchConfig) -> Params:
    """The inverse of params_from_numpy: the port's parameters as the JAX
    package's `tf.init` pytree of numpy arrays — units[j] layer
    r * len(pattern) + j stacked over the reps r (a tuple over the pattern
    positions), tail a tuple of the remaining layers. Bitwise: stacking
    copies the values. Checkpoints of this tree are the JAX package's."""
    kinds = layout(cfg)
    p = len(cfg.pattern)
    reps = len(kinds) // p if cfg.scan_layers else 0
    layers = [tree_map(lambda t: t.detach().cpu().numpy(), layer)
              for layer in params["layers"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    out = {k: tree_map(lambda t: t.detach().cpu().numpy(), params[k])
           for k in ("embed", "final_norm", "head", "frontend_proj")
           if k in params}
    if reps > 0:
        out["units"] = tuple(stack(*layers[j:reps * p:p]) for j in range(p))
    out["tail"] = tuple(layers[reps * p:])
    return out


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating parameters cast to `dtype` (integers untouched)."""
    return tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_residual(p: Params, x: Tensor, cfg: ArchConfig, attn_fn,
                   token_group=None):
    """ln1 -> attn_fn -> residual -> ln2 -> moe / ffn -> residual, shared
    by the train, dense decode, paged decode and prefill paths (one
    implementation, so the paged == dense invariant cannot drift).
    attn_fn(h) -> (y, extra). Returns (x, extra, the MoE aux loss: None
    without MoE; the serving paths drop it). token_group: moe_apply's."""
    h = ll.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, extra = attn_fn(h)
    x = x + y
    h = ll.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    aux = None
    if cfg.moe.n_experts > 0:
        # on the gathered sequence under sequence parallelism: the routing,
        # the capacity and the aux loss read the whole micro on every rank
        y, aux = ll.whole_seq(lambda h: moe_lib.moe_apply(
            p["moe"], h, cfg, token_group), h)
        x = x + y
    elif cfg.ffn_type != "none":
        x = x + ffn_lib.ffn_apply(p["ffn"], h, cfg)
    return x, extra, aux


def _recurrent_layer(p: Params, x: Tensor, kind: str, cfg: ArchConfig,
                     state) -> Tuple[Tensor, Any]:
    """One token through a recurrent layer: x [B, 1, d] -> (x, new state).
    xLSTM: the block plus a residual; rglru: pre-norm RG-LRU plus a
    residual, then pre-norm FFN plus a residual. The one form of the
    decode, verify and prefill paths."""
    if kind == "mlstm":
        y, state = xlstm_lib.mlstm_decode(p["block"], x, cfg, state)
        return x + y, state
    if kind == "slstm":
        y, state = xlstm_lib.slstm_decode(p["block"], x, cfg, state)
        return x + y, state
    h = ll.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, state = rglru_lib.rglru_decode(p["rec"], h, cfg, state)
    x = x + y
    h = ll.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + ffn_lib.ffn_apply(p["ffn"], h, cfg), state


def _recurrent_decode_multi(p: Params, x: Tensor, kind: str,
                            cfg: ArchConfig, state) -> Tuple[Tensor, Any]:
    """A Q-token append on a recurrent layer (the speculative verify step):
    the one-token cell run Q times, each at the [B, 1, d] shape of a decode
    step, so its outputs and states are bitwise Q sequential steps (the
    Q tokens are not batched: a GEMM's rows can depend on its row count).
    Returns (x [B, Q, d], every token's state stacked [Q, ...]): state
    folds each token in irreversibly, so the caller rolls a slot back to
    the state of its last accepted token."""
    ys, states = [], []
    for t in range(x.shape[1]):
        y, state = _recurrent_layer(p, x[:, t:t + 1].contiguous(), kind,
                                    cfg, state)
        ys.append(y)
        states.append(state)
    return torch.cat(ys, dim=1), type(state)(
        *(torch.stack(leaves) for leaves in zip(*states)))


def _head(params: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = ll.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return ll.lm_head(params.get("head"), params["embed"], x, cfg)


def _embed_inputs(params: Params, batch: Dict[str, Tensor],
                  cfg: ArchConfig) -> Tensor:
    """Token embeddings; for vit archs the projected patches
    batch["patches"] [B, frontend_len, frontend_dim] overlay the first
    frontend_len positions (those positions are the image); for the audio
    frontend the projected frames batch["frames"] [B, S, frontend_dim]
    are the whole input. Under sequence parallelism the result is this
    rank's block of the sequence: the frames and the patches are projected
    whole, then cut (layers.split_seq)."""
    if cfg.frontend == "audio":
        return ll.split_seq(ll.linear_apply(params["frontend_proj"],
                                            batch["frames"], cfg))
    x = ll.embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vit":
        patches = ll.linear_apply(params["frontend_proj"], batch["patches"],
                                  cfg).to(x.dtype)
        n = patches.shape[1]
        if not ll.seq_split():
            return torch.cat([patches, x[:, n:]], dim=1)
        s = batch["tokens"].shape[1]
        whole = ll.split_seq(torch.nn.functional.pad(patches,
                                                     (0, 0, 0, s - n)))
        ctx = act_sharding.current()
        lo = ctx.rank * x.shape[1]
        pos = torch.arange(lo, lo + x.shape[1], device=x.device)
        x = torch.where((pos < n)[None, :, None], whole, x)
    return x


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------

def _layer_train(p: Params, x: Tensor, kind: str, cfg: ArchConfig,
                 positions: Tensor, token_group=None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """One layer over the whole sequence: (x, the MoE aux loss or None).
    An attention layer: _attn_residual; an mLSTM or sLSTM block: a bare
    residual; an rglru layer: pre-norm RG-LRU plus a residual, then
    pre-norm FFN plus a residual. Under sequence parallelism x is this
    rank's block of the sequence (the JAX package's _seq_shard) and so is
    the result; the norms run on the block, the xLSTM blocks on the
    gathered sequence (layers.whole_seq)."""
    if kind == "mlstm":
        return x + ll.whole_seq(lambda h: xlstm_lib.mlstm_apply(
            p["block"], h, cfg), x), None
    if kind == "slstm":
        return x + ll.whole_seq(lambda h: xlstm_lib.slstm_apply(
            p["block"], h, cfg), x), None
    if kind == "rglru":
        h = ll.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
        x = x + rglru_lib.rglru_apply(p["rec"], h, cfg)
        h = ll.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        return x + ffn_lib.ffn_apply(p["ffn"], h, cfg), None
    x, _, aux = _attn_residual(p, x, cfg, lambda h: (attn.attention_train(
        p["attn"], h, cfg, kind=kind, positions=positions), None),
        token_group)
    return x, aux


def tp_leaf_modes(params_shape: Params, cfg: ArchConfig,
                  sizes: Dict[str, int], seq: bool = False
                  ) -> List[Tuple[str, Optional[int]]]:
    """How forward_train's layers use each leaf under the TP context of a
    mesh with axis sizes `sizes`, in leaf order (the train step's plan),
    as (mode, dim):

      ("split", dim) — the rank's block along `dim` over "model" (column-,
                  row-, vocab- or expert-parallel): its gradient is the
                  block's, whole;
      ("partial", None) — the whole leaf, of which the rank uses a part (a
                  column-parallel layer's bias, the kv weights the q heads
                  of a rank read): its gradient is summed over "model";
      ("full", None) — the whole leaf in a part of the model every rank
                  runs alike (norms, routers, xLSTM blocks, the
                  fallbacks): its gradient is the same on every rank.

    The RG-LRU block, where channels_split holds, splits w_gate, w_x, w_r,
    w_i and the conv's w along their channels and w_out along its input
    rows (or reads it whole: a fallback), lam and the biases partial.

    `seq`: the plan under sequence parallelism (the residual stream each
    rank's block of the sequence). The leaves applied to the rank's block
    alone then get a part of their gradient and become partial: the
    norms ln1, ln2 and final_norm, and a tensor-parallel block's whole
    row-parallel leaves (a fallback's weight, w_down's bias). The parts
    every rank computes alike on the gathered sequence
    (layers.whole_seq: the xLSTM blocks, a replicated attention, FFN or
    RG-LRU, the MoE block) and the vocab ends keep their modes.

    The predicates are the layers' own (layers.vocab_split,
    attention.heads_split / kv_split / wo_local, ffn.hidden_split /
    down_local, moe.tp_mode / down_local, rglru.channels_split /
    out_local)."""
    t = sizes.get("model", 1)
    vocab = ll.vocab_split(cfg, sizes)
    heads = attn.heads_split(cfg, sizes)
    kv = attn.kv_split(cfg, sizes)
    moe_mode = moe_lib.tp_mode(cfg, sizes)
    rec = rglru_lib.channels_split(cfg, sizes)
    hidden = ffn_lib.hidden_split(cfg, cfg.d_ff, sizes)
    full, partial = ("full", None), ("partial", None)

    def ffn_mode(role, leaf, d_ff, ndim):
        if not ffn_lib.hidden_split(cfg, d_ff, sizes):
            return full
        if role == "w_down":
            return (("split", 0) if leaf == "w"
                    and ffn_lib.down_local(cfg, d_ff, t) else full)
        return ("split", ndim - 1) if leaf == "w" else partial

    def mode(names, ndim):
        leaf = names[-1]
        role = names[-2] if leaf in ("w", "b") and len(names) > 1 else leaf
        if names[0] in ("embed", "head"):
            return (("split", 0 if names[0] == "embed" else ndim - 1)
                    if vocab else full)
        if names[0] != "layers" or len(names) < 4:
            return full
        sub = names[2]
        if sub == "attn" and heads:
            if role == "wo":
                return (("split", 0) if leaf == "w"
                        and attn.wo_local(cfg, t) else full)
            if leaf == "b":
                return partial
            return ("split", ndim - 1) if role == "wq" or kv else partial
        if sub == "rec" and rec:
            if role == "w_out":
                return (("split", 0) if leaf == "w"
                        and rglru_lib.out_local(cfg, t) else full)
            if role == "lam" or leaf == "b":
                return partial
            return ("split", ndim - 1)    # w_gate, w_x, w_r, w_i, conv w
        if sub == "ffn":
            return ffn_mode(role, leaf, cfg.d_ff, ndim)
        if sub == "moe" and names[3] == "shared":
            return ffn_mode(role, leaf, cfg.moe.d_shared, ndim)
        if sub == "moe" and role in ("w_gate", "w_up", "w_down"):
            if moe_mode == "ep":
                return ("split", 0)
            if moe_mode == "etp":
                if role != "w_down":
                    return ("split", ndim - 1)
                return ("split", 1) if moe_lib.down_local(cfg, t) else full
        return full

    def stream(names):
        """Whether the leaf is applied to the rank's S block alone under
        sequence parallelism."""
        if names[0] == "final_norm":
            return True
        if names[0] != "layers":
            return False
        if names[2] in ("ln1", "ln2"):
            return True
        row = {"attn": ("wo", heads), "ffn": ("w_down", hidden),
               "rec": ("w_out", rec)}.get(names[2])
        return row is not None and names[3] == row[0] and row[1]

    modes = []
    for names, leaf in _leaf_paths(params_shape):
        m = mode(names, leaf.ndim)
        modes.append(partial if seq and m == full and stream(names) else m)
    return modes


def _leaf_paths(tree, names: Tuple[str, ...] = ()):
    """(names, leaf) of nested dicts, lists and tuples, in leaf order: the
    dict keys, "[i]" for a sequence item."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, names + (f"[{i}]",))
    else:
        yield names, tree


def serve_leaf_modes(params_shape: Params, cfg: ArchConfig,
                     sizes: Dict[str, int]) -> List[Tuple[str, Optional[int]]]:
    """How the mesh decode step's layers use each leaf (the serve step's
    plan, tp_leaf_modes' (mode, dim) pairs in leaf order): the train plan,
    but the attention leaves follow the form the cache rule gives the
    decode (attention.decode_form), which the kv heads decide, and the
    RG-LRU block is read whole (the decode runs it whole: the cache rule
    does not split its state over "model"). Where they
    divide "model" the form is head-parallel and the train plan's
    attention entries hold (the kv heads split too). Otherwise every rank
    computes every head (length-parallel or replicated) and reads the
    attention leaves whole. gemma3-1b at model 2: its 4 q heads divide, so
    the train step splits wq, but its one kv head does not, so the cache
    splits the ring length and the decode reads wq, wk, wv and wo whole."""
    # the head-parallel form does not depend on the ring's length
    heads = attn.decode_form(cfg, 0, sizes.get("model", 1)) \
        == "head-parallel"
    train = tp_leaf_modes(params_shape, cfg, sizes)
    return [("full", None) if names[0] == "layers"
            and (names[2] == "rec" or names[2] == "attn" and not heads)
            else m
            for (names, _), m in zip(_leaf_paths(params_shape), train)]


def tp_fallbacks(cfg: ArchConfig, sizes: Dict[str, int]) -> List[str]:
    """The row-parallel linears of `cfg` that run whole on the gathered
    activation under a "model" axis of sizes["model"] ranks (their
    producer is split, but a rank's block of their inputs is not whole
    segments)."""
    t = sizes.get("model", 1)
    kinds = set(layout(cfg))
    out = []
    if kinds & set(ATTN_KINDS) and attn.heads_split(cfg, sizes) \
            and not attn.wo_local(cfg, t):
        out.append("attn.wo")
    ffn_kinds = ({"rglru"} if cfg.moe.n_experts else
                 {"rglru"} | set(ATTN_KINDS))
    if cfg.ffn_type != "none" and kinds & ffn_kinds \
            and ffn_lib.hidden_split(cfg, cfg.d_ff, sizes) \
            and not ffn_lib.down_local(cfg, cfg.d_ff, t):
        out.append("ffn.w_down")
    if "rglru" in kinds and rglru_lib.channels_split(cfg, sizes) \
            and not rglru_lib.out_local(cfg, t):
        out.append("rglru.w_out")
    if cfg.moe.n_experts and kinds & set(ATTN_KINDS):
        if (moe_lib.tp_mode(cfg, sizes) == "etp"
                and not moe_lib.down_local(cfg, t)):
            out.append("moe.w_down")
        m = cfg.moe
        if m.n_shared and ffn_lib.hidden_split(cfg, m.d_shared, sizes) \
                and not ffn_lib.down_local(cfg, m.d_shared, t):
            out.append("moe.shared.w_down")
    return out


def forward_train(params: Params, batch: Dict[str, Tensor],
                  cfg: ArchConfig, *, token_group=None
                  ) -> Tuple[Tensor, Tensor]:
    """batch: {"tokens": [B, S]} (+ "patches" for vit archs; "frames"
    [B, S, frontend_dim] alone for the audio frontend). Returns (logits
    fp32 [B, S, V], the MoE aux loss summed over layers).

    cfg.remat recomputes each layer in the backward: the layer runs under
    torch.utils.checkpoint with use_reentrant=False, which keeps only the
    layer's input and runs the layer's forward again, with autograd on,
    when the backward reaches it (the JAX package's jax.checkpoint). On
    the card a CADC linear then launches K1g twice a step (the forward
    and the recompute, each saving its gate) and K2 once. (The reentrant
    form would run the first pass with autograd off, so K1 then K1g, but
    it refuses torch.autograd.grad.)

    The recurrent layers run their training forms (rglru.rglru_apply,
    xlstm.mlstm_apply / slstm_apply) under the same remat. token_group:
    the group whose ranks hold the batch's other rows, for the MoE blocks
    to route over the whole batch (moe.moe_apply; the data-parallel train
    step, launch/steps.py).

    Under sequence parallelism (the TP context's `seq`) the embeddings are
    cut to this rank's block of the sequence and the layers carry it (the
    JAX package's _seq_shard); the head gathers the sequence back, so the
    logits are the whole sequence's."""
    kinds = layout(cfg)
    x = _embed_inputs(params, batch, cfg)
    s = batch["frames" if cfg.frontend == "audio" else "tokens"].shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(kinds):
        args = (params["layers"][i], x, kind, cfg, positions, token_group)
        # the layers draw no random numbers: no RNG state to stash
        x, a = (torch.utils.checkpoint.checkpoint(
                    _layer_train, *args, use_reentrant=False,
                    preserve_rng_state=False)
                if cfg.remat else _layer_train(*args))
        if a is not None:  # without MoE the JAX package adds zeros
            aux = aux + a
    return _head(params, x, cfg), aux


class _VocabLse(torch.autograd.Function):
    """logsumexp over the vocab rows of every rank of `group` (each rank's
    logits [..., V_r]): the global max and the sum of exp by all-reduce.
    The operations of torch.logsumexp (log(sum(exp(x - m))) + m, an
    infinite max taken as 0) and of its backward (g * exp(x - lse)), so a
    group of one is bitwise torch.logsumexp."""

    @staticmethod
    def forward(ctx, x, group):
        m = (x.amax(dim=-1) if x.shape[-1] else
             x.new_full(x.shape[:-1], -math.inf))
        comm.all_reduce(m, group, dist.ReduceOp.MAX)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        comm.all_reduce(s, group)
        lse = s.log().add_(m)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None


def _vocab_parallel_terms(logits: Tensor, labels: Tensor, cfg: ArchConfig):
    """(lse, the label's logit, the argmax) of vocab-parallel logits (this
    rank's real rows, layers.vocab_range) over the "model" group."""
    ctx = act_sharding.current()
    lo, _, valid = ll.vocab_range(cfg)
    lse = _VocabLse.apply(logits, ctx.group)
    local = labels.to(torch.int64) - lo
    inside = (local >= 0) & (local < valid)
    idx = local.clamp(0, max(valid - 1, 0))[..., None]
    picked = (torch.gather(logits, -1, idx)[..., 0] if valid
              else logits.new_zeros(labels.shape))
    picked = comm.reduce_from(torch.where(inside, picked,
                                          picked.new_zeros(())), ctx.group)
    with torch.no_grad():
        m = torch.full(labels.shape, -math.inf, device=logits.device)
        first = torch.full(labels.shape, cfg.padded_vocab,
                           dtype=torch.int64, device=logits.device)
        if valid:
            m, first = logits.max(dim=-1)
            first = first + lo
        top = comm.all_reduce(m.clone(), ctx.group, dist.ReduceOp.MAX)
        first = torch.where(m == top, first, cfg.padded_vocab)
        comm.all_reduce(first, ctx.group, dist.ReduceOp.MIN)
    return lse, picked, first


def lm_loss(logits: Tensor, labels: Tensor, *, z_loss: float = 1e-4,
            cfg: Optional[ArchConfig] = None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Causal LM cross-entropy plus z-loss (z_loss * logsumexp^2), averaged
    over the unmasked labels [B, S] (-1 = masked). Returns (loss, {"ce",
    "acc"}), the metrics detached.

    In the TP context, where `cfg` splits the vocab over "model"
    (layers.vocab_split), `logits` are this rank's vocab rows
    (forward_train's) and the loss is vocab-parallel: the global max, the
    sum of exp and the label's logit by all-reduce, the padded rows left
    out as the head leaves them out; the same value on every rank."""
    mask = (labels >= 0).float()
    if (cfg is not None and act_sharding.current() is not None
            and ll.vocab_split(cfg)):
        lse, picked, top = _vocab_parallel_terms(logits, labels, cfg)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        idx = labels.clamp(min=0).to(torch.int64)[..., None]
        picked = torch.gather(logits, -1, idx)[..., 0]
        top = logits.detach().argmax(dim=-1)
    ce = (lse - picked) * mask
    zl = z_loss * lse.square() * mask
    denom = mask.sum().clamp(min=1.0)
    loss = (ce + zl).sum() / denom
    hit = (top == labels).float() * mask
    return loss, {"ce": ce.detach().sum() / denom, "acc": hit.sum() / denom}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_layer_state(kind: str, cfg: ArchConfig, batch: int,
                     device: torch.device):
    """The init state of a recurrent layer kind for `batch` slots (fp32;
    the mLSTM and sLSTM stabilizers m at -inf)."""
    if kind == "mlstm":
        return xlstm_lib.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm_lib.slstm_init_state(cfg, batch, device)
    if kind == "rglru":
        return rglru_lib.rglru_init_state(cfg, batch, device)
    raise ValueError(f"unknown layer kind {kind!r}")


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
                device=device_lib.DEFAULT_DEVICE) -> List[Any]:
    """Dense caches, one per layer: ring caches for attention layers,
    state rows for recurrent ones."""
    dev = device_lib.resolve(device)
    dtype = dtype or ll.cdtype(cfg)
    return [attn.init_cache(cfg, kind, batch, seq_len, dtype, dev)
            if kind in ATTN_KINDS else init_layer_state(kind, cfg, batch, dev)
            for kind in layout(cfg)]


def init_paged_caches(cfg: ArchConfig, n_slots: int, block_size: int,
                      n_blocks: Dict[str, int], dtype=None,
                      device=device_lib.DEFAULT_DEVICE) -> List[Any]:
    """Paged KV pools for attention layers, [n_blocks[kind] + 1,
    block_size, K, hd] (the last block is the write sink, see
    attention.PagedKV); every layer of one kind shares the engine's one
    block table for it. Recurrent layers keep per-slot state rows
    (batch == n_slots), exactly as the dense layout does."""
    dev = device_lib.resolve(device)
    dtype = dtype or ll.cdtype(cfg)
    return [attn.init_paged_pool(cfg, n_blocks[kind], block_size, dtype, dev)
            if kind in ATTN_KINDS
            else init_layer_state(kind, cfg, n_slots, dev)
            for kind in layout(cfg)]


def copy_caches(caches: Sequence) -> List[Any]:
    """A copy of every cache tensor (a decode step on the copy leaves the
    original untouched)."""
    return [type(c)(*(t.clone() for t in c)) for c in caches]


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------

def _decode_layers(params: Params, tokens: Tensor, position: Tensor,
                   caches: List, cfg: ArchConfig,
                   block_tables: Optional[Dict[str, Tensor]],
                   ring_lens: Optional[Dict[str, int]],
                   token_group=None) -> Tensor:
    """tokens [B] -> logits [B, V]; tokens [B, Q] (a multi-token append)
    -> logits [B, Q, V]. KV caches are written in place; a recurrent
    layer's list entry becomes its new state (stacked [Q, ...] per token
    for Q > 1). ring_lens: each kind's logical ring length (paged: the
    covered-prefix tables' true length; dense: the rings whose blocks the
    caches are, in the TP context)."""
    multi = tokens.ndim == 2
    x = ll.embed(params["embed"], tokens if multi else tokens[:, None], cfg)
    for i, kind in enumerate(layout(cfg)):
        p, cache = params["layers"][i], caches[i]
        with ll.tap_scope(f"layer{i:02d}.{kind}"):
            if kind not in ATTN_KINDS:
                run = _recurrent_decode_multi if x.shape[1] > 1 else \
                    _recurrent_layer
                x, caches[i] = run(p, x, kind, cfg, cache)
                continue
            if block_tables is None:
                fn = lambda h, p=p, cache=cache, kind=kind: (  # noqa: E731
                    attn.attention_decode(
                        p["attn"], h, cfg, kind=kind, position=position,
                        cache=cache,
                        ring_len=ring_lens[kind] if ring_lens else None),
                    None)
            else:
                fn = lambda h, p=p, cache=cache, kind=kind: (  # noqa: E731
                    attn.attention_decode_paged(
                        p["attn"], h, cfg, kind=kind, position=position,
                        cache=cache, block_table=block_tables[kind],
                        ring_len=ring_lens[kind] if ring_lens else None),
                    None)
            x = _attn_residual(p, x, cfg, fn, token_group)[0]
    if not multi:
        return _head(params, x, cfg)[:, 0]
    # one head product a token column, each in the decode step's [B, 1, d]
    # shape: a GEMM's output rows can depend on its row count (the CPU's
    # BLAS picks its kernel by it); in this shape they are the decode's
    return torch.cat([_head(params, x[:, t:t + 1], cfg)
                      for t in range(x.shape[1])], dim=1)


def decode_step(params: Params, tokens: Tensor, position: Tensor, caches,
                cfg: ArchConfig, *, ring_lens: Optional[Dict[str, int]] = None,
                token_group=None) -> Tensor:
    """One decode step against dense caches (updated in place): tokens [B]
    int -> logits [B, V]. position: scalar or [B] per-slot offsets.

    In the TP context (the mesh serve step, launch/steps.py) the caches
    are this rank's blocks, under sharding.cache_specs, of rings of
    `ring_lens[kind]` entries, the logits this rank's vocab rows
    (layers.lm_head), and `token_group` the group an MoE block routes
    over (moe.moe_apply)."""
    return _decode_layers(params, tokens, position, caches, cfg, None,
                          ring_lens, token_group)


def decode_step_paged(params: Params, tokens: Tensor, position: Tensor,
                      caches, block_tables: Dict[str, Tensor],
                      cfg: ArchConfig,
                      ring_lens: Optional[Dict[str, int]] = None) -> Tensor:
    """decode_step against paged KV pools (updated in place). block_tables:
    one [B, nb] int32 table per attention kind (-1 = unallocated), possibly
    a covered-prefix slice — `ring_lens` then carries the true per-kind
    ring lengths. A stack with no attention kind takes an empty dict."""
    return _decode_layers(params, tokens, position, caches, cfg,
                          block_tables, ring_lens)


def decode_step_spec(params: Params, tokens: Tensor, position: Tensor,
                     caches, block_tables: Dict[str, Tensor], cfg: ArchConfig,
                     ring_lens: Optional[Dict[str, int]] = None) -> Tensor:
    """Speculative verify step: Q tokens a slot scored in ONE forward.

    tokens [B, Q >= 2] — column 0 the last committed token, columns
    1..Q-1 the drafts; position [B] the base position of column 0 (token t
    sits at position + t). Returns logits [B, Q, V]: logits[:, t] is
    conditioned on the prefix ending at token t, so its argmax is the
    token greedy decode emits after accepting tokens 0..t.

    The paged pools are written in place with all Q tokens' K/V (the
    multi-token append of attention_decode_paged, which fails fast when Q
    exceeds the ring). Entries of rejected drafts need no rollback: the
    next append's base advances by the commit count c >= 1 and covers
    [base + c, base + c + Q - 1], a superset of the stale
    [base + c, base + Q - 1], and an append writes before it attends, so
    every stale entry is rewritten before any q token reads it. On local
    rings this is the sequential decode only with ring headroom
    (attention.cache_len(headroom=)). Recurrent layers fold each token in
    irreversibly: their list entries come back as every token's state
    stacked [Q, ...] (_recurrent_decode_multi), and the caller must select
    the state of each slot's last kept token (backends.PagedBackend.
    decode_spec) before the caches serve another step."""
    if tokens.ndim != 2 or tokens.shape[1] < 2:
        raise ValueError(
            f"decode_step_spec wants tokens [B, Q >= 2]; got "
            f"{tuple(tokens.shape)} (use decode_step_paged for single "
            f"tokens)")
    return _decode_layers(params, tokens, position, caches, cfg,
                          block_tables, ring_lens)


# ---------------------------------------------------------------------------
# batched prefill (full-sequence forward that yields cache contributions)
# ---------------------------------------------------------------------------

def _recurrent_prefill(p: Params, x: Tensor, kind: str, cfg: ArchConfig,
                       lengths: Tensor):
    """The decode cell run over the prompt token by token at [B, 1, d]
    (so the final state is bitwise what feeding the prompt through
    decode_step leaves behind), each slot's state frozen at
    t >= lengths[slot]: (x [B, S, d], the final per-slot state)."""
    b, s = x.shape[0], x.shape[1]
    state = init_layer_state(kind, cfg, b, x.device)
    ys = []
    for t in range(s):
        y, new = _recurrent_layer(p, x[:, t:t + 1].contiguous(), kind, cfg,
                                  state)
        keep = t < lengths
        state = type(new)(*(
            torch.where(keep.reshape((b,) + (1,) * (nl.ndim - 1)), nl, ol)
            for nl, ol in zip(new, state)))
        ys.append(y)
    return torch.cat(ys, dim=1), state


def forward_prefill(params: Params, batch: Dict[str, Tensor],
                    cfg: ArchConfig, *, lengths: Optional[Tensor] = None
                    ) -> Tuple[Tensor, List[Any]]:
    """Batched prefill over left-aligned prompts (positions 0..S-1) of
    per-slot lengths [B] (default S); batch {"tokens": [B, S]} (+
    "patches" for vit archs). Returns (logits fp32 [B, S, V], per-layer
    contributions): an attention layer's rope'd (k, v) [B, S, K, hd] —
    padded tail tokens give entries the cache writers mask out — and a
    recurrent layer's final state at each slot's own length."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int64,
                             device=tokens.device)
    kinds = layout(cfg)
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(s, device=tokens.device)[None, :]
    contribs = []
    for i, kind in enumerate(kinds):
        p = params["layers"][i]
        if kind in ATTN_KINDS:
            x, c, _ = _attn_residual(p, x, cfg, lambda h, p=p, kind=kind:
                                     attn.attention_prefill(
                                         p["attn"], h, cfg, kind=kind,
                                         positions=positions))
        else:
            x, c = _recurrent_prefill(p, x, kind, cfg, lengths)
        contribs.append(c)
    return _head(params, x, cfg), contribs
