"""The LM stack: embedding -> pattern-cycled attention blocks -> norm -> head.

Port of repro.models.lm.transformer for the attention layer kinds
('global', 'local'), each with a dense FFN or an MoE block, tied or untied
heads, and the ViT patch prefix; recurrent and xLSTM kinds and the audio
frontend raise at init. The JAX package stacks each pattern position's
parameters over the unit repeats and runs them as one lax.scan; here the
stack is a Python list of layers, layer i having kind
cfg.pattern_for_layers[i], and the scan is a loop.

Parameters: {"embed": {"table"}, "final_norm": {"scale"}, "head": {"w"}
(untied heads), "frontend_proj": {"w", "b"} (vit), "layers": [{"ln1",
"attn": {"wq", "wk", "wv", "wo"} (+ "b" with qkv bias), "ln2", "ffn":
{"w_gate", "w_up", "w_down"} or "moe": {"router", "w_gate", "w_up",
"w_down", "shared", "shared_gate"}}, ...]} — the JAX names, one dict per
layer. `params_from_numpy` takes the JAX package's `tf.init` pytree (as
numpy arrays) and returns this layout.

Caches: a list with one entry per layer — attention.KVCache rings (dense)
or attention.PagedKV pools (paged), updated in place by the decode steps.
`decode_step_spec` is the speculative verify step: Q tokens a slot in one
multi-token paged append.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_lib
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import moe as moe_lib

Tensor = torch.Tensor
Params = Dict[str, Any]
ATTN_KINDS = ("global", "local")


def layout(cfg: ArchConfig) -> Tuple[str, ...]:
    """Kind of every layer, in stack order. Refuses what is not ported:
    the recurrent and xLSTM kinds and the audio frontend (an encoder's;
    ffn.ffn_init refuses the plain gelu FFN)."""
    kinds = cfg.pattern_for_layers
    other = sorted(set(kinds) - set(ATTN_KINDS))
    if other:
        raise NotImplementedError(
            f"layer kinds {other} are not ported (attention kinds are)")
    if cfg.frontend not in (None, "vit"):
        raise NotImplementedError(
            f"the {cfg.frontend!r} frontend is not ported (vit is)")
    return kinds


def _layer_init(gen: torch.Generator, cfg: ArchConfig,
                device: torch.device) -> Params:
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


def init(cfg: ArchConfig, *, seed: int = 0,
         device=device_lib.DEFAULT_DEVICE,
         dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters from a seeded torch.Generator on `device`: fp32,
    or cast to `dtype` leaf group by leaf group as they are drawn (the
    same draws in the same order, so init(dtype=d) is bitwise
    cast_params(init(), d), without holding the whole fp32 model). The JAX
    package's jax.random draws cannot be reproduced here; parity tests
    load JAX-initialised parameters with params_from_numpy."""
    dev = device_lib.resolve(device)
    kinds = layout(cfg)
    gen = torch.Generator(device=dev)
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
    params["layers"] = [cast(_layer_init(gen, cfg, dev)) for _ in kinds]
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
    stay [S, xbar, d_out]; "head", "frontend_proj" and every bias "b" are
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


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating parameters cast to `dtype` (integers untouched)."""
    return tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_residual(p: Params, x: Tensor, cfg: ArchConfig, attn_fn):
    """ln1 -> attn_fn -> residual -> ln2 -> moe / ffn -> residual, shared
    by the dense decode, paged decode and prefill paths (one
    implementation, so the paged == dense invariant cannot drift).
    attn_fn(h) -> (y, extra). The MoE aux loss is dropped: serving takes
    no gradient."""
    h = ll.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, extra = attn_fn(h)
    x = x + y
    h = ll.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if cfg.moe.n_experts > 0:
        x = x + moe_lib.moe_apply(p["moe"], h, cfg)[0]
    elif cfg.ffn_type != "none":
        x = x + ffn_lib.ffn_apply(p["ffn"], h, cfg)
    return x, extra


def _head(params: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = ll.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return ll.lm_head(params.get("head"), params["embed"], x, cfg)


def _embed_inputs(params: Params, batch: Dict[str, Tensor],
                  cfg: ArchConfig) -> Tensor:
    """Token embeddings; for vit archs the projected patches
    batch["patches"] [B, frontend_len, frontend_dim] overlay the first
    frontend_len positions (those positions are the image)."""
    x = ll.embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vit":
        patches = ll.linear_apply(params["frontend_proj"], batch["patches"],
                                  cfg)
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, seq_len: int, dtype=None,
                device=device_lib.DEFAULT_DEVICE) -> List[attn.KVCache]:
    """Dense ring caches, one per layer."""
    dev = device_lib.resolve(device)
    dtype = dtype or ll.cdtype(cfg)
    return [attn.init_cache(cfg, kind, batch, seq_len, dtype, dev)
            for kind in layout(cfg)]


def init_paged_caches(cfg: ArchConfig, block_size: int,
                      n_blocks: Dict[str, int], dtype=None,
                      device=device_lib.DEFAULT_DEVICE) -> List[attn.PagedKV]:
    """Paged KV pools, one per layer, [n_blocks[kind] + 1, block_size, K,
    hd] (the last block is the write sink, see attention.PagedKV). Every
    layer of one kind shares the engine's one block table for it."""
    dev = device_lib.resolve(device)
    dtype = dtype or ll.cdtype(cfg)
    return [attn.init_paged_pool(cfg, n_blocks[kind], block_size, dtype, dev)
            for kind in layout(cfg)]


def _decode_layers(params: Params, tokens: Tensor, position: Tensor,
                   caches: Sequence, cfg: ArchConfig,
                   block_tables: Optional[Dict[str, Tensor]],
                   ring_lens: Optional[Dict[str, int]]) -> Tensor:
    """tokens [B] -> logits [B, V]; tokens [B, Q] (a multi-token paged
    append) -> logits [B, Q, V]; caches updated in place."""
    multi = tokens.ndim == 2
    x = ll.embed(params["embed"], tokens if multi else tokens[:, None], cfg)
    for i, kind in enumerate(layout(cfg)):
        p, cache = params["layers"][i], caches[i]
        if block_tables is None:
            fn = lambda h, p=p, cache=cache, kind=kind: (  # noqa: E731
                attn.attention_decode(p["attn"], h, cfg, kind=kind,
                                      position=position, cache=cache), None)
        else:
            fn = lambda h, p=p, cache=cache, kind=kind: (  # noqa: E731
                attn.attention_decode_paged(
                    p["attn"], h, cfg, kind=kind, position=position,
                    cache=cache, block_table=block_tables[kind],
                    ring_len=ring_lens[kind] if ring_lens else None), None)
        with ll.tap_scope(f"layer{i:02d}.{kind}"):
            x, _ = _attn_residual(p, x, cfg, fn)
    if not multi:
        return _head(params, x, cfg)[:, 0]
    # one head product a token column, each in the decode step's [B, 1, d]
    # shape: a GEMM's output rows can depend on its row count (the CPU's
    # BLAS picks its kernel by it); in this shape they are the decode's
    return torch.cat([_head(params, x[:, t:t + 1], cfg)
                      for t in range(x.shape[1])], dim=1)


def decode_step(params: Params, tokens: Tensor, position: Tensor, caches,
                cfg: ArchConfig) -> Tensor:
    """One decode step against dense caches (updated in place): tokens [B]
    int -> logits [B, V]. position: scalar or [B] per-slot offsets."""
    return _decode_layers(params, tokens, position, caches, cfg, None, None)


def decode_step_paged(params: Params, tokens: Tensor, position: Tensor,
                      caches, block_tables: Dict[str, Tensor],
                      cfg: ArchConfig,
                      ring_lens: Optional[Dict[str, int]] = None) -> Tensor:
    """decode_step against paged KV pools (updated in place). block_tables:
    one [B, nb] int32 table per attention kind (-1 = unallocated), possibly
    a covered-prefix slice — `ring_lens` then carries the true per-kind
    ring lengths."""
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
    (attention.cache_len(headroom=)). Recurrent layers, whose states the
    JAX package stacks per token for the caller to select
    (`_recurrent_decode_multi`), come with the recurrent kinds: the port
    refuses them at init."""
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

def forward_prefill(params: Params, batch: Dict[str, Tensor],
                    cfg: ArchConfig) -> Tuple[Tensor, List[Tuple[Tensor, Tensor]]]:
    """Batched prefill over left-aligned prompts (positions 0..S-1);
    batch {"tokens": [B, S]} (+ "patches" for vit archs). Returns (logits fp32 [B, S, V], per-layer rope'd (k, v) [B, S, K, hd]);
    padded tail tokens contribute entries the cache writers mask out."""
    tokens = batch["tokens"]
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    contribs = []
    for i, kind in enumerate(layout(cfg)):
        p = params["layers"][i]
        x, kv = _attn_residual(p, x, cfg, lambda h, p=p, kind=kind:
                               attn.attention_prefill(p["attn"], h, cfg,
                                                      kind=kind,
                                                      positions=positions))
        contribs.append(kv)
    return _head(params, x, cfg), contribs
