"""GQA/MQA attention: RoPE, global-causal / sliding-local / bidirectional
(encoder) full-sequence attention for training and prefill, and decode
against dense ring caches or paged KV pools.

Port of repro.models.lm.attention. Decode takes PER-SLOT positions (a [B]
vector; a scalar broadcasts): the continuous-batching engine runs every
cache slot at its own offset. Two cache layouts share one attention form
(`masked_sdpa`):

  * dense `KVCache` [B, L, K, hd] — one ring per slot;
  * paged `PagedKV` — [n_blocks, block_size, K, hd] pools plus a per-slot
    block table; `attention_decode_paged` dispatches through
    kernels.ops.paged_attention (the CUDA flash-decoding kernel, or the
    gather formulation that is bit-identical to the dense ring).

The port writes new K/V into the caches IN PLACE (the JAX package returns
new arrays); callers that must keep a cache unchanged pass a copy.

QKV/O projections route through layers.linear_apply, so they are
CADC-partitioned when the config says so.

Training under the TP context (parallel.act_sharding; the JAX package's
`_hshard` constraint, heads over "model") runs each rank's block of q
heads: q column-parallel, k / v column-parallel over the kv heads where
they divide the axis, else each rank computes the kv heads its q heads
read (q_head // (H / K)) from the whole weight, then `wo` row-parallel
(or, where its segments would span ranks, over the gathered heads).
`heads_split` / `kv_split` / `wo_local` say which, for the layers and the
train step's plan alike. Under sequence parallelism (the context's `seq`)
the input is this rank's block of the sequence: the head-parallel form
gathers it along S (layers.tp_in) and wo's output is reduce-scattered
along S; a replicated attention runs on the gathered sequence
(layers.whole_seq). Positions, RoPE and the masks are the whole
sequence's either way.

Decode under the TP context (the mesh serve step, launch/steps.py) runs
on each rank's block of the dense rings under the cache rule
(parallel/sharding.py cache_specs), which also picks the form
(`decode_form`): head-parallel where the kv heads divide "model" (the
train form's q / k / v over the rank's heads, `wo` row-parallel or on the
gathered heads), length-parallel where the ring length does (every head
from the whole weights, the rank whose block holds the new entry writes
it, the ranks' partial softmaxes merged over "model": `_merge_partials`),
else replicated (the attention whole on every rank).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
# One definition of the ring mask and of the SDPA form (NEG_INF masking,
# softcap) for the dense and paged paths: paged == dense bitwise holds only
# while they agree.
from repro_torch.kernels.paged_attention import (_ring_mask, masked_sdpa,
                                                 partial_sdpa)
from repro_torch.models.lm import layers as ll
from repro_torch.parallel import act_sharding as sa
from repro_torch.parallel import comm

Tensor = torch.Tensor


def attn_init(gen: torch.Generator, cfg: ArchConfig,
              device: torch.device) -> Dict:
    d, h, k_, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = cfg.attn_qkv_bias
    return {
        "wq": ll.linear_init(gen, d, h * hd, cfg, device, bias=b),
        "wk": ll.linear_init(gen, d, k_ * hd, cfg, device, bias=b),
        "wv": ll.linear_init(gen, d, k_ * hd, cfg, device, bias=b),
        "wo": ll.linear_init(gen, h * hd, d, cfg, device),
    }


def heads_split(cfg: ArchConfig, sizes: Optional[Dict[str, int]] = None
                ) -> bool:
    """Whether the q heads are split over "model" (H divides the axis)."""
    return sa.splits(cfg.n_heads, sizes=sizes, enabled=cfg.act_sharding)


def kv_split(cfg: ArchConfig, sizes: Optional[Dict[str, int]] = None
             ) -> bool:
    """Whether the kv heads are split too (K divides the axis); else each
    rank computes the kv heads of its q heads from the whole weight."""
    return heads_split(cfg, sizes) and sa.splits(
        cfg.n_kv_heads, sizes=sizes, enabled=cfg.act_sharding)


def wo_local(cfg: ArchConfig, model: int) -> bool:
    """Whether `wo` runs row-parallel on each rank's heads (the heads'
    features are whole segments on every rank)."""
    return ll.segment_local(cfg, cfg.n_heads * cfg.head_dim, model)


def decode_form(cfg: ArchConfig, ring_len: int, model: int) -> str:
    """The form of a decode step's attention over a "model" axis of `model`
    ranks, read off the layout the cache rule (sharding.cache_specs) gives
    a dense ring of `ring_len` entries: "head-parallel" where the kv heads
    divide the axis, "length-parallel" where the ring length does, else
    "replicated"."""
    if cfg.n_kv_heads % model == 0:
        return "head-parallel"
    if ring_len % model == 0:
        return "length-parallel"
    return "replicated"


def _kv_heads_of(cfg: ArchConfig, rank: int, model: int):
    """The kv heads [lo, hi) the q heads of `rank` read, and each local q
    head's index among them."""
    h_loc = cfg.n_heads // model
    group = cfg.n_heads // cfg.n_kv_heads
    q = range(rank * h_loc, (rank + 1) * h_loc)
    lo, hi = q[0] // group, q[-1] // group + 1
    return lo, hi, [j // group - lo for j in q]


def _qkv_tp(p, x: Tensor, cfg: ArchConfig, positions: Tensor):
    """_qkv over this rank's q heads (and the kv heads they read): q, k, v
    with k / v expanded to one head per q head where the local q heads do
    not group evenly over them."""
    ctx = sa.current()
    t = ctx.sizes["model"]
    x = ll.tp_in(x)
    b, s, _ = x.shape
    h, hd = cfg.n_heads // t, cfg.head_dim
    q = ll.column_linear(p["wq"], x, cfg).reshape(b, s, h, hd)
    if kv_split(cfg):
        kw = {}
        k_ = cfg.n_kv_heads // t
    else:
        lo, hi, idx = _kv_heads_of(cfg, ctx.rank, t)
        kw = {"cols": (lo * hd, hi * hd)}
        k_ = hi - lo
    k = ll.column_linear(p["wk"], x, cfg, **kw).reshape(b, s, k_, hd)
    v = ll.column_linear(p["wv"], x, cfg, **kw).reshape(b, s, k_, hd)
    if not kv_split(cfg) and not (
            h % k_ == 0 and idx == [j // (h // k_) for j in range(h)]):
        sel = torch.tensor(idx, device=x.device)
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    return (ll.rope(q, positions, cfg.rope_theta),
            ll.rope(k, positions, cfg.rope_theta), v)


def _qkv(p, x: Tensor, cfg: ArchConfig, positions: Tensor):
    """x [B, S, d], positions [B or 1, S] -> rope'd q [B,S,H,hd], k, v."""
    b, s, _ = x.shape
    h, k_, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ll.linear_apply(p["wq"], x, cfg).reshape(b, s, h, hd)
    k = ll.linear_apply(p["wk"], x, cfg).reshape(b, s, k_, hd)
    v = ll.linear_apply(p["wv"], x, cfg).reshape(b, s, k_, hd)
    return (ll.rope(q, positions, cfg.rope_theta),
            ll.rope(k, positions, cfg.rope_theta), v)


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q [B,C,H,hd], k/v [B,L,K,hd], mask [B,C,L] bool (True = keep)."""
    return masked_sdpa(q, k, v, mask, cfg.attn_logit_softcap)


def attention_train(p: Dict, x: Tensor, cfg: ArchConfig, *, kind: str,
                    positions: Tensor) -> Tensor:
    """kind: 'global' (causal, or bidirectional for encoders) | 'local'
    (causal sliding window), over the whole sequence in q chunks of
    cfg.attn_chunk rows."""
    if sa.current() is not None and not heads_split(cfg):
        return ll.whole_seq(lambda h: _attention_full(
            p, h, cfg, kind=kind, positions=positions)[0], x)
    return _attention_full(p, x, cfg, kind=kind, positions=positions)[0]


def attention_prefill(p: Dict, x: Tensor, cfg: ArchConfig, *, kind: str,
                      positions: Tensor) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Batched-prefill attention: the full-sequence forward, also returning
    the rope'd (k, v) [B, S, K, hd] for insertion into the KV caches."""
    out, k, v = _attention_full(p, x, cfg, kind=kind, positions=positions)
    return out, (k, v)


def _attention_full(p: Dict, x: Tensor, cfg: ArchConfig, *, kind: str,
                    positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Causal (and, for 'local', windowed) attention over the whole
    sequence — every key for an encoder (cfg.is_encoder) — in q chunks of
    cfg.attn_chunk rows against every key (the masks give each chunk
    exactly the JAX package's keys)."""
    tp = sa.current() is not None and heads_split(cfg)
    q, k, v = (_qkv_tp if tp else _qkv)(p, x, cfg, positions)
    b, s = q.shape[:2]
    kpos = torch.arange(s, device=x.device)
    outs = []
    for c0 in range(0, s, cfg.attn_chunk):
        qpos = torch.arange(c0, min(c0 + cfg.attn_chunk, s), device=x.device)
        if cfg.is_encoder:
            mask = torch.ones(qpos.numel(), s, dtype=torch.bool,
                              device=x.device)
        else:
            mask = kpos[None, :] <= qpos[:, None]
            if kind == "local":
                mask &= kpos[None, :] > qpos[:, None] - cfg.local_window
        outs.append(_sdpa(q[:, c0:c0 + qpos.numel()], k, v,
                          mask.expand(b, -1, -1), cfg))
    out = torch.cat(outs, dim=1).reshape(b, s, -1)
    if tp:
        local = wo_local(cfg, sa.current().sizes["model"])
        return ll.row_or_gathered(p["wo"], out, cfg, local), k, v
    return ll.linear_apply(p["wo"], out, cfg), k, v


# ---------------------------------------------------------------------------
# decode path (KV cache)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: Tensor  # [B, L, K, hd] — L = seq_len (global) or window (local)
    v: Tensor


class PagedKV(NamedTuple):
    """A slot's logical [L, K, hd] ring scattered over `L / block_size`
    physical blocks named by its block-table row. The pools hold one block
    more than the tables can name: the last block is the sink for writes
    to unallocated (-1) blocks — the JAX package drops them by scattering
    to index n_blocks with mode="drop" — so the write needs no host sync.
    No table names the sink, so nothing reads it."""

    k: Tensor  # [n_blocks + 1, block_size, K, hd]
    v: Tensor


def cache_len(cfg: ArchConfig, kind: str, seq_len: int, *,
              headroom: int = 0) -> int:
    """Logical per-slot cache length for an attention layer kind — the one
    source of the ring geometry for the dense and the paged caches.

    `headroom` buys multi-token appends (speculative verify steps of
    Q = headroom + 1 tokens) the sequential decode's semantics on local
    rings: a Q-token append equals Q one-token steps only while no write
    lands inside an earlier q token's window, which needs
    ring_len >= window + Q - 1 (attention_decode_paged). Entries past the
    window are masked either way, so the headroom changes capacity, never
    the attention output."""
    if kind == "local":
        return min(cfg.local_window + headroom, seq_len)
    return seq_len


def init_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int,
               dtype: torch.dtype, device: torch.device) -> KVCache:
    shape = (batch, cache_len(cfg, kind, seq_len), cfg.n_kv_heads,
             cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_paged_pool(cfg: ArchConfig, n_blocks: int, block_size: int,
                    dtype: torch.dtype, device: torch.device) -> PagedKV:
    """n_blocks addressable blocks plus the write sink (see PagedKV)."""
    shape = (n_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _decode_qkv(p: Dict, x: Tensor, cfg: ArchConfig, position: Tensor,
                qkv=_qkv):
    """x [B, Q, d]; position scalar or [B] is the BASE position (token t
    sits at position + t). Returns q, k_new, v_new and pos [B] int64.
    qkv: _qkv, or _qkv_tp for the rank's heads."""
    b, s = x.shape[0], x.shape[1]
    pos = torch.as_tensor(position, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.ndim == 0 else pos
    qpos = pos[:, None] + torch.arange(s, device=x.device)[None, :]
    q, k_new, v_new = qkv(p, x, cfg, qpos)
    return q, k_new, v_new, pos


def _ring_slot(pos: Tensor, l: int, kind: str) -> Tensor:
    """Ring index each new token lands at (global rings clamp at l-1)."""
    return torch.remainder(pos, l) if kind == "local" else pos.clamp(0, l - 1)


def _decode_mask(pos: Tensor, l: int, kind: str, window: int, lo: int = 0,
                 n: Optional[int] = None) -> Tensor:
    """[B, n] validity of ring entries [lo, lo + n) (default: the whole
    ring of l entries) at per-slot positions `pos` [B]."""
    idx = torch.arange(lo, lo + (l if n is None else n), device=pos.device)
    return _ring_mask(pos, idx, kind=kind, ring_len=l, window=window,
                      q_len=1)[:, 0]


def _merge_partials(out: Tensor, top: Tensor, total: Tensor,
                    group) -> Tensor:
    """The softmax attention over the ranks' blocks of the ring from each
    rank's partial_sdpa (its block's fp32 output [B, C, H, hd], its max and
    sum of exp [B, C, H]): the partials all-gathered over `group` and
    merged in rank order, so every rank holds the same bits. fp32."""
    parts = comm.all_gather(torch.cat([out, top[..., None], total[..., None]],
                                      dim=-1), 0, group)
    parts = parts.unflatten(0, (-1, out.shape[0]))   # [T, B, C, H, hd + 2]
    tops = parts[..., -2]
    weight = parts[..., -1] * torch.exp(tops - tops.amax(dim=0))
    acc, norm = weight[0, ..., None] * parts[0, ..., :-2], weight[0]
    for r in range(1, parts.shape[0]):
        acc = acc + weight[r, ..., None] * parts[r, ..., :-2]
        norm = norm + weight[r]
    return acc / norm[..., None]


def attention_decode(p: Dict, x: Tensor, cfg: ArchConfig, *, kind: str,
                     position: Tensor, cache: KVCache,
                     ring_len: Optional[int] = None) -> Tensor:
    """One-token decode against a dense ring cache, written in place.
    x [B, 1, d]; position scalar or [B]. Returns the attention output.

    Under the TP context `cache` is this rank's block of a logical ring of
    `ring_len` entries (required there) under sharding.cache_specs, and
    decode_form picks the form (module docstring). Length-parallel: rank
    r's block holds entries [r L / T, (r + 1) L / T); a slot's new entry is
    written by the rank whose block holds its ring index (the other ranks
    rewrite what their block holds), each rank scores its block under the
    ring mask at the block's offset, and _merge_partials combines them; a
    row no rank may read gets masked_sdpa's uniform average."""
    ctx = sa.current()
    form = None
    if ctx is not None:
        if ring_len is None:
            raise ValueError("a decode in the TP context needs the logical "
                             "ring length of the cache's block")
        t = ctx.sizes["model"]
        form = decode_form(cfg, ring_len, t)
    b = x.shape[0]
    heads = form == "head-parallel"
    q, k_new, v_new, pos = _decode_qkv(p, x, cfg, position,
                                       _qkv_tp if heads else _qkv)
    n = cache.k.shape[1]
    rows = torch.arange(b, device=x.device)
    if form == "length-parallel":
        lo, l = ctx.rank * n, n * t
        slot = _ring_slot(pos, l, kind) - lo
        mine = ((slot >= 0) & (slot < n))[:, None, None]
        slot = slot.clamp(0, n - 1)
        for c, new in ((cache.k, k_new), (cache.v, v_new)):
            c[rows, slot] = torch.where(mine, new[:, 0].to(c.dtype),
                                        c[rows, slot])
        valid = _decode_mask(pos, l, kind, cfg.local_window, lo, n)
        out = _merge_partials(*partial_sdpa(
            q, cache.k, cache.v, valid[:, None, :], cfg.attn_logit_softcap),
            ctx.group).to(q.dtype)
    else:
        slot = _ring_slot(pos, n, kind)
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
        valid = _decode_mask(pos, n, kind, cfg.local_window)
        out = _sdpa(q, cache.k, cache.v, valid[:, None, :], cfg)
    out = out.reshape(b, 1, -1)
    if heads:
        return ll.row_or_gathered(p["wo"], out, cfg, wo_local(cfg, t))
    return ll.linear_apply(p["wo"], out, cfg)


def attention_decode_paged(p: Dict, x: Tensor, cfg: ArchConfig, *, kind: str,
                           position: Tensor, cache: PagedKV,
                           block_table: Tensor,
                           ring_len: Optional[int] = None) -> Tensor:
    """Decode against the paged pool, written in place. x [B, Q, d], Q >= 1.
    block_table [B, nb] int32 maps each slot's logical block to a physical
    block; -1 marks an unallocated block (writes to it go to the pool's
    sink block, reads are masked). The table may be a COVERED-PREFIX slice of the full table;
    `ring_len` then carries the true ring length (default nb * block_size).

    Q > 1 ring semantics: all Q tokens' K/V are written first, then every
    q token attends the final ring under its own mask — sequential-exact
    on a local ring only while the append does not wrap it."""
    b, q_len = x.shape[0], x.shape[1]
    q, k_new, v_new, pos = _decode_qkv(p, x, cfg, position)
    bs = cache.k.shape[1]
    nb = block_table.shape[1]
    ring_len = nb * bs if ring_len is None else ring_len
    if q_len > ring_len:
        raise ValueError(
            f"multi-token append of {q_len} tokens exceeds the "
            f"{ring_len}-entry ring: ring slots would collide")
    qpos = pos[:, None] + torch.arange(q_len, device=x.device)[None, :]
    slot = _ring_slot(qpos, ring_len, kind)
    # Idle slots may sit at stale positions past the covered prefix; their
    # rows are all -1, so clamping the block index only keeps the gather
    # in range and changes no live write.
    blk = (slot // bs).clamp(max=nb - 1)
    phys = torch.gather(block_table.to(torch.int64), 1, blk)
    phys = torch.where(phys >= 0, phys, cache.k.shape[0] - 1)  # -1: sink
    cache.k[phys, slot % bs] = k_new.to(cache.k.dtype)
    cache.v[phys, slot % bs] = v_new.to(cache.v.dtype)
    out = kops.paged_attention(
        q, cache.k, cache.v, block_table, pos, kind=kind,
        window=cfg.local_window, ring_len=ring_len,
        softcap=cfg.attn_logit_softcap, impl=cfg.paged_attn_impl,
    ).reshape(b, q_len, -1)
    return ll.linear_apply(p["wo"], out, cfg)
