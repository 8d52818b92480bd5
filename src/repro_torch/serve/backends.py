"""Device-side cache backends for the serve engine.

Port of repro.serve.backends (dense and paged). Both backends expose

    init_caches() -> caches
    decode(params, caches, tables, tokens, positions) -> (next, logits)
    write_prefill(caches, contribs, slot_ids, lengths, host_tables)
    reset_slots(caches, slot_mask)

and update the caches in place (a recurrent layer's list entry is
replaced by its new state); the paged backend built with spec_tokens=K
adds the speculative draft/verify step

    decode_spec(params, caches, tables, tokens [B, K+1], positions)
        -> (greedy [B, K+1], logits, keep [B])

which scores the committed token and K drafts in one multi-token append,
computes the accepted-prefix length and rolls every recurrent layer's
state back to each slot's last kept token (`_select_spec_states`; KV
entries of rejected drafts need no rollback: the next append rewrites
them before any read). Its rings get K entries of headroom
(attention.cache_len). `DenseBackend` keeps per-slot ring caches
([n_slots, L, K, hd]); `PagedBackend` scatters each ring over
block-table-indexed pools. Recurrent layers keep per-slot state rows,
the same in both. A stack with no attention kind (xLSTM) has no rings,
no block tables and no pools. On the plain attention path the two
layouts are bit-identical by construction: the paged writer places
exactly the entries the dense ring holds, and the paged attention
regathers them into the ring layout before the same masked SDPA.

Prefill insertion is a GATHER, not a scatter over token positions: ring
entry i of a slot with prompt length `len` holds the latest position
p_i ≡ i (mod L) with p_i <= len-1. The (row, entry, position) triples of
the valid entries are computed once per admission wave on the host
(numpy), so every layer's insertion is one indexed copy with no
device-to-host sync. A recurrent layer's final prefill state goes into
its slot's row; padding rows are dropped.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import transformer as tf

Tensor = torch.Tensor


def _ring_entries(lengths: np.ndarray, ring_len: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Valid ring entries after a prefill of `lengths` [Bp] tokens:
    (row, entry i, prompt position p_i) arrays. Entry i holds
    p_i = last - ((last - i) mod ring_len), the newest position congruent
    to i — what token-by-token decode writes would have left behind."""
    last = (lengths.astype(np.int64) - 1)[:, None]
    i = np.arange(ring_len)[None, :]
    p = last - np.mod(last - i, ring_len)
    row, entry = np.nonzero((p >= 0) & (p <= last))
    return row, entry, p[row, entry]


class _Backend:
    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int,
                 device: torch.device):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = device
        self.kinds = tf.layout(cfg)
        self.attn_kinds = [k for k in tf.ATTN_KINDS if k in self.kinds]

    def decode(self, params, caches, tables, tokens: Tensor,
               positions: Tensor) -> Tuple[Tensor, Tensor]:
        logits = self._logits(params, caches, tables, tokens, positions)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _logits(self, params, caches, tables, tokens, positions) -> Tensor:
        raise NotImplementedError

    def write_prefill(self, caches, contribs: List[Any],
                      slot_ids: np.ndarray, lengths: np.ndarray,
                      host_tables: Optional[Dict[str, np.ndarray]]) -> None:
        """Insert the prefill's contributions for rows with slot_ids <
        n_slots (the rest are padding) into the caches: an attention
        layer's K/V (contribs[i] = (k, v) [Bp, S, K, hd]) into its ring, a
        recurrent layer's final state into its slots' rows (JAX
        _write_states)."""
        rows = np.flatnonzero(slot_ids < self.n_slots)
        index = {}
        for kind in self.attn_kinds:
            r, e, p = _ring_entries(lengths[rows], self._ring_len(kind))
            dest = self._dest(kind, slot_ids[rows][r], e, host_tables)
            keep = dest[0] >= 0            # paged: unallocated blocks drop
            to_dev = lambda a: torch.as_tensor(  # noqa: E731
                a[keep], dtype=torch.int64, device=self.device)
            index[kind] = (to_dev(rows[r]), to_dev(p), to_dev(dest[0]),
                           to_dev(dest[1]))
        src = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        dst = torch.as_tensor(slot_ids[rows], dtype=torch.int64,
                              device=self.device)
        for kind, cache, contrib in zip(self.kinds, caches, contribs):
            if kind not in tf.ATTN_KINDS:
                for leaf, new in zip(cache, contrib):
                    leaf[dst] = new[src].to(leaf.dtype)
                continue
            k_new, v_new = contrib
            src_row, src_pos, d0, d1 = index[kind]
            cache.k[d0, d1] = k_new[src_row, src_pos].to(cache.k.dtype)
            cache.v[d0, d1] = v_new[src_row, src_pos].to(cache.v.dtype)

    def reset_slots(self, caches, slot_mask: np.ndarray) -> None:
        """Put the init state back into the recurrent rows of the slots in
        `slot_mask` [n_slots] (JAX _reset_states): an admitted request
        must not start from the state its slot's last request left. KV
        passes through: ring masking never reads stale entries."""
        slots = np.flatnonzero(slot_mask)
        if not slots.size:
            return
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for kind, cache in zip(self.kinds, caches):
            if kind in tf.ATTN_KINDS:
                continue
            fresh = tf.init_layer_state(kind, self.cfg, len(slots),
                                        self.device)
            for leaf, init in zip(cache, fresh):
                leaf[idx] = init.to(leaf.dtype)

    def _ring_len(self, kind: str) -> int:
        raise NotImplementedError

    def _dest(self, kind, slots, entries, host_tables):
        raise NotImplementedError


class DenseBackend(_Backend):
    """Per-slot ring caches: the bit-exact reference the paged backend is
    tested against."""

    def init_caches(self):
        return tf.init_caches(self.cfg, self.n_slots, self.max_len,
                              device=self.device)

    def _ring_len(self, kind):
        return attn.cache_len(self.cfg, kind, self.max_len)

    def _dest(self, kind, slots, entries, host_tables):
        return slots, entries

    def _logits(self, params, caches, tables, tokens, positions):
        return tf.decode_step(params, tokens, positions, caches, self.cfg)


class PagedBackend(_Backend):
    """Block-table-indexed KV pools."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int,
                 block_size: int, device: torch.device,
                 n_blocks: Optional[Dict[str, int]] = None,
                 spec_tokens: int = 0):
        super().__init__(cfg, n_slots, max_len, device)
        self.block_size = block_size
        self.spec_tokens = spec_tokens
        kinds = self.attn_kinds
        if spec_tokens:
            # A verify step appends Q = K + 1 tokens. Local rings get
            # window + K entries, so no write lands inside an earlier
            # draft's window; global rings hold positions up to
            # max_len - 1 + K (a slot's last step may draft past its last
            # committed token), where the clip at ring_len - 1 would put
            # two drafts on one entry. Rounded up to whole blocks: the
            # extra entries are masked, they change capacity, not output.
            alloc = max_len + spec_tokens
            self.ring_len = {
                k: -(-attn.cache_len(cfg, k, alloc, headroom=spec_tokens)
                     // block_size) * block_size
                for k in kinds}
        else:
            self.ring_len = {k: attn.cache_len(cfg, k, max_len)
                             for k in kinds}
            for k, l in self.ring_len.items():
                if l % block_size != 0:
                    raise ValueError(
                        f"block_size={block_size} must divide the {k!r} ring "
                        f"length {l} (max_len={max_len}, "
                        f"local_window={cfg.local_window})")
        self.blocks_per_slot = {k: l // block_size
                                for k, l in self.ring_len.items()}
        self.n_blocks = dict(n_blocks) if n_blocks else {
            k: n_slots * nb for k, nb in self.blocks_per_slot.items()}
        for k, nb in self.blocks_per_slot.items():
            if self.n_blocks.get(k, 0) < nb:
                raise ValueError(
                    f"n_blocks[{k!r}]={self.n_blocks.get(k)} cannot cover "
                    f"even one slot ({nb} blocks/slot) — no request could "
                    f"ever be admitted")

    def init_caches(self):
        return tf.init_paged_caches(self.cfg, self.n_slots, self.block_size,
                                    self.n_blocks, device=self.device)

    def covered_blocks(self, max_pos: int) -> Dict[str, int]:
        """Per-kind count of table blocks that can hold any entry a slot at
        position <= max_pos could have written: ring slots only reach
        min(max_pos + 1, ring_len), so blocks past that prefix are dead and
        the engine slices them off the device tables. Bucketed to powers
        of two to bound the number of table shapes."""
        need = max(1, max_pos + 1)
        out = {}
        for kind, nb in self.blocks_per_slot.items():
            k = -(-min(need, self.ring_len[kind]) // self.block_size)
            b = 1
            while b < k:
                b *= 2
            out[kind] = min(b, nb)
        return out

    def _ring_len(self, kind):
        return self.ring_len[kind]

    def _dest(self, kind, slots, entries, host_tables):
        bs = self.block_size
        return host_tables[kind][slots, entries // bs], entries % bs

    def _logits(self, params, caches, tables, tokens, positions):
        return tf.decode_step_paged(params, tokens, positions, caches, tables,
                                    self.cfg, ring_lens=self.ring_len)

    def decode_spec(self, params, caches, tables, tokens: Tensor,
                    positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """One draft/verify step. tokens [B, Q]: column 0 the last committed
        token, 1..Q-1 the drafts. Returns (greedy [B, Q], logits [B, Q, V],
        keep [B]): greedy[:, t] is the token greedy decode emits after
        accepting tokens 0..t; keep in 1..Q is how many input tokens stand
        (the committed one and the accepted drafts) — the engine commits
        greedy[:, :keep] and advances the positions by keep. Recurrent
        layers come back rolled back to the keep'th token."""
        if not self.spec_tokens:
            raise ValueError("backend built without spec_tokens")
        logits = tf.decode_step_spec(params, tokens, positions, caches,
                                     tables, self.cfg,
                                     ring_lens=self.ring_len)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        # draft t (tokens[:, t + 1]) stands iff every draft before it does
        # and it equals the target's greedy continuation greedy[:, t]
        match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
        keep = 1 + torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        self._select_spec_states(caches, keep)
        return greedy, logits, keep

    def _select_spec_states(self, caches, keep: Tensor) -> None:
        """Roll each recurrent layer back to the state of each slot's last
        kept token: decode_step_spec leaves every token's state stacked
        [Q, ...]; index keep - 1 of slot b's row becomes the layer's state
        (JAX _select_spec_states). Attention pools pass through (their
        stale entries are rewritten before any read)."""
        km1 = (keep - 1).to(torch.int64)
        rows = torch.arange(keep.shape[0], device=keep.device)
        for i, kind in enumerate(self.kinds):
            if kind not in tf.ATTN_KINDS:
                caches[i] = type(caches[i])(*(leaf[km1, rows]
                                              for leaf in caches[i]))


def make_backend(name: str, cfg: ArchConfig, n_slots: int, max_len: int,
                 block_size: int, device: torch.device,
                 n_blocks: Optional[Dict[str, int]] = None,
                 spec_tokens: int = 0) -> _Backend:
    if name == "dense":
        if spec_tokens:
            raise ValueError(
                "speculative decoding needs the paged backend (the dense "
                "ring writer is single-token)")
        return DenseBackend(cfg, n_slots, max_len, device)
    if name == "paged":
        return PagedBackend(cfg, n_slots, max_len, block_size, device,
                            n_blocks, spec_tokens)
    raise ValueError(f"unknown cache backend {name!r}")
