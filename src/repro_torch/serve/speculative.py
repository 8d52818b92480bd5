"""Draft proposers for the engine's speculative decoding.

Port of repro.serve.speculative. Each engine iteration a proposer offers K
draft tokens for every decoding slot; the TARGET model scores all K + 1
positions in one multi-token `decode_step_spec`, and the longest draft
prefix that matches the target's own greedy continuations is committed,
with the bonus token of the last scored position
(ServeEngine._spec_decode_step). The committed stream never depends on
the proposer: a rejected draft costs a verify lane, an accepted one saves
a decode step.

  * `NgramProposer` ("ngram") — prompt-lookup decoding: the tokens that
    followed the most recent earlier occurrence of the history's longest
    trailing n-gram. No model.
  * `DraftModelProposer` ("model") — a shrunk config of the target (fewer
    layers, the same vocabulary) runs K greedy decode steps a step. It
    keeps dense per-slot caches at the engine's COMMITTED frontier. The
    port writes caches in place, so `propose` rolls out on a copy of them
    (the JAX package relies on immutable arrays for that), and
    `on_commit` re-feeds the tokens the target committed under a per-slot
    mask: the caches never hold speculation the target rejected.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import transformer as tf
from repro_torch.serve import backends as backends_lib


class Proposer:
    """The interface the engine drives: `k` drafts a slot a step."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"need at least one draft token, got k={k}")
        self.k = k

    def on_admit(self, admitted: Sequence[Tuple[int, object]]) -> None:
        """Called after the target's batched prefill with the admitted
        [(slot, Request)]; Request.tokens[0] (the target's first token) is
        already there."""

    def propose(self, active: np.ndarray,
                histories: List[Optional[np.ndarray]]) -> np.ndarray:
        """[n_slots, k] int32 drafts. `histories[s]` is the committed stream
        (prompt + generated) of active slot s."""
        raise NotImplementedError

    def on_commit(self, committed: List[Optional[np.ndarray]]) -> None:
        """Called once a step with the tokens committed per slot (None for
        inactive slots): the only way a stateful proposer advances."""


class NgramProposer(Proposer):
    """Prompt-lookup decoding (arXiv:2304.04487-style, model-free).

    For n from `max_ngram` down to 1: take the history's trailing n-gram,
    find its most recent earlier occurrence, and propose the k tokens that
    followed it (padded with the last of them when the match sits near the
    end). With no match, repeat the last token."""

    def __init__(self, k: int, max_ngram: int = 3):
        super().__init__(k)
        if max_ngram < 1:
            raise ValueError("max_ngram must be >= 1")
        self.max_ngram = max_ngram

    def _propose_one(self, hist: np.ndarray) -> np.ndarray:
        k = self.k
        for n in range(min(self.max_ngram, hist.size - 1), 0, -1):
            win = np.lib.stride_tricks.sliding_window_view(hist, n)
            starts = np.flatnonzero((win == hist[-n:]).all(axis=1))
            starts = starts[starts < hist.size - n]  # earlier occurrences
            if starts.size == 0:
                continue
            i = int(starts[-1])  # the most recent match
            cont = hist[i + n: i + n + k]
            return np.concatenate(
                [cont, np.full(k - cont.size, cont[-1], hist.dtype)])
        return np.full(k, hist[-1], np.int32)

    def propose(self, active, histories):
        out = np.zeros((len(histories), self.k), np.int32)
        for s, hist in enumerate(histories):
            if active[s]:
                out[s] = self._propose_one(np.asarray(hist, np.int32))
        return out


def default_draft_config(cfg: ArchConfig) -> ArchConfig:
    """The target config shrunk to a cheap draft: half a pattern unit's
    layers (at least 1); vocabulary, widths and CADC settings unchanged."""
    return cfg.with_overrides(n_layers=max(1, len(cfg.pattern) // 2),
                              name=cfg.name + "-draft")


class DraftModelProposer(Proposer):
    """K sequential greedy decode steps of a shrunk draft model a step.

    State: dense per-slot caches and (pos, last) at the engine's committed
    frontier. `params` is the draft's parameters as the JAX package's
    `tf.init` pytree of numpy arrays (carried over by
    transformer.params_from_numpy); by default they are drawn from a
    torch.Generator seeded by `seed`."""

    def __init__(self, k: int, cfg: ArchConfig, n_slots: int, max_len: int,
                 *, draft_cfg: Optional[ArchConfig] = None, seed: int = 1,
                 params=None, device=device_lib.DEFAULT_DEVICE):
        super().__init__(k)
        self.cfg_d = draft_cfg or default_draft_config(cfg)
        if self.cfg_d.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg_d.vocab_size} != target vocab "
                f"{cfg.vocab_size}: proposals would not be target tokens")
        self.device = device_lib.resolve(device)
        self.n_slots = n_slots
        params = (tf.init(self.cfg_d, seed=seed, device=self.device)
                  if params is None else
                  tf.params_from_numpy(params, self.cfg_d, self.device))
        self.params = steps_lib.cast_compute(params, self.cfg_d)
        # + k: the draft rolls out past the committed frontier, and its
        # global rings must hold those positions without clip collisions
        self.backend = backends_lib.DenseBackend(self.cfg_d, n_slots,
                                                 max_len + k, self.device)
        self.caches = self.backend.init_caches()
        self.pos = np.zeros(n_slots, np.int64)
        self.last = np.zeros(n_slots, np.int64)
        self._prefill = steps_lib.make_batched_prefill_step(self.cfg_d)

    def _copy_caches(self) -> List[attn.KVCache]:
        return [attn.KVCache(c.k.clone(), c.v.clone()) for c in self.caches]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def on_admit(self, admitted) -> None:
        if not admitted:
            return
        from repro_torch.serve.engine import make_prefill_batch

        # the engine's own prefill-batch builder: the draft frontier
        # mirrors the target's only while the layouts match. Stale KV of a
        # reused slot needs no reset: ring masking never reads it.
        batch, lengths, slot_ids = make_prefill_batch(
            self.cfg_d, self.n_slots, admitted, self.device)
        _, _, contribs = self._prefill(self.params, batch,
                                       self._tensor(lengths))
        self.backend.write_prefill(self.caches, contribs, slot_ids, lengths,
                                   None)
        for slot, req in admitted:
            # the frontier tracks the TARGET's commits: its first token,
            # not the draft model's own prediction
            self.pos[slot] = req.prompt.size
            self.last[slot] = req.tokens[0]

    def propose(self, active, histories):
        del histories  # the draft caches ARE the history
        caches = self._copy_caches()  # the rollout's; self.caches stay
        tokens, pos = self._tensor(self.last), self._tensor(self.pos)
        drafts = []
        for _ in range(self.k):
            logits = tf.decode_step(self.params, tokens, pos, caches,
                                    self.cfg_d)
            tokens = torch.argmax(logits, dim=-1)
            drafts.append(tokens)
            pos = pos + 1
        return torch.stack(drafts, dim=1).to(torch.int32).cpu().numpy()

    def on_commit(self, committed) -> None:
        n = self.n_slots
        counts = np.array([0 if c is None else len(c) for c in committed])
        cmax = int(counts.max()) if counts.size else 0
        if cmax == 0:
            return
        # inputs = [previous last, committed[:-1]]; the new last committed
        # token is the next step's first input
        feed = np.zeros((cmax, n), np.int64)
        act = np.zeros((cmax, n), bool)
        for s, c in enumerate(committed):
            if counts[s]:
                inputs = np.concatenate([[self.last[s]],
                                         np.asarray(c[:-1], np.int64)])
                feed[: inputs.size, s] = inputs
                act[: inputs.size, s] = True
        for t in range(cmax):
            mask = self._tensor(act[t])
            old = self._copy_caches() if not act[t].all() else None
            tf.decode_step(self.params, self._tensor(feed[t]),
                           self._tensor(self.pos + t), self.caches,
                           self.cfg_d)
            if old is not None:  # slots with nothing to feed keep their rows
                m = mask.reshape(-1, 1, 1, 1)
                for c, o in zip(self.caches, old):
                    c.k.copy_(torch.where(m, c.k, o.k))
                    c.v.copy_(torch.where(m, c.v, o.v))
        for s, c in enumerate(committed):
            if counts[s]:
                self.pos[s] += counts[s]
                self.last[s] = int(np.asarray(c)[-1])


def make_proposer(name: str, k: int, cfg: ArchConfig, n_slots: int,
                  max_len: int, *, device=device_lib.DEFAULT_DEVICE,
                  **kw) -> Proposer:
    if name == "ngram":
        return NgramProposer(k, **kw)
    if name == "model":
        return DraftModelProposer(k, cfg, n_slots, max_len, device=device,
                                  **kw)
    raise ValueError(f"unknown draft proposer {name!r} "
                     "(expected 'ngram' or 'model')")
