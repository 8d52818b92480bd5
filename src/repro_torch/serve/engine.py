"""ServeEngine: continuous batching over the CADC decode path.

Port of repro.serve.engine. One engine iteration = (admit waiting
requests into free slots) -> (batched prefill for the admissions) -> (one
decode step across all slots). Every slot runs at its own position;
finished sequences are evicted, their slot and — under the paged backend
— their physical KV blocks immediately reusable. Admission is FIFO with
head-of-line blocking on slot/block availability.

Prefill modes:
  * 'batched' (default): one full-sequence forward for all admissions of
    the iteration (ragged prompt lengths, bucketed to powers of two);
    the first token falls out of the prefill logits.
  * 'decode': each prefill-phase slot feeds its next prompt token through
    the ordinary decode step (caches built by the decode step itself).

Speculative decoding (EngineConfig.spec_tokens = K > 0, paged backend and
batched prefill only): each decode step becomes a draft/verify step — a
proposer (serve.speculative) offers K tokens a slot, the target scores
all K + 1 positions in one multi-token `decode_step_spec`, and the longest
draft prefix matching the target's greedy continuations is committed with
the bonus token. The committed streams are those of spec_tokens=0 greedy
decode for any proposer (tests/test_torch_speculative.py).

Parameters are cast to the compute dtype once, at construction
(launch/steps.py). Caches live on `device` and are updated in place. An
admitted slot's recurrent state rows (rglru, mlstm, slstm layers) are put
back to their init state before its prefill (backends reset_slots): in
decode-mode prefill a slot would otherwise carry its last request's
state into the next one. A stack with no attention kind (xLSTM) has no
block tables and no pools.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.serve import backends as backends_lib
from repro_torch.serve.blocks import BlockTables
from repro_torch.serve.telemetry import Telemetry

IDLE, PREFILL, DECODE = "idle", "prefill", "decode"


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def make_prefill_batch(cfg: ArchConfig, n_slots: int, admitted,
                       device: torch.device):
    """Padded prefill inputs for an admission wave: (batch dict, lengths
    [n_slots], slot_ids [n_slots]) with sentinel rows (id == n_slots) for
    padding, which the cache writers drop. Prompt lengths are bucketed to
    powers of two so only a few shapes ever run. Shared by the engine and
    the draft-model proposer: the draft's cache frontier mirrors the
    target's only while the two prefill layouts are one."""
    s_pad = _bucket(max(r.prompt.size for _, r in admitted))
    if cfg.frontend == "vit":
        s_pad = max(s_pad, _bucket(cfg.frontend_len))
    tokens = np.zeros((n_slots, s_pad), np.int64)
    lengths = np.zeros(n_slots, np.int32)
    slot_ids = np.full(n_slots, n_slots, np.int32)
    for i, (slot, req) in enumerate(admitted):
        tokens[i, : req.prompt.size] = req.prompt
        lengths[i] = req.prompt.size
        slot_ids[i] = slot
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    if cfg.frontend == "vit":
        # the prefill overlays these onto the first frontend_len positions
        # (those positions are the image). Requests without patches get
        # zeros, and a prompt shorter than frontend_len lies wholly under
        # that zero image, as in the JAX package.
        patches = np.zeros((n_slots, cfg.frontend_len, cfg.frontend_dim),
                           np.float32)
        for i, (_, req) in enumerate(admitted):
            if req.patches is not None:
                patches[i] = req.patches
        batch["patches"] = torch.as_tensor(patches, device=device)
    return batch, lengths, slot_ids


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new: int
    arrival_step: int = 0
    # vit archs: image embeddings [frontend_len, frontend_dim] overlaying
    # the first frontend_len prompt positions; None -> zeros (text only)
    patches: Optional[np.ndarray] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_len: int = 256
    block_size: int = 16
    backend: str = "paged"            # 'paged' | 'dense'
    prefill_mode: str = "batched"     # 'batched' | 'decode'
    # psum-sparsity sample period (decode steps between taps; 0 = off).
    # None -> ArchConfig.serve_telemetry_every. Every sample re-runs one
    # decode step with kernel_impl='torch' to materialize psums.
    telemetry_every: Optional[int] = None
    record_logits: bool = False       # keep per-token logits (tests)
    eos_token: Optional[int] = None
    n_blocks: Optional[Dict[str, int]] = None  # paged pool sizes (per kind)
    # Speculative decoding: K > 0 drafts K tokens a slot a step and
    # verifies them in one multi-token step; the committed streams equal
    # spec_tokens=0 greedy decode. Paged backend + batched prefill only.
    spec_tokens: int = 0
    spec_draft: str = "ngram"         # 'ngram' | 'model' (serve.speculative)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig, *,
                 device=device_lib.DEFAULT_DEVICE):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        if ecfg.prefill_mode not in ("batched", "decode"):
            raise ValueError(f"bad prefill_mode {ecfg.prefill_mode!r}")
        if cfg.frontend == "vit" and ecfg.prefill_mode == "decode":
            raise ValueError("vit-frontend archs need prefill_mode='batched'")
        if ecfg.spec_tokens and ecfg.prefill_mode != "batched":
            # decode-mode prefill would interleave prompt tokens with
            # drafts inside one multi-token append
            raise ValueError("speculative decoding needs batched prefill")
        self.device = device_lib.resolve(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = tf.tree_map(lambda a: a.to(self.device),
                                   steps_lib.cast_compute(params, cfg))
        self.telemetry_every = (cfg.serve_telemetry_every
                                if ecfg.telemetry_every is None
                                else ecfg.telemetry_every)
        self.backend = backends_lib.make_backend(
            ecfg.backend, cfg, ecfg.n_slots, ecfg.max_len, ecfg.block_size,
            self.device, ecfg.n_blocks, ecfg.spec_tokens)
        self.proposer = None
        if ecfg.spec_tokens:
            from repro_torch.serve import speculative as spec_lib
            self.proposer = spec_lib.make_proposer(
                ecfg.spec_draft, ecfg.spec_tokens, cfg, ecfg.n_slots,
                ecfg.max_len, device=self.device)
        self.caches = self.backend.init_caches()
        self.tables: Optional[BlockTables] = None
        if ecfg.backend == "paged":
            self.tables = BlockTables(
                ecfg.n_slots, self.backend.blocks_per_slot,
                self.backend.n_blocks)
        self.telemetry = Telemetry()

        n = ecfg.n_slots
        self.slot_req: List[Optional[Request]] = [None] * n
        self.slot_phase = [IDLE] * n
        self.slot_pos = np.zeros(n, np.int32)
        self.slot_last = np.zeros(n, np.int32)
        self.slot_uses = np.zeros(n, np.int64)  # admissions per slot

        self.queue: deque[Request] = deque()
        self.results: Dict[int, Request] = {}
        self._next_rid = 0
        self._it = 0
        self._prefill_fn = steps_lib.make_batched_prefill_step(cfg)
        self._dev_tables_cache = {}

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, *,
               arrival_step: int = 0, rid: Optional[int] = None,
               patches: Optional[np.ndarray] = None) -> int:
        """Queue a request; `patches` [frontend_len, frontend_dim] are a
        vit arch's image embeddings (None: a zero image)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new > self.ecfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"max_len={self.ecfg.max_len}")
        if patches is not None:
            want = (self.cfg.frontend_len, self.cfg.frontend_dim)
            if self.cfg.frontend != "vit":
                raise ValueError(f"{self.cfg.name} takes no patches")
            if tuple(np.shape(patches)) != want:
                raise ValueError(f"patches must be {want}")
            if prompt.size < self.cfg.frontend_len:
                # the image occupies positions 0..frontend_len-1: a shorter
                # prompt would cache and attend a truncated image
                raise ValueError(
                    f"vit prompts must span the image prefix: need >= "
                    f"frontend_len={self.cfg.frontend_len} tokens, got "
                    f"{prompt.size}")
        if rid is None:
            rid = self._next_rid
        elif (rid in self.results
              or any(r.rid == rid for r in self.queue)
              or any(r is not None and r.rid == rid for r in self.slot_req)):
            raise ValueError(f"rid {rid} already in use")
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      arrival_step=arrival_step, patches=patches)
        # keep FIFO-by-arrival; re-sort only on out-of-order submission
        out_of_order = bool(self.queue) and (
            (self.queue[-1].arrival_step, self.queue[-1].rid)
            > (arrival_step, rid))
        self.queue.append(req)
        if out_of_order:
            self.queue = deque(sorted(
                self.queue, key=lambda r: (r.arrival_step, r.rid)))
        return rid

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.queue) or any(p != IDLE for p in self.slot_phase)

    def reset_metrics(self) -> None:
        """Restart telemetry, results, the step clock and allocator
        diagnostics between a warmup run and the measured run. The engine
        must be drained."""
        if self.has_work():
            raise RuntimeError("reset_metrics on a non-drained engine")
        self.telemetry = Telemetry()
        self.results = {}
        self._it = 0
        self.slot_uses[:] = 0
        if self.tables is not None:
            self.tables.reset_stats()

    def run(self, workload: Optional[Sequence[Tuple[int, np.ndarray, int]]]
            = None, *, max_steps: int = 100_000) -> Dict[str, Any]:
        """Drain `workload` [(arrival_step, prompt, max_new)] (plus anything
        already submitted) and return the telemetry summary."""
        for arrival, prompt, max_new in (workload or []):
            self.submit(prompt, max_new, arrival_step=arrival)
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        summary = self.telemetry.summary()
        summary["slot_uses"] = self.slot_uses.tolist()
        summary["telemetry_sample_every"] = self.telemetry_every
        if self.tables is not None:
            summary["blocks"] = self.tables.stats()
        return summary

    def step(self) -> None:
        it = self._it
        self._it += 1
        now = self.telemetry.now()
        for req in self.queue:  # sorted by arrival: stop at the future
            if req.arrival_step > it:
                break
            trace = self.telemetry.trace(req.rid)
            if trace.arrival_wall is None:
                trace.arrival_wall = now

        admitted = self._admit(it)
        if admitted:
            mask = np.zeros(self.ecfg.n_slots, bool)
            mask[[slot for slot, _ in admitted]] = True
            # recurrent slots restart from their init state; stale KV
            # needs no reset (ring masking never reads it)
            self.backend.reset_slots(self.caches, mask)
            if self.ecfg.prefill_mode == "batched":
                self._batched_prefill(admitted)
            if self.proposer is not None:
                self.proposer.on_admit(admitted)

        if not any(p != IDLE for p in self.slot_phase):
            return
        if self.telemetry_every and it % self.telemetry_every == 0:
            self._sample_sparsity()
        if self.ecfg.spec_tokens:
            self._spec_decode_step()
        else:
            self._decode_step()

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------

    def _admit(self, it: int) -> List[Tuple[int, Request]]:
        admitted = []
        while self.queue and self.queue[0].arrival_step <= it:
            try:
                slot = self.slot_phase.index(IDLE)
            except ValueError:
                break
            if self.tables is not None and not self.tables.assign(slot):
                break  # pool exhausted: head-of-line waits for an eviction
            req = self.queue.popleft()
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            self.slot_last[slot] = req.prompt[0]
            self.slot_phase[slot] = PREFILL
            self.slot_uses[slot] += 1
            admitted.append((slot, req))
            self._dev_tables_cache = {}  # tables changed -> re-upload
        return admitted

    def _evict(self, slot: int) -> None:
        req = self.slot_req[slot]
        trace = self.telemetry.trace(req.rid)
        trace.finish_wall = self.telemetry.now()
        trace.n_generated = len(req.tokens)
        req.done = True
        self.results[req.rid] = req
        self.slot_req[slot] = None
        self.slot_phase[slot] = IDLE
        if self.tables is not None:
            self.tables.release(slot)
            self._dev_tables_cache = {}

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        eos = (self.ecfg.eos_token is not None and req.tokens
               and req.tokens[-1] == self.ecfg.eos_token)
        out_of_room = self.slot_pos[slot] >= self.ecfg.max_len
        if len(req.tokens) >= req.max_new or eos or out_of_room:
            self._evict(slot)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _device_tables(self, covered: Optional[Dict[str, int]] = None):
        """Device block tables, optionally sliced to the covered-prefix
        block count per kind (dead-block skipping: blocks no slot position
        can reach are dropped from the decode step). Uploads are cached
        per prefix shape and invalidated on any table change."""
        if self.tables is None:
            return None
        key = None if covered is None else tuple(sorted(covered.items()))
        hit = self._dev_tables_cache.get(key)
        if hit is None:
            hit = {
                k: torch.as_tensor(np.ascontiguousarray(
                    v if covered is None else v[:, : covered[k]]),
                    device=self.device)
                for k, v in self.tables.tables.items()
            }
            self._dev_tables_cache[key] = hit
        return hit

    def _batched_prefill(self, admitted: List[Tuple[int, Request]]) -> None:
        batch, lengths, slot_ids = make_prefill_batch(
            self.cfg, self.ecfg.n_slots, admitted, self.device)

        t0 = time.perf_counter()
        first, last, contribs = self._prefill_fn(
            self.params, batch, torch.as_tensor(lengths, device=self.device))
        self.backend.write_prefill(
            self.caches, contribs, slot_ids, lengths,
            self.tables.tables if self.tables is not None else None)
        first_np = first.cpu().numpy()
        last_np = last.cpu().numpy() if self.ecfg.record_logits else None
        self.telemetry.record_prefill(time.perf_counter() - t0)

        now = self.telemetry.now()
        for i, (slot, req) in enumerate(admitted):
            tok = int(first_np[i])
            req.tokens.append(tok)
            if last_np is not None:
                req.logits.append(last_np[i])
            trace = self.telemetry.trace(req.rid)
            trace.first_token_wall = now
            if trace.arrival_wall is None:
                trace.arrival_wall = now
            self.slot_pos[slot] = req.prompt.size
            self.slot_last[slot] = tok
            self.slot_phase[slot] = DECODE
            self._maybe_finish(slot)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode_step(self) -> None:
        n = self.ecfg.n_slots
        tokens = np.zeros(n, np.int64)
        for s in range(n):
            if self.slot_phase[s] == DECODE:
                tokens[s] = self.slot_last[s]
            elif self.slot_phase[s] == PREFILL:
                tokens[s] = self.slot_req[s].prompt[self.slot_pos[s]]
        positions = self.slot_pos.astype(np.int64)

        # dead-block skipping: blocks past the covered prefix are provably
        # unread, so the decode step gets tables sliced to that prefix
        covered = None
        if self.tables is not None:
            active = [int(positions[s]) for s in range(n)
                      if self.slot_phase[s] != IDLE]
            covered = self.backend.covered_blocks(max(active, default=0))
        # table upload is admission-time bookkeeping (cached until the
        # allocator changes) — kept out of the measured decode step
        dev_tables = self._device_tables(covered)

        t0 = time.perf_counter()
        nxt, logits = self.backend.decode(
            self.params, self.caches, dev_tables,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(positions, device=self.device))
        nxt_np = nxt.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.ecfg.record_logits else None
        dt = time.perf_counter() - t0

        emitted = 0
        now = self.telemetry.now()
        for s in range(n):
            req = self.slot_req[s]
            if self.slot_phase[s] == DECODE:
                tok = int(nxt_np[s])
                req.tokens.append(tok)
                if logits_np is not None:
                    req.logits.append(logits_np[s])
                self.slot_last[s] = tok
                self.slot_pos[s] += 1
                emitted += 1
                self._maybe_finish(s)
            elif self.slot_phase[s] == PREFILL:
                self.slot_pos[s] += 1
                if self.slot_pos[s] == req.prompt.size:
                    tok = int(nxt_np[s])
                    req.tokens.append(tok)
                    if logits_np is not None:
                        req.logits.append(logits_np[s])
                    trace = self.telemetry.trace(req.rid)
                    trace.first_token_wall = now
                    if trace.arrival_wall is None:
                        trace.arrival_wall = now
                    self.slot_last[s] = tok
                    self.slot_phase[s] = DECODE
                    emitted += 1
                    self._maybe_finish(s)
        self.telemetry.record_step(dt, emitted)

    # ------------------------------------------------------------------
    # speculative decode (draft / verify)
    # ------------------------------------------------------------------

    def _spec_decode_step(self) -> None:
        """One draft/verify step: K proposer drafts a decoding slot, ONE
        multi-token decode_spec over all K + 1 positions, and the commit of
        the longest draft prefix matching the target's greedy continuations
        plus the bonus token. Every slot advances by its own count; commits
        are capped at max_new and cut after eos, so a slot can finish — and
        be evicted — mid-draft, with rejected-draft KV left behind that no
        later read sees (decode_step_spec)."""
        n, k = self.ecfg.n_slots, self.ecfg.spec_tokens
        active = np.array([p == DECODE for p in self.slot_phase])
        histories: List[Optional[np.ndarray]] = [None] * n
        for s in range(n):
            if active[s]:
                req = self.slot_req[s]
                histories[s] = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
        # drafting is part of the measured step: a draft model pays K
        # decode steps here (dt sums propose, verify and on_commit)
        t0 = time.perf_counter()
        drafts = self.proposer.propose(active, histories)
        dt = time.perf_counter() - t0

        tokens = np.zeros((n, k + 1), np.int64)
        for s in range(n):
            if active[s]:
                tokens[s, 0] = self.slot_last[s]
                tokens[s, 1:] = drafts[s]
        positions = self.slot_pos.astype(np.int64)

        covered = None
        if self.tables is not None:
            # the append writes (and its q tokens may read) up to position
            # base + k: cover the drafts, not just the base
            act_pos = [int(positions[s]) for s in range(n) if active[s]]
            covered = self.backend.covered_blocks(max(act_pos, default=0) + k)
        dev_tables = self._device_tables(covered)

        t0 = time.perf_counter()
        greedy, logits, keep = self.backend.decode_spec(
            self.params, self.caches, dev_tables,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(positions, device=self.device))
        greedy_np = greedy.cpu().numpy()
        keep_np = keep.cpu().numpy()
        logits_np = logits.cpu().numpy() if self.ecfg.record_logits else None
        dt += time.perf_counter() - t0

        emitted = accepted = 0
        committed: List[Optional[np.ndarray]] = [None] * n
        for s in range(n):
            if not active[s]:
                continue
            req = self.slot_req[s]
            accepted += int(keep_np[s]) - 1
            c = min(int(keep_np[s]), req.max_new - len(req.tokens))
            toks = greedy_np[s, :c]
            if self.ecfg.eos_token is not None:
                hits = np.flatnonzero(toks == self.ecfg.eos_token)
                if hits.size:
                    c = int(hits[0]) + 1
                    toks = toks[:c]
            committed[s] = toks
            req.tokens.extend(int(t) for t in toks)
            if logits_np is not None:
                req.logits.extend(logits_np[s, i] for i in range(c))
            self.slot_last[s] = int(toks[-1])
            self.slot_pos[s] += c
            emitted += c
        t0 = time.perf_counter()
        self.proposer.on_commit(committed)
        dt += time.perf_counter() - t0
        n_active = int(active.sum())
        self.telemetry.record_step(dt, emitted)
        self.telemetry.record_spec(n_active * k, accepted, emitted, n_active)
        for s in range(n):
            if active[s]:
                self._maybe_finish(s)

    # ------------------------------------------------------------------
    # telemetry probe
    # ------------------------------------------------------------------

    def _sample_sparsity(self) -> None:
        """One decode step on a copy of the caches with the plain linears
        (the only path that materializes psums) and the psum tap open over
        the active slots' rows."""
        if self.cfg.linear_impl != "cadc":
            return
        ucfg = self.cfg.with_overrides(kernel_impl="torch",
                                       paged_attn_impl="torch")
        caches = tf.copy_caches(self.caches)
        n = self.ecfg.n_slots
        active = [self.slot_phase[s] != IDLE for s in range(n)]
        tokens = torch.as_tensor(np.array(
            [self.slot_last[s] if active[s] else 0 for s in range(n)],
            np.int64), device=self.device)
        positions = torch.as_tensor(self.slot_pos.astype(np.int64),
                                    device=self.device)
        rows = torch.as_tensor(active, device=self.device)
        with ll.psum_stats_tap(rows) as tap:
            if self.tables is not None:
                tf.decode_step_paged(self.params, tokens, positions, caches,
                                     self._device_tables(), ucfg,
                                     ring_lens=self.backend.ring_len)
            else:
                tf.decode_step(self.params, tokens, positions, caches, ucfg)
            recs = list(tap)
        self.telemetry.record_sparsity({
            r["label"]: {"gate_off": float(r["gate_off"]),
                         "exact_zero": float(r["exact_zero"]),
                         "segments": r["segments"]}
            for r in recs
        })

