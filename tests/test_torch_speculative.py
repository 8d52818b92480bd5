"""The port's speculative decoding against plain greedy and the JAX package,
on the CPU.

gemma3-1b smoke config with CADC linears, fp32, 2 slots, staggered distinct
prompts (queueing, eviction and slot reuse on the speculative path). For
the n-gram proposer (K = 2) and the draft-model proposer (K = 3):

  * inside the port the committed streams equal spec_tokens=0 greedy decode
    token for token, and so do the logits, bitwise (an attention-only
    stack: the JAX package's docstring says the same of its own);
  * the streams and the `speculative` telemetry counts equal the JAX spec
    engine's (the draft model given the JAX draft's parameters);
  * decode_step_spec's logits match JAX's on the same paged caches within
    1e-4, and the headroom rings are JAX's.
On mixtral-8x22b's and qwen2-moe-a2.7b's smoke configs (MoE, untied
heads) the streams and counts equal the JAX spec engine's; greedy is not
the reference there (TestMoESpeculative).

The edges of tests/test_speculative.py: zero acceptance, full acceptance
across the eviction boundary, eos inside an accepted run, the ring
fail-fast and the rejections. NgramProposer proposes what JAX's does;
DraftModelProposer.propose leaves the draft caches bitwise unchanged.

On the recurrent archs (TestRecurrentSpeculative): recurrentgemma-9b's spec
engines under the n-gram, draft-model, oracle and anti-oracle proposers
(and xlstm-1.3b's under the n-gram one) give the JAX spec engine's streams
and counts; the anti-oracle's logits are bitwise plain greedy; and after a
verify step with mixed acceptance every slot's recurrent state is bitwise
the state `keep` sequential decode steps leave (the rollback).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import transformer as jtf
from repro.serve import DraftModelProposer as JDraftModelProposer
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import NgramProposer as JNgramProposer
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import backends as jbackends
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import transformer as ttf
from repro_torch.serve import (DraftModelProposer, EngineConfig,
                               NgramProposer, Proposer, Request, ServeEngine)
from repro_torch.serve import backends as tbackends

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
# (spec_draft, K) of the two proposers
PROPOSERS = [("ngram", 2), ("model", 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jsmoke("gemma3_1b", linear_impl="cadc")
    tcfg = tsmoke("gemma3_1b", linear_impl="cadc")
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    return jcfg, jparams, tcfg, ttf.params_from_numpy(tree, tcfg, "cpu")


def _workload(vocab, n=3, max_new=4):
    """Distinct prompts (the oracles key on them), staggered arrivals."""
    rng = np.random.RandomState(11)
    return [(i, rng.randint(0, vocab, size=(3 + i,)).astype(np.int32),
             max_new) for i in range(n)]


ECFG = dict(n_slots=2, max_len=32, block_size=16, backend="paged",
            telemetry_every=0)


def _run(workload, *, proposer=None, **kw):
    _, _, tcfg, params = _setup()
    eng = ServeEngine(tcfg, params, EngineConfig(
        **ECFG, record_logits=True, **kw), device="cpu")
    if proposer is not None:
        eng.proposer = proposer
    eng.run([(a, p.copy(), g) for a, p, g in workload])
    return eng


@functools.lru_cache(maxsize=None)
def _base(max_new=4, eos_token=None):
    return _run(_workload(_setup()[2].vocab_size, max_new=max_new),
                eos_token=eos_token)


def _jax_draft_tree(jeng):
    return jax.tree_util.tree_map(np.array, jeng.proposer.params)


@functools.lru_cache(maxsize=None)
def _jax_spec(draft, k):
    jcfg, jparams, _, _ = _setup()
    jeng = JServeEngine(jcfg, jparams, JEngineConfig(
        **ECFG, spec_tokens=k, spec_draft=draft))
    jeng.run([(a, p.copy(), g) for a, p, g in _workload(jcfg.vocab_size)])
    return jeng


@functools.lru_cache(maxsize=None)
def _port_spec(draft, k):
    proposer = None
    if draft == "model":
        # the JAX draft's parameters, so the two engines draft alike
        _, _, tcfg, _ = _setup()
        proposer = DraftModelProposer(
            k, tcfg, ECFG["n_slots"], ECFG["max_len"],
            params=_jax_draft_tree(_jax_spec(draft, k)), device="cpu")
    return _run(_workload(_setup()[2].vocab_size), proposer=proposer,
                spec_tokens=k, spec_draft=draft)


def _assert_streams_equal(spec, base):
    """Token streams and every token's logits, bitwise."""
    assert sorted(spec.results) == sorted(base.results)
    for rid in base.results:
        rs, rb = spec.results[rid], base.results[rid]
        assert rs.tokens == rb.tokens, f"req {rid}: diverged from greedy"
        assert len(rs.logits) == len(rb.logits)
        for i, (ls, lb) in enumerate(zip(rs.logits, rb.logits)):
            assert np.array_equal(ls, lb), (rid, i)


class OracleProposer(Proposer):
    """Replays a baseline run's streams (acceptance 1 until the cap), or
    with shift=1 those tokens + 1 mod vocab (acceptance exactly 0)."""

    def __init__(self, k, baseline, vocab, *, shift=0):
        super().__init__(k)
        self.vocab, self.shift = vocab, shift
        self.streams = [np.concatenate([r.prompt,
                                        np.asarray(r.tokens, np.int32)])
                        for r in baseline.results.values()]

    def propose(self, active, histories):
        out = np.zeros((len(histories), self.k), np.int32)
        for s, hist in enumerate(histories):
            if not active[s]:
                continue
            full = next(f for f in self.streams if f.size >= hist.size
                        and np.array_equal(f[: hist.size], hist))
            cont = full[hist.size: hist.size + self.k]
            cont = np.concatenate([cont,
                                   np.zeros(self.k - cont.size, np.int32)])
            out[s] = (cont + self.shift) % self.vocab
        return out


class TestGreedyParity:
    @pytest.mark.parametrize("draft,k", PROPOSERS)
    def test_streams_and_logits_bitwise_greedy(self, draft, k):
        """Through admission, eviction and slot reuse."""
        spec, base = _port_spec(draft, k), _base()
        _assert_streams_equal(spec, base)
        sp = spec.telemetry.summary()["speculative"]
        assert 0.0 <= sp["accept_rate"] <= 1.0
        assert 1.0 <= sp["tokens_per_step"] <= k + 1
        assert sum(spec.slot_uses) == 3 and max(spec.slot_uses) > 1

    @pytest.mark.parametrize("draft,k", PROPOSERS)
    def test_streams_and_counts_match_jax_engine(self, draft, k):
        jeng, teng = _jax_spec(draft, k), _port_spec(draft, k)
        assert sorted(jeng.results) == sorted(teng.results)
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens
        for key in ("spec_steps", "spec_drafted", "spec_accepted",
                    "spec_committed", "spec_slot_steps"):
            assert getattr(teng.telemetry, key) == getattr(jeng.telemetry,
                                                           key), key

    def test_zero_acceptance_degenerates_to_decode(self):
        """All drafts rejected: one committed token a step, the stream and
        the logits bitwise the plain decode's."""
        base = _base()
        anti = OracleProposer(3, base, base.cfg.vocab_size, shift=1)
        spec = _run(_workload(base.cfg.vocab_size), spec_tokens=3,
                    proposer=anti)
        _assert_streams_equal(spec, base)
        sp = spec.telemetry.summary()["speculative"]
        assert sp["accept_rate"] == 0.0 and sp["tokens_per_step"] == 1.0

    def test_full_acceptance_eviction_boundary(self):
        """Oracle drafts: slots commit K + 1 tokens a step and finish
        mid-draft (max_new = 5, not a multiple of 4): commits are capped,
        the slot is evicted with rejected-draft KV left behind, its blocks
        drain back for reuse."""
        base = _base(max_new=5)
        oracle = OracleProposer(3, base, base.cfg.vocab_size)
        spec = _run(_workload(base.cfg.vocab_size, max_new=5), spec_tokens=3,
                    proposer=oracle)
        _assert_streams_equal(spec, base)
        assert all(len(r.tokens) == 5 for r in spec.results.values())
        sp = spec.telemetry.summary()["speculative"]
        assert sp["accept_rate"] > 0.5 and sp["tokens_per_step"] > 1.5
        stats = spec.tables.stats()
        assert all(s["free"] == s["pool_blocks"] for s in stats.values())
        assert any(s["total_allocs"] > s["pool_blocks"]
                   for s in stats.values())

    def test_eos_truncates_inside_accepted_run(self):
        probe = _base(max_new=6)
        eos = probe.results[0].tokens[2]
        base = _base(max_new=6, eos_token=eos)
        oracle = OracleProposer(3, probe, probe.cfg.vocab_size)
        spec = _run(_workload(probe.cfg.vocab_size, max_new=6),
                    spec_tokens=3, proposer=oracle, eos_token=eos)
        _assert_streams_equal(spec, base)
        assert spec.results[0].tokens[-1] == eos
        assert len(spec.results[0].tokens) <= len(probe.results[0].tokens)


def _port_caches(jcaches, cfg):
    """The JAX package's paged caches ({"units", "tail"} of PagedKV, units
    stacked over the pattern's reps) in the port's per-layer list, each
    pool with its sink block."""
    p = len(cfg.pattern)
    units, tail = jcaches["units"], jcaches["tail"]
    reps = (cfg.n_layers - len(tail)) // p
    out = []
    for i in range(cfg.n_layers):
        c = (jax.tree_util.tree_map(lambda a: a[i // p], units[i % p])
             if i < reps * p else tail[i - reps * p])
        out.append(tattn.PagedKV(*(
            torch.cat([torch.as_tensor(np.array(a)),
                       torch.zeros((1,) + a.shape[1:])]) for a in c)))
    return out


@functools.lru_cache(maxsize=None)
def _moe_engines(arch, draft, k):
    """(JAX spec engine, port spec engine) on an MoE arch's smoke config,
    the port's draft model given the JAX draft's parameters."""
    jcfg = jsmoke(arch, linear_impl="cadc")
    tcfg = tsmoke(arch, linear_impl="cadc")
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    params = ttf.params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                                   tcfg, "cpu")
    wl = _workload(jcfg.vocab_size)
    jeng = JServeEngine(jcfg, jparams, JEngineConfig(
        **ECFG, spec_tokens=k, spec_draft=draft))
    jeng.run([(a, p.copy(), g) for a, p, g in wl])
    teng = ServeEngine(tcfg, params, EngineConfig(
        **ECFG, spec_tokens=k, spec_draft=draft), device="cpu")
    if draft == "model":
        teng.proposer = DraftModelProposer(
            k, tcfg, ECFG["n_slots"], ECFG["max_len"],
            params=_jax_draft_tree(jeng), device="cpu")
    teng.run([(a, p.copy(), g) for a, p, g in wl])
    return jeng, teng


class TestMoESpeculative:
    """A verify step of B x Q tokens routes with the capacity of B x Q
    (moe.capacity), which can drop pairs that Q single steps keep: an MoE
    spec stream need not equal greedy decode, in the JAX package too. The
    port's is held to the JAX spec engine's instead."""

    @pytest.mark.parametrize("draft,k", PROPOSERS)
    @pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen2_moe_a27b"])
    def test_streams_and_counts_match_jax_engine(self, arch, draft, k):
        jeng, teng = _moe_engines(arch, draft, k)
        assert sorted(jeng.results) == sorted(teng.results) == [0, 1, 2]
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens
        for key in ("spec_steps", "spec_drafted", "spec_accepted",
                    "spec_committed", "spec_slot_steps"):
            assert getattr(teng.telemetry, key) == getattr(jeng.telemetry,
                                                           key), key
        # the draft model of an untied arch carries its own head
        if draft == "model":
            assert "head" in teng.proposer.params


class TestModules:
    @pytest.mark.parametrize("k", [2, 3])
    def test_decode_step_spec_logits_match_jax(self, k):
        """Random pools, fragmented tables, slots at the start, the middle
        and past the local window: logits [B, K+1, V] and the appended
        pools within 1e-4 of JAX's."""
        jcfg, jparams, tcfg, params = _setup()
        n_slots, max_len, bs = 3, 32, 16
        jbe = jbackends.PagedBackend(jcfg, n_slots, max_len, bs,
                                     spec_tokens=k)
        rng = np.random.RandomState(3)
        jcaches = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32),
            jbe.init_caches())
        tables = {}
        for kind, nb in jbe.blocks_per_slot.items():
            perm = rng.permutation(jbe.n_blocks[kind]).astype(np.int32)
            tables[kind] = perm[: n_slots * nb].reshape(n_slots, nb)
        tokens = rng.randint(0, jcfg.vocab_size, size=(n_slots, k + 1))
        pos = np.array([0, 13, max_len - 1], np.int32)
        jlogits, jnew = jtf.decode_step_spec(
            jparams, jax.numpy.asarray(tokens.astype(np.int32)),
            jax.numpy.asarray(pos), jcaches,
            {kk: jax.numpy.asarray(v) for kk, v in tables.items()}, jcfg,
            ring_lens=jbe.ring_len)
        tcaches = _port_caches(jcaches, tcfg)
        tlogits = ttf.decode_step_spec(
            params, torch.as_tensor(tokens), torch.as_tensor(pos), tcaches,
            {kk: torch.as_tensor(v) for kk, v in tables.items()}, tcfg,
            ring_lens=jbe.ring_len)
        assert tuple(tlogits.shape) == tuple(jlogits.shape) == (
            n_slots, k + 1, tcfg.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        for got, want in zip(tcaches, _port_caches(jnew, tcfg)):
            np.testing.assert_allclose(got.k.numpy(), want.k.numpy(), **TOL)
            np.testing.assert_allclose(got.v.numpy(), want.v.numpy(), **TOL)

    def test_decode_step_spec_wants_two_tokens(self):
        _, _, tcfg, params = _setup()
        with pytest.raises(ValueError, match="Q >= 2"):
            ttf.decode_step_spec(params, torch.zeros(2, 1, dtype=torch.int64),
                                 torch.zeros(2), None, {}, tcfg)

    @pytest.mark.parametrize("max_len,k", [(32, 2), (64, 3), (40, 1),
                                           (64, 0)])
    def test_ring_len_equals_jax(self, max_len, k):
        jcfg, _, tcfg, _ = _setup()
        jbe = jbackends.PagedBackend(jcfg, 2, max_len, 16, spec_tokens=k)
        tbe = tbackends.PagedBackend(tcfg, 2, max_len, 16, CPU,
                                     spec_tokens=k)
        assert tbe.ring_len == jbe.ring_len
        assert tbe.blocks_per_slot == jbe.blocks_per_slot
        assert tbe.covered_blocks(max_len - 1 + k) == \
            jbe.covered_blocks(max_len - 1 + k)
        if k:
            assert tbe.ring_len["local"] >= tcfg.local_window + k
            assert tbe.ring_len["global"] >= max_len + k

    def test_append_beyond_ring_fails_fast(self):
        """Q = 9 tokens on an 8-entry ring would put two drafts on one
        entry: ValueError, not a corrupted cache."""
        cfg = tsmoke("gemma3_1b").with_overrides(local_window=8)
        gen = torch.Generator().manual_seed(0)
        p = tattn.attn_init(gen, cfg, CPU)
        pool = tattn.init_paged_pool(cfg, 1, 8, torch.float32, CPU)
        x = torch.zeros(1, 9, cfg.d_model)
        with pytest.raises(ValueError, match="ring"):
            tattn.attention_decode_paged(
                p, x, cfg, kind="local", position=torch.tensor([0]),
                cache=pool, block_table=torch.tensor([[0]], dtype=torch.int32))

    def test_dense_backend_rejects_spec(self):
        _, _, tcfg, params = _setup()
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16, backend="dense",
                spec_tokens=2), device="cpu")

    def test_decode_prefill_rejects_spec(self):
        _, _, tcfg, params = _setup()
        with pytest.raises(ValueError, match="batched"):
            ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16, prefill_mode="decode",
                spec_tokens=2), device="cpu")

    def test_backend_without_spec_rejects_decode_spec(self):
        _, _, tcfg, _ = _setup()
        be = tbackends.PagedBackend(tcfg, 2, 32, 16, CPU)
        with pytest.raises(ValueError, match="spec_tokens"):
            be.decode_spec(None, None, None, None, None)


class TestProposers:
    def test_ngram_proposals_equal_jax(self):
        """Seeded random histories over a small vocabulary (so n-grams
        repeat), every k and n-gram order; the fallback (no repeat) and the
        padding (a match near the end) included."""
        rng = np.random.RandomState(0)
        histories = [rng.randint(0, 5, size=rng.randint(1, 30))
                     .astype(np.int32) for _ in range(60)]
        histories += [np.array([3, 1, 4, 2], np.int32),     # fallback
                      np.array([1, 9, 1], np.int32),        # padding
                      np.array([7], np.int32)]               # one token
        active = np.ones(len(histories), bool)
        active[::7] = False
        hist_in = [h if a else None for h, a in zip(histories, active)]
        for k in (1, 2, 4):
            for n in (1, 2, 3):
                got = NgramProposer(k, max_ngram=n).propose(active, hist_in)
                want = JNgramProposer(k, max_ngram=n).propose(active,
                                                              hist_in)
                assert got.dtype == want.dtype == np.int32
                assert np.array_equal(got, want), (k, n)
        prop = NgramProposer(4, max_ngram=1)
        assert prop.propose(np.array([True]), [np.array([1, 9, 1])]
                            ).tolist() == [[9, 1, 1, 1]]
        assert NgramProposer(4).propose(np.array([True]), [np.array(
            [3, 1, 4, 2])]).tolist() == [[2, 2, 2, 2]]
        with pytest.raises(ValueError):
            NgramProposer(0)

    def test_draft_model_proposals_equal_jax(self):
        """Given the JAX draft's parameters, the port's draft model proposes
        what JAX's does, after an admission and after a commit that moves
        one slot only."""
        jcfg, _, tcfg, _ = _setup()
        jprop = JDraftModelProposer(3, jcfg, 2, 32)
        tprop = DraftModelProposer(
            3, tcfg, 2, 32, device="cpu",
            params=jax.tree_util.tree_map(np.array, jprop.params))
        rng = np.random.RandomState(4)
        reqs = []
        for cls in (JRequest, Request):
            r = np.random.RandomState(4)
            reqs.append([(s, cls(rid=s, prompt=r.randint(
                0, jcfg.vocab_size, size=5 + 3 * s).astype(np.int32),
                max_new=4, tokens=[int(r.randint(jcfg.vocab_size))]))
                for s in range(2)])
        jprop.on_admit(reqs[0])
        tprop.on_admit(reqs[1])
        active = np.array([True, True])
        for _ in range(2):
            got = tprop.propose(active, [None, None])
            want = jprop.propose(active, [None, None])
            assert np.array_equal(got, want)
            commit = [rng.randint(0, jcfg.vocab_size, size=2)
                      .astype(np.int32), None]
            jprop.on_commit(commit)
            tprop.on_commit(commit)
            assert tprop.pos.tolist() == jprop.pos.tolist()

    def test_draft_model_propose_leaves_caches_unchanged(self):
        """propose rolls out on a copy; on_commit advances only the slots
        that committed, leaving the others' rows bitwise as they were."""
        _, _, tcfg, _ = _setup()
        prop = DraftModelProposer(3, tcfg, 2, 32, device="cpu")
        base = _base()
        admitted = [(0, base.results[0]), (1, base.results[1])]
        prop.on_admit(admitted)

        def snap():
            return [(c.k.clone(), c.v.clone()) for c in prop.caches]

        def same(a, b):
            return all(torch.equal(x, y) for p, q in zip(a, b)
                       for x, y in zip(p, q))

        before, pos = snap(), prop.pos.copy()
        drafts = prop.propose(np.array([True, True]), [None, None])
        assert drafts.shape == (2, 3) and drafts.dtype == np.int32
        assert same(snap(), before) and np.array_equal(prop.pos, pos)
        again = prop.propose(np.array([True, True]), [None, None])
        assert np.array_equal(drafts, again)
        # slot 1 commits nothing: its rows stay; slot 0 advances by 2
        prop.on_commit([np.array([5, 6], np.int32), None])
        after = snap()
        assert prop.pos.tolist() == [pos[0] + 2, pos[1]]
        assert prop.last[0] == 6
        for (k0, v0), (k1, v1) in zip(before, after):
            assert torch.equal(k0[1], k1[1]) and torch.equal(v0[1], v1[1])
            assert not torch.equal(k0[0], k1[0])


@functools.lru_cache(maxsize=None)
def _setup_arch(arch):
    jcfg = jsmoke(arch, linear_impl="cadc")
    tcfg = tsmoke(arch, linear_impl="cadc")
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    return jcfg, jparams, tcfg, ttf.params_from_numpy(tree, tcfg, "cpu")


def _run_arch(arch, *, proposer=None, **kw):
    _, _, tcfg, params = _setup_arch(arch)
    eng = ServeEngine(tcfg, params, EngineConfig(
        **ECFG, record_logits=True, **kw), device="cpu")
    if proposer is not None:
        eng.proposer = proposer
    eng.run([(a, p.copy(), g) for a, p, g in _workload(tcfg.vocab_size)])
    return eng


@functools.lru_cache(maxsize=None)
def _base_arch(arch):
    return _run_arch(arch)


@functools.lru_cache(maxsize=None)
def _recurrent_engines(arch, draft, k):
    """(JAX spec engine, port spec engine) under one proposer: "ngram" and
    "model" as the engines build them (the port's draft model given the
    JAX draft's parameters), "oracle" / "anti" replaying the port's
    spec_tokens=0 streams in both."""
    jcfg, jparams, tcfg, params = _setup_arch(arch)
    wl = _workload(jcfg.vocab_size)
    replay = draft in ("oracle", "anti")

    def oracle():
        base = _base_arch(arch)
        return OracleProposer(k, base, tcfg.vocab_size,
                              shift=int(draft == "anti"))

    jeng = JServeEngine(jcfg, jparams, JEngineConfig(
        **ECFG, spec_tokens=k, spec_draft="ngram" if replay else draft))
    if replay:
        jeng.proposer = oracle()
    jeng.run([(a, p.copy(), g) for a, p, g in wl])
    proposer = oracle() if replay else None
    if draft == "model":
        proposer = DraftModelProposer(
            k, tcfg, ECFG["n_slots"], ECFG["max_len"],
            params=_jax_draft_tree(jeng), device="cpu")
    teng = _run_arch(arch, proposer=proposer, spec_tokens=k,
                     spec_draft="ngram" if replay else draft)
    return jeng, teng


class TestRecurrentSpeculative:
    @pytest.mark.parametrize("arch,draft", [
        ("recurrentgemma_9b", "ngram"), ("recurrentgemma_9b", "model"),
        ("recurrentgemma_9b", "oracle"), ("recurrentgemma_9b", "anti"),
        ("xlstm_13b", "ngram")])
    def test_streams_and_counts_match_jax_engine(self, arch, draft):
        jeng, teng = _recurrent_engines(arch, draft, 3)
        assert sorted(jeng.results) == sorted(teng.results) == [0, 1, 2]
        for rid in jeng.results:
            assert teng.results[rid].tokens == jeng.results[rid].tokens
        for key in ("spec_steps", "spec_drafted", "spec_accepted",
                    "spec_committed", "spec_slot_steps"):
            assert getattr(teng.telemetry, key) == getattr(jeng.telemetry,
                                                           key), key
        if draft == "anti":
            assert teng.telemetry.spec_accepted == 0
        if draft == "oracle":
            assert teng.telemetry.spec_accepted > 0

    @pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
    def test_anti_oracle_logits_are_plain_greedy(self, arch):
        """Every draft rejected: each verify step rolls every slot back to
        its first token's state; streams and logits bitwise plain greedy."""
        base = _base_arch(arch)
        anti = OracleProposer(3, base, base.cfg.vocab_size, shift=1)
        spec = _run_arch(arch, proposer=anti, spec_tokens=3)
        _assert_streams_equal(spec, base)
        assert spec.telemetry.spec_accepted == 0

    @pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
    def test_rollback_is_keep_sequential_steps(self, arch):
        """Three slots after a ragged prefill; drafts built from the
        sequential greedy continuation so that slot b keeps 1, 2 and 4
        tokens. After decode_spec each recurrent layer's row b is bitwise
        the state keep_b sequential decode steps leave (recurrent layers
        ahead of the attention layers: later ones see a Q-row attention
        product)."""
        from repro_torch.launch import steps as tsteps
        from repro_torch.serve.blocks import BlockTables

        _, _, tcfg, params = _setup_arch(arch)
        n, k = 3, 3
        be = tbackends.PagedBackend(tcfg, n, 32, 16, CPU, spec_tokens=k)
        caches = be.init_caches()
        tables = BlockTables(n, be.blocks_per_slot, be.n_blocks)
        for slot in range(n):
            tables.assign(slot)
        dev_tables = {kk: torch.as_tensor(v) for kk, v in
                      tables.tables.items()}
        rng = np.random.RandomState(9)
        lengths = np.array([5, 9, 7], np.int32)
        tokens = np.zeros((n, 9), np.int64)
        for b, m in enumerate(lengths):
            tokens[b, :m] = rng.randint(0, tcfg.vocab_size, size=m)
        first, _, contribs = tsteps.make_batched_prefill_step(tcfg)(
            params, {"tokens": torch.as_tensor(tokens)},
            torch.as_tensor(lengths))
        be.write_prefill(caches, contribs, np.arange(n, dtype=np.int32),
                         lengths, tables.tables)
        pos = torch.as_tensor(lengths.astype(np.int64))
        kinds = ttf.layout(tcfg)
        rec = range(next((i for i, kind in enumerate(kinds)
                          if kind in ttf.ATTN_KINDS), len(kinds)))
        assert len(rec) > 0

        seq = ttf.copy_caches(caches)
        fed, states = [first.long()], []
        for t in range(k + 1):
            nxt, _ = be.decode(params, seq, dev_tables, fed[-1], pos + t)
            fed.append(nxt.long())
            states.append(ttf.copy_caches(seq))
        greedy = torch.stack(fed, dim=1)                # [n, k + 2]
        drafts = greedy[:, 1:k + 1].clone()
        drafts[0] = (drafts[0] + 1) % tcfg.vocab_size   # keep 1
        drafts[1, 1:] = (drafts[1, 1:] + 1) % tcfg.vocab_size  # keep 2
        verify = torch.cat([greedy[:, :1], drafts], dim=1)
        g, _, keep = be.decode_spec(params, caches, dev_tables, verify, pos)
        assert keep.tolist() == [1, 2, 4]
        assert torch.equal(g[2], greedy[2, 1:])
        for b, kb in enumerate(keep.tolist()):
            for i in rec:
                for name, got, want in zip(type(caches[i])._fields,
                                           caches[i], states[kb - 1][i]):
                    assert got.shape == want.shape
                    assert torch.equal(got[b], want[b]), (i, name, b, kb)
