"""The port's LM families against the JAX package, on the CPU.

gemma-7b (MHA, GeGLU), codeqwen1.5-7b (qkv bias, untied head),
phi4-mini (GQA), mixtral-8x22b (MoE top-2, sliding window, untied head),
qwen2-moe-a2.7b (MoE top-4 with shared experts, qkv bias, untied head),
internvl2-1b (the ViT patch prefix, qkv bias), recurrentgemma-9b (RG-LRU
with local MQA attention) and xlstm-1.3b (mLSTM and sLSTM blocks, no
attention, untied head) at their smoke sizes, fp32, the JAX package's
`tf.init` parameters carried over by `params_from_numpy`:

  * the port's init makes the JAX pytree's leaves (names, shapes, dtypes);
  * forward_prefill(lengths=) over ragged prompts: logits, every layer's
    K/V and every recurrent layer's final state within 1e-4 of JAX's,
    CADC and dense linears;
  * paged decode steps on random pools and random recurrent states with
    fragmented tables, slots past the local window: logits, appended
    pools and new states within 1e-4 of decode_step_paged's;
  * inside the port the paged engine equals the dense one bitwise, tokens
    and logits, through eviction and slot reuse;
  * the recurrent archs' prefill states are bitwise the states that
    feeding each prompt through decode_step leaves behind;
  * init(dtype=bf16) is bitwise cast_params(init(), bf16).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import transformer as jtf
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import rglru as trg
from repro_torch.models.lm import transformer as ttf
from repro_torch.models.lm import xlstm as txl
from repro_torch.serve import EngineConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma_7b", "codeqwen15_7b", "phi4_mini_38b", "mixtral_8x22b",
         "qwen2_moe_a27b", "internvl2_1b", "recurrentgemma_9b", "xlstm_13b"]
RECURRENT_ARCHS = ["recurrentgemma_9b", "xlstm_13b"]
STATES = {"rglru": trg.RGLRUState, "mlstm": txl.MLSTMState,
          "slstm": txl.SLSTMState}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _setup(arch, linear_impl="cadc"):
    jcfg = jsmoke(arch, linear_impl=linear_impl)
    tcfg = tsmoke(arch, linear_impl=linear_impl)
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    return jcfg, jparams, tcfg, tree


def _batch(cfg, b, s, seed):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, size=(b, s)).astype(
        np.int32)}
    if cfg.frontend == "vit":
        out["patches"] = rng.randn(b, cfg.frontend_len,
                                   cfg.frontend_dim).astype(np.float32)
    return out


def _walk(tree, path=""):
    """(path, leaf) of nested dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _leaves(tree):
    return [(p, tuple(a.shape), str(a.dtype)) for p, a in _walk(tree)]


def _layer_of(tree, i, cfg):
    """Layer i's subtree of a JAX {"units", "tail"} pytree (units stacked
    over the pattern's reps)."""
    p = len(cfg.pattern)
    units, tail = tree["units"], tree["tail"]
    reps = (cfg.n_layers - len(tail)) // p
    if i < reps * p:
        return jax.tree_util.tree_map(lambda a: a[i // p], units[i % p])
    return tail[i - reps * p]


def _port_caches(jcaches, cfg):
    """The JAX package's paged caches as the port's per-layer list: each
    attention pool with its sink block, each recurrent state as the port's
    state tuple."""
    out = []
    for i, kind in enumerate(cfg.pattern_for_layers):
        c = _layer_of(jcaches, i, cfg)
        if kind in STATES:
            out.append(STATES[kind](*(torch.as_tensor(np.array(a))
                                      for a in c)))
            continue
        out.append(tattn.PagedKV(*(
            torch.cat([torch.as_tensor(np.array(a)),
                       torch.zeros((1,) + a.shape[1:])]) for a in c)))
    return out


def _assert_caches_close(got, want):
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for name, a, b in zip(type(g)._fields, g, w):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                       **TOL)


@pytest.mark.parametrize("arch", ARCHS)
class TestModelParity:
    def test_init_makes_the_jax_leaves(self, arch):
        """init and params_from_numpy give one layout: a JAX-initialised
        pytree round-trips into the port's structure."""
        _, _, tcfg, tree = _setup(arch)
        mine = ttf.init(tcfg, device="cpu")
        carried = ttf.params_from_numpy(tree, tcfg, device="cpu")
        assert _leaves(mine) == _leaves(carried)
        names = {p for p, _, _ in _leaves(mine)}
        assert ("/head/w" in names) == (not tcfg.tie_embeddings)
        assert ("/frontend_proj/b" in names) == (tcfg.frontend == "vit")
        i = next((i for i, k in enumerate(tcfg.pattern_for_layers)
                  if k in ttf.ATTN_KINDS), None)
        assert (f"/layers/{i}/attn/wq/b" in names) == tcfg.attn_qkv_bias
        assert (f"/layers/{i}/moe/router" in names) == (
            tcfg.moe.n_experts > 0)
        for j, kind in enumerate(tcfg.pattern_for_layers):
            raw = {"rglru": ["rec/lam", "rec/conv/w", "ffn/w_up/w"],
                   "mlstm": ["block/conv/b", "block/w_if/b"],
                   "slstm": ["block/r_gates"]}.get(kind, [])
            assert all(f"/layers/{j}/{r}" in names for r in raw), kind

    @pytest.mark.parametrize("linear_impl", ["cadc", "dense"])
    def test_prefill_logits_match_jax(self, arch, linear_impl):
        """Ragged lengths: the recurrent states freeze at each prompt's own
        end (attention layers ignore them)."""
        jcfg, jparams, tcfg, tree = _setup(arch, linear_impl)
        batch = _batch(jcfg, 3, 40, seed=0)
        lengths = np.array([40, 17, 33], np.int32)
        want, contribs = jtf.forward_prefill(
            jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()},
            jcfg, lengths=jax.numpy.asarray(lengths))
        got, tcontribs = ttf.forward_prefill(
            ttf.params_from_numpy(tree, tcfg, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
            lengths=torch.from_numpy(lengths))
        assert tuple(got.shape) == (3, 40, tcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert len(tcontribs) == tcfg.n_layers
        for i, c in enumerate(tcontribs):
            jc = _layer_of(contribs, i, tcfg)
            assert len(c) == len(jc)
            for a, b in zip(c, jc):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    def test_paged_decode_logits_match_jax(self, arch):
        """Random pools, fragmented tables; slots at the start, mid ring and
        past the local window; four steps, each appending in place."""
        jcfg, jparams, tcfg, tree = _setup(arch)
        params = ttf.params_from_numpy(tree, tcfg, device="cpu")
        n_slots, max_len, bs = 3, 48, 16
        kinds = [k for k in sorted(set(jcfg.pattern)) if k in ttf.ATTN_KINDS]
        ring = {k: tattn.cache_len(tcfg, k, max_len) for k in kinds}
        n_blocks = {k: n_slots * ring[k] // bs + 2 for k in kinds}
        rng = np.random.RandomState(3)
        jcaches = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32),
            jtf.init_paged_caches(jcfg, n_slots, bs, n_blocks, max_len))
        tables = {k: rng.permutation(n_blocks[k])[: n_slots * ring[k] // bs]
                  .astype(np.int32).reshape(n_slots, -1) for k in kinds}
        if kinds:
            tables[kinds[0]][0, -1] = -1     # an unallocated block
        tcaches = _port_caches(jcaches, tcfg)
        pos = np.array([0, 13, max_len - 6], np.int32)
        step = jax.jit(functools.partial(jtf.decode_step_paged, cfg=jcfg,
                                         ring_lens=ring))
        jt = {k: jax.numpy.asarray(v) for k, v in tables.items()}
        tt = {k: torch.as_tensor(v) for k, v in tables.items()}
        for _ in range(4):
            tok = rng.randint(0, jcfg.vocab_size, size=n_slots)
            want, jcaches = step(jparams, jax.numpy.asarray(tok.astype(
                np.int32)), jax.numpy.asarray(pos), jcaches, jt)
            got = ttf.decode_step_paged(params, torch.as_tensor(tok),
                                        torch.as_tensor(pos), tcaches, tt,
                                        tcfg, ring_lens=ring)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            pos = pos + 1
        _assert_caches_close(tcaches, _port_caches(jcaches, tcfg))

    def test_paged_bit_identical_to_dense(self, arch):
        """The same schedule through both cache layouts: every token and
        every token's logits bitwise, through eviction and slot reuse
        (tests/test_serve_engine.py's invariant, on the port)."""
        _, _, tcfg, tree = _setup(arch)
        params = ttf.params_from_numpy(tree, tcfg, device="cpu")
        rng = np.random.RandomState(7)
        lo = tcfg.frontend_len if tcfg.frontend == "vit" else 3
        wl = [(i, rng.randint(0, tcfg.vocab_size, size=lo + i % 3).astype(
            np.int32), 3) for i in range(3)]
        runs = {}
        for backend in ("paged", "dense"):
            eng = ServeEngine(tcfg, params, EngineConfig(
                n_slots=2, max_len=32, block_size=16, backend=backend,
                record_logits=True), device="cpu")
            eng.run([(a, p.copy(), g) for a, p, g in wl])
            runs[backend] = eng.results
        assert sorted(runs["paged"]) == sorted(runs["dense"]) == [0, 1, 2]
        for rid, rp in runs["paged"].items():
            rd = runs["dense"][rid]
            assert rp.tokens == rd.tokens and len(rp.tokens) == 3
            for lp, ld in zip(rp.logits, rd.logits):
                assert np.array_equal(lp, ld)

    def test_init_in_bf16_is_cast_params(self, arch):
        tcfg = tsmoke(arch, linear_impl="cadc")
        direct = ttf.init(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
        cast = ttf.cast_params(ttf.init(tcfg, seed=3, device="cpu"),
                               torch.bfloat16)
        assert _leaves(direct) == _leaves(cast)
        for (_, a), (_, b) in zip(_walk(direct), _walk(cast)):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_prefill_state_is_the_decode_state(arch):
    """Every recurrent layer's prefill state, bitwise the state that
    feeding slot b's prompt through decode_step leaves in row b, for
    ragged prompts (the batch keeps its rows, so every GEMM keeps its
    row count). Recurrent layers ahead of any attention layer only:
    past one, the prefill's attention output is a [B, S] product."""
    _, _, tcfg, tree = _setup(arch)
    kinds = tcfg.pattern_for_layers
    first_attn = next((i for i, k in enumerate(kinds)
                       if k in ttf.ATTN_KINDS), len(kinds))
    assert first_attn > 0
    params = ttf.params_from_numpy(tree, tcfg, device="cpu")
    tokens = torch.from_numpy(_batch(tcfg, 3, 12, seed=6)["tokens"]
                              ).long()
    lengths = torch.tensor([12, 5, 9])
    _, contribs = ttf.forward_prefill(params, {"tokens": tokens}, tcfg,
                                      lengths=lengths)
    for b, n in enumerate(lengths.tolist()):
        caches = ttf.init_caches(tcfg, 3, 16, device="cpu")
        for t in range(n):
            ttf.decode_step(params, tokens[:, t], torch.tensor(t),
                            caches, tcfg)
        for i in range(first_attn):
            for name, a, c in zip(type(caches[i])._fields, caches[i],
                                  contribs[i]):
                assert torch.equal(a[b], c[b]), (i, name, b)
