"""The port's attention-only LM families against the JAX package, on the CPU.

gemma-7b (MHA, GeGLU), codeqwen1.5-7b (qkv bias, untied head),
phi4-mini (GQA), mixtral-8x22b (MoE top-2, sliding window, untied head),
qwen2-moe-a2.7b (MoE top-4 with shared experts, qkv bias, untied head) and
internvl2-1b (the ViT patch prefix, qkv bias) at their smoke sizes, fp32,
the JAX package's `tf.init` parameters carried over by
`params_from_numpy`:

  * the port's init makes the JAX pytree's leaves (names, shapes, dtypes);
  * forward_prefill logits and every layer's K/V within 1e-4 of JAX's,
    CADC and dense linears;
  * paged decode steps on random pools with fragmented tables, slots past
    the local window: logits and appended pools within 1e-4 of
    decode_step_paged's;
  * inside the port the paged engine equals the dense one bitwise, tokens
    and logits, through eviction and slot reuse;
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
from repro_torch.models.lm import transformer as ttf
from repro_torch.serve import EngineConfig, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma_7b", "codeqwen15_7b", "phi4_mini_38b", "mixtral_8x22b",
         "qwen2_moe_a27b", "internvl2_1b"]


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


def _port_caches(jcaches, cfg):
    """The JAX package's paged caches ({"units", "tail"}, units stacked over
    the pattern's reps) as the port's per-layer pools, each with its sink
    block."""
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
        assert ("/layers/0/attn/wq/b" in names) == tcfg.attn_qkv_bias
        assert ("/layers/0/moe/router" in names) == (tcfg.moe.n_experts > 0)

    @pytest.mark.parametrize("linear_impl", ["cadc", "dense"])
    def test_prefill_logits_match_jax(self, arch, linear_impl):
        jcfg, jparams, tcfg, tree = _setup(arch, linear_impl)
        batch = _batch(jcfg, 2, 40, seed=0)
        want, contribs = jtf.forward_prefill(
            jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()},
            jcfg)
        got, tcontribs = ttf.forward_prefill(
            ttf.params_from_numpy(tree, tcfg, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        assert tuple(got.shape) == (2, 40, tcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        j_last = contribs["units"][0] if contribs["units"] else None
        for i, (k, v) in enumerate(tcontribs):
            jk, jv = (jax.tree_util.tree_map(lambda a: a[i], j_last)
                      if j_last is not None else contribs["tail"][i])
            np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)

    def test_paged_decode_logits_match_jax(self, arch):
        """Random pools, fragmented tables; slots at the start, mid ring and
        past the local window; four steps, each appending in place."""
        jcfg, jparams, tcfg, tree = _setup(arch)
        params = ttf.params_from_numpy(tree, tcfg, device="cpu")
        n_slots, max_len, bs = 3, 48, 16
        kinds = sorted(set(jcfg.pattern))
        ring = {k: tattn.cache_len(tcfg, k, max_len) for k in kinds}
        n_blocks = {k: n_slots * ring[k] // bs + 2 for k in kinds}
        rng = np.random.RandomState(3)
        jcaches = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32),
            jtf.init_paged_caches(jcfg, n_slots, bs, n_blocks, max_len))
        tables = {k: rng.permutation(n_blocks[k])[: n_slots * ring[k] // bs]
                  .astype(np.int32).reshape(n_slots, -1) for k in kinds}
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
        for got, want in zip(tcaches, _port_caches(jcaches, tcfg)):
            np.testing.assert_allclose(got.k.numpy(), want.k.numpy(), **TOL)
            np.testing.assert_allclose(got.v.numpy(), want.v.numpy(), **TOL)

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

