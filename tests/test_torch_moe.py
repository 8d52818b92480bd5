"""The port's MoE block against the JAX package's, on the CPU.

qwen2-moe-a2.7b's smoke config (8 routed experts, top-4, 2 shared) with
and without its shared experts, fp32, CADC and dense expert banks, the
JAX package's `moe_init` parameters: outputs and the load-balance aux loss
within 1e-4 of `moe_apply`'s, and the router's expert ids equal to
jax.lax.top_k's. The cases cover a capacity small enough to drop pairs and
a router with two equal columns, whose tied probabilities top-k must
order lower expert first, as jax.lax.top_k does (torch.topk does not).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.configs import smoke_config as jsmoke
from repro.models.lm import moe as jmoe
from repro_torch.configs import MoEConfig
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import moe as tmoe
from repro_torch.models.lm import transformer as ttf

TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(linear_impl, n_shared, capacity_factor, tie):
    moe = dict(n_experts=8, top_k=4, d_expert=64, n_shared=n_shared,
               d_shared=96 if n_shared else 0,
               capacity_factor=capacity_factor)
    jcfg = jsmoke("qwen2_moe_a27b", linear_impl=linear_impl,
                  moe=JMoEConfig(**moe))
    tcfg = tsmoke("qwen2_moe_a27b", linear_impl=linear_impl,
                  moe=MoEConfig(**moe))
    jp = jax.tree_util.tree_map(np.array,
                                jmoe.moe_init(jax.random.PRNGKey(1), jcfg))
    if tie:
        jp["router"][:, 2] = jp["router"][:, 1]
    return jcfg, jp, tcfg


def _ids(router, x, k):
    """(port's, JAX's) top-k expert ids of tokens x under `router`."""
    logits = x.reshape(-1, x.shape[-1]) @ router
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    mine = tmoe._top_k(probs, k)[1].numpy()
    want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), k)[1]
    return probs, mine, np.asarray(want)


# (linear_impl, shared experts, capacity factor, tied router columns)
CASES = [("cadc", 2, 1.25, False), ("dense", 2, 1.25, False),
         ("cadc", 0, 1.25, False), ("cadc", 2, 0.25, False),
         ("dense", 0, 0.25, False), ("cadc", 2, 1.25, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_apply_matches_jax(case):
    jcfg, jp, tcfg = _setup(*case)
    x = np.random.RandomState(0).randn(2, 13, jcfg.d_model).astype(
        np.float32)
    want, want_aux = jmoe.moe_apply(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_apply(ttf.tree_map(torch.as_tensor, jp),
                              torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    probs, mine, ids = _ids(jp["router"], x, tcfg.moe.top_k)
    np.testing.assert_array_equal(mine, ids)
    if tcfg.moe.capacity_factor < 1.0:  # the case that must drop pairs
        per_expert = np.bincount(ids.reshape(-1), minlength=8)
        assert per_expert.max() > tmoe.capacity(26, tcfg)
    if case[3]:  # the tie is real, and it decided an order
        assert torch.equal(probs[:, 1], probs[:, 2])
        both = [(list(r).index(1), list(r).index(2)) for r in ids
                if 1 in r and 2 in r]
        assert both and all(i < j for i, j in both)


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3], [0.2, 0.2, 0.2, 0.2,
                                                      0.2]])
    w, e = tmoe._top_k(probs, 3)
    want_w, want_e = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert e.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("n_tokens", [1, 8, 26, 32, 1024])
def test_capacity_matches_jax(n_tokens):
    jcfg, _, tcfg = _setup("cadc", 2, 1.25, False)
    assert tmoe.capacity(n_tokens, tcfg) == jmoe.capacity(n_tokens, jcfg)
