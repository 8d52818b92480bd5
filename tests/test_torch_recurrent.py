"""The port's recurrent decode cells against the JAX package, on the CPU.

RG-LRU (recurrentgemma-9b's smoke config) and the xLSTM mLSTM and sLSTM
blocks (xlstm-1.3b's) at smoke size, fp32, CADC and dense linears, with
the JAX package's init parameters carried over as numpy arrays and inputs
made from a seed with numpy:

  * the depthwise conv step, rglru_decode, mlstm_decode and slstm_decode
    over 6 carried steps: every output and every state leaf within 1e-4;
  * the first step from the init state (m = -inf) is finite, and m comes
    out finite: exp(-inf) gives 0, not NaN;
  * the *_init_state shapes and dtypes are JAX's, and the port's layer
    inits make the JAX pytree's leaves (names, shapes, dtypes);
  * inside the port, a Q-token recurrent append (the verify step's) is
    bitwise Q one-token steps, every stacked state included, and the
    prefill's frozen rows keep their init state (-inf stays -inf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import rglru as jrg
from repro.models.lm import xlstm as jxl
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import rglru as trg
from repro_torch.models.lm import transformer as ttf
from repro_torch.models.lm import xlstm as txl

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
STEPS, B = 6, 3

# kind -> (config, JAX init / decode / init_state, port's)
CELLS = {
    "rglru": ("recurrentgemma_9b", jrg.rglru_init, jrg.rglru_decode,
              jrg.rglru_init_state, trg.rglru_init, trg.rglru_decode,
              trg.rglru_init_state, trg.RGLRUState),
    "mlstm": ("xlstm_13b", jxl.mlstm_init, jxl.mlstm_decode,
              jxl.mlstm_init_state, txl.mlstm_init, txl.mlstm_decode,
              txl.mlstm_init_state, txl.MLSTMState),
    "slstm": ("xlstm_13b", jxl.slstm_init, jxl.slstm_decode,
              jxl.slstm_init_state, txl.slstm_init, txl.slstm_decode,
              txl.slstm_init_state, txl.SLSTMState),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _walk(tree, path=""):
    """(path, shape, dtype name) of every leaf of nested dicts of torch
    tensors or JAX arrays."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    else:
        yield path, tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _setup(kind, linear_impl="cadc"):
    arch, jinit, _, _, _, _, _, _ = CELLS[kind]
    jcfg = jsmoke(arch, linear_impl=linear_impl)
    tcfg = tsmoke(arch, linear_impl=linear_impl)
    jp = jinit(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, _to_torch(jp)


def _tstate(kind, jstate):
    return CELLS[kind][7](*(torch.as_tensor(np.array(a)) for a in jstate))


def _assert_state_close(got, want):
    assert type(got)._fields == type(want)._fields
    for name, g, w in zip(type(got)._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("linear_impl", ["cadc", "dense"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_decode_matches_jax_over_carried_steps(kind, linear_impl):
    jcfg, tcfg, jp, tp = _setup(kind, linear_impl)
    _, _, jdec, jinit_state, _, tdec, _, _ = CELLS[kind]
    rng = np.random.RandomState(0)
    jstate = jinit_state(jcfg, B)
    tstate = _tstate(kind, jstate)
    for step in range(STEPS):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        jy, jstate = jdec(jp, jnp.asarray(x), jcfg, jstate)
        ty, tstate = tdec(tp, torch.from_numpy(x), tcfg, tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   err_msg=f"step {step}", **TOL)
        _assert_state_close(tstate, jstate)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_first_step_from_init_is_finite(kind):
    _, tcfg, _, tp = _setup(kind)
    _, _, _, _, _, tdec, tinit_state, _ = CELLS[kind]
    state = tinit_state(tcfg, B, CPU)
    if kind != "rglru":
        assert torch.isneginf(state.m).all()
    x = torch.from_numpy(np.random.RandomState(1).randn(
        B, 1, tcfg.d_model).astype(np.float32))
    y, new = tdec(tp, x, tcfg, state)
    assert torch.isfinite(y).all()
    for name, leaf in zip(type(new)._fields, new):
        assert torch.isfinite(leaf).all(), name


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_init_state_shapes_and_dtypes_are_jax(kind):
    jcfg, tcfg, _, _ = _setup(kind)
    _, _, _, jinit_state, _, _, tinit_state, _ = CELLS[kind]
    jstate, tstate = jinit_state(jcfg, 5), tinit_state(tcfg, 5, CPU)
    assert type(tstate)._fields == type(jstate)._fields
    for t, j in zip(tstate, jstate):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("linear_impl", ["cadc", "dense"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_layer_init_makes_the_jax_leaves(kind, linear_impl):
    _, tcfg, jp, _ = _setup(kind, linear_impl)
    tinit = CELLS[kind][4]
    mine = tinit(torch.Generator().manual_seed(0), tcfg, CPU)
    assert list(_walk(mine)) == list(_walk(jp))


def test_rglru_lambda_init_lands_a_in_range():
    """a = exp(-c softplus(Lambda) r) at r = 0.5 lies in [0.9, 0.999], as
    the JAX init intends."""
    tcfg = tsmoke("recurrentgemma_9b")
    p = trg.rglru_init(torch.Generator().manual_seed(0), tcfg, CPU)
    a = torch.exp(-trg.C_RGLRU * torch.nn.functional.softplus(p["lam"]) * 0.5)
    assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6


def test_conv1d_step_matches_jax():
    rng = np.random.RandomState(2)
    width, ch = 4, 24
    jp = jxl._causal_conv1d_init(jax.random.PRNGKey(3), width, ch)
    jp["b"] = jnp.asarray(rng.randn(ch).astype(np.float32))
    tp = _to_torch(jp)
    jbuf = jnp.zeros((B, width - 1, ch), jnp.float32)
    tbuf = torch.zeros(B, width - 1, ch)
    for _ in range(STEPS):
        x = rng.randn(B, ch).astype(np.float32)
        jy, jbuf = jxl._conv1d_step(jp, jbuf, jnp.asarray(x))
        ty, tbuf = txl._conv1d_step(tp, tbuf, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), **TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
def test_multi_token_append_is_sequential_steps(arch):
    """_recurrent_decode_multi at Q = 4: every token's output and stacked state
    bitwise one-token steps at the [B, 1, d] shape."""
    tcfg = tsmoke(arch, linear_impl="cadc")
    params = ttf.init(tcfg, seed=2, device="cpu")
    kind = tcfg.pattern[0]
    p = params["layers"][0]
    x = torch.from_numpy(np.random.RandomState(4).randn(
        B, 4, tcfg.d_model).astype(np.float32))
    state0 = ttf.init_layer_state(kind, tcfg, B, CPU)
    y, stacked = ttf._recurrent_decode_multi(p, x, kind, tcfg, state0)
    state = state0
    for t in range(4):
        yt, state = ttf._recurrent_layer(p, x[:, t:t + 1].contiguous(), kind,
                                         tcfg, state)
        assert torch.equal(y[:, t:t + 1], yt)
        for leaf, seq in zip(stacked, state):
            assert torch.equal(leaf[t], seq)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
def test_prefill_frozen_rows_keep_the_init_state(arch):
    """A row of length 0 (the engine's padding rows) keeps its init state
    through the prefill: -inf stabilizers stay -inf, nothing turns NaN;
    a row of length 1 holds the first step's state."""
    tcfg = tsmoke(arch, linear_impl="cadc")
    params = ttf.init(tcfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(3, 6)))
    logits, contribs = ttf.forward_prefill(
        params, {"tokens": tokens}, tcfg,
        lengths=torch.tensor([6, 0, 1]))
    assert torch.isfinite(logits).all()
    for kind, c in zip(ttf.layout(tcfg), contribs):
        if kind in ttf.ATTN_KINDS:
            continue
        init = ttf.init_layer_state(kind, tcfg, 1, CPU)
        for name, leaf, fresh in zip(type(c)._fields, c, init):
            assert not torch.isnan(leaf).any(), (kind, name)
            assert torch.equal(leaf[1], fresh[0]), (kind, name)
        if kind in ("mlstm", "slstm"):
            assert torch.isfinite(c.m[0]).all() and torch.isfinite(
                c.m[2]).all()
