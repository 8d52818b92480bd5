"""LM training in the port against the JAX package, on the CPU.

Every attention-only smoke config (gemma3-1b, gemma-7b, codeqwen1.5-7b,
phi4-mini, mixtral-8x22b, qwen2-moe-a2.7b, internvl2-1b),
hubert-xlarge's encoder (audio frames, bidirectional attention, the gelu
FFN, an untied head) and the recurrent ones (recurrentgemma-9b: RG-LRU
and local attention; xlstm-1.3b: mLSTM and sLSTM, at S = 80 the
sequential mLSTM, and as "xlstm_13b.chunk16" at mlstm_chunk 16 and S = 64
the chunkwise one), CADC linears, fp32, TF32 off. The port draws the
parameters; `params_to_numpy` hands them to JAX in its `tf.init` layout,
so both packages run on the same values. JAX runs its default
kernel_impl="xla" (the oracle); the port its plain path. Tolerance: the
JAX package's fp32 bound, 1e-4 of scale (tests/test_kernel_grads.py TOL).

  * params_to_numpy is the JAX tree (names, shapes, dtypes of
    jax.eval_shape(tf.init)) and params_from_numpy's inverse, bitwise;
  * forward_train's logits and aux loss and lm_loss's loss / ce / acc,
    labels partly masked (-1);
  * the loss (lm_loss + 0.01 * aux, the train step's) and every gradient
    against jax.value_and_grad of the same loss;
  * remat on and off give bitwise-equal gradients;
  * make_lm_dataset's chain equals JAX's token for token, fed the starts
    and noise jax.random draws as src/repro/data/synthetic.py does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.data import synthetic as jsyn
from repro.models.lm import transformer as jtf
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.data import synthetic as tsyn
from repro_torch.models.lm import transformer as ttf

ARCHS = ["gemma3_1b", "gemma_7b", "codeqwen15_7b", "phi4_mini_38b",
         "mixtral_8x22b", "qwen2_moe_a27b", "internvl2_1b", "hubert_xlarge",
         "recurrentgemma_9b", "xlstm_13b"]
# each arch, and xlstm at mlstm_chunk 16 over S = 64 (4 chunks: the
# chunkwise mLSTM; at S = 80 and the default chunk of 256 it scans)
CASES = ARCHS + ["xlstm_13b.chunk16"]
VARIANTS = {"chunk16": ({"mlstm_chunk": 16}, 64)}
TOL = 1e-4
B, S = 2, 80  # gemma3's smoke window is 32 and its q chunk 64: both bite


@pytest.fixture(autouse=True, scope="module")
def _fp32_one_thread():
    prev = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(prev[0])
    torch.backends.cuda.matmul.allow_tf32 = prev[1]
    torch.backends.cudnn.allow_tf32 = prev[2]


def _batch(cfg, s=S, seed=0):
    """numpy batch: tokens (or frames), patches for vit, labels with every
    fifth position and one whole row tail masked."""
    rng = np.random.RandomState(seed)
    s = max(s, cfg.frontend_len + 8) if cfg.frontend == "vit" else s
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = rng.randn(B, s, cfg.frontend_dim).astype(np.float32)
    else:
        out["tokens"] = rng.randint(0, cfg.vocab_size, (B, s)).astype(
            np.int32)
    if cfg.frontend == "vit":
        out["patches"] = rng.randn(B, cfg.frontend_len,
                                   cfg.frontend_dim).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[:, ::5] = -1
    labels[1, s // 2:] = -1
    out["labels"] = labels
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v).to(torch.int64) if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in batch.items()}


def _port_run(params, cfg, batch):
    """(logits, aux, loss, metrics, grads as the JAX tree) of the port."""
    live = ttf.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = []
    ttf.tree_map(leaves.append, live)
    tb = _torch_batch(batch)
    logits, aux = ttf.forward_train(
        live, {k: v for k, v in tb.items() if k != "labels"}, cfg)
    loss, metrics = ttf.lm_loss(logits, tb["labels"])
    loss = loss + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    gtree = ttf.tree_map(lambda _: next(it), live)
    return (logits.detach(), aux.detach(), loss.detach(), metrics,
            ttf.params_to_numpy(gtree, cfg))


@functools.lru_cache(maxsize=None)
def _case(case):
    arch, _, variant = case.partition(".")
    overrides, s = VARIANTS[variant] if variant else ({}, S)
    tcfg = tsmoke(arch, linear_impl="cadc").with_overrides(**overrides)
    jcfg = jsmoke(arch, linear_impl="cadc").with_overrides(**overrides)
    params = ttf.init(tcfg, seed=0, device="cpu")
    tree = ttf.params_to_numpy(params, tcfg)
    batch = _batch(tcfg, s)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    labels = jnp.asarray(batch["labels"])

    def jloss(p):
        logits, aux = jtf.forward_train(p, jb, jcfg)
        loss, metrics = jtf.lm_loss(logits, labels)
        return loss + 0.01 * aux, (logits, aux, metrics)

    (jl, (jlog, jaux, jm)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(tree)
    want = jax.tree_util.tree_map(np.asarray, (jl, jlog, jaux, jm, jg))
    return tcfg, jcfg, params, batch, want, _port_run(params, tcfg, batch)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: err / scale {err:.3g} > {TOL}"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_is_the_jax_tree(arch):
    tcfg, jcfg, params, *_ = _case(arch)
    tree = ttf.params_to_numpy(params, tcfg)
    shapes = jax.eval_shape(lambda k: jtf.init(k, jcfg),
                            jax.random.PRNGKey(0))
    got = jax.tree_util.tree_flatten_with_path(tree)
    want = jax.tree_util.tree_flatten_with_path(shapes)
    assert got[1] == want[1]  # the same treedef: names, tuples, dicts
    for (path, a), (_, s) in zip(got[0], want[0]):
        assert (a.shape, a.dtype) == (s.shape, s.dtype), \
            jax.tree_util.keystr(path)
    back = ttf.params_from_numpy(tree, tcfg, device="cpu")
    a, b = [], []
    ttf.tree_map(a.append, back)
    ttf.tree_map(b.append, params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", CASES)
def test_forward_train_and_lm_loss_match_jax(arch):
    *_, want, got = _case(arch)
    jl, jlog, jaux, jm, _ = want
    logits, aux, loss, metrics, _ = got
    assert logits.shape == jlog.shape and logits.dtype == torch.float32
    _close(logits, jlog, "logits")
    _close(aux, jaux, "aux")
    _close(loss, jl, "loss")
    _close(metrics["ce"], jm["ce"], "ce")
    assert float(metrics["acc"]) == pytest.approx(float(jm["acc"]), abs=0)
    assert not metrics["ce"].requires_grad


@pytest.mark.parametrize("arch", CASES)
def test_grads_match_jax_value_and_grad(arch):
    *_, want, got = _case(arch)
    gw = jax.tree_util.tree_flatten_with_path(want[4])
    gg = jax.tree_util.tree_flatten_with_path(got[4])
    assert gg[1] == gw[1]
    for (path, g), (_, w) in zip(gg[0], gw[0]):
        _close(g, w, f"grad {jax.tree_util.keystr(path)}")
    # hubert's token table is in the tree but takes no gradient
    if arch == "hubert_xlarge":
        assert not np.any(got[4]["embed"]["table"])


@pytest.mark.parametrize("arch", ["gemma3_1b", "qwen2_moe_a27b",
                                  "hubert_xlarge", "recurrentgemma_9b",
                                  "xlstm_13b", "xlstm_13b.chunk16"])
def test_remat_on_and_off_give_bitwise_grads(arch):
    tcfg, _, params, batch, _, got = _case(arch)
    assert tcfg.remat
    off = _port_run(params, tcfg.with_overrides(remat=False), batch)
    assert torch.equal(off[2], got[2])
    a, b = jax.tree_util.tree_leaves(off[4]), jax.tree_util.tree_leaves(got[4])
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _jax_draws(spec, step, batch_size):
    """The starts and noise of src/repro/data/synthetic.py:97-105."""
    key = jax.random.fold_in(jax.random.PRNGKey(spec.seed), step)
    first, noise = [], []
    for k in jax.random.split(key, batch_size):
        k0, kseq = jax.random.split(k)
        first.append(np.asarray(jax.random.randint(
            k0, (spec.order,), 0, spec.vocab_size)))
        noise.append(np.asarray(jax.random.uniform(kseq,
                                                   (spec.seq_len + 1,))))
    return np.stack(first), np.stack(noise)


@pytest.mark.parametrize("vocab,seq,order,seed,step", [
    (512, 64, 2, 0, 0), (262144, 48, 2, 3, 7), (64, 40, 3, 1, 2)])
def test_lm_chain_equals_jax_token_for_token(vocab, seq, order, seed, step):
    spec = jsyn.LMTokenSpec(vocab_size=vocab, seq_len=seq, seed=seed,
                            order=order)
    want = np.asarray(jsyn.make_lm_dataset(spec)(step, 3)["tokens"])
    first, noise = _jax_draws(spec, step, 3)
    got = tsyn.lm_chain(torch.as_tensor(first), torch.as_tensor(noise),
                        vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_lm_dataset_is_a_function_of_seed_and_step():
    spec = tsyn.LMTokenSpec(vocab_size=300, seq_len=20, seed=5)
    data = tsyn.make_lm_dataset(spec, device="cpu")
    a, b = data(4, 3)["tokens"], data(4, 3)["tokens"]
    assert a.shape == (3, 21) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, data(5, 3)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 300
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsyn.make_lm_dataset(spec, device="cuda")
