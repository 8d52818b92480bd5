"""The port's LM train step, its CLI and its checkpoints against the JAX
package, on the CPU (gemma3-1b's smoke config, CADC linears, fp32; the
train step and the port's checkpoints also on recurrentgemma-9b's and
xlstm-1.3b's).

  * steps.make_train_step against the JAX package's make_train_step
    (jitted, no mesh) at n_micro 1 and 2: the losses of 3 steps and the
    parameters after steps 1 and 3 within 1e-4 — under make_optimizer's
    warmup (lr 0 at step 0) and under a constant AdamW lr of 1e-3, where
    the update is about lr * sign(grad) and the parameters after 3 steps
    differ by ~5e-6 (AdamW's normalisation does not make the bound
    ill-conditioned at these sizes);
  * make_prefill_step's next-token logits against JAX's;
  * an LM checkpoint ({"params", "opt"}, the JAX layout) written by the
    port is restored bitwise by repro.ckpt.restore (for the recurrent
    configs too: their raw leaves lam, conv and r_gates), and one written
    by the JAX package by the port's train CLI;
  * the train CLI stopped after its step-2 save and started again resumes to
    step 4 bitwise the unbroken run (params, AdamW moments, losses);
  * the watchdog raises on a step past its timeout; the twin of
    examples/lm_cadc_train.py runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import smoke_config as jsmoke
from repro.launch import steps as jsteps
from repro.models.lm import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch import ckpt as tckpt
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.launch import lm_cadc_train
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import transformer as ttf
from repro_torch.train import optimizer as topt

ARCH = "gemma3_1b"
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _cfgs(arch=ARCH):
    return tsmoke(arch, linear_impl="cadc"), jsmoke(arch, linear_impl="cadc")


def _tokens(step, b=4, s=32):
    rng = np.random.RandomState(100 + step)
    return rng.randint(0, _cfgs()[0].vocab_size, (b, s + 1)).astype(np.int32)


def _max_abs(tp, jp, cfg) -> float:
    a = jax.tree_util.tree_leaves(ttf.params_to_numpy(tp, cfg))
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert len(a) == len(b)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("n_micro,lr", [(1, None), (2, None), (2, 1e-3)],
                         ids=["micro1-warmup", "micro2-warmup",
                              "micro2-lr1e-3"])
def test_train_step_matches_jax(n_micro, lr):
    _train_step_parity(ARCH, n_micro, lr)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
@pytest.mark.parametrize("n_micro,lr", [(1, None), (2, 1e-3)],
                         ids=["micro1-warmup", "micro2-lr1e-3"])
def test_recurrent_train_step_matches_jax(arch, n_micro, lr):
    """The recurrent configs (xlstm at S = 32: the sequential mLSTM)."""
    _train_step_parity(arch, n_micro, lr)


def _train_step_parity(arch, n_micro, lr):
    tcfg, jcfg = _cfgs(arch)
    t_opt = topt.adamw(lr) if lr else tsteps.make_optimizer(tcfg)
    j_opt = jopt.adamw(lr) if lr else jsteps.make_optimizer(jcfg)
    tstep = tsteps.make_train_step(tcfg, t_opt, n_micro=n_micro)
    jstep = jax.jit(jsteps.make_train_step(jcfg, j_opt, n_micro=n_micro))
    tp = ttf.init(tcfg, seed=0, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, ttf.params_to_numpy(tp, tcfg))
    ts, js = t_opt.init(tp), j_opt.init(jp)
    first = tp
    for step in range(3):
        toks = _tokens(step)
        tb = {"tokens": torch.as_tensor(toks[:, :-1]).long(),
              "labels": torch.as_tensor(toks[:, 1:]).long()}
        jb = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
        tp, ts, tm = tstep(tp, ts, tb, step)
        jp, js, jm = jstep(jp, js, jb, jnp.asarray(step, jnp.int32))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=TOL, abs=TOL)
        if step in (0, 2):
            assert _max_abs(tp, jp, tcfg) <= TOL, f"params after {step + 1}"
    # the step returns new tensors and leaves its inputs as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tsteps._leaves(first), tsteps._leaves(ttf.init(tcfg, seed=0,
                                                       device="cpu"))))
    if lr:  # the parameters moved: the update reached the masters
        assert _max_abs(tp, ttf.params_to_numpy(first, tcfg), tcfg) > 1e-3


def test_prefill_step_matches_jax():
    tcfg, jcfg = _cfgs()
    tp = ttf.init(tcfg, seed=0, device="cpu")
    toks = _tokens(0)[:, :-1]
    got = tsteps.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(
        toks).long()})
    want = jsteps.make_prefill_step(jcfg)(ttf.params_to_numpy(tp, tcfg),
                                         {"tokens": jnp.asarray(toks)})
    assert got.shape == (4, tcfg.vocab_size) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _train_cli(steps, ckpt_dir=None, extra=(), arch=ARCH):
    argv = ["--arch", arch, "--smoke", "--cadc", "--crossbar", "64",
            "--steps", str(steps), "--batch", "4", "--seq", "32",
            "--microbatch", "2", "--log-every", "1", "--device", "cpu",
            *extra]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2", "--keep-k", "2"]
    return ttrain.main(argv)


def _equal_trees(a, b) -> bool:
    """Same names (sorted keys) and bitwise-equal leaves."""
    (na, la), (nb, lb) = tckpt.checkpoint._flatten(a), \
        tckpt.checkpoint._flatten(b)
    return na == nb and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_port_lm_checkpoint_restores_bitwise_in_jax(tmp_path):
    _port_checkpoint_in_jax(ARCH, tmp_path)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_13b"])
def test_recurrent_port_lm_checkpoint_restores_bitwise_in_jax(arch,
                                                               tmp_path):
    _port_checkpoint_in_jax(arch, tmp_path)


def _port_checkpoint_in_jax(arch, tmp_path):
    tcfg, jcfg = _cfgs(arch)
    out = _train_cli(2, str(tmp_path), arch=arch)
    assert tckpt.all_steps(str(tmp_path)) == [2]
    shapes = jax.eval_shape(lambda k: jtf.init(k, jcfg),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    like = {"params": zeros, "opt": jopt.adamw(1e-3).init(zeros)}
    step, got = jckpt.restore(str(tmp_path), like)
    assert step == 2
    want = {"params": ttf.params_to_numpy(out["params"], tcfg),
            "opt": {k: ttf.params_to_numpy(v, tcfg)
                    for k, v in out["opt_state"].items()}}
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) == 3 * len(jax.tree_util.tree_leaves(zeros))
    assert all(np.asarray(x).dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(gl, wl))


def test_jax_lm_checkpoint_restores_bitwise_in_port(tmp_path):
    tcfg, jcfg = _cfgs()
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init(jax.random.PRNGKey(3), jcfg))
    jstate = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5, jopt.adamw(1e-3).init(jparams))
    jckpt.save(str(tmp_path), 5, {"params": jparams, "opt": jstate})
    params = ttf.init(tcfg, seed=0, device="cpu")
    opt = topt.adamw(1e-3).init(params)
    step, p, o = ttrain.restore(str(tmp_path), params, opt, tcfg, "cpu")
    assert step == 5
    assert _equal_trees(p, ttf.params_from_numpy(jparams, tcfg, "cpu"))
    for k in ("m", "v"):
        assert _equal_trees(o[k], ttf.params_from_numpy(jstate[k], tcfg,
                                                        "cpu"))


def test_train_cli_stopped_and_restarted_is_bitwise_the_unbroken_run(tmp_path):
    d = str(tmp_path)
    unbroken = _train_cli(4)
    first = _train_cli(2, d)                  # stops right after its save
    resumed = _train_cli(4, d)                # restores step 2, runs 2 and 3
    assert tckpt.all_steps(d) == [2, 4]
    assert [h["step"] for h in first["history"]] == [0, 1]
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert ([h["loss"] for h in resumed["history"]]
            == [h["loss"] for h in unbroken["history"][2:]])
    assert _equal_trees(resumed["params"], unbroken["params"])
    assert _equal_trees(resumed["opt_state"], unbroken["opt_state"])


def test_watchdog_raises_on_a_slow_step():
    import time

    with pytest.raises(TimeoutError, match="exceeded"):
        with ttrain.StepWatchdog(0.05):
            time.sleep(1.0)
    with ttrain.StepWatchdog(5.0):  # a step inside its limit
        pass


def test_lm_cadc_train_twin_runs():
    out = lm_cadc_train.main(["--steps", "4", "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert out["cfg"].linear_impl == "cadc" and out["cfg"].crossbar_size == 64
