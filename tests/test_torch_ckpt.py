"""The port's checkpoints against the JAX package's, on the CPU.

A checkpoint written by `repro_torch.ckpt` restores bitwise in
`repro.ckpt` and the other way round, on LeNet-5 and ResNet-18 (width 4)
params, BN state and AdamW state, with the same `__names__` (the
`jax.tree_util.keystr` of each leaf, dict keys sorted). keep_k GC, a stray
tmp file and mismatched targets behave as in the JAX package. The port's
CNN loop, stopped after a save and rerun on the same `ckpt_dir`, ends
bitwise where an unbroken run of its own ends (the JAX package's own
restart test fails on this tree, so the port is held to itself).
"""
import collections
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.models.cnn import lenet5 as jlenet
from repro.models.cnn import resnet18 as jresnet
from repro.train import optimizer as jopt
from repro_torch import ckpt as tckpt
from repro_torch.data import synthetic as tsyn
from repro_torch.models import common as tcm
from repro_torch.models.cnn import lenet5 as tlenet
from repro_torch.models.cnn import resnet18 as tresnet
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

MODELS = {"lenet5": (jlenet, {}), "resnet18": (jresnet, {"width": 4})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _jax_tree(model):
    """{"params", "model_state", "opt"} of a JAX model after one AdamW
    update (moments nonzero), as numpy."""
    mod, kw = MODELS[model]
    params, state = jax.jit(functools.partial(mod.init, **kw))(
        jax.random.PRNGKey(0))
    opt = jopt.adamw(1e-3)
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    _, opt_state = jax.jit(opt.update)(grads, opt.init(params), params,
                                       jnp.asarray(0))
    tree = {"params": params, "model_state": state, "opt": opt_state}
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(model):
    return tcm.params_from_numpy(_jax_tree(model), "cpu")


def _leaves_equal(got, want):
    gl = jax.tree_util.tree_leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_checkpoint_restores_bitwise_in_jax(model, tmp_path):
    jtree = _jax_tree(model)
    path = tckpt.save(str(tmp_path), 7, _port_tree(model), keep_k=2)
    assert os.path.basename(path) == "step_7.npz"
    like = jax.tree_util.tree_map(np.zeros_like, jtree)
    step, got = jckpt.restore(str(tmp_path), like)
    assert step == 7
    _leaves_equal(got, jtree)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_jax_checkpoint_restores_bitwise_in_port(model, tmp_path):
    jtree = _jax_tree(model)
    jckpt.save(str(tmp_path), 3, jtree)
    like = tcm.params_from_numpy(
        jax.tree_util.tree_map(np.zeros_like, jtree), "cpu")
    step, got = tckpt.restore(str(tmp_path), like)
    assert step == 3
    _leaves_equal(got, jtree)
    # the port's dicts keep the target's key order; leaves are tensors on
    # the target leaf's device
    assert list(got["params"]) == list(like["params"])
    leaf = got["params"]["c2" if model == "lenet5" else "stem"]["w"]
    assert isinstance(leaf, torch.Tensor) and leaf.device == torch.device(
        "cpu")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_names_equal_jax(model, tmp_path):
    tckpt.save(str(tmp_path / "t"), 1, _port_tree(model))
    jckpt.save(str(tmp_path / "j"), 1, _jax_tree(model))

    def names(d):
        with np.load(os.path.join(d, "step_1.npz")) as z:
            return json.loads(str(z["__names__"]))

    got, want = names(str(tmp_path / "t")), names(str(tmp_path / "j"))
    assert got == want
    assert "['params']['f1']['w']" in got or "['params']['stem']['w']" in got


NT = collections.namedtuple("NT", "k v")


def test_names_of_lists_tuples_and_namedtuples_equal_jax():
    """The flatten order of every node kind the JAX package's trees use:
    sorted dict keys, list / tuple indices, NamedTuple fields."""
    tree = {"b": [np.ones(2), (np.zeros(1), np.ones(3))],
            "a": {"z": np.ones(1), "c": NT(np.ones(4), np.zeros(2))},
            "e": {}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    names, leaves = tckpt.checkpoint._flatten(tree)
    assert names == [jax.tree_util.keystr(p) for p, _ in flat]
    assert all(a is b for a, b in zip(leaves, (v for _, v in flat)))
    back = tckpt.checkpoint._unflatten(tree, leaves)
    assert list(back) == ["b", "a", "e"] and isinstance(back["a"]["c"], NT)


def test_keep_k_gc_and_stray_tmp_ignored(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for step in (1, 2, 3, 4):
        tckpt.save(d, step, {"w": tree["w"] + step}, keep_k=2)
    assert tckpt.all_steps(d) == [3, 4]
    # a writer that crashed before its rename leaves only a tmp file
    with open(os.path.join(d, "tmp.9.npz"), "wb") as f:
        f.write(b"torn")
    assert tckpt.latest_step(d) == 4
    step, got = tckpt.restore(d, tree)
    assert step == 4 and torch.equal(got["w"], tree["w"] + 4)
    step, got = tckpt.restore(d, tree, step=3)
    assert step == 3 and torch.equal(got["w"], tree["w"] + 3)
    assert tckpt.all_steps(str(tmp_path / "none")) == []
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


@pytest.mark.parametrize("bad", ["name", "shape"])
def test_mismatched_target_raises(bad, tmp_path):
    tree = {"a": torch.zeros(2, 3), "b": {"c": torch.ones(4)}}
    tckpt.save(str(tmp_path), 1, tree)
    like = ({"a": torch.zeros(2, 3), "b": {"d": torch.ones(4)}}
            if bad == "name" else
            {"a": torch.zeros(3, 2), "b": {"c": torch.ones(4)}})
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(str(tmp_path), like)


def _train(model, steps, ckpt_dir=None):
    """The port's loop on the CPU: CADC relu at crossbar 64, AdamW,
    batch 4, a save every 2 steps when ckpt_dir is given."""
    mod, kw, spec = {
        "lenet5": (tlenet, {}, tsyn.ClassificationSpec(hw=28, channels=1)),
        "resnet18": (tresnet, {"width": 4},
                     tsyn.ClassificationSpec(hw=16, channels=3)),
    }[model]
    return tloop.train(
        init_fn=mod.init, apply_fn=mod.apply,
        batch_fn=tsyn.make_classification_dataset(spec, device="cpu"),
        mode=tcm.LayerMode(impl="cadc", crossbar_size=64),
        cfg=tloop.TrainConfig(steps=steps, batch_size=4, eval_every=1,
                              eval_batches=1, ckpt_dir=ckpt_dir,
                              ckpt_every=2, keep_k=2),
        init_kwargs=kw, device="cpu")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_kill_and_restart_is_bitwise_the_unbroken_run(model, tmp_path):
    d = str(tmp_path)
    unbroken = _train(model, 4)
    first = _train(model, 2, d)           # stops right after its save
    assert tckpt.all_steps(d) == [2]
    resumed = _train(model, 4, d)          # restores step 2, runs 2 and 3
    assert tckpt.all_steps(d) == [2, 4]
    assert [h["step"] for h in first["history"]] == [0, 1]
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert resumed["history"] == unbroken["history"][2:]
    for key in ("params", "state"):
        a = jax.tree_util.tree_leaves(
            resumed[key], is_leaf=lambda t: isinstance(t, torch.Tensor))
        b = jax.tree_util.tree_leaves(
            unbroken[key], is_leaf=lambda t: isinstance(t, torch.Tensor))
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    # the step-4 file holds the unbroken run's optimizer state
    opt = topt.adamw(1e-3).init(unbroken["params"])
    _, saved = tckpt.restore(d, {"params": unbroken["params"],
                                 "model_state": unbroken["state"],
                                 "opt": opt})
    assert all(torch.equal(x, y) for x, y in zip(
        tloop._flatten(saved["params"]), tloop._flatten(unbroken["params"])))
