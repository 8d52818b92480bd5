"""The port's parallel modules against the JAX package, on the CPU.

  * the sharding rules: param_specs for every architecture at full width,
    CADC off and on (crossbar 256; gemma3-1b also 128), on the local (4, 1),
    production (16, 16) and multi-pod (2, 16, 16) meshes — the JAX side on
    a stand-in mesh (axis_names and devices.shape are all its rules read),
    one eval_shape per config and layout shared by the meshes; batch_specs,
    cache_specs, paged_cache_specs and block_table_specs the same; the
    abstract params, optimizer state, caches and step inputs equal in shape
    and dtype. The port keeps its layers as a list, so its trees are
    stacked into the JAX layout (units / tail) first: a stacked leaf's spec
    is P(None, *the layer's spec), and the layers a unit stacks must agree;
  * the tensor-parallel CADC linear over 4 gloo ranks (the plain version
    on each) at the JAX test's sizes against JAX's single-device
    core.cadc.cadc_matmul: fp32 wire within 1e-5, bf16 wire relative error
    below 0.01 with bf16 handed to all_reduce, vConv within 1e-4 of x @ w,
    and a segment count the group does not divide refused (the JAX test's
    bounds);
  * the ternary store: codes bitwise JAX's and scales within 1e-6 relative
    on the JAX test's seeds, encode_tree picking the same leaves, the int8
    code shards gathered over 2 ranks (int8 on the wire) giving the
    unsharded product bitwise; DTensor's blocks under
    sharding.placements are fsdp.shard's.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_dist import run_ranks, ternary_rank, tp_cadc_rank
from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.core import cadc as jcadc
from repro.launch import steps as jsteps
from repro.models.lm import transformer as jtf
from repro.parallel import sharding as jshard
from repro.parallel import ternary_store as jts
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.lm import transformer as ttf
from repro_torch.parallel import sharding as tshard
from repro_torch.parallel import ternary_store as tts

MESHES = [(("data", "model"), (4, 1)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
LAYOUTS = ([(a, None) for a in ARCH_IDS] + [(a, 256) for a in ARCH_IDS]
           + [("gemma3_1b", 128)])
N_BLOCKS = {"global": 10, "local": 12}


def _over(xbar):
    return {} if xbar is None else dict(linear_impl="cadc",
                                        crossbar_size=xbar)


@functools.lru_cache(maxsize=None)
def _abstract(arch, xbar):
    """(port cfg, JAX cfg, port abstract params, JAX eval_shape params)."""
    tcfg, jcfg = tget(arch, **_over(xbar)), jget(arch, **_over(xbar))
    return (tcfg, jcfg, tsteps.abstract_params(tcfg),
            jsteps.abstract_params(jcfg))


def _meshes():
    for names, shape in MESHES:
        yield (tmesh.Mesh(names, shape),
               types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape)))


def _stack(nodes, leaf):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes], leaf) for k in nodes[0]}
    if isinstance(nodes[0], tuple) and hasattr(nodes[0], "_fields"):
        return type(nodes[0])(*(_stack([getattr(n, f) for n in nodes], leaf)
                                for f in nodes[0]._fields))
    return leaf(nodes)


def _stack_spec(specs):
    assert all(s == specs[0] for s in specs), specs  # a unit's layers agree
    return JP(None, *specs[0])


def _stack_shape(sds):
    assert all(s == sds[0] for s in sds), sds
    return jax.ShapeDtypeStruct((len(sds), *sds[0].shape), sds[0].dtype)


def _jax_layout(tree, cfg):
    """A port tree in the JAX layout: its per-layer list ("layers" of a
    params tree, or a cache list) becomes {"units": one entry a pattern
    position with its layers stacked, "tail": the rest}, as
    transformer.params_to_numpy stacks. Leaves: torch tensors become
    ShapeDtypeStructs, spec tuples PartitionSpecs."""
    tree = jax.tree_util.tree_map(
        lambda x: (JP(*x) if type(x) is tuple else jax.ShapeDtypeStruct(
            tuple(x.shape), jnp.dtype(str(x.dtype)[6:]))),
        tree, is_leaf=lambda x: type(x) is tuple)
    layers = tree["layers"] if isinstance(tree, dict) else tree
    is_spec = isinstance(jax.tree_util.tree_leaves(
        layers, is_leaf=lambda x: isinstance(x, JP))[0], JP)
    p = len(cfg.pattern)
    reps = len(layers) // p if cfg.scan_layers else 0
    units = tuple(_stack(layers[j:reps * p:p],
                         _stack_spec if is_spec else _stack_shape)
                  for j in range(p)) if reps else ()
    out = {k: v for k, v in tree.items() if k != "layers"} \
        if isinstance(tree, dict) else {}
    out.update(units=units, tail=tuple(layers[reps * p:]))
    return out


def _flat(tree):
    """{keystr: leaf}, ShapeDtypeStructs as (shape, dtype name) and
    PartitionSpecs as tuples."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        if isinstance(leaf, jax.ShapeDtypeStruct):
            leaf = (tuple(leaf.shape), str(leaf.dtype))
        elif isinstance(leaf, JP):
            leaf = tuple(leaf)
        out[jax.tree_util.keystr(path)] = leaf
    return out


@pytest.mark.parametrize("arch,xbar", LAYOUTS,
                         ids=[f"{a}-{x or 'dense'}" for a, x in LAYOUTS])
def test_param_specs_match_jax(arch, xbar):
    tcfg, jcfg, tparams, jparams = _abstract(arch, xbar)
    assert _flat(_jax_layout(tparams, tcfg)) == _flat(jparams)
    for tm, jm in _meshes():
        got = _jax_layout(tshard.param_specs(tparams, tcfg, tm), tcfg)
        assert _flat(got) == _flat(jshard.param_specs(jparams, jcfg, jm)), tm


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_input_specs_match_jax(arch):
    tcfg, jcfg, tparams, jparams = _abstract(arch, None)
    for name, shape in SHAPES.items():
        got = {k: (tuple(v.shape), str(v.dtype)[6:], v.device.type)
               for k, v in tsteps.input_specs(tcfg, shape).items()}
        want = {k: (tuple(v.shape), str(v.dtype), "meta")
                for k, v in jsteps.input_specs(jcfg, JSHAPES[name]).items()}
        assert got == want, name
    topt = tsteps.abstract_opt_state(tsteps.make_optimizer(tcfg), tparams)
    jopt = jsteps.abstract_opt_state(jsteps.make_optimizer(jcfg), jparams)
    assert set(topt) == set(jopt) == {"m", "v"}
    for k in topt:
        assert _flat(_jax_layout(topt[k], tcfg)) == _flat(jopt[k]), k
    for batch in (8, 32):
        tc = tsteps.abstract_caches(tcfg, batch, 64)
        jc = jsteps.abstract_caches(jcfg, batch, 64)
        assert _flat(_jax_layout(tc, tcfg)) == _flat(jc)
        tp = ttf.init_paged_caches(tcfg, batch, 16, N_BLOCKS,
                                   device="meta")
        jp = jax.eval_shape(lambda: jtf.init_paged_caches(
            jcfg, batch, 16, N_BLOCKS, 160))
        tables = {"global": np.zeros((batch, 10), np.int32),
                  "local": np.zeros((batch, 4), np.int32)}
        for tm, jm in _meshes():
            for kind in ("train", "prefill", "decode"):
                assert tshard.batch_specs(tcfg, tm, kind) == {
                    k: tuple(v) for k, v in
                    jshard.batch_specs(jcfg, jm, kind).items()}
            assert tshard.activation_spec(tcfg, tm) == tuple(
                jshard.activation_spec(jcfg, jm))
            got = _jax_layout(tshard.cache_specs(tc, tcfg, tm, batch), tcfg)
            assert _flat(got) == _flat(
                jshard.cache_specs(jc, jcfg, jm, batch)), tm
            got = _jax_layout(tshard.paged_cache_specs(tp, tcfg, tm), tcfg)
            assert _flat(got) == _flat(
                jshard.paged_cache_specs(jp, jcfg, jm)), tm
            assert tshard.block_table_specs(tables, tcfg, tm) == {
                k: tuple(v) for k, v in
                jshard.block_table_specs(tables, jcfg, jm).items()}


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    pod = tmesh.make_production_mesh(multi_pod=True)
    assert tshard.placements(tshard.P(("pod", "data"), "model"), pod) == (
        Shard(0), Shard(0), Shard(1))
    assert tshard.placements(tshard.P(None, "data"), pod) == (
        Replicate(), Shard(1), Replicate())
    assert tshard.placements(tshard.P(None), tmesh.make_local_mesh(4)) == (
        Replicate(), Replicate())
    assert tshard.data_dim(tshard.P(None, None, "data")) == 2
    assert tshard.data_dim(tshard.P(("pod", "data"))) == 0
    assert tshard.data_dim(tshard.P("model", None)) is None
    assert tmesh.data_axes(pod) == ("pod", "data")
    assert tmesh.axis_size(pod, "model") == 16 and pod.size == 512
    assert tmesh.make_local_mesh() == tmesh.Mesh(("data", "model"), (1, 1))


# ---------------------------------------------------------------------------
# the tensor-parallel CADC linear
# ---------------------------------------------------------------------------

def test_tp_cadc_linear_over_four_ranks_matches_jax(tmp_path):
    b, d, n, xbar = 8, 512, 128, 64          # S = 8 segments over 4 ranks
    rng = np.random.RandomState(0)
    x = rng.randn(b, d).astype(np.float32)
    w = (rng.randn(d, n) / 22.6).astype(np.float32)
    y_ref = np.asarray(jcadc.cadc_matmul(jnp.asarray(x), jnp.asarray(w),
                                         crossbar_size=xbar, fn="relu"))
    outs = run_ranks(tp_cadc_rank, 4, tmp_path, x, w, xbar)
    for o in outs:
        np.testing.assert_allclose(o["y32"], y_ref, rtol=1e-5, atol=1e-5)
        rel = np.linalg.norm(o["y16"] - y_ref) / np.linalg.norm(y_ref)
        assert rel < 0.01, rel
        assert 0 < rel        # the wire really rounded
        np.testing.assert_allclose(o["yv"], x @ w, rtol=1e-4, atol=1e-4)
        assert o["wire32"] == ["torch.float32"]
        assert o["wire16"] == ["torch.bfloat16"]
        assert o["dtypes"] == ("torch.float32", "torch.float32")
        assert o["refused"]
        np.testing.assert_array_equal(o["y32"], outs[0]["y32"])


# ---------------------------------------------------------------------------
# the ternary store
# ---------------------------------------------------------------------------

KEY = jax.random.PRNGKey(0)


def _same_codec(w):
    t, j = tts.encode(torch.from_numpy(w)), jts.encode(jnp.asarray(w))
    assert t["codes"].dtype == torch.int8
    np.testing.assert_array_equal(t["codes"].numpy(), np.asarray(j["codes"]))
    np.testing.assert_allclose(t["scale"].numpy(), np.asarray(j["scale"]),
                               rtol=1e-6, atol=0)
    return t, j


def test_ternary_codec_matches_jax():
    w = np.asarray(jax.random.normal(KEY, (512, 256)) * 0.05)
    x = np.asarray(jax.random.normal(jax.random.fold_in(KEY, 1), (8, 512)))
    t, j = _same_codec(w)
    np.testing.assert_allclose(
        tts.ternary_linear(torch.from_numpy(x), t).numpy(),
        np.asarray(jts.ternary_linear(jnp.asarray(x), j)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tts.decode(t, torch.float32).numpy(),
        np.asarray(jts.decode(j, jnp.float32)), rtol=1e-6, atol=0)
    assert tts.relative_error(torch.from_numpy(w)) == pytest.approx(
        jts.relative_error(jnp.asarray(w)), rel=1e-5)
    for seed in range(31):                   # the property test's seeds
        _same_codec(np.asarray(
            jax.random.normal(jax.random.PRNGKey(seed), (64, 8)) * 0.1))


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_encode_tree_picks_the_same_leaves():
    """The JAX test's tree, and a small gemma3-1b's parameters in the JAX
    layout (its stacked units are 3-D: passed through by both)."""
    tree = {"wq": {"w": np.ones((512, 256), np.float32),
                   "b": np.zeros((256,), np.float32)},
            "ln": {"scale": np.ones((256,), np.float32)},
            "tiny": {"w": np.ones((4, 4), np.float32)}}
    cfg = tget("gemma3_1b", n_layers=7, d_model=128, d_ff=256,
               vocab_size=512)
    params = ttf.params_to_numpy(ttf.init(cfg, seed=0, device="cpu"), cfg)
    for t, min_size in ((tree, 1 << 16), (params, 1 << 14)):
        got, n = tts.encode_tree(
            jax.tree_util.tree_map(torch.from_numpy, t), min_size=min_size)
        want, m = jts.encode_tree(jax.tree_util.tree_map(jnp.asarray, t),
                                  min_size=min_size)
        assert n == m > 0
        got, want = _by_path(got), _by_path(want)
        assert got.keys() == want.keys()
        for k in got:
            if k.endswith("['scale']") and "['codes']" not in k and (
                    k[:-len("['scale']")] + "['codes']") in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=0)
            else:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_int8_codes_gathered_over_two_ranks(tmp_path):
    rng = np.random.RandomState(1)
    w = (rng.randn(256, 64) * 0.1).astype(np.float32)
    x = rng.randn(16, 256).astype(np.float32)
    want = tts.ternary_linear(torch.from_numpy(x),
                              tts.encode(torch.from_numpy(w))).numpy()
    for o in run_ranks(ternary_rank, 2, tmp_path, w, x):
        np.testing.assert_array_equal(o["y"], want)
        assert o["wire"] == ["torch.int8"]
        assert o["dtensor_same"] == [True, True]
