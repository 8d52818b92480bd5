"""The RG-LRU block channel-parallel over "model" (rglru.rglru_apply in the
TP context), on the CPU over gloo.

  * over 2 and 4 ranks, smoke recurrentgemma-9b (rnn_width 64) with CADC
    at crossbar 16 (w_out row-parallel on whole local segments) and 64
    (w_out on the gathered channels), with and without sequence
    parallelism: the output and the gradients of x and of every leaf
    (this rank's block of a split leaf, the sum over the ranks of a
    partial one) against the whole block on one process, fp32 within
    RTOL of scale; the leaves' modes those transformer.tp_leaf_modes
    gives; a planted fault — lam and the conv's bias read at the next
    rank's channel block — past the gate;
  * at full width, tp_leaf_modes' RG-LRU entries split exactly the dims
    the JAX package's sharding rules give "model" (and no other), on
    (16, 16) and (2, 16, 16), dense and CADC at crossbar 256 and 128;
    serve_leaf_modes keeps them whole;
  * tp_fallbacks names rglru.w_out where a rank's channels are not whole
    segments, and at full width matches test_torch_tp_train's FALLBACKS.

The rank bodies live here, and the module imports no JAX at top level.
"""
import types

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.lm import rglru
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import act_sharding as sa
from repro_torch.parallel import comm, fsdp

B, S = 2, 16
XBARS = (16, 64)
RTOL = 1e-4
FAULT = (16, False)


def _cfg(xbar):
    return smoke_config("recurrentgemma_9b", linear_impl="cadc",
                        crossbar_size=xbar, dtype="float32",
                        bf16_wire=False)


def _inputs(cfg):
    """The whole model's params (the conv's bias drawn, not zero), its
    first layer's RG-LRU leaves with their names, x and the output probe."""
    params = tf.init(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(5)
    rec = params["layers"][0]["rec"]
    rec["conv"]["b"] = torch.randn(rec["conv"]["b"].shape, generator=g)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    probe = torch.randn(B, S, cfg.d_model, generator=g)
    return params, x, probe


def _rec_entries(params, cfg, mesh, sizes, seq):
    """(names, leaf, (mode, dim), model dim) of layer 0's RG-LRU leaves:
    the train plan's modes (under sequence parallelism where `seq`) and
    the rules' "model" dims."""
    paths = list(tf._leaf_paths(params))
    modes = tf.tp_leaf_modes(params, cfg, sizes, seq)
    mdims = fsdp.model_dims(params, cfg, mesh)
    return [(names, leaf, mode, md)
            for (names, leaf), mode, md in zip(paths, modes, mdims)
            if names[:3] == ("layers", "[0]", "rec")]


def _grads(rec, x, probe, cfg):
    """rglru_apply's output and the gradients of x and of rec's leaves
    (in leaf order) against the probe."""
    leaves = [t.detach().requires_grad_() for t in steps._leaves(rec)]
    x = x.detach().requires_grad_()
    y = rglru.rglru_apply(steps._rebuild(rec, leaves), x, cfg)
    grads = torch.autograd.grad((y * probe).sum(), [x] + leaves)
    return y.detach().numpy(), [g.numpy() for g in grads]


def rglru_rank(rank, world):
    mesh = mesh_lib.Mesh(("data", "model"), (1, world))
    mg = mesh_lib.process_groups(mesh)
    out = {}
    for xbar in XBARS:
        cfg = _cfg(xbar)
        params, x, probe = _inputs(cfg)
        entries = _rec_entries(params, cfg, mesh, mg.sizes, False)
        rec = {}
        for names, leaf, (mode, dim), md in entries:
            node = rec
            for k in names[3:-1]:
                node = node.setdefault(k, {})
            node[names[-1]] = (comm.block(leaf, dim, rank, world)
                               if mode == "split" else leaf)
        for seq in (False, True):
            xs, ps = ((comm.block(x, 1, rank, world),
                       comm.block(probe, 1, rank, world)) if seq
                      else (x, probe))
            with sa.tp_context(mg.sizes, mg.groups["model"], rank, seq):
                out[xbar, seq] = _grads(rec, xs, ps, cfg)
                if (xbar, seq) == FAULT:
                    real = rglru._channels
                    rglru._channels = lambda t: comm.block(
                        t, t.ndim - 1, (rank + 1) % world, world)
                    try:
                        out["fault"] = _grads(rec, xs, ps, cfg)
                    finally:
                        rglru._channels = real
            out[xbar, "plan", seq] = [
                (names, mode, md) for names, _, mode, md in _rec_entries(
                    params, cfg, mesh, mg.sizes, seq)]
    return out


@pytest.fixture(scope="module")
def rglru_runs(tmp_path_factory):
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(rglru_rank, world,
                                    tmp_path_factory.mktemp(f"rg{world}"),
                                    timeout=120)
        return runs[world]
    return get


def _whole(xbar):
    cfg = _cfg(xbar)
    params, x, probe = _inputs(cfg)
    return _grads(params["layers"][0]["rec"], x, probe, cfg)


def _err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _assemble(outs, key, plan, world, seq):
    """The ranks' output and gradients put back whole: a split leaf's
    blocks concatenated along its dim, a partial one's summed over the
    ranks, a full one rank 0's; x's gradient (and, under sequence
    parallelism, the output) by S blocks."""
    ys, gs = zip(*(o[key] for o in outs))
    y = np.concatenate(ys, axis=1) if seq else ys[0]
    gx = np.concatenate([g[0] for g in gs], axis=1) if seq else gs[0][0]
    leaves = []
    for j, (_, (mode, dim), _) in enumerate(plan):
        parts = [g[j + 1] for g in gs]
        leaves.append(np.concatenate(parts, axis=dim) if mode == "split"
                      else sum(parts) if mode == "partial" else parts[0])
    return y, [gx] + leaves


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("seq", [False, True])
def test_channel_parallel_block_is_the_whole_block(world, xbar, seq,
                                                   rglru_runs):
    outs = rglru_runs(world)
    plan = outs[0][xbar, "plan", seq]
    y, grads = _assemble(outs, (xbar, seq), plan, world, seq)
    want_y, want_grads = _whole(xbar)
    assert _err(y, want_y) <= RTOL
    for g, w in zip(grads, want_grads):
        assert g.shape == w.shape and _err(g, w) <= RTOL
    if not seq:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[xbar, seq][1][0],
                                          outs[0][xbar, seq][1][0])
    modes = {names[3:]: mode for names, mode, _ in plan}
    local = rglru.out_local(_cfg(xbar), world)
    assert modes[("w_out", "w")] == (("split", 0) if local else
                                     ("partial" if seq else "full", None))
    assert ("rglru.w_out" in tf.tp_fallbacks(_cfg(xbar),
                                             {"model": world})) != local
    assert modes[("lam",)] == modes[("conv", "b")] == ("partial", None)
    assert modes[("conv", "w")] == ("split", 1)
    for names, (mode, dim), md in plan:
        if mode == "split":
            assert dim == md, names


def test_wrong_channel_block_fails_the_gate(rglru_runs):
    outs = rglru_runs(2)
    faulty = [{**o, FAULT: o["fault"]} for o in outs]
    y, grads = _assemble(faulty, FAULT, outs[0][FAULT[0], "plan", FAULT[1]], 2,
                         FAULT[1])
    want_y, want_grads = _whole(FAULT[0])
    assert _err(y, want_y) > 10 * RTOL


MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


@pytest.mark.parametrize("xbar", [None, 256, 128])
def test_rglru_plan_splits_the_dims_jax_gives_model(xbar):
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as jget
    from repro.launch import steps as jsteps
    from repro.parallel import sharding as jshard

    over = {} if xbar is None else dict(linear_impl="cadc",
                                        crossbar_size=xbar)
    tcfg, jcfg = get_config("recurrentgemma_9b", **over), \
        jget("recurrentgemma_9b", **over)
    tshape, jshape = steps.abstract_params(tcfg), \
        jsteps.abstract_params(jcfg)
    rglru_units = [j for j, k in enumerate(jcfg.pattern) if k == "rglru"]
    for names_, shape in MESHES:
        jmesh = types.SimpleNamespace(axis_names=names_,
                                      devices=np.empty(shape))
        specs = jshard.param_specs(jshape, jcfg, jmesh)
        want = {}
        for j in rglru_units:
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    specs["units"][j]["rec"],
                    is_leaf=lambda s: isinstance(s, JP))[0]:
                key = tuple(str(k.key) for k in path)
                # a unit's spec leads with the stacked layers' axis
                dims = [i - 1 for i, e in enumerate(spec) if e == "model"]
                assert want.setdefault(key, dims) == dims
        sizes = dict(zip(names_, shape))
        train = tf.tp_leaf_modes(tshape, tcfg, sizes)
        serve = tf.serve_leaf_modes(tshape, tcfg, sizes)
        seen = set()
        for (names, _), (mode, dim), smode in zip(tf._leaf_paths(tshape),
                                                  train, serve):
            if names[0] != "layers" or names[2] != "rec":
                continue
            seen.add(names[3:])
            assert ([dim] if mode == "split" else []) == want[names[3:]], \
                (names, mode, dim)
            assert smode == ("full", None)
        assert seen == set(want)


def test_fallbacks_at_full_width_match_the_table():
    from test_torch_tp_train import FALLBACKS

    for xbar, want in FALLBACKS["recurrentgemma_9b"].items():
        cfg = get_config("recurrentgemma_9b", linear_impl="cadc",
                         crossbar_size=xbar)
        for t, w in zip((2, 4, 16), want):
            assert tf.tp_fallbacks(cfg, {"model": t}) == w
            assert rglru.out_local(cfg, t)
    # at a crossbar a rank's 4096 / 16 channels do not fill
    cfg = get_config("recurrentgemma_9b", linear_impl="cadc",
                     crossbar_size=512)
    assert "rglru.w_out" in tf.tp_fallbacks(cfg, {"model": 16})
