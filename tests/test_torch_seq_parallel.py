"""Sequence parallelism over "model" in the LM train step (cfg.seq_sharding:
the JAX package's _seq_shard, Megatron-SP's collectives made by hand), on
the CPU over gloo.

  * steps.make_fsdp_train_step under seq_sharding at (data 1, model 2) for
    every case of tests/test_torch_tp_train.py (fp32, and bf16 where that
    file runs bf16) and at (1, 4) in fp32 (4 ranks: the smoke configs' 2
    heads do not divide it, so attention runs on the gathered sequence),
    against make_train_step on one process, the same global batches and
    n_micro, STEPS steps. make_train_step is held to JAX's make_train_step
    in tests/test_torch_lm_train_step.py; JAX's _seq_shard is a sharding
    constraint, so its values are the unsharded ones. Bounds as the TP
    step's: losses within LOSS_RTOL relative, fp32 parameters within
    PARAM_TOL of their scale; every rank the same bits;
  * a micro whose length does not divide the axis (S 15 at model 2) runs
    as without sequence parallelism, bitwise;
  * at (1, 1) the step is make_train_step's, bitwise, for every case in
    fp32 and bf16;
  * the planted fault — the norms' gradients, each rank's of its block of
    the sequence, left unsummed over "model" (tp_leaf_modes(seq=True)
    patched to give ln1, ln2 and final_norm ("full", None)) — fails the
    parameter gate;
  * the plan: under sequence parallelism the norms and the fallbacks'
    whole leaves become partial, and nothing else changes.

One spawn a mesh; every spawn is bounded (run_ranks: 240 s).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_tp_train as tpt
from _torch_dist import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.lm import transformer as tf

STEPS = 2
MESHES = {"1x2": (1, 2), "1x4": (1, 4)}
ODD_S = 15
FAULT_RUN = ("gemma3.xbar32", "fp32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(case, dt, seq=True):
    return tpt._cfg(case, dt).with_overrides(seq_sharding=seq)


def _runs(shape):
    return [r for r in tpt._runs() if shape == (1, 2) or r[1] == "fp32"]


_REF = {}


def _reference(case, dt):
    """make_train_step on one process: (losses, parameter leaves)."""
    if (case, dt) not in _REF:
        cfg = _cfg(case, dt, seq=False)
        opt = tpt._optimizer()
        step = steps.make_train_step(cfg, opt, n_micro=tpt.N_MICRO)
        p = tf.init(cfg, seed=0, device="cpu")
        s = opt.init(p)
        losses = []
        for i, batch in enumerate(tpt._batches(cfg, STEPS)):
            p, s, m = step(p, s, batch, i)
            losses.append(float(m["loss"]))
        _REF[case, dt] = losses, [t.numpy() for t in steps._leaves(p)]
    return _REF[case, dt]


def _run(cfg, mesh, **kw):
    return tpt._mesh_run(cfg, mesh,
                         batches=tpt._batches(cfg, STEPS, **kw))


def _unsummed_norms(plan):
    """tp_leaf_modes with the norms' partial entries under seq made
    ("full", None): each rank keeps its own block's gradient."""
    def leaf_modes(shape, cfg, sizes, seq=False):
        modes = plan(shape, cfg, sizes, seq)
        return [("full", None) if seq and names[-1] == "scale"
                and m == ("partial", None) else m
                for (names, _), m in zip(tf._leaf_paths(shape), modes)]
    return leaf_modes


def sp_rank(rank, world, shape):
    mesh = mesh_lib.Mesh(("data", "model"), shape)
    out = {run: _run(_cfg(*run), mesh) for run in _runs(shape)}
    if shape == (1, 2):
        out["odd"] = [_run(_cfg(*FAULT_RUN, seq=on), mesh, seq=ODD_S)
                      for on in (False, True)]
        plan, tf.tp_leaf_modes = tf.tp_leaf_modes, _unsummed_norms(
            tf.tp_leaf_modes)
        try:
            out["fault"] = _run(_cfg(*FAULT_RUN), mesh)
        finally:
            tf.tp_leaf_modes = plan
    return out


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            shape = MESHES[mesh]
            runs[mesh] = run_ranks(sp_rank, int(np.prod(shape)),
                                   tmp_path_factory.mktemp(f"sp{mesh}"),
                                   shape, timeout=240)
        return runs[mesh]
    return get


def _param_err(params, want):
    return max(float(np.abs(a - w).max()) / max(1.0, float(np.abs(w).max()))
               for a, w in zip(params, want))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(tpt.CASES))
def test_sp_step_matches_the_single_process_step(case, mesh, sp_runs):
    outs = sp_runs(mesh)
    for dt in [d for c, d in _runs(MESHES[mesh]) if c == case]:
        want_losses, want_params = _reference(case, dt)
        got = [o[case, dt] for o in outs]
        for losses, params in got:
            np.testing.assert_allclose(losses, want_losses,
                                       rtol=tpt.LOSS_RTOL[dt], atol=0)
            if dt == "fp32":
                assert _param_err(params, want_params) <= tpt.PARAM_TOL
        for losses, params in got[1:]:
            assert losses == got[0][0]
            assert all(np.array_equal(a, b)
                       for a, b in zip(params, got[0][1]))


def test_a_length_the_axis_does_not_divide_runs_without_sp(sp_runs):
    for (losses, params), (sp_losses, sp_params) in (
            o["odd"] for o in sp_runs("1x2")):
        assert sp_losses == losses
        assert all(np.array_equal(a, b) for a, b in zip(sp_params, params))


def test_unsummed_norm_gradients_fail_the_gate(sp_runs):
    outs = sp_runs("1x2")
    good = outs[0][FAULT_RUN][1]
    want = _reference(*FAULT_RUN)[1]
    assert _param_err(good, want) <= tpt.PARAM_TOL
    errs = [_param_err(o["fault"][1], want) for o in outs]
    assert min(errs) > 10 * tpt.PARAM_TOL, errs


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(tpt.CASES))
def test_one_rank_sp_step_is_the_single_process_step_bitwise(
        case, one_rank_group):
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    for dt in ("fp32", "bf16"):
        losses, params = _run(_cfg(case, dt), mesh)
        want_losses, want_params = _reference(case, dt)
        assert losses == want_losses
        assert all(np.array_equal(a, b) for a, b in zip(params, want_params))


@pytest.mark.parametrize("case", list(tpt.CASES))
def test_sp_plan_sums_the_norms_and_fallbacks(case):
    """The SP plan differs from the TP plan only where a leaf meets the
    rank's block of the sequence alone: the norms, and the whole
    row-parallel leaves of a split block (its fallback weight, w_down's
    bias); those become partial."""
    cfg = _cfg(case, "fp32")
    shape = steps.abstract_params(cfg)
    for t in (2, 4):
        sizes = {"pod": 1, "data": 1, "model": t}
        tp = tf.tp_leaf_modes(shape, cfg, sizes)
        sp = tf.tp_leaf_modes(shape, cfg, sizes, seq=True)
        changed = {names for (names, _), a, b in zip(
            tf._leaf_paths(shape), tp, sp) if a != b}
        norms = {names for names, _ in tf._leaf_paths(shape)
                 if names[0] == "final_norm" or names[0] == "layers"
                 and names[2] in ("ln1", "ln2")}
        assert norms <= changed
        for names in changed:
            assert tp[[n for n, _ in tf._leaf_paths(shape)].index(names)] \
                == ("full", None)
            assert names in norms or names[3] in ("wo", "w_down", "w_out")
        if set(tf.tp_fallbacks(cfg, sizes)) & {"attn.wo", "ffn.w_down",
                                               "rglru.w_out"}:
            assert changed - norms
