"""Tensor parallelism over "model" and data parallelism over "pod" inside
the LM train step, on the CPU over gloo.

  * steps.make_fsdp_train_step on the meshes (data 1, model 2), (2, 2)
    and (pod 2, data 1, model 2) — spawned ranks, one spawn a mesh —
    against steps.make_train_step on one process (which
    tests/test_torch_lm_train_step.py holds to JAX), the same global
    batches and n_micro, 3 steps: smoke gemma3-1b with CADC at crossbar 32
    (wo and w_down row-parallel on whole local segments) and at 128 (both
    fall back to the gathered activation), qwen2-moe-a2.7b with E = 8
    (expert parallelism) and with E = 5 (within-expert TP, at crossbar
    32: the down product row-parallel), recurrentgemma-9b and xlstm-1.3b
    (their recurrent blocks replicated, the MLP and attention split) and
    hubert-xlarge (the encoder, an untied head of 64 real rows in 256:
    one rank holds none). Bounds as the FSDP step's: fp32 (dtype float32,
    bf16_wire off) losses within 1e-6 relative and the parameters within
    1e-5 of their scale; bf16 (gemma3-1b at crossbar 32 and the EP MoE)
    losses within 1e-3 relative. Every rank gathers the same whole model
    and reports the same loss;
  * at (1, 1) the step is make_train_step's, bitwise (fp32 and bf16), for
    every config, the MoE ones with their shared experts included;
  * the row-parallel linears every arch at full width runs on the
    gathered activation, at crossbar 256 and 128 and T = 2, 4, 16;
  * the vocab-parallel loss (2 ranks, 300 real rows of 512) equal to
    lm_loss on the whole logits within 1e-6, its gradient too;
  * under seq_sharding (sequence parallelism over "model") the step at
    (1, 2) equals the step without it at the bounds above
    (tests/test_torch_seq_parallel.py holds it to make_train_step on
    every case);
  * a checkpoint written at (2, 2) re-lays bitwise at (4, 1) and (1, 4);
  * comm.all_reduce_coalesced (the step's bucketed reductions) equals one
    all_reduce a tensor.

Every spawn is bounded (run_ranks: 240 s).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_ranks
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp
from repro_torch.train import optimizer as opt_lib

MESHES = {"1x2": (("data", "model"), (1, 2)),
          "2x2": (("data", "model"), (2, 2)),
          "2x1x2": (("pod", "data", "model"), (2, 1, 2))}
ETP_MOE = MoEConfig(n_experts=5, top_k=2, d_expert=64, n_shared=2,
                    d_shared=96)
CASES = {
    "gemma3.xbar32": ("gemma3_1b", dict(crossbar_size=32)),
    "gemma3.xbar128": ("gemma3_1b", dict(crossbar_size=128)),
    "qwen2moe.ep": ("qwen2_moe_a27b", {}),
    "qwen2moe.etp": ("qwen2_moe_a27b", dict(moe=ETP_MOE, crossbar_size=32)),
    "recurrentgemma": ("recurrentgemma_9b", {}),
    "xlstm": ("xlstm_13b", {}),
    "hubert": ("hubert_xlarge", {}),
}
BF16 = ("gemma3.xbar32", "qwen2moe.ep")
DTYPES = {"fp32": dict(dtype="float32", bf16_wire=False),
          "bf16": dict(dtype="bfloat16", bf16_wire=True)}
N_MICRO, B, S, STEPS, LR = 2, 8, 16, 3, 1e-4
LOSS_RTOL = {"fp32": 1e-6, "bf16": 1e-3}
PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _runs():
    return [(c, dt) for c in CASES for dt in DTYPES
            if dt == "fp32" or c in BF16]


def _cfg(case, dt):
    arch, kw = CASES[case]
    return smoke_config(arch, linear_impl="cadc", **kw, **DTYPES[dt])


def _optimizer():
    return opt_lib.adamw(LR, weight_decay=0.1, max_grad_norm=1.0)


def _batches(cfg, steps=STEPS, seq=S):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, seq + 1)))
        batch = {"tokens": toks[:, :-1].long(), "labels": toks[:, 1:].long()}
        if cfg.frontend == "audio":
            batch = {"frames": torch.from_numpy(rng.standard_normal(
                (B, seq, cfg.frontend_dim)).astype(np.float32)),
                "labels": batch["labels"]}
        out.append(batch)
    return out


_REF = {}


def _reference(case, dt):
    """make_train_step on one process: (losses, parameter leaves)."""
    if (case, dt) not in _REF:
        cfg = _cfg(case, dt)
        opt = _optimizer()
        step = steps.make_train_step(cfg, opt, n_micro=N_MICRO)
        p = tf.init(cfg, seed=0, device="cpu")
        s = opt.init(p)
        losses = []
        for i, batch in enumerate(_batches(cfg)):
            p, s, m = step(p, s, batch, i)
            losses.append(float(m["loss"]))
        _REF[case, dt] = losses, [t.numpy() for t in steps._leaves(p)]
    return _REF[case, dt]


def _mesh_run(cfg, mesh, ckpt_dir=None, batches=None):
    """The mesh step over this rank's blocks: (losses, the parameters
    gathered back whole); `ckpt_dir`: also save a checkpoint there;
    `batches`: the global batches (default _batches(cfg))."""
    opt = _optimizer()
    full = tf.init(cfg, seed=0, device="cpu")
    dims = fsdp.data_dims(full, cfg, mesh)
    mdims = fsdp.model_dims(full, cfg, mesh)
    step = steps.make_fsdp_train_step(cfg, mesh, dims, optimizer=opt,
                                      n_micro=N_MICRO)
    mg = step.mesh_groups
    p = steps._rebuild(full, [fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
                              for t, d, md in zip(steps._leaves(full), dims,
                                                  mdims)])
    s = opt.init(p)
    losses = []
    for i, batch in enumerate(_batches(cfg) if batches is None else batches):
        p, s, m = step(p, s, batch, i)
        losses.append(float(m["loss"]))
    if ckpt_dir:
        ttrain.save(ckpt_dir, STEPS, p, s, cfg, 3, dims, mdims, mg)
    whole = [fsdp.gather(fsdp.gather(t, d, mg.groups["data"]), md,
                         mg.groups["model"]).numpy()
             for t, d, md in zip(steps._leaves(p), dims, mdims)]
    return losses, whole


def _vocab_loss(rank, world):
    """lm_loss over a rank's vocab rows (300 real of 512, 2 ranks) and
    the gradient of its logits."""
    from repro_torch.parallel import act_sharding as sa

    cfg = smoke_config("gemma3_1b", vocab_size=300)
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 5, cfg.padded_vocab, generator=g) * 4
    labels = torch.randint(0, 300, (2, 5), generator=g)
    labels[0, 1] = -1
    rows = cfg.padded_vocab // world
    mg = mesh_lib.process_groups(mesh_lib.Mesh(("data", "model"),
                                               (1, world)))
    with sa.tp_context(mg.sizes, mg.groups["model"], rank):
        mine = logits[:, :, rank * rows:(rank + 1) * rows]
        mine = mine[..., :max(0, min(rows, 300 - rank * rows))]
        mine = mine.clone().requires_grad_()
        loss, metrics = tf.lm_loss(mine, labels, cfg=cfg)
        (grad,) = torch.autograd.grad(loss, mine)
    return (float(loss), float(metrics["ce"]), float(metrics["acc"]),
            grad.numpy(), logits.numpy(), labels.numpy())


def tp_rank(rank, world, names, shape, ckpt_dir):
    mesh = mesh_lib.Mesh(names, shape)
    out = {run: _mesh_run(_cfg(*run), mesh,
                          ckpt_dir if run == ("gemma3.xbar32", "fp32")
                          else None)
           for run in _runs()}
    if shape == (1, 2):
        out["vocab_loss"] = _vocab_loss(rank, world)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every case over each mesh: one spawn a mesh."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            names, shape = MESHES[mesh]
            d = tmp_path_factory.mktemp(f"tp{mesh}")
            runs[mesh] = (run_ranks(tp_rank, int(np.prod(shape)), d, names,
                                    shape, str(d / "ckpt"), timeout=240),
                          str(d / "ckpt"))
        return runs[mesh]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_the_single_process_step(case, mesh, tp_runs):
    outs, _ = tp_runs(mesh)
    for dt in [d for c, d in _runs() if c == case]:
        want_losses, want_params = _reference(case, dt)
        got = [o[case, dt] for o in outs]
        init = [t.numpy() for t in steps._leaves(
            tf.init(_cfg(case, dt), seed=0, device="cpu"))]
        for losses, params in got:
            np.testing.assert_allclose(losses, want_losses,
                                       rtol=LOSS_RTOL[dt], atol=0)
            if dt == "fp32":
                for a, w, p0 in zip(params, want_params, init):
                    scale = max(1.0, float(np.abs(w).max()))
                    assert np.abs(a - w).max() <= PARAM_TOL * scale
                assert max(float(np.abs(w - p).max())
                           for w, p in zip(want_params, init)) \
                    > 10 * PARAM_TOL
        for losses, params in got[1:]:
            assert losses == got[0][0]
            assert all(np.array_equal(a, b)
                       for a, b in zip(params, got[0][1]))


def test_the_plan_splits_and_falls_back_as_designed():
    sizes = {"pod": 1, "data": 1, "model": 2}
    assert tf.tp_fallbacks(_cfg("gemma3.xbar32", "fp32"), sizes) == []
    assert tf.tp_fallbacks(_cfg("gemma3.xbar128", "fp32"), sizes) == [
        "attn.wo", "ffn.w_down"]
    for case, want in (("qwen2moe.ep", "ep"), ("qwen2moe.etp", "etp")):
        from repro_torch.models.lm import moe
        assert moe.tp_mode(_cfg(case, "fp32"), sizes) == want
    cfg = _cfg("gemma3.xbar32", "fp32")
    modes = tf.tp_leaf_modes(steps.abstract_params(cfg), cfg, sizes)
    assert {m for m, _ in modes} == {"split", "partial", "full"}


# The row-parallel linears each arch at full width runs on the gathered
# activation (CADC at crossbar 256 and 128, a "model" axis of T = 2, 4 and
# 16): S does not divide T, or a rank's block of the producer's features
# is not whole crossbars.
_W = ["ffn.w_down"]
FALLBACKS = {
    "gemma3_1b": {256: (_W, _W, _W), 128: ([], _W, _W)},
    "gemma_7b": {256: ([], [], []), 128: ([], [], [])},
    "codeqwen15_7b": {256: (_W, _W, _W), 128: (_W, _W, _W)},
    "phi4_mini_38b": {256: ([], [], []), 128: ([], [], [])},
    "mixtral_8x22b": {256: ([], [], ["attn.wo"]), 128: ([], [], [])},
    "qwen2_moe_a27b": {
        256: ([], ["moe.shared.w_down"],
              ["attn.wo", "moe.w_down", "moe.shared.w_down"]),
        128: ([], [], ["moe.w_down", "moe.shared.w_down"])},
    "internvl2_1b": {256: (["attn.wo", "ffn.w_down"], _W, _W),
                     128: (["attn.wo"], _W, _W)},
    "recurrentgemma_9b": {256: ([], [], []), 128: ([], [], [])},
    "xlstm_13b": {256: ([], [], []), 128: ([], [], [])},
    "hubert_xlarge": {
        256: (["attn.wo"], ["attn.wo"], ["attn.wo", "ffn.w_down"]),
        128: ([], ["attn.wo"], ["attn.wo", "ffn.w_down"])},
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_fallbacks_at_full_width(arch):
    for xbar, want in FALLBACKS[arch].items():
        cfg = get_config(arch, linear_impl="cadc", crossbar_size=xbar)
        got = [tf.tp_fallbacks(cfg, {"pod": 1, "data": 1, "model": t})
               for t in (2, 4, 16)]
        assert got == list(want), (arch, xbar)


def test_vocab_parallel_loss_equals_lm_loss(tp_runs):
    outs, _ = tp_runs("1x2")
    res = [o["vocab_loss"] for o in outs]
    logits, labels = torch.from_numpy(res[0][4]), torch.from_numpy(res[0][5])
    whole = logits[..., :300].clone().requires_grad_()
    loss, metrics = tf.lm_loss(whole, labels)
    (grad,) = torch.autograd.grad(loss, whole)
    loss = loss.detach()
    for rank, (l, ce, acc, g, _, _) in enumerate(res):
        np.testing.assert_allclose(l, float(loss), rtol=1e-6)
        np.testing.assert_allclose(ce, float(metrics["ce"]), rtol=1e-6)
        assert acc == float(metrics["acc"])
        lo = rank * 256
        want = grad[..., lo:lo + g.shape[-1]].numpy()
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
    assert res[1][3].shape[-1] == 300 - 256


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_is_the_single_process_step_bitwise(case, one_rank_group):
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    for dt in ("fp32", "bf16"):
        losses, whole = _mesh_run(_cfg(case, dt), mesh)
        want_losses, want_params = _reference(case, dt)
        assert losses == want_losses
        assert all(np.array_equal(a, b) for a, b in zip(whole, want_params))


def seq_rank(rank, world):
    """gemma3 at crossbar 32, fp32, at (1, 2) with and without
    seq_sharding."""
    mesh = mesh_lib.Mesh(("data", "model"), (1, 2))
    cfg = _cfg("gemma3.xbar32", "fp32")
    return [_mesh_run(cfg.with_overrides(seq_sharding=on), mesh)
            for on in (False, True)]


def test_seq_sharding_matches_the_step_without_it(tmp_path):
    for (losses, params), (sp_losses, sp_params) in run_ranks(
            seq_rank, 2, tmp_path, timeout=240):
        np.testing.assert_allclose(sp_losses, losses,
                                   rtol=LOSS_RTOL["fp32"], atol=0)
        for a, w in zip(sp_params, params):
            assert np.abs(a - w).max() <= PARAM_TOL * max(
                1.0, float(np.abs(w).max()))


def coalesced_rank(rank, world):
    """all_reduce_coalesced over mixed dtypes, a non-contiguous view and
    buckets of one and of several tensors, against one all_reduce each;
    a tensor listed twice, its entries in two buckets, summed once."""
    from repro_torch.parallel import comm

    g = torch.Generator().manual_seed(rank)
    ts = [torch.randn(5, 3, generator=g), torch.randn(300, generator=g),
          torch.randn(4, 6, generator=g).t(), torch.randn(7, generator=g),
          torch.randn(2, 2, generator=g).bfloat16()]
    want = [comm.all_reduce(t.clone()) for t in ts]
    comm.all_reduce_coalesced(ts, bucket_bytes=600)
    twice = torch.randn(100, generator=g)
    other = torch.randn(100, generator=g)
    want += [comm.all_reduce(twice.clone()), comm.all_reduce(other.clone())]
    comm.all_reduce_coalesced([twice, other, twice], bucket_bytes=600)
    return all(torch.equal(a, b) for a, b in zip(ts + [twice, other], want))


def test_all_reduce_coalesced_is_each_all_reduce(tmp_path):
    assert run_ranks(coalesced_rank, 2, tmp_path, timeout=60) == [True] * 2


def relay_rank(rank, world, ckpt_dir):
    """The checkpoint restored whole, then this rank's blocks under (4, 1)
    and (1, 4)."""
    cfg = _cfg("gemma3.xbar32", "fp32")
    like = tf.init(cfg, seed=0, device="cpu")
    opt = _optimizer()
    step, params, state = ttrain.restore(ckpt_dir, like, opt.init(like), cfg,
                                         "cpu")
    out = {}
    for shape in ((4, 1), (1, 4)):
        mesh = mesh_lib.Mesh(("data", "model"), shape)
        mg = mesh_lib.process_groups(mesh)
        dims = fsdp.data_dims(like, cfg, mesh)
        mdims = fsdp.model_dims(like, cfg, mesh)
        out[shape] = [[fsdp.mesh_block(t, d, md, mg.coords, mg.sizes).numpy()
                       for t, d, md in zip(steps._leaves(tree), dims, mdims)]
                      for tree in (params, state["m"], state["v"])]
    return step, out


def test_2x2_checkpoint_relays_bitwise_at_4x1_and_1x4(tp_runs, tmp_path):
    outs, ckpt_dir = tp_runs("2x2")
    cfg = _cfg("gemma3.xbar32", "fp32")
    like = tf.init(cfg, seed=0, device="cpu")
    step, params, state = ttrain.restore(ckpt_dir, like,
                                         _optimizer().init(like), cfg, "cpu")
    assert step == STEPS
    saved = [steps._leaves(t) for t in (params, state["m"], state["v"])]
    trained = outs[0][("gemma3.xbar32", "fp32")][1]
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(saved[0], trained))
    relaid = run_ranks(relay_rank, 4, tmp_path, ckpt_dir, timeout=120)
    for shape in ((4, 1), (1, 4)):
        mesh = mesh_lib.Mesh(("data", "model"), shape)
        dims = fsdp.data_dims(like, cfg, mesh)
        mdims = fsdp.model_dims(like, cfg, mesh)
        assert any(d is not None for d in (dims if shape[0] > 1 else mdims))
        for rank, (got_step, out) in enumerate(relaid):
            assert got_step == STEPS
            coords = {"data": rank // shape[1], "model": rank % shape[1]}
            sizes = dict(zip(("data", "model"), shape))
            for got_tree, want_tree in zip(out[shape], saved):
                for got, want, d, md in zip(got_tree, want_tree, dims,
                                            mdims):
                    np.testing.assert_array_equal(
                        got, fsdp.mesh_block(want, d, md, coords,
                                             sizes).numpy())
