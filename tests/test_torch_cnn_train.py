"""The port's CNN training against the JAX package, on the CPU.

From JAX-initialized params carried across by `params_from_numpy`, and on
JAX-made batches, the port's LeNet-5 and ResNet-18 (width 4, 16x16 inputs,
batch 4) must give the JAX package's logits, BN state and gradients, and
3-step `sgd` loss trajectories, within 1e-4 — the JAX package's TOL for
fp32 forwards and gradients. The port runs both its layer paths: kernel
'auto' (on CPU tensors the plain versions of K1g / K2 / K3 through the
autograd Functions of kernels/ops.py) and 'torch' (the core formulation
under torch autograd). `adamw` and `sgd` give the JAX updates on identical
gradients within 1e-6 (elementwise fp32 formulas). The psum sparsity per
layer and the cost model's reductions equal the JAX package's on the same
trained params (within 1e-6: counts of exact zeros may differ only where a
psum rounds to 0 on one side).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro.core import sparsity as jsp
from repro.data import synthetic as jsyn
from repro.models import common as jcm
from repro.models.cnn import lenet5 as jlenet
from repro.models.cnn import resnet18 as jresnet
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.core import costmodel as tcost
from repro_torch.core import sparsity as tsp
from repro_torch.data import synthetic as tsyn
from repro_torch.models import common as tcm
from repro_torch.models.cnn import lenet5 as tlenet
from repro_torch.models.cnn import resnet18 as tresnet
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

TOL = 1e-4
KERNELS = ["auto", "torch"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    """Every leaf within tol of its tensor's scale (max(1, max |want|))."""
    jl = jax.tree_util.tree_leaves(want)
    tl = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= tol * scale


MODELS = {
    "lenet5": dict(j=jlenet, t=tlenet, init={}, hw=28, ch=1),
    "resnet18": dict(j=jresnet, t=tresnet,
                     init={"num_classes": 10, "width": 4}, hw=16, ch=3),
}


@functools.lru_cache(maxsize=None)
def _setup(model):
    spec = MODELS[model]
    params, state = spec["j"].init(jax.random.PRNGKey(0), **spec["init"])
    data = jsyn.make_classification_dataset(jsyn.ClassificationSpec(
        n_classes=10, hw=spec["hw"], channels=spec["ch"], noise=0.8))
    batches = [_np(data(step, 4)) for step in range(3)]
    return _np(params), _np(state), batches


def _modes(impl):
    return (jcm.LayerMode(impl=impl, crossbar_size=64),
            tcm.LayerMode(impl=impl, crossbar_size=64))


@functools.lru_cache(maxsize=None)
def _jax_step(model, impl, train):
    """jit of (params, state, image, label) -> (loss, logits, new state,
    grads) of the JAX model."""
    spec = MODELS[model]
    jmode, _ = _modes(impl)

    @jax.jit
    def run(p, s, image, label):
        def loss_fn(p_):
            logits, ns = spec["j"].apply(p_, s, image, jcm.Ctx(jmode),
                                         train=train)
            return jloop.cross_entropy(logits, label), (logits, ns)

        (loss, (logits, ns)), g = jax.value_and_grad(loss_fn,
                                                      has_aux=True)(p)
        return loss, logits, ns, g

    return run


def _torch_step(model, tmode, tp, ts, batch, train):
    flat = [p.detach().requires_grad_() for p in tloop._flatten(tp)]
    live = tloop._unflatten(tp, flat)
    b = tcm.params_from_numpy(batch, "cpu")
    logits, ns = MODELS[model]["t"].apply(live, ts, b["image"],
                                          tcm.Ctx(tmode), train=train)
    loss = tloop.cross_entropy(logits, b["label"].long())
    grads = tloop._unflatten(tp, torch.autograd.grad(loss, flat))
    return loss.detach(), logits.detach(), ns, grads


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("impl", ["vconv", "cadc"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_state_and_grads_match_jax(model, impl, kernel):
    """Loss, logits and BN state in train mode; gradients in train mode
    too, except for ResNet-18 CADC, whose gradients are compared with BN
    on its running statistics: there the dendritic relu leaves BN channels
    with near-zero batch variance (6.9e-5 in s3b0's projection BN at this
    size), whose train-mode backward amplifies fp32 rounding ~10^3-fold —
    the port's own fp32 gradients move by 4.3e-4 of scale when the non-psum
    ops run in float64 — so no two fp32 summation orders agree there at
    1e-4. With BN on running statistics they agree to ~1e-6."""
    params, state, batches = _setup(model)
    b = batches[0]
    _, tmode = _modes(impl)
    tmode = dataclasses.replace(tmode, kernel=kernel)
    tp = tcm.params_from_numpy(params, "cpu")
    ts = tcm.params_from_numpy(state, "cpu")
    loss, logits, new_state, grads = _jax_step(model, impl, True)(
        params, state, b["image"], b["label"])
    tloss, tlogits, tnew, tgrads = _torch_step(model, tmode, tp, ts, b, True)
    assert abs(float(tloss) - float(loss)) <= TOL * max(1.0, abs(float(loss)))
    _close(tlogits, logits)
    _close(tnew, new_state)
    if model == "resnet18" and impl == "cadc":
        grads = _jax_step(model, impl, False)(params, state, b["image"],
                                              b["label"])[3]
        tgrads = _torch_step(model, tmode, tp, ts, b, False)[3]
    _close(tgrads, grads)


def _jax_losses(model, impl, noise=0.0):
    """Losses of three JAX sgd steps; `noise` scales the images by
    (1 + noise * N(0, 1)) — a probe of the trajectory's conditioning."""
    params, state, batches = _setup(model)
    opt = jopt.sgd(0.05)
    p, s, o = params, state, opt.init(params)
    losses = []
    for i, b in enumerate(batches):
        img = b["image"] * (1 + noise * np.random.RandomState(i).randn(
            *b["image"].shape)).astype(np.float32)
        loss, _, s, g = _jax_step(model, impl, True)(p, s, img, b["label"])
        u, o = opt.update(g, o, p, i)
        p = jopt.apply_updates(p, u)
        losses.append(float(loss))
    return np.asarray(losses), s


@pytest.mark.parametrize("impl", ["vconv", "cadc"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sgd_trajectory_matches_jax(model, impl):
    """Three sgd steps of the port's train loop against the JAX step on the
    same JAX-made batches: each loss within 1e-4 of it, plus twice the
    distance the JAX trajectory itself moves when its images are scaled by
    1 + 1e-7 * N(0, 1). That spread is ~1e-7 everywhere but ResNet-18 CADC
    at this size, whose near-zero-variance BN channels make the third
    step's loss move by ~8% under that noise: there the first two steps
    are held to 1e-4 and the third only as far as JAX agrees with
    itself."""
    spec = MODELS[model]
    params, state, batches = _setup(model)
    _, tmode = _modes(impl)
    jlosses, s = _jax_losses(model, impl)
    spread = np.abs(_jax_losses(model, impl, noise=1e-7)[0] - jlosses)
    tb = []
    for b in batches:
        b = tcm.params_from_numpy(b, "cpu")
        b["label"] = b["label"].long()
        tb.append(b)
    out = tloop.train(apply_fn=spec["t"].apply,
                      batch_fn=lambda step, _bs: tb[step % len(tb)],
                      initial=(tcm.params_from_numpy(params, "cpu"),
                               tcm.params_from_numpy(state, "cpu")),
                      mode=tmode, optimizer=topt.sgd(0.05),
                      cfg=tloop.TrainConfig(steps=3, batch_size=4,
                                            eval_every=1, eval_batches=1),
                      device="cpu")
    tlosses = np.asarray([h["loss"] for h in out["history"]])
    assert (np.abs(tlosses - jlosses)
            <= TOL * np.abs(jlosses) + 2 * spread).all(), (tlosses, jlosses,
                                                            spread)
    if spread.max() <= 1e-6:
        _close(out["state"], s)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.RandomState(0)
    params = {"a": {"w": rng.randn(5, 3).astype(np.float32)},
              "b": rng.randn(4).astype(np.float32)}
    kw = (dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0)
          if name == "adamw" else
          dict(lr=0.1, momentum=0.9, weight_decay=1e-3, nesterov=True,
               max_grad_norm=1.0))
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tcm.params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = {"a": {"w": rng.randn(5, 3).astype(np.float32)},
             "b": rng.randn(4).astype(np.float32)}
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.asarray(step))
        tu, ts = to.update(tcm.params_from_numpy(g, "cpu"), ts, tp, step)
        _close(tu, ju, tol=1e-6)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    _close(tp, jp, tol=1e-6)
    sched_j = jopt.cosine_warmup_schedule(1e-3, 5, 20)
    sched_t = topt.cosine_warmup_schedule(1e-3, 5, 20)
    np.testing.assert_allclose([sched_t(i) for i in range(25)],
                               [float(sched_j(i)) for i in range(25)],
                               rtol=1e-6)


def test_sparsity_and_cost_model_match_jax():
    params, state, batches = _setup("lenet5")
    jmode = jcm.LayerMode(impl="cadc", crossbar_size=64, collect_stats=True)
    tmode = tcm.LayerMode(impl="cadc", crossbar_size=64, collect_stats=True)
    # "trained": three sgd steps on the JAX side, used by both sides
    opt = jopt.sgd(0.05)
    p, o = params, opt.init(params)
    for i, b in enumerate(batches):
        g = _jax_step("lenet5", "cadc", True)(p, {}, b["image"],
                                               b["label"])[3]
        u, o = opt.update(g, o, p, i)
        p = jopt.apply_updates(p, u)
    p = _np(p)
    x = batches[2]["image"]
    jctx, tctx = jcm.Ctx(jmode), tcm.Ctx(tmode)
    jlenet.apply(p, {}, x, jctx)
    tlenet.apply(tcm.params_from_numpy(p, "cpu"), {},
                 torch.from_numpy(x), tctx)
    jst, tst = jctx.stats_dict(), tctx.stats_dict()
    assert list(jst) == list(tst) == ["conv2", "fc1", "fc2", "fc3"]

    def layers(stats, mod):
        return [mod.LayerPsumStats(nm, int(v["segments"]), int(v["count"]),
                                   float(v["sparsity"]),
                                   float(v["segments"]) > 1)
                for nm, v in stats.items()]

    jl, tl = layers(jst, jsp), layers(tst, tsp)
    for a, b in zip(tl, jl):
        assert (a.segments, a.count) == (b.segments, b.count)
        assert abs(a.sparsity - b.sparsity) <= 1e-6
    ja, ta = jsp.summarize(jl), tsp.summarize(tl)
    for k in ja:
        assert abs(ta[k] - ja[k]) <= 1e-6 * max(1.0, abs(ja[k]))
    macs = sum(lay.count * 64 for lay in jl)
    jr = jcost.evaluate_network(jl, macs=macs, adc_bits=4).reductions()
    tr = tcost.evaluate_network(tl, macs=macs, adc_bits=4).reductions()
    for k in jr:
        assert abs(tr[k] - jr[k]) <= 1e-6


def test_synthetic_data_is_a_function_of_seed_and_step():
    spec = tsyn.ClassificationSpec(n_classes=10, hw=28, channels=1)
    fn = tsyn.make_classification_dataset(spec, device="cpu")
    a, b, c = fn(3, 8), fn(3, 8), fn(4, 8)
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
    assert not torch.equal(a["image"], c["image"])
    assert a["image"].shape == (8, 28, 28, 1) and a["label"].dtype == torch.int64
    assert int(a["label"].max()) < 10
    # class templates carry the signal: same-class images correlate
    t = tsyn._templates(spec)
    assert t.shape == (10, 28, 28, 1)


def test_layer_mode_rejects_slice_3_options():
    with pytest.raises(NotImplementedError):
        tcm.LayerMode(quant=object())
    with pytest.raises(NotImplementedError):
        tcm.LayerMode(adc=object())
    with pytest.raises(NotImplementedError):
        tcm.LayerMode(q8_fused=True)
    with pytest.raises(NotImplementedError):
        tloop.train(apply_fn=tlenet.apply, batch_fn=None,
                    cfg=tloop.TrainConfig(ckpt_dir="x"))
