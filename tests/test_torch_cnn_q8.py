"""The paper's 4/2/4b operating point — QAT, int8 q8 inference and the ADC
model — in the port's CNNs against the JAX package, on the CPU.

Models at the JAX tests' widths: LeNet-5, ResNet-18 width 8, VGG-16
width_div 16, the SNN at width 8 and hw 16; params are JAX-initialized and carried
across by `params_from_numpy`; inputs are made with numpy from a seed.

What a quantized network can be held to across frameworks:
  * A q8 layer fed the same input equals the JAX layer: its activation
    codes bitwise (max|x| is exact, the quantizer's operations are the
    JAX ones), its output within the relative difference of the ternary
    alpha (its fp32 reductions sum in other orders in torch and XLA) plus
    1e-6 of scale. (The JAX forward is jitted, and XLA fuses its q8 layers'
    dequantization; the op-level q8 parity is bitwise, in
    test_torch_cadc_q8.py.)
  * A whole q8 network is not bitwise: every activation is a small integer
    times a scale, so x / scale * levels often lands exactly on a .5 tie,
    where an ulp of difference upstream (alpha; XLA's rsqrt in BN, which is
    not correctly rounded on the CPU) flips a code by one level, and the
    flip propagates. The end-to-end test therefore records every layer's
    codes on both sides, reports the count that differ per layer, and
    requires that at the first layer where any differ each difference is
    one level at a rounding boundary (JAX's level value within 1e-4 of a
    half-integer) — a fault would differ elsewhere — and that the logits
    agree within 1e-5 of scale when no code differs. With weights on a
    1/64 grid (ternary statistics exact in any order) the SNN, which has
    no BN, is bitwise end to end.
  * QAT (fake-quant STE): a layer's loss within 1e-5 of scale, and its
    gradients within 1e-4 where the gate is continuous at psum 0 (vConv,
    supralinear). A relu gate is not: with quantized operands a segment's
    psum is often an exact-zero integer sum that each framework rounds to
    a different tiny value, whose sign decides the gate; its gradients are
    held inside the port (kernel vs torch path) instead. The SNN, which
    has no BN and binary spikes for activations, trains with the JAX loss
    and gradients within 1e-4 (vConv, supralinear).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import quant as jq
from repro.models import common as jcm
from repro.models.cnn import lenet5 as jlenet
from repro.models.cnn import resnet18 as jresnet
from repro.models.cnn import snn as jsnn
from repro.models.cnn import vgg16 as jvgg
from repro.train import loop as jloop
from repro_torch.core import adc as tadc
from repro_torch.core import quant as tq
from repro_torch.data import synthetic as tsyn
from repro_torch.models import common as tcm
from repro_torch.models.cnn import lenet5 as tlenet
from repro_torch.models.cnn import resnet18 as tresnet
from repro_torch.models.cnn import snn as tsnn
from repro_torch.models.cnn import vgg16 as tvgg
from repro_torch.train import loop as tloop

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(model, seed=0):
    rng = np.random.RandomState(seed)
    if model == "snn":
        return (rng.rand(2, 4, 16, 16, 2) < 0.3).astype(np.float32)
    if model == "vgg16":
        return rng.randn(2, 32, 32, 3).astype(np.float32)
    if model == "lenet5":
        return rng.randn(2, 28, 28, 1).astype(np.float32)
    return rng.randn(2, 8, 8, 3).astype(np.float32)


MODELS = {
    "lenet5": (jlenet, tlenet, {}, "relu"),
    "resnet18": (jresnet, tresnet, dict(num_classes=10, width=8), "relu"),
    "vgg16": (jvgg, tvgg, dict(num_classes=10, width_div=16), "relu"),
    "snn": (jsnn, tsnn, dict(num_classes=11, width=8, hw=16), "sublinear"),
}


def _params(model, grid=False):
    jmod, _, kw, _ = MODELS[model]
    jp, js = jmod.init(jax.random.PRNGKey(0), **kw)
    if grid:  # weights on a 1/64 grid: exact ternary statistics
        jp = jax.tree_util.tree_map(
            lambda a: jnp.round(a * 64) / 64 if a.ndim >= 2 else a, jp)
    tp, ts = tcm.params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.array(a), (jp, js)), "cpu")
    return (jp, js), (tp, ts)


def _modes(model, **kw):
    """(JAX mode, port mode): CADC at crossbar 64 with the model's fn; each
    kwarg is a (JAX value, port value) pair; JAX's kernel defaults to
    'xla', the oracle dispatch."""
    base = dict(impl="cadc", crossbar_size=64, fn=MODELS[model][3])
    jkw = {"kernel": "xla", **{k: v[0] for k, v in kw.items()}}
    return (jcm.LayerMode(**base, **jkw),
            tcm.LayerMode(**base, **{k: v[1] for k, v in kw.items()}))


def _jctx(model, mode):
    """The JAX Ctx. The JAX SNN scans its time loop unless its Ctx carries
    an rng (unused without an ADC); an rng keeps it a Python loop, so its
    layers can be recorded."""
    return jcm.Ctx(mode, jax.random.PRNGKey(0) if model == "snn" else None)


Q8 = dict(quant=(jq.PAPER_424, tq.PAPER_424), q8_fused=(True, True))
QAT = dict(quant=(jq.PAPER_424, tq.PAPER_424))


def _scale(a):
    return max(1.0, float(np.abs(np.asarray(a)).max()))


# ---------------------------------------------------------------------------
# params carried across: the fp32 models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["auto", "torch"])
@pytest.mark.parametrize("model", ["vgg16", "snn"])
def test_params_from_numpy_fp32_models_agree(model, kernel):
    """One set of JAX-initialized params: eval logits (and VGG-16's
    train-mode logits and BN state) within 1e-4 of scale."""
    jmod, tmod, _, _ = MODELS[model]
    (jp, js), (tp, ts) = _params(model)
    jm, tm = _modes(model, kernel=("xla", kernel))
    x = _x(model)
    for train in (False, True):
        a, jns = jax.jit(lambda p, s, xx: jmod.apply(
            p, s, xx, _jctx(model, jm), train=train))(jp, js, jnp.asarray(x))
        b, tns = tmod.apply(tp, ts, torch.from_numpy(x), tcm.Ctx(tm),
                            train=train)
        assert np.abs(b.detach().numpy() - np.asarray(a)).max() <= \
            TOL * _scale(a)
        for k in jns:
            for s in jns[k]:
                assert np.abs(tns[k][s].numpy() - np.asarray(jns[k][s])
                              ).max() <= TOL * _scale(jns[k][s])


@pytest.mark.parametrize("fn", ["relu", "sublinear"])
def test_snn_fp32_training_gradients(fn):
    """BPTT through the arctan surrogate: loss and every gradient within
    1e-4 of scale, kernel path (plain K3 / K1g / K2)."""
    (jp, js), (tp, ts) = _params("snn")
    x = _x("snn")
    labels = np.array([3, 7])
    jm = jcm.LayerMode(impl="cadc", crossbar_size=64, fn=fn, kernel="xla")

    def loss(p):
        lg, _ = jsnn.apply(p, js, jnp.asarray(x), jcm.Ctx(jm), train=True)
        return jloop.cross_entropy(lg, jnp.asarray(labels))

    lj, gj = jax.jit(jax.value_and_grad(loss))(jp)
    flat = [t.requires_grad_() for t in tloop._flatten(tp)]
    lg, _ = tsnn.apply(tp, ts, torch.from_numpy(x),
                       tcm.Ctx(tcm.LayerMode(impl="cadc", crossbar_size=64,
                                             fn=fn)), train=True)
    lt = tloop.cross_entropy(lg, torch.from_numpy(labels))
    gt = torch.autograd.grad(lt, flat)
    assert abs(lt.item() - float(lj)) <= TOL * _scale(lj)
    for a, b in zip(gt, jax.tree_util.tree_leaves(gj)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL * _scale(b)


def test_spike_surrogate_gradient():
    v = torch.tensor([0.2, 0.99, 1.0, 1.01, 3.0], requires_grad=True)
    s = tsnn.spike(v)
    assert torch.equal(s, torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0]))
    (g,) = torch.autograd.grad(s.sum(), v)
    want = 1.0 / (1.0 + (np.pi * (v.detach().numpy() - 1.0)) ** 2)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)


def test_vgg16_published_width_parameter_count():
    p, _ = tvgg.init(torch.Generator().manual_seed(0), num_classes=100,
                     device="cpu")
    n = sum(t.numel() for t in tloop._flatten(p))
    assert 15_200_000 < n < 15_400_000   # ~15.3 M at 100 classes


# ---------------------------------------------------------------------------
# q8 inference
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recording():
    """Record every weight layer of a JAX forward — its kind and kwargs in
    `meta`, its (params, input, output) in `layers` — and every
    quantize_codes call of both packages (input, codes, lsb), restoring
    the modules after. Under jax.jit the JAX records are tracers, which the
    traced function returns."""
    rec = {"meta": [], "layers": [], "jax": [], "torch": [], "alpha": []}
    saved = [(jcm, n, getattr(jcm, n))
             for n in ("linear_forward", "conv_forward")]
    saved += [(jq, "quantize_codes", jq.quantize_codes),
              (tq, "quantize_codes", tq.quantize_codes),
              (jq, "ternary_decompose", jq.ternary_decompose)]

    def layer(kind, orig):
        def wrapped(p, x, ctx, **kw):
            y = orig(p, x, ctx, **kw)
            rec["meta"].append((kind, kw))
            rec["layers"].append((p, x, y))
            return y
        return wrapped

    def codes(side, orig):
        def wrapped(x, bits):
            c, lsb = orig(x, bits)
            rec[side].append((x, c, lsb))
            return c, lsb
        return wrapped

    jcm.linear_forward = layer("linear_forward", saved[0][2])
    jcm.conv_forward = layer("conv_forward", saved[1][2])
    jq.quantize_codes = codes("jax", saved[2][2])
    tq.quantize_codes = codes("torch", saved[3][2])

    def ternary(w):
        c, alpha = saved[4][2](w)
        rec["alpha"].append(alpha)
        return c, alpha

    jq.ternary_decompose = ternary
    try:
        yield rec
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


@functools.lru_cache(maxsize=None)
def _q8_runs(model, grid):
    """One recorded q8 forward of each package on the same params and
    input: (records, JAX logits, port logits, port mode), every record as
    numpy."""
    jmod, tmod, _, _ = MODELS[model]
    (jp, js), (tp, ts) = _params(model, grid=grid)
    jm, tm = _modes(model, **Q8)
    x = _x(model)
    with _recording() as rec:
        def fwd(p, xx):
            a, _ = jmod.apply(p, js, xx, _jctx(model, jm))
            return a, rec["layers"], rec["jax"], rec["alpha"]

        a, layers, jcodes, alphas = jax.jit(fwd)(jp, jnp.asarray(x))
        b, _ = tmod.apply(tp, ts, torch.from_numpy(x), tcm.Ctx(tm))
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    out = {"layers": [(kind, to_np(p), np.array(xx), kw, np.array(y),
                       float(al))
                      for (kind, kw), (p, xx, y), al in zip(rec["meta"],
                                                            layers, alphas)],
           "jax": [(np.array(xx), np.array(c), float(lsb))
                   for xx, c, lsb in jcodes],
           "torch": [(xx.numpy(), c.numpy(), float(lsb))
                     for xx, c, lsb in rec["torch"]]}
    return out, np.asarray(a), b.numpy(), tm


@pytest.mark.parametrize("model", ["lenet5", "resnet18", "vgg16", "snn"])
def test_q8_layers_match_jax(model):
    """Each q8 layer of the JAX forward (jitted), fed to the port's layer:
    the same activation codes bitwise; the same output within the
    relative difference of the layer's scale (twice it: f may be quadratic
    in the scale) plus 1e-6 of scale. Under jit XLA divides by the level
    count as a product with its reciprocal, so the JAX lsb may differ by an
    ulp, and fuses the layer's dequantization and sum (the bitwise
    op-level parity is test_torch_cadc_q8's)."""
    rec, _, _, tm = _q8_runs(model, False)
    assert len(rec["layers"]) == len(rec["jax"]) == {
        "lenet5": 5, "resnet18": 21, "vgg16": 16, "snn": 12}[model]
    for (kind, p, x, kw, want, ja), (_, jc, jlsb) in zip(rec["layers"],
                                                         rec["jax"]):
        tc, tlsb = tq.quantize_codes(torch.from_numpy(x), 4)
        tlsb = float(tlsb)
        assert np.array_equal(tc.numpy(), jc)
        assert abs(tlsb - jlsb) <= 2.5e-7 * jlsb      # an ulp at most
        tp = tcm.params_from_numpy(p, "cpu")
        got = getattr(tcm, kind)(tp, torch.from_numpy(x), tcm.Ctx(tm),
                                 **kw).numpy()
        ta = float(tq.ternary_decompose(tp["w"])[1])
        rel = 2 * abs(ta * tlsb - ja * jlsb) / (ja * jlsb)
        assert np.abs(got - want).max() <= (rel + 1e-6) * _scale(want)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("model", ["lenet5", "resnet18", "vgg16", "snn"])
def test_q8_logits_match_jax(model, grid):
    """End to end, q8 layers on K4 / K5's plain versions against the JAX
    `kernel="xla"` dispatch (module docstring: code flips at ties)."""
    rec, a, b, _ = _q8_runs(model, grid)
    assert len(rec["jax"]) == len(rec["torch"]) > 0
    diffs = [int((cj != ct).sum()) for (_, cj, _), (_, ct, _)
             in zip(rec["jax"], rec["torch"])]
    print(f"{model} grid={grid}: activation codes differing per q8 layer "
          f"{diffs} of {[c.size for _, c, _ in rec['jax']]}")
    first = next((i for i, d in enumerate(diffs) if d), None)
    if first is None:
        assert np.abs(b - a).max() <= 1e-5 * _scale(a)
        if grid and model == "snn":
            np.testing.assert_array_equal(b, a)
        return
    xj, cj, lsb = rec["jax"][first]
    ct = rec["torch"][first][1]
    flip = cj != ct
    assert np.abs(cj[flip].astype(int) - ct[flip].astype(int)).max() == 1
    level = np.clip(xj / (lsb * 7), -1, 1) * 7
    assert np.abs(np.abs(level[flip] - np.floor(level[flip])) - 0.5).max() \
        <= 1e-4


def test_q8_layers_block_gradients():
    """q8_fused is inference-only: no gradient reaches w or x through a
    q8 layer (the JAX stop_gradient), while the bias still learns."""
    _, tm = _modes("resnet18", **Q8)
    rng = np.random.RandomState(2)
    pc = {"w": torch.from_numpy(rng.randn(3, 3, 8, 8).astype(np.float32)
                                ).requires_grad_()}
    x = torch.from_numpy(rng.randn(1, 6, 6, 8).astype(np.float32)
                         ).requires_grad_()
    y = tcm.conv_forward(pc, x, tcm.Ctx(tm))
    assert not y.requires_grad
    pl = {"w": torch.from_numpy(rng.randn(96, 10).astype(np.float32)
                                ).requires_grad_(),
          "b": torch.zeros(10, requires_grad=True)}
    xl = torch.from_numpy(rng.randn(4, 96).astype(np.float32)
                          ).requires_grad_()
    gw, gx, gb = torch.autograd.grad(
        tcm.linear_forward(pl, xl, tcm.Ctx(tm)).sum(),
        (pl["w"], xl, pl["b"]), allow_unused=True)
    assert gw is None and gx is None
    assert torch.equal(gb, torch.full((10,), 4.0))


def test_q8_path_needs_ternary_quantization():
    """_use_q8: q8_fused with quant off, or non-ternary weights, takes the
    float path, as in JAX."""
    for quant in (tq.FP32, tq.QuantConfig(weight_bits=4)):
        mode = tcm.LayerMode(impl="cadc", quant=quant, q8_fused=True)
        assert not tcm._use_q8(mode)
    assert tcm._use_q8(tcm.LayerMode(quant=tq.PAPER_424, q8_fused=True))


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

LAYERS = [  # (kind, weight shape, input shape, kwargs)
    ("conv", (3, 3, 3, 16), (2, 8, 8, 3), {}),
    ("conv", (3, 3, 16, 32), (2, 8, 8, 16), {}),
    ("conv", (1, 1, 16, 32), (2, 8, 8, 16), {"stride": (2, 2)}),
    ("linear", (300, 40), (6, 300), {}),
]


def _jax_layer(kind, mode, kw):
    """The jitted JAX layer forward (params, x) -> y."""
    fwd = getattr(jcm, f"{kind}_forward")
    return jax.jit(lambda p, x: fwd(p, x, jcm.Ctx(mode), **kw))


def _layer_case(kind, wshape, xshape, seed):
    rng = np.random.RandomState(seed)
    fan_in = int(np.prod(wshape[:-1]))
    p = {"w": (rng.randn(*wshape) * np.sqrt(2 / fan_in)).astype(np.float32)}
    if kind == "linear":
        p["b"] = (rng.randn(wshape[-1]) * 0.1).astype(np.float32)
    x = np.maximum(rng.randn(*xshape), 0).astype(np.float32)
    return p, x


@pytest.mark.parametrize("impl,fn", [("vconv", "relu"),
                                     ("cadc", "supralinear")])
@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_qat_layer_loss_and_grads_match_jax(layer, impl, fn):
    kind, wshape, xshape, kw = LAYERS[layer]
    p, x = _layer_case(kind, wshape, xshape, 10 + layer)
    tfwd = getattr(tcm, f"{kind}_forward")
    jm = jcm.LayerMode(impl=impl, fn=fn, quant=jq.PAPER_424, kernel="xla")
    jfwd = _jax_layer(kind, jm, kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y0 = jax.eval_shape(jfwd, jp, jnp.asarray(x))
    r = np.random.RandomState(layer).randn(*y0.shape).astype(np.float32)

    def jloss(pp, xx):
        return jnp.vdot(jfwd(pp, xx), jnp.asarray(r))

    lj, (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    for kernel in ("auto", "torch"):
        tm = tcm.LayerMode(impl=impl, fn=fn, quant=tq.PAPER_424,
                           kernel=kernel)
        tp = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in p.items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        lt = (tfwd(tp, xt, tcm.Ctx(tm), **kw) * torch.from_numpy(r)).sum()
        grads = torch.autograd.grad(lt, [*tp.values(), xt])
        assert abs(lt.item() - float(lj)) <= 1e-5 * _scale(lj)
        for got, want in zip(grads, [*(gp[k] for k in tp), gx]):
            assert np.abs(got.numpy() - np.asarray(want)).max() <= \
                TOL * _scale(want)


@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_qat_relu_layer_kernel_path_matches_torch_path(layer):
    """CADC relu QAT: loss within 1e-5 of JAX's; the kernel path's (plain
    K3 / K1g with packed gates, K2) gradients equal the core path's within
    1e-4 — the same psums on both, so the same gates."""
    kind, wshape, xshape, kw = LAYERS[layer]
    p, x = _layer_case(kind, wshape, xshape, 20 + layer)
    jm = jcm.LayerMode(impl="cadc", quant=jq.PAPER_424, kernel="xla")
    jy = _jax_layer(kind, jm, kw)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out = {}
    for kernel in ("auto", "torch"):
        tm = tcm.LayerMode(impl="cadc", quant=tq.PAPER_424, kernel=kernel)
        tp = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in p.items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        y = getattr(tcm, f"{kind}_forward")(tp, xt, tcm.Ctx(tm), **kw)
        assert np.abs(y.detach().numpy() - np.asarray(jy)).max() <= \
            1e-5 * _scale(jy)
        out[kernel] = torch.autograd.grad(y.square().sum(),
                                          [*tp.values(), xt])
    for a, b in zip(out["auto"], out["torch"]):
        assert (a - b).abs().max().item() <= TOL * max(1.0,
                                                       b.abs().max().item())


@pytest.mark.parametrize("impl,fn", [("vconv", "relu"),
                                     ("cadc", "supralinear")])
def test_snn_qat_loss_and_grads_match_jax(impl, fn):
    """Gates continuous at psum 0 only: the fake-quant weights w + (q - w)
    are q up to rounding, so an exact-zero integer sum is a tiny psum of
    either sign in either framework, which decides a relu gate and makes
    sublinear's f'(p) = 0.5 / sqrt(p) unbounded."""
    (jp, js), (tp, ts) = _params("snn")
    x = _x("snn")
    labels = np.array([1, 9])
    jm = jcm.LayerMode(impl=impl, crossbar_size=64, fn=fn,
                       quant=jq.PAPER_424, kernel="xla")

    def loss(p):
        lg, _ = jsnn.apply(p, js, jnp.asarray(x), _jctx("snn", jm),
                           train=True)
        return jloop.cross_entropy(lg, jnp.asarray(labels))

    lj, gj = jax.jit(jax.value_and_grad(loss))(jp)
    flat = [t.requires_grad_() for t in tloop._flatten(tp)]
    tm = tcm.LayerMode(impl=impl, crossbar_size=64, fn=fn,
                       quant=tq.PAPER_424)
    lg, _ = tsnn.apply(tp, ts, torch.from_numpy(x), tcm.Ctx(tm), train=True)
    lt = tloop.cross_entropy(lg, torch.from_numpy(labels))
    gt = torch.autograd.grad(lt, flat)
    assert abs(lt.item() - float(lj)) <= TOL * _scale(lj)
    for a, b in zip(gt, jax.tree_util.tree_leaves(gj)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL * _scale(b)


def test_qat_then_q8_eval_through_the_loop():
    """train.loop.train with a QAT mode and a q8 eval mode: finite losses,
    and the final evaluation runs the q8 layers (their output is the q8
    oracle's: eval under kernel 'torch' gives the same numbers)."""
    data = tsyn.make_classification_dataset(
        tsyn.ClassificationSpec(n_classes=10, hw=32, channels=3, noise=0.9,
                                seed=2), device="cpu")
    mode = tcm.LayerMode(impl="cadc", crossbar_size=64, quant=tq.PAPER_424)
    q8 = dataclasses.replace(mode, q8_fused=True)
    out = tloop.train(init_fn=tvgg.init, apply_fn=tvgg.apply, batch_fn=data,
                      mode=mode, eval_mode=q8,
                      cfg=tloop.TrainConfig(steps=2, batch_size=4,
                                            eval_every=1, eval_batches=1),
                      init_kwargs={"num_classes": 10, "width_div": 16},
                      device="cpu")
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    again = tloop.evaluate(tvgg.apply, out["params"], out["state"], data,
                           dataclasses.replace(q8, kernel="torch"),
                           n_batches=1, batch_size=4)
    assert again == out["eval"]


# ---------------------------------------------------------------------------
# the ADC model (Fig. 9)
# ---------------------------------------------------------------------------

ADC = (jadc.AdcConfig(bits=4), tadc.AdcConfig(bits=4))


def _adc_linear(kernel, adc, *, quant=tq.FP32, q8=False, rng=7):
    mode = tcm.LayerMode(impl="cadc", crossbar_size=64, kernel=kernel,
                         adc=adc, quant=quant, q8_fused=q8)
    g = np.random.RandomState(0)
    p = {"w": torch.from_numpy(g.randn(96, 32).astype(np.float32)),
         "b": torch.zeros(32)}
    x = torch.from_numpy(g.randn(4, 96).astype(np.float32))
    return tcm.linear_forward(p, x, tcm.Ctx(mode, rng))


def _adc_conv(kernel, adc, rng=7):
    mode = tcm.LayerMode(impl="cadc", crossbar_size=32, kernel=kernel,
                         adc=adc)
    g = np.random.RandomState(1)
    p = {"w": torch.from_numpy((g.randn(3, 3, 8, 16) * 0.1).astype(
        np.float32))}
    x = torch.from_numpy(g.randn(2, 8, 8, 8).astype(np.float32))
    return tcm.conv_forward(p, x, tcm.Ctx(mode, rng))


@pytest.mark.parametrize("kernel", ["auto", "cuda"])
def test_adc_survives_kernel_mode(kernel):
    """The port's test_adc_kernel_fallback: a kernel mode with the ADC
    takes the core path — no kernel launch, not even for impl 'cuda' on
    CPU tensors, which would raise — bitwise the torch path under one
    seed, and different from the noise-free output."""
    for layer in (_adc_linear, _adc_conv):
        y_kernel = layer(kernel, ADC[1])
        assert torch.equal(y_kernel, layer("torch", ADC[1]))
        assert not torch.equal(y_kernel, layer("torch", None))


def test_q8_with_adc_falls_back():
    y_ref = _adc_linear("torch", ADC[1], quant=tq.PAPER_424, q8=True)
    y_kernel = _adc_linear("auto", ADC[1], quant=tq.PAPER_424, q8=True)
    y_clean = _adc_linear("torch", None, quant=tq.PAPER_424, q8=True)
    assert torch.equal(y_kernel, y_ref)
    assert not torch.equal(y_kernel, y_clean)


def test_adc_deterministic_given_rng():
    assert torch.equal(_adc_linear("auto", ADC[1]),
                       _adc_linear("auto", ADC[1]))
    assert not torch.equal(_adc_linear("auto", ADC[1]),
                           _adc_linear("auto", ADC[1], rng=8))
    # rng None: the quantization alone, the same as any seed's clean path
    assert torch.equal(_adc_linear("auto", ADC[1], rng=None),
                       _adc_linear("torch", dataclasses.replace(
                           ADC[1], noise_sigma=0.0, noise_mu=0.0)))


@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_noise_free_adc_layer_matches_jax(layer):
    """Without noise the ADC layer is the JAX one within 1e-5 of scale
    (its psums are fp32 sums in another order; no code lands on a tie)."""
    kind, wshape, xshape, kw = LAYERS[layer]
    p, x = _layer_case(kind, wshape, xshape, 30 + layer)
    jm = jcm.LayerMode(impl="cadc", crossbar_size=64, adc=ADC[0],
                       kernel="xla")
    tm = tcm.LayerMode(impl="cadc", crossbar_size=64, adc=ADC[1])
    a = _jax_layer(kind, jm, kw)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    b = getattr(tcm, f"{kind}_forward")(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcm.Ctx(tm), **kw)
    assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-5 * _scale(a)


def test_adc_noise_seeds_in_the_loop():
    """evaluate(rng=...) draws batch i's noise from fold_in(rng, i): the
    same seed repeats, another differs, None is noise-free; train under
    an ADC mode seeds every step from fold_in(seed + 17, step)."""
    data = tsyn.make_classification_dataset(
        tsyn.ClassificationSpec(n_classes=10, hw=16, channels=3, noise=0.9,
                                seed=1), device="cpu")
    p, s = tresnet.init(torch.Generator().manual_seed(0), width=4,
                        device="cpu")
    mode = tcm.LayerMode(impl="cadc", crossbar_size=16, adc=ADC[1])
    ev = lambda rng: tloop.evaluate(  # noqa: E731
        tresnet.apply, p, s, data, mode, n_batches=2, batch_size=4, rng=rng)
    assert ev(5) == ev(5)
    assert ev(5)["loss"] != ev(6)["loss"] != ev(None)["loss"]
    cfg = tloop.TrainConfig(steps=2, batch_size=4, eval_batches=1)
    runs = [tloop.train(apply_fn=tresnet.apply, batch_fn=data,
                        initial=(p, s), mode=mode, cfg=cfg, device="cpu",
                        optimizer=None)["history"] for _ in range(2)]
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# event data
# ---------------------------------------------------------------------------

def test_event_dataset_is_a_function_of_seed_and_step():
    fn = tsyn.make_event_dataset(n_classes=11, hw=16, t_steps=6, seed=3,
                                 device="cpu")
    a, b, c = fn(2, 8), fn(2, 8), fn(3, 8)
    assert torch.equal(a["events"], b["events"])
    assert not torch.equal(a["events"], c["events"])
    assert a["events"].shape == (8, 6, 16, 16, 2)
    assert set(a["events"].unique().tolist()) <= {0.0, 1.0}
    assert a["label"].dtype == torch.int64 and int(a["label"].max()) < 11
    # firing rates between 0.02 and 0.37, as the JAX generator's
    rate = fn(0, 512)["events"].mean().item()
    assert 0.02 < rate < 0.37
