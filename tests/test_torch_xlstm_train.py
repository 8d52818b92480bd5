"""The mLSTM and sLSTM training forms in the port against the JAX package,
on the CPU.

xlstm-1.3b's smoke config, CADC linears, fp32, TF32 off. The port draws
the parameters (the norm scales and biases jittered off zero so their
gradients are tested too); the JAX package gets them as numpy arrays, and
the inputs and the output cotangent are made from a seed with numpy. JAX
runs its default kernel_impl="xla" (the oracle); the port its plain path.
Tolerance: the JAX package's fp32 bound, 1e-4 of scale
(tests/test_kernel_grads.py TOL).

  * mlstm_apply in both forms (mlstm_chunk 0: the sequential cell; 16 at
    S = 64: the chunkwise one) and slstm_apply: outputs and every
    gradient against jax.vjp;
  * the twin of tests/test_mlstm_chunkwise.py: the port's chunkwise form
    equal to its sequential form within 1e-4 (relative norm) at (S, chunk)
    = (32, 8), (64, 16), (64, 64), (96, 32), and at the gate scales 0.5, 2
    and 5;
  * each training form against the port's decode cell run token by token;
  * every gradient finite from the init state (m = -inf), also where a
    chunk's decay rows underflow to exact zeros;
  * an mLSTM and an sLSTM layer under remat (torch.utils.checkpoint) and
    without it give bitwise-equal gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import xlstm as jxl
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import transformer as ttf
from repro_torch.models.lm import xlstm as txl

TOL = 1e-4
# the training forms and the decode cell add in another order (fp32
# rounding only; the chunkwise form also telescopes the stabilizer)
DECODE_TOL = 1e-5
CPU = torch.device("cpu")
ARCH = "xlstm_13b"
B, S = 2, 64

# kind / mLSTM form -> (port apply, JAX apply, mlstm_chunk)
FORMS = {
    "mlstm.sequential": (txl.mlstm_apply, jxl.mlstm_apply, 0),
    "mlstm.chunkwise": (txl.mlstm_apply, jxl.mlstm_apply, 16),
    "slstm": (txl.slstm_apply, jxl.slstm_apply, 0),
}


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


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: err / scale {err:.3g} > {tol}"


def _jitter(tree, seed):
    """The port's params with every norm scale and bias moved off its zero
    init (N(0, 0.1)), so that their gradients are not trivially equal."""
    gen = torch.Generator().manual_seed(seed)

    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    v + 0.1 * torch.randn(v.shape, generator=gen)
                    if k in ("scale", "b") else v) for k, v in t.items()}

    return walk(tree)


def _leaves(tree) -> list:
    out = []
    ttf.tree_map(out.append, tree)
    return out


def _port_vjp(fn, params, x, cot):
    """(fn(params, x), d<fn, cot>/d params as numpy, d/dx)."""
    live = ttf.tree_map(lambda t: t.detach().requires_grad_(), params)
    xt = torch.as_tensor(x).requires_grad_()
    y = fn(live, xt)
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum(),
                                _leaves(live) + [xt])
    it = iter(grads)
    gtree = ttf.tree_map(lambda _: next(it).numpy(), live)
    return y.detach().numpy(), gtree, next(it).numpy()


def _jax_vjp(fn, params, x, cot):
    tree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().numpy()), params)
    y, vjp = jax.vjp(fn, tree, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    return (np.asarray(y), jax.tree_util.tree_map(np.asarray, gp),
            np.asarray(gx))


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _setup(form):
    """(port apply, JAX apply, port cfg, JAX cfg, jittered port params)."""
    tfn, jfn, chunk = FORMS[form]
    tcfg = tsmoke(ARCH, linear_impl="cadc").with_overrides(mlstm_chunk=chunk)
    jcfg = jsmoke(ARCH, linear_impl="cadc").with_overrides(mlstm_chunk=chunk)
    init = txl.mlstm_init if form.startswith("mlstm") else txl.slstm_init
    p = _jitter(init(torch.Generator().manual_seed(0), tcfg, CPU), 1)
    return tfn, jfn, tcfg, jcfg, p


@pytest.mark.parametrize("form", list(FORMS))
def test_training_form_matches_jax(form):
    tfn, jfn, tcfg, jcfg, p = _setup(form)
    x, cot = _x((B, S, tcfg.d_model), 2), _x((B, S, tcfg.d_model), 3)
    y, gp, gx = _port_vjp(lambda pp, xx: tfn(pp, xx, tcfg), p, x, cot)
    jy, jgp, jgx = _jax_vjp(lambda pp, xx: jfn(pp, xx, jcfg), p, x, cot)
    _close(y, jy, "output")
    _close(gx, jgx, "grad x")
    a = jax.tree_util.tree_flatten_with_path(gp)
    b = jax.tree_util.tree_flatten_with_path(jgp)
    assert a[1] == b[1]
    for (path, g), (_, w) in zip(a[0], b[0]):
        assert np.isfinite(g).all(), jax.tree_util.keystr(path)
        _close(g, w, f"grad {jax.tree_util.keystr(path)}")


def _qkvif(b, s, h, dh, seed, gate_scale=2.0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, generator=gen) for _ in range(3))
    ir, fr = (torch.randn(b, s, h, generator=gen) * gate_scale
              for _ in range(2))
    return q, k, v, ir, fr


def _rel(got, want) -> float:
    return float(torch.linalg.norm(got - want) / (torch.linalg.norm(want)
                                                  + 1e-9))


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64), (96, 32)])
def test_chunkwise_equals_sequential(s, chunk):
    q, k, v, ir, fr = _qkvif(2, s, 3, 8, 0)
    ref = txl._mlstm_sequential(q, k, v, ir, fr, dh=8)
    out = txl._mlstm_chunkwise(q, k, v, ir, fr, chunk=chunk, dh=8)
    assert _rel(out, ref) < 1e-4


@pytest.mark.parametrize("gate_scale", [0.5, 2.0, 5.0])
def test_chunkwise_equals_sequential_across_gate_scales(gate_scale):
    """Large f / i logs exercise the log-space max telescoping."""
    for seed in range(5):
        q, k, v, ir, fr = _qkvif(1, 32, 2, 4, seed, gate_scale)
        ref = txl._mlstm_sequential(q, k, v, ir, fr, dh=4)
        out = txl._mlstm_chunkwise(q, k, v, ir, fr, chunk=8, dh=4)
        assert _rel(out, ref) < 1e-4, (seed, _rel(out, ref))


def _decode_run(form, p, x, cfg):
    decode, init_state = ((txl.mlstm_decode, txl.mlstm_init_state)
                          if form.startswith("mlstm") else
                          (txl.slstm_decode, txl.slstm_init_state))
    state, ys = init_state(cfg, x.shape[0], CPU), []
    for t in range(x.shape[1]):
        y, state = decode(p, x[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("form", list(FORMS))
def test_training_form_equals_the_decode_cell_token_by_token(form):
    tfn, _, tcfg, _, p = _setup(form)
    x = torch.as_tensor(_x((B, S, tcfg.d_model), 5))
    with torch.no_grad():
        _close(tfn(p, x, tcfg), _decode_run(form, p, x, tcfg), "y",
               DECODE_TOL)


def test_chunkwise_grads_finite_where_decay_rows_underflow():
    """From m = -inf, and in a chunk whose decay rows are all exact zeros:
    chunk 0's i gates at +60 leave m ~ 60 in the carry, chunk 1's first
    rows take i at -60, so their intra-chunk weights e^{a - m} underflow to
    0 (and the inter-chunk term carries them). Every gradient finite, and
    the output and the gradients the sequential form's."""
    b, s, h, dh, chunk = 1, 32, 2, 4, 16
    q, k, v, ir, fr = _qkvif(b, s, h, dh, 3, 1.0)
    ir[:, :chunk] += 60.0
    ir[:, chunk:chunk + 8] -= 60.0
    cot = torch.randn(b, s, h, dh, generator=torch.Generator().manual_seed(4))
    outs = []
    for run in (lambda *t: txl._mlstm_chunkwise(*t, chunk=chunk, dh=dh),
                lambda *t: txl._mlstm_sequential(*t, dh=dh)):
        ins = [t.clone().requires_grad_() for t in (q, k, v, ir, fr)]
        y = run(*ins)
        grads = torch.autograd.grad((y * cot).sum(), ins)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        outs.append((y.detach(), grads))
    (yc, gc), (ys, gs) = outs
    assert _rel(yc, ys) < 1e-4
    for a, w in zip(gc, gs):
        _close(a, w, "grad")


@pytest.mark.parametrize("form", list(FORMS))
def test_grads_finite_from_the_init_state(form):
    """The first token meets m = -inf: e^{f + m - m_new} = 0 forward, and
    a zero (not NaN) gradient back."""
    tfn, _, tcfg, _, p = _setup(form)
    x = torch.as_tensor(_x((B, S, tcfg.d_model), 7, scale=3.0))
    live = ttf.tree_map(lambda t: t.detach().requires_grad_(), p)
    xt = x.clone().requires_grad_()
    y = tfn(live, xt, tcfg)
    grads = torch.autograd.grad(y.square().sum(), _leaves(live) + [xt])
    assert bool(torch.isfinite(y).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_remat_on_and_off_give_bitwise_grads(kind):
    tcfg = tsmoke(ARCH, linear_impl="cadc").with_overrides(mlstm_chunk=16)
    layer = _jitter(ttf._layer_init(torch.Generator().manual_seed(0), kind,
                                    tcfg, CPU), 1)
    x = torch.as_tensor(_x((B, S, tcfg.d_model), 6))
    pos = torch.arange(S)[None]

    def grads(remat):
        live = ttf.tree_map(lambda t: t.detach().requires_grad_(), layer)
        args = (live, x, kind, tcfg, pos)
        y, aux = (torch.utils.checkpoint.checkpoint(
            ttf._layer_train, *args, use_reentrant=False)
            if remat else ttf._layer_train(*args))
        assert aux is None
        return torch.autograd.grad(y.square().sum(), _leaves(live))

    on, off = grads(True), grads(False)
    assert len(on) == len(off) == len(_leaves(layer))
    assert all(torch.equal(a, b) for a, b in zip(on, off))
