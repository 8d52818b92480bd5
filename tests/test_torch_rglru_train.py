"""The RG-LRU's training form in the port against the JAX package, on the
CPU.

recurrentgemma-9b's smoke config, CADC linears, fp32, TF32 off. The port
draws the parameters (the norm scales and biases jittered off zero so
their gradients are tested too); the JAX package gets them as numpy
arrays, and the inputs and the output cotangent are made from a seed with
numpy. JAX runs its default kernel_impl="xla" (the oracle); the port its
plain path. Tolerance: the JAX package's fp32 bound, 1e-4 of scale
(tests/test_kernel_grads.py TOL).

  * _causal_conv1d and rglru_apply: outputs and every gradient (the
    parameters and the input) against jax.vjp;
  * the log-depth scan (_linear_scan) against a loop h = a * h + b over S,
    ragged and power-of-two S, values and gradients;
  * rglru_apply against the port's decode cell run token by token;
  * an rglru layer under remat (torch.utils.checkpoint) and without it
    gives bitwise-equal gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.lm import rglru as jrg
from repro.models.lm import xlstm as jxl
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models.lm import rglru as trg
from repro_torch.models.lm import transformer as ttf
from repro_torch.models.lm import xlstm as txl

TOL = 1e-4
# the scan and the decode cell add in another order (fp32 rounding only)
DECODE_TOL = 1e-5
CPU = torch.device("cpu")
ARCH = "recurrentgemma_9b"
B, S = 2, 48


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


def _port_vjp(fn, params, x, cot):
    """(fn(params, x), d<fn, cot>/d params as numpy, d/dx)."""
    live = ttf.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = []
    ttf.tree_map(leaves.append, live)
    xt = torch.as_tensor(x).requires_grad_()
    y = fn(live, xt)
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum(),
                                leaves + [xt])
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


def _assert_vjp_close(got, want):
    (y, gp, gx), (jy, jgp, jgx) = got, want
    _close(y, jy, "output")
    _close(gx, jgx, "grad x")
    a = jax.tree_util.tree_flatten_with_path(gp)
    b = jax.tree_util.tree_flatten_with_path(jgp)
    assert a[1] == b[1]
    for (path, g), (_, w) in zip(a[0], b[0]):
        _close(g, w, f"grad {jax.tree_util.keystr(path)}")


def _cfgs():
    return (tsmoke(ARCH, linear_impl="cadc"), jsmoke(ARCH, linear_impl="cadc"))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_causal_conv1d_matches_jax():
    c, width = 40, 4
    p = _jitter(txl._causal_conv1d_init(torch.Generator().manual_seed(0),
                                        width, c, CPU), 1)
    x, cot = _x((B, S, c), 2), _x((B, S, c), 3)
    got = _port_vjp(txl._causal_conv1d, p, x, cot)
    _assert_vjp_close(got, _jax_vjp(jxl._causal_conv1d, p, x, cot))


def test_causal_conv1d_is_causal():
    """Output t reads inputs t - width + 1 .. t only."""
    p = txl._causal_conv1d_init(torch.Generator().manual_seed(0), 4, 8, CPU)
    x = torch.as_tensor(_x((1, 16, 8), 4))
    y = txl._causal_conv1d(p, x)
    x2 = x.clone()
    x2[:, 9:] += 1.0
    y2 = txl._causal_conv1d(p, x2)
    assert torch.equal(y[:, :9], y2[:, :9]) and not torch.equal(y[:, 9:],
                                                                y2[:, 9:])


def _loop_scan(a, b):
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33, 100])
def test_linear_scan_matches_a_loop(s):
    gen = torch.Generator().manual_seed(s)
    a = torch.rand(3, s, 7, generator=gen).requires_grad_()
    b = torch.randn(3, s, 7, generator=gen).requires_grad_()
    cot = torch.randn(3, s, 7, generator=gen)
    got, want = trg._linear_scan(a, b), _loop_scan(a, b)
    _close(got.detach(), want.detach(), "h", 1e-6)
    # at S = 1, h_0 = b_0 reads no a: its gradient is None (0 in the loop)
    ga = torch.autograd.grad((got * cot).sum(), (a, b), allow_unused=True)
    wa = torch.autograd.grad((want * cot).sum(), (a, b))
    for g, w, name in zip(ga, wa, ("a", "b")):
        _close(torch.zeros_like(w) if g is None else g, w, f"grad {name}",
               1e-5)


def test_rglru_apply_matches_jax():
    tcfg, jcfg = _cfgs()
    p = _jitter(trg.rglru_init(torch.Generator().manual_seed(0), tcfg, CPU),
                1)
    x, cot = _x((B, S, tcfg.d_model), 2), _x((B, S, tcfg.d_model), 3)
    got = _port_vjp(lambda pp, xx: trg.rglru_apply(pp, xx, tcfg), p, x, cot)
    want = _jax_vjp(lambda pp, xx: jrg.rglru_apply(pp, xx, jcfg), p, x, cot)
    _assert_vjp_close(got, want)


def test_rglru_apply_equals_the_decode_cell_token_by_token():
    tcfg, _ = _cfgs()
    p = _jitter(trg.rglru_init(torch.Generator().manual_seed(0), tcfg, CPU),
                1)
    x = torch.as_tensor(_x((B, S, tcfg.d_model), 5))
    with torch.no_grad():
        got = trg.rglru_apply(p, x, tcfg)
        state = trg.rglru_init_state(tcfg, B, CPU)
        want = []
        for t in range(S):
            y, state = trg.rglru_decode(p, x[:, t:t + 1], tcfg, state)
            want.append(y)
    _close(got, torch.cat(want, dim=1), "y", DECODE_TOL)


def test_rglru_layer_remat_on_and_off_give_bitwise_grads():
    tcfg, _ = _cfgs()
    layer = _jitter(ttf._layer_init(torch.Generator().manual_seed(0),
                                    "rglru", tcfg, CPU), 1)
    x = torch.as_tensor(_x((B, S, tcfg.d_model), 6))
    pos = torch.arange(S)[None]

    def grads(remat):
        live = ttf.tree_map(lambda t: t.detach().requires_grad_(), layer)
        leaves = []
        ttf.tree_map(leaves.append, live)
        args = (live, x, "rglru", tcfg, pos)
        y, aux = (torch.utils.checkpoint.checkpoint(
            ttf._layer_train, *args, use_reentrant=False)
            if remat else ttf._layer_train(*args))
        assert aux is None
        return torch.autograd.grad(y.square().sum(), leaves)

    on, off = grads(True), grads(False)
    assert len(on) == len(off) == 15
    assert all(torch.equal(a, b) for a, b in zip(on, off))
