"""The port's CADC conv against the JAX package.

`_segment_taps`, `im2col` and `_col2im` must equal the JAX package's. The
plain version of K3 (`cadc_conv2d_torch`, reached through the conv's
autograd Function in kernels/ops.py on CPU tensors) and its backward (K2's
plain version over im2col patches, then `_col2im`) must give the outputs
and gradients of `repro.core.conv.cadc_conv2d` and jax.grad of it within
1e-4 — the JAX package's TOL — over stride 1 and 2, SAME / VALID /
explicit padding, 1x1 to 5x5 kernels, and a contraction shorter than a
crossbar. The Pallas conv is not the reference: it cannot run on jax
0.9.0. Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv
from repro.kernels.cadc_conv import _col2im as jcol2im
from repro.kernels.cadc_conv import _segment_taps as jtaps
from repro_torch.core import conv as tconv
from repro_torch.kernels import cadc_conv as tcc
from repro_torch.kernels import ops as tops

TOL = 1e-4

# (B, H, W, Cin, K, Cout, stride, padding, xbar)
CASES = [
    (2, 12, 12, 1, 5, 6, (1, 1), "VALID", 64),     # LeNet conv1: D = 25 < xbar
    (2, 7, 7, 6, 5, 16, (1, 1), "VALID", 64),      # LeNet conv2: taps span segments
    (2, 8, 8, 3, 3, 8, (1, 1), "SAME", 64),        # ResNet stem: D = 27
    (2, 8, 8, 16, 3, 24, (2, 2), "SAME", 64),      # stride 2, SAME
    (2, 9, 9, 16, 3, 8, (2, 2), "VALID", 128),     # stride 2, VALID, odd H
    (2, 8, 8, 32, 1, 16, (2, 2), "SAME", 64),      # 1x1 projection
    (1, 9, 7, 8, 3, 12, (2, 1), ((1, 0), (2, 1)), 64),  # explicit pads
    (1, 6, 6, 40, 5, 10, (1, 1), "SAME", 256),     # 5x5, several taps a segment
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(case, seed=0):
    b, h, w, cin, k, cout, *_ = case
    rng = np.random.RandomState(seed + h * 31 + cin)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(
        np.float32)
    return x, wt


@pytest.mark.parametrize("k1,k2,c,xbar", [(5, 5, 1, 64), (5, 5, 6, 64),
                                          (3, 3, 64, 64), (3, 3, 64, 128),
                                          (3, 3, 3, 64), (1, 1, 512, 256),
                                          (3, 3, 40, 64), (3, 3, 512, 256)])
def test_segment_taps_match_jax(k1, k2, c, xbar):
    assert tcc._segment_taps(k1, k2, c, xbar) == jtaps(k1, k2, c, xbar)


@pytest.mark.parametrize("case", CASES)
def test_im2col_and_col2im_match_jax(case):
    *_, k, _, stride, padding, _ = case
    x, _ = _inputs(case)
    want = jax.jit(lambda a: jconv.im2col(a, (k, k), stride=stride,
                                          padding=padding))(x)
    got = tconv.im2col(torch.from_numpy(x), (k, k), stride=stride,
                       padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dp = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    np.testing.assert_allclose(
        tcc._col2im(torch.from_numpy(dp), x.shape, (k, k), stride,
                    padding).numpy(),
        np.asarray(jax.jit(lambda a: jcol2im(a, x.shape, (k, k), stride,
                                             padding))(dp)),
        rtol=1e-6, atol=1e-6)
    assert tconv.conv_output_positions(x.shape[1:3], (k, k), stride,
                                       padding) == jconv.conv_output_positions(
        x.shape[1:3], (k, k), stride, padding)


@pytest.mark.parametrize("fn", ["relu", "identity"])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_grads_match_jax(case, fn):
    *_, k, _, stride, padding, xbar = case
    x, w = _inputs(case)
    kw = dict(crossbar_size=xbar, fn=fn, stride=stride, padding=padding)
    r = np.random.RandomState(2).randn(
        *jax.eval_shape(lambda a, b: jconv.cadc_conv2d(a, b, **kw), x,
                        w).shape).astype(np.float32)

    @jax.jit
    def reference(a, b):
        y, vjp = jax.vjp(lambda a_, b_: jconv.cadc_conv2d(a_, b_, **kw), a, b)
        return (y, *vjp(jnp.asarray(r)))

    want, hx, hw = reference(x, w)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tops.cadc_conv2d(xt, wt, impl="auto", **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    (y * torch.from_numpy(r)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(hx)).max() <= TOL
    assert np.abs(wt.grad.numpy() - np.asarray(hw)).max() <= TOL


@pytest.mark.parametrize("save_gate", ["packed", "bytes", "recompute"])
def test_save_gate_modes_give_jax_grads(save_gate):
    case = CASES[1]
    *_, k, _, stride, padding, xbar = case
    x, w = _inputs(case, seed=5)
    kw = dict(crossbar_size=xbar, fn="relu", stride=stride, padding=padding)
    hx, hw = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jconv.cadc_conv2d(a, b, **kw)),
        argnums=(0, 1)))(x, w)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tops.cadc_conv2d(xt, wt, save_gate=save_gate, **kw).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(hx)).max() <= TOL
    assert np.abs(wt.grad.numpy() - np.asarray(hw)).max() <= TOL


def test_plain_gate_layout():
    """The conv gate is [S, B, OH, OW, ceil(Cout/32)] words (Cout = 16
    pads to one word), whose bits are the bytes gate's."""
    case = CASES[1]
    x, w = _inputs(case)
    y, gate = tcc.cadc_conv2d_torch(torch.from_numpy(x), torch.from_numpy(w),
                                    crossbar_size=64, fn="relu",
                                    padding="VALID", mode="packed")
    assert gate.shape == (3, 2, 3, 3, 1) and gate.dtype == torch.int32
    y2, gate2 = tcc.cadc_conv2d_torch(torch.from_numpy(x),
                                      torch.from_numpy(w), crossbar_size=64,
                                      fn="relu", padding="VALID",
                                      mode="bytes")
    assert gate2.shape == (3, 2, 3, 3, 16)
    np.testing.assert_array_equal(
        tcc._cm._unpack_mask(gate, 16).bool().numpy(), gate2.numpy())
    np.testing.assert_array_equal(y.numpy(), y2.numpy())


def test_empty_batch_takes_core_path():
    x = torch.zeros(0, 8, 8, 3)
    w = torch.randn(3, 3, 3, 4)
    assert tops.cadc_conv2d(x, w, crossbar_size=64).shape == (0, 8, 8, 4)
