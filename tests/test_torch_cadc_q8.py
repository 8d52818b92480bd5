"""The q8 kernels' plain versions (K4, K5) and their straight-through
gradients against the JAX package, on the CPU.

Inputs are integer codes made with numpy from a seed; both packages get
the same codes and the same fp32 scale.
  * Forward: the plain K4 / K5 (what ops.cadc_matmul_q8 / cadc_conv2d_q8
    run on CPU tensors) equal the JAX oracle (`impl="xla"`, the sequential
    q8 oracle of kernels/ref.py) BITWISE for relu / identity / sublinear /
    supralinear: integer psums have one true answer and every later fp32
    step is the same operation in the same order; so does K4's Pallas
    kernel in interpret mode, but for identity, where XLA fuses its
    dequantize-and-add (test_plain_k4_equals_jax_interpret). tanh is held
    at 1e-6 of scale (XLA's tanh is not torch's). The JAX Pallas K5 does not run on this jax (pl.load), so K5
    is held against the oracle only.
  * Gradients: the port's straight-through VJP (K2's plain version on the
    codes as fp32, times scale; d(scale) = <dw_unscaled, w>) within 1e-4
    of jax.grad — of K4 in interpret mode for the matmul, and of the float
    oracle sum_s f(scale * p_s) for the conv (the template of
    tests/test_kernel_grads.py::TestQ8Grads) — in every save_gate mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as jconv
from repro.kernels import ops as jops
from repro.kernels.cadc_matmul import cadc_matmul_q8_pallas
from repro_torch.kernels import cadc_conv as tcc
from repro_torch.kernels import cadc_matmul as tcm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-4
EXACT_FNS = ["relu", "identity", "sublinear", "supralinear"]
SCALE = np.float32(0.0123)


def _codes(seed, shape, lo, hi):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_fn_equal(got, want, fn):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if fn == "tanh":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", EXACT_FNS + ["tanh"])
@pytest.mark.parametrize("xbar", [64, 128, 256])
@pytest.mark.parametrize("d", [300, 512])
def test_plain_k4_equals_jax_oracle(fn, xbar, d):
    """D = 300 is not a multiple of any crossbar; leading dims flattened."""
    x = _codes(d + xbar, (3, 5, d), -7, 8)
    w = _codes(xbar, (d, 40), -1, 2)
    want = jops.cadc_matmul_q8(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(SCALE), crossbar_size=xbar, fn=fn,
                               impl="xla")
    for impl in ("auto", "torch"):
        got = tops.cadc_matmul_q8(_t(x), _t(w), _t(SCALE), crossbar_size=xbar,
                                  fn=fn, impl=impl)
        assert got.dtype == torch.float32
        _assert_fn_equal(got.numpy(), want, fn)
    # the oracle of the port equals the JAX one too
    _assert_fn_equal(tref.cadc_matmul_q8_ref(
        _t(x), _t(w), _t(SCALE), crossbar_size=xbar, fn=fn).numpy(), want, fn)


@pytest.mark.parametrize("fn", EXACT_FNS)
@pytest.mark.parametrize("xbar", [64, 128])
def test_plain_k4_equals_jax_interpret(fn, xbar):
    """Bitwise, except identity: there XLA's CPU compiler contracts the
    interpret kernel's `acc + float(p) * scale` into one fma, so K4 in
    interpret mode differs from the JAX package's own xla oracle (by an
    ulp of the sum, on ~40% of the elements here) while the port, which
    rounds twice as the oracle does, equals the oracle bitwise; held at
    1e-6 of scale against interpret."""
    x = _codes(1, (24, 200), -127, 128)   # full int8 range of the codes
    w = _codes(2, (200, 24), -1, 2)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(SCALE))
    want = np.asarray(cadc_matmul_q8_pallas(
        *args, crossbar_size=xbar, fn=fn, block_m=16, block_n=16,
        interpret=True))
    oracle = np.asarray(jops.cadc_matmul_q8(*args, crossbar_size=xbar, fn=fn,
                                            impl="xla"))
    got = tops.cadc_matmul_q8(_t(x), _t(w), _t(SCALE), crossbar_size=xbar,
                              fn=fn).numpy()
    np.testing.assert_array_equal(got, oracle)
    if fn == "identity":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["relu", "sublinear"])
def test_plain_k4_gate_is_the_dequantized_psums(fn):
    """K4g's plain version writes f'(scale * p_s) per segment, in K1g's
    layouts; its output is K4's."""
    x, w = _t(_codes(3, (16, 192), -7, 8)), _t(_codes(4, (192, 70), -1, 2))
    y0 = tcm.cadc_matmul_q8_torch(x, w, _t(SCALE), crossbar_size=64, fn=fn)
    psums = torch.stack([(x[:, i:i + 64].float() @ w[i:i + 64].float())
                         * _t(SCALE) for i in range(0, 192, 64)])
    for mode in (("packed", "bytes") if fn == "relu" else ("bytes",)):
        y, gate = tcm.cadc_matmul_q8_gate_torch(
            x, w, _t(SCALE), crossbar_size=64, fn=fn, mode=mode)
        assert torch.equal(y, y0)
        want = tcm._gate_of(psums, tcm._resolve_gate(fn)[1], mode, fn)
        assert torch.equal(gate, want)
        assert gate.nbytes == tcm.gate_residual_nbytes(
            16, 192, 70, crossbar_size=64, fn=fn, save_gate=mode)


CONV_CASES = [  # (B, H, Cin, K, Cout, stride, padding, xbar)
    (2, 9, 3, 3, 16, 1, "SAME", 16),     # Cin 3: the first conv's layout
    (2, 9, 5, 3, 40, 2, "SAME", 16),     # segments spanning taps, stride 2
    (2, 10, 5, 3, 17, 2, "VALID", 32),   # D = 45 not a multiple of 32
    (1, 8, 2, 3, 8, 1, "SAME", 64),      # the SNN's conv1 (Cin 2)
    (2, 8, 16, 1, 32, 2, "SAME", 64),    # a 1x1 stride-2 projection
    (1, 6, 32, 3, 24, 1, "VALID", 128),
]


@pytest.mark.parametrize("fn", EXACT_FNS + ["tanh"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_k5_equals_jax_oracle(fn, case):
    b, h, cin, k, cout, s, pad, xbar = case
    x = _codes(h * cin, (b, h, h, cin), -7, 8)
    w = _codes(cout, (k, k, cin, cout), -1, 2)
    want = jops.cadc_conv2d_q8(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(SCALE), crossbar_size=xbar, fn=fn,
                               stride=(s, s), padding=pad, impl="xla")
    got = tops.cadc_conv2d_q8(_t(x), _t(w), _t(SCALE), crossbar_size=xbar,
                              fn=fn, stride=(s, s), padding=pad)
    _assert_fn_equal(got.numpy(), want, fn)
    _assert_fn_equal(tref.cadc_conv2d_q8_ref(
        _t(x), _t(w), _t(SCALE), crossbar_size=xbar, fn=fn, stride=(s, s),
        padding=pad).numpy(), want, fn)


def test_plain_k5_gate_layout():
    """The conv gate is [S, B, OH, OW, ...]: K4g's of the im2col product."""
    x, w = _t(_codes(5, (2, 7, 7, 6), -7, 8)), _t(_codes(6, (3, 3, 6, 40),
                                                          -1, 2))
    kw = dict(crossbar_size=32, fn="relu", stride=(2, 2), padding="SAME")
    y, gate = tcc.cadc_conv2d_q8_torch(x, w, _t(SCALE), mode="packed", **kw)
    y0, none = tcc.cadc_conv2d_q8_torch(x, w, _t(SCALE), **kw)
    assert none is None and torch.equal(y, y0)
    assert gate.shape == (2, 2, 4, 4, 2) and gate.dtype == torch.int32


def test_q8_conv_empty_batch():
    x = torch.zeros((0, 6, 6, 4), dtype=torch.int8)
    w = _t(_codes(7, (3, 3, 4, 8), -1, 2))
    y = tops.cadc_conv2d_q8(x, w, 0.5, crossbar_size=16)
    assert y.shape == (0, 6, 6, 8) and y.dtype == torch.float32


def test_q8_plain_versions_refuse_inexact_crossbars():
    """Above 1024 rows an int8 psum may pass 2^24: fp32 is then inexact."""
    x = torch.zeros((2, 2048), dtype=torch.int8)
    w = torch.zeros((2048, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        tcm.cadc_matmul_q8_torch(x, w, _t(SCALE), crossbar_size=2048,
                                 fn="relu")


def test_q8_kernels_need_cuda_tensors():
    x = torch.zeros((2, 64), dtype=torch.int8)
    w = torch.zeros((64, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        tops.cadc_matmul_q8(x, w, 1.0, crossbar_size=64, impl="cuda")
    with pytest.raises(ValueError):
        tcm.cadc_matmul_q8_cuda(x, w, _t(SCALE), crossbar_size=64, fn="relu")
    with pytest.raises(ValueError):
        tcc.cadc_conv2d_q8_cuda(torch.zeros((1, 4, 4, 2), dtype=torch.int8),
                                torch.zeros((3, 3, 2, 4), dtype=torch.int8),
                                _t(SCALE), crossbar_size=64, fn="relu")


# ---------------------------------------------------------------------------
# straight-through gradients
# ---------------------------------------------------------------------------

def _relu0(p):
    # f'(0) = 0, the kernels' convention (exact-zero psums are common with
    # integer data, where jnp.maximum would split the tie)
    return jnp.where(p > 0, p, 0.0)


def _grads_torch(op, x, w, s, r):
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    st = _t(s).requires_grad_()
    y = op(xt, wt, st)
    return [t.numpy() for t in torch.autograd.grad((y * _t(r)).sum(),
                                                   (xt, wt, st))]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    assert np.abs(np.asarray(got) - want).max() <= tol * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("fn,save_gate", [
    (fn, sg) for fn in ("relu", "identity", "sublinear", "supralinear")
    for sg in tcm.SAVE_GATE_MODES
    if sg != "packed" or fn in ("relu", "identity")])  # packing: indicators
def test_k4_ste_grads_match_jax_interpret(fn, save_gate):
    """Float arrays holding codes (QAT): the port's VJP against jax.grad of
    K4's custom_vjp in interpret mode, the same save_gate."""
    xf = _codes(43, (10, 140), -7, 8).astype(np.float32)
    wf = _codes(44, (140, 16), -1, 2).astype(np.float32)
    s = np.float32(0.05)
    r = np.random.RandomState(45).randn(10, 16).astype(np.float32)

    def jop(a, b, sc):
        return jnp.vdot(cadc_matmul_q8_pallas(
            a, b, sc, crossbar_size=64, fn=fn, block_m=16, block_n=32,
            interpret=True, save_gate=save_gate), jnp.asarray(r))

    want = jax.grad(jop, argnums=(0, 1, 2))(jnp.asarray(xf), jnp.asarray(wf),
                                            jnp.asarray(s))
    got = _grads_torch(lambda a, b, sc: tops.cadc_matmul_q8(
        a, b, sc, crossbar_size=64, fn=fn, save_gate=save_gate), xf, wf, s, r)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_k4_scale_grad_with_int_codes():
    """int8 primals take no gradient; d(scale) still flows (JAX: float0)."""
    x = _codes(41, (12, 150), -7, 8)
    w = _codes(42, (150, 9), -1, 2)
    r = np.random.RandomState(42).randn(12, 9).astype(np.float32)
    s = np.float32(0.731)
    want = jax.grad(lambda sc: jnp.vdot(cadc_matmul_q8_pallas(
        jnp.asarray(x), jnp.asarray(w), sc, crossbar_size=64, fn="relu",
        block_m=16, block_n=16, interpret=True), jnp.asarray(r)))(
        jnp.asarray(s))
    st = _t(s).requires_grad_()
    y = tops.cadc_matmul_q8(_t(x), _t(w), st, crossbar_size=64, fn="relu")
    (got,) = torch.autograd.grad((y * _t(r)).sum(), st)
    _close(got.numpy(), want)


@pytest.mark.parametrize("save_gate", tcm.SAVE_GATE_MODES)
@pytest.mark.parametrize("case", [(2, 7, 5, 3, 40, 1, "SAME", 16),
                                  (2, 8, 6, 3, 33, 2, "VALID", 32),
                                  (1, 6, 3, 3, 16, 2, "SAME", 64)])
def test_k5_ste_grads_match_jax_float_oracle(case, save_gate):
    """The conv's VJP against jax.grad of sum_s relu(scale * p_s) over the
    JAX im2col (its Pallas conv does not run on this jax)."""
    b, h, cin, k, cout, st, pad, xbar = case
    xf = _codes(51, (b, h, h, cin), -7, 8).astype(np.float32)
    wf = _codes(52, (k, k, cin, cout), -1, 2).astype(np.float32)
    s = np.float32(0.07)
    oh = (h - k) // st + 1 if pad == "VALID" else -(-h // st)
    r = np.random.RandomState(53).randn(b, oh, oh, cout).astype(np.float32)

    def jop(a, c, sc):
        y = jconv.cadc_conv2d(a, c, crossbar_size=xbar,
                              fn=lambda p: _relu0(sc * p), stride=(st, st),
                              padding=pad)
        return jnp.vdot(y, jnp.asarray(r))

    want = jax.grad(jop, argnums=(0, 1, 2))(jnp.asarray(xf), jnp.asarray(wf),
                                            jnp.asarray(s))
    got = _grads_torch(lambda a, c, sc: tops.cadc_conv2d_q8(
        a, c, sc, crossbar_size=xbar, fn="relu", stride=(st, st),
        padding=pad, save_gate=save_gate), xf, wf, s, r)
    for g_, w_ in zip(got, want):
        _close(g_, w_)


@pytest.mark.parametrize("fn", ["relu", "sublinear", "supralinear"])
def test_k2_recompute_takes_the_q8_scale(fn):
    """K2's plain recompute with `scale` re-derives f'(scale * p_s): the
    backward of the forward's saved gate, bitwise."""
    x = _t(_codes(61, (12, 128), -7, 8)).float()
    w = _t(_codes(62, (128, 20), -1, 2)).float()
    g = torch.from_numpy(np.random.RandomState(63).randn(12, 20).astype(
        np.float32))
    _, gate = tcm.cadc_matmul_q8_gate_torch(x, w, _t(SCALE), crossbar_size=64,
                                            fn=fn, mode="bytes")
    kw = dict(crossbar_size=64, fn=fn)
    saved = tcm.cadc_segmented_bwd_torch(g, x, w, gate, mode="bytes", **kw)
    rec = tcm.cadc_segmented_bwd_torch(g, x, w, None, mode="recompute",
                                       scale=_t(SCALE), **kw)
    assert torch.equal(saved[0], rec[0]) and torch.equal(saved[1], rec[1])
