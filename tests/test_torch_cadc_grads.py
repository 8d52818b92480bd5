"""The port's CADC matmul gradients against the JAX package.

The plain versions of K1g (`cadc_matmul_gate_torch`) and K2
(`cadc_segmented_bwd_torch`), reached through the autograd Function of
kernels/ops.py on CPU tensors, must give the gradients of jax.grad through
the JAX package's oracle (`ops.cadc_matmul(impl="xla")`) within 1e-4 — the
JAX package's own TOL (tests/test_kernel_grads.py) — for every crossbar
size of the paper's sweep, dendritic fn and save_gate mode, with a
contraction that is not a multiple of the crossbar. The packed gate words
are held against the Pallas forward's residual in interpret mode (small
blocks: interpret is slow), bit for bit wherever the psum is not within
1e-5 of 0 (elsewhere its sign may differ with the summation order).
Inputs come from numpy seeds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cadc_matmul import _pack_mask as jpack
from repro.kernels.cadc_matmul import _unpack_mask as junpack
from repro.kernels.cadc_matmul import cadc_matmul_fwd_residuals
from repro_torch.core import cadc as tcadc
from repro_torch.core import dendritic as tdend
from repro_torch.kernels import cadc_matmul as tcm
from repro_torch.kernels import ops as tops

TOL = 1e-4
XBARS = [64, 128, 256]
FNS = ["relu", "identity", "sublinear", "tanh"]
MODES = ["auto", "packed", "bytes", "recompute"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(xbar):
    m, d, n = 10, 2 * xbar + 17, 21
    rng = np.random.RandomState(xbar)
    x = rng.randn(m, d).astype(np.float32)
    w = (rng.randn(d, n) / 16).astype(np.float32)
    r = rng.randn(m, n).astype(np.float32)
    return x, w, r


@functools.lru_cache(maxsize=None)
def _jax_grads(xbar, fn):
    x, w, r = _inputs(xbar)

    def loss(a, b):
        return jnp.vdot(jops.cadc_matmul(a, b, crossbar_size=xbar, fn=fn,
                                         impl="xla"), r)

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, w)
    return np.asarray(gx), np.asarray(gw)


def _torch_grads(xbar, fn, save_gate):
    x, w, r = _inputs(xbar)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tops.cadc_matmul(xt, wt, crossbar_size=xbar, fn=fn, impl="auto",
                         save_gate=save_gate)
    (y * torch.from_numpy(r)).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("save_gate", MODES)
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("xbar", XBARS)
def test_grads_match_jax(xbar, fn, save_gate):
    if (save_gate == "packed" and not tdend.gate_packing(fn)
            and tdend.gate_dtype(fn) is not None):
        with pytest.raises(ValueError, match="indicator gate"):
            _torch_grads(xbar, fn, save_gate)
        return
    gx, gw = _torch_grads(xbar, fn, save_gate)
    hx, hw = _jax_grads(xbar, fn)
    assert np.abs(gx - hx).max() <= TOL
    assert np.abs(gw - hw).max() <= TOL


@pytest.mark.parametrize("save_gate", MODES)
def test_forward_and_saved_gate(save_gate):
    """K1g's plain version: the forward equals the JAX oracle; the saved
    gate has the mode's format and exactly gate_residual_nbytes bytes."""
    x, w, _ = _inputs(64)
    xp = tcadc.pad_to_segments(torch.from_numpy(x), -1, 64)
    wp = tcadc.pad_to_segments(torch.from_numpy(w), 0, 64)
    mode = tcm.gate_mode(save_gate, "relu")
    y, gate = tcm.cadc_matmul_gate_torch(xp, wp, crossbar_size=64,
                                         fn="relu", mode=mode)
    want = jops.cadc_matmul(jnp.asarray(x), jnp.asarray(w), crossbar_size=64,
                            fn="relu", impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    nbytes = tcm.gate_residual_nbytes(10, x.shape[1], 21, crossbar_size=64,
                                      fn="relu", save_gate=save_gate)
    if mode == "recompute":
        assert gate is None and nbytes == 0
        return
    assert gate.nbytes == nbytes
    assert gate.shape == ((3, 10, 1) if mode == "packed" else (3, 10, 21))
    assert gate.dtype == (torch.int32 if mode == "packed" else torch.bool)


def test_identity_saves_nothing():
    for sg in MODES[:1] + MODES[2:]:
        assert tcm.gate_mode(sg, "identity") == "none"
        assert tcm.gate_residual_nbytes(64, 200, 64, crossbar_size=64,
                                        fn="identity", save_gate=sg) == 0
    with pytest.raises(ValueError, match="save_gate="):
        tcm.gate_mode("nope", "relu")


def test_pack_unpack_match_jax():
    rng = np.random.RandomState(0)
    gate = (rng.rand(7, 96) > 0.5).astype(np.float32)
    words = tcm._pack_mask(torch.from_numpy(gate)).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, np.asarray(jpack(jnp.asarray(gate))))
    back = tcm._unpack_mask(torch.from_numpy(words.view(np.int32)), 96)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(junpack(jnp.asarray(words))))
    # a ragged N pads whole words with zero bits
    ragged = tcm._pack_mask(torch.from_numpy(gate[:, :70]))
    assert ragged.shape == (7, 3)
    np.testing.assert_array_equal(
        tcm._unpack_mask(ragged, 70).numpy(), gate[:, :70])


@pytest.mark.parametrize("fn,save_gate,n", [("relu", "packed", 40),
                                            ("sublinear", "bytes", 32)])
def test_gate_matches_pallas_residual(fn, save_gate, n):
    rng = np.random.RandomState(1)
    x = rng.randn(12, 150).astype(np.float32)
    w = (rng.randn(150, n) / 12).astype(np.float32)
    y, gate = cadc_matmul_fwd_residuals(
        jnp.asarray(x), jnp.asarray(w), crossbar_size=64, fn=fn,
        block_m=8, block_n=32, interpret=True, save_gate=save_gate)
    xp = tcadc.pad_to_segments(torch.from_numpy(x), -1, 64)
    wp = tcadc.pad_to_segments(torch.from_numpy(w), 0, 64)
    ty, tgate = tcm.cadc_matmul_gate_torch(xp, wp, crossbar_size=64, fn=fn,
                                           mode=save_gate)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y)[:12, :n],
                               rtol=TOL, atol=TOL)
    psum = torch.stack([xp[:, s * 64:(s + 1) * 64] @ wp[s * 64:(s + 1) * 64]
                        for s in range(3)])
    far = (psum.abs() > 1e-5).numpy()
    jgate = np.asarray(gate)[:, :12]
    if save_gate == "packed":
        got = tcm._unpack_mask(tgate, n).numpy()
        want = np.stack([np.asarray(junpack(jnp.asarray(g)))
                         for g in jgate])[..., :n]
        np.testing.assert_array_equal(got[far], want[far])
    else:
        np.testing.assert_allclose(tgate.numpy()[far],
                                   jgate[..., :n][far], rtol=TOL, atol=TOL)


def test_forward_only_when_no_grad():
    """Without autograd the op is K1's plain version (no gate saved) and
    gives the same values."""
    x, w, _ = _inputs(64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with torch.no_grad():
        y0 = tops.cadc_matmul(xt.requires_grad_(), wt, crossbar_size=64)
    y1 = tops.cadc_matmul(xt, wt, crossbar_size=64)
    assert not y0.requires_grad and y1.requires_grad
    np.testing.assert_array_equal(y0.numpy(), y1.detach().numpy())


def test_sequential_oracle_matches_plain_kernel_and_jax_ref():
    """kernels/ref.py: the same sequential segment order as K1's plain
    version (bitwise), and the JAX package's oracle within 1e-4."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    x, w, _ = _inputs(128)
    want = jref.cadc_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                crossbar_size=128, fn="tanh")
    got = tref.cadc_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                               crossbar_size=128, fn="tanh")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    xp = tcadc.pad_to_segments(torch.from_numpy(x), -1, 128)
    wp = tcadc.pad_to_segments(torch.from_numpy(w), 0, 128)
    plain = tcm.cadc_matmul_torch(xp, wp, crossbar_size=128, fn="tanh")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_registry_matches_jax_and_register_reaches_the_backward():
    """gate_dtype / gate_packing as in JAX; a registered indicator fn calls
    the on_register hooks and trains through the plain K1g / K2 with a
    packed gate, giving relu's gradients."""
    from repro.core import dendritic as jdend

    for fn in ("identity", "relu", "sublinear", "supralinear", "tanh"):
        jdt, tdt = jdend.gate_dtype(fn), tdend.gate_dtype(fn)
        assert (jdt is None) == (tdt is None)
        if tdt is not None:
            assert torch.empty((), dtype=tdt).element_size() == \
                jnp.dtype(jdt).itemsize
        assert tdend.gate_packing(fn) == jdend.gate_packing(fn)
    seen = []
    tdend.on_register(seen.append)
    try:
        tdend.register("relu_port_test", tdend.relu, tdend.relu_grad,
                       gate=torch.bool, gate_packing=True)
        with pytest.raises(ValueError, match="gate_packing requires"):
            tdend.register("relu_port_test2", tdend.relu, gate_packing=True)
    finally:
        tdend._REGISTER_HOOKS.remove(seen.append)
    assert seen == ["relu_port_test"]
    assert tcm.gate_mode("auto", "relu_port_test") == "packed"
    got = _torch_grads(64, "relu_port_test", "packed")
    want = _torch_grads(64, "relu", "packed")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
