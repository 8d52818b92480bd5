"""The port's CADC matmul against the JAX package.

The plain version of the CUDA kernel (kernels/cadc_matmul.py
`cadc_matmul_torch`, reached through kernels/ops.py) must match the JAX
package's oracle (`ops.cadc_matmul(impl="xla")`) and its Pallas kernel in
interpret mode within 1e-4 — the fp32 forward bound of the JAX package's
own kernel tests — for every dendritic fn and for a contraction dim that is
not a multiple of the crossbar. Inputs come from numpy seeds. The CUDA
kernel itself is held against the plain version on a card, in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cadc as jcadc
from repro.core import dendritic as jdend
from repro.kernels import ops as jops
from repro_torch.core import cadc as tcadc
from repro_torch.core import dendritic as tdend
from repro_torch.kernels import cadc_matmul as tcm
from repro_torch.kernels import ops as tops

FNS = ["identity", "relu", "sublinear", "supralinear", "tanh"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, m, d, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, d).astype(np.float32)
    w = (rng.randn(d, n) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("fn", FNS)
def test_dendritic_fns_and_grads_match(fn):
    """Elementwise f and f', including the f'(0) = 0 convention at exact
    zeros."""
    x = np.concatenate([np.random.RandomState(0).randn(64),
                        [0.0, -0.0, 1e-30, -1e-30]]).astype(np.float32)
    for jf, tf_ in ((jdend.get(fn), tdend.get(fn)),
                    (jdend.grad(fn), tdend.grad(fn))):
        np.testing.assert_allclose(tf_(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), **TOL)
    assert float(tdend.grad(fn)(torch.zeros(1))[0]) == float(
        jdend.grad(fn)(jnp.zeros(1))[0])


def test_dendritic_registry():
    with pytest.raises(ValueError, match="unknown dendritic fn"):
        tdend.get("nope")
    tdend.register("half", lambda x: 0.5 * x)
    try:
        with pytest.raises(ValueError, match="no registered derivative"):
            tdend.grad("half")
        tdend.register("half", lambda x: 0.5 * x, lambda x: 0.5 + 0 * x)
        assert float(tdend.grad("half")(torch.ones(1))[0]) == 0.5
    finally:
        tdend.DENDRITIC_FNS.pop("half")
        tdend.DENDRITIC_GRADS.pop("half", None)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("m,d,n,xbar", [(8, 64, 48, 32), (5, 100, 40, 32),
                                        (3, 37, 7, 16)])
def test_plain_matches_jax_oracle(fn, m, d, n, xbar):
    x, w = _inputs(m * d + n, m, d, n)
    want = jops.cadc_matmul(jnp.asarray(x), jnp.asarray(w),
                            crossbar_size=xbar, fn=fn, impl="xla")
    got = tops.cadc_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           crossbar_size=xbar, fn=fn, impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", FNS)
def test_plain_matches_jax_interpret_kernel(fn):
    """Ragged D (100 = 3 x 32 + 4) and ragged M/N against the Pallas
    kernel run in interpret mode with small blocks."""
    x, w = _inputs(11, 10, 100, 24)
    want = jops.cadc_matmul(jnp.asarray(x), jnp.asarray(w), crossbar_size=32,
                            fn=fn, impl="interpret", block_m=16, block_n=16)
    got = tops.cadc_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           crossbar_size=32, fn=fn, impl="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", ["relu", "identity"])
def test_core_oracle_matches_jax_core(fn):
    x, w = _inputs(3, 4, 70, 9)
    want = jcadc.cadc_matmul(jnp.asarray(x), jnp.asarray(w),
                             crossbar_size=32, fn=fn)
    got = tcadc.cadc_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            crossbar_size=32, fn=fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if fn == "identity":
        np.testing.assert_allclose(
            tcadc.vconv_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               crossbar_size=32).numpy(), x @ w, **TOL)


def test_plain_sums_segments_in_order():
    """The plain version adds f(psum_s) for s = 0, 1, ... one at a time to
    a zero accumulator — the kernel's and kernels/ref.py's order —
    bitwise."""
    x, w = _inputs(5, 6, 96, 10)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    acc = torch.zeros(6, 10)
    for s in (0, 1, 2):
        acc = acc + torch.relu(xt[:, 32 * s:32 * (s + 1)] @ wt[32 * s:32 * (s + 1)])
    got = tcm.cadc_matmul_torch(xt, wt, crossbar_size=32, fn="relu")
    assert torch.equal(got, acc)


def test_plain_rejects_unpadded_contraction():
    x, w = _inputs(0, 2, 40, 3)
    with pytest.raises(ValueError, match="multiple of crossbar_size"):
        tcm.cadc_matmul_torch(torch.from_numpy(x), torch.from_numpy(w),
                              crossbar_size=32, fn="relu")


def test_dispatch_on_cpu():
    """'auto' takes the plain version for CPU tensors; 'cuda' raises rather
    than falling back; the kernel wrapper itself refuses CPU tensors."""
    x, w = (torch.from_numpy(a) for a in _inputs(1, 3, 64, 8))
    auto = tops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="auto")
    plain = tops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="torch")
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="CUDA"):
        tops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tcm.cadc_matmul_cuda(x, w, crossbar_size=32, fn="relu")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="xla")
    assert tcm.cadc_matmul_cuda.launches == 0


def test_kernel_fn_ids_cover_builtin_fns():
    assert set(tcm.FN_IDS) == set(FNS)
