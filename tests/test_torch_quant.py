"""The port's quantizers and ADC model against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
  * quantize_codes: codes and lsb bitwise equal (max|x| is exact and the
    operation order is the JAX one: x / scale, clip, times levels, round
    half to even).
  * ternary stats: codes equal; alpha within 1e-6 relative — its fp32
    reductions (mean |w|, sums over the mask) sum in another order in
    torch than in XLA, so it may differ by an ulp.
  * the fake-quant forwards within 1e-6 of their scale (alpha's ulp),
    with identity straight-through gradients.
  * make_psum_transform without noise bitwise equal to JAX's; with noise
    the port draws from a torch.Generator, so it is held to the noise's
    distribution and to determinism under a seed, not to JAX's bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import quant as jq
from repro_torch.core import adc as tadc
from repro_torch.core import quant as tq

SHAPES = [(7, 33), (4, 5, 6, 9), (300, 70), (3, 3, 64, 128)]


def _x(seed, shape, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_codes_bitwise(bits, shape):
    x = _x(bits, shape)
    jc, jl = jq.quantize_codes(jnp.asarray(x), bits)
    tc, tl = tq.quantize_codes(_t(x), bits)
    assert tc.dtype == torch.int8 and tl.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.float32(tl.item()).tobytes() == np.asarray(jl).tobytes()


def test_quantize_codes_ties_round_half_to_even():
    """x / scale * levels lands on .5 exactly: both round to even."""
    x = np.array([7.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    jc, _ = jq.quantize_codes(jnp.asarray(x), 4)
    tc, _ = tq.quantize_codes(_t(x), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tc.numpy(), [7, 0, 2, 2, 0, -2, 4])


def test_quantize_codes_rejects_wide_bits():
    with pytest.raises(ValueError):
        tq.quantize_codes(torch.zeros(3), 9)


@pytest.mark.parametrize("shape", SHAPES)
def test_ternary_codes_and_alpha(shape):
    w = _x(11, shape, 0.1)
    jc, ja = jq.ternary_decompose(jnp.asarray(w))
    tc, ta = tq.ternary_decompose(_t(w))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tq.ternary_codes(_t(w)).numpy(),
                                  np.asarray(jq.ternary_codes(jnp.asarray(w))))
    assert abs(ta.item() - float(ja)) <= 1e-6 * abs(float(ja))
    # alpha * codes is the ternarized weight, as in JAX
    np.testing.assert_array_equal(
        (ta * tc.float()).numpy(), tq.ternarize(_t(w), ste=False).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_fake_quant_forwards(shape):
    x = _x(3, shape)
    for bits in (2, 4, 8):
        for axis in (None, 0):
            a = np.asarray(jq.quantize_symmetric(jnp.asarray(x), bits,
                                                 axis=axis))
            b = tq.quantize_symmetric(_t(x), bits, axis=axis).numpy()
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
    a = np.asarray(jq.ternarize(jnp.asarray(x)))
    b = tq.ternarize(_t(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())
    for cfg_j, cfg_t in ((jq.PAPER_424, tq.PAPER_424), (jq.FP32, tq.FP32),
                         (jq.QuantConfig(weight_bits=4),
                          tq.QuantConfig(weight_bits=4))):
        for f in ("quant_input", "quant_weight"):
            a = np.asarray(getattr(cfg_j, f)(jnp.asarray(x)))
            b = getattr(cfg_t, f)(_t(x)).numpy()
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("quantizer", [
    lambda x: tq.quantize_symmetric(x, 4),
    lambda x: tq.quantize_symmetric(x, 3, axis=0),
    tq.ternarize,
    tq.PAPER_424.quant_input,
    tq.PAPER_424.quant_weight,
])
def test_straight_through_gradients_are_identity(quantizer):
    x = _t(_x(5, (6, 10))).requires_grad_()
    r = torch.from_numpy(np.random.RandomState(6).randn(6, 10).astype(
        np.float32))
    (g,) = torch.autograd.grad((quantizer(x) * r).sum(), x)
    torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [
    dict(bits=4), dict(bits=3, cadc_mode=False), dict(bits=5),
    dict(bits=4, full_scale=2.0), dict(bits=4, enabled=False),
])
def test_psum_transform_noise_free_bitwise(cfg):
    ps = _x(8, (16, 5, 40), 2.0)
    a = np.asarray(jadc.make_psum_transform(jadc.AdcConfig(**cfg))(
        jnp.asarray(ps)))
    b = tadc.make_psum_transform(tadc.AdcConfig(**cfg))(_t(ps)).numpy()
    np.testing.assert_array_equal(b, a)


def test_psum_transform_ste_gradient():
    ps = _t(_x(9, (8, 3, 12))).requires_grad_()
    r = torch.randn(8, 3, 12, generator=torch.Generator().manual_seed(0))
    t = tadc.make_psum_transform(tadc.NOMINAL_27C,
                                 torch.Generator().manual_seed(1))
    (g,) = torch.autograd.grad((t(ps) * r).sum(), ps)
    torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_psum_transform_noise_distribution_and_determinism():
    """Code-space noise N(mu, sigma) LSB where the ideal code is > 0, none
    elsewhere (cadc_mode); the same generator seed gives the same bits."""
    cfg = tadc.AdcConfig(bits=4, full_scale=15.0)  # lsb 1: codes = values
    ps = torch.from_numpy(np.random.RandomState(3).randint(
        -15, 16, (200_000,)).astype(np.float32))
    clean = tadc.make_psum_transform(cfg)(ps)
    noisy = tadc.make_psum_transform(
        cfg, torch.Generator().manual_seed(5))(ps)
    again = tadc.make_psum_transform(
        cfg, torch.Generator().manual_seed(5))(ps)
    other = tadc.make_psum_transform(
        cfg, torch.Generator().manual_seed(6))(ps)
    assert torch.equal(noisy, again) and not torch.equal(noisy, other)
    eps = noisy - clean
    pos = clean > 0
    assert torch.equal(eps[~pos], torch.zeros_like(eps[~pos]))
    assert abs(eps[pos].mean().item() - cfg.noise_mu) < 0.01
    assert abs(eps[pos].std().item() - cfg.noise_sigma) < 0.01
    noisy_all = tadc.make_psum_transform(
        tadc.AdcConfig(bits=4, full_scale=15.0, cadc_mode=False),
        torch.Generator().manual_seed(5))(ps)
    assert bool(((noisy_all - clean)[~pos] != 0).all())
