"""ADC (in-memory ramp ADC, "IMA") model: psum quantization + noise.

Port of repro.core.adc. The paper's IMA digitizes each crossbar psum at
1-5 bit resolution; SPICE calibration at 27C/TT gives an output-code error
~ N(mu=-0.11, sigma=0.56) LSB (Fig. 7). The pipeline is a `psum_transform`
hook for the core cadc_matmul / cadc_conv2d:

    raw psum (fp32, "analog") -> clip to full-scale -> code = round(p/LSB)
    -> code += eps, eps ~ N(mu, sigma)          (noise in CODE space)
    -> p' = code * LSB                           (back to value space)

For CADC the IMA realizes f() itself, so non-positive psums read out as
exactly code 0 whatever the ramp noise (`cadc_mode`): that is why CADC is
noise-robust.

The noise is drawn from an explicit torch.Generator. torch's generators
cannot give jax.random's bits, so noisy outputs are compared inside the
port only; the noise-free transform is the JAX one bitwise (the same
operations in the same order, and the same STE expression).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdcConfig:
    bits: int = 4
    noise_mu: float = -0.11     # LSB units (paper Fig. 7, 27C TT)
    noise_sigma: float = 0.56   # LSB units
    full_scale: Optional[float] = None  # None -> auto (max |psum|, detached)
    cadc_mode: bool = True      # IMA-realized f(): clamped psums are noiseless
    enabled: bool = True


def fold_in(seed: int, i: int) -> int:
    """A seed derived from (seed, i), the counterpart of
    jax.random.fold_in: distinct i give distinct streams."""
    return (seed * 1_000_003 + i) % 2**63


def make_psum_transform(cfg: AdcConfig,
                        generator: Optional[torch.Generator] = None
                        ) -> Callable[[Tensor], Tensor]:
    """fp32 -> fp32 transform to pass as `psum_transform`. generator=None
    disables the noise (pure quantization); otherwise the noise is drawn
    from it (on its device, which must be the psums')."""

    def transform(psums: Tensor) -> Tensor:
        if not cfg.enabled:
            return psums
        levels = 2 ** cfg.bits - 1
        if cfg.full_scale is None:
            fs = psums.detach().abs().max() + 1e-8
        else:
            fs = torch.tensor(cfg.full_scale, dtype=psums.dtype,
                              device=psums.device)
        lsb = fs / levels
        code = torch.round(torch.clamp(psums, -fs, fs) / lsb)
        if generator is not None:
            eps = cfg.noise_mu + cfg.noise_sigma * torch.randn(
                psums.shape, generator=generator, dtype=psums.dtype,
                device=psums.device)
            if cfg.cadc_mode:
                # IMA: SA holds 0 for non-positive MACs -> no noise there.
                eps = torch.where(code > 0, eps, torch.zeros_like(eps))
            code = code + eps
        q = code * lsb
        # STE so quantized-in-the-loop training still flows gradients.
        return psums + (q - psums).detach()

    return transform


NOMINAL_27C = AdcConfig()  # the paper's nominal corner
