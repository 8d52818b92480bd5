"""Fake-quantization (QAT-style) for the paper's 4/2/4-bit configuration.

Port of repro.core.quant. Paper operating point: 4-bit signed PWM inputs,
2-bit (ternary) weights stored in twin-9T bitcells, 4-bit ADC outputs
(IMA). All three are modelled with straight-through estimators (STE) so the
quantized network stays trainable (Fig. 9 "Quantization and test results").

The operation order is the JAX one, so the codes are bitwise equal on the
same input: x / scale (a division, not a product with the reciprocal),
clip to [-1, 1], times the level count, round half to even (torch.round,
as jnp.round). The ternary statistics are fp32 reductions, which torch and
XLA sum in different orders: alpha (and so a q8 layer's scale) may differ
from the JAX package's by an ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _ste(x: Tensor, q: Tensor) -> Tensor:
    """Straight-through: forward q, backward identity."""
    return x + (q - x).detach()


def _symmetric_scale(x: Tensor, axis: Optional[int] = None) -> Tensor:
    """Per-tensor (axis=None) or per-axis clipped max|x| scale — the one
    definition both the fake-quant and the int8-code paths use."""
    if axis is None:
        scale = x.abs().max()
    else:
        scale = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(scale, min=1e-8)


def _symmetric_levels(x: Tensor, scale: Tensor, bits: int) -> Tensor:
    """Integer level index round(clip(x/scale) * (2^(b-1)-1)) — fp32."""
    levels = 2 ** (bits - 1) - 1
    return torch.round(torch.clamp(x / scale, -1.0, 1.0) * levels)


def quantize_symmetric(x: Tensor, bits: int, *, axis: Optional[int] = None,
                       ste: bool = True) -> Tensor:
    """Symmetric uniform quantizer with 2^(bits-1)-1 positive levels.

    axis=None -> per-tensor scale; otherwise per-`axis` (e.g. per-channel).
    """
    if bits >= 32:
        return x
    levels = 2 ** (bits - 1) - 1
    scale = _symmetric_scale(x, axis)
    q = _symmetric_levels(x, scale, bits) / levels * scale
    return _ste(x, q) if ste else q


def _ternary_stats(w: Tensor) -> Tuple[Tensor, Tensor]:
    """(mask, alpha) of the TWN rule: delta = 0.7 * mean|w|; alpha =
    mean |w| over the supra-threshold set."""
    absw = w.abs()
    delta = 0.7 * absw.mean()
    mask = absw > delta
    alpha = (absw * mask).sum() / torch.clamp(mask.sum().to(w.dtype), min=1.0)
    return mask, alpha


def ternarize(w: Tensor, *, ste: bool = True) -> Tensor:
    """Ternary weight network quantizer (the paper's 2-bit weights):
    w_q in {-alpha, 0, +alpha} by the TWN rule (_ternary_stats)."""
    mask, alpha = _ternary_stats(w)
    q = alpha * torch.sign(w) * mask
    return _ste(w, q) if ste else q


def ternary_codes(w: Tensor) -> Tensor:
    """{-1, 0, +1} int8 codes with an implicit per-tensor alpha."""
    mask, _ = _ternary_stats(w)
    return (torch.sign(w) * mask).to(torch.int8)


def ternary_decompose(w: Tensor) -> Tuple[Tensor, Tensor]:
    """(codes int8 {-1,0,+1}, alpha fp32) with alpha * codes ==
    ternarize(w, ste=False): the operands of the q8 kernels."""
    mask, alpha = _ternary_stats(w)
    codes = (torch.sign(w) * mask).to(torch.int8)
    return codes, alpha.float()


def quantize_codes(x: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    """(codes int8, lsb fp32) with lsb * codes == quantize_symmetric(x,
    bits, ste=False) up to one fp32 re-association of scale / levels —
    per-tensor scale, bits <= 8. The q8 kernels' input format."""
    if bits > 8:
        raise ValueError(f"int8 codes need bits <= 8, got {bits}")
    levels = 2 ** (bits - 1) - 1
    scale = _symmetric_scale(x)
    codes = _symmetric_levels(x, scale, bits).to(torch.int8)
    return codes, (scale / levels).float()


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The paper's a/w/o bit triple, e.g. 4/2/4b."""

    input_bits: int = 4
    weight_bits: int = 2  # 2 -> ternary (twin-9T)
    adc_bits: int = 4     # output / psum resolution
    enabled: bool = True

    def quant_input(self, x: Tensor) -> Tensor:
        if not self.enabled:
            return x
        return quantize_symmetric(x, self.input_bits)

    def quant_weight(self, w: Tensor) -> Tensor:
        if not self.enabled:
            return w
        if self.weight_bits == 2:
            return ternarize(w)
        return quantize_symmetric(w, self.weight_bits, axis=0)


FP32 = QuantConfig(enabled=False)
PAPER_424 = QuantConfig(input_bits=4, weight_bits=2, adc_bits=4)
