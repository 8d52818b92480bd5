"""Shared functional layer machinery of the CNN models.

Port of repro.models.common. Params are nested dicts of tensors, as the
JAX pytrees, in the JAX layouts: NHWC activations, HWIO conv weights,
[in, out] dense weights. Every weight-bearing layer routes through
`linear_forward` / `conv_forward`, which dispatch on LayerMode.impl:
'vconv' (baseline partitioned matmul) or 'cadc' (per-crossbar dendritic
f()). Quantization (4/2/4b etc., fake-quant STE), the int8-native q8
kernels and the ADC noise model compose via the same mode. Psum sparsity
statistics are collected through the Ctx object, which also carries the
ADC noise's seed.

Which path a layer takes:
  * q8 (`_use_q8`, inference only): K4 / K5 on int8 codes, when the mode
    opts in, quantizes with ternary weights and int8-representable inputs,
    and nothing needs materialized psums (no stats, no ADC);
  * kernels (`_use_fused`): K1g / K1 / K3 with K2 under autograd, on the
    fake-quantized floats when `quant` is on;
  * core: the einsum / im2col formulation, whenever a layer needs the
    materialized psums — the stats sink, or the ADC model, whose
    transform acts on every psum. So with `adc` set no layer launches a
    kernel, whatever `kernel` and `q8_fused` say, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import adc as adc_lib
from repro_torch.core import cadc as cadc_lib
from repro_torch.core import conv as conv_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.quant import FP32, QuantConfig
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LayerMode:
    """How weight-bearing layers execute. This is the paper's experiment
    axis.

    `kernel` picks the segmented contraction's backend: 'auto' (the
    default) runs the CUDA kernels (K1 / K1g / K2 / K3) on CUDA tensors and
    their plain versions on CPU tensors, both through kernels/ops.py's
    autograd Functions; 'cuda' insists on the kernels; 'torch' is the core
    einsum / im2col formulation under torch autograd (the counterpart of
    the JAX package's 'xla'). The JAX LayerMode defaults to 'xla' — its
    kernels need a TPU; the port defaults to 'auto', so a CUDA run trains
    through the kernels unasked. Layers that must materialize psums (stats
    collection, the ADC model) take the core path whatever `kernel` says.

    `save_gate` is the gradient residual of the kernels ('auto' | 'packed'
    | 'bytes' | 'recompute'; kernels/cadc_matmul.py).

    `q8_fused` routes ternary-weight quantized layers through the
    int8-native kernels K4 / K5: int8 codes x int8 ternary codes -> int32
    psums, bitwise the q8 oracle. It is an inference path: the layer
    computation is detached (the torch form of the JAX stop_gradient), so
    no gradient reaches w or x through it; training keeps the fake-quant
    STE floats (q8_fused=False).
    """

    impl: str = "vconv"                 # 'vconv' | 'cadc'
    crossbar_size: int = 64             # 64 / 128 / 256 (paper sweep)
    fn: str = "relu"                    # dendritic f() for cadc
    quant: QuantConfig = FP32
    adc: Optional[adc_lib.AdcConfig] = None
    collect_stats: bool = False
    kernel: str = "auto"
    save_gate: str = "auto"
    q8_fused: bool = False

    def __post_init__(self):
        if self.kernel not in kops.IMPLS:
            raise ValueError(f"kernel={self.kernel!r}; choose from "
                             f"{kops.IMPLS}")

    def dendritic_fn(self) -> str:
        return self.fn if self.impl == "cadc" else "identity"


class Ctx:
    """Per-forward context: the layer mode, the seed of the ADC noise, and
    the psum stats sink. `rng` is an int seed (None: no noise); every
    layer that asks for the ADC transform gets its own generator, seeded
    from (rng, its index) — the counterpart of jax.random.fold_in(rng, i)."""

    def __init__(self, mode: LayerMode, rng: Optional[int] = None):
        self.mode = mode
        self.rng = rng
        self.stats: List[Dict[str, Tensor]] = []
        self._names: List[str] = []
        self._i = 0

    def next_generator(self, device) -> Optional[torch.Generator]:
        if self.rng is None:
            return None
        self._i += 1
        return torch.Generator(device=device).manual_seed(
            adc_lib.fold_in(self.rng, self._i))

    def psum_transform(self, device):
        """The ADC model's psum transform of the next layer (None without
        an ADC), its noise drawn on `device` (the psums')."""
        if self.mode.adc is None:
            return None
        return adc_lib.make_psum_transform(self.mode.adc,
                                           self.next_generator(device))

    def record(self, name: str, psums: Optional[Tensor], segments: int):
        if not self.mode.collect_stats or psums is None:
            return
        self._names.append(name)
        self.stats.append({
            "sparsity": (psums == 0).float().mean(),
            "count": torch.tensor(float(psums.numel() // psums.shape[0])),
            "segments": torch.tensor(float(segments)),
        })

    def stats_dict(self) -> Dict[str, Dict[str, Tensor]]:
        return dict(zip(self._names, self.stats))


# ---------------------------------------------------------------------------
# initializers (one torch.Generator drawn in order; a generator on the
# device of the tensors it fills)
# ---------------------------------------------------------------------------

def he_init(gen: torch.Generator, shape, fan_in: int,
            device=None) -> Tensor:
    return torch.randn(shape, generator=gen,
                       device=device or gen.device) * math.sqrt(2.0 / fan_in)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = True,
               device=None) -> Params:
    p = {"w": he_init(gen, (d_in, d_out), d_in, device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device or gen.device)
    return p


def conv_init(gen, k1: int, k2: int, cin: int, cout: int,
              device=None) -> Params:
    return {"w": he_init(gen, (k1, k2, cin, cout), k1 * k2 * cin, device)}


def params_from_numpy(tree, device) -> Any:
    """A JAX CNN (params, state) pytree of numpy arrays (np.asarray of each
    leaf) -> the same nesting of fp32 tensors on `device`, layouts
    unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------

def _use_fused(mode: LayerMode, want_ps: bool) -> bool:
    """Route through kernels/ops.py? Only when nothing needs the
    materialized psums (the stats sink or the ADC transform), which the
    kernels never write. The `mode.adc is None` guard is load-bearing:
    without it a kernel mode would silently skip the ADC model (the
    psum transform never reaches a kernel)."""
    return mode.kernel != "torch" and not want_ps and mode.adc is None


def _use_q8(mode: LayerMode) -> bool:
    """Int8-native path: opted in, quantization on, ternary weights and
    int8-representable inputs (the paper's 4/2/4b operating point)."""
    return (mode.q8_fused and mode.quant.enabled
            and mode.quant.weight_bits == 2 and mode.quant.input_bits <= 8)


@torch.no_grad()
def _q8_operands(x: Tensor, w: Tensor, bits: int):
    """(x codes, w codes, scale = input lsb * weight alpha), detached: the
    q8 layer computed from them carries no gradient to x or w."""
    x_codes, lsb = quant_lib.quantize_codes(x, bits)
    w_codes, alpha = quant_lib.ternary_decompose(w)
    return x_codes, w_codes, lsb * alpha


def linear_forward(p: Params, x: Tensor, ctx: Ctx, *,
                   name: str = "fc") -> Tensor:
    mode = ctx.mode
    segs = cadc_lib.num_segments(p["w"].shape[0], mode.crossbar_size)
    want_ps = mode.collect_stats and segs > 1
    if _use_q8(mode) and not want_ps and mode.adc is None:
        # int8 crossbar arithmetic (alpha * codes == ternarize(w)): one
        # fp32 scale, int32 psums; detached (inference only), the bias
        # added outside as in JAX.
        x_codes, w_codes, scale = _q8_operands(x, p["w"],
                                               mode.quant.input_bits)
        y = kops.cadc_matmul_q8(
            x_codes, w_codes, scale, crossbar_size=mode.crossbar_size,
            fn=mode.dendritic_fn(), impl=mode.kernel,
            save_gate=mode.save_gate).to(x.dtype)
        return y + p["b"] if "b" in p else y
    w = mode.quant.quant_weight(p["w"])
    xq = mode.quant.quant_input(x)
    if _use_fused(mode, want_ps):
        y = kops.cadc_matmul(xq, w, crossbar_size=mode.crossbar_size,
                             fn=mode.dendritic_fn(), impl=mode.kernel,
                             save_gate=mode.save_gate)
    else:
        out = cadc_lib.cadc_matmul(
            xq, w, crossbar_size=mode.crossbar_size, fn=mode.dendritic_fn(),
            return_psums=want_ps,
            psum_transform=(ctx.psum_transform(x.device)
                            if segs > 1 or mode.adc else None))
        if want_ps:
            ctx.record(name, out.psums, segs)
            out = out.y
        y = out
    if "b" in p:
        y = y + p["b"]
    return y


def conv_forward(p: Params, x: Tensor, ctx: Ctx, *, stride=(1, 1),
                 padding="SAME", name: str = "conv") -> Tensor:
    mode = ctx.mode
    k1, k2, cin, _ = p["w"].shape
    segs = cadc_lib.num_segments(k1 * k2 * cin, mode.crossbar_size)
    want_ps = mode.collect_stats and segs > 1
    if _use_q8(mode) and not want_ps and mode.adc is None:
        # inference-only int8 path, detached as in linear_forward
        x_codes, w_codes, scale = _q8_operands(x, p["w"],
                                               mode.quant.input_bits)
        return kops.cadc_conv2d_q8(
            x_codes, w_codes, scale, crossbar_size=mode.crossbar_size,
            fn=mode.dendritic_fn(), stride=stride, padding=padding,
            impl=mode.kernel, save_gate=mode.save_gate).to(x.dtype)
    w = mode.quant.quant_weight(p["w"])
    xq = mode.quant.quant_input(x)
    if _use_fused(mode, want_ps):
        return kops.cadc_conv2d(xq, w, crossbar_size=mode.crossbar_size,
                                fn=mode.dendritic_fn(), stride=stride,
                                padding=padding, impl=mode.kernel,
                                save_gate=mode.save_gate)
    out = conv_lib.cadc_conv2d(
        xq, w, crossbar_size=mode.crossbar_size, fn=mode.dendritic_fn(),
        stride=stride, padding=padding, return_psums=want_ps,
        psum_transform=(ctx.psum_transform(x.device)
                        if segs > 1 or mode.adc else None))
    if want_ps:
        ctx.record(name, out.psums, segs)
        out = out.y
    return out


# ---------------------------------------------------------------------------
# BatchNorm (functional, EMA state threaded) and pooling, NHWC
# ---------------------------------------------------------------------------

def bn_init(c: int, device=None) -> Tuple[Params, Params]:
    params = {"scale": torch.ones(c, device=device),
              "bias": torch.zeros(c, device=device)}
    state = {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)}
    return params, state


def bn_forward(p: Params, s: Params, x: Tensor, *, train: bool,
               momentum: float = 0.9) -> Tuple[Tensor, Params]:
    """The JAX formula: biased batch variance over every axis but the
    last, EMA m*old + (1-m)*new, eps 1e-5 (not nn.BatchNorm2d, whose
    unbiased running variance and reversed momentum compute another
    function). The new state is detached, as JAX returns it outside the
    differentiated loss."""
    axes = tuple(range(x.ndim - 1))
    if train:
        mean = x.mean(axes)
        var = (x - mean).square().mean(axes)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (x - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y, new_s


def _nchw(fn, x: Tensor, window: int, stride: int) -> Tensor:
    return fn(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def max_pool(x: Tensor, window: int = 2, stride: int = 2) -> Tensor:
    return _nchw(F.max_pool2d, x, window, stride)


def avg_pool(x: Tensor, window: int = 2, stride: int = 2) -> Tensor:
    return _nchw(F.avg_pool2d, x, window, stride)


def global_avg_pool(x: Tensor) -> Tensor:
    return x.mean(dim=(1, 2))
