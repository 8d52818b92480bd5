"""Shared functional layer machinery of the CNN models.

Port of repro.models.common (fp32). Params are nested dicts of tensors, as
the JAX pytrees, in the JAX layouts: NHWC activations, HWIO conv weights,
[in, out] dense weights. Every weight-bearing layer routes through
`linear_forward` / `conv_forward`, which dispatch on LayerMode.impl:
'vconv' (baseline partitioned matmul) or 'cadc' (per-crossbar dendritic
f()). Psum sparsity statistics are collected through the Ctx object.

Quantization (`quant`), the ADC model (`adc`) and the q8 kernels come with
slice 3 of the port: a LayerMode that asks for them raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cadc as cadc_lib
from repro_torch.core import conv as conv_lib
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
    collection) take the core path whatever `kernel` says.

    `save_gate` is the gradient residual of the kernels ('auto' | 'packed'
    | 'bytes' | 'recompute'; kernels/cadc_matmul.py).
    """

    impl: str = "vconv"                 # 'vconv' | 'cadc'
    crossbar_size: int = 64             # 64 / 128 / 256 (paper sweep)
    fn: str = "relu"                    # dendritic f() for cadc
    quant: Optional[Any] = None         # slice 3 (None = fp32)
    adc: Optional[Any] = None           # slice 3 (None = ideal psums)
    collect_stats: bool = False
    kernel: str = "auto"
    save_gate: str = "auto"
    q8_fused: bool = False              # slice 3

    def __post_init__(self):
        if self.quant is not None or self.adc is not None or self.q8_fused:
            raise NotImplementedError(
                "quantized layers, the ADC model and the q8 kernels come "
                "with slice 3 of the port; LayerMode takes fp32 only")
        if self.kernel not in kops.IMPLS:
            raise ValueError(f"kernel={self.kernel!r}; choose from "
                             f"{kops.IMPLS}")

    def dendritic_fn(self) -> str:
        return self.fn if self.impl == "cadc" else "identity"


class Ctx:
    """Per-forward context: the layer mode and the psum stats sink. (The
    JAX Ctx also carries the ADC model's rng, which comes with slice 3.)"""

    def __init__(self, mode: LayerMode):
        self.mode = mode
        self.stats: List[Dict[str, Tensor]] = []
        self._names: List[str] = []

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
    materialized psums (the stats sink), which the kernels never write."""
    return mode.kernel != "torch" and not want_ps


def linear_forward(p: Params, x: Tensor, ctx: Ctx, *,
                   name: str = "fc") -> Tensor:
    mode = ctx.mode
    segs = cadc_lib.num_segments(p["w"].shape[0], mode.crossbar_size)
    want_ps = mode.collect_stats and segs > 1
    if _use_fused(mode, want_ps):
        y = kops.cadc_matmul(x, p["w"], crossbar_size=mode.crossbar_size,
                             fn=mode.dendritic_fn(), impl=mode.kernel,
                             save_gate=mode.save_gate)
    else:
        out = cadc_lib.cadc_matmul(x, p["w"],
                                   crossbar_size=mode.crossbar_size,
                                   fn=mode.dendritic_fn(),
                                   return_psums=want_ps)
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
    if _use_fused(mode, want_ps):
        return kops.cadc_conv2d(x, p["w"], crossbar_size=mode.crossbar_size,
                                fn=mode.dendritic_fn(), stride=stride,
                                padding=padding, impl=mode.kernel,
                                save_gate=mode.save_gate)
    out = conv_lib.cadc_conv2d(x, p["w"], crossbar_size=mode.crossbar_size,
                               fn=mode.dendritic_fn(), stride=stride,
                               padding=padding, return_psums=want_ps)
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
