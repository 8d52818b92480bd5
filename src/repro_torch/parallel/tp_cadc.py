"""Tensor-parallel CADC linear: the paper's psum locality as an explicit
collective schedule. Port of repro.parallel.tp_cadc.

Layout: the segment axis S of a CADC weight [S, xbar, N] is split over the
ranks of the tensor-parallel group ("model") — a crossbar never spans
devices, so the dendritic f() is applied entirely on its rank and ONLY the
(linear) cross-segment sum crosses the wire:

    per rank:  y_loc = sum_{s in local segments} f(x_s @ w_s)   (no comm)
    across:    y     = all_reduce(y_loc)                         (1 AR)

y_loc is cast to a narrow wire dtype (bf16) before the all-reduce, halving
the collective's bytes: post-f() psum sums are activation-scaled and
tolerate bf16 (the paper compresses the same quantity on its macro's bus).
vConv cannot do this locally-nonlinear trick: it must move raw psums (S x
the traffic) or sum before f(); `tp_vconv_linear` is its exact form.

Rank r of a group of T owns segments [r * S / T, (r + 1) * S / T). On the
card y_loc is one K1 launch (kernels/ops.cadc_matmul) over the rank's
slice of x and its segments, reshaped to [S_loc * xbar, N]; impl="torch"
(or a CPU tensor under "auto") runs the plain version,
core.cadc.cadc_einsum_segments. `tp_cadc_linear` is a forward: it runs
without autograd.

`tp_cadc_row_linear` is the differentiable form the LM train step's
row-parallel layers run (models/lm/layers.row_linear): the rank holds its
segments' weight block and its segment-aligned slice of the activation,
K1g runs over them forward and K2 backward (CadcMatmulFn on the local
[S_loc * xbar, N] block), and Megatron's row-parallel all-reduce
(comm.reduce_from: the sum forward, the gradient unchanged backward)
carries the partial outputs in their own dtype. Under sequence
parallelism that collective is a reduce-scatter along S
(comm.reduce_scatter_from, `scatter_dim`): the same local segments, the
same f() on each rank, only the linear sum leaves the rank, and each rank
keeps its block of the sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import cadc as cadc_lib
from repro_torch.core import work
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops as kops
from repro_torch.parallel import comm

Tensor = torch.Tensor


def segment_weights(w: Tensor, crossbar_size: int) -> Tensor:
    """[D, N] -> [S, xbar, N] (zero-padded D), the TP-shardable CADC
    layout. The caller pads x to S * xbar as well."""
    d, n = w.shape
    s = cadc_lib.num_segments(d, crossbar_size)
    return cadc_lib.pad_to_segments(w, 0, crossbar_size).reshape(
        s, crossbar_size, n)


def _local_product(x_loc: Tensor, w_loc: Tensor, *, fn: str, impl: str,
                   save_gate: str = "auto",
                   psum_dtype: Optional[torch.dtype] = None) -> Tensor:
    """sum over the local segments s of f(x_s @ w_s), x_loc [..., S_loc *
    xbar], w_loc [S_loc, xbar, N], where the routes split: K1 / K1g and K2
    on the card, cadc_einsum_segments otherwise."""
    s_loc, xbar, n = w_loc.shape
    if kops.resolve(impl, x_loc) == "cuda":
        return kops.cadc_matmul(x_loc, w_loc.reshape(s_loc * xbar, n),
                                crossbar_size=xbar, fn=fn, impl=impl,
                                save_gate=save_gate)
    return cadc_lib.cadc_einsum_segments(
        x_loc.reshape(*x_loc.shape[:-1], s_loc, xbar), w_loc, fn, psum_dtype)


def _local_cost(x_loc: Tensor, w_loc: Tensor, *, fn: str,
                save_gate: str = "auto", **_):
    return cm.linear_cost(x_loc, w_loc, crossbar_size=w_loc.shape[1], fn=fn,
                          save_gate=save_gate)


@torch.no_grad()
def tp_cadc_linear(x: Tensor, w_seg: Tensor, *, group=None,
                   fn: str = "relu",
                   wire_dtype: Optional[torch.dtype] = torch.bfloat16,
                   impl: str = "auto") -> Tensor:
    """y[..., N] = sum_s f(x_s @ w_s) in fp32, the segments split over
    `group` (default: the default process group).

    x: [..., D], the same on every rank (D = S * xbar).
    w_seg: [S, xbar, N] with S % group size == 0 (ValueError otherwise);
      each rank reads its own segments only.
    wire_dtype: dtype of the partial outputs on the wire (None = fp32).
    """
    s, xbar, _ = w_seg.shape
    t = dist.get_world_size(group)
    if s % t:
        raise ValueError(f"segments {s} not divisible by the group's size {t}")
    if x.shape[-1] != s * xbar:
        raise ValueError(f"x [..., {x.shape[-1]}] does not span the {s} "
                         f"segments of {xbar} rows: pad it to {s * xbar}")
    r = dist.get_rank(group)
    s_loc = s // t
    x_loc = x[..., r * s_loc * xbar:(r + 1) * s_loc * xbar]
    w_loc = w_seg[r * s_loc:(r + 1) * s_loc]
    y_loc = work.product(_local_product, _local_cost, x_loc, w_loc, fn=fn,
                         impl=impl)
    y = y_loc.to(wire_dtype or torch.float32)   # psum-compressed wire
    with work.quiet():
        dist.all_reduce(y, group=group)         # the ONLY collective
    return y.float()


def tp_cadc_row_linear(x_loc: Tensor, w_loc: Tensor, *, group,
                       fn: str = "relu", impl: str = "auto",
                       save_gate: str = "auto",
                       psum_dtype: Optional[torch.dtype] = None,
                       scatter_dim: Optional[int] = None) -> Tensor:
    """y[..., N] = all_reduce(sum over the local segments s of
    f(x_s @ w_s)) over `group`, differentiable; with `scatter_dim`, this
    rank's block along that dim of the sum (a reduce-scatter).

    x_loc: [..., S_loc * xbar], this rank's slice of the activation, cut
      on segment boundaries (ValueError otherwise: a crossbar never spans
      ranks); w_loc: [S_loc, xbar, N], this rank's segments.
    The product runs in x_loc's dtype with fp32 psums (`psum_dtype`:
    stored in that dtype first, on the plain path, as linear_apply's
    bf16_wire does); the all-reduce carries the result in x_loc's dtype.
    """
    s_loc, xbar, n = w_loc.shape
    if x_loc.shape[-1] != s_loc * xbar:
        raise ValueError(f"x [..., {x_loc.shape[-1]}] is not the {s_loc} "
                         f"local segments of {xbar} rows")
    y = work.product(_local_product, _local_cost, x_loc, w_loc, fn=fn,
                     impl=impl, save_gate=save_gate, psum_dtype=psum_dtype)
    if scatter_dim is not None:
        return comm.reduce_scatter_from(y, scatter_dim, group)
    return comm.reduce_from(y, group)


def tp_vconv_linear(x: Tensor, w_seg: Tensor, *, group=None,
                    impl: str = "auto") -> Tensor:
    """Baseline: the same layout with identity f — the exact TP matmul.
    The partial sums are raw (fp32 wire: bf16 would change the result
    beyond the quantization CADC already absorbed in f())."""
    return tp_cadc_linear(x, w_seg, group=group, fn="identity",
                          wire_dtype=None, impl=impl)
