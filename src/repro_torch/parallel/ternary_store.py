"""Ternary weight store: the paper's 2-bit crossbar codes as a wire format.
Port of repro.parallel.ternary_store.

The CADC macro stores weights as ternary codes (twin-9T bitcell); the
4/2/4b system never moves fp weights at all. Here weights live SHARDED as
int8 codes {-1, 0, +1} plus one fp32 scale per output column, so every
FSDP all-gather moves 1 byte a parameter instead of 4 (or 2).

Least-squares per-column scale: alpha_j = mean of |w_j| over the nonzero
codes minimizes ||w_j - alpha_j c_j||^2 for fixed codes. The codes are the
TWN rule's (core/quant.ternary_codes).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.quant import ternary_codes
from repro_torch.parallel import comm

Tensor = torch.Tensor


def encode(w: Tensor) -> Dict[str, Tensor]:
    """[D, N] fp -> {"codes": int8 [D, N], "scale": fp32 [N]}."""
    codes = ternary_codes(w)
    nz = (codes != 0).float()
    num = (w.float().abs() * nz).sum(dim=0)
    den = torch.clamp(nz.sum(dim=0), min=1.0)
    return {"codes": codes, "scale": (num / den).float()}


def decode(t: Dict[str, Tensor], dtype=torch.bfloat16) -> Tensor:
    return (t["codes"].float() * t["scale"][None, :]).to(dtype)


def ternary_linear(x: Tensor, t: Dict[str, Tensor], *,
                   gather_codes: bool = False, group=None) -> Tensor:
    """x [..., D] @ (alpha * codes): the scale multiplies the fp32 psum,
    one multiply an output (the IMA's reference-scale step). The fp32
    product is torch.matmul, as the JAX package computes it outside any
    kernel.

    gather_codes=True: t["codes"] is this rank's FSDP shard, rows [r * D /
    T, (r + 1) * D / T) of the codes over `group` (the "data" axis), and
    the int8 shards are all-gathered (1 byte a parameter) before the
    product on the whole codes."""
    codes = t["codes"]
    if gather_codes:
        codes = comm.all_gather(codes, 0, group)
    psum = torch.matmul(x.float(), codes.float())
    return (psum * t["scale"]).to(x.dtype)


def encode_tree(params, *, min_size: int = 1 << 16):
    """Encode every 2-D floating leaf named "w" of at least min_size
    elements (the serving checkpoint transform); other leaves pass through.
    Returns (tree, n_encoded)."""
    n = 0

    def enc(key, leaf):
        nonlocal n
        if (key == "w" and isinstance(leaf, Tensor) and leaf.ndim == 2
                and leaf.numel() >= min_size and leaf.is_floating_point()):
            n += 1
            return encode(leaf)
        return walk(leaf)

    def walk(node):
        if isinstance(node, dict):
            return {k: enc(str(k), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(enc(f"[{i}]", v) for i, v in enumerate(node))
        return node

    return walk(params), n


def relative_error(w: Tensor) -> float:
    """||w - dec(enc(w))|| / ||w|| — the W2 quantization noise."""
    t = encode(w)
    return float(torch.linalg.norm(w.float() - decode(t, torch.float32))
                 / torch.linalg.norm(w.float()))
