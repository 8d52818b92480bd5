"""Psum sparsity accounting (paper Figs. 1b & 5).

Copy of repro.core.sparsity on torch tensors (pure arithmetic).

Two distinct quantities:
  * psum COUNT: positions x Cout x S — how many psums a partitioned layer
    emits per inference (Fig. 1b's 144x-567x blow-up vs unpartitioned).
  * psum SPARSITY: fraction of psums that are exactly zero after f()
    (Fig. 5; vConv sparsity is the natural zero rate, CADC's is ~50-90%).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.core import cadc

Tensor = torch.Tensor


def psum_sparsity(post_f_psums: Tensor) -> Tensor:
    """Fraction of exactly-zero psums (post-f). Scalar fp32."""
    return (post_f_psums == 0).float().mean()


def psum_count(
    out_positions: int, c_out: int, contract_dim: int, crossbar_size: int
) -> int:
    """Psums emitted per inference by one partitioned layer."""
    s = cadc.num_segments(contract_dim, crossbar_size)
    return out_positions * c_out * s


def psum_blowup(contract_dim: int, crossbar_size: int) -> int:
    """x-factor vs the unpartitioned (single-crossbar) case: S."""
    return cadc.num_segments(contract_dim, crossbar_size)


@dataclasses.dataclass
class LayerPsumStats:
    name: str
    segments: int
    count: int            # psums / inference
    sparsity: float       # post-f zero fraction
    partitioned: bool     # False when the layer fits one crossbar (no psums)

    @property
    def nonzero_count(self) -> float:
        return self.count * (1.0 - self.sparsity)


def summarize(stats: Sequence[LayerPsumStats]) -> Dict[str, float]:
    """Network-level aggregates. Layers that fit a single crossbar (paper:
    Conv-1 everywhere) generate no psums and are excluded, as in Fig. 5."""
    part = [s for s in stats if s.partitioned]
    total = sum(s.count for s in part)
    nnz = sum(s.nonzero_count for s in part)
    return {
        "total_psums": float(total),
        "nonzero_psums": float(nnz),
        "eliminated_frac": 0.0 if total == 0 else 1.0 - nnz / total,
        "mean_layer_sparsity": (
            0.0 if not part else float(sum(s.sparsity for s in part) / len(part))
        ),
    }
