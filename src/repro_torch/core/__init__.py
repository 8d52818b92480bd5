"""CADC core: the paper's contribution as plain PyTorch ops."""
from repro_torch.core.cadc import (
    cadc_matmul,
    num_segments,
    pad_to_segments,
    vconv_matmul,
)
from repro_torch.core.dendritic import DENDRITIC_FNS

__all__ = [
    "DENDRITIC_FNS",
    "cadc_matmul",
    "num_segments",
    "pad_to_segments",
    "vconv_matmul",
]
