"""Device selection for the port's entry points.

Entry points take an explicit `device` and default to "cuda": the port is
written for the GPU, and a run that silently lands on the CPU would report
CPU numbers under GPU names. CPU runs (the tests) pass device="cpu".
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
