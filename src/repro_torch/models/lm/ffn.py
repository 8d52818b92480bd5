"""FFN blocks: SwiGLU / GeGLU, CADC-routable. Port of repro.models.lm.ffn."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll

Tensor = torch.Tensor


def ffn_init(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Dict:
    if cfg.ffn_type not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"ffn_type {cfg.ffn_type!r} is not ported (swiglu, geglu are)")
    d, d_ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ll.linear_init(gen, d, d_ff, cfg, device),
        "w_up": ll.linear_init(gen, d, d_ff, cfg, device),
        "w_down": ll.linear_init(gen, d_ff, d, cfg, device),
    }


def ffn_apply(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    gate = ll.linear_apply(p["w_gate"], x, cfg)
    if cfg.ffn_type == "swiglu":
        g = F.silu(gate)
    elif cfg.ffn_type == "geglu":
        # the JAX package's jax.nn.gelu(approximate=True): the tanh form
        g = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type}")
    u = ll.linear_apply(p["w_up"], x, cfg)
    return ll.linear_apply(p["w_down"], g * u, cfg)
