"""FFN blocks: SwiGLU / GeGLU / GELU, CADC-routable. Port of
repro.models.lm.ffn."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll

Tensor = torch.Tensor


def ffn_init(gen: torch.Generator, cfg: ArchConfig, device: torch.device,
             d_ff: int = 0) -> Dict:
    """d_ff: the hidden width (0: cfg.d_ff; MoE's shared experts pass
    theirs). The gated kinds have w_gate, w_up, w_down; "gelu" (an
    encoder's) w_up and w_down with biases."""
    d, d_ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_type in ("swiglu", "geglu"):
        return {
            "w_gate": ll.linear_init(gen, d, d_ff, cfg, device),
            "w_up": ll.linear_init(gen, d, d_ff, cfg, device),
            "w_down": ll.linear_init(gen, d_ff, d, cfg, device),
        }
    return {
        "w_up": ll.linear_init(gen, d, d_ff, cfg, device, bias=True),
        "w_down": ll.linear_init(gen, d_ff, d, cfg, device, bias=True),
    }


def ffn_apply(p: Dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    # gelu: the JAX package's jax.nn.gelu(approximate=True), the tanh form
    if cfg.ffn_type == "gelu":
        h = F.gelu(ll.linear_apply(p["w_up"], x, cfg), approximate="tanh")
        return ll.linear_apply(p["w_down"], h, cfg)
    gate = ll.linear_apply(p["w_gate"], x, cfg)
    if cfg.ffn_type == "swiglu":
        g = F.silu(gate)
    elif cfg.ffn_type == "geglu":
        g = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type}")
    u = ll.linear_apply(p["w_up"], x, cfg)
    return ll.linear_apply(p["w_down"], g * u, cfg)
