"""FFN blocks: SwiGLU / GeGLU / GELU, CADC-routable. Port of
repro.models.lm.ffn.

Under the TP context (parallel.act_sharding; the JAX package's `_tp`
constraint, d_ff over "model") the up / gate projections are
column-parallel and w_down row-parallel over each rank's block of d_ff,
or over the gathered hidden where that block is not whole segments
(layers.segment_local). Under sequence parallelism the split form gathers
its input along S (layers.tp_in) and reduce-scatters w_down's output; a
block whose hidden does not divide runs on the gathered sequence
(layers.whole_seq)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as ll
from repro_torch.parallel import act_sharding as sa

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


def hidden_split(cfg: ArchConfig, d_ff: int,
                 sizes: Optional[Dict[str, int]] = None) -> bool:
    """Whether the hidden dim is split over "model" (d_ff divides it)."""
    return sa.splits(d_ff, sizes=sizes, enabled=cfg.act_sharding)


def down_local(cfg: ArchConfig, d_ff: int, model: int) -> bool:
    """Whether w_down runs row-parallel on each rank's hidden block."""
    return ll.segment_local(cfg, d_ff, model)


def ffn_apply(p: Dict, x: Tensor, cfg: ArchConfig,
              d_ff: Optional[int] = None, copied: bool = False) -> Tensor:
    """d_ff: the block's hidden width (default cfg.d_ff; MoE's shared
    experts pass theirs), which decides the TP form. copied: x has passed
    through comm.copy_to already (the caller's TP region: MoE's shared
    experts read the experts' input)."""
    ctx = sa.current()
    d_ff = d_ff or cfg.d_ff
    tp = ctx is not None and hidden_split(cfg, d_ff)
    if ctx is not None and ctx.seq and not tp:
        return ll.whole_seq(lambda h: ffn_apply(p, h, cfg, d_ff), x)
    if tp and not copied:
        x = ll.tp_in(x)
        up = ll.column_linear
    else:
        up = ll.linear_apply

    def down(h):
        if tp:
            return ll.row_or_gathered(
                p["w_down"], h, cfg,
                down_local(cfg, d_ff, ctx.sizes["model"]))
        return ll.linear_apply(p["w_down"], h, cfg)

    # gelu: the JAX package's jax.nn.gelu(approximate=True), the tanh form
    if cfg.ffn_type == "gelu":
        return down(F.gelu(up(p["w_up"], x, cfg), approximate="tanh"))
    gate = up(p["w_gate"], x, cfg)
    if cfg.ffn_type == "swiglu":
        g = F.silu(gate)
    elif cfg.ffn_type == "geglu":
        g = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type}")
    u = up(p["w_up"], x, cfg)
    return down(g * u)
