"""What the LM drivers share: the port's ArchConfig from a configuration
file, and the weights, which the benchmark makes itself from the seed.

The weights are one fp32 draw on the device (`torch.randn` with a
Generator seeded by the run's seed), cut into leaves: the embedding
(std 0.02), every linear (std 1 / sqrt(d_in)), the RMSNorm scales (std
0.1: the stack's norm is x · (1 + scale)). The same draw gives the
program its parameter tree and the reference its plain matrices, so
neither takes the other's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import get_config


def arch(config: dict, traffic: dict):
    """The port's ArchConfig for a decoder configuration file: the port's
    registry entry `port_arch`, every size and setting overridden from
    the file."""
    c = config
    heads = c["num_attention_heads"]
    return get_config(c["port_arch"]).with_overrides(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=heads, n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim", c["hidden_size"] // heads),
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        tie_embeddings=c["tie_word_embeddings"], norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], pattern=("global",),
        ffn_type="swiglu", linear_impl=c["linear_impl"],
        crossbar_size=c["crossbar_size"], dendritic_fn=c["dendritic_fn"],
        kernel_impl=c["kernel_impl"], dtype=c["dtype"],
        params_dtype="float32", bf16_wire=c["bf16_wire"],
        remat=c["remat"], attn_chunk=c.get("attn_chunk", 512),
        n_microbatches=traffic.get("micro", 1))


def dims(c: dict) -> dict:
    h = c["num_attention_heads"]
    hd = c.get("head_dim", c["hidden_size"] // h)
    return {"d": c["hidden_size"], "h": h, "k": c["num_key_value_heads"],
            "hd": hd, "f": c["intermediate_size"], "v": c["vocab_size"],
            "layers": c["num_hidden_layers"]}


LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def layer_shapes(c: dict) -> Dict[str, Tuple[int, int]]:
    """Each linear of a layer as [d_in, d_out]."""
    n = dims(c)
    d, q, kv, f = n["d"], n["h"] * n["hd"], n["k"] * n["hd"], n["f"]
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def leaf_specs(c: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every leaf, in the stack's leaf order."""
    n = dims(c)
    out = [("embed", (n["v"], n["d"]), 0.02),
           ("final_norm", (n["d"],), 0.1)]
    for i in range(n["layers"]):
        p = f"layers.{i}."
        out.append((p + "ln1", (n["d"],), 0.1))
        for name in LINEARS[:4]:
            d_in, d_out = layer_shapes(c)[name]
            out.append((p + name, (d_in, d_out), 1 / math.sqrt(d_in)))
        out.append((p + "ln2", (n["d"],), 0.1))
        for name in LINEARS[4:]:
            d_in, d_out = layer_shapes(c)[name]
            out.append((p + name, (d_in, d_out), 1 / math.sqrt(d_in)))
    return out


def draw(c: dict, seed: int, device, vocab_rows: int = 0
         ) -> Dict[str, torch.Tensor]:
    """The weights of `seed`: leaf name -> fp32 tensor. The embedding is
    its own draw (Generator seed + 1), into the first vocab rows of a
    table of `vocab_rows` (the program's padded vocab; 0: the vocab),
    the padding zero; every other leaf a view of one draw (seed)."""
    specs = leaf_specs(c)
    (_, (v, d), e_std), rest = specs[0], specs[1:]
    table = torch.zeros(max(vocab_rows, v), d, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    torch.randn((v, d), generator=gen, out=table[:v])
    table[:v].mul_(e_std)
    total = sum(math.prod(s) for _, s, _ in rest)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {"embed": table}, 0
    for name, shape, std in rest:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def program_tree(w: Dict[str, torch.Tensor], cfg) -> dict:
    """The port's parameter tree (transformer.init's layout: CADC linears
    segmented [S, xbar, d_out]) as views of the weights."""
    xbar = cfg.crossbar_size

    def lin(t):
        if cfg.linear_impl != "cadc":
            return {"w": t}
        if t.shape[0] % xbar:
            raise ValueError(f"d_in {t.shape[0]} is not whole crossbars")
        return {"w": t.view(t.shape[0] // xbar, xbar, t.shape[1])}

    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        layers.append({
            "ln1": {"scale": w[p + "ln1"]},
            "attn": {k: lin(w[p + k]) for k in LINEARS[:4]},
            "ln2": {"scale": w[p + "ln2"]},
            "ffn": {k: lin(w[p + k]) for k in LINEARS[4:]}})
    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["final_norm"]}, "layers": layers}


def leaves(tree) -> list:
    """A tree's leaves in insertion order (the port's leaf order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def names(c: dict) -> List[str]:
    return [n for n, _, _ in leaf_specs(c)]


def shapes(tree) -> List[tuple]:
    """The shapes of a tree's leaves, in order."""
    return [tuple(t.shape) for t in leaves(tree)]


def check_layout(got: List[tuple], cfg) -> None:
    """Leaf shapes `got` are those of the port's own init. (A process's
    first tree on the meta device imports torch.distributed.tensor and
    torch._dynamo: seconds.)"""
    from repro_torch.launch import steps

    want = shapes(steps.abstract_params(cfg))
    if want != list(got):
        raise ValueError(f"parameter layout differs from the port's: "
                         f"{got[:4]} against {want[:4]}")


def leaf_norms(tree, vocab: int) -> torch.Tensor:
    """Each leaf's fp32 norm (the embedding over its vocab rows), stacked
    on the device."""
    out = []
    for i, t in enumerate(leaves(tree)):
        t = t.detach()
        if i == 0:
            t = t[:vocab]
        out.append(torch.linalg.vector_norm(t.float()))
    return torch.stack(out)


def delta_norms(tree, w0: Dict[str, torch.Tensor], order: List[str],
                vocab: int) -> torch.Tensor:
    """Each leaf's fp32 norm of (tree - w0), the embedding over its vocab
    rows."""
    out = []
    for i, (t, name) in enumerate(zip(leaves(tree), order)):
        d = t.detach().reshape(w0[name].shape) - w0[name]
        if i == 0:
            d = d[:vocab]
        out.append(torch.linalg.vector_norm(d.float()))
    return torch.stack(out)
