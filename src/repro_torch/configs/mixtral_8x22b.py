"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE, SWA (window 4096).

The sliding window bounds the KV cache (rings of min(window, max_len)).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    ffn_type="none",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    pattern=("local",),
    local_window=4096,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    n_microbatches=16,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, local_window=32,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=96),
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
