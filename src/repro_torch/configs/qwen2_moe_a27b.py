"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed top-4 + 4
shared experts (merged 5632 shared FFN), fine-grained d_expert 1408."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    ffn_type="none",
    attn_qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632),
    pattern=("global",),
    tie_embeddings=False,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=4, d_expert=64, n_shared=2, d_shared=96),
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
