"""Phi-4-mini 3.8B [arXiv:2412.08905]: dense, RoPE, SwiGLU, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    ffn_type="swiglu",
    pattern=("global",),
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
