"""Gemma-7B [arXiv:2403.08295]: dense, GeGLU, head_dim 256, MHA (kv=16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    ffn_type="geglu",
    pattern=("global",),
    emb_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
