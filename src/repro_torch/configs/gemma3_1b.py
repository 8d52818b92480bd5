"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 5:1 local:global, MQA, 128k ctx.

long_500k runs: local layers cache a 512 window; the 1-in-6 global layers
are MQA (kv=1) so their 500k cache stays small.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    ffn_type="geglu",
    pattern=("local", "local", "local", "local", "local", "global"),
    local_window=512,
    rope_theta=1_000_000.0,
    emb_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
    vocab_size=512, local_window=32, crossbar_size=64, attn_chunk=64,
    n_microbatches=1,
)
