"""InternVL2-1B [arXiv:2404.16821]: InternViT frontend (STUB — the caller
supplies precomputed patch embeddings, ServeEngine.submit(patches=)) +
Qwen2-0.5B-style LM backbone."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    ffn_type="swiglu",
    attn_qkv_bias=True,
    pattern=("global",),
    tie_embeddings=True,
    frontend="vit",
    frontend_dim=1024,   # InternViT-300M output width
    frontend_len=256,    # patch tokens prepended to the text sequence
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, frontend_dim=48, frontend_len=16,
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
