"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch, QKV bias, MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    ffn_type="swiglu",
    attn_qkv_bias=True,
    pattern=("global",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=160,
    vocab_size=512, crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
