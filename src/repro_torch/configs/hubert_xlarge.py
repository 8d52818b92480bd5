"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only transformer over conv-stem
frame embeddings (the stem is a stub: the batch carries precomputed 512-d
frames). Objective: masked frame cluster prediction (504 k-means codes),
i.e. frame-level CE — HuBERT's pretraining loss. No decode shapes: the
port trains it (transformer.forward_train) and its serve engine refuses
it.

Adaptation note: HuBERT uses a conv positional embedding; RoPE stands in
on the encoder (bidirectional, no mask) — positional treatment is
orthogonal to the CADC technique under study."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    ffn_type="gelu",
    pattern=("global",),
    is_encoder=True,
    tie_embeddings=False,
    frontend="audio",
    frontend_dim=512,
    frontend_len=-1,  # the whole sequence is frontend frames
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=64, frontend_dim=32,
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
