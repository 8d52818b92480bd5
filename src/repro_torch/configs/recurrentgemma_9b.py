"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: RG-LRU + local attention,
2:1 recurrent:attention pattern, MQA (kv=1). Sub-quadratic => long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    ffn_type="geglu",
    pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rnn_width=4096,
    conv1d_width=4,
    emb_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
    vocab_size=512, local_window=32, rnn_width=64,
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
