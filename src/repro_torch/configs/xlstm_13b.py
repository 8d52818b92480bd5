"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM residual blocks (7:1),
no separate FFN (d_ff=0 — blocks carry their own up/down projections).
Fully recurrent => long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    ffn_type="none",
    pattern=("mlstm",) * 7 + ("slstm",),
    tie_embeddings=False,
)

SMOKE = CONFIG.with_overrides(
    dtype="float32",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab_size=512, pattern=("mlstm", "slstm"),
    crossbar_size=64, attn_chunk=64, n_microbatches=1,
)
