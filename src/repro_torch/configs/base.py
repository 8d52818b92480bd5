"""Architecture config schema + registry (--arch <id> selectable).

A copy of repro.configs.base: the port keeps its own configs and never
imports the JAX package. Differences from the original: the registry names
only the archs the port serves, and the two backend knobs take the port's
values ('auto' | 'cuda' | 'torch' — see kernel_impl / paged_attn_impl).

Every assigned architecture is one frozen ArchConfig; the CADC integration
knobs (linear_impl / crossbar_size / dendritic_fn) turn the paper's technique
on for ANY weight-bearing matmul in the stack.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The assigned shape set (identical across the 10 LM-family archs).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_expert: int = 0          # per-expert FFN hidden dim
    n_shared: int = 0          # shared (always-on) experts
    d_shared: int = 0          # shared-expert hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block layout: cycled over layers. entries: 'global' | 'local' |
    # 'rglru' | 'mlstm' | 'slstm'
    pattern: Tuple[str, ...] = ("global",)
    local_window: int = 4096
    ffn_type: str = "swiglu"     # swiglu | geglu | gelu | none
    attn_qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    is_encoder: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    emb_scale: bool = False      # gemma-style sqrt(d) embedding scaling

    moe: MoEConfig = MoEConfig()

    # modality frontend stub (input_specs supplies precomputed embeddings)
    frontend: Optional[str] = None   # 'vit' | 'audio'
    frontend_dim: int = 0
    frontend_len: int = 0            # prefix length occupied by frontend embs

    # ssm/hybrid block dims
    rnn_width: int = 0               # RG-LRU width (recurrentgemma)
    conv1d_width: int = 4
    # chunkwise-parallel mLSTM chunk length (§Perf iter 3); 0 = sequential
    mlstm_chunk: int = 256
    # audit-only: unroll the attention q-chunk loop so cost_analysis prices
    # every chunk (lax.scan bodies are priced once) — same math/blocking
    attn_unroll: bool = False

    # ---- CADC integration (the paper's technique) ----
    linear_impl: str = "dense"       # 'dense' | 'cadc'
    crossbar_size: int = 256
    dendritic_fn: str = "relu"
    # Kernel backend for CADC linears ('auto' | 'cuda' | 'torch'):
    # 'auto' (the default) runs the hand-written CADC-matmul kernel
    # (kernels/cadc_matmul.py) on CUDA tensors and the plain segmented
    # einsum on CPU tensors; 'cuda' runs the kernel and raises on CPU
    # tensors; 'torch' keeps the plain segmented einsum on any device (the
    # counterpart of the JAX package's 'xla', its default there: it honors
    # bf16_wire and feeds the psum telemetry tap).
    kernel_impl: str = "auto"
    # Gradient-residual format of the CADC matmul under autograd ('auto' |
    # 'packed' | 'bytes' | 'recompute'; kernels/cadc_matmul.py gate_mode):
    # what K1g saves in the forward for K2, the backward.
    kernel_save_gate: str = "auto"
    # Paged-attention decode backend ('auto' | 'cuda' | 'torch'): 'cuda' is
    # the flash-decoding kernel over the block table (kernels/
    # paged_attention.py), 'torch' the gather formulation — bit-identical
    # to the dense caches, and the kernel's oracle. 'auto' = kernel for
    # CUDA tensors, plain version for CPU tensors.
    paged_attn_impl: str = "auto"

    # ---- numerics / execution ----
    dtype: str = "bfloat16"
    # stored-parameter dtype. Training keeps fp32 masters (bf16_wire casts
    # per step); SERVING stores bf16 — halves the per-token weight reads
    # that dominate decode cells (§Perf iter 6).
    params_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 512            # q-chunk for blockwise attention
    scan_layers: bool = True
    # Megatron-style activation-TP constraints (§Perf iter 1). No-op
    # outside a mesh context / on non-divisible dims — safe everywhere.
    act_sharding: bool = True
    # §Perf iter 4 (REFUTED — default off): residual stream seq-sharded
    # over 'model' at layer boundaries. Hypothesis was GSPMD's ar+slice ->
    # reduce-scatter rewrite would halve TP wire bytes (Megatron-SP);
    # measured: collective bytes INCREASED (gemma_7b train 2.60->3.61s)
    # because GSPMD inserts plain reshards, not the SP schedule — real SP
    # needs manual shard_map collectives. Kept as an ablation flag.
    seq_sharding: bool = False
    # §Perf iter 2: bf16 on every wire — params cast to compute dtype once
    # per step (FSDP gathers + wgrad reductions ride bf16) and matmul
    # partial sums stored bf16 so row-parallel ARs do too. The paper's
    # psum bus carries 4-5b ADC codes; bf16 psum accumulation is strictly
    # more precise than the hardware being reproduced.
    bf16_wire: bool = True

    # per-shape overrides (e.g. microbatching)
    n_microbatches: int = 8

    # ---- serving defaults (repro_torch.serve continuous-batching engine) ----
    # slot count of the continuous-batching engine (concurrent sequences
    # resident in the caches) and the paged-KV block granule. block size
    # must divide both max_len and the local ring (min(local_window,
    # max_len)); 16 divides every assigned arch's window.
    serve_slots: int = 8
    serve_block_size: int = 16
    # psum-sparsity telemetry sample period (decode steps between taps;
    # 0 = off). Each sample re-runs one decode step with kernel_impl='torch'
    # (the only path that materializes psums) — steady-state steps must
    # NOT pay that double compute, so keep this sparse. Engine/CLI default
    # to this; EngineConfig.telemetry_every / --telemetry-every override.
    serve_telemetry_every: int = 0

    # embedding/head rows padded to this multiple (TP/lane alignment —
    # Megatron-style vocab padding; logits are sliced back to vocab_size)
    vocab_pad_multiple: int = 256

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def pattern_for_layers(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def supports_decode(self) -> bool:
        return not self.is_encoder

    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic stacks:
        every layer must be local/recurrent, or the global layers must be
        MQA (tiny cache) within a mostly-local pattern."""
        kinds = set(self.pattern)
        if kinds <= {"local", "rglru", "mlstm", "slstm"}:
            return True
        if "global" in kinds and kinds != {"global"}:
            # mixed pattern: allow when global layers are MQA (kv_heads == 1)
            return self.n_kv_heads == 1
        return False

    def shape_cells(self) -> Sequence[str]:
        """The dry-run cells this arch runs, with skip reasons for the rest."""
        cells = []
        for s in SHAPES.values():
            if s.kind == "decode" and not self.supports_decode():
                continue
            if s.name == "long_500k" and not self.supports_long_context():
                continue
            if s.name == "prefill_32k" and self.is_encoder:
                cells.append(s.name)  # encoders do run long forward passes
                continue
            cells.append(s.name)
        return cells

    def skip_reasons(self) -> Dict[str, str]:
        out = {}
        for s in SHAPES.values():
            if s.name in self.shape_cells():
                continue
            if s.kind == "decode" and not self.supports_decode():
                out[s.name] = "encoder-only: no decode step"
            elif s.name == "long_500k":
                out[s.name] = "pure full-attention stack: 500k needs sub-quadratic attention"
        return out


# The archs the port has: every LM of the JAX package. hubert_xlarge is an
# encoder (no decode path): it is trained, never served.
ARCH_IDS = [
    "gemma3_1b",
    "gemma_7b",
    "codeqwen15_7b",
    "phi4_mini_38b",
    "mixtral_8x22b",
    "qwen2_moe_a27b",
    "internvl2_1b",
    "recurrentgemma_9b",
    "xlstm_13b",
    "hubert_xlarge",
]


def get_config(arch_id: str, **overrides) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    cfg: ArchConfig = mod.CONFIG
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    return cfg


def smoke_config(arch_id: str, **overrides) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    cfg: ArchConfig = mod.SMOKE
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    return cfg
