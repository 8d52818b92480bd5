"""Continuous-batching serve engine over the CADC decode path (port of
repro.serve).

  * engine.ServeEngine — admission queue, slot allocation, finished-
                         sequence eviction + slot/block reuse, batched
                         prefill / decode scheduling.
  * blocks             — host-side paged-KV block allocator + per-kind
                         block tables.
  * backends           — dense (per-slot ring caches) and paged (block
                         tables over KV pools) cache programs.
  * speculative        — draft proposers (n-gram prompt lookup, a
                         shrunk draft model) for draft/verify decoding.
  * telemetry          — tokens/s, TTFT, p50/p99 step latency and the
                         psum-sparsity signal tapped from the decode path.
  * workload           — Poisson-style synthetic arrival streams.
"""
from repro_torch.serve.blocks import BlockAllocator, BlockTables
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.speculative import (DraftModelProposer, NgramProposer,
                                           Proposer, default_draft_config,
                                           make_proposer)
from repro_torch.serve.telemetry import Telemetry
from repro_torch.serve.workload import poisson_workload

__all__ = [
    "BlockAllocator",
    "BlockTables",
    "DraftModelProposer",
    "EngineConfig",
    "NgramProposer",
    "Proposer",
    "Request",
    "ServeEngine",
    "Telemetry",
    "default_draft_config",
    "make_proposer",
    "poisson_workload",
]
