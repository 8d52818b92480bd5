"""Serving telemetry: throughput, TTFT, step-latency percentiles, and the
paper's psum-sparsity signal sampled live from the decode path.

The sparsity probe is the CADC quantity behind the paper's 29.3% / 47.9%
buffer/accumulation reductions: the fraction of crossbar partial sums the
dendritic gate zeroes (`gate_off`), plus the exact-zero fraction. The
engine samples it every `telemetry_every` decode steps by running one
decode step on a copy of the caches with kernel_impl='torch' (the only
path that materializes psums) and the layers.psum_stats_tap active; the
tap's records are labelled per layer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class RequestTrace:
    rid: int
    arrival_wall: Optional[float] = None
    first_token_wall: Optional[float] = None
    finish_wall: Optional[float] = None
    n_generated: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_wall is None or self.arrival_wall is None:
            return None
        return self.first_token_wall - self.arrival_wall


class Telemetry:
    def __init__(self):
        self.requests: Dict[int, RequestTrace] = {}
        self.step_s: List[float] = []        # decode-step wall seconds
        self.prefill_s: List[float] = []
        self.decode_tokens = 0
        self.decode_wall = 0.0
        self.sparsity: Dict[str, List[Dict[str, float]]] = {}
        # speculative decode counters (record_spec; all zero when off)
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.spec_slot_steps = 0  # sum of active-slot counts over steps
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter()

    def trace(self, rid: int) -> RequestTrace:
        if rid not in self.requests:
            self.requests[rid] = RequestTrace(rid)
        return self.requests[rid]

    def record_step(self, dt: float, n_tokens: int) -> None:
        self.step_s.append(dt)
        self.decode_wall += dt
        self.decode_tokens += n_tokens

    def record_prefill(self, dt: float) -> None:
        self.prefill_s.append(dt)

    def record_spec(self, drafted: int, accepted: int, committed: int,
                    n_active: int) -> None:
        """One draft/verify step: `drafted` draft tokens proposed across
        the `n_active` decoding slots, `accepted` of them verified
        (longest matching prefix), `committed` tokens actually emitted
        (accepted + bonus tokens, after max_new/eos caps)."""
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_committed += committed
        self.spec_slot_steps += n_active

    def record_sparsity(self, per_layer: Dict[str, Dict[str, Any]]) -> None:
        for label, rec in per_layer.items():
            self.sparsity.setdefault(label, []).append(
                {k: float(v) for k, v in rec.items()})

    def summary(self) -> Dict[str, Any]:
        ttfts = [t.ttft_s for t in self.requests.values()
                 if t.ttft_s is not None]
        n_steps = len(self.step_s)
        p50_s = _pct(self.step_s, 50)
        out = {
            "requests_finished": sum(
                1 for t in self.requests.values()
                if t.finish_wall is not None),
            "decode_tokens": self.decode_tokens,
            "tokens_per_s": (self.decode_tokens / self.decode_wall
                             if self.decode_wall > 0 else 0.0),
            # steady-state throughput from the MEDIAN step latency: immune
            # to single-step scheduler/host stalls (a 40 ms hiccup in a
            # 50 ms run halves the mean-based number while changing
            # nothing about the serving path) — the robust quantity
            # benchmarks gate on when run on shared machines
            "tokens_per_s_p50": (self.decode_tokens / n_steps / p50_s
                                 if n_steps and p50_s > 0 else 0.0),
            "step_ms_p50": _pct(self.step_s, 50) * 1e3,
            "step_ms_p99": _pct(self.step_s, 99) * 1e3,
            "ttft_ms_p50": _pct(ttfts, 50) * 1e3,
            "ttft_ms_p99": _pct(ttfts, 99) * 1e3,
            "prefill_ms_p50": _pct(self.prefill_s, 50) * 1e3,
            "wall_s": time.perf_counter() - self._t0,
        }
        if self.spec_steps:
            out["speculative"] = {
                "steps": self.spec_steps,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
                # committed tokens per slot per verify step — the
                # amortization win (1.0 == plain decode; up to K + 1)
                "tokens_per_step": (self.spec_committed
                                    / max(self.spec_slot_steps, 1)),
            }
        if self.sparsity:
            out["psum_sparsity"] = {
                label: {
                    "gate_off": float(np.mean([r["gate_off"] for r in recs])),
                    "exact_zero": float(np.mean(
                        [r["exact_zero"] for r in recs])),
                    "segments": int(recs[0].get("segments", 0)),
                    "samples": len(recs),
                }
                for label, recs in sorted(self.sparsity.items())
            }
        return out
