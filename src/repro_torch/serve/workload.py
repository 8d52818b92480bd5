"""Synthetic serving workloads: Poisson-style arrival streams.

Arrivals are expressed in engine iterations (one iteration == one decode
step across the slots), which keeps workloads deterministic for tests and
benchmarks while still exercising the scheduler's real behavior: bursts,
queueing, slot exhaustion, eviction + reuse. Wall-clock TTFT is measured
by the engine against the iteration at which each request became visible.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def poisson_workload(
    *,
    n_requests: int,
    rate: float,
    vocab_size: int,
    prompt_len: Tuple[int, int] = (4, 16),
    max_new: Tuple[int, int] = (4, 16),
    seed: int = 0,
) -> List[Tuple[int, np.ndarray, int]]:
    """[(arrival_step, prompt int32 [P], max_new_tokens)] sorted by arrival.

    `rate` is the expected number of arrivals per decode step; inter-
    arrival gaps are exponential (Poisson process discretized onto the
    step clock)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        p = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
        g = int(rng.randint(max_new[0], max_new[1] + 1))
        prompt = rng.randint(0, vocab_size, size=(p,)).astype(np.int32)
        out.append((int(t), prompt, g))
    return out
