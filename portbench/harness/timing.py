"""The measured window: a closed loop of the cell's unit of work.

Units are called back to back from the host for `seconds` of host time;
the window ends when the device has finished the last one (a
synchronize), so its length covers all the work enqueued in it. On a
CUDA device an event is recorded after each unit with no synchronize,
and each unit's time is the gap between consecutive events (the first
from an event recorded at the window's start).
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List, NamedTuple

import torch


class Window(NamedTuple):
    units: int             # work completed (tokens, images)
    calls: int             # unit calls (steps, batches, prefill calls)
    seconds: float         # host clock, start to the final synchronize
    enqueue_s: List[float]  # host time of each call, no synchronize
    call_ms: List[float]   # each call's time between end-of-call events


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call: Callable[[int], int], seconds: float,
                device: torch.device, first: int = 0) -> Window:
    """call(i) enqueues unit i and returns the work it completes."""
    cuda = device.type == "cuda"
    sync(device)
    marks = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    deadline, host_marks = t0 + seconds, [t0]
    enqueue, units, i = [], 0, first
    while True:
        a = time.perf_counter()
        units += call(i)
        b = time.perf_counter()
        enqueue.append(b - a)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            host_marks.append(b)
        i += 1
        if b >= deadline:
            break
    sync(device)
    t1 = time.perf_counter()
    if cuda:
        prev, call_ms = start, []
        for ev in marks:
            call_ms.append(prev.elapsed_time(ev))
            prev = ev
    else:
        call_ms = [(y - x) * 1e3 for x, y in zip(host_marks, host_marks[1:])]
    return Window(units, i - first, t1 - t0, enqueue, call_ms)


def p95(values: List[float]) -> float:
    """The 95th percentile (Python's quantiles, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]
