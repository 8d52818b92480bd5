"""Device traces: busy time, idle share, and device time by layer.

Two windows of a few units each, after the measured window:

* device window (CUDA activity alone, so the host runs at its own
  speed): `busy_s` is the union of the intervals in which an operation
  (kernel, copy, set) ran on the device; `window_s` is the window's host
  clock; the device operations that took most time;
* layer window (CPU and CUDA activity, the benchmark's ranges on): each
  device operation is attributed to the innermost named range open
  around the runtime call that launched it (the benchmark's
  `portbench.*` ranges, or an autograd node such as
  `CadcMatmulFnBackward`), and each idle gap to what the host was doing
  when it ended: the range and the host op that launched the operation
  after it. The CPU trace slows the host, so its
  gaps are longer than in the measured window; its device times are not.

Each window opens with 64 short marker kernels (`spin_kernel`, the
profiler can drop a window's first records) and a synchronize; only
operations after the last marker count.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

MARKER = "spin_kernel"
MARKERS = 64
TRIES = 3


class Ev(NamedTuple):
    name: str
    on_device: bool
    start: int        # ns
    end: int          # ns
    thread: int
    corr: int         # correlation id
    linked: int       # device events: the launching host op's id


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def kineto_events(prof) -> List[Ev]:
    """The trace's events as Ev, user annotations mirrored onto the device
    dropped (they are ranges, not operations)."""
    from torch.autograd import DeviceType

    out, host_names = [], set()
    raw = list(prof.profiler.kineto_results.events())
    for e in raw:
        if e.device_type() == DeviceType.CPU:
            host_names.add(e.name())
    for e in raw:
        dev = e.device_type() == DeviceType.CUDA
        if dev and (getattr(e, "is_user_annotation", lambda: False)()
                    or e.name() in host_names):
            continue
        start = _ns(e, "start")
        out.append(Ev(e.name(), dev, start, start + _ns(e, "duration"),
                      e.start_thread_id(), e.correlation_id(),
                      e.linked_correlation_id()))
    return out


def union_s(intervals: Iterable[Tuple[int, int]]) -> Tuple[float, list]:
    """(total seconds covered, the merged intervals) of [start, end) ns."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e9, merged


def _after_markers(events: Sequence[Ev]) -> Tuple[int, List[Ev]]:
    marks = [e.end for e in events if e.on_device and MARKER in e.name]
    t0 = max(marks) if marks else 0
    return t0, [e for e in events if e.on_device and e.start >= t0
                and MARKER not in e.name]


def host_tree(events: Sequence[Ev]) -> Tuple[List[Ev], List[int]]:
    """Host ops with each one's parent index (-1: none), by nesting of
    their intervals on their thread."""
    host = sorted((e for e in events if not e.on_device),
                  key=lambda e: (e.thread, e.start, -e.end))
    parent, stack, thread = [], [], None
    for i, e in enumerate(host):
        if e.thread != thread:
            stack, thread = [], e.thread
        while stack and host[stack[-1]].end <= e.start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return host, parent


def _is_api(e: Ev) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...): it shares its correlation id with the device
    operation it launched."""
    return e.name.startswith("cu")


def attribute(events: Sequence[Ev], labels: Sequence[str]
              ) -> Tuple[Dict[str, float], List[Tuple[str, float]]]:
    """(device seconds by the innermost label on each operation's host
    stack — "unlabelled" where none, "unlinked" where the operation names
    no host call —, idle seconds by host activity, largest first).

    An operation's host stack is that of the runtime call that launched
    it (same correlation id), so launches from outside PyTorch (the
    port's ctypes kernels) sit inside the ranges open around them; where
    no runtime call is traced, the torch op the operation is linked to."""
    host, parent = host_tree(events)
    api = {e.corr: i for i, e in enumerate(host) if _is_api(e)}
    ops = {e.corr: i for i, e in enumerate(host) if not _is_api(e)}
    _, dev = _after_markers(events)

    def chain(i: int):
        while i >= 0:
            yield host[i]
            i = parent[i]

    def label_of(i: int) -> str:
        for e in chain(i):
            for l in labels:
                if e.name == l or e.name.endswith(l):
                    return l
        return "unlabelled"

    def op_of(i: int) -> str:
        return next((e.name for e in chain(i) if not _is_api(e)),
                    host[i].name)

    by_label: Dict[str, float] = collections.defaultdict(float)
    dev = sorted(dev, key=lambda e: e.start)
    owner = []
    for e in dev:
        i = api.get(e.corr, -1)
        if i < 0 and e.linked:
            i = ops.get(e.linked, -1)
        owner.append(i)
        by_label[label_of(i) if i >= 0 else "unlinked"] += (
            (e.end - e.start) / 1e9)
    _, merged = union_s((e.start, e.end) for e in dev)
    starts = [e.start for e in dev]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (_, b), (a, _) in zip(merged, merged[1:]):
        i = owner[bisect.bisect_left(starts, a)]
        key = "unlinked" if i < 0 else f"{label_of(i)} / {op_of(i)}"
        gaps[key[:120]] += (a - b) / 1e9
    return dict(by_label), sorted(gaps.items(), key=lambda kv: -kv[1])[:10]


def top_ops(dev: Sequence[Ev], n: int = 10) -> List[Tuple[str, float]]:
    tot: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        tot[e.name[:120]] += (e.end - e.start) / 1e9
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _profile(run: Callable[[int], None], n: int, first: int,
             cpu: bool) -> Tuple[List[Ev], float]:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            run(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return kineto_events(prof), window


def device_window(run: Callable[[int], None], n: int, first: int
                  ) -> Tuple[float, float, List[Tuple[str, float]]]:
    """(busy s, window s, top device ops) over run(first .. first+n-1),
    device activity alone; retried where the trace shows no device time."""
    for _ in range(TRIES):
        events, window = _profile(run, n, first, cpu=False)
        first += n
        _, dev = _after_markers(events)
        busy, _ = union_s((e.start, e.end) for e in dev)
        if busy > 0:
            return busy, window, top_ops(dev)
    raise RuntimeError("profiler: no device time in the device window")


def layer_window(run: Callable[[int], None], n: int, first: int,
                 labels: Sequence[str]
                 ) -> Tuple[Dict[str, float], List[Tuple[str, float]]]:
    """(device seconds a unit by label, idle seconds by host activity)
    over run(first .. first+n-1), host and device activity."""
    for _ in range(TRIES):
        events, _ = _profile(run, n, first, cpu=True)
        first += n
        by_label, gaps = attribute(events, labels)
        if sum(by_label.values()) > 0:
            return {k: v / n for k, v in by_label.items()}, gaps
    raise RuntimeError("profiler: no device time in the layer window")


def labels_of(readers: Iterable, extra: Optional[Iterable[str]] = ()
              ) -> List[str]:
    """Every range a set of metric readers attributes time to."""
    out = list(extra or ())
    for r in readers:
        for l in getattr(r, "LABELS", ()):
            if l not in out:
                out.append(l)
    return out
