"""One run of one cell: set-up, the measured window, the traced windows
(`--trace 1`), the correctness check, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, then `setup_parts` (what `setup_s` is made of: the
process's imports, the device's start, the kernels' build or load, the
cell's set-up; `build_s` is the first run's compile in a checkout, which
later runs find done), and last `checks`: each number compared with its
limit. The same numbers are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.harness import guard, registry, spans as spans_lib, timing
from portbench.harness import trace as trace_lib


class Run:
    """What a metric reader reads: the cell, its driver's Cell, the
    measured window, the set-up time, and with `--trace 1` the traces."""

    def __init__(self, cell: str, spec: dict, work, window: timing.Window,
                 setup_s: float):
        self.cell, self.spec, self.work = cell, spec, work
        self.window, self.setup_s = window, setup_s
        self.busy_s: Optional[float] = None
        self.trace_window_s: Optional[float] = None
        self.device_ops: List = []
        self.by_label: Dict[str, float] = {}
        self.gaps: List = []
        self.layer_calls: List[int] = []

    def label_s(self, labels) -> float:
        """Device seconds a unit under any of `labels` (layer window)."""
        return sum(self.by_label.get(l, 0.0) for l in labels)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _traced_calls(window: timing.Window) -> int:
    """Units a traced window takes: about 3 s of the measured rate, 1 to
    10 units."""
    per = window.seconds / max(window.calls, 1)
    return max(1, min(10, int(3.0 / per)))


def build_kernels(device: torch.device) -> float:
    """Builds the port's kernel libraries that the checkout lacks (only a
    checkout's first run compiles: the libraries stay under its build/
    folder) and returns the seconds it took. Nothing to build off the
    card."""
    if device.type != "cuda":
        return 0.0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0


def run_cell(args, *, t_start: float, device: torch.device,
             bench: Optional[registry.Bench] = None,
             config_over: Optional[dict] = None,
             traffic_over: Optional[dict] = None,
             fault: Optional[str] = None,
             parts: Optional[Dict[str, float]] = None) -> dict:
    """One run; returns the result (printing is the caller's). `parts`:
    the set-up's phases so far (seconds by name). The overrides and
    `fault` are for the tests (a small cell on the CPU, a planted fault
    in the timed path)."""
    parts = dict(parts or {})
    bench = bench or registry.Bench()
    spec = bench.cell(args.workload)
    config = {**bench.config(spec["config"]), **(config_over or {})}
    traffic = {**bench.traffic(spec["traffic"]), **(traffic_over or {})}
    limits = bench.limits(args.workload)["limits"]
    driver = bench.driver(traffic["driver"])
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    spans = spans_lib.Spans()

    parts["build_s"] = build_kernels(device)
    t_cell = time.perf_counter()
    work = driver.Cell(config, traffic, args.seed, device, spans,
                       fault=fault)
    guard.check("after set-up")
    timing.sync(device)
    t_window = time.perf_counter()
    parts["cell_s"] = t_window - t_cell
    setup_s = t_window - t_start
    window = timing.closed_loop(work.call, args.seconds, device,
                                first=work.first_call)
    guard.check("after the window")
    run = Run(args.workload, spec, work, window, setup_s)

    breakdown = None
    if args.trace:
        readers = [bench.metric(m["name"]) for m in
                   bench.metrics_for(args.workload, "per_layer")]
        n = _traced_calls(window)
        first = work.first_call + window.calls

        def traced(i):
            with spans.range(spans_lib.STEP):
                work.call(i)

        run.busy_s, run.trace_window_s, run.device_ops = \
            trace_lib.device_window(work.call, n, first)
        first += n * trace_lib.TRIES
        with spans.install():
            labels = trace_lib.labels_of(readers, [spans_lib.STEP,
                                                       spans_lib.LAYER])
            run.by_label, run.gaps = trace_lib.layer_window(
                traced, n, first, labels)
        run.layer_calls = list(range(first, first + n))
        breakdown = {"device_ops": [list(x) for x in run.device_ops],
                     "idle_gaps": [list(x) for x in run.gaps]}

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    t_trace = time.perf_counter()
    work.release()
    numbers = work.check()
    guard.check("at the end")
    t_check = time.perf_counter()
    print(f"portbench: set-up {setup_s:.1f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"), window {window.seconds:.1f} "
          f"s ({window.calls} units), traces "
          f"{t_trace - t_start - setup_s - window.seconds:.1f} s, check "
          f"{t_check - t_trace:.1f} s", file=sys.stderr, flush=True)

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_for(args.workload, section):
        value = bench.metric(m["name"]).read(run)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"{m['name']}: no reading in "
                                   f"{args.workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if args.trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.trace_window_s
    result = {"correct": correct, "attempted": window.calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts"] = parts
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None, *, t_start: float) -> int:
    parts = {"imports_s": time.perf_counter() - t_start}
    args = parse(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    bench = registry.Bench()
    chips = bench.cell(args.workload).get("chips", 1)
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.ones(1, device=device).add_(1)
    timing.sync(device)
    parts["device_s"] = time.perf_counter() - t0
    try:
        result = run_cell(args, t_start=t_start, device=device, bench=bench,
                          parts=parts)
    except guard.JaxLoaded as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    emit(result)
    return 0
