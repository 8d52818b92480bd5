"""Runs of one cell, one process each, one after another, and the spread
of each metric: the benchmark's command as a check runs it.

    python3 portbench/tools/sets.py --workload <cell> --seconds 20 \
        --seeds 11 12 13 [--trace 0] [--out sets.jsonl]

Each run's last stdout line (the result) and its seconds are appended to
--out; the summary gives each metric's median and its spread, the
distance between the first and third quartiles (statistics.quantiles,
n=4) as a share of the median.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values):
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    for seed in args.seeds:
        cmd = [sys.executable, os.path.join(_CHECKOUT, "portbench", "run.py"),
               "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=_CHECKOUT, capture_output=True,
                           text=True, timeout=1500)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": p.returncode, "wall_s": wall}
        try:
            rec["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            rec["stderr"] = p.stderr[-3000:]
            rec["stdout"] = p.stdout[-1000:]
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    ok = [r["result"] for r in results if "result" in r]
    summary = {}
    for name in (ok[0]["metrics"] if ok else {}):
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        summary[name] = {"median": statistics.median(vals),
                         "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"summary": args.workload, "metrics": summary,
                      "correct": [r["correct"] for r in ok]}), flush=True)


if __name__ == "__main__":
    main()
