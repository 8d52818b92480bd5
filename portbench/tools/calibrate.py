"""Readings that correctness limits are set from (not run by the
benchmark's own runs): for each seed, the program's numbers against the
reference (the lower reading), the control's (the reference computed a
precision below the configuration's, in the program's place: each
driver's `controls()`), and where the cell trains each fault's, read in
the reference put in the program's place (`faults()`), with `look()`.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 1] [--out calibrate.jsonl]

Each seed runs as a run does: set-up, a short window at the cell's own
load, the program's state freed, the check. One process, seed after
seed; each seed's line is printed and appended to --out.
"""
import argparse
import json
import os
import sys
import time

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(_CHECKOUT, "src"), _CHECKOUT]

import torch  # noqa: E402

from portbench.harness import registry, spans, timing  # noqa: E402


def readings(bench, cell: str, seed: int, device,
             seconds: float = 1.0) -> dict:
    spec = bench.cell(cell)
    config, traffic = bench.config(spec["config"]), bench.traffic(
        spec["traffic"])
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    work = bench.driver(traffic["driver"]).Cell(config, traffic, seed,
                                                device, spans.Spans())
    timing.closed_loop(work.call, seconds, device, first=work.first_call)
    work.release()
    out = {"cell": cell, "seed": seed, "program": work.check()}
    out.update(work.controls())
    if hasattr(work, "faults"):
        out.update(work.faults())
    if hasattr(work, "look"):
        out["look"] = work.look()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = registry.Bench()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(bench, args.workload, seed, device, args.seconds)
        r["s"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
