"""CADC inside an LM: train a small GQA transformer with every weight
matmul running the paper's crossbar-partitioned dendritic form.

    python -m repro_torch.launch.lm_cadc_train [--steps 200] [--device cpu]

Twin of examples/lm_cadc_train.py: the smoke config of --arch through the
LM train CLI (launch/train.py) with linear_impl='cadc' at crossbar 64,
batch 8, seq 128; fails unless the loss decreases. On a CUDA device every
CADC linear trains through K1g and K2.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"=== {args.arch} (smoke config) + CADC, {args.steps} steps ===")
    out = train_cli.main([
        "--arch", args.arch, "--smoke", "--cadc", "--crossbar", "64",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--log-every", str(max(1, args.steps // 10)),
        "--device", args.device,
    ])
    losses = [h["loss"] for h in out["history"]]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"LM loss must decrease under CADC: {losses}")
    print("OK: CADC LM trains (loss decreased)")
    return out


if __name__ == "__main__":
    main()
