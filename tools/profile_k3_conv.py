#!/usr/bin/env python3
"""What K3's plan, tiles and gate cost, on one card.

    python3 tools/profile_k3_conv.py [--out PATH]

At each conv shape of a ResNet-18 CADC train step (width 64, batch 128,
crossbar 64, relu) it times, in one process:

  planned       K3 as shipped (`cadc_conv2d_cuda`: `plan_conv`'s plan) with
                the packed gate the train step saves;
  no_gate       the same plan without a gate (the eval forward);
  one_segment   the same plan without a gate at crossbar = D: one segment,
                so no segment ends (timing only: another function);
  gather, tap128x64, tap64x64
                each plan the shape admits, forced, packed gate (gather is
                K3's only kernel before the tap kernel);
  F.conv2d      cuDNN's fp32 conv of the NCHW view (TF32 off): the vConv
                yardstick.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose inputs
rotate over copies holding 3x the L2. Prints one line a shape, the sums
over a train step (all 20 convs, and the 19 that the tap kernel takes)
and, last, the card's name and power limit; --out writes the record as
JSON. Needs a GPU.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))


def main() -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import cadc_conv as cc

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_k3_conv: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    xbar = 64
    shapes = {}
    for c in cs.conv_layers("resnet18"):
        shapes[c[1:]] = shapes.get(c[1:], 0) + 1
    rows, tot = [], {}
    for (b, h, cin, k, cout, stride, padding), count in shapes.items():
        st = (stride, stride)
        oh = cs.conv_out_hw(h, k, stride, padding)
        m, d = b * oh * oh, k * k * cin
        w = torch.randn(k, k, cin, cout, generator=gen, device=dev) / 8
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def make():
            return (torch.randn(b, h, h, cin, generator=gen, device=dev),)

        first = make()
        xs = [first] + cs.rotation(make, first[0].numel() * 4)[1:]
        pick = itertools.cycle(xs).__next__
        reps = max(20, len(xs))
        plan = cc.plan_conv(m, cout, cin, xbar)
        kw = dict(fn="relu", stride=st, padding=padding)
        calls = {
            "planned": lambda: cc.cadc_conv2d_cuda(
                pick()[0], w, crossbar_size=xbar, mode="packed", **kw),
            "no_gate": lambda: cc.cadc_conv2d_cuda(
                pick()[0], w, crossbar_size=xbar, mode="none", **kw),
            "one_segment": lambda: cc.cadc_conv2d_cuda(
                pick()[0], w, crossbar_size=d, mode="none", **kw),
        }
        for p in cc.conv_plans(m, cout, cin, xbar):
            name = p.kernel + ("" if p.kernel == "gather"
                               else f"{p.tile[0]}x{p.tile[1]}")
            calls[name] = lambda p=p: cc._conv_launch(
                "k3", pick()[0], w, xbar, "relu", st, padding, "packed",
                None, plan=p)
        cpad = 0 if padding == "VALID" else k // 2
        calls["F.conv2d"] = lambda: F.conv2d(
            pick()[0].permute(0, 3, 1, 2), w_oihw, stride=st, padding=cpad)
        ms = {name: cs.device_ms(fn, reps) for name, fn in calls.items()}
        flops, k3_bytes, *_ = cs._conv_ops_bytes(b, h, cin, k, cout,
                                                 stride, padding, xbar)
        bound, _ = cs.bound_ms(k3_bytes, flops, torch.float32)
        row = {"shape": [b, h, cin, k, cout, stride, padding],
               "per_step": count, "plan": f"{plan.kernel} {plan.tile}",
               "bound_ms": bound, "ms": ms}
        rows.append(row)
        for name, v in ms.items():
            for key in (("all", "tap") if plan.kernel == "tap" else ("all",)):
                t = tot.setdefault(key, {}).setdefault(name, [0.0, 0])
                t[0] += count * v
                t[1] += count
        print(f"B{b} H{h} C{cin} K{k} O{cout} s{stride} x{count} "
              f"({row['plan']}, bound {bound:.4f}): " + ", ".join(
                  f"{n} {v:.4f}" for n, v in ms.items()), flush=True)
        del xs
    n_convs = sum(shapes.values())
    for key, what in (("all", f"all {n_convs} convs"),
                      ("tap", "the convs the planner gives the tap kernel")):
        print(f"per train step over {what} (ms; convs covered): "
              + ", ".join(f"{n} {v:.3f} ({c})"
                          for n, (v, c) in tot[key].items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "xbar": xbar, "shapes": rows,
                       "per_step": tot}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
