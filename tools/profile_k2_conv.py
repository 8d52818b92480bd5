#!/usr/bin/env python3
"""What the tap conv backward's plans and gate cost, on one card.

    python3 tools/profile_k2_conv.py [--out PATH]

At each conv shape of a ResNet-18 CADC train step (width 64, batch 128,
crossbar 64, relu) that `plan_conv_bwd` gives the tap kernels (19 of the
20: not the stem), it times, in one process:

  planned         dx and dw together as shipped (`cadc_conv2d_bwd_cuda`
                  under the planner's plan) with the packed gate K3 saves;
  dx, dw          each alone under the planned plan, packed gate;
  dx_no_gate, dw_no_gate
                  the same without a gate (vConv: identity);
  dx <tile>       dx under each other tile the shape admits, forced;
  dw unsplit, dw 2x splits
                  dw with M unsplit and split twice as often as planned;
  old_route       im2col + K2 over the patches + `_col2im` (the route the
                  tap kernels replace);
  cudnn_dgrad, cudnn_wgrad
                  cuDNN's fp32 convolution_backward of the NCHW views with
                  the input grad alone and the weight grad alone (TF32
                  off): the vConv yardsticks of dx and dw.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose inputs
rotate over copies holding 3x the L2. Prints one line a shape, the sums over
a train step (each sum says how many convs it covers) and, last, the card's
name and power limit; --out writes the record as JSON. Needs a GPU.
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
    import chip_smoke as cs
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_k2_conv: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    xbar = 64
    shapes = {}
    for c in cs.conv_layers("resnet18"):
        shapes[c[1:]] = shapes.get(c[1:], 0) + 1
    rows, tot = [], {}
    for (b, h, cin, k, cout, stride, padding), count in shapes.items():
        st = (stride, stride)
        x_shape, w_shape = (b, h, h, cin), (k, k, cin, cout)
        plan = cc.plan_conv_bwd(x_shape, w_shape, st, padding, xbar,
                                "packed")
        if plan.kernel != "tap":
            continue
        oh = cs.conv_out_hw(h, k, stride, padding)
        w = torch.randn(*w_shape, generator=gen, device=dev) / 8
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(crossbar_size=xbar, stride=st, padding=padding)
        _, gate = cc.cadc_conv2d_cuda(
            torch.randn(*x_shape, generator=gen, device=dev), w, fn="relu",
            mode="packed", **kw)

        def make():
            return (torch.randn(b, oh, oh, cout, generator=gen, device=dev),
                    torch.randn(*x_shape, generator=gen, device=dev))

        first = make()
        ops = [first] + cs.rotation(make, sum(t.numel() * 4
                                              for t in first))[1:]
        pick = itertools.cycle(ops).__next__
        reps = max(20, len(ops))

        def tap(need_dx=True, need_dw=True, gated=True, p=None):
            g, x = pick()
            return cc.cadc_conv2d_bwd_cuda(
                g, x, w, gate if gated else None,
                fn="relu" if gated else "identity",
                mode="packed" if gated else "none", need_dx=need_dx,
                need_dw=need_dw, plan=p, **kw)

        def cudnn(mask):
            g, x = pick()
            return torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None,
                list(st), [k // 2] * 2, [1, 1], False, [0, 0], 1, mask)

        calls = {
            "planned": lambda: tap(),
            "dx": lambda: tap(need_dw=False),
            "dw": lambda: tap(need_dx=False),
            "dx_no_gate": lambda: tap(need_dw=False, gated=False),
            "dw_no_gate": lambda: tap(need_dx=False, gated=False),
        }
        for p in cc.conv_bwd_plans(x_shape, w_shape, st, padding, xbar,
                                   "packed"):
            if p.dw_splits == plan.dw_splits and p.dx_tile != plan.dx_tile:
                calls[f"dx {p.dx_tile[0]}x{p.dx_tile[1]}"] = (
                    lambda p=p: tap(need_dw=False, p=p))
            elif p.dx_tile == plan.dx_tile and p.dw_splits != plan.dw_splits:
                label = ("dw unsplit" if p.dw_splits == 1
                         else "dw 2x splits")
                calls[label] = lambda p=p: tap(need_dx=False, p=p)
        calls["old_route"] = lambda: cc._bwd_patches(
            cm.cadc_segmented_bwd_cuda, *pick(), w, gate, fn="relu",
            mode="packed", **kw)
        calls["cudnn_dgrad"] = lambda: cudnn([True, False, False])
        calls["cudnn_wgrad"] = lambda: cudnn([False, True, False])
        ms = {name: cs.device_ms(fn, reps) for name, fn in calls.items()}
        flops, *_, tap_bytes = cs._conv_ops_bytes(b, h, cin, k, cout, stride,
                                                  padding, xbar)
        bound, _ = cs.bound_ms(tap_bytes, 2 * flops, torch.float32)
        row = {"shape": [b, h, cin, k, cout, stride, padding],
               "per_step": count, "dx_tile": plan.dx_tile,
               "dw_splits": plan.dw_splits, "bound_ms": bound, "ms": ms}
        rows.append(row)
        for name, v in ms.items():
            t = tot.setdefault(name, [0.0, 0])
            t[0] += count * v
            t[1] += count
        print(f"B{b} H{h} C{cin} K{k} O{cout} s{stride} x{count} (dx "
              f"{plan.dx_tile}, dw {plan.dw_splits} splits, bound "
              f"{bound:.4f}): " + ", ".join(f"{n} {v:.4f}"
                                            for n, v in ms.items()),
              flush=True)
        del ops, gate
    print("per train step over the convs the planner gives the tap kernels "
          "(ms; convs covered): " + ", ".join(
              f"{n} {v:.3f} ({c})" for n, (v, c) in tot.items()), flush=True)
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
