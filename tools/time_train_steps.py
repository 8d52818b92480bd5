#!/usr/bin/env python3
"""The ResNet-18 CADC train step and the VGG-16 QAT step of one tree, alone.

    python3 tools/time_train_steps.py [TREE] [--tag NAME]

Times the two training steps of `chip_smoke.py` with its own functions
(`time_resnet_step`: width 64, batch 128, CADC relu at crossbar 64, AdamW;
`time_vgg`: published width, batch 128, 4/2/4b QAT, from seeded random
parameters) on the checkout at TREE (default: this one), building its
kernels into TREE's build directory first. Prints one JSON line: the step
p50s and every step's ms (CUDA events around each step), the profiler's
device-busy ms, "other (PyTorch)" ms and launches per step, and peak
memory. To compare two commits, unpack the other with `git archive` into
a directory git ignores and run both trees in one command on one card, in
turns (parent, change, change, parent): the host clock spreads between
calls. Needs a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--tag", default=None, help="name of the tree's line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_train_steps: needs a GPU")
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.models.cnn import vgg16

    dev = torch.device("cuda")
    rep = {}
    with contextlib.redirect_stdout(io.StringIO()):  # keep one line
        cs.build_kernels(rep)
        cs.time_resnet_step(dev, rep)
        params, state = vgg16.init(torch.Generator(device=dev).manual_seed(0),
                                   num_classes=100, device=dev)
        cs.time_vgg(dev, (params, state), rep)
    r, v = rep["resnet18_step"], rep["vgg16_timing"]
    other = r["device_ms_per_step_by_kernel"]["other (PyTorch)"]
    print(json.dumps({
        "tree": args.tag or root, "device": torch.cuda.get_device_name(0),
        "resnet18_step_ms_p50": r["step_ms_p50"],
        "resnet18_step_ms": r["step_ms_all"],
        "resnet18_busy_ms": r["device_busy_ms_per_step"],
        "resnet18_other_ms": other["ms"],
        "resnet18_other_launches": other["calls"],
        "resnet18_peak_bytes": r["peak_memory_bytes"],
        "vgg16_qat_step_ms_p50": v["qat_step_ms_p50"],
        "vgg16_qat_step_ms": v["qat_step_ms_all"],
        "vgg16_qat_peak_bytes": v["qat_peak_memory_bytes"]}), flush=True)


if __name__ == "__main__":
    main()
