#!/usr/bin/env python3
"""What K2 over matrices costs under each of its plans, on one card.

    python3 tools/profile_k2_matrix.py [--set plans|diag] [--out PATH]

--set plans (the default): at each K2 matrix shape of the train paths —
ResNet-18's and VGG-16's stem (im2col patches: M 131072, D 27, N 64),
ResNet-18's fc, the SNN's conv1 (D 18, N 32, sublinear's fp32 gate),
LeNet-5's c1 and c2 (D 25 and 150) and its FC layers, crossbar 64, relu's
packed gate unless said — it times, in one process, every plan
`bwd_plans` lists (the planner's first):

  both      dx and dw together (`cadc_segmented_bwd_cuda` under the plan);
  dx, dw    each alone under the plan's tiles and split;

beside the vConv yardsticks on the same operands: the torch.matmul dx + dw
pair and torch.matmul's dw alone (TF32 off), and the bounds of both and of
dw alone (each input read once, each output written once, at 3.35 TB/s or
67 fp32 TFLOP/s, whichever is longer).

--set diag: where dw's time goes at the three split shapes (the stem, the
SNN's conv1, LeNet-5's c1). It builds edited copies of csrc/cadc_bwd.cu
into build/k2_variants/ — the shipped source, one without dw's
multiply-adds, one without its split sum (the last block's addition of
the partials) — and times each one's dx and dw under the planner's plan,
then dw of the shipped and the no-split-sum copies at each dw tile 32 x 16
/ 32 x 32 / 32 x 64 and 16, 33, 66 or 132 splits.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose inputs
rotate over copies holding 3x the L2. Prints one line a plan or copy and,
last, the card's name and power limit; --out writes the record as JSON.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

# (name, M, D, N, fn, steps' count, whether the step wants dx)
SHAPES = [("resnet18.stem / vgg16.stem", 131072, 27, 64, "relu", 1, False),
          ("resnet18.fc", 128, 512, 10, "relu", 1, True),
          ("snn.conv1 (a time step)", 32768, 18, 32, "sublinear", 8, False),
          ("lenet5.c1", 50176, 25, 6, "relu", 1, False),
          ("lenet5.c2", 6400, 150, 16, "relu", 1, True),
          ("lenet5.f1", 64, 448, 120, "relu", 1, True),
          ("lenet5.f3", 64, 128, 10, "relu", 1, True)]
XBAR = 64
# --set diag: the split shapes, and the edits of its copies (source text ->
# replacement, each found exactly once)
DIAG_SHAPES = [s for s in SHAPES if s[0].split(".")[-1].startswith(
    ("stem", "conv1", "c1"))]
DIAG_EDITS = {
    "shipped": [],
    "no dw multiply-adds": [(
        "    for (int i = 0; i < C::kMK / C::kG; ++i) {",
        "    for (int i = 0; i < (p.M < 0 ? C::kMK / C::kG : 0); ++i) {")],
    "no dw split sum": [("  if (split) add_splits",
                         "  if (false) add_splits")],
}


def _case(cs, cm, dendritic, gen, dev, m, d, n, fn):
    """w, the gate, the mode and a rotation of (g, x) operand copies."""
    mode = cm.gate_mode("auto", fn)
    w = torch.randn(d, n, generator=gen, device=dev) / math.sqrt(d)
    x0 = torch.randn(m, d, generator=gen, device=dev)
    p = torch.stack([x0[:, i:i + XBAR] @ w[i:i + XBAR]
                     for i in range(0, d, XBAR)])
    gate = cm._gate_of(p, dendritic.grad(fn), mode, fn)

    def make():
        return (torch.randn(m, n, generator=gen, device=dev),
                torch.randn(m, d, generator=gen, device=dev))

    first = make()
    ops = [first] + cs.rotation(make, sum(t.numel() * 4 for t in first))[1:]
    return w, gate, mode, ops


def _variant(cm, tag, edits):
    """A ctypes library of csrc/cadc_bwd.cu with `edits` made, built into
    build/k2_variants/, bound as kernels/cadc_matmul.py binds the shipped
    one."""
    from repro_torch.kernels import _build

    out = os.path.join(REPO, "build", "k2_variants")
    os.makedirs(out, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out)
    src = (_build.CSRC / "cadc_bwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            sys.exit(f"profile_k2_matrix: edit {old!r} not found once")
        src = src.replace(old, new)
    stem = os.path.join(out, tag.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          stem + ".so", stem + ".cu"], capture_output=True,
                         text=True)
    if run.returncode:
        sys.exit(f"profile_k2_matrix: nvcc failed for {tag}:\n{run.stdout}"
                 f"{run.stderr}")
    lib = ctypes.CDLL(stem + ".so")
    lib.cadc_bwd_launch.argtypes = cm._bwd_lib().cadc_bwd_launch.argtypes
    lib.cadc_bwd_launch.restype = ctypes.c_int
    lib.cadc_bwd_error_string.argtypes = [ctypes.c_int]
    lib.cadc_bwd_error_string.restype = ctypes.c_char_p
    return lib


def diag(cs, cm, dendritic, gen, dev) -> list:
    rows = []
    shipped = cm._bwd_lib
    libs = {tag: _variant(cm, tag, e) for tag, e in DIAG_EDITS.items()}
    for name, m, d, n, fn, _, _ in DIAG_SHAPES:
        w, gate, mode, ops = _case(cs, cm, dendritic, gen, dev, m, d, n, fn)
        pick = itertools.cycle(ops).__next__
        reps = max(20, len(ops))
        kw = dict(crossbar_size=XBAR, fn=fn, mode=mode)
        row = {"shape": name, "m": m, "d": d, "n": n, "mode": mode,
               "copies": {}, "dw_tile_splits": {}}
        for tag, lib in libs.items():
            cm._bwd_lib = functools.lru_cache()(lambda lib=lib: lib)
            ms = {k: cs.device_ms(lambda a=a: cm.cadc_segmented_bwd_cuda(
                      *pick(), w, gate, need_dx=a[0], need_dw=a[1], **kw),
                      reps)
                  for k, a in (("dx", (True, False)), ("dw", (False, True)))}
            row["copies"][tag] = ms
            print(f"{name} M{m} D{d} N{n} {mode}, {tag}: dx {ms['dx']:.4f}, "
                  f"dw {ms['dw']:.4f}", flush=True)
            if tag == "no dw multiply-adds":
                continue
            scan = row["dw_tile_splits"].setdefault(tag, {})
            for tile in ((32, 16), (32, 32), (32, 64)):
                if tile[1] > 16 and 2 * n <= tile[1]:
                    continue
                for sp in (16, 33, 66, 132):
                    q = cm.plan_bwd(m, n, d, XBAR, mode, False, True,
                                    _force=((128, 32), tile, sp))
                    label = f"{tile[0]}x{tile[1]} x {q.dw_splits}"
                    scan[label] = cs.device_ms(
                        lambda q=q: cm.cadc_segmented_bwd_cuda(
                            *pick(), w, gate, need_dx=False, plan=q, **kw),
                        reps)
            print(f"{name}, {tag}, dw by tile x splits: " + ", ".join(
                f"{k} {v:.4f}" for k, v in scan.items()), flush=True)
        cm._bwd_lib = shipped
        rows.append(row)
        del ops, gate
    return rows


def main() -> None:
    import chip_smoke as cs
    from repro_torch.core import dendritic
    from repro_torch.kernels import cadc_matmul as cm

    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="plans", choices=("plans", "diag"))
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_k2_matrix: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    rows = (diag(cs, cm, dendritic, gen, dev) if args.set == "diag"
            else plans(cs, cm, dendritic, gen, dev))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "xbar": XBAR, "set": args.set,
                       "shapes": rows}, f, indent=1)
    print(card)


def plans(cs, cm, dendritic, gen, dev) -> list:
    rows = []
    for name, m, d, n, fn, count, step_dx in SHAPES:
        w, gate, mode, ops = _case(cs, cm, dendritic, gen, dev, m, d, n, fn)
        kw = dict(crossbar_size=XBAR, fn=fn, mode=mode)
        pick = itertools.cycle(ops).__next__
        reps = max(20, len(ops))
        gate_b = gate.numel() * gate.element_size()
        flops = 2 * m * d * n
        bound_both, _ = cs.bound_ms(4 * (m * n + 2 * m * d + 2 * d * n)
                                    + gate_b, 2 * flops, torch.float32)
        bound_dw, _ = cs.bound_ms(4 * (m * n + m * d + d * n) + gate_b,
                                  flops, torch.float32)
        lib = {"matmul_pair": cs.device_ms(
                   lambda: (lambda g, x: (torch.matmul(g, w.T),
                                          torch.matmul(x.T, g)))(*pick()),
                   reps),
               "matmul_dw": cs.device_ms(
                   lambda: (lambda g, x: torch.matmul(x.T, g))(*pick()),
                   reps)}
        plans = cm.bwd_plans(m, n, d, XBAR, mode)
        timed = []
        for plan in plans:
            force = (plan.dx_tile, plan.dw_tile, plan.dw_splits)

            def run(need_dx, need_dw, force=force):
                q = cm.plan_bwd(m, n, d, XBAR, mode, need_dx, need_dw,
                                _force=force)
                g, x = pick()
                return cm.cadc_segmented_bwd_cuda(
                    g, x, w, gate, need_dx=need_dx, need_dw=need_dw, plan=q,
                    **kw)

            ms = {label: cs.device_ms(lambda a=a: run(*a), reps)
                  for label, a in (("both", (True, True)),
                                   ("dx", (True, False)),
                                   ("dw", (False, True)))}
            label = (f"dx {plan.dx_tile[0]}x{plan.dx_tile[1]}, dw "
                     f"{plan.dw_tile[0]}x{plan.dw_tile[1]} x "
                     f"{plan.dw_splits} splits")
            timed.append({"plan": label, "planner": plan == plans[0],
                          "ms": ms})
            print(f"{name} M{m} D{d} N{n} {mode}: {label}"
                  f"{' (planner)' if plan == plans[0] else ''}: both "
                  f"{ms['both']:.4f}, dx {ms['dx']:.4f}, dw {ms['dw']:.4f}",
                  flush=True)
        print(f"{name}: torch.matmul pair {lib['matmul_pair']:.4f}, "
              f"torch.matmul dw {lib['matmul_dw']:.4f}; bound both "
              f"{bound_both:.4f}, dw alone {bound_dw:.4f}; the step wants "
              f"{'dx + dw' if step_dx else 'dw only'}, x{count} a step",
              flush=True)
        rows.append({"shape": name, "m": m, "d": d, "n": n, "mode": mode,
                     "per_step": count, "step_dx": step_dx,
                     "bound_both_ms": bound_both, "bound_dw_ms": bound_dw,
                     "library_ms": lib, "plans": timed})
        del ops, gate
    return rows


if __name__ == "__main__":
    main()
