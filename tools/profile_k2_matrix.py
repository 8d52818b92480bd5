#!/usr/bin/env python3
"""What K2 over matrices costs under each of its plans, on one card.

    python3 tools/profile_k2_matrix.py [--set plans|diag|lm|gate] [--out PATH]
    python3 tools/profile_k2_matrix.py --fit RECORD

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

--set lm: K2 on bf16 operands (the LM train steps') at gemma3-1b's seven
linear shapes at a train micro's M = 2048 and at M = 512, crossbar 256,
relu's packed gate: every plan of the tensor-core route `bwd_plans` lists
(dx alone, dw alone, both), beside the CUDA-core route on fp32 copies
(the route before it; its time includes the copies), the plain version,
the torch.matmul dx + dw pair in bf16 (on the operands as they are) and
in fp32 (on fp32 operands, TF32 off), and the bounds at the bf16 and fp32
peaks.

--set gate: where the tensor-core route applies the gate, at w_gate (M
2048, D 1280, N 6912) under the planner's plan: the shipped source (in
shared memory, by the threads that copied g) against a copy built into
build/k2_variants/ that applies it to the fragments in registers
(GATE_EDITS), packed and byte gates, in turns shipped, copy, copy,
shipped; each copy's dx and dw first held bitwise to the shipped ones.

--fit RECORD (no GPU): the per-slice seconds of the tensor-core route's
model (kernels/cadc_matmul.py _MMA_BWD_SLICE_S) from a --set lm record:
for each dx tile and for dw, the median over the unsplit plans of the
time over (rounds of blocks x slices a block).

Every time is chip_smoke.device_ms: a CUDA graph of calls whose inputs
rotate over copies holding 3x the L2. Prints one line a plan or copy and,
last, the card's name and power limit; --out writes the record as JSON.
Needs a GPU but for --fit.
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
# --set lm: (name, M, D, N) at crossbar LM_XBAR
LM_XBAR = 256
LM_SHAPES = [(name, m, d, n) for m in (2048, 512) for name, d, n in (
    ("wq", 1280, 1024), ("wk", 1280, 256), ("wo", 1024, 1152),
    ("w_gate", 1280, 6912), ("w_down", 6912, 1152))]
# --set gate: the copy that applies the gate to g's fragments in
# registers (from the slots, once the slice's barrier has published them)
# instead of in shared memory: dw's B fragments (b[j][0]: g ⊙ f' rows 2q,
# 2q + 1 of the k16 step, column 8j + g of the warp's 32; b[j][1]: rows
# 2q + 8, 2q + 9) and dx's A fragments (a[h]: row g + 8h, columns 2q, 2q +
# 1; a[h + 2]: columns 2q + 8, 2q + 9)
_REG_GATE_B = """\
      const unsigned char* slot = bs + C::kBBytes;
      if constexpr (kDw && kGated) {
        // b[j][0]: g ⊙ f' rows (of M) 2q, 2q + 1, column 8j + g of the
        // warp's 32; b[j][1]: rows 2q + 8, 2q + 9
        if (p.gvec) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = kk * 16 + 2 * q + 8 * h;
            if constexpr (kKind == cadc::kGatePacked) {
              const uint32_t* wd = reinterpret_cast<const uint32_t*>(slot);
              const uint32_t w0 = wd[k * (C::kGCols / kPack) + wn];
              const uint32_t w1 = wd[(k + 1) * (C::kGCols / kPack) + wn];
#pragma unroll
              for (int j = 0; j < kNT; ++j)
                b[j][h] &= pair_mask(w0 >> (8 * j + g) & 1u,
                                     w1 >> (8 * j + g) & 1u);
            } else {
#pragma unroll
              for (int j = 0; j < kNT; ++j) {
                const int c = wn * 32 + 8 * j + g;
                b[j][h] &= pair_mask(slot[k * C::kGCols + c],
                                     slot[(k + 1) * C::kGCols + c]);
              }
            }
          }
        }
      }
"""
_REG_GATE_A = """\
        if constexpr (!kDw && kGated) {
          // a[h]: g ⊙ f' row g + 8h, columns (of N) 2q, 2q + 1 of the
          // k16 step; a[h + 2]: columns 2q + 8, 2q + 9
          if (p.gvec) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * (R / 2) + i * 16 + 8 * h + g;
              if constexpr (kKind == cadc::kGatePacked) {
                const uint32_t bits =
                    reinterpret_cast<const uint32_t*>(
                        slot)[r * (C::kGCols / kPack) + kk / 2] >>
                    (16 * (kk % 2) + 2 * q);
                a[h] &= pair_mask(bits & 1u, bits & 2u);
                a[h + 2] &= pair_mask(bits & 0x100u, bits & 0x200u);
              } else {
                const unsigned char* gb = slot + r * C::kGCols + kk * 16 +
                                          2 * q;
                a[h] &= pair_mask(gb[0], gb[1]);
                a[h + 2] &= pair_mask(gb[8], gb[9]);
              }
            }
          }
        }
"""
_A_LOOP = """\
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
"""
_MMA_LOOP = """\
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          cadc::mma_bf16"""
GATE_EDITS = {
    "shared": [],
    "registers": [
        ("      if (p.gvec)\n        mma_gate<",
         "      if (false)\n        mma_gate<"),
        (_A_LOOP, _REG_GATE_B + _A_LOOP),
        (_MMA_LOOP, _REG_GATE_A + _MMA_LOOP)],
}
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
    for entry in ("cadc_bwd_launch", "cadc_bwd_mma_launch"):
        getattr(lib, entry).argtypes = getattr(cm._bwd_lib(),
                                               entry).argtypes
        getattr(lib, entry).restype = ctypes.c_int
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
    ap.add_argument("--set", default="plans",
                    choices=("plans", "diag", "lm", "gate"))
    ap.add_argument("--out", default=None, help="write the record as JSON")
    ap.add_argument("--fit", default=None, metavar="RECORD",
                    help="fit the mma route's slice seconds to a --set lm "
                         "record (no GPU)")
    args = ap.parse_args()
    if args.fit:
        fit(cm, args.fit)
        return
    if not torch.cuda.is_available():
        sys.exit("profile_k2_matrix: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    run = {"diag": diag, "lm": lm, "gate": gate}.get(args.set, plans)
    rows = run(cs, cm, dendritic, gen, dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "xbar": LM_XBAR if args.set in (
                           "lm", "gate") else XBAR, "set": args.set,
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


def _lm_case(cs, cm, gen, dev, m, d, n, xbar=LM_XBAR):
    """bf16 w, relu's packed gate of a first x, and a rotation of bf16 (g,
    x) operand copies."""
    bf = torch.bfloat16
    w = (torch.randn(d, n, generator=gen, device=dev) / math.sqrt(d)).to(bf)

    def make():
        return (torch.randn(m, n, generator=gen, device=dev).to(bf),
                torch.randn(m, d, generator=gen, device=dev).to(bf))

    first = make()
    _, gate = cm.cadc_matmul_gate_torch(first[1], w, crossbar_size=xbar,
                                        fn="relu", mode="packed")
    ops = [first] + cs.rotation(make, sum(t.numel() * 2 for t in first))[1:]
    return w, gate, ops


def lm(cs, cm, dendritic, gen, dev) -> list:
    rows = []
    bf = torch.bfloat16
    kw = dict(crossbar_size=LM_XBAR, fn="relu", mode="packed")
    for name, m, d, n in LM_SHAPES:
        w, gate, ops = _lm_case(cs, cm, gen, dev, m, d, n)
        pick = itertools.cycle(ops).__next__
        reps = max(20, len(ops))
        w32 = w.float()
        ops32 = [(g.float(), x.float()) for g, x in ops]
        pick32 = itertools.cycle(ops32).__next__
        gate_b = gate.numel() * gate.element_size()
        flops = 2 * m * d * n
        bounds = {str(dt)[6:]: cs.bound_ms(
                      size * (m * n + m * d + d * n) + gate_b
                      + 4 * (m * d + d * n), 2 * flops, dt)[0]
                  for size, dt in ((2, bf), (4, torch.float32))}
        other = {
            "fp32_route_with_copies": cs.device_ms(
                lambda: (lambda g, x: cm.cadc_segmented_bwd_cuda(
                    g.float(), x.float(), w.float(), gate, **kw))(*pick()),
                reps),
            "plain": cs.device_ms(
                lambda: cm.cadc_segmented_bwd_torch(*pick(), w, gate, **kw),
                reps),
            "matmul_pair_bf16": cs.device_ms(
                lambda: (lambda g, x: (torch.matmul(g, w.T),
                                       torch.matmul(x.T, g)))(*pick()),
                reps),
            "matmul_pair_fp32": cs.device_ms(
                lambda: (lambda g, x: (torch.matmul(g, w32.T),
                                       torch.matmul(x.T, g)))(*pick32()),
                reps)}
        del ops32
        timed = []
        plans = cm.bwd_plans(m, n, d, LM_XBAR, "packed", dtype=bf,
                             fn="relu")
        for plan in plans:
            force = (plan.dx_tile, plan.dw_tile, plan.dw_splits)

            def run(need_dx, need_dw, force=force):
                q = cm.plan_bwd(m, n, d, LM_XBAR, "packed", need_dx,
                                need_dw, dtype=bf, fn="relu", _force=force)
                g, x = pick()
                return cm.cadc_segmented_bwd_cuda(
                    g, x, w, gate, need_dx=need_dx, need_dw=need_dw,
                    plan=q, **kw)

            ms = {label: cs.device_ms(lambda a=a: run(*a), reps)
                  for label, a in (("both", (True, True)),
                                   ("dx", (True, False)),
                                   ("dw", (False, True)))}
            timed.append({"dx_tile": plan.dx_tile, "dx_grid": plan.dx_grid,
                          "dw_grid": plan.dw_grid, "dw_rows": plan.dw_rows,
                          "planner": plan == plans[0], "ms": ms})
            print(f"{name} M{m} D{d} N{n}: dx {plan.dx_tile[0]} rows, dw "
                  f"{plan.dw_splits} splits"
                  f"{' (planner)' if plan == plans[0] else ''}: both "
                  f"{ms['both']:.4f}, dx {ms['dx']:.4f}, dw {ms['dw']:.4f} "
                  f"({2 * flops / ms['both'] / 1e9:.1f} TFLOP/s)",
                  flush=True)
        print(f"{name} M{m}: fp32 route with its copies "
              f"{other['fp32_route_with_copies']:.4f}, plain "
              f"{other['plain']:.4f}, torch.matmul pair bf16 "
              f"{other['matmul_pair_bf16']:.4f} / fp32 "
              f"{other['matmul_pair_fp32']:.4f}; bound bf16 "
              f"{bounds['bfloat16']:.4f}, fp32 {bounds['float32']:.4f}",
              flush=True)
        rows.append({"shape": name, "m": m, "d": d, "n": n,
                     "bound_ms": bounds, "other_ms": other, "plans": timed})
        del ops, gate
        torch.cuda.empty_cache()
    return rows


def gate(cs, cm, dendritic, gen, dev) -> list:
    m, d, n = 2048, 1280, 6912
    bf = torch.bfloat16
    shipped = cm._bwd_lib
    libs = {tag: _variant(cm, tag, e) for tag, e in GATE_EDITS.items()}
    order = list(libs) + list(libs)[::-1]
    w, _, ops = _lm_case(cs, cm, gen, dev, m, d, n)
    pick = itertools.cycle(ops).__next__
    reps = max(20, len(ops))
    rows = []
    for mode in ("packed", "bytes"):
        p0 = torch.stack([ops[0][1][:, i:i + LM_XBAR].float()
                          @ w[i:i + LM_XBAR].float()
                          for i in range(0, d, LM_XBAR)])
        g8 = cm._gate_of(p0, dendritic.grad("relu"), mode, "relu")
        kw = dict(crossbar_size=LM_XBAR, fn="relu", mode=mode)
        want = cm.cadc_segmented_bwd_cuda(*ops[0], w, g8, **kw)
        row = {"mode": mode, "m": m, "d": d, "n": n, "ms": {}}
        for tag in order:
            cm._bwd_lib = functools.lru_cache()(lambda lib=libs[tag]: lib)
            got = cm.cadc_segmented_bwd_cuda(*ops[0], w, g8, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"profile_k2_matrix: {tag} differs from the "
                         "shipped source")
            ms = {k: cs.device_ms(lambda a=a: cm.cadc_segmented_bwd_cuda(
                      *pick(), w, g8, need_dx=a[0], need_dw=a[1], **kw),
                      reps)
                  for k, a in (("dx", (True, False)), ("dw", (False, True)))}
            row["ms"].setdefault(tag, []).append(ms)
            print(f"w_gate M{m} {mode}, gate in {tag}: dx {ms['dx']:.4f}, "
                  f"dw {ms['dw']:.4f}", flush=True)
        cm._bwd_lib = shipped
        rows.append(row)
        del g8, p0
    assert cm.plan_bwd(m, n, d, LM_XBAR, "packed", dtype=bf,
                       fn="relu").kernel == "mma"
    return rows


def fit(cm, path: str) -> None:
    """Print the model constants a --set lm record gives: each dx tile's
    and dw's seconds a slice (the median over the unsplit plans of the
    time over rounds of blocks x slices a block), and dw's merge, a + b x
    splits x rounds of tiles (least squares over the split plans' time
    past their rounds of slices); then, at each shape, the plan the
    planner picks against the fastest timed one."""
    import statistics

    import numpy as np

    with open(path) as f:
        rec = json.load(f)
    per, tail = {}, []
    for row in rec["shapes"]:
        m, d, n = row["m"], row["d"], row["n"]
        for p in row["plans"]:
            r = p["dx_tile"][0]
            blocks = p["dx_grid"][0] * p["dx_grid"][1]
            rounds = -(-blocks // cm.SMS)
            per.setdefault(f"dx {r}", []).append(
                p["ms"]["dx"] * 1e-3 / (rounds * -(-n // cm._MMA_BWD_BK)))
            tiles = p["dw_grid"][0] * p["dw_grid"][1]
            splits = p["dw_grid"][2]
            slices = (-(-tiles * splits // cm.SMS)
                      * -(-p["dw_rows"] // cm._MMA_BWD_BK))
            if splits == 1:
                per.setdefault("dw", []).append(p["ms"]["dw"] * 1e-3 / slices)
            else:
                tail.append((p["ms"]["dw"] * 1e-3, slices,
                             splits * -(-tiles // cm.SMS)))
    print(rec["card"])
    got = {k: statistics.median(v) for k, v in per.items()}
    for k, v in sorted(per.items()):
        print(f"{k}: {got[k]:.3e} s a slice (median of {len(v)}; "
              f"{min(v):.3e} .. {max(v):.3e})")
    a = np.array([[1.0, u] for _, _, u in tail])
    y = np.array([t - sl * got["dw"] for t, sl, _ in tail])
    (t0, t1), *_ = np.linalg.lstsq(a, y, rcond=None)
    part = cm.MMA_BWD_DW_TILE[0] * cm.MMA_BWD_DW_TILE[1] * 4
    print(f"dw merge: {t0:.3e} s + {t1:.3e} s a split a round of tiles "
          f"(a {part}-byte partial at {part / t1:.3e} bytes/s), over "
          f"{len(tail)} split plans")
    for row in rec["shapes"]:
        m, d, n = row["m"], row["d"], row["n"]
        plan = cm.plan_bwd(m, n, d, rec["xbar"], "packed",
                           dtype=torch.bfloat16, fn="relu")
        best = {k: min(row["plans"], key=lambda p: p["ms"][k])
                for k in ("dx", "dw")}
        print(f"{row['shape']} M{m}: planner dx {plan.dx_tile[0]} rows, dw "
              f"x{plan.dw_splits}; fastest timed dx "
              f"{best['dx']['dx_tile'][0]} rows ({best['dx']['ms']['dx']:.4f}"
              f" ms), dw x{best['dw']['dw_grid'][2]} "
              f"({best['dw']['ms']['dw']:.4f} ms)")


if __name__ == "__main__":
    main()
