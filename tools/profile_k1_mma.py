#!/usr/bin/env python3
"""K1 / K1g on bf16 operands under every plan of the tensor-core kernel.

    python3 tools/profile_k1_mma.py [--set plans|diag] [--out PATH]
    python3 tools/profile_k1_mma.py --refit RECORD...

On a card, at gemma3-1b's seven CADC linears (crossbar 256, relu) at M =
2048 (a train micro: K1g, packed gate), 1024 and 512 (prefill: K1) and 32
(a verify step: K1), and at the other LM train shapes at M = 2048 (K1g),
it times in one process:

  plans      every plan of `cadc_matmul.mma_plans` (each row tile at each
             segment group count), the planner's first;
  tile       the CUDA-core tile kernel under the plan it had before the mma
             kernel (`plan_fwd` at the fp32 default);
  matmul     torch.matmul of the same bf16 x and w (the vConv yardstick).

--set diag builds edited copies of csrc/cadc_matmul.cu into
build/k1_mma_variants/ (DIAG_EDITS: parts removed — the mma, the segment
epilogue, the loads after the ring's first fill — or the slice depth and
ring stages changed) and times each under the planner's plan at DIAG_CASES,
beside the shipped kernel; the slice and stage variants must give the
shipped kernel's bits.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose operands
rotate over copies holding 3x the L2 (x at M >= 512, w below: the verify
step streams its weights cold). Prints one line a shape and, last, the
card's name and power limit; --out writes the record as JSON. Needs a GPU.

--refit (CPU, scipy) fits the planner's constants (`_MMA_SLICE_S` and
`_MMA_MERGE_BYTES` in kernels/cadc_matmul.py) to the
records' plan times by least squares on relative error, and prints them
with, per shape, the plan the model picks beside the fastest measured
one.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402

XBAR = 256
GEMMA = [("wq", 1280, 1024), ("wk", 1280, 256), ("wv", 1280, 256),
         ("wo", 1024, 1152), ("w_gate", 1280, 6912), ("w_up", 1280, 6912),
         ("w_down", 6912, 1152)]
# the other LM train shapes (chip_smoke.py lm_kernel_shapes), M = 2048
OTHER = [("hubert.w_up", 1280, 5120), ("hubert.head", 1280, 504),
         ("rg.w_x", 4096, 4096), ("rg.wk", 4096, 256),
         ("rg.ffn.w_up", 4096, 12288), ("rg.ffn.w_down", 12288, 4096),
         ("mlstm.w_up", 2048, 8192), ("mlstm.w_if", 4096, 8),
         ("slstm.w_up", 2048, 2730), ("slstm.w_down", 2816, 2048)]
CASES = ([(name, m, d, n) for m in (2048, 1024, 512, 32)
          for name, d, n in GEMMA]
         + [(name, 2048, d, n) for name, d, n in OTHER])


OUT_DIR = os.path.join(REPO, "build", "k1_mma_variants")
_NO_MMA = [("        for (int j = 0; j < kNT; ++j) mma_bf16(ps[i][j], a, b[j][0], "
            "b[j][1]);",
            "        for (int j = 0; j < kNT; ++j) ps[i][j][0] += "
            "__uint_as_float((a[0] ^ b[j][0] ^ a[3] ^ b[j][1]) & "
            "0x3f800000u);")]
_NO_EPILOGUE = [("    switch (p.fn) {\n      case 0: seg_done(",
                 "    if (p.fn < 0) switch (p.fn) {\n      case 0: seg_done(")]
_NO_LOADS = [("    if (t >= n_slices) return;",
              "    if (t >= n_slices || t >= kMmaStages - 1) return;")]


def _depth(bk, stages):
    return [("constexpr int kMmaBK = 64;", f"constexpr int kMmaBK = {bk};"),
            ("constexpr int kMmaStages = 4;",
             f"constexpr int kMmaStages = {stages};")]


# tag -> (edits, whether the copy computes y: then it must equal shipped's)
DIAG_EDITS = {
    "shipped": ([], True),
    "no mma": (_NO_MMA, False),
    "no epilogue": (_NO_EPILOGUE, False),
    "no loads": (_NO_LOADS, False),
    "mma only": (_NO_EPILOGUE + _NO_LOADS, False),
    "bk64 s3": (_depth(64, 3), True),
    "bk128 s2": (_depth(128, 2), True),
}
# (name, M, D, N, mode)
DIAG_CASES = [("w_gate", 2048, 1280, 6912, "packed"),
              ("w_down", 2048, 6912, 1152, "packed"),
              ("wk", 2048, 1280, 256, "packed"),
              ("w_gate", 32, 1280, 6912, "none")]


def diag(out_path) -> None:
    import shutil
    import subprocess

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import cadc_matmul as cm

    dev = torch.device("cuda", 0)
    src = (_build.CSRC / "cadc_matmul.cu").read_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, OUT_DIR)
    jobs = {}
    for tag, (edits, _) in DIAG_EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"profile_k1_mma: edit {old!r} not found once")
            text = text.replace(old, new)
        stem = os.path.join(OUT_DIR, tag.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        jobs[tag] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    orig = cm._lib
    shipped = orig()
    libs = {}
    for tag, (stem, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_k1_mma: nvcc failed for {tag}:\n{log}")
        for ln in cs.ptxas_lines(log):
            if "bf16_mma_kernel" in ln:
                print(f"{tag}: {ln}", flush=True)
        lib = libs[tag] = __import__("ctypes").CDLL(stem + ".so")
        for fn in ("cadc_matmul_launch", "cadc_matmul_gate_launch",
                   "cadc_matmul_error_string"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = getattr(shipped, fn).restype
    gen = torch.Generator(device=dev).manual_seed(28)
    rows = []
    try:
        for name, m, d, n, mode in DIAG_CASES:
            s = d // XBAR
            w = (torch.randn(d, n, generator=gen, device=dev)
                 / math.sqrt(d)).to(torch.bfloat16)
            xs = cs.rotation(lambda: torch.randn(
                m, d, generator=gen, device=dev).to(torch.bfloat16),
                m * d * 2)
            pick = itertools.cycle(xs).__next__
            plan = cm.plan_fwd(m, n, s, XBAR, dtype=torch.bfloat16)
            row = {"case": name, "M": m, "D": d, "N": n, "mode": mode,
                   "plan": _plan_str(plan)}
            ref = None
            for tag, (_, computes) in DIAG_EDITS.items():
                cm._lib = lambda lib=libs[tag]: lib
                y = cm._fwd_launch(xs[0], w, XBAR, "relu", mode, plan=plan)
                torch.cuda.synchronize()
                if tag == "shipped":
                    ref = y
                elif computes and not (torch.equal(y[0], ref[0]) and (
                        y[1] is None or torch.equal(y[1], ref[1]))):
                    sys.exit(f"profile_k1_mma: {tag} differs from shipped "
                             f"at {name} M={m}")
                row[tag] = cs.device_ms(lambda: cm._fwd_launch(
                    pick(), w, XBAR, "relu", mode, plan=plan),
                    max(20, len(xs)))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del xs, pick, w
            torch.cuda.empty_cache()
    finally:
        cm._lib = orig
    print(cs.nvidia_smi(), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)


def _plan_str(p) -> str:
    return f"{p.kernel} {p.width} groups={p.groups}"


def measure(out_path) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import cadc_matmul as cm

    if not torch.cuda.is_available():
        sys.exit("profile_k1_mma: needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    gen = torch.Generator(device=dev).manual_seed(27)
    rows = []
    for name, m, d, n in CASES:
        s = d // XBAR
        mode = "packed" if m == 2048 else "none"
        bf = torch.bfloat16

        def make_w():
            return (torch.randn(d, n, generator=gen, device=dev)
                    / math.sqrt(d)).to(bf)

        def make_x():
            return torch.randn(m, d, generator=gen, device=dev).to(bf)

        if m >= 512:
            w = make_w()
            sets = [(x, w) for x in cs.rotation(make_x, m * d * 2)]
        else:
            x = make_x()
            sets = [(x, w) for w in cs.rotation(make_w, d * n * 2)]
        pick = itertools.cycle(sets).__next__
        reps = max(20, len(sets))
        row = {"case": name, "M": m, "D": d, "N": n, "xbar": XBAR,
               "mode": mode, "plans": {}}

        def run(plan):
            return cs.keep_counts(lambda: cs.device_ms(
                lambda: cm._fwd_launch(*pick(), XBAR, "relu", mode,
                                       plan=plan), reps))

        for plan in cm.mma_plans(m, n, s, XBAR):
            row["plans"][_plan_str(plan)] = run(plan)
        planned = cm.plan_fwd(m, n, s, XBAR, dtype=bf)
        row["planner"] = _plan_str(planned)
        row["ms"] = row["plans"][row["planner"]]
        tile = cm.plan_fwd(m, n, s, XBAR)
        row["tile_plan"] = f"{tile.kernel} {tile.width} split={tile.split}"
        row["tile_ms"] = run(tile)
        row["matmul_ms"] = cs.device_ms(lambda: torch.matmul(*pick()), reps)
        nbytes = (m * d + d * n) * 2 + m * n * 4
        row["bound_ms"], row["bound_by"] = cs.bound_ms(nbytes, 2 * m * d * n,
                                                       bf)
        best = min(row["plans"], key=row["plans"].get)
        row["best"] = best
        print(f"{name} M={m} D={d} N={n}: planner {row['planner']} "
              f"{row['ms'] * 1e3:.2f} us (best {best} "
              f"{row['plans'][best] * 1e3:.2f}), tile {row['tile_ms'] * 1e3:.1f}"
              f", torch.matmul {row['matmul_ms'] * 1e3:.2f}, bound "
              f"{row['bound_ms'] * 1e3:.2f} by {row['bound_by']}; "
              f"{2 * m * d * n / row['ms'] / 1e9:.1f} TFLOP/s", flush=True)
        rows.append(row)
        del sets, pick
        torch.cuda.empty_cache()
    card = cs.nvidia_smi()
    print(card, flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


def refit(paths) -> None:
    import numpy as np
    from scipy.optimize import least_squares

    from repro_torch.kernels import cadc_matmul as cm

    samples = []  # (row, plan, measured seconds)
    for path in paths:
        with open(path) as f:
            for row in json.load(f)["rows"]:
                s = row["D"] // row["xbar"]
                for key, ms in row["plans"].items():
                    _, rows_, groups = key.split()
                    if int(rows_) not in cm.MMA_ROWS:
                        continue  # a tile the kernel no longer has
                    plan = cm._mma_plan(int(rows_), int(groups.split("=")[1]),
                                        row["M"], row["N"])
                    samples.append((row, plan, ms * 1e-3, s))

    def model(theta, row, plan, s):
        saved = (dict(cm._MMA_SLICE_S), cm._MMA_MERGE_BYTES)
        cm._MMA_SLICE_S.update({128: theta[0] * 1e-6, 32: theta[1] * 1e-6})
        cm._MMA_MERGE_BYTES = theta[2] * 1e10
        try:
            return cm._mma_seconds(plan, row["M"], row["N"], s, row["xbar"])
        finally:
            cm._MMA_SLICE_S.update(saved[0])
            cm._MMA_MERGE_BYTES = saved[1]

    def resid(theta):
        return np.array([model(theta, r, p, s) / t - 1
                         for r, p, t, s in samples])

    x0 = np.array([cm._MMA_SLICE_S[128] * 1e6, cm._MMA_SLICE_S[32] * 1e6,
                   cm._MMA_MERGE_BYTES / 1e10])
    fit = least_squares(resid, x0, bounds=(1e-3, np.inf))
    th = fit.x
    print(f"_MMA_SLICE_S = {{128: {th[0]:.3g}e-6, 32: {th[1]:.3g}e-6}}")
    print(f"_MMA_MERGE_BYTES = {th[2]:.3g}e10")
    print(f"relative error: rms {np.sqrt(np.mean(fit.fun ** 2)):.3f}, max "
          f"{np.max(np.abs(fit.fun)):.3f}")
    by_row = {}
    for r, p, t, s in samples:
        by_row.setdefault(id(r), (r, s, []))[2].append((p, t))
    for r, s, plans in by_row.values():
        picked = min(plans, key=lambda pt: model(th, r, pt[0], s))
        best = min(plans, key=lambda pt: pt[1])
        print(f"{r['case']} M={r['M']}: model picks {_plan_str(picked[0])} "
              f"({picked[1] * 1e6:.2f} us), fastest {_plan_str(best[0])} "
              f"({best[1] * 1e6:.2f} us)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", choices=("plans", "diag"), default="plans")
    ap.add_argument("--out", default=None)
    ap.add_argument("--refit", nargs="+", default=None)
    args = ap.parse_args()
    if args.refit:
        refit(args.refit)
    elif args.set == "diag":
        diag(args.out)
    else:
        measure(args.out)


if __name__ == "__main__":
    main()
