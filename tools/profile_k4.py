#!/usr/bin/env python3
"""Where K4's time goes, on one card.

    python3 tools/profile_k4.py [--set plans|diag|all] [--out PATH]
    python3 tools/profile_k4.py --refit RECORD [RECORD ...]

--set plans (the default): at every q8 FC shape of VGG-16 (f1 = f2: M 128,
D 512, N 512; f3: N 100), ResNet-18 (fc: N 10) and the SNN (fc: M 32, D
4096, N 11), at crossbars 64, 128 and 256, it times in one process every
plan `q8_plans` lists (the planner's first), the int8 tile kernel K4 had
before (its launcher is kept below, on csrc/cadc_tile.cuh's tile kernel,
under `plan_fwd`'s plan as before), torch._int_mm on the same codes (N
padded to a multiple of 8) and the launch floor (a one-element add_ under
the same graph replay).

--set diag: edited copies of csrc/cadc_matmul.cu built into
build/k4_variants/ — the shipped source; without the mma (an xor of its
operands); without the transpose of w's chunks; without the segment
epilogue (no f, no gate: the dequantized psum is stored); without the
merge of a split (the last block only resets its counter); and loads only
(none of those four) — timed under the planner's plan and every other
plan at xbar 64 at the same shapes (timing only: the edited copies no
longer compute K4); and the shipped kernel under the planner's plan
called after a small PyTorch kernel each time, that kernel's own time
taken off (how the eval batch calls it).

--refit RECORD [RECORD ...] (no GPU): fits the planner's model
(`_q8_seconds` in kernels/cadc_matmul.py: `_Q8_FIXED`, `_Q8_ROUND`,
`_Q8_LOAD`, `_Q8_MERGE`) to the --set plans sweeps of the records (the
mean time of a plan over them) by least squares on relative error, and
prints the constants with, per case, the plan the model picks beside the
fastest measured one.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose x codes
rotate over copies holding 3x the L2. Prints one line a case and, last, the
card's name and power limit; --out writes the record as JSON. Needs a GPU
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

OUT_DIR = os.path.join(REPO, "build", "k4_variants")
XBARS = (64, 128, 256)
# --set diag: the edits of each copy (source text -> replacement, each
# found exactly once)
_NO_MMA = [("            mma_s8(ps[ni], a, b[ni][0], b[ni][1]);",
            "            ps[ni][0] ^= a[0] ^ a[3] ^ b[ni][0] ^ b[ni][1];")]
_NO_TRANSPOSE = [("        if (p.wmode == kWSpan)\n"
                  "          transpose_span(xs + kQ8XBytes, wt, lane, p.N);\n"
                  "        else\n"
                  "          transpose_w(xs + kQ8XBytes, wt, lane);\n", "")]
_NO_EPILOGUE = [("      switch (p.fn) {\n        case 0: seg_end(",
                 "      if (p.fn < 0) switch (p.fn) {\n        case 0: "
                 "seg_end(")]
_NO_MERGE = [("    if (!cadc::arrive_last(counter, gridDim.z)) return;\n",
              "    if (!cadc::arrive_last(counter, gridDim.z)) return;\n"
              "    if (p.M > 0) {\n      if (tid == 0) *counter = 0;\n"
              "      return;\n    }\n")]
DIAG_EDITS = {
    "shipped": [],
    "no mma": _NO_MMA,
    "no transpose": _NO_TRANSPOSE,
    "no epilogue": _NO_EPILOGUE,
    "no merge": _NO_MERGE,
    "loads only": _NO_MMA + _NO_TRANSPOSE + _NO_EPILOGUE + _NO_MERGE,
}

# The int8 tile kernel K4 ran on before its redesign: cadc_tile.cuh's
# fwd_tile_kernel over a row-major int8 loader, 8- or 64-row tiles of 64
# columns, int32 multiply-adds on the CUDA cores; split over segments with
# the ordered segment sum where plan_fwd says so. No gate (timing only).
OLD_SOURCE = r'''
#include <stdint.h>

#include "cadc_tile.cuh"

namespace {

struct RowMajorQ8 {
  const int8_t* x;
  size_t D;
  __device__ __forceinline__ int operator()(int m, int d) const {
    return x[static_cast<size_t>(m) * D + d];
  }
};

template <int BM, int TM, int TN>
int launch(const int8_t* x, const int8_t* w, const float* scale, float* y,
           float* scratch, int* counters, int M, int N, int S, int xbar,
           int fn, cudaStream_t st) {
  const int D = S * xbar;
  const dim3 grid((N + 63) / 64, (M + BM - 1) / BM, scratch ? S : 1);
  const RowMajorQ8 xl{x, static_cast<size_t>(D)};
  if (scratch)
    cadc::fwd_tile_kernel<int8_t, int, BM, 64, TM, TN, false, true,
                          RowMajorQ8><<<grid, cadc::kThreads, 0, st>>>(
        xl, w, y, scratch, counters, nullptr, M, N, D, S, xbar, fn, 0,
        scale);
  else
    cadc::fwd_tile_kernel<int8_t, int, BM, 64, TM, TN, false, false,
                          RowMajorQ8><<<grid, cadc::kThreads, 0, st>>>(
        xl, w, y, nullptr, nullptr, nullptr, M, N, D, S, xbar, fn, 0,
        scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int old_q8_launch(const void* x, const void* w, const void* scale,
                             void* y, void* scratch, void* counters, int M,
                             int N, int S, int xbar, int fn, int rows,
                             void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* yp = static_cast<float*>(y);
  auto* scr = static_cast<float*>(scratch);
  auto* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 8)
    return launch<8, 1, 2>(xp, wp, sp, yp, scr, cnt, M, N, S, xbar, fn, st);
  if (rows == 64)
    return launch<64, 4, 4>(xp, wp, sp, yp, scr, cnt, M, N, S, xbar, fn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
'''


def _start(sources: dict) -> dict:
    """Start one nvcc a source ({tag: text}) into OUT_DIR; returns the jobs
    for _finish."""
    from repro_torch.kernels import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, OUT_DIR)
    jobs = {}
    for tag, src in sources.items():
        stem = os.path.join(OUT_DIR, tag.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        jobs[tag] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return jobs


def _finish(jobs: dict) -> dict:
    """{tag: loaded library} once every job of _start has built."""
    libs = {}
    for tag, (stem, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"profile_k4: nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(stem + ".so")
    return libs


def start_old_build():
    """Start building the old int8 tile kernel; the returned callable waits
    for it and returns its library, bound (chip_smoke.py builds it beside
    the port's sources)."""
    jobs = _start({"old_tile": OLD_SOURCE})

    def finish():
        lib = _finish(jobs)["old_tile"]
        lib.old_q8_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.old_q8_launch.restype = ctypes.c_int
        return lib
    return finish


def old_call(lib, x, w, scale, *, crossbar_size, fn="relu"):
    """The old wrapper: plan_fwd's tile plan (no stream kernel for q8),
    fp32 scratch where it splits, one launch."""
    from repro_torch.kernels import cadc_matmul as cm

    m, d = x.shape
    n = w.shape[1]
    s = d // crossbar_size
    plan = cm.plan_fwd(m, n, s, crossbar_size)
    y = torch.empty(m, n, device=x.device)
    scratch = (torch.empty(s, m, n, device=x.device) if plan.split
               else None)
    counters = cm._counters(x.device) if plan.split else None
    code = lib.old_q8_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if counters is None else counters.data_ptr(), m, n, s,
        crossbar_size, cm.FN_IDS[fn], plan.width,
        torch.cuda.current_stream(x.device).cuda_stream)
    if code:
        raise RuntimeError(f"old int8 tile kernel: CUDA error {code}")
    return y


def _cases(cs):
    """(name, M, D, N) of the distinct q8 FC shapes (VGG-16's f2 is f1)."""
    return [c for c in cs.q8_fc_shapes() if c[0] != "vgg16.f2"]


def _operands(cs, dev, gen, m, d, n):
    """w codes, and x codes rotating over copies holding 3x the L2."""
    w = cs._codes(gen, dev, (d, n), -1, 2)

    def make():
        return cs._codes(gen, dev, (m, d), -7, 8)
    xs = [make()]
    xs += [t[0] for t in cs.rotation(lambda: (make(),), m * d)[1:]]
    return w, xs


def plans(cs, cm, dev, gen) -> list:
    old = start_old_build()()
    scale = torch.tensor(0.0123, device=dev)
    one = torch.zeros(1, device=dev)
    floor = cs.device_ms(lambda: one.add_(1), 20)
    rows = []
    for (name, m, d, n), xbar in itertools.product(_cases(cs), XBARS):
        s = d // xbar
        w, xs = _operands(cs, dev, gen, m, d, n)
        pick = itertools.cycle(xs).__next__
        reps = max(20, len(xs))
        want = cm.cadc_matmul_q8_torch(xs[0], w, scale, crossbar_size=xbar,
                                       fn="relu")
        got = old_call(old, xs[0], w, scale, crossbar_size=xbar)
        if not torch.equal(got, want):
            sys.exit(f"profile_k4: the old tile kernel differs at {name}")
        planned = cm.plan_fwd_q8(m, n, s, xbar)
        row = {"case": name, "M": m, "D": d, "N": n, "xbar": xbar, "S": s,
               "planner": planned.groups, "plans": {}}
        for p in cm.q8_plans(m, n, s, xbar):
            row["plans"][str(p.groups)] = cs.device_ms(
                lambda p=p: cm._fwd_launch(pick(), w, xbar, "relu", "none",
                                           scale, plan=p), reps)
        old_plan = cm.plan_fwd(m, n, s, xbar)
        row["old tile kernel"] = cs.device_ms(
            lambda: old_call(old, pick(), w, scale, crossbar_size=xbar),
            reps)
        row["old plan"] = (f"{old_plan.width} rows, "
                           f"{'split' if old_plan.split else 'single'}, "
                           f"{old_plan.blocks} blocks")
        n8 = -(-n // 8) * 8
        w8 = torch.zeros((d, n8), dtype=torch.int8, device=dev)
        w8[:, :n] = w
        row["torch._int_mm"] = cs.device_ms(lambda: torch._int_mm(pick(), w8),
                                            reps)
        row["launch floor"] = floor
        nbytes = m * d + d * n + 4 * m * n + 4
        row["bound_ms"] = cs.bound_ms(nbytes, 2 * m * d * n, torch.int8)[0]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def diag(cs, cm, dev, gen) -> list:
    from repro_torch.kernels import _build

    shipped = cm._lib
    src = (_build.CSRC / "cadc_matmul.cu").read_text()
    sources = {}
    for tag, edits in DIAG_EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"profile_k4: edit {old!r} not found once")
            text = text.replace(old, new)
        sources[tag] = text
    libs = _finish(_start(sources))
    for lib in libs.values():
        for fn in ("cadc_matmul_q8_launch", "cadc_matmul_error_string"):
            getattr(lib, fn).argtypes = getattr(shipped(), fn).argtypes
            getattr(lib, fn).restype = getattr(shipped(), fn).restype
    scale = torch.tensor(0.0123, device=dev)
    rows = []
    try:
        for name, m, d, n in _cases(cs):
            xbar = 64
            s = d // xbar
            w, xs = _operands(cs, dev, gen, m, d, n)
            pick = itertools.cycle(xs).__next__
            reps = max(20, len(xs))
            row = {"case": name, "M": m, "D": d, "N": n, "xbar": xbar,
                   "planner": cm.plan_fwd_q8(m, n, s, xbar).groups,
                   "copies": {}}
            for tag, lib in libs.items():
                cm._lib = lambda lib=lib: lib
                row["copies"][tag] = {
                    str(p.groups): cs.device_ms(
                        lambda p=p: cm._fwd_launch(pick(), w, xbar, "relu",
                                                   "none", scale, plan=p),
                        reps)
                    for p in cm.q8_plans(m, n, s, xbar)}
            # the planner's plan each time after a small PyTorch kernel (as
            # the eval batch calls it), less that kernel alone
            cm._lib = shipped
            junk = torch.zeros(1 << 16, device=dev)
            alone = cs.device_ms(lambda: junk.add_(1), reps)
            row["after a PyTorch kernel"] = cs.device_ms(
                lambda: (junk.add_(1),
                         cm.cadc_matmul_q8_cuda(pick(), w, scale,
                                                crossbar_size=xbar,
                                                fn="relu")), reps) - alone
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        cm._lib = shipped
    return rows


def refit(paths) -> None:
    """The planner's constants by least squares on the sweeps' relative
    error (see the module docstring)."""
    import numpy as np
    from scipy.optimize import least_squares

    from repro_torch.kernels import cadc_matmul as cm

    times = {}
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        for row in rec.get("plans", []):
            for groups, ms in row["plans"].items():
                key = (row["case"], row["M"], row["N"], row["S"],
                       row["xbar"], int(groups))
                times.setdefault(key, []).append(ms * 1e3)
    keys = sorted(times)
    us = np.array([np.mean(times[k]) for k in keys])
    plans = [cm.plan_fwd_q8(m, n, s, xbar, _force=g)
             for _, m, n, s, xbar, g in keys]

    names = ("_Q8_FIXED", "_Q8_ROUND", "_Q8_LOAD", "_Q8_MERGE")

    def model(p):
        saved = [getattr(cm, k) for k in names]
        for k, v in zip(names, (p[0], p[1], p[2], (p[3], p[4]))):
            setattr(cm, k, v)
        try:
            return np.array([cm._q8_seconds(pl, k[3], k[4])
                             for pl, k in zip(plans, keys)])
        finally:
            for k, v in zip(names, saved):
                setattr(cm, k, v)

    fit = least_squares(lambda p: (model(p) - us) / us,
                        x0=[2.0, 1.0, 0.1, 1.0, 0.5], bounds=(0, np.inf)).x
    pred = model(fit)
    print(f"_Q8_FIXED = {fit[0]:.3f}")
    print(f"_Q8_ROUND = {fit[1]:.3f}")
    print(f"_Q8_LOAD = {fit[2]:.3f}")
    print(f"_Q8_MERGE = ({fit[3]:.3f}, {fit[4]:.3f})")
    print(f"rms relative error {np.sqrt(np.mean(((pred - us) / us) ** 2)):.3f}")
    cases = sorted({k[:5] for k in keys})
    gaps = []
    for case in cases:
        at = [i for i, k in enumerate(keys) if k[:5] == case]
        i = min(at, key=lambda i: pred[i])
        j = min(at, key=lambda i: us[i])
        gaps.append(us[i] / us[j] - 1)
        print(f"{case[0]} xbar={case[4]}: model picks {keys[i][5]} groups "
              f"({us[i]:.2f} us), fastest {keys[j][5]} ({us[j]:.2f} us), "
              f"+{100 * gaps[-1]:.1f} %")
    print(f"the model's pick over the fastest: mean +{100 * np.mean(gaps):.1f}"
          f" %, worst +{100 * max(gaps):.1f} % over {len(gaps)} cases")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="plans", choices=("plans", "diag", "all"))
    ap.add_argument("--out", default=None, help="write the record as JSON")
    ap.add_argument("--refit", nargs="+", default=None, metavar="RECORD",
                    help="fit the planner to these records (no GPU)")
    args = ap.parse_args()
    if args.refit:
        refit(args.refit)
        return

    import chip_smoke as cs
    from repro_torch.kernels import cadc_matmul as cm

    if not torch.cuda.is_available():
        sys.exit("profile_k4: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    record = {}
    for name, fn in (("plans", plans), ("diag", diag)):
        if args.set in (name, "all"):
            record[name] = fn(cs, cm, dev, gen)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "set": args.set, **record}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
