#!/usr/bin/env python3
"""Where K6's time goes, on one card.

    python3 tools/profile_k6.py [--set plans|fit|diag|all] [--out PATH]
    python3 tools/profile_k6.py --refit RECORD [RECORD ...]

--set plans (the default): at the main path's geometries — gemma3-1b
(4 q heads on 1 kv head, head_dim 256, bf16), 8 slots at positions
64..159, block 16, a 160-entry ring, local and global, the covered-prefix
widths 8 and 10 — and at the 40-slot and ring-512 cases of chip_smoke.py's
check_k6, it times in one process every plan `paged_plans` lists (the
planner's first), the two-launch kernel K6 had before (its source is kept
below, edited only to build on its own, with its old split rule), each
backend of scaled_dot_product_attention that takes the masked call over
K/V already gathered into the dense ring, and the launch floor (a
one-element add_ under the same graph replay).

--set fit: the sweep the planner's cost model (`_paged_cost` in
kernels/paged_attention.py) is fitted to: every plan at 1, 8, 40 and 300
slots x rings of 4, 10 and 32 chunks, every chunk live (global kind at the
ring's last position), bf16.

--refit RECORD [RECORD ...] (no GPU): fits the planner's cost model to
the --set fit and --set plans sweeps of one or more --out records (each
case of each set a workload of its own; the mean time of a plan over the
records) by least squares on relative error, plus ranking terms (weight
RANK_WEIGHT) that ask each case's fastest plan to be predicted below every
plan of the case measured more than RANK_MARGIN slower, and prints the
constants of kernels/paged_attention.py (`_PAGED_LAT`, `_PAGED_THR`,
`_PAGED_MERGE`, `_PAGED_P`) with, per case, the plan the model picks
beside the fastest measured one and the gap between them, then the mean
and worst gap.

--set diag: edited copies of csrc/paged_attention.cu built into
build/k6_variants/ — the shipped source; loads only (no scores, softmax
or PV); no scores; no PV; no merge (the last block of a tile only resets
its counter) — timed under the planner's plan and the one-group plan at
the main path's geometries.

Every time is chip_smoke.device_ms: a CUDA graph of calls whose pools
rotate over copies holding 3x the L2. Prints one line a case and, last,
the card's name and power limit; --out writes the record as JSON. Needs a
GPU.
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

BS, RING, N_SLOTS = 16, 160, 8
RANK_WEIGHT, RANK_MARGIN = 3.0, 0.02
MAIN_POSITIONS = [64, 77, 90, 101, 118, 131, 147, 159]
# --set diag: the edits of each copy (source text -> replacement, each
# found exactly once)
_NO_SCORES = [("        if (i < bs && vi < nv) {", "        if (a.Q < 0) {"),
              ("      for (int r = 0; r < kR; ++r) dot[r] = "
               "lanes_sum<kLPE>(dot[r]);\n", "")]
_NO_PV = [("#pragma unroll 4\n        for (int i = 0; i < bs; ++i) {\n"
            "          const float v = to_f32(vb[i * hd + d]);\n#pragma unroll\n"
            "          for (int r = 0; r < kR; ++r)\n",
            "        for (int i = 0; i < (a.Q < 0 ? bs : 0); ++i) {\n"
            "          const float v = to_f32(vb[i * hd + d]);\n#pragma unroll\n"
            "          for (int r = 0; r < kR; ++r)\n")]
_NO_SOFTMAX = [("      float mx = -INFINITY;\n      for (int i = lane; i < bs;"
                " i += 32) mx = fmaxf(mx, sc[i * kR + r]);",
                "      if (a.Q > 0) continue;\n      float mx = -INFINITY;\n"
                "      for (int i = lane; i < bs; i += 32) mx = fmaxf(mx, "
                "sc[i * kR + r]);")]
DIAG_EDITS = {
    "shipped": [],
    "loads only": _NO_SCORES + _NO_SOFTMAX + _NO_PV,
    "no scores": _NO_SCORES,
    "no PV": _NO_PV,
    "no merge": [("  if (tid == 0) a.counters[tile] = 0;\n",
                  "  if (tid == 0) a.counters[tile] = 0;\n"
                  "  if (a.Q > 0) return;\n")],
}


def _cfg():
    from repro_torch.configs import get_config
    return get_config("gemma3_1b")


def _case(cs, cfg, dev, gen, *, kind, ring, nb, positions, window=None):
    """q, a rotation of (k_pool, v_pool) copies, the table and positions of
    len(positions) busy slots (chip_smoke.k6_inputs, its idle slot
    dropped)."""
    q, kp, vp, tbl, pos = cs.k6_inputs(cfg, dev, torch.bfloat16, kind=kind,
                                       ring_len=ring, nb=nb,
                                       positions=list(positions) + [0],
                                       gen=gen)
    b = len(positions)
    pools = [(kp, vp)] + cs.rotation(lambda: (kp.clone(), vp.clone()),
                                     kp.numel() * 2 * 2)[1:]
    kw = dict(kind=kind, window=cfg.local_window if window is None
              else window, ring_len=ring)
    return (q[:b], pools, torch.as_tensor(tbl[:b], device=dev), pos[:b], kw)


def _plan_row(cs, pa, case, plans) -> dict:
    q, pools, tbl, pos, kw = case
    pick = itertools.cycle(pools).__next__
    reps = max(20, len(pools))
    out = {}
    for p in plans:
        out[f"cps={p.cps} groups={p.groups} threads={p.threads}"] = \
            cs.device_ms(lambda p=p: pa.paged_attention_cuda(
                q, *pick(), tbl, pos, plan=p, **kw), reps)
    return out


def _geometries(cfg):
    """(label, kind, ring, nb, positions, window) of --set plans and diag."""
    import numpy as np
    many = np.random.RandomState(2).randint(0, 2048, size=40).tolist()
    rows = []
    for kind in ("local", "global"):
        for nb in (10, 8):
            top = min(RING, nb * BS) - 1
            pos = (MAIN_POSITIONS if nb == 10 else
                   np.linspace(64, top, N_SLOTS).astype(int).tolist())
            rows.append((f"main {kind} nb={nb}", kind, RING, nb, pos,
                         cfg.local_window))
    rows.append(("ring 512, 8 slots", "local", 512, 32,
                 [3, 200, 511, 512, 700, 1023, 1500, 9], 512))
    rows.append(("ring 512, 40 slots", "local", 512, 32, many, 512))
    return rows


def plans(cs, pa, cfg, dev, gen) -> list:
    import torch.nn.functional as F

    rows = []
    old = _old_lib()
    for label, kind, ring, nb, positions, window in _geometries(cfg):
        case = _case(cs, cfg, dev, gen, kind=kind, ring=ring, nb=nb,
                     positions=positions, window=window)
        q, pools, tbl, pos, kw = case
        b = len(positions)
        rows_ = q.shape[1] * cfg.n_heads // cfg.n_kv_heads
        shape = (b, cfg.n_kv_heads, nb, rows_, cfg.head_dim, 2, BS)
        planned = pa.plan_paged(*shape)
        row = {"case": label, "B": b, "nb": nb, "kind": kind,
               "planner": f"cps={planned.cps} groups={planned.groups} "
                          f"threads={planned.threads}",
               "plans": _plan_row(cs, pa, case, pa.paged_plans(*shape))}
        pick = itertools.cycle(pools).__next__
        reps = max(20, len(pools))
        row["two-launch kernel (before)"] = cs.device_ms(
            lambda: _old_call(old, q, *pick(), tbl, pos, **kw), reps)
        # SDPA over K/V already gathered into the dense ring
        kp, vp = pools[0]
        valid = pa._ring_mask(pos, torch.arange(ring, device=dev), kind=kind,
                              ring_len=ring, window=kw["window"],
                              q_len=1)[:, 0]
        valid[:, :nb * BS] &= (tbl >= 0).repeat_interleave(BS, dim=1)
        idx = tbl.clamp(min=0).long()
        kd = kp[idx].reshape(b, nb * BS, -1)
        vd = vp[idx].reshape(b, nb * BS, -1)
        gathered = cs.rotation(lambda: tuple(
            t.clone().unsqueeze(1).expand(-1, cfg.n_heads, -1, -1)
            for t in (kd, vd)), kd.numel() * 2 * 2)
        row["sdpa"] = cs.sdpa_backends_ms(
            q[:, 0].unsqueeze(2), gathered,
            valid[:, None, None, :nb * BS])
        one = torch.zeros(1, device=dev)
        row["launch floor"] = cs.device_ms(lambda: one.add_(1), 20)
        # q and out, the K / V rows of the readable entries, table, positions
        nbytes = (2 * q.numel() * 2
                  + int(valid.sum()) * cfg.n_kv_heads * cfg.head_dim * 2 * 2
                  + tbl.numel() * 4 + pos.numel() * pos.element_size())
        row["bound_ms"] = cs.bound_ms(
            nbytes, 4 * cfg.n_heads * int(valid.sum()) * cfg.head_dim,
            torch.bfloat16)[0]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del pools, gathered
    return rows


def fit(cs, pa, cfg, dev, gen) -> list:
    rows = []
    for b in (1, 8, 40, 300):
        for nb in (4, 10, 32):
            ring = nb * BS
            case = _case(cs, cfg, dev, gen, kind="global", ring=ring, nb=nb,
                         positions=[ring - 1] * b)
            shape = (b, cfg.n_kv_heads, nb, cfg.n_heads // cfg.n_kv_heads,
                     cfg.head_dim, 2, BS)
            planned = pa.plan_paged(*shape)
            row = {"B": b, "nb": nb,
                   "planner": f"cps={planned.cps} groups={planned.groups} "
                              f"threads={planned.threads}",
                   "plans": _plan_row(cs, pa, case, pa.paged_plans(*shape))}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del case
    return rows


def _variants(pa) -> dict:
    """{tag: ctypes library} of csrc/paged_attention.cu with each entry of
    DIAG_EDITS made, built into build/k6_variants/ (one nvcc each, all
    started together), bound as kernels/paged_attention.py binds the
    shipped one."""
    from repro_torch.kernels import _build

    sources = {}
    for tag, edits in DIAG_EDITS.items():
        src = (_build.CSRC / "paged_attention.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"profile_k6: edit {old!r} not found once")
            src = src.replace(old, new)
        sources[tag] = src
    libs = _compile(sources)
    for lib in libs.values():
        lib.paged_attention_launch.argtypes = \
            pa._lib().paged_attention_launch.argtypes
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return libs


def _compile(sources: dict) -> dict:
    """{tag: source} -> {tag: loaded library}, built into
    build/k6_variants/ by one nvcc a source, all started together."""
    from repro_torch.kernels import _build

    out = os.path.join(REPO, "build", "k6_variants")
    os.makedirs(out, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out)
    jobs = {}
    for tag, src in sources.items():
        stem = os.path.join(out, tag.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        jobs[tag] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for tag, (stem, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_k6: nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(stem + ".so")
    return libs


def diag(cs, pa, cfg, dev, gen) -> list:
    rows = []
    shipped = pa._lib
    libs = _variants(pa)
    try:
        for label, kind, ring, nb, positions, window in _geometries(cfg)[:4]:
            case = _case(cs, cfg, dev, gen, kind=kind, ring=ring, nb=nb,
                         positions=positions, window=window)
            shape = (len(positions), cfg.n_kv_heads, nb,
                     cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, 2, BS)
            plans = {"planner": pa.plan_paged(*shape),
                     "one group": pa.plan_paged(*shape, _force=(nb, 256))}
            row = {"case": label, "copies": {}}
            for tag, lib in libs.items():
                pa._lib = lambda lib=lib: lib
                row["copies"][tag] = {
                    k: next(iter(_plan_row(cs, pa, case, [p]).values()))
                    for k, p in plans.items()}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del case
    finally:
        pa._lib = shipped
    return rows


def _old_lib():
    """The two-launch kernel K6 had before (OLD_SOURCE), built into
    build/k6_variants/."""
    lib = _compile({"two_launch": OLD_SOURCE})["two_launch"]
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _old_call(lib, q, k_pool, v_pool, tbl, pos, *, kind, window, ring_len):
    """The old wrapper: its split rule (fill the SMs twice, at most one
    group a chunk), fp32 scratch, two launches."""
    b, q_len, h, hd = q.shape
    bs, k_ = k_pool.shape[1], k_pool.shape[2]
    nb = tbl.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    want = max(1, -(-2 * sms // max(1, b * k_)))
    cps = -(-nb // max(1, min(nb, want)))
    n_split = max(1, -(-nb // cps))
    rows = b * k_ * n_split * q_len * (h // k_)
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    pos32 = pos.to(torch.int32)
    code = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        pos32.data_ptr(), out.data_ptr(), part[:rows].data_ptr(),
        part[rows:2 * rows].data_ptr(), part[2 * rows:].data_ptr(), b, q_len,
        h, k_, hd, bs, nb, cps, n_split, ring_len, window,
        int(kind == "local"), 0.0, hd ** -0.5, 1,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code:
        raise RuntimeError(f"two-launch K6: CUDA error {code}")
    return out


def refit(paths) -> None:
    """The planner's constants, least squares on the sweeps' relative
    error (see the module docstring)."""
    import re

    import numpy as np
    from scipy.optimize import least_squares

    times = {}
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        for row in rec.get("fit", []) + rec.get("plans", []):
            case = row.get("case", f"fit B={row['B']} nb={row['nb']}")
            for label, ms in row["plans"].items():
                key = (case, row["B"], row["nb"]) + tuple(
                    int(x) for x in re.findall(r"\d+", label))
                times.setdefault(key, []).append(ms * 1e3)
    keys = sorted(times)
    cases = np.array([k[0] for k in keys])
    b, nb, cps, groups, threads, us = np.array(
        [k[1:] + (np.mean(times[k]),) for k in keys], float).T
    sms = 132

    def model(p):
        a1, b1, a2, b2, c, d, e1, f1, e2, f2, pw = p
        pick = lambda x, y: np.where(threads == 128, x, y)  # noqa: E731
        lat = pick(a1, a2) + pick(b1, b2) * cps
        thr = b * groups * (pick(e1, e2) + pick(f1, f2) * cps) / sms
        return ((lat ** pw + thr ** pw) ** (1 / pw)
                + np.where(groups > 1, c + d * groups, 0))

    # ranking terms: each case's fastest plan predicted below every plan
    # of the case measured more than RANK_MARGIN slower
    fastest = {c: np.flatnonzero(cases == c)[np.argmin(us[cases == c])]
               for c in set(cases)}
    pairs = np.array([(j, i) for c, j in fastest.items()
                      for i in np.flatnonzero(cases == c)
                      if us[i] > (1 + RANK_MARGIN) * us[j]])

    def residuals(p):
        pred = model(p)
        jp, ip = pred[pairs[:, 0]], pred[pairs[:, 1]]
        return np.concatenate([(pred - us) / us, RANK_WEIGHT * np.maximum(
            0, (jp - ip) / us[pairs[:, 0]])])

    fit = least_squares(residuals,
                        x0=[3, 3, 3, 2.3, 2.4, 0.13, 1.3, 1.2, 2.7, 1.8, 1.6],
                        bounds=([0] * 10 + [1], [np.inf] * 10 + [30])).x
    a1, b1, a2, b2, c, d, e1, f1, e2, f2, pw = fit
    pred = model(fit)
    print(f"_PAGED_LAT = {{128: ({a1:.3f}, {b1:.3f}), 256: ({a2:.3f}, "
          f"{b2:.3f})}}")
    print(f"_PAGED_THR = {{128: ({e1:.3f}, {f1:.3f}), 256: ({e2:.3f}, "
          f"{f2:.3f})}}")
    print(f"_PAGED_MERGE = ({c:.3f}, {d:.3f})")
    print(f"_PAGED_P = {pw:.3f}")
    print(f"rms relative error {np.sqrt(np.mean(((pred - us) / us) ** 2)):.3f}")
    gaps = []
    for case in sorted(set(cases)):
        at = cases == case
        i = int(np.argmin(np.where(at, pred, np.inf)))
        j = int(np.argmin(np.where(at, us, np.inf)))
        gaps.append(us[i] / us[j] - 1)
        print(f"{case} (B={b[i]:.0f} nb={nb[i]:.0f}): model picks "
              f"cps={cps[i]:.0f} threads={threads[i]:.0f} ({us[i]:.2f} us), "
              f"fastest cps={cps[j]:.0f} threads={threads[j]:.0f} "
              f"({us[j]:.2f} us), +{100 * gaps[-1]:.1f} %")
    print(f"the model's pick over the fastest: mean +{100 * np.mean(gaps):.1f}"
          f" %, worst +{100 * max(gaps):.1f} % over {len(gaps)} cases")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="plans",
                    choices=("plans", "fit", "diag", "all"))
    ap.add_argument("--out", default=None, help="write the record as JSON")
    ap.add_argument("--refit", nargs="+", default=None, metavar="RECORD",
                    help="fit the planner to these records (no GPU)")
    args = ap.parse_args()
    if args.refit:
        refit(args.refit)
        return

    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        sys.exit("profile_k6: needs a GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    cfg = _cfg()
    record = {}
    for name, fn in (("plans", plans), ("fit", fit), ("diag", diag)):
        if args.set in (name, "all"):
            record[name] = fn(cs, pa, cfg, dev, gen)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "set": args.set, **record}, f,
                      indent=1)
    print(card)


# The two-launch kernel of csrc/paged_attention.cu before its redesign:
# split-K flash decoding, one block per (kv head, slot, group of chunks)
# staging K/V by scalar loads, and paged_attention_combine_kernel merging
# the groups in a second launch. Kept for --set plans' comparison.
OLD_SOURCE = r"""
// K6 before its redesign (two launches); see tools/profile_k6.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 8;  // K/V elements a thread has in flight at once

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Ring-entry validity for q token t (absolute position pos + t), the
// `_ring_mask` rule: global entries hold position idx; local entries hold
// the newest position congruent to idx mod ring_len.
__device__ __forceinline__ bool ring_valid(int pos, int t, int idx, int q_len,
                                           int ring_len, int window,
                                           int local) {
  const int qp = pos + t;
  if (!local) return idx <= qp;
  const int newest = pos + q_len - 1;
  int d = (newest - idx) % ring_len;
  if (d < 0) d += ring_len;
  const int held = newest - d;
  return held >= 0 && held <= qp && held > qp - window;
}

// Offset of q/out element (b, t, head kh*g + gi, d) for resident row r.
__device__ __forceinline__ size_t row_offset(int b, int r, int d, int Q,
                                             int H, int g, int kh, int hd) {
  const int t = r / g, gi = r % g;
  return ((static_cast<size_t>(b) * Q + t) * H + kh * g + gi) * hd + d;
}

// grid (K, B, n_split). Group s writes part_m/part_l [B, K, n_split, R] and
// part_acc [B, K, n_split, R, hd] (unnormalised).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ positions,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int Q, int H, int K,
                       int hd, int bs, int nb, int cps, int ring_len,
                       int window, int local, float softcap, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int g = H / K;
  const int R = Q * g;  // resident rows: row r = t * g + gi -> head kh*g+gi

  extern __shared__ float smem[];
  float* qs = smem;             // [R][hd]
  float* acc = qs + R * hd;     // [R][hd]
  float* ks = acc + R * hd;     // [bs][hd]
  float* vs = ks + bs * hd;     // [bs][hd]
  float* sc = vs + bs * hd;     // [R][bs] scores, then probabilities
  float* m = sc + R * bs;       // [R] running max
  float* l = m + R;             // [R] running normaliser
  float* alpha = l + R;         // [R] rescale of this chunk
  unsigned char* vm = reinterpret_cast<unsigned char*>(alpha + R);  // [Q][bs]

  const int pos = positions[b];
  const size_t row_stride = static_cast<size_t>(K) * hd;  // one pool entry

  for (int e = threadIdx.x; e < R * hd; e += kThreads) {
    qs[e] = to_f32(q[row_offset(b, e / hd, e % hd, Q, H, g, kh, hd)]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_end = min(nb, (split + 1) * cps);
  for (int c = split * cps; c < c_end; ++c) {
    const int phys = table[static_cast<size_t>(b) * nb + c];
    if (phys < 0) continue;  // unallocated: uniform over the block

    int any = 0;
    for (int e = threadIdx.x; e < Q * bs; e += kThreads) {
      const int t = e / bs, i = e % bs;
      const bool ok =
          ring_valid(pos, t, c * bs + i, Q, ring_len, window, local);
      vm[e] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // whole chunk masked: skip

    const T* kb = k_pool + static_cast<size_t>(phys) * bs * row_stride + kh * hd;
    const T* vb = v_pool + static_cast<size_t>(phys) * bs * row_stride + kh * hd;
    const int n_kv = bs * hd;
    for (int e0 = threadIdx.x; e0 < n_kv; e0 += kThreads * kLoadBatch) {
      float kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n_kv) {
          const size_t off = (e / hd) * row_stride + e % hd;
          kr[u] = to_f32(kb[off]);
          vr[u] = to_f32(vb[off]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n_kv) {
          ks[e] = kr[u];
          vs[e] = vr[u];
        }
      }
    }
    __syncthreads();

    // scores: one warp per (row, entry) pair, lanes over hd
    for (int p = warp; p < R * bs; p += kWarps) {
      const int r = p / bs, i = p % bs;
      if (!vm[(r / g) * bs + i]) {
        if (lane == 0) sc[p] = -INFINITY;
        continue;
      }
      float part = 0.f;
      for (int d = lane; d < hd; d += 32)
        part = fmaf(qs[r * hd + d], ks[i * hd + d], part);
      part = warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sc[p] = s;
      }
    }
    __syncthreads();

    // online-softmax bookkeeping, one warp per row, lanes over entries
    for (int r = warp; r < R; r += kWarps) {
      const unsigned char* rv = vm + (r / g) * bs;
      float* sr = sc + r * bs;
      float mx = -INFINITY;
      for (int i = lane; i < bs; i += 32)
        if (rv[i]) mx = fmaxf(mx, sr[i]);
      mx = warp_max(mx);
      if (mx == -INFINITY) {  // no valid entry for this row in this chunk
        for (int i = lane; i < bs; i += 32) sr[i] = 0.f;
        if (lane == 0) alpha[r] = 1.f;
        continue;
      }
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < bs; i += 32) {
        const float pr = rv[i] ? expf(sr[i] - m_new) : 0.f;
        sr[i] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        l[r] = a * l[r] + sum;
        m[r] = m_new;
        alpha[r] = a;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < R * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const unsigned char* rv = vm + (r / g) * bs;
      float a = alpha[r] * acc[e];
      for (int i = 0; i < bs; ++i)
        if (rv[i]) a = fmaf(sc[r * bs + i], vs[i * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  const size_t base =
      (static_cast<size_t>(b) * K + kh) * gridDim.z + split;  // [B, K, S]
  for (int e = threadIdx.x; e < R * hd; e += kThreads)
    part_acc[base * R * hd + e] = acc[e];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    part_m[base * R + r] = m[r];
    part_l[base * R + r] = l[r];
  }
}

// grid (K, B): merges the n_split partials of one (slot, kv head) in group
// order. One warp per row first turns the groups' (m, l) into weights
// exp(m_s - M) / L in shared memory; groups with l = 0 saw no valid entry
// and get weight 0, and their (zero) acc is never read. Then each output
// element sums its groups' acc with independent loads. A row with no valid
// entry at all writes 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int Q, int H, int K,
                               int hd, int n_split) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / K;
  const int R = Q * g;
  const size_t base = (static_cast<size_t>(b) * K + kh) * n_split;
  extern __shared__ float wts[];  // [R][n_split]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < n_split; s += 32)
      if (part_l[(base + s) * R + r] > 0.f)
        mx = fmaxf(mx, part_m[(base + s) * R + r]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float ls = part_l[(base + s) * R + r];
      const float w = ls > 0.f ? expf(part_m[(base + s) * R + r] - mx) : 0.f;
      wts[r * n_split + s] = w;
      lsum = fmaf(w, ls, lsum);
    }
    lsum = warp_sum(lsum);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int s = lane; s < n_split; s += 32) wts[r * n_split + s] *= inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * hd; e += kThreads) {
    const int r = e / hd;
    const float* w = wts + r * n_split;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (w[s] != 0.f) a = fmaf(w[s], part_acc[(base + s) * R * hd + e], a);
    out[row_offset(b, r, e % hd, Q, H, g, kh, hd)] = from_f32<T>(a);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* positions, void* out, float* part_m,
           float* part_l, float* part_acc, int B, int Q, int H, int K, int hd,
           int bs, int nb, int cps, int n_split, int ring_len, int window,
           int local, float softcap, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(K, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, positions, part_m, part_l,
      part_acc, Q, H, K, hd, bs, nb, cps, ring_len, window, local, softcap,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto combine = paged_attention_combine_kernel<T>;
  const size_t wsmem = static_cast<size_t>(Q) * (H / K) * n_split *
                       sizeof(float);
  if (wsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(combine,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(wsmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine<<<dim3(K, B), kThreads, wsmem, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), Q, H, K, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it against
// the card's per-block limit before launching).
extern "C" size_t paged_attention_smem_bytes(int Q, int H, int K, int hd,
                                             int bs) {
  const size_t R = static_cast<size_t>(Q) * (H / K);
  return (2 * R * hd + 2 * static_cast<size_t>(bs) * hd + R * bs + 3 * R) *
             sizeof(float) +
         static_cast<size_t>(Q) * bs;
}

// dtype 0 = fp32, 1 = bf16 (q, pools and out share it); softcap <= 0 means
// none. The ring's nb chunks are cut into n_split groups of cps chunks;
// part_m/part_l hold B*K*n_split*R floats and part_acc B*K*n_split*R*hd
// (R = Q*H/K). Returns the CUDA error code after the launches (0 =
// success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* positions, void* out, void* part_m, void* part_l,
    void* part_acc, int B, int Q, int H, int K, int hd, int bs, int nb,
    int cps, int n_split, int ring_len, int window, int local, float softcap,
    float scale, int dtype, void* stream) {
  const size_t smem = paged_attention_smem_bytes(Q, H, K, hd, bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, positions, out, pm, pl, pa,
                         B, Q, H, K, hd, bs, nb, cps, n_split, ring_len,
                         window, local, softcap, scale, smem, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, positions, out, pm,
                               pl, pa, B, Q, H, K, hd, bs, nb, cps, n_split,
                               ring_len, window, local, softcap, scale, smem,
                               st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


if __name__ == "__main__":
    main()
