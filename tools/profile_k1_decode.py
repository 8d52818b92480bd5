#!/usr/bin/env python3
"""Where K1's decode time goes, on one card.

    python3 tools/profile_k1_decode.py [--out PATH]

At each gemma3-1b decode shape (the seven CADC linears at M = 8 slots, bf16,
relu, crossbar 256) it times, in one process:

  planned      K1 as shipped (`cadc_matmul_cuda`: the stream kernel under
               `plan_fwd`'s plan);
  strip4/8     the stream kernel forced to 4 or 8 vectors a strip;
  no_pdl       a copy launched without programmatic dependent launch;
  no_sum       a copy without the ordered segment sum (timing only: its
               output is not y);
  no_epilogue  a copy that stops after the weight stream (timing only);
  read_only    a kernel that only streams w with the stream kernel's
               mapping (128 threads, 8 sixteen-byte loads a thread in
               flight): the bytes' ceiling for this access pattern;
  matmul       torch.matmul of the same x and w (the vConv yardstick).

The copies are csrc/cadc_matmul.cu with one edit each, written and built
under build/k1_profile/. Every time is chip_smoke.device_ms: a CUDA graph
of calls whose weights rotate over copies holding 3x the L2, so each call
finds its weights cold, as a decode step does. Prints one line a shape,
the sums over a decode step (x 26 layers) and, last, the card's name and
power limit; --out writes the record as JSON. Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

VARIANTS = ("no_pdl", "no_sum", "no_epilogue")
READ_ONLY = r"""
template <int kLanes>
__global__ void __launch_bounds__(128) read_only_kernel(
    const uint4* __restrict__ w, int row_vecs, int xbar, unsigned* out) {
  constexpr int kGroups = 128 / kLanes, kB = 8;
  const int c = blockIdx.x * kLanes + threadIdx.x % kLanes;
  const uint4* wp = w + static_cast<size_t>(blockIdx.z) * xbar * row_vecs + c;
  unsigned a = 0;
  for (int k0 = threadIdx.x / kLanes; k0 < xbar; k0 += kB * kGroups) {
    uint4 v[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int k = k0 + b * kGroups;
      v[b] = k < xbar && c < row_vecs
                 ? __ldg(wp + static_cast<size_t>(k) * row_vecs)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) a ^= v[b].x ^ v[b].y ^ v[b].z ^ v[b].w;
  }
  if (a == 0x9e3779b9u) out[threadIdx.x] = a;  // keeps the loads alive
}
"""


def variant_source(src: str) -> str:
    """csrc/cadc_matmul.cu's kernels, once per variant (each in its own
    namespace), plus the read-only kernel and two C entry points."""
    head = src[:src.index("namespace {")]
    body = src[src.index("namespace {"):src.index("template <typename T>\nint "
                                                  "stream_by_lanes(")]
    body = body.replace("namespace {", "", 1)
    cut = "  // The row groups of a warp: a reduce-scatter"
    edits = {
        "no_pdl": ("constexpr int kStreamPdl = 1;",
                   "constexpr int kStreamPdl = 0;"),
        "no_sum": ("  if (scratch)\n    cadc::ordered_segment_sum",
                   "  if (false)\n    cadc::ordered_segment_sum"),
        "no_epilogue": (cut, "  if (acc[0] == 1234.5f) y[threadIdx.x] = "
                             "acc[RV - 1];\n  return;\n" + cut),
    }
    tile_h = os.path.join(REPO, "src", "repro_torch", "csrc",
                          "cadc_tile.cuh")
    parts = [head.replace('#include "cadc_tile.cuh"',
                          f'#include "{tile_h}"'), READ_ONLY]
    entry = []
    for i, name in enumerate(VARIANTS):
        old, new = edits[name]
        assert old in body, name
        v = body.replace(old, new)
        parts.append(f"namespace v{i} {{\n{v}\n}}  // namespace v{i}\n")
        for lanes in (4, 8):
            entry.append(
                f"  if (variant == {i} && lanes == {lanes}) return "
                f"v{i}::launch_stream<__nv_bfloat16, {lanes}>(x, w, y, "
                f"static_cast<float*>(scratch), static_cast<int*>(counters), "
                f"M, N, S, xbar, 1, st);")
    parts.append(
        'extern "C" int k1v_launch(int variant, int lanes, const void* x, '
        "const void* w, void* y, void* scratch, void* counters, int M, "
        "int N, int S, int xbar, void* stream) {\n"
        "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n"
        + "\n".join(entry) + "\n  return 1;\n}\n"
        'extern "C" int k1v_read_only(int lanes, const void* w, void* out, '
        "int N, int S, int xbar, void* stream) {\n"
        "  const int rv = N / 8;\n"
        "  const dim3 grid((rv + lanes - 1) / lanes, 1, S);\n"
        "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n"
        "  if (lanes == 4) read_only_kernel<4><<<grid, 128, 0, st>>>("
        "static_cast<const uint4*>(w), rv, xbar, static_cast<unsigned*>(out));\n"
        "  else read_only_kernel<8><<<grid, 128, 0, st>>>("
        "static_cast<const uint4*>(w), rv, xbar, static_cast<unsigned*>(out));\n"
        "  return static_cast<int>(cudaGetLastError());\n}\n")
    return "".join(parts)


def build(out_dir: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "cadc_matmul.cu")) as f:
        code = variant_source(f.read())
    cu = os.path.join(out_dir, "k1_variants.cu")
    so = os.path.join(out_dir, "k1_variants.so")
    with open(cu, "w") as f:
        f.write(code)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.k1v_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.k1v_read_only.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_k1_decode: needs a GPU")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import cadc_matmul as cm

    lib = build(os.path.join(REPO, "build", "k1_profile"))
    dev = torch.device("cuda", 0)
    cfg = get_config("gemma3_1b")
    xbar, m, layers = cfg.crossbar_size, 8, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(3)
    counters = cm._counters(dev)
    junk = torch.empty(1024, dtype=torch.int32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    record, step = {}, {}
    for name, d, n in cs.linear_shapes(cfg):
        s = d // xbar
        x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
        ws = cs.rotation(lambda: (torch.randn(d, n, generator=gen, device=dev)
                                  / math.sqrt(d)).to(torch.bfloat16), d * n * 2)
        reps = max(20, len(ws))
        pick = itertools.cycle(ws).__next__
        plan = cm.plan_fwd(m, n, s, xbar, vec=8)

        def variant(i, lanes):
            def call():
                y = torch.empty(m, n, device=dev)
                scr = torch.empty(s, m, n, device=dev)
                code = lib.k1v_launch(i, lanes, x.data_ptr(), pick().data_ptr(),
                                      y.data_ptr(), scr.data_ptr(),
                                      counters.data_ptr(), m, n, s, xbar,
                                      stream())
                if code:
                    raise RuntimeError(f"k1v_launch: CUDA error {code}")
            return call

        row = {"D": d, "N": n, "plan": f"{plan.kernel} {plan.width} "
                                      f"grid={plan.grid}"}
        row["planned"] = cs.device_ms(lambda: cm.cadc_matmul_cuda(
            x, pick(), crossbar_size=xbar, fn="relu"), reps)
        for lanes in (4, 8):
            forced = cm.plan_fwd(m, n, s, xbar, vec=8,
                                 _force=("stream", lanes, True))
            row[f"strip{lanes}"] = cs.device_ms(lambda: cm._fwd_launch(
                x, pick(), xbar, "relu", "none", plan=forced), reps)
        for i, vname in enumerate(VARIANTS):
            row[vname] = cs.device_ms(variant(i, plan.width), reps)
        row["read_only"] = cs.device_ms(lambda: lib.k1v_read_only(
            plan.width, pick().data_ptr(), junk.data_ptr(), n, s, xbar,
            stream()), reps)
        row["matmul"] = cs.device_ms(lambda: torch.matmul(x, pick()), reps)
        row["bound"] = (m * d * 2 + d * n * 2 + m * n * 4) / cs.HBM_BYTES_PER_S * 1e3
        if int(counters.abs().sum()):
            sys.exit("arrival counters not zero after the runs")
        record[name] = row
        for k, v in row.items():
            if isinstance(v, float):
                step[k] = step.get(k, 0.0) + v * layers
        print(name, json.dumps({k: (round(v * 1e3, 2) if isinstance(v, float)
                                    else v) for k, v in row.items()}),
              "(us)", flush=True)
        del ws
    print("per decode step (ms, x%d layers):" % layers,
          json.dumps({k: round(v, 4) for k, v in step.items()}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "per_call_ms": record,
                       "per_step_ms": step}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
