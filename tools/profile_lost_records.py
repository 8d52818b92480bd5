#!/usr/bin/env python3
"""How many kernel records torch.profiler loses over a decode step window.

    python3 tools/profile_lost_records.py [--reps 3] [--steps 8]

Serves qwen2-moe-a2.7b at full width and recurrentgemma-9b at
chip_smoke.py's REC_LAYERS depth (random bf16 weights, CADC relu at
crossbar 256, 8 slots) with chip_smoke.py's profiler ranges on, and for
each variant of the window takes --reps windows of --steps decode steps
in a row: the K1 and K6 launches the wrappers count against the ones the
profiler reports, and the profiler's kernel total. Variants: as
chip_smoke.py's decode profile did before PR 22 (no synchronize before
the window, CPU and CUDA activity), a synchronize before the window, CUDA
activity alone, and 0.2 s of idle host time at both ends inside the
window. Prints one JSON line a window. Needs a GPU; builds the kernels
first.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"no sync, CPU + CUDA": (False, True, 0.0),
            "sync, CPU + CUDA": (True, True, 0.0),
            "sync, CUDA only": (True, False, 0.0),
            "sync, CPU + CUDA, 0.2 s pads": (True, True, 0.2)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_lost_records: needs a GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "src"))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.lm import transformer as tf
    from repro_torch.serve import EngineConfig, ServeEngine

    with contextlib.redirect_stdout(io.StringIO()):
        cs.build_kernels({})
    dev = torch.device("cuda", 0)
    for arch, spans in ((cs.MOE_ARCH, cs.moe_spans),
                        (cs.RG_ARCH, cs.rec_spans)):
        cfg = cs.slice5_cfg(arch, **({"n_layers": cs.REC_LAYERS[arch]}
                                     if arch in cs.REC_LAYERS else {}))
        params = tf.init(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        engine = ServeEngine(cfg, params, EngineConfig(
            n_slots=cs.N_SLOTS, max_len=cs.MAX_LEN, block_size=cs.BLOCK),
            device=dev)
        rng = np.random.RandomState(7)
        windows = len(VARIANTS) * args.reps
        for _ in range(cs.N_SLOTS):
            engine.submit(rng.randint(0, cfg.vocab_size, size=16).astype(
                np.int32), windows * args.steps + 2)
        engine.step()
        restore = spans()
        try:
            for name, (sync, cpu, pad) in VARIANTS.items():
                for rep in range(args.reps):
                    if sync:
                        torch.cuda.synchronize()
                    k1 = cm.cadc_matmul_cuda.launches
                    k6 = pa.paged_attention_cuda.launches
                    acts = ([ProfilerActivity.CUDA]
                            + ([ProfilerActivity.CPU] if cpu else []))
                    with profile(activities=acts) as prof:
                        time.sleep(pad)
                        for _ in range(args.steps):
                            engine.step()
                        torch.cuda.synchronize()
                        time.sleep(pad)
                    seen = {"K1": 0, "K6": 0, "total": 0}
                    for e in prof.key_averages():
                        if ("CUDA" not in str(getattr(e, "device_type", ""))
                                or e.key in cs.MOE_SPANS + cs.REC_SPANS):
                            continue
                        seen["total"] += e.count
                        if "paged_attention" in e.key:
                            seen["K6"] += e.count
                        elif "stream_kernel" in e.key or "RowMajor" in e.key:
                            seen["K1"] += e.count
                    print(json.dumps({
                        "arch": cfg.name, "variant": name, "rep": rep,
                        "counted": {"K1": cm.cadc_matmul_cuda.launches - k1,
                                    "K6": pa.paged_attention_cuda.launches
                                    - k6},
                        "profiled": seen}), flush=True)
        finally:
            restore()
        del engine, params
        torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
