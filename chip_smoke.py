#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all started together);
  2. K1 (CADC matmul) against its plain version on the card at every
     gemma3-1b linear shape, M = 8 (decode), 256 and every prefill M of the
     main path (8 slots x each prompt bucket), fp32 (TF32 off) and bf16,
     relu and identity;
  3. K6 (paged attention) against its plain version: the main path's ring
     geometry (ring 160 under a 512 window, each covered-prefix table
     width it slices), longer local and global rings, -1 blocks, NaN-filled
     dead blocks, an idle slot, and enough slots that the ring is split
     into groups of several chunks;
  4. the main path: ServeEngine at full gemma3-1b width in bf16 with CADC
     linears and kernel_impl="auto" (8 slots, 16 Poisson requests, prompts
     <= 128, gen <= 32, block 16). Launch counts are zeroed just before it
     and read just after; both kernels must have run, exactly as often as
     the step counts say;
  5. one batched prefill and 4 decode steps at full width in fp32 (TF32
     off): kernel-path logits against plain-path logits, both paths fed
     the same tokens;
  6. kernel device times at the main path's decode shapes (CUDA events
     around the replay of a CUDA graph of calls whose operands rotate over
     copies that together exceed 3x the L2 cache, so every call finds its
     operands cold, as a decode step does) beside their plain versions, a
     library call where one computes the same function, and the bound from
     bytes and operations; plus the host-inclusive time per eager call, and
     the device busy time per decode step from torch.profiler.

Prints the serving metrics, the card's name and power limit, one JSON line
of kernel records and, last, {"ok": true, "device": {...}}.
`--report PATH` also writes the full record (per-shape times, ptxas
register counts, profiler breakdown) to PATH as JSON.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances (kernel vs plain version on the same card):
#   K1: fp32 psums on both sides, products of bf16 inputs exact in fp32;
#       only the summation order differs -> 1e-4 of the output's scale.
#   K6 fp32: online vs two-pass softmax, different summation order -> 2e-5
#       (the JAX package's paged-attention bound).
#   K6 bf16: both outputs round to bf16 (ulp 1.6e-2 on [2, 4)) and the
#       plain version rounds probabilities to bf16 before PV -> 3e-2.
#   Logits, fp32 full width: 1e-4 of the logits' scale (the fp32 forward
#       bound of the JAX package's kernel tests).
K1_RTOL = 1e-4
K6_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LOGITS_RTOL = 1e-4

# The main path (phase 4): engine geometry and Poisson workload.
N_SLOTS, MAX_LEN, BLOCK = 8, 160, 16
PROMPT_LEN, MAX_NEW = (64, 128), (16, 32)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def host_ms(fn, reps: int = 20) -> float:
    """Mean ms per fn() launched from Python, CUDA events around the loop:
    host launch cost included (what an eager caller pays)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def l2_bytes() -> int:
    props = torch.cuda.get_device_properties(0)
    return int(getattr(props, "L2_cache_size", 0) or 50 << 20)


def rotation(make, nbytes: int) -> list:
    """Copies of an operand set of `nbytes`, enough that together they hold
    3x the L2 cache: a graph that calls through all of them in turn finds
    every call's operands evicted, as a decode step that streams 1.5 GB of
    weights does."""
    return [make() for _ in range(max(2, math.ceil(3 * l2_bytes() / nbytes)))]


def device_ms(fn, reps: int = 20) -> float:
    """Mean device ms per fn(): `reps` calls captured in one CUDA graph and
    replayed, CUDA events around the replays — no host launch gaps. Callers
    that rotate operands pass reps >= the number of copies, so the graph
    touches every copy."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_kernels(report):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if log.is_file() else []
        report.setdefault("ptxas", {})[name] = lines
        for ln in lines:
            print(f"ptxas {name}: {ln}", flush=True)
    print(f"build: {sorted(libs)} in {report['build_s']:.1f} s", flush=True)


def linear_shapes(cfg):
    """(name, D padded to whole crossbars, N) of the seven CADC linears."""
    from repro_torch.core.cadc import num_segments

    xb = cfg.crossbar_size
    pad = lambda d: num_segments(d, xb) * xb  # noqa: E731
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    return [("wq", pad(d), hq), ("wk", pad(d), hkv), ("wv", pad(d), hkv),
            ("wo", pad(hq), d), ("w_gate", pad(d), cfg.d_ff),
            ("w_up", pad(d), cfg.d_ff), ("w_down", pad(cfg.d_ff), d)]


def k1_rows():
    """M of every K1 call on the main path: N_SLOTS at decode, N_SLOTS x the
    engine's prompt bucket at each batched prefill (rows are padded to the
    bucket, whatever the number admitted); plus 256, a mid size."""
    from repro_torch.serve.engine import _bucket

    lo, hi = PROMPT_LEN
    return sorted({N_SLOTS, 256} | {N_SLOTS * _bucket(p)
                                    for p in range(lo, hi + 1)})


def check_k1(cfg, dev, report):
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(1)
    xbar = cfg.crossbar_size
    worst, n_checks = 0.0, 0
    rows = k1_rows()
    for d, n in sorted({(d, n) for _, d, n in linear_shapes(cfg)}):
        for m in rows:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
                w = (torch.randn(d, n, generator=gen, device=dev)
                     / math.sqrt(d)).to(dtype)
                for fn in ("relu", "identity"):
                    got = cm.cadc_matmul_cuda(x, w, crossbar_size=xbar, fn=fn)
                    want = cm.cadc_matmul_torch(x, w, crossbar_size=xbar,
                                                fn=fn)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    tol = K1_RTOL * max(1.0, want.abs().max().item())
                    worst = max(worst, err)
                    n_checks += 1
                    if not err <= tol:
                        fail(f"K1 D={d} N={n} M={m} {dtype} {fn}: max abs "
                             f"err {err} > {tol}")
    report["k1_max_abs_err"] = worst
    print(f"K1 cadc_matmul: {n_checks} checks ok (M in {rows}), max abs err "
          f"{worst:.3e}", flush=True)


def k6_inputs(cfg, dev, dtype, *, kind, ring_len, nb, positions, gen,
              n_blocks=None):
    """q, pools, a fragmented table (trailing -1 past each slot's live
    blocks, an idle last slot) and positions for len(positions) slots."""
    b = len(positions)
    bs, h, kh, hd = 16, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_blocks = n_blocks or b * (ring_len // bs) + 4
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_blocks, bs, kh, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_blocks, bs, kh, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device=dev).cpu().numpy()
    tbl = np.full((b, ring_len // bs), -1, np.int32)
    take = 0
    for i, p in enumerate(positions[:-1]):
        live = min(-(-(p + 1) // bs), ring_len // bs)
        tbl[i, :live] = perm[take:take + live]
        take += live
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, kp, vp, tbl[:, :nb], pos


def main_path_k6_cases(cfg):
    """(kind, window, ring_len, table blocks, positions) of the main path's
    decode steps: rings of cache_len(kind, MAX_LEN) under the config's
    window, sliced to each covered-prefix width the engine's rule
    (PagedBackend.covered_blocks) gives for positions PROMPT_LEN[0] ..
    MAX_LEN - 1; N_SLOTS - 1 busy slots spread over the positions that
    width covers, and an idle last slot."""
    from repro_torch.models.lm.attention import cache_len

    cases = []
    for kind in ("local", "global"):
        ring = cache_len(cfg, kind, MAX_LEN)
        widths = set()
        for p in range(PROMPT_LEN[0], MAX_LEN):
            k = -(-min(p + 1, ring) // BLOCK)
            widths.add(min(1 << (k - 1).bit_length(), ring // BLOCK))
        for nb in sorted(widths):
            top = min(MAX_LEN, nb * BLOCK) - 1
            pos = np.linspace(PROMPT_LEN[0], top, N_SLOTS - 1).astype(int)
            cases.append((kind, cfg.local_window, ring, nb,
                          pos.tolist() + [0]))
    return cases


def check_k6(cfg, dev, report):
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    many = np.random.RandomState(2).randint(0, 2048, size=40).tolist()
    cases = main_path_k6_cases(cfg) + [
        ("local", 512, 512, 32, [3, 200, 511, 512, 700, 1023, 1500, 9]),
        ("local", 64, 128, 8, [3, 63, 64, 130, 300, 77, 127, 0]),
        ("global", 512, 160, 4, [0, 10, 33, 40, 50, 60, 63, 2]),  # warm-up
        ("local", 512, 512, 32, many),  # 40 slots: groups of 5 chunks
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for kind, window, ring, nb, positions in cases:
            q, kp, vp, tbl, pos = k6_inputs(cfg, dev, dtype, kind=kind,
                                            ring_len=ring, nb=nb,
                                            positions=positions, gen=gen)
            t = torch.as_tensor(tbl, device=dev)
            kw = dict(kind=kind, window=window, ring_len=ring)
            got = pa.paged_attention_cuda(q, kp, vp, t, pos, **kw)
            want = pa.paged_attention_torch(q, kp, vp, t, pos, **kw)
            # NaN in every block no live entry of this case can read
            dirty_k, dirty_v = kp.clone(), vp.clone()
            idx = torch.arange(ring, device=dev)
            valid = pa._ring_mask(pos, idx, kind=kind, ring_len=ring,
                                  window=window, q_len=1)[:, 0].cpu()
            read = set()
            for i in range(len(positions)):
                for c in range(nb):
                    if tbl[i, c] >= 0 and bool(valid[i, c * 16:(c + 1) * 16].any()):
                        read.add(int(tbl[i, c]))
            dead = [j for j in range(kp.shape[0]) if j not in read]
            dirty_k[dead] = float("nan")
            dirty_v[dead] = float("nan")
            # ... and in every masked entry of the blocks that are read
            for i in range(len(positions)):
                for c in range(nb):
                    if int(tbl[i, c]) in read:
                        off = (~valid[i, c * 16:(c + 1) * 16]).nonzero()[:, 0]
                        off = off.to(dev)
                        dirty_k[int(tbl[i, c]), off] = float("nan")
                        dirty_v[int(tbl[i, c]), off] = float("nan")
            dirty = pa.paged_attention_cuda(q, dirty_k, dirty_v, t, pos, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            tag = (f"K6 {kind} window={window} ring={ring} nb={nb} "
                   f"B={len(positions)} {dtype}")
            if not err <= K6_TOL[dtype]:
                fail(f"{tag}: max abs err {err} > {K6_TOL[dtype]}")
            if not torch.equal(dirty, got) or torch.isnan(dirty).any():
                fail(f"{tag}: NaN garbage in dead blocks changed the output")
            if not torch.equal(got[-1], torch.zeros_like(got[-1])):
                fail(f"{tag}: idle slot (all -1) is not exactly 0")
    report["k6_max_abs_err"] = worst
    report["k6_cases"] = [c[:4] + (len(c[4]),) for c in cases]
    print(f"K6 paged_attention: {2 * len(cases)} cases ok (main path "
          f"{[c[:4] for c in main_path_k6_cases(cfg)]}; NaN garbage, idle "
          f"slot, covered prefix, 40 slots), max abs err {worst:.3e}",
          flush=True)


def serve_main_path(cfg, params, dev, report):
    """The main path: the engine at full width; returns launch counts."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import EngineConfig, ServeEngine, poisson_workload

    ecfg = EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN, block_size=BLOCK)
    engine = ServeEngine(cfg, params, ecfg, device=dev)
    warm = poisson_workload(n_requests=2, rate=1.0, vocab_size=cfg.vocab_size,
                            prompt_len=(16, 32), max_new=(2, 4), seed=99)
    engine.run(warm)
    engine.reset_metrics()
    workload = poisson_workload(n_requests=16, rate=0.5,
                                vocab_size=cfg.vocab_size,
                                prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                                seed=0)
    torch.cuda.synchronize()
    cm.cadc_matmul_cuda.launches = 0
    pa.paged_attention_cuda.launches = 0
    t0 = time.perf_counter()
    summary = engine.run(workload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cadc_matmul": cm.cadc_matmul_cuda.launches,
                "paged_attention": pa.paged_attention_cuda.launches}

    n_dec = len(engine.telemetry.step_s)
    n_pre = len(engine.telemetry.prefill_s)
    if summary["requests_finished"] != len(workload):
        fail(f"{summary['requests_finished']}/{len(workload)} requests "
             "finished")
    for (_, _, g), rid in zip(workload, sorted(engine.results)):
        toks = engine.results[rid].tokens
        if len(toks) != g or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: {len(toks)} tokens (want {g}) or a token "
                 "outside the vocabulary")
    want = {"cadc_matmul": 7 * cfg.n_layers * (n_dec + n_pre),
            "paged_attention": cfg.n_layers * n_dec}
    for name, n in launches.items():
        if n <= 0 or n != want[name]:
            fail(f"{name} launched {n} times on the main path, want "
                 f"{want[name]} ({n_dec} decode steps, {n_pre} prefills)")
    print(f"serve gemma3-1b full width bf16 cadc: {len(workload)} requests, "
          f"{summary['decode_tokens']} decode tokens, {n_dec} decode steps, "
          f"{n_pre} prefills, {wall:.2f} s", flush=True)
    print(f"tok/s {summary['tokens_per_s']:.1f}", flush=True)
    print(f"step ms p50 {summary['step_ms_p50']:.3f} p99 "
          f"{summary['step_ms_p99']:.3f}", flush=True)
    print(f"TTFT ms p50 {summary['ttft_ms_p50']:.3f} p99 "
          f"{summary['ttft_ms_p99']:.3f}", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    report["serve"] = {k: summary[k] for k in (
        "tokens_per_s", "tokens_per_s_p50", "step_ms_p50", "step_ms_p99",
        "ttft_ms_p50", "ttft_ms_p99", "prefill_ms_p50", "decode_tokens")}
    report["serve"].update(decode_steps=n_dec, prefills=n_pre, wall_s=wall,
                           launches=launches)
    profile_decode(engine, cfg, report)
    return launches


def profile_decode(engine, cfg, report) -> None:
    """Device busy time per decode step with every slot busy: torch.profiler
    (CUPTI) over 8 pure decode steps, summing the device-side events. A
    diagnostic: if the profiler cannot trace here, it is recorded as not
    measured and the run goes on."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(7)
    for _ in range(engine.ecfg.n_slots):
        engine.submit(rng.randint(0, cfg.vocab_size, size=96).astype(np.int32),
                      12)
    engine.step()  # admission, batched prefill, first decode step
    n_steps = 8
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            rows.append((us, e.key, e.count))
    except Exception as e:  # diagnostic only: keep the smoke run going
        print(f"profiler: not measured ({e!r})", file=sys.stderr)
        report["serve"]["device_busy_ms_per_step"] = f"not measured: {e!r}"
        engine.run()
        return
    engine.run()  # drain
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / n_steps
    report["serve"]["device_busy_ms_per_step"] = busy if rows else \
        "not measured: the profiler saw no device events"
    report["serve"]["device_top_per_step"] = [
        {"name": k[:90], "ms": us / 1e3 / n_steps, "calls": c / n_steps}
        for us, k, c in rows[:12]]
    print(f"profiler: device busy per decode step: "
          f"{report['serve']['device_busy_ms_per_step']} ms (8 slots busy, "
          f"{n_steps} steps)", flush=True)


def fp32_logits_check(cfg, params, dev, report):
    """One batched prefill + 4 decode steps, kernel path vs plain path, fed
    the same tokens (the plain path's greedy picks)."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.serve.backends import PagedBackend
    from repro_torch.serve.blocks import BlockTables

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, max_len = 4, 128
    rng = np.random.RandomState(5)
    lengths = np.array([97, 64, 40, 120], np.int32)
    tokens = np.zeros((n, 128), np.int64)
    for i, length in enumerate(lengths):
        tokens[i, :length] = rng.randint(0, cfg.vocab_size, size=length)
    slot_ids = np.arange(n, dtype=np.int32)

    def run(path_cfg, feed):
        backend = PagedBackend(path_cfg, n, max_len, 16, dev)
        caches = backend.init_caches()
        tables = BlockTables(n, backend.blocks_per_slot, backend.n_blocks)
        for s in range(n):
            tables.assign(s)
        dev_tables = {k: torch.as_tensor(v, device=dev)
                      for k, v in tables.tables.items()}
        p = steps_lib.cast_compute(params, path_cfg)
        first, last, contribs = steps_lib.make_batched_prefill_step(path_cfg)(
            p, {"tokens": torch.as_tensor(tokens, device=dev)},
            torch.as_tensor(lengths, device=dev))
        backend.write_prefill(caches, contribs, slot_ids, lengths,
                              tables.tables)
        logits, picks = [last], [first]
        pos = torch.as_tensor(lengths.astype(np.int64), device=dev)
        for step in range(4):
            tok = (feed[step] if feed is not None else picks[-1]).long()
            nxt, lg = backend.decode(p, caches, dev_tables, tok, pos)
            logits.append(lg)
            picks.append(nxt)
            pos = pos + 1
        return logits, picks

    plain_cfg = cfg.with_overrides(dtype="float32", kernel_impl="torch",
                                   paged_attn_impl="torch")
    kern_cfg = cfg.with_overrides(dtype="float32", kernel_impl="auto",
                                  paged_attn_impl="auto")

    def counted(path_cfg, feed):
        cm.cadc_matmul_cuda.launches = 0
        pa.paged_attention_cuda.launches = 0
        out = run(path_cfg, feed)
        torch.cuda.synchronize()
        return out, (cm.cadc_matmul_cuda.launches,
                     pa.paged_attention_cuda.launches)

    (want, picks), n_plain = counted(plain_cfg, None)
    (got, kpicks), n_kern = counted(kern_cfg, picks)
    # the plain path launches no kernel; the kernel path launches K1 for
    # every linear of the prefill and of the 4 decode steps, and K6 for
    # every layer of each decode step
    for name, seen, need in (
            ("plain", n_plain, (0, 0)),
            ("kernel", n_kern, (7 * cfg.n_layers * 5, cfg.n_layers * 4))):
        if seen != need:
            fail(f"fp32 {name} path launched (cadc_matmul, paged_attention)"
                 f" = {seen}, want {need}")
    worst_rel = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        worst_rel = max(worst_rel, err / scale)
        if not torch.isfinite(g).all() or not err <= LOGITS_RTOL * scale:
            fail(f"fp32 logits step {step}: max abs err {err} > "
                 f"{LOGITS_RTOL} x {scale}")
    same = sum(bool(torch.equal(a, b)) for a, b in zip(picks, kpicks))
    report["fp32_logits"] = {"max_err_over_scale": worst_rel,
                             "greedy_steps_equal": same,
                             "steps": len(picks), "launches": n_kern}
    print(f"fp32 full width: prefill + 4 decode steps, kernel vs plain "
          f"logits max err / scale {worst_rel:.3e} (tol {LOGITS_RTOL}); "
          f"greedy picks equal on {same}/{len(picks)} steps", flush=True)


def time_k1(cfg, dev, launches, report):
    """One decode step's K1 work: the seven linears at M = 8 slots, bf16,
    relu, x 26 layers. Weights rotate over copies that hold 3x the L2
    cache, as in a real step that streams 1.5 GB of weights."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(3)
    m, dt, xbar = 8, torch.bfloat16, cfg.crossbar_size
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "ops": 0.0}
    per_shape = {}
    for name, d, n in linear_shapes(cfg):
        x = torch.randn(m, d, generator=gen, device=dev).to(dt)
        ws = rotation(lambda: (torch.randn(d, n, generator=gen, device=dev)
                               / math.sqrt(d)).to(dt), d * n * 2)
        reps = max(20, len(ws))
        pick = itertools.cycle(ws).__next__
        saved = cm.cadc_matmul_cuda.launches
        kernel = lambda: cm.cadc_matmul_cuda(x, pick(), crossbar_size=xbar,  # noqa: E731
                                             fn="relu")
        k = device_ms(kernel, reps)
        k_host = host_ms(kernel)
        cm.cadc_matmul_cuda.launches = saved   # comparison launches
        p = device_ms(lambda: cm.cadc_matmul_torch(x, pick(), crossbar_size=xbar,
                                                   fn="relu"), reps)
        lib = device_ms(lambda: torch.matmul(x, pick()), reps)
        nbytes = m * d * 2 + d * n * 2 + m * n * 4
        per_shape[name] = {"D": d, "N": n, "copies": len(ws),
                           "ms": k, "host_ms": k_host,
                           "plain_ms": p, "matmul_ms": lib,
                           "bound_ms": bound_ms(nbytes, 2 * m * d * n, dt)[0]}
        tot["ms"] += k
        tot["plain"] += p
        tot["lib"] += lib
        tot["bytes"] += nbytes
        tot["ops"] += 2 * m * d * n
        del ws
    layers = cfg.n_layers
    b_ms, b_by = bound_ms(tot["bytes"] * layers, tot["ops"] * layers, dt)
    # prefill-sized M (8 slots x a 128-token bucket) at the w_gate shape
    m_pre, (_, d_g, n_g) = 1024, linear_shapes(cfg)[4]
    xp = torch.randn(m_pre, d_g, generator=gen, device=dev).to(dt)
    wps = rotation(lambda: (torch.randn(d_g, n_g, generator=gen, device=dev)
                            / math.sqrt(d_g)).to(dt), d_g * n_g * 2)
    pick = itertools.cycle(wps).__next__
    saved = cm.cadc_matmul_cuda.launches
    pre_ms = device_ms(lambda: cm.cadc_matmul_cuda(xp, pick(),
                                                   crossbar_size=xbar,
                                                   fn="relu"), len(wps))
    cm.cadc_matmul_cuda.launches = saved
    del wps
    report["k1_timing"] = {
        "unit": "one decode step: 7 linears x 26 layers, M=8, bf16, relu",
        "l2_bytes": l2_bytes(),
        "per_shape_one_call": per_shape,
        "matmul_ms_per_step": tot["lib"] * layers,
        "prefill_w_gate_M1024_ms": pre_ms,
        "prefill_w_gate_M1024_bound_ms": bound_ms(
            m_pre * d_g * 2 + d_g * n_g * 2 + m_pre * n_g * 4,
            2 * m_pre * d_g * n_g, dt)[0],
    }
    return {"name": "cadc_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/cadc_matmul.cu",
            "replaces": "src/repro/kernels/cadc_matmul.py:188",
            "launches": launches["cadc_matmul"],
            "max_abs_err": report["k1_max_abs_err"],
            "ms": tot["ms"] * layers, "plain_ms": tot["plain"] * layers,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def time_k6(cfg, dev, launches, report):
    """One decode step's K6 work at the main path's geometry: 8 slots at
    positions 64..159 of a 160-entry ring (10 blocks of 16), bf16; 22
    local + 4 global layers. Pools (and SDPA's gathered K/V) rotate over
    copies that hold 3x the L2 cache."""
    from repro_torch.kernels import paged_attention as pa
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    dt, bs, ring = torch.bfloat16, BLOCK, MAX_LEN
    nb = ring // bs
    positions = [64, 77, 90, 101, 118, 131, 147, 159]
    kinds = list(cfg.pattern_for_layers)
    per_kind = {}
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "ops": 0.0}
    for kind in ("local", "global"):
        n_layers = kinds.count(kind)
        q, kp, vp, tbl, pos = k6_inputs(cfg, dev, dt, kind=kind,
                                        ring_len=ring, nb=nb,
                                        positions=positions + [0], gen=gen)
        q, tbl, pos = q[:8], torch.as_tensor(tbl[:8], device=dev), pos[:8]
        pools = rotation(lambda: (kp.clone(), vp.clone()),
                         kp.numel() * 2 * 2)
        reps = max(20, len(pools))
        pick = itertools.cycle(pools).__next__
        kw = dict(kind=kind, window=cfg.local_window, ring_len=ring)
        saved = pa.paged_attention_cuda.launches
        kernel = lambda: pa.paged_attention_cuda(q, *pick(), tbl, pos, **kw)  # noqa: E731
        k = device_ms(kernel, reps)
        k_host = host_ms(kernel)
        pa.paged_attention_cuda.launches = saved
        p = device_ms(lambda: pa.paged_attention_torch(q, *pick(), tbl, pos,
                                                       **kw), reps)
        # library yardstick: SDPA over the slots' K/V already gathered into
        # the dense ring layout (the gather itself is not timed)
        valid = pa._ring_mask(pos, torch.arange(ring, device=dev), kind=kind,
                              ring_len=ring, window=cfg.local_window,
                              q_len=1)[:, 0]
        kd = kp[tbl.clamp(min=0).long()].reshape(8, ring, -1)
        vd = vp[tbl.clamp(min=0).long()].reshape(8, ring, -1)
        qs = q[:, 0].unsqueeze(2)                              # [B, H, 1, hd]
        mask = valid[:, None, None, :]
        gathered = rotation(lambda: tuple(
            t.clone().unsqueeze(1).expand(-1, cfg.n_heads, -1, -1)
            for t in (kd, vd)), kd.numel() * 2 * 2)
        pick_kv = itertools.cycle(gathered).__next__
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qs, *pick_kv(), attn_mask=mask), max(20, len(gathered)))
        live_entries = int(valid.sum())
        live_chunks = sum(bool(valid[i, c * bs:(c + 1) * bs].any())
                          for i in range(8) for c in range(nb))
        hd, h = cfg.head_dim, cfg.n_heads
        nbytes = (8 * h * hd * 2 * 2 + live_chunks * bs * hd * 2 * 2
                  + tbl.numel() * 4 + 8 * 4)
        ops = 4 * h * live_entries * hd
        per_kind[kind] = {"layers": n_layers, "ms": k, "host_ms": k_host,
                          "plain_ms": p,
                          "sdpa_ms": lib, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, ops, dt)[0]}
        tot["ms"] += k * n_layers
        tot["plain"] += p * n_layers
        tot["lib"] += lib * n_layers
        tot["bytes"] += nbytes * n_layers
        tot["ops"] += ops * n_layers
        del pools, gathered
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], dt)
    report["k6_timing"] = {
        "unit": f"one decode step: {len(kinds)} layers "
                f"({kinds.count('local')} local + {kinds.count('global')} "
                "global), 8 slots, bf16, ring 160 (10 blocks of 16), "
                "positions 64..159",
        "per_kind_one_call": per_kind,
        "library": "scaled_dot_product_attention over pre-gathered K/V"}
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:168",
            "launches": launches["paged_attention"],
            "max_abs_err": report["k6_max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tot["lib"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default=None,
                    help="also write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.models.lm import transformer as tf
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py ({e})")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    build_kernels(report)
    cfg = get_config("gemma3_1b").with_overrides(linear_impl="cadc",
                                                 kernel_impl="auto")
    check_k1(cfg, dev, report)
    check_k6(cfg, dev, report)

    params = tf.init(cfg, seed=0, device=dev)        # fp32, random weights
    launches = serve_main_path(cfg, params, dev, report)
    fp32_logits_check(cfg, params, dev, report)
    del params
    torch.cuda.empty_cache()

    kernels = [time_k1(cfg, dev, launches, report),
               time_k6(cfg, dev, launches, report)]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    report["nvidia_smi"] = card
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
