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

Slice 2, CNN training (fp32, TF32 off):
  7. K1g / K2 against their plain versions at every FC shape of LeNet-5
     and ResNet-18's fc, M = 64 and 128, xbar 64 / 128 / 256, relu /
     identity / sublinear, all four save_gate modes; dw bitwise equal
     across two runs; recompute bitwise equal to the forward's saved gate;
  8. K3 (forward, gate) and the conv backward (K2 over im2col patches +
     _col2im) against their plain versions at every conv shape of both
     models at the paths' batches (stride 1 and 2, SAME and VALID, 1x1
     projections, Cin 1 and 3, segments spanning taps), xbar 64/128/256;
  9. the LeNet-5 path: repro_torch.launch.train_cnn_cadc (vConv and CADC,
     20 steps each, batch 64) with exact launch counts of K1, K1g, K2, K3;
 10. training parity at full width, both models: kernel path against
     plain path from the same params and batches — step-0 loss, every
     gradient, 3 sgd steps' losses; the plain path launches nothing;
 11. the slice's main path: ResNet-18 at width 64 (11.2 M params) trained
     through train.loop.train on the CIFAR-10 proxy, batch 128, CADC relu
     at crossbar 64 then vConv, 5 steps each, exact launch counts; then
     its train step ms p50, images/s, peak memory, and torch.profiler's
     device time per kernel per step and the card's idle share;
 12. K1g, K2 and K3 device times per ResNet-18 train step (and at
     LeNet-5's shapes) beside their plain versions, the vConv PyTorch call
     at the same shapes and the bound.

Prints the serving and training metrics, the card's name and power limit,
one JSON line of kernel records and, last, {"ok": true, "device": {...}}.
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


# ---------------------------------------------------------------------------
# slice 2: CNN training through K1g, K2 and K3
# ---------------------------------------------------------------------------

XBARS = (64, 128, 256)
# Tolerances of slice 2 (kernel vs plain version on the same card, fp32,
# TF32 off): outputs and gradients within TRAIN_RTOL of their tensor's
# scale (the JAX package's TOL; only the fp32 summation order differs);
# gate bits equal wherever |psum| > GATE_NEAR x the output's scale (nearer
# 0 the sign of a psum can differ with the summation order, so those
# mismatches are counted and printed, not failed); fp32 gates of curved
# fns within TRAIN_RTOL where |psum| > 1e-2 (f'(p) amplifies the psum's
# rounding by |f''(p)|, p^-1.5 / 4 for sublinear). Training parity: step-0
# loss within LOSS0_RTOL, 3 sgd steps' losses within TRAIN_RTOL, relative.
TRAIN_RTOL = 1e-4
GATE_NEAR = 1e-5
LOSS0_RTOL = 1e-5
LENET_BATCH, RESNET_BATCH, RESNET_WIDTH = 64, 128, 64
LENET_STEPS, RESNET_STEPS = 20, 5
# The data of the paths: the MNIST proxy of examples/train_cnn_cadc.py and
# the CIFAR-10 proxy of benchmarks/common.py.
MNIST = dict(n_classes=10, hw=28, channels=1, noise=0.8)
CIFAR = dict(n_classes=10, hw=32, channels=3, noise=0.9, seed=1)


def counters():
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    return {"cadc_matmul": cm.cadc_matmul_cuda,
            "cadc_matmul_gate": cm.cadc_matmul_gate_cuda,
            "cadc_segmented_bwd": cm.cadc_segmented_bwd_cuda,
            "cadc_conv2d": cc.cadc_conv2d_cuda}


def zero_counts() -> None:
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: f.launches for k, f in counters().items()}


def keep_counts(fn):
    """Run fn() without touching the launch counts (comparison launches)."""
    saved = {k: f.launches for k, f in counters().items()}
    out = fn()
    for k, f in counters().items():
        f.launches = saved[k]
    return out


def rel_err(got, want) -> tuple:
    """(max abs err / scale, scale) with scale = max(1, max |want|)."""
    scale = max(1.0, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / scale, scale


# max abs err of each slice-2 kernel over its checks (the kernels line)
MAX_ABS = {"k1g": 0.0, "k2": 0.0, "k3": 0.0}


def track(key: str, got, want) -> float:
    """Record the max abs err of a kernel check; return err / scale."""
    err, scale = rel_err(got, want)
    MAX_ABS[key] = max(MAX_ABS[key], err * scale)
    return err


def fc_shapes():
    """(name, D, N) of LeNet-5's FC layers and ResNet-18's fc."""
    return [("lenet.f1", 400, 120), ("lenet.f2", 120, 84),
            ("lenet.f3", 84, 10), ("resnet.fc", 8 * RESNET_WIDTH, 10)]


def conv_layers(model: str):
    """(name, B, H, Cin, K, Cout, stride, padding) of every conv of the
    model, in forward order, at the path's batch and width."""
    if model == "lenet5":
        b = LENET_BATCH
        return [("c1", b, 32, 1, 5, 6, 1, "VALID"),
                ("c2", b, 14, 6, 5, 16, 1, "VALID")]
    b, w = RESNET_BATCH, RESNET_WIDTH
    out = [("stem", b, 32, 3, 3, w, 1, "SAME")]
    h, cin = 32, w
    for si, cout in enumerate((w, 2 * w, 4 * w, 8 * w)):
        for bi in range(2):
            s = 2 if (si > 0 and bi == 0) else 1
            out.append((f"s{si}b{bi}.conv1", b, h, cin, 3, cout, s, "SAME"))
            ho = -(-h // s)
            out.append((f"s{si}b{bi}.conv2", b, ho, cout, 3, cout, 1,
                        "SAME"))
            if s != 1 or cin != cout:
                out.append((f"s{si}b{bi}.proj", b, h, cin, 1, cout, s,
                            "SAME"))
            h, cin = ho, cout
    return out


def conv_out_hw(h, k, stride, padding) -> int:
    from repro_torch.core.conv import _norm_padding

    (lo, hi), _ = _norm_padding(padding, (k, k), (1, 1))
    return (h + lo + hi - k) // stride + 1


def check_k1g_k2(dev, report):
    """K1g (and K1 where a mode saves nothing) and K2 against their plain
    versions at every FC shape of the path, M = 64 and 128, xbar 64 / 128 /
    256, relu / identity / sublinear, all four save_gate modes."""
    from repro_torch.core import dendritic
    from repro_torch.core.cadc import pad_to_segments
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    n_checks = near_mismatch = 0
    for name, d, n in fc_shapes():
        for m in (64, 128):
            for xbar in XBARS:
                x = pad_to_segments(torch.randn(m, d, generator=gen,
                                                device=dev), -1, xbar)
                w = pad_to_segments(torch.randn(d, n, generator=gen,
                                                device=dev) / math.sqrt(d),
                                    0, xbar)
                g = torch.randn(m, n, generator=gen, device=dev)
                psums = torch.stack([x[:, i:i + xbar] @ w[i:i + xbar]
                                     for i in range(0, x.shape[1], xbar)])
                for fn in ("relu", "identity", "sublinear"):
                    for save_gate in cm.SAVE_GATE_MODES:
                        if (save_gate == "packed"
                                and dendritic.gate_dtype(fn) is not None
                                and not dendritic.gate_packing(fn)):
                            continue  # packing needs an indicator gate
                        tag = (f"{name} M={m} xbar={xbar} {fn} "
                               f"save_gate={save_gate}")
                        near_mismatch += _check_matmul_case(
                            cm, x, w, g, psums, xbar, fn, save_gate, tag,
                            worst)
                        n_checks += 1
    report["k1g_k2_checks"] = {"n": n_checks, "max_err_over_scale": worst,
                               "near_zero_gate_mismatches": near_mismatch}
    print(f"K1g/K2: {n_checks} checks ok (FC shapes {fc_shapes()}, M 64 / "
          f"128, xbar {XBARS}, relu / identity / sublinear, save_gate "
          f"{cm.SAVE_GATE_MODES}); max err / scale {worst}; gate bit "
          f"mismatches at |psum| <= {GATE_NEAR} x scale: {near_mismatch}",
          flush=True)


def _check_gate(cm, gate, want_gate, psums, scale, n, tag) -> int:
    """Fail on a gate difference away from psum 0; return the count of
    differences near it."""
    far = psums.abs() > GATE_NEAR * scale
    if gate.dtype == torch.int32:
        got, want = cm._unpack_mask(gate, n).bool(), \
            cm._unpack_mask(want_gate, n).bool()
    elif gate.dtype == torch.bool:
        got, want = gate, want_gate
    else:
        ok = psums.abs() > 1e-2
        err, _ = rel_err(gate[ok], want_gate[ok])
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: fp32 gate err / scale {err} > {TRAIN_RTOL}")
        return 0
    if not torch.equal(got[far], want[far]):
        fail(f"{tag}: gate bits differ where |psum| > {GATE_NEAR} x scale")
    return int((got != want).sum())


def _check_matmul_case(cm, x, w, g, psums, xbar, fn, save_gate, tag,
                       worst) -> int:
    mode = cm.gate_mode(save_gate, fn)
    kw = dict(crossbar_size=xbar, fn=fn)
    near = 0
    if mode in ("packed", "bytes"):
        y, gate = cm.cadc_matmul_gate_cuda(x, w, mode=mode, **kw)
        want_y, want_gate = cm.cadc_matmul_gate_torch(x, w, mode=mode, **kw)
        nbytes = cm.gate_residual_nbytes(x.shape[0], x.shape[1], w.shape[1],
                                         save_gate=save_gate, **kw)
        if gate.nbytes != nbytes:
            fail(f"{tag}: gate holds {gate.nbytes} bytes, "
                 f"gate_residual_nbytes says {nbytes}")
        near = _check_gate(cm, gate, want_gate, psums,
                           max(1.0, float(want_y.abs().max())), w.shape[1],
                           tag)
    else:
        y, gate = cm.cadc_matmul_cuda(x, w, **kw), None
        want_y = cm.cadc_matmul_torch(x, w, **kw)
    err = (track("k1g", y, want_y) if gate is not None
           else rel_err(y, want_y)[0])
    worst["fwd"] = max(worst["fwd"], err)
    if not err <= TRAIN_RTOL:
        fail(f"{tag}: forward err / scale {err} > {TRAIN_RTOL}")
    dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, mode=mode, **kw)
    _, dw2 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, mode=mode,
                                        need_dx=False, **kw)
    if not torch.equal(dw, dw2):
        fail(f"{tag}: dw differs between two runs")
    if mode == "recompute":
        # the recomputed gate is the forward's: same psums, same order
        _, fwd_gate = cm.cadc_matmul_gate_cuda(x, w, mode="bytes", **kw)
        sdx, sdw = cm.cadc_segmented_bwd_cuda(g, x, w, fwd_gate,
                                              mode="bytes", **kw)
        if not (torch.equal(dx, sdx) and torch.equal(dw, sdw)):
            fail(f"{tag}: recompute differs from the forward's saved gate")
        want_dx, want_dw = cm.cadc_segmented_bwd_torch(
            g, x, w, fwd_gate, mode="bytes", **kw)
    else:
        want_dx, want_dw = cm.cadc_segmented_bwd_torch(g, x, w, gate,
                                                       mode=mode, **kw)
    for key, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        err = track("k2", got, want)
        worst[key] = max(worst[key], err)
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: {key} err / scale {err} > {TRAIN_RTOL}")
    return near


def check_k3(dev, report):
    """K3's forward (with and without its gate) and the conv backward (K2
    over im2col patches, then _col2im) against their plain versions at
    every conv shape of both models at the paths' batches, xbar 64 / 128 /
    256 with relu's packed gate; at xbar 64 also vConv (identity), the
    byte gate and recompute."""
    from repro_torch.core.conv import im2col
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(12)
    shapes = sorted({c[1:] for mdl in ("lenet5", "resnet18")
                     for c in conv_layers(mdl)})
    worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    n_checks = near_mismatch = spanning = 0
    for b, h, cin, k, cout, stride, padding in shapes:
        x = torch.randn(b, h, h, cin, generator=gen, device=dev)
        w = torch.randn(k, k, cin, cout, generator=gen,
                        device=dev) / math.sqrt(k * k * cin)
        oh = conv_out_hw(h, k, stride, padding)
        g = torch.randn(b, oh, oh, cout, generator=gen, device=dev)
        patches = im2col(x, (k, k), stride=(stride, stride),
                         padding=padding).reshape(-1, k * k * cin)
        w2d = w.reshape(-1, cout)
        for xbar in XBARS:
            segs = cc._segment_taps(k, k, cin, xbar)
            spanning += sum(len(t) > 1 for t in segs)
            psums = torch.stack([patches[:, i:i + xbar] @ w2d[i:i + xbar]
                                 for i in range(0, patches.shape[1], xbar)])
            cases = [("relu", "auto")]
            if xbar == XBARS[0]:
                cases += [("identity", "auto"), ("relu", "bytes"),
                          ("relu", "recompute")]
            for fn, save_gate in cases:
                tag = (f"K3 B={b} H={h} Cin={cin} K={k} Cout={cout} "
                       f"s={stride} {padding} xbar={xbar} {fn} {save_gate}")
                near_mismatch += _check_conv_case(
                    cc, cm, x, w, g, patches, psums, xbar, fn, save_gate,
                    (stride, stride), padding, tag, worst)
                n_checks += 1
    report["k3_checks"] = {"n": n_checks, "shapes": shapes,
                           "max_err_over_scale": worst,
                           "segments_spanning_taps": spanning,
                           "near_zero_gate_mismatches": near_mismatch}
    print(f"K3: {n_checks} checks ok over {len(shapes)} conv shapes of "
          f"LeNet-5 (B={LENET_BATCH}) and ResNet-18 (B={RESNET_BATCH}, "
          f"width {RESNET_WIDTH}), xbar {XBARS}; {spanning} segments span "
          f"several taps; max err / scale {worst}; gate bit mismatches at "
          f"|psum| <= {GATE_NEAR} x scale: {near_mismatch}", flush=True)


def _check_conv_case(cc, cm, x, w, g, patches, psums, xbar, fn, save_gate,
                     stride, padding, tag, worst) -> int:
    mode = cm.gate_mode(save_gate, fn)
    kw = dict(crossbar_size=xbar, fn=fn, stride=stride, padding=padding)
    k1, k2, cin, cout = w.shape
    fmode = mode if mode in ("packed", "bytes") else "none"
    y, gate = cc.cadc_conv2d_cuda(x, w, mode=fmode, **kw)
    want_y, want_gate = cc.cadc_conv2d_torch(x, w, mode=fmode, **kw)
    err = track("k3", y, want_y)
    scale = max(1.0, float(want_y.abs().max()))
    worst["fwd"] = max(worst["fwd"], err)
    if not err <= TRAIN_RTOL:
        fail(f"{tag}: forward err / scale {err} > {TRAIN_RTOL}")
    near = 0
    if gate is not None:
        m = patches.shape[0]
        nbytes = cm.gate_residual_nbytes(m, k1 * k2 * cin, cout,
                                         crossbar_size=xbar, fn=fn,
                                         save_gate=save_gate)
        if gate.nbytes != nbytes:
            fail(f"{tag}: gate holds {gate.nbytes} bytes, "
                 f"gate_residual_nbytes says {nbytes}")
        near = _check_gate(cm, gate.reshape(gate.shape[0], m, -1),
                           want_gate.reshape(gate.shape[0], m, -1), psums,
                           scale, cout, tag)
        if fmode == "packed":   # the eval forward: K3 without its gate
            y0, _ = cc.cadc_conv2d_cuda(x, w, mode="none", **kw)
            if not torch.equal(y0, y):
                fail(f"{tag}: the gate changed K3's output")
    g2 = g.reshape(-1, cout)
    w2d = w.reshape(-1, cout)
    gate2 = None if gate is None else gate.reshape(gate.shape[0],
                                                   g2.shape[0], -1)
    bkw = dict(crossbar_size=xbar, fn=fn)
    dpat, dw = cm.cadc_segmented_bwd_cuda(g2, patches, w2d, gate2, mode=mode,
                                          **bkw)
    if mode == "recompute":
        _, fgate = cc.cadc_conv2d_cuda(x, w, mode="bytes", **kw)
        fgate = fgate.reshape(fgate.shape[0], g2.shape[0], -1)
        sdp, sdw = cm.cadc_segmented_bwd_cuda(g2, patches, w2d, fgate,
                                              mode="bytes", **bkw)
        if not (torch.equal(dpat, sdp) and torch.equal(dw, sdw)):
            fail(f"{tag}: recompute differs from K3's saved gate")
        want_dp, want_dw = cm.cadc_segmented_bwd_torch(
            g2, patches, w2d, fgate, mode="bytes", **bkw)
    else:
        want_dp, want_dw = cm.cadc_segmented_bwd_torch(
            g2, patches, w2d, gate2, mode=mode, **bkw)
    oh = g.shape[1]
    dx = cc._col2im(dpat.reshape(x.shape[0], oh, oh, -1), tuple(x.shape),
                    (k1, k2), stride, padding)
    want_dx = cc._col2im(want_dp.reshape(x.shape[0], oh, oh, -1),
                         tuple(x.shape), (k1, k2), stride, padding)
    for key, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        err = track("k2", got, want)
        worst[key] = max(worst[key], err)
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: {key} err / scale {err} > {TRAIN_RTOL}")
    return near


def per_step_launches(model: str, impl: str) -> tuple:
    """(per train step, per eval batch) launches of each kernel, from the
    layer list: every conv runs K3 (with its gate when training CADC
    relu), every FC K1g when training CADC relu (K1 for vConv, whose
    identity gate is nothing to save) and K1 when evaluating; every
    weight-bearing layer runs K2 once in the backward."""
    n_conv = len(conv_layers(model))
    n_fc = 3 if model == "lenet5" else 1
    train = {"cadc_conv2d": n_conv, "cadc_segmented_bwd": n_conv + n_fc,
             "cadc_matmul_gate": n_fc if impl == "cadc" else 0,
             "cadc_matmul": 0 if impl == "cadc" else n_fc}
    evals = {"cadc_conv2d": n_conv, "cadc_segmented_bwd": 0,
             "cadc_matmul_gate": 0, "cadc_matmul": n_fc}
    return train, evals


def expect(train, evals, steps, batches) -> dict:
    return {k: steps * train[k] + batches * evals[k] for k in train}


def lenet_path(dev, report):
    """The twin of examples/train_cnn_cadc.py on the card: LeNet-5 trained
    as vConv and as CADC; exact launch counts."""
    from repro_torch.launch import train_cnn_cadc

    zero_counts()
    t0 = time.perf_counter()
    out = train_cnn_cadc.main(["--steps", str(LENET_STEPS), "--batch",
                               str(LENET_BATCH), "--device", "cuda"])
    wall = time.perf_counter() - t0
    got = read_counts()
    want = {k: 0 for k in got}
    for impl in ("vconv", "cadc"):
        tr, ev = per_step_launches("lenet5", impl)
        for k, v in expect(tr, ev, LENET_STEPS, 8).items():
            want[k] += v
    # the sparsity pass: conv1 spans one crossbar, so it needs no psums and
    # takes K3; every other layer runs the core math (no kernel)
    want["cadc_conv2d"] += 1
    if got != want:
        fail(f"LeNet-5 path launched {got}, want {want}")
    for label in ("vconv", "cadc"):
        hist = out["results"][label]["history"]
        if not all(math.isfinite(h["loss"]) for h in hist):
            fail(f"LeNet-5 {label}: a non-finite loss")
    if not 0.0 <= out["summary"]["eliminated_frac"] <= 1.0:
        fail("LeNet-5: psum sparsity outside [0, 1]")
    report["lenet5_path"] = {
        "steps": LENET_STEPS, "batch": LENET_BATCH, "wall_s": wall,
        "launches": got,
        "eval_acc": {k: out["results"][k]["eval"]["acc"]
                     for k in ("vconv", "cadc")},
        "psum_sparsity": out["summary"]["eliminated_frac"],
        "reductions": out["reductions"]}
    print(f"LeNet-5 path (vConv + CADC, {LENET_STEPS} steps each, batch "
          f"{LENET_BATCH}): {wall:.1f} s, launches {json.dumps(got)} as the "
          f"layer list says", flush=True)


def _model(model):
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import lenet5, resnet18

    if model == "lenet5":
        return (lenet5, {}, synthetic.ClassificationSpec(**MNIST),
                LENET_BATCH)
    return (resnet18, {"num_classes": 10, "width": RESNET_WIDTH},
            synthetic.ClassificationSpec(**CIFAR), RESNET_BATCH)


def training_parity(dev, report):
    """Kernel path (kernel 'auto': K1g / K2 / K3) against plain path
    (kernel 'torch') from the same params and batches, CADC relu xbar 64,
    fp32, TF32 off, both models at full width."""
    from repro_torch.data import synthetic
    from repro_torch.models.common import Ctx, LayerMode
    from repro_torch.train import loop, optimizer

    out = {}
    for model in ("lenet5", "resnet18"):
        mod, init_kw, spec, batch = _model(model)
        data = synthetic.make_classification_dataset(spec, device=dev)
        batches = [data(i, batch) for i in range(3)]
        params, state = mod.init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev, **init_kw)
        runs = {}
        for kernel in ("auto", "torch"):
            mode = LayerMode(impl="cadc", crossbar_size=64, kernel=kernel)
            zero_counts()
            flat = [p.detach().requires_grad_() for p in
                    loop._flatten(params)]
            logits, _ = mod.apply(loop._unflatten(params, flat), state,
                                  batches[0]["image"], Ctx(mode),
                                  train=True)
            loss0 = loop.cross_entropy(logits, batches[0]["label"])
            grads = torch.autograd.grad(loss0, flat)
            step = loop.make_train_step(mod.apply, mode, optimizer.sgd(0.05))
            p, s = params, state
            o = optimizer.sgd(0.05).init(p)
            losses = []
            for i, b in enumerate(batches):
                p, s, o, m = step(p, s, o, b, i)
                losses.append(float(m["loss"]))
            runs[kernel] = (float(loss0.detach()), grads, losses,
                            read_counts())
        (l0k, gk, lk, nk), (l0p, gp, lp, np_) = runs["auto"], runs["torch"]
        # the kernel path: one forward + backward, then 3 train steps
        want = expect(per_step_launches(model, "cadc")[0],
                      per_step_launches(model, "cadc")[1], 4, 0)
        if any(np_.values()) or nk != want:
            fail(f"{model}: launches kernel path {nk} (want {want}), plain "
                 f"path {np_} (want none)")
        if not abs(l0k - l0p) <= LOSS0_RTOL * abs(l0p):
            fail(f"{model}: step-0 loss {l0k} vs plain {l0p}")
        worst_g = 0.0
        for a, b in zip(gk, gp):
            err, _ = rel_err(a, b)
            worst_g = max(worst_g, err)
        if not worst_g <= TRAIN_RTOL:
            fail(f"{model}: gradient err / scale {worst_g} > {TRAIN_RTOL}")
        worst_l = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        if not worst_l <= TRAIN_RTOL:
            fail(f"{model}: sgd losses {lk} vs plain {lp}")
        out[model] = {"loss0": [l0k, l0p], "grad_err_over_scale": worst_g,
                      "sgd_losses": [lk, lp], "loss_rel_err": worst_l,
                      "launches_kernel_path": nk}
        print(f"training parity {model} (full width, fp32, TF32 off): "
              f"step-0 loss {l0k:.6f} vs {l0p:.6f}; grads max err / scale "
              f"{worst_g:.2e}; 3 sgd losses rel err {worst_l:.2e}; plain "
              f"path launches 0", flush=True)
        del params, state, batches, runs
        torch.cuda.empty_cache()
    report["training_parity"] = out


def resnet_main_path(dev, report):
    """The slice's main path: ResNet-18 at its published width trained
    through train.loop.train, as benchmarks/common.py does, CADC relu at
    crossbar 64 and then vConv, RESNET_STEPS steps each, batch 128, on the
    CIFAR-10 proxy; exact launch counts. Returns the CADC run's counts."""
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import resnet18
    from repro_torch.models.common import LayerMode
    from repro_torch.train import loop, optimizer

    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(**CIFAR), device=dev)
    cfg = loop.TrainConfig(steps=RESNET_STEPS, batch_size=RESNET_BATCH,
                           eval_every=1, eval_batches=1)
    counts, result = {}, {}
    for impl in ("cadc", "vconv"):
        mode = LayerMode(impl=impl, crossbar_size=64, fn="relu")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = loop.train(init_fn=resnet18.init, apply_fn=resnet18.apply,
                         batch_fn=data, mode=mode,
                         optimizer=optimizer.adamw(1e-3), cfg=cfg,
                         init_kwargs={"num_classes": 10,
                                      "width": RESNET_WIDTH}, device=dev)
        got = read_counts()
        wall = time.perf_counter() - t0
        want = expect(*per_step_launches("resnet18", impl), RESNET_STEPS, 1)
        if got != want:
            fail(f"ResNet-18 {impl}: launched {got}, want {want}")
        losses = [h["loss"] for h in out["history"]]
        if not (all(math.isfinite(v) for v in losses)
                and math.isfinite(out["eval"]["loss"])):
            fail(f"ResNet-18 {impl}: non-finite losses {losses}")
        counts[impl] = got
        result[impl] = {"losses": losses, "eval": out["eval"],
                        "wall_s": wall, "launches": got}
        print(f"ResNet-18 width {RESNET_WIDTH} {impl}: {RESNET_STEPS} train "
              f"steps at batch {RESNET_BATCH} + 1 eval batch in {wall:.1f} s,"
              f" losses {[round(v, 4) for v in losses]}, launches "
              f"{json.dumps(got)} as the layer list says", flush=True)
    report["resnet18_path"] = result
    return counts["cadc"]


def time_resnet_step(dev, report):
    """Train step ms p50 (CUDA events around each step), images/s and peak
    memory of ResNet-18 CADC at full width, then torch.profiler over a few
    steps: device time per kernel per step and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic
    from repro_torch.models.cnn import resnet18
    from repro_torch.models.common import LayerMode
    from repro_torch.train import loop, optimizer

    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(**CIFAR), device=dev)
    mode = LayerMode(impl="cadc", crossbar_size=64, fn="relu")
    opt = optimizer.adamw(1e-3)
    step = loop.make_train_step(resnet18.apply, mode, opt)
    p, s = resnet18.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev, num_classes=10, width=RESNET_WIDTH)
    o = opt.init(p)
    batches = [data(i, RESNET_BATCH) for i in range(4)]
    for i in range(2):  # warm-up
        p, s, o, _ = step(p, s, o, batches[i], i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, s, o, m = step(p, s, o, batches[i % 4], 2 + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(times))
    n_prof = 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(n_prof):
            p, s, o, m = step(p, s, o, batches[i % 4], 20 + i)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / n_prof
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3 / n_prof, e.key, e.count / n_prof))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        fail("profiler: no device time seen over the ResNet-18 steps")

    def group(key: str) -> str:
        for pat, name in (("ConvGather", "K3 cadc_conv2d"),
                          ("RowMajor", "K1/K1g cadc_matmul"),
                          ("segment_sum", "K1/K1g segment sum"),
                          ("bwd_dx_kernel", "K2 dx"),
                          ("bwd_dw_kernel", "K2 dw"),
                          ("split_sum", "K2 dw split sum")):
            if pat in key:
                return name
        return "other (PyTorch)"

    groups = {}
    for ms, key, calls in rows:
        gname = group(key)
        g = groups.setdefault(gname, {"ms": 0.0, "calls": 0.0})
        g["ms"] += ms
        g["calls"] += calls
    report["resnet18_step"] = {
        "batch": RESNET_BATCH, "width": RESNET_WIDTH,
        "step_ms_p50": p50, "step_ms_all": times,
        "images_per_s": RESNET_BATCH / (p50 / 1e3),
        "peak_memory_bytes": peak,
        "profiled_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_ms_per_step_by_kernel": groups,
        "device_top_per_step": [{"name": k[:110], "ms": ms, "calls": c}
                                for ms, k, c in rows[:16]]}
    print(f"ResNet-18 CADC train step (width {RESNET_WIDTH}, batch "
          f"{RESNET_BATCH}): p50 {p50:.2f} ms, "
          f"{RESNET_BATCH / (p50 / 1e3):.0f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB; profiler: device busy {busy:.2f} of "
          f"{wall_ms:.2f} ms per step (idle share "
          f"{max(0.0, 1.0 - busy / wall_ms):.3f})", flush=True)
    for gname, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {gname}: {g['ms']:.3f} ms/step over {g['calls']:.0f} "
              f"launches", flush=True)


def _conv_ops_bytes(b, h, cin, k, cout, stride, padding, xbar):
    """(flops, bytes of K3 with its packed gate, bytes of K2) of one conv:
    each input read once and each output written once."""
    oh = conv_out_hw(h, k, stride, padding)
    m, d = b * oh * oh, k * k * cin
    s = -(-d // xbar)
    gate = s * m * -(-cout // 32) * 4
    flops = 2 * m * d * cout
    k3 = 4 * (b * h * h * cin + d * cout + m * cout) + gate
    k2 = 4 * (m * cout + m * d + d * cout + m * d + d * cout) + gate
    return flops, k3, k2


def time_train_kernels(dev, launches, report):
    """Device times of K1g, K2 and K3 for one ResNet-18 CADC train step
    (every conv and the fc at their shapes, batch 128, width 64, xbar 64,
    relu's packed gate), beside their plain versions and a PyTorch call of
    the vConv function at the same shapes (F.conv2d / torch.matmul, TF32
    off); plus LeNet-5's shapes at batch 64. CUDA-graph replay over operand
    copies that hold 3x the L2, as time_k1."""
    import torch.nn.functional as F

    from repro_torch.core.conv import im2col
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(13)
    xbar, fn = 64, "relu"
    per_shape = {}
    tot = {k: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0,
               "ops": 0.0} for k in ("k3", "k2", "k1g")}

    def timed(name, count, make, kernel, plain, lib, k_bytes, ops, key):
        first = make()
        ops_set = [first] + rotation(make, sum(
            t.numel() * t.element_size() for t in first))[1:]
        reps = max(20, len(ops_set))
        pick = itertools.cycle(ops_set).__next__
        k = keep_counts(lambda: device_ms(lambda: kernel(*pick()), reps))
        pl = keep_counts(lambda: device_ms(lambda: plain(*pick()), reps))
        lb = device_ms(lambda: lib(*pick()), reps)
        b_ms, b_by = bound_ms(k_bytes, ops, torch.float32)
        per_shape.setdefault(key, {})[name] = {
            "count_per_step": count, "ms": k, "plain_ms": pl,
            "library_ms": lb, "bound_ms": b_ms, "bound_by": b_by}
        if name.startswith("resnet"):
            t = tot[key]
            t["ms"] += count * k
            t["plain"] += count * pl
            t["lib"] += count * lb
            t["bytes"] += count * k_bytes
            t["ops"] += count * ops
        del ops_set

    convs = {}
    for model in ("resnet18", "lenet5"):
        for c in conv_layers(model):
            key = (model,) + c[1:]
            convs[key] = convs.get(key, 0) + 1
    for (model, b, h, cin, k, cout, stride, padding), count in convs.items():
        name = f"{model}.B{b}.H{h}.C{cin}.K{k}.O{cout}.s{stride}"
        st = (stride, stride)
        w = torch.randn(k, k, cin, cout, generator=gen, device=dev) / 8
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        flops, k3_bytes, k2_bytes = _conv_ops_bytes(b, h, cin, k, cout,
                                                    stride, padding, xbar)
        cpad = 0 if padding == "VALID" else k // 2  # SAME, odd k

        def make_x():
            return (torch.randn(b, h, h, cin, generator=gen, device=dev),)

        kw = dict(crossbar_size=xbar, fn=fn, stride=st, padding=padding)
        timed(name, count, make_x,
              lambda x: cc.cadc_conv2d_cuda(x, w, mode="packed", **kw),
              lambda x: cc.cadc_conv2d_torch(x, w, mode="packed", **kw),
              lambda x: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=st,
                                 padding=cpad),
              k3_bytes, flops, "k3")
        # K2: the conv backward over im2col patches, with K3's gate
        x0 = torch.randn(b, h, h, cin, generator=gen, device=dev)
        _, gate = cc.cadc_conv2d_cuda(x0, w, mode="packed", **kw)
        oh = conv_out_hw(h, k, stride, padding)
        m, d = b * oh * oh, k * k * cin
        gate = gate.reshape(gate.shape[0], m, -1)
        w2d = w.reshape(d, cout)

        def make_bwd():
            xx = torch.randn(b, h, h, cin, generator=gen, device=dev)
            return (torch.randn(m, cout, generator=gen, device=dev),
                    im2col(xx, (k, k), stride=st,
                           padding=padding).reshape(m, d))

        bkw = dict(crossbar_size=xbar, fn=fn, mode="packed")
        timed(name, count, make_bwd,
              lambda g, pt: cm.cadc_segmented_bwd_cuda(g, pt, w2d, gate,
                                                       **bkw),
              lambda g, pt: cm.cadc_segmented_bwd_torch(g, pt, w2d, gate,
                                                        **bkw),
              lambda g, pt: (torch.matmul(g, w2d.T), torch.matmul(pt.T, g)),
              k2_bytes, 2 * flops, "k2")
        del x0, gate
    # FC layers: K1g forward (relu's packed gate) and K2 backward
    fcs = [("resnet18.fc", RESNET_BATCH, 8 * RESNET_WIDTH, 10),
           ("lenet5.f1", LENET_BATCH, 400, 120),
           ("lenet5.f2", LENET_BATCH, 120, 84),
           ("lenet5.f3", LENET_BATCH, 84, 10)]
    for name, m, d, n in fcs:
        dp = -(-d // xbar) * xbar
        w = torch.randn(dp, n, generator=gen, device=dev) / math.sqrt(d)
        s = dp // xbar
        gate_b = s * m * -(-n // 32) * 4
        flops = 2 * m * dp * n

        def make_x(m=m, dp=dp):
            return (torch.randn(m, dp, generator=gen, device=dev),)

        timed(name, 1, make_x,
              lambda x: cm.cadc_matmul_gate_cuda(x, w, crossbar_size=xbar,
                                                 fn=fn, mode="packed"),
              lambda x: cm.cadc_matmul_gate_torch(x, w, crossbar_size=xbar,
                                                  fn=fn, mode="packed"),
              lambda x: torch.matmul(x, w),
              4 * (m * dp + dp * n + m * n) + gate_b, flops, "k1g")
        _, gate = cm.cadc_matmul_gate_cuda(torch.randn(m, dp, device=dev), w,
                                           crossbar_size=xbar, fn=fn,
                                           mode="packed")

        def make_bwd(m=m, dp=dp, n=n):
            return (torch.randn(m, n, generator=gen, device=dev),
                    torch.randn(m, dp, generator=gen, device=dev))

        timed(name, 1, make_bwd,
              lambda g, x: cm.cadc_segmented_bwd_cuda(
                  g, x, w, gate, crossbar_size=xbar, fn=fn, mode="packed"),
              lambda g, x: cm.cadc_segmented_bwd_torch(
                  g, x, w, gate, crossbar_size=xbar, fn=fn, mode="packed"),
              lambda g, x: (torch.matmul(g, w.T), torch.matmul(x.T, g)),
              4 * (m * n + 2 * m * dp + 2 * dp * n) + gate_b, 2 * flops,
              "k2")
    report["train_kernel_timing"] = {
        "unit": f"one ResNet-18 CADC train step: width {RESNET_WIDTH}, "
                f"batch {RESNET_BATCH}, xbar {xbar}, relu, packed gate",
        "l2_bytes": l2_bytes(), "per_shape_one_call": per_shape,
        "library": "vConv yardsticks: F.conv2d (NCHW view of the NHWC "
                   "tensor, TF32 off) for K3; torch.matmul for K1g; the "
                   "dx and dw torch.matmul pair for K2"}
    rows = []
    for key, name, src, rep in (
            ("k1g", "cadc_matmul_gate", "src/repro_torch/csrc/cadc_matmul.cu",
             "src/repro/kernels/cadc_matmul.py:199"),
            ("k2", "cadc_segmented_bwd", "src/repro_torch/csrc/cadc_bwd.cu",
             "src/repro/kernels/cadc_matmul.py:492"),
            ("k3", "cadc_conv2d", "src/repro_torch/csrc/cadc_conv.cu",
             "src/repro/kernels/cadc_conv.py:226")):
        t = tot[key]
        b_ms, b_by = bound_ms(t["bytes"], t["ops"], torch.float32)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": MAX_ABS[key],
                     "ms": t["ms"], "plain_ms": t["plain"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": t["lib"]})
        print(f"{name}: {t['ms']:.3f} ms per ResNet-18 train step (plain "
              f"{t['plain']:.3f}, vConv library {t['lib']:.3f}, bound "
              f"{b_ms:.3f} by {b_by})", flush=True)
    return rows


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
    check_k1g_k2(dev, report)
    check_k3(dev, report)

    params = tf.init(cfg, seed=0, device=dev)        # fp32, random weights
    launches = serve_main_path(cfg, params, dev, report)
    fp32_logits_check(cfg, params, dev, report)
    del params
    torch.cuda.empty_cache()

    lenet_path(dev, report)
    training_parity(dev, report)
    train_launches = resnet_main_path(dev, report)
    time_resnet_step(dev, report)
    torch.cuda.empty_cache()

    kernels = [time_k1(cfg, dev, launches, report),
               time_k6(cfg, dev, launches, report),
               *time_train_kernels(dev, train_launches, report)]
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
