#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all started together);
  2. K1 (CADC matmul) against its plain version on the card at every
     gemma3-1b linear shape, M = 8 (decode: the stream kernel), 32 (a
     verify step: 8 slots x Q = 4), 256 and every prefill M of the main
     path (8 slots x each prompt bucket), fp32 (TF32 off) and bf16, relu
     and identity;
  3. K6 (paged attention) against its plain version under the planner's
     plan and every forced plan (plan_paged): the main path's ring
     geometry (ring 160 under a 512 window, each covered-prefix table
     width it slices), the verify steps' (Q = 4 on the 176-entry headroom
     rings, each width covered_blocks(pos + 3) slices), longer local and
     global rings, -1 blocks, NaN-filled dead blocks, an idle slot, and
     enough slots that the ring is split into groups of several chunks;
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
     the device busy time per decode step from torch.profiler, by kernel
     (K1 launches once per linear: its segment sum is inside the kernel;
     K6 once per layer: its groups merge inside the kernel). K6 also
     beside the launch floor (a one-element add_ under the same replay)
     and SDPA's fastest backend that takes the masked call.

Slice 4, speculative decoding and checkpoints:
  4a. the verify gap: on one engine state (8 slots after a prefill, bf16),
     max |delta logit| between each row of a Q = 4 verify step and a
     Q = 1 decode step at the same prefix, with the kernels on, K1 alone,
     K6 alone and neither, and the head as one GEMM against per column;
  4b. serve_spec: phase 4's workload with spec_tokens = 3 under the n-gram
     proposer, the draft model (gemma3-1b at 3 layers), an oracle that
     replays the spec_tokens=0 streams and its anti-oracle: all 16
     requests finish, exact launch counts (K6 once a layer a verify step;
     K1 7 x layers a verify step and a prefill, plus the draft model's),
     the anti-oracle accepts nothing; every stream equals the
     spec_tokens=0 stream or leaves it first at a token whose greedy
     top-2 margin is below the gap of 4a; the n-gram engine's device time
     per verify step under the profiler;
  9a. ckpt_resume: LeNet-5 (K3, K1g, K2) 4 steps straight against 2 steps
     that save and a new train() call that resumes to 4: bitwise params,
     exact launch counts.

Slice 5, the attention-only LM families (after slice 4's phases):
  5a. K1 against its plain version at each of the 23 linear shapes of
     gemma-7b, codeqwen1.5-7b, phi4-mini, mixtral-8x22b, qwen2-moe-a2.7b
     and internvl2-1b at published width (attention, FFN or shared
     experts, untied heads, the vit projection; d_in padded to whole
     crossbars), M = 8, 32 and 1024 (internvl2's also 4 and 2048), fp32
     (TF32 off) and bf16, relu;
  5b. K6 at each config's geometry (H / K / head_dim; R = 1, 3, 6, 7 rows
     at decode and 4x that at Q = 4) on its path's rings, as phase 3 does:
     every plan, NaN in dead entries, an idle slot;
  5c. the slice's path: qwen2-moe-a2.7b at full width (24 layers,
     d_model 2048, 60 routed experts at top-4 + 4 shared, qkv bias, an
     untied head over 151 936 tokens; random bf16 weights from seed 0) on
     phase 4's engine and workload: all 16 requests finish, K1 169 and K6
     24 launches a decode step (K1 169 a prefill), step ms, tok/s, TTFT,
     and the device time per decode step under the profiler split into
     K1, K6, the expert products and the MoE dispatch;
  5d. qwen2-moe-a2.7b at 4 layers in fp32: phase 5's kernel-vs-plain
     logits check;
  5e. internvl2-1b at full width: 4 requests with random [256, 1024]
     patch tensors, prompts of 256..288 tokens, 16 new tokens, exact
     launch counts; one prompt under two patch tensors gives two first
     tokens' logits;
  5f. (timed after the training phases, beside phase 6's K1) K1 device
     times at M = 8 at every shape of 5a beside torch.matmul, the plain
     version and the bound; qwen2-moe's K1 time a decode step.

Slice 2, CNN training (fp32, TF32 off):
  7. K1g / K2 against their plain versions at every FC shape of LeNet-5
     and ResNet-18's fc, M = 64 and 128, xbar 64 / 128 / 256, relu /
     identity / sublinear, all four save_gate modes; K2 under the
     planner's plan and every forced plan (plan_bwd): dx bitwise across
     plans, dw bitwise equal across two runs of a plan; recompute bitwise
     equal to the forward's saved gate;
  8. K3 (forward, gate) and the conv backward against their plain
     versions at every conv shape of LeNet-5, ResNet-18, VGG-16 and the
     SNN at the paths' batches (stride 1 and 2, SAME and VALID, 1x1
     projections, Cin 1, 2 and 3, segments spanning taps), xbar
     64/128/256, every plan a shape admits: the patches route (K2 over
     im2col patches + _col2im) everywhere — under every K2 plan where Cin
     is off 32 (the stems, LeNet-5: K2's main-path shapes) — and where
     plan_conv_bwd says
     "tap" the dgrad / wgrad kernels beside it — dx bitwise the patches
     route under every plan, dw within TRAIN_RTOL and bitwise run to run;
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
 12. K1g, K2 (matrix form: the stem and the FC layers; dx + dw beside
     the torch.matmul pair, and as the step runs it — the stem's dw only —
     beside torch.matmul's dw, im2col + K2 and cuDNN's weight grad), the
     tap conv backward (dgrad + wgrad: dx, dw and both, beside cuDNN's
     convolution_backward and the old route, im2col + K2 + _col2im) and
     K3 device times per ResNet-18 train step (and at LeNet-5's shapes)
     beside their plain versions, the vConv PyTorch call at the same
     shapes and the bound.

Slice 3, the paper's 4/2/4b operating point (int8 q8 kernels, TF32 off):
 13. K4 / K4g (q8 CADC matmul, the int8 tensor-core kernel) against their
     plain versions, bitwise (tanh within 1e-6 of scale), gate bits
     included, at every q8 FC shape of VGG-16, ResNet-18 and the SNN at
     the eval batch, xbar 64 / 128 / 256, every fn, under the planner's
     plan and every forced plan (plan_fwd_q8: the single pass, segment
     groups split over blocks), each bitwise the planner's; the
     straight-through backward (dx, dw, dscale) through ops.cadc_matmul_q8
     in every save_gate mode within 1e-4 of scale;
 14. K5 (q8 fused conv) and its gates against the plain version,
     bitwise, at every conv shape of the three models at the paths'
     batches, the same sweep, under every plan the shape admits (the
     gather kernel, the int8 tensor-core tap kernel at each tile); at
     xbar 256 also codes at -128 / 127, whose psums reach 2^22;
 15. the slice's main path: VGG-16 at its published width (15.3 M params,
     CIFAR-100 proxy, batch 128) trained with QAT through
     train.loop.train (K3 / K1g / K2), its final evaluation in the q8 mode
     (K5 x 13, K4 x 3 per batch, no K1 / K3), exact launch counts; q8
     logits bitwise equal between kernel and plain paths; the Fig. 9 ADC
     evaluation (4 bits, noise-free and noisy) with no kernel launch (the
     ADC needs materialized psums: every layer takes the core path), kernel
     mode equal to torch mode bitwise under one seed;
 16. ResNet-18 width 64 q8 eval on the params phase 11 trained (K5 x 20,
     K4 x 1 per batch), the same checks;
 17. the SNN (width 32, 32x32 events, T 8, batch 32, CADC sublinear):
     fp32 training through K3 / K1g / K2 and q8 inference through K5 / K4,
     exact launch counts, bitwise q8 logits;
 18. VGG-16's q8 eval ms p50, images/s, peak memory, device time by kernel
     and idle share, and its QAT step; K4 and K5 device ms per q8 eval
     batch of each path beside their plain versions, the vConv library
     call (F.conv2d on fp32 codes; torch._int_mm) and the int8 bound; K5
     per conv shape with its plan, beside the gather kernel at that shape;
     K4 per FC shape with its plan, beside the int8 tile kernel it
     replaced (built from tools/profile_k4.py), torch._int_mm, the bound
     and the launch floor.

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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

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
# Slice 4, speculative decoding: drafts a slot a verify step (Q = K + 1).
SPEC_K = 3
# Slice 5, the attention-only LM families: the configs whose K1 shapes and
# K6 geometries are checked; qwen2-moe-a2.7b served at full width on the
# main path's engine and workload, and at MOE_FP32_LAYERS layers in fp32;
# internvl2-1b's patch prefix: VIT_REQUESTS requests of VIT_PROMPT tokens
# (the 256-token image and text), VIT_NEW new tokens each.
SLICE5_ARCHS = ("gemma_7b", "codeqwen15_7b", "phi4_mini_38b",
                "mixtral_8x22b", "qwen2_moe_a27b", "internvl2_1b")
MOE_ARCH, VIT_ARCH = "qwen2_moe_a27b", "internvl2_1b"
MOE_FP32_LAYERS = 4
VIT_REQUESTS, VIT_MAX_LEN, VIT_PROMPT, VIT_NEW = 4, 304, (256, 288), 16


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


def profile_device(run, n: int, group, what: str):
    """torch.profiler over run(0) .. run(n - 1), CUDA events around them:
    (wall ms per call under the profiler, device-busy ms per call, rows
    [(ms per call, kernel name, launches per call)] largest first, and the
    rows summed by group(name) into {group: {"ms", "calls"}})."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(n):
            run(i)
        end.record()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3 / n, e.key, e.count / n))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        fail(f"profiler: no device time seen over {what}")
    groups = {}
    for ms, key, calls in rows:
        g = groups.setdefault(group(key), {"ms": 0.0, "calls": 0.0})
        g["ms"] += ms
        g["calls"] += calls
    return start.elapsed_time(end) / n, busy, rows, groups


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# Kernels that must compile without spills (ptxas' report of each
# instantiation): K3's tap-aligned kernel, the conv backward's dgrad and
# wgrad kernels, K5's int8 tap kernel, K2's dx and dw kernels (saved
# gates and recompute), K6, K4's int8 tensor-core kernel.
NO_SPILL_KERNELS = ("tap_tile_kernel", "dgrad_kernel", "wgrad_kernel",
                    "q8_tap_kernel", "bwd_dx_kernel", "bwd_dw_kernel",
                    "bwd_dx_recompute_kernel", "bwd_dw_recompute_kernel",
                    "paged_attention_kernel", "q8_mma_kernel")
# K4's int8 tile kernel before its redesign (tools/profile_k4.py keeps its
# launcher), built beside the port's sources: time_q8_kernels' yardstick.
OLD_K4 = {}


def ptxas_lines(log: str) -> list:
    """ptxas' register and spill lines of a build log, each prefixed with
    the kernel it is about (demangled where c++filt is installed)."""
    import re
    import shutil

    out, name = [], "?"
    filt = shutil.which("c++filt")
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            if filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
            name = name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0] if name.endswith(")") else name
            continue
        if "registers" in ln or "spill" in ln:
            out.append(f"{name}: {ln.replace('ptxas info    :', '').strip()}")
    return out


def build_kernels(report):
    import re

    from repro_torch.kernels import _build

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import profile_k4

    t0 = time.perf_counter()
    old_k4 = profile_k4.start_old_build()
    libs = _build.build()
    OLD_K4["lib"] = old_k4()
    report["build_s"] = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = ptxas_lines(log.read_text()) if log.is_file() else []
        report.setdefault("ptxas", {})[name] = lines
        for ln in lines:
            print(f"ptxas {name}: {ln}", flush=True)
            spill = re.search(r"(\d+) bytes spill stores", ln)
            if (spill and int(spill.group(1))
                    and any(k in ln for k in NO_SPILL_KERNELS)):
                fail(f"ptxas: {name}: {ln}")
    print(f"build: {sorted(libs)} in {report['build_s']:.1f} s", flush=True)


def linear_shapes(cfg):
    """(name, D padded to whole crossbars, N) of every CADC linear K1 runs:
    a layer's four attention linears and three FFN linears (an MoE
    layer's shared experts, d_shared wide; a routed-only MoE layer has
    none: its experts are batched GEMMs), then an untied head and the vit
    frontend's projection."""
    from repro_torch.core.cadc import num_segments

    xb = cfg.crossbar_size
    pad = lambda d: num_segments(d, xb) * xb  # noqa: E731
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    out = [("wq", pad(d), hq), ("wk", pad(d), hkv), ("wv", pad(d), hkv),
           ("wo", pad(hq), d)]
    d_ff = (cfg.moe.d_shared * (cfg.moe.n_shared > 0) if cfg.moe.n_experts
            else cfg.d_ff * (cfg.ffn_type != "none"))
    if d_ff:
        out += [("w_gate", pad(d), d_ff), ("w_up", pad(d), d_ff),
                ("w_down", pad(d_ff), d)]
    if not cfg.tie_embeddings:
        out.append(("head", pad(d), cfg.padded_vocab))
    if cfg.frontend == "vit":
        out.append(("frontend_proj", pad(cfg.frontend_dim), d))
    return out


def k1_per_pass(cfg, prefill: bool = False) -> int:
    """K1 launches of one forward (a decode step, a verify step or a
    batched prefill): each layer's linears, an untied head, and at a vit
    prefill the frontend's projection."""
    per_layer = sum(name not in ("head", "frontend_proj")
                    for name, _, _ in linear_shapes(cfg))
    return (per_layer * cfg.n_layers + (not cfg.tie_embeddings)
            + (prefill and cfg.frontend == "vit"))


def k1_rows():
    """M of every K1 call on the serving paths: N_SLOTS at decode, N_SLOTS x
    the engine's prompt bucket at each batched prefill (rows are padded to
    the bucket, whatever the number admitted), N_SLOTS x (SPEC_K + 1) at a
    verify step; plus 256, a mid size. The draft model has the target's
    widths and runs K1 at N_SLOTS (its rollout and re-feed steps) and at
    the same prefill rows."""
    from repro_torch.serve.engine import _bucket

    lo, hi = PROMPT_LEN
    return sorted({N_SLOTS, N_SLOTS * (SPEC_K + 1), 256}
                  | {N_SLOTS * _bucket(p) for p in range(lo, hi + 1)})


def k1_case(cm, gen, dev, xbar, d, n, m, dtype, fn) -> float:
    """K1 against its plain version on one random x [m, d], w [d, n]:
    the max abs error; fails past K1_RTOL of the output's scale."""
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, n, generator=gen, device=dev)
         / math.sqrt(d)).to(dtype)
    got = cm.cadc_matmul_cuda(x, w, crossbar_size=xbar, fn=fn)
    want = cm.cadc_matmul_torch(x, w, crossbar_size=xbar, fn=fn)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = K1_RTOL * max(1.0, want.abs().max().item())
    if not err <= tol:
        fail(f"K1 D={d} N={n} M={m} {dtype} {fn}: max abs err {err} > {tol}")
    return err


def check_k1(cfg, dev, report):
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(1)
    xbar = cfg.crossbar_size
    worst, n_checks = 0.0, 0
    rows = k1_rows()
    for d, n in sorted({(d, n) for _, d, n in linear_shapes(cfg)}):
        for m in rows:
            for dtype in (torch.float32, torch.bfloat16):
                for fn in ("relu", "identity"):
                    worst = max(worst, k1_case(cm, gen, dev, xbar, d, n, m,
                                               dtype, fn))
                    n_checks += 1
    report["k1_max_abs_err"] = worst
    print(f"K1 cadc_matmul: {n_checks} checks ok (M in {rows}), max abs err "
          f"{worst:.3e}", flush=True)


def k6_inputs(cfg, dev, dtype, *, kind, ring_len, nb, positions, gen,
              n_blocks=None, q_len=1):
    """q [B, q_len, H, hd], pools, a fragmented table (trailing -1 past each
    slot's live blocks, an idle last slot) and positions for
    len(positions) slots."""
    b = len(positions)
    bs, h, kh, hd = 16, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_blocks = n_blocks or b * (ring_len // bs) + 4
    q = torch.randn(b, q_len, h, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_blocks, bs, kh, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_blocks, bs, kh, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device=dev).cpu().numpy()
    tbl = np.full((b, ring_len // bs), -1, np.int32)
    take = 0
    for i, p in enumerate(positions[:-1]):
        live = min(-(-(p + q_len) // bs), ring_len // bs)
        tbl[i, :live] = perm[take:take + live]
        take += live
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, kp, vp, tbl[:, :nb], pos


def main_path_k6_cases(cfg, max_len=MAX_LEN, lo=PROMPT_LEN[0]):
    """(kind, window, ring_len, table blocks, positions) of a serving
    path's decode steps (the main path's by default): rings of
    cache_len(kind, max_len) under the config's window, sliced to each
    covered-prefix width the engine's rule (PagedBackend.covered_blocks)
    gives for positions lo .. max_len - 1; N_SLOTS - 1 busy slots spread
    over the positions that width covers, and an idle last slot."""
    from repro_torch.models.lm.attention import cache_len

    cases = []
    for kind in ("local", "global"):
        if kind not in cfg.pattern:
            continue
        ring = cache_len(cfg, kind, max_len)
        widths = set()
        for p in range(lo, max_len):
            k = -(-min(p + 1, ring) // BLOCK)
            widths.add(min(1 << (k - 1).bit_length(), ring // BLOCK))
        for nb in sorted(widths):
            top = min(max_len, nb * BLOCK) - 1
            pos = np.linspace(lo, top, N_SLOTS - 1).astype(int)
            cases.append((kind, cfg.local_window, ring, nb,
                          pos.tolist() + [0]))
    return cases


def spec_ring(cfg, kind: str, max_len=MAX_LEN) -> int:
    """The verify step's ring: PagedBackend(spec_tokens=SPEC_K)'s rule."""
    from repro_torch.models.lm.attention import cache_len

    need = cache_len(cfg, kind, max_len + SPEC_K, headroom=SPEC_K)
    return -(-need // BLOCK) * BLOCK


def spec_k6_cases(cfg, max_len=MAX_LEN, lo=PROMPT_LEN[0]):
    """(kind, window, ring_len, table blocks, positions, Q) of the verify
    steps of serve_spec (or of a path of max_len and shortest prompt lo):
    Q = SPEC_K + 1 on the headroom rings, sliced to each width
    covered_blocks(pos + SPEC_K) gives for base positions lo ..
    max_len - 1; N_SLOTS - 1 busy slots spread over the base positions
    that width covers, and an idle last slot."""
    cases = []
    for kind in ("local", "global"):
        if kind not in cfg.pattern:
            continue
        ring = spec_ring(cfg, kind, max_len)
        widths = set()
        for p in range(lo, max_len):
            k = -(-min(p + SPEC_K + 1, ring) // BLOCK)
            widths.add(min(1 << (k - 1).bit_length(), ring // BLOCK))
        for nb in sorted(widths):
            top = min(max_len, nb * BLOCK - SPEC_K) - 1
            pos = np.linspace(lo, top, N_SLOTS - 1).astype(int)
            cases.append((kind, cfg.local_window, ring, nb,
                          pos.tolist() + [0], SPEC_K + 1))
    return cases


def k6_case(pa, cfg, dev, dtype, case, gen) -> tuple:
    """K6 under the planner's plan and every forced plan against its plain
    version on one case (kind, window, ring, nb, positions, Q): within
    K6_TOL, unchanged by NaN in every entry no live row may read, 0 for
    the idle last slot. Returns (max abs err, plans run)."""
    kind, window, ring, nb, positions, q_len = case
    q, kp, vp, tbl, pos = k6_inputs(cfg, dev, dtype, kind=kind,
                                    ring_len=ring, nb=nb,
                                    positions=positions, gen=gen,
                                    q_len=q_len)
    t = torch.as_tensor(tbl, device=dev)
    kw = dict(kind=kind, window=window, ring_len=ring)
    want = pa.paged_attention_torch(q, kp, vp, t, pos, **kw)
    # NaN in every block no live entry of this case can read
    dirty_k, dirty_v = kp.clone(), vp.clone()
    idx = torch.arange(ring, device=dev)
    valid = pa._ring_mask(pos, idx, kind=kind, ring_len=ring,
                          window=window, q_len=q_len).any(dim=1).cpu()
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
    shape = (len(positions), cfg.n_kv_heads, nb,
             q_len * cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
             q.element_size(), 16)
    worst, n_plans = 0.0, 0
    # the planner's plan (None) and every forced plan
    for plan in [None] + pa.paged_plans(*shape):
        got = pa.paged_attention_cuda(q, kp, vp, t, pos, plan=plan, **kw)
        dirty = pa.paged_attention_cuda(q, dirty_k, dirty_v, t, pos,
                                        plan=plan, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        n_plans += 1
        tag = (f"K6 {cfg.name} H/K={cfg.n_heads}/{cfg.n_kv_heads} "
               f"hd={cfg.head_dim} {kind} window={window} ring={ring} "
               f"nb={nb} B={len(positions)} Q={q_len} {dtype} plan {plan}")
        if not err <= K6_TOL[dtype]:
            fail(f"{tag}: max abs err {err} > {K6_TOL[dtype]}")
        if not torch.equal(dirty, got) or torch.isnan(dirty).any():
            fail(f"{tag}: NaN garbage in dead blocks changed the output")
        if not torch.equal(got[-1], torch.zeros_like(got[-1])):
            fail(f"{tag}: idle slot (all -1) is not exactly 0")
    return worst, n_plans


def check_k6(cfg, dev, report):
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    many = np.random.RandomState(2).randint(0, 2048, size=40).tolist()
    cases = [c + (1,) for c in main_path_k6_cases(cfg) + [
        ("local", 512, 512, 32, [3, 200, 511, 512, 700, 1023, 1500, 9]),
        ("local", 64, 128, 8, [3, 63, 64, 130, 300, 77, 127, 0]),
        ("global", 512, 160, 4, [0, 10, 33, 40, 50, 60, 63, 2]),  # warm-up
        ("local", 512, 512, 32, many),  # 40 slots: groups of 5 chunks
    ]] + spec_k6_cases(cfg)
    n_plans = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            err, n = k6_case(pa, cfg, dev, dtype, case, gen)
            worst, n_plans = max(worst, err), n_plans + n
    if int(cm._counters(dev).abs().sum()):
        fail("K6 left the arrival counters nonzero")
    report["k6_max_abs_err"] = worst
    report["k6_cases"] = [c[:4] + (len(c[4]), c[5]) for c in cases]
    print(f"K6 paged_attention: {2 * len(cases)} cases x every plan "
          f"({n_plans} runs) ok (main path "
          f"{[c[:4] for c in main_path_k6_cases(cfg)]}; verify steps at "
          f"Q={SPEC_K + 1} {[c[:4] for c in spec_k6_cases(cfg)]}; NaN "
          f"garbage, idle slot, covered prefix, 40 slots), max abs err "
          f"{worst:.3e}", flush=True)


def serve_main_path(cfg, params, dev, report, key="serve"):
    """The main path (or slice 5's, qwen2-moe-a2.7b's under key
    "serve_moe"): the engine at full width on the main path's workload;
    returns launch counts and the run's streams."""
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
    want = {"cadc_matmul": k1_per_pass(cfg) * (n_dec + n_pre),
            "paged_attention": cfg.n_layers * n_dec}
    for name, n in launches.items():
        if n <= 0 or n != want[name]:
            fail(f"{name} launched {n} times on the main path, want "
                 f"{want[name]} ({n_dec} decode steps, {n_pre} prefills)")
    print(f"serve {cfg.name} full width bf16 cadc: {len(workload)} requests, "
          f"{summary['decode_tokens']} decode tokens, {n_dec} decode steps, "
          f"{n_pre} prefills, {wall:.2f} s", flush=True)
    print(f"tok/s {summary['tokens_per_s']:.1f}", flush=True)
    print(f"step ms p50 {summary['step_ms_p50']:.3f} p99 "
          f"{summary['step_ms_p99']:.3f}", flush=True)
    print(f"TTFT ms p50 {summary['ttft_ms_p50']:.3f} p99 "
          f"{summary['ttft_ms_p99']:.3f}", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    report[key] = {k: summary[k] for k in (
        "tokens_per_s", "tokens_per_s_p50", "step_ms_p50", "step_ms_p99",
        "ttft_ms_p50", "ttft_ms_p99", "prefill_ms_p50", "decode_tokens")}
    report[key].update(decode_steps=n_dec, prefills=n_pre, wall_s=wall,
                       launches=launches)
    base = {"workload": workload, "summary": summary,
            "tokens": [engine.results[rid].tokens
                       for rid in sorted(engine.results)]}
    profile_decode(engine, cfg, report, key=key)
    return launches, base


MOE_SPANS = ("moe block", "moe expert products", "moe shared FFN")


def moe_spans():
    """Wrap the MoE block, its expert products and its shared FFN in
    profiler ranges (MOE_SPANS); returns the function that unwraps them."""
    from torch.profiler import record_function

    from repro_torch.models.lm import ffn as ffn_lib
    from repro_torch.models.lm import moe as moe_lib

    saved = [(moe_lib, "moe_apply", MOE_SPANS[0]),
             (moe_lib, "_expert_linear", MOE_SPANS[1]),
             (ffn_lib, "ffn_apply", MOE_SPANS[2])]
    saved = [(mod, name, label, getattr(mod, name))
             for mod, name, label in saved]
    for mod, name, label, fn in saved:
        def wrapped(*a, fn=fn, label=label, **kw):
            with record_function(label):
                return fn(*a, **kw)
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, _, fn in saved:
            setattr(mod, name, fn)
    return restore


def profile_decode(engine, cfg, report, key="serve", max_new=12) -> None:
    """Device busy time per decode step with every slot busy: torch.profiler
    (CUPTI) over 8 pure decode (or verify) steps, summing the device-side
    events, into report[key]. For an MoE config the device time under the
    MoE ranges (moe_spans) is split out: the expert products, and the
    dispatch (the block less its expert products and shared FFN: router,
    top-k, sort, scatter, gather, combine). A diagnostic: if the profiler
    cannot trace here, it is recorded as not measured and the run goes
    on."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(7)
    for _ in range(engine.ecfg.n_slots):
        engine.submit(rng.randint(0, cfg.vocab_size, size=96).astype(np.int32),
                      max_new)
    engine.step()  # admission, batched prefill, first decode step
    n_steps = 8
    restore = moe_spans() if cfg.moe.n_experts else (lambda: None)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            # a range's own device-side copy (a user annotation) is no
            # kernel: its time is its kernels'
            if ("CUDA" not in str(getattr(e, "device_type", ""))
                    or e.key in MOE_SPANS):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            rows.append((us, e.key, e.count))
        spans = {label: 0.0 for label in MOE_SPANS}
        if cfg.moe.n_experts:
            for e in prof.events():
                if e.name in spans and "CPU" in str(e.device_type):
                    spans[e.name] += e.device_time_total / 1e3 / n_steps
    except Exception as e:  # diagnostic only: keep the smoke run going
        print(f"profiler: not measured ({e!r})", file=sys.stderr)
        report[key]["device_busy_ms_per_step"] = f"not measured: {e!r}"
        restore()
        engine.run()
        return
    restore()
    engine.run()  # drain
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / n_steps
    report[key]["device_busy_ms_per_step"] = busy if rows else \
        "not measured: the profiler saw no device events"
    report[key]["device_top_per_step"] = [
        {"name": k[:90], "ms": us / 1e3 / n_steps, "calls": c / n_steps}
        for us, k, c in rows[:12]]
    groups = {}
    for us, kname, calls in rows:
        name = ("K1 stream kernel" if "stream_kernel" in kname
                else "K1 tile kernel" if "RowMajor" in kname
                else "K6 paged attention" if "paged_attention" in kname
                else "other (PyTorch)")
        g = groups.setdefault(name, {"ms": 0.0, "calls": 0.0})
        g["ms"] += us / 1e3 / n_steps
        g["calls"] += calls / n_steps
    if cfg.moe.n_experts:
        # the MoE ranges hold PyTorch kernels only but for the shared
        # FFN's K1 launches, which stay in the K1 groups
        other = groups.pop("other (PyTorch)", {"ms": 0.0, "calls": 0.0})
        experts = spans["moe expert products"]
        dispatch = (spans["moe block"] - experts
                    - spans["moe shared FFN"])
        groups["MoE expert products (torch.bmm)"] = {"ms": experts}
        groups["MoE dispatch and combine"] = {"ms": dispatch}
        other["ms"] -= experts + dispatch
        groups["other (PyTorch; the launches count the MoE's too)"] = other
        report[key]["moe_spans_ms_per_step"] = spans
    report[key]["device_ms_per_step_by_kernel"] = groups
    k6_calls = groups.get("K6 paged attention", {}).get("calls", 0)
    if k6_calls != cfg.n_layers:
        fail(f"decode profile: {k6_calls} K6 launches a step, want one a "
             f"layer ({cfg.n_layers})")
    print(f"profiler ({key}): device busy per step: "
          f"{report[key]['device_busy_ms_per_step']} ms (8 slots busy, "
          f"{n_steps} steps)", flush=True)
    for gname, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        calls = (f" over {g['calls']:.0f} launches" if "calls" in g
                 else "")
        print(f"  {gname}: {g['ms']:.3f} ms/step{calls}", flush=True)


def fp32_logits_check(cfg, params, dev, report, key="fp32_logits"):
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
            ("kernel", n_kern, (k1_per_pass(cfg) * 5, cfg.n_layers * 4))):
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
    report[key] = {"max_err_over_scale": worst_rel,
                   "greedy_steps_equal": same, "steps": len(picks),
                   "launches": n_kern}
    print(f"fp32 {cfg.name} at full width, {cfg.n_layers} layers: prefill + "
          f"4 decode steps, kernel vs plain "
          f"logits max err / scale {worst_rel:.3e} (tol {LOGITS_RTOL}); "
          f"greedy picks equal on {same}/{len(picks)} steps", flush=True)


def replay_proposer(k, streams, vocab, shift):
    """The oracle (shift 0: replays the spec_tokens=0 streams, so every
    draft stands until the cap) or its anti-oracle (shift 1: those tokens
    + 1 mod vocab, so none does) of tests/test_speculative.py. A history no
    stream extends (a warm-up request, or a stream that left the greedy one
    at a near-tie) gets its last token + shift, repeated."""
    from repro_torch.serve import Proposer

    class Replay(Proposer):
        def propose(self, active, histories):
            out = np.zeros((len(histories), self.k), np.int32)
            for s, hist in enumerate(histories):
                if not active[s]:
                    continue
                full = next((f for f in streams if f.size >= hist.size
                             and np.array_equal(f[: hist.size], hist)), None)
                if full is None:
                    cont = np.full(self.k, hist[-1], np.int64)
                else:
                    cont = full[hist.size: hist.size + self.k]
                    cont = np.concatenate(
                        [cont, np.zeros(self.k - cont.size, np.int64)])
                out[s] = (cont + shift) % vocab
            return out

    return Replay(k)


def verify_gap(cfg, params, dev, report) -> float:
    """max |logit| difference between each row t of a verify step (Q =
    SPEC_K + 1) and a Q = 1 decode step at the same prefix, on one engine
    state: N_SLOTS slots after a batched prefill of prompts of 64..128
    tokens on the headroom rings, the drafts being the decode steps' own
    greedy picks (so each row's prefix is the decode's), tables sliced as
    the engine slices them. Measured in bf16 (the serving path; the
    kernels-on gap bounds the stream check) and in fp32 (TF32 off; finer
    than bf16's rounding of the logits), each with the kernels on, K1
    alone (plain paged attention), K6 alone (plain linears) and neither;
    plus the head as one GEMM over the step's rows against the per-column
    head the verify step computes, and the device time of both."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf
    from repro_torch.serve.backends import PagedBackend
    from repro_torch.serve.blocks import BlockTables

    rng = np.random.RandomState(8)
    lengths = np.linspace(*PROMPT_LEN, N_SLOTS).astype(np.int32)
    tokens = np.zeros((N_SLOTS, PROMPT_LEN[1]), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
    slot_ids = np.arange(N_SLOTS, dtype=np.int32)

    def gap(path_cfg):
        backend = PagedBackend(path_cfg, N_SLOTS, MAX_LEN, BLOCK, dev,
                               spec_tokens=SPEC_K)
        caches = backend.init_caches()
        tables = BlockTables(N_SLOTS, backend.blocks_per_slot,
                             backend.n_blocks)
        for slot in range(N_SLOTS):
            tables.assign(slot)

        def sliced(max_pos):
            cov = backend.covered_blocks(max_pos)
            return {k: torch.as_tensor(np.ascontiguousarray(v[:, :cov[k]]),
                                       device=dev)
                    for k, v in tables.tables.items()}

        p = steps_lib.cast_compute(params, path_cfg)
        first, _, contribs = steps_lib.make_batched_prefill_step(path_cfg)(
            p, {"tokens": torch.as_tensor(tokens, device=dev)},
            torch.as_tensor(lengths, device=dev))
        backend.write_prefill(caches, contribs, slot_ids, lengths,
                              tables.tables)
        pos = torch.as_tensor(lengths.astype(np.int64), device=dev)
        top = int(lengths.max())
        dec_caches = [type(c)(c.k.clone(), c.v.clone()) for c in caches]
        fed, dec = [first.long()], []
        for t in range(SPEC_K + 1):
            nxt, lg = backend.decode(p, dec_caches, sliced(top + t), fed[-1],
                                     pos + t)
            dec.append(lg)
            fed.append(nxt.long())
        heads = []
        head = tf._head
        tf._head = lambda pp, x, c: heads.append(x) or head(pp, x, c)
        try:
            _, ver, _ = backend.decode_spec(
                p, caches, sliced(top + SPEC_K),
                torch.stack(fed[:SPEC_K + 1], dim=1), pos)
        finally:
            tf._head = head
        torch.cuda.synchronize()
        err = max(float((ver[:, t] - dec[t]).abs().max())
                  for t in range(SPEC_K + 1))
        x = torch.cat(heads, dim=1)
        one = head(p, x, path_cfg)
        per_col = torch.cat([head(p, x[:, t:t + 1], path_cfg)
                             for t in range(x.shape[1])], dim=1)
        return err, float((one - per_col).abs().max())

    out = {}
    for dtype in ("bfloat16", "float32"):
        for name, kimpl, aimpl in (("kernels", "auto", "auto"),
                                   ("K1 only", "auto", "torch"),
                                   ("K6 only", "torch", "auto"),
                                   ("plain", "torch", "torch")):
            err, head_one_gemm = gap(cfg.with_overrides(
                dtype=dtype, kernel_impl=kimpl, paged_attn_impl=aimpl))
            out.setdefault(dtype, {})[name] = {
                "max_abs_logit_gap": err, "head_as_one_gemm": head_one_gemm}
        print(f"verify step vs Q = 1 decode, max |delta logit| ({dtype}, "
              f"one state, {N_SLOTS} slots, Q = {SPEC_K + 1}): "
              + "; ".join(f"{k} {v['max_abs_logit_gap']:.4g}"
                          for k, v in out[dtype].items())
              + f"; the head as one GEMM over the {N_SLOTS * (SPEC_K + 1)} "
              f"rows against per column: "
              f"{out[dtype]['kernels']['head_as_one_gemm']:.4g}", flush=True)
    # what the per-column head costs: device ms of the verify step's head,
    # bf16, as one GEMM and per column
    p = steps_lib.cast_compute(params, cfg)
    x = torch.randn(N_SLOTS, SPEC_K + 1, cfg.d_model, device=dev).to(
        torch.bfloat16)
    one_ms = device_ms(lambda: tf._head(p, x, cfg), 10)
    col_ms = device_ms(lambda: [tf._head(p, x[:, t:t + 1], cfg)
                                for t in range(SPEC_K + 1)], 10)
    del p
    out["head_ms"] = {"one_gemm": one_ms, "per_column": col_ms}
    print(f"verify step's head (bf16): one GEMM {one_ms:.3f} ms, per column "
          f"{col_ms:.3f} ms", flush=True)
    report["verify_gap"] = out
    gap_all = out["bfloat16"]["kernels"]["max_abs_logit_gap"]
    if not math.isfinite(gap_all):
        fail(f"verify gap is not finite: {gap_all}")
    return gap_all


def serve_spec(cfg, params, dev, base, gap, report) -> None:
    """Slice 4's path: the main path's workload through the engine with
    spec_tokens = SPEC_K under four proposers (n-gram, the draft model —
    gemma3-1b at default_draft_config's 3 layers, random weights from seed
    1 — the oracle and its anti-oracle), each after a warm-up, with exact
    launch counts. Every stream must equal the spec_tokens=0 stream, or
    leave it first at a token whose top-2 logit margin in the greedy run
    is below the measured verify gap."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import EngineConfig, ServeEngine, poisson_workload

    workload = base["workload"]
    greedy = base["tokens"]
    streams = [np.concatenate([p, np.asarray(t, np.int64)])
               for (_, p, _), t in zip(workload, greedy)]

    # top-2 margins of the greedy run at every token (a run that records
    # its logits; its streams must be the timed run's)
    ref = ServeEngine(cfg, params, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        record_logits=True), device=dev)
    ref.run(workload)
    margins = []
    for i, rid in enumerate(sorted(ref.results)):
        req = ref.results[rid]
        if req.tokens != greedy[i]:
            fail(f"greedy run is not deterministic: request {i} differs "
                 "between two spec_tokens=0 runs")
        top2 = np.sort(np.stack(req.logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        req.logits = []
    del ref

    warm = poisson_workload(n_requests=2, rate=1.0, vocab_size=cfg.vocab_size,
                            prompt_len=(16, 32), max_new=(2, 4), seed=99)
    plain = base["summary"]
    out = {}
    for name in ("ngram", "model", "oracle", "anti"):
        engine = ServeEngine(cfg, params, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, block_size=BLOCK,
            spec_tokens=SPEC_K,
            spec_draft="model" if name == "model" else "ngram"), device=dev)
        if name in ("oracle", "anti"):
            engine.proposer = replay_proposer(SPEC_K, streams,
                                              cfg.vocab_size,
                                              int(name == "anti"))
        engine.run(warm)
        engine.reset_metrics()
        advances = [0]  # the draft model's re-feed steps (on_commit)
        commit = engine.proposer.on_commit

        def counted(committed, commit=commit):
            advances[0] += max(len(c) for c in committed if c is not None)
            commit(committed)

        engine.proposer.on_commit = counted
        torch.cuda.synchronize()
        cm.cadc_matmul_cuda.launches = 0
        pa.paged_attention_cuda.launches = 0
        t0 = time.perf_counter()
        summary = engine.run(workload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"cadc_matmul": cm.cadc_matmul_cuda.launches,
                    "paged_attention": pa.paged_attention_cuda.launches}
        engine.proposer.on_commit = commit
        tel = engine.telemetry
        n_ver, n_pre = tel.spec_steps, len(tel.prefill_s)
        draft = 0
        if name == "model":
            draft = 7 * engine.proposer.cfg_d.n_layers * (
                SPEC_K * n_ver + advances[0] + n_pre)
        want = {"cadc_matmul": 7 * cfg.n_layers * (n_ver + n_pre) + draft,
                "paged_attention": cfg.n_layers * n_ver}
        if n_ver != len(tel.step_s) or launches != want:
            fail(f"serve_spec {name}: launched {launches}, want {want} "
                 f"({n_ver} verify steps, {n_pre} prefills, draft "
                 f"{draft})")
        if summary["requests_finished"] != len(workload):
            fail(f"serve_spec {name}: {summary['requests_finished']}/"
                 f"{len(workload)} requests finished")
        sp = summary["speculative"]
        if name == "anti" and (tel.spec_accepted != 0
                               or tel.spec_committed != tel.spec_slot_steps):
            fail(f"serve_spec anti-oracle: {tel.spec_accepted} drafts "
                 f"accepted, {tel.spec_committed} tokens over "
                 f"{tel.spec_slot_steps} slot-steps (want 0, one a step)")
        diverged = []
        for i, rid in enumerate(sorted(engine.results)):
            toks = engine.results[rid].tokens
            if len(toks) != workload[i][2] or not all(
                    0 <= t < cfg.vocab_size for t in toks):
                fail(f"serve_spec {name} request {i}: {len(toks)} tokens "
                     f"(want {workload[i][2]}) or one outside the vocab")
            if toks == greedy[i]:
                continue
            at = next(j for j, (a, b) in enumerate(zip(toks, greedy[i]))
                      if a != b)
            m = float(margins[i][at])
            diverged.append({"request": i, "token": at, "margin": m})
            if not m < gap:
                fail(f"serve_spec {name} request {i}: the stream leaves the "
                     f"greedy one at token {at}, where the greedy top-2 "
                     f"margin {m:.4g} is not below the verify gap {gap:.4g}")
        out[name] = {k: summary[k] for k in (
            "tokens_per_s", "tokens_per_s_p50", "step_ms_p50",
            "step_ms_p99", "ttft_ms_p50", "decode_tokens")}
        out[name].update(
            requests_finished=summary["requests_finished"],
            accept_rate=sp["accept_rate"],
            tokens_per_step=sp["tokens_per_step"], drafted=sp["drafted"],
            accepted=sp["accepted"], verify_steps=n_ver, prefills=n_pre,
            draft_refeed_steps=advances[0] if name == "model" else 0,
            launches=launches, wall_s=wall, diverged=diverged)
        print(f"serve_spec {name} (K={SPEC_K}): "
              f"{summary['requests_finished']}/{len(workload)} requests, "
              f"tok/s {summary['tokens_per_s']:.1f} (spec_tokens=0: "
              f"{plain['tokens_per_s']:.1f}), step ms p50 "
              f"{summary['step_ms_p50']:.3f} p99 {summary['step_ms_p99']:.3f}"
              f" (spec_tokens=0: {plain['step_ms_p50']:.3f} / "
              f"{plain['step_ms_p99']:.3f}), accept rate "
              f"{sp['accept_rate']:.3f}, tokens/slot/step "
              f"{sp['tokens_per_step']:.3f}, {n_ver} verify steps, launches "
              f"{json.dumps(launches)}; streams: "
              f"{len(workload) - len(diverged)} equal to spec_tokens=0, "
              f"{len(diverged)} leave it at near-ties {diverged}",
              flush=True)
        if name == "ngram":
            # 40 new tokens: the 8 profiled steps all verify, even at full
            # acceptance
            profile_decode(engine, cfg, out, key="ngram", max_new=40)
        del engine
    report["serve_spec"] = out


def time_k1(cfg, dev, launches, report, m=N_SLOTS):
    """One decode step's K1 work: the seven linears at M = 8 slots, bf16,
    relu, x 26 layers (with m = 32: a verify step's). Weights rotate over
    copies that hold 3x the L2 cache, as in a real step that streams 1.5 GB
    of weights."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(3)
    dt, xbar = torch.bfloat16, cfg.crossbar_size
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
        plan = cm.plan_fwd(m, n, d // xbar, xbar, vec=8)
        per_shape[name] = {"D": d, "N": n, "copies": len(ws),
                           "plan": f"{plan.kernel} {plan.width} "
                                   f"split={plan.split} grid={plan.grid}",
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
    if m != N_SLOTS:
        report["k1_timing_verify"] = {
            "unit": f"one verify step: 7 linears x {layers} layers, M={m}, "
                    "bf16, relu",
            "per_shape_one_call": per_shape, "ms": tot["ms"] * layers,
            "plain_ms": tot["plain"] * layers,
            "matmul_ms": tot["lib"] * layers, "bound_ms": b_ms}
        print(f"K1 at a verify step (M={m}): {tot['ms'] * layers:.3f} ms "
              f"(plain {tot['plain'] * layers:.3f}, torch.matmul "
              f"{tot['lib'] * layers:.3f}, bound {b_ms:.3f} by {b_by}); "
              f"plans {sorted({v['plan'] for v in per_shape.values()})}",
              flush=True)
        return None
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
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["lib"] * layers}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_backends_ms(qs, gathered, mask) -> dict:
    """Device ms of scaled_dot_product_attention(qs, k, v, attn_mask=mask)
    under each backend alone, k / v rotating over `gathered`; a backend
    that refuses the masked call maps to why."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name] = "refused: not in this PyTorch"
            continue
        pick = itertools.cycle(gathered).__next__

        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qs, *pick(),
                                                      attn_mask=mask)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
                out[name] = device_ms(call, max(20, len(gathered)))
        except RuntimeError as e:
            out[name] = f"refused: {str(e).strip().splitlines()[0][:100]}"
    return out


def fastest_sdpa(per_backend: dict) -> tuple:
    """(backend, ms) of the fastest backend that took the call."""
    took = {k: v for k, v in per_backend.items() if isinstance(v, float)}
    if not took:
        fail(f"no SDPA backend took the masked call: {per_backend}")
    name = min(took, key=took.get)
    return name, took[name]


def time_k6(cfg, dev, launches, report):
    """One decode step's K6 work at the main path's geometry: 8 slots at
    positions 64..159 of a 160-entry ring (10 blocks of 16), bf16; 22
    local + 4 global layers. Pools (and SDPA's gathered K/V) rotate over
    copies that hold 3x the L2 cache. Beside the kernel: its plain
    version, SDPA on K/V already gathered into the dense ring (the fastest
    backend that takes the masked call), the bound, and the launch floor —
    a one-element add_ under the same graph replay."""
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(4)
    dt, bs, ring = torch.bfloat16, BLOCK, MAX_LEN
    nb = ring // bs
    positions = [64, 77, 90, 101, 118, 131, 147, 159]
    kinds = list(cfg.pattern_for_layers)
    per_kind = {}
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "ops": 0.0}
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1), 20)
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
        plan = pa.plan_paged(8, cfg.n_kv_heads, nb,
                             cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, 2,
                             bs)
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
        valid &= (tbl >= 0).repeat_interleave(bs, dim=1)
        kd = kp[tbl.clamp(min=0).long()].reshape(8, ring, -1)
        vd = vp[tbl.clamp(min=0).long()].reshape(8, ring, -1)
        qs = q[:, 0].unsqueeze(2)                              # [B, H, 1, hd]
        gathered = rotation(lambda: tuple(
            t.clone().unsqueeze(1).expand(-1, cfg.n_heads, -1, -1)
            for t in (kd, vd)), kd.numel() * 2 * 2)
        sdpa = sdpa_backends_ms(qs, gathered, valid[:, None, None, :])
        lib_name, lib = fastest_sdpa(sdpa)
        # the bytes the call needs: q and out, the K and V rows of the
        # entries its token may read (the kernel zero-fills the others
        # without a load), the table and the positions
        live_entries = int(valid.sum())
        hd, h, k_ = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        nbytes = (8 * h * hd * 2 * 2 + live_entries * k_ * hd * 2 * 2
                  + tbl.numel() * 4 + pos.numel() * pos.element_size())
        ops = 4 * h * live_entries * hd
        per_kind[kind] = {"layers": n_layers, "ms": k, "host_ms": k_host,
                          "plain_ms": p,
                          "plan": f"cps={plan.cps} groups={plan.groups} "
                                  f"threads={plan.threads} rows={plan.rows} "
                                  f"blocks={plan.blocks}",
                          "sdpa_ms": lib, "sdpa_backend": lib_name,
                          "sdpa_by_backend": sdpa, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, ops, dt)[0],
                          "launch_floor_ms": floor}
        print(f"K6 {kind}: {k * 1e3:.2f} us a call ({plan.cps} chunks x "
              f"{plan.groups} groups, {plan.threads} threads), eager "
              f"{k_host * 1e3:.1f} us, SDPA {lib_name} {lib * 1e3:.2f} us, "
              f"launch floor {floor * 1e3:.2f} us", flush=True)
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
        "launch_floor_ms_per_step": floor * len(kinds),
        "library": "scaled_dot_product_attention over pre-gathered K/V, "
                   "the fastest backend that takes the masked call"}
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:168",
            "launches": launches["paged_attention"],
            "max_abs_err": report["k6_max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": tot["lib"]}


# ---------------------------------------------------------------------------
# slice 5: the attention-only LM families (MoE, qkv bias, untied heads, the
# vit patch prefix)
# ---------------------------------------------------------------------------

def slice5_cfg(arch: str, **kw):
    from repro_torch.configs import get_config

    return get_config(arch).with_overrides(linear_impl="cadc",
                                           kernel_impl="auto", **kw)


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def slice5_k1_shapes() -> dict:
    """{(D, N): (configs, names)} of every K1 shape of the six configs."""
    out = {}
    for arch in SLICE5_ARCHS:
        cfg = slice5_cfg(arch)
        for name, d, n in linear_shapes(cfg):
            archs, names = out.setdefault((d, n), (set(), set()))
            archs.add(arch)
            names.add(name)
    return out


def slice5_k1_rows(archs) -> list:
    """M of the checks at a shape: a decode step's 8 slots, a verify step's
    32 rows and the main path's 1024-row prefill; internvl2-1b's path adds
    its 4 slots and its 2048-row prefill (4 slots x a 512-token bucket)."""
    rows = {N_SLOTS, N_SLOTS * (SPEC_K + 1), 1024}
    if VIT_ARCH in archs:
        rows |= {VIT_REQUESTS, VIT_REQUESTS * 512}
    return sorted(rows)


def check_k1_slice5(dev, report) -> None:
    """K1 against its plain version at every K1 shape of the six configs
    (qwen2-moe's and internvl2's paths, the others' published widths), at
    the rows slice5_k1_rows gives, fp32 (TF32 off) and bf16, relu."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(11)
    worst, n_checks = 0.0, 0
    shapes = slice5_k1_shapes()
    for (d, n), (archs, _) in sorted(shapes.items()):
        for m in slice5_k1_rows(archs):
            for dtype in (torch.float32, torch.bfloat16):
                worst = max(worst, k1_case(cm, gen, dev, 256, d, n, m, dtype,
                                           "relu"))
                n_checks += 1
        torch.cuda.empty_cache()
    report["k1_slice5"] = {"checks": n_checks, "max_abs_err": worst,
                           "shapes": sorted(shapes)}
    report["k1_max_abs_err"] = max(report["k1_max_abs_err"], worst)
    print(f"K1 at the six configs' {len(shapes)} shapes: {n_checks} checks "
          f"ok, max abs err {worst:.3e}", flush=True)


def check_k6_slice5(dev, report) -> None:
    """K6 under every plan at each config's geometry: its path's rings
    (qwen2-moe and the text-only configs at the main path's max_len 160,
    prompts from 64; internvl2 at 304, prompts from 256) at Q = 1 and at a
    verify step's Q = 4 on the headroom rings, fp32 and bf16."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(12)
    worst, n_plans, n_cases, seen = 0.0, 0, 0, []
    for arch in SLICE5_ARCHS:
        cfg = slice5_cfg(arch)
        geo = ((VIT_MAX_LEN, VIT_PROMPT[0]) if arch == VIT_ARCH
               else (MAX_LEN, PROMPT_LEN[0]))
        cases = ([c + (1,) for c in main_path_k6_cases(cfg, *geo)]
                 + spec_k6_cases(cfg, *geo))
        for dtype in (torch.float32, torch.bfloat16):
            for case in cases:
                err, n = k6_case(pa, cfg, dev, dtype, case, gen)
                worst, n_plans = max(worst, err), n_plans + n
                n_cases += 1
        r = cfg.n_heads // cfg.n_kv_heads
        seen.append(f"{arch} H/K {cfg.n_heads}/{cfg.n_kv_heads} hd "
                    f"{cfg.head_dim} R {r}/{r * (SPEC_K + 1)} "
                    f"{[c[:4] for c in cases]}")
    if int(cm._counters(dev).abs().sum()):
        fail("K6 left the arrival counters nonzero")
    report["k6_slice5"] = {"cases": n_cases, "runs": n_plans,
                           "max_abs_err": worst, "geometries": seen}
    report["k6_max_abs_err"] = max(report["k6_max_abs_err"], worst)
    print(f"K6 at the six configs' geometries: {n_cases} cases x every plan "
          f"({n_plans} runs) ok, max abs err {worst:.3e}; "
          + "; ".join(seen), flush=True)


def moe_main_path(dev, report) -> dict:
    """Slice 5's path: qwen2-moe-a2.7b at full width (24 layers, 60 routed
    experts at top-4 and 4 shared, qkv bias, an untied head of 151 936
    rows) with random weights from seed 0 drawn in bf16, CADC relu at
    crossbar 256, through the main path's engine and workload (K1 on the
    attention linears, the shared experts and the head: 169 launches a
    decode step and a prefill; K6 once a layer a decode step)."""
    from repro_torch.models.lm import transformer as tf

    cfg = slice5_cfg(MOE_ARCH)
    if (k1_per_pass(cfg), cfg.n_layers) != (7 * 24 + 1, 24):
        fail(f"{cfg.name}: {k1_per_pass(cfg)} K1 launches a pass, want 169")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = n_params(params)
    print(f"{cfg.name}: {n / 1e9:.3f} B parameters drawn in bf16 layer by "
          f"layer in {init_s:.1f} s; expert products: torch.bmm on bf16 "
          f"operands with out_dtype=torch.float32", flush=True)
    launches, _ = serve_main_path(cfg, params, dev, report, key="serve_moe")
    report["serve_moe"].update(
        params=n, init_s=init_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        expert_products="torch.bmm(bf16, bf16, out_dtype=torch.float32)")
    print(f"{cfg.name}: peak device memory "
          f"{report['serve_moe']['peak_gib']:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def moe_fp32_logits(dev, report) -> None:
    """qwen2-moe-a2.7b at published width and MOE_FP32_LAYERS layers in
    fp32 (TF32 off): one batched prefill and 4 decode steps, kernel-path
    logits against plain-path logits (full depth in fp32 does not fit)."""
    from repro_torch.models.lm import transformer as tf

    cfg = slice5_cfg(MOE_ARCH, n_layers=MOE_FP32_LAYERS)
    params = tf.init(cfg, seed=0, device=dev)
    fp32_logits_check(cfg, params, dev, report, key="fp32_logits_moe")
    del params
    torch.cuda.empty_cache()


def vit_path(dev, report) -> None:
    """internvl2-1b at full width through the patch prefix: VIT_REQUESTS
    requests, each with a random [256, 1024] patch tensor, prompts of
    VIT_PROMPT tokens, VIT_NEW new tokens; exact K1 (168 a decode step,
    169 a prefill: the frontend's projection) and K6 counts. The last
    request repeats the first one's prompt under other patches: its first
    token's logits must differ."""
    from repro_torch.models.lm import transformer as tf
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = slice5_cfg(VIT_ARCH)
    params = tf.init(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    engine = ServeEngine(cfg, params, EngineConfig(
        n_slots=VIT_REQUESTS, max_len=VIT_MAX_LEN, block_size=BLOCK,
        record_logits=True), device=dev)
    rng = np.random.RandomState(6)
    lens = np.linspace(*VIT_PROMPT, VIT_REQUESTS - 1).astype(int)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    prompts.append(prompts[0])
    shape = (cfg.frontend_len, cfg.frontend_dim)
    torch.cuda.synchronize()
    cm.cadc_matmul_cuda.launches = 0
    pa.paged_attention_cuda.launches = 0
    t0 = time.perf_counter()
    for prompt in prompts:
        engine.submit(prompt, VIT_NEW,
                      patches=rng.randn(*shape).astype(np.float32))
    summary = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cadc_matmul": cm.cadc_matmul_cuda.launches,
                "paged_attention": pa.paged_attention_cuda.launches}
    n_dec = len(engine.telemetry.step_s)
    n_pre = len(engine.telemetry.prefill_s)
    want = {"cadc_matmul": k1_per_pass(cfg) * n_dec
            + k1_per_pass(cfg, prefill=True) * n_pre,
            "paged_attention": cfg.n_layers * n_dec}
    if launches != want:
        fail(f"vit path launched {launches}, want {want} ({n_dec} decode "
             f"steps, {n_pre} prefills)")
    res = [engine.results[rid] for rid in sorted(engine.results)]
    if len(res) != VIT_REQUESTS or any(
            len(r.tokens) != VIT_NEW
            or not all(0 <= t < cfg.vocab_size for t in r.tokens)
            or not all(np.isfinite(lg).all() for lg in r.logits)
            for r in res):
        fail(f"vit path: {len(res)} requests finished, or a stream of "
             f"other than {VIT_NEW} tokens, a token outside the vocabulary "
             "or non-finite logits")
    gap = float(np.abs(res[0].logits[0] - res[-1].logits[0]).max())
    if not gap > 0:
        fail("vit path: one prompt under two patch tensors gave the same "
             "first-token logits")
    report["serve_vit"] = {k: summary[k] for k in (
        "tokens_per_s", "step_ms_p50", "step_ms_p99", "ttft_ms_p50",
        "decode_tokens")}
    report["serve_vit"].update(decode_steps=n_dec, prefills=n_pre,
                               wall_s=wall, launches=launches,
                               patch_logit_gap=gap)
    print(f"serve {cfg.name} full width bf16 cadc, patch prefix: "
          f"{len(res)} requests of {[p.size for p in prompts]} tokens "
          f"({cfg.frontend_len} image), {n_dec} decode steps, {n_pre} "
          f"prefills, {wall:.2f} s, tok/s {summary['tokens_per_s']:.1f}, "
          f"launches {json.dumps(launches)}; one prompt under two patch "
          f"tensors: first-token logits differ by up to {gap:.4g}",
          flush=True)
    del engine, params
    torch.cuda.empty_cache()


def time_k1_slice5(dev, report) -> None:
    """K1 device ms at M = 8 (a decode step's rows), bf16, relu, at every
    K1 shape of the six configs, beside its plain version, torch.matmul
    and the bound (weights rotated over copies that hold 3x the L2, as in
    time_k1); then qwen2-moe-a2.7b's K1 time a decode step from them."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(13)
    dt, m, xbar = torch.bfloat16, N_SLOTS, 256
    per_shape = {}
    for (d, n), (archs, names) in sorted(slice5_k1_shapes().items()):
        x = torch.randn(m, d, generator=gen, device=dev).to(dt)
        ws = rotation(lambda: (torch.randn(d, n, generator=gen, device=dev)
                               / math.sqrt(d)).to(dt), d * n * 2)
        reps = max(20, len(ws))
        pick = itertools.cycle(ws).__next__
        saved = cm.cadc_matmul_cuda.launches
        k = device_ms(lambda: cm.cadc_matmul_cuda(x, pick(),
                                                  crossbar_size=xbar,
                                                  fn="relu"), reps)
        cm.cadc_matmul_cuda.launches = saved   # comparison launches
        p = device_ms(lambda: cm.cadc_matmul_torch(x, pick(),
                                                   crossbar_size=xbar,
                                                   fn="relu"), len(ws))
        lib = device_ms(lambda: torch.matmul(x, pick()), reps)
        nbytes = m * d * 2 + d * n * 2 + m * n * 4
        plan = cm.plan_fwd(m, n, d // xbar, xbar, vec=8)
        per_shape[f"{d}x{n}"] = {
            "D": d, "N": n, "configs": sorted(archs), "names": sorted(names),
            "plan": f"{plan.kernel} {plan.width} split={plan.split} "
                    f"grid={plan.grid}",
            "ms": k, "plain_ms": p, "matmul_ms": lib,
            "bound_ms": bound_ms(nbytes, 2 * m * d * n, dt)[0]}
        print(f"K1 M=8 D={d} N={n} ({'/'.join(sorted(names))} of "
              f"{', '.join(sorted(archs))}): {k * 1e3:.2f} us, torch.matmul "
              f"{lib * 1e3:.2f}, plain {p * 1e3:.2f}, bound "
              f"{per_shape[f'{d}x{n}']['bound_ms'] * 1e3:.2f} ({plan.kernel}"
              f" {plan.width}, grid {plan.grid})", flush=True)
        del ws
        torch.cuda.empty_cache()
    cfg = slice5_cfg(MOE_ARCH)
    step = {"ms": 0.0, "matmul_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, d, n in linear_shapes(cfg):
        times = 1 if name == "head" else cfg.n_layers
        for key in step:
            step[key] += per_shape[f"{d}x{n}"][key] * times
    report["k1_timing_slice5"] = {
        "unit": "one call at M=8, bf16, relu", "per_shape": per_shape,
        "qwen2_moe_decode_step": step}
    print(f"K1 a {cfg.name} decode step (169 launches at M=8): "
          f"{step['ms']:.3f} ms, torch.matmul {step['matmul_ms']:.3f}, "
          f"plain {step['plain_ms']:.3f}, bound {step['bound_ms']:.3f} "
          "(sums of the one-call times)", flush=True)


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
            "cadc_conv2d_bwd": cc.cadc_conv2d_bwd_cuda,
            "cadc_conv2d": cc.cadc_conv2d_cuda,
            "cadc_matmul_q8": cm.cadc_matmul_q8_cuda,
            "cadc_matmul_q8_gate": cm.cadc_matmul_q8_gate_cuda,
            "cadc_conv2d_q8": cc.cadc_conv2d_q8_cuda}


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


# max abs err of each slice-2 kernel over its checks (the kernels line;
# "k2c": the tap conv backward's dgrad and wgrad)
MAX_ABS = {"k1g": 0.0, "k2": 0.0, "k3": 0.0, "k2c": 0.0}
# K3 launches under a forced plan, by kernel, held bitwise to the planner's;
# conv backward launches under a forced plan ("bwd_tap"), dx held bitwise;
# K2 over matrices under a forced plan ("bwd_matrix"), dx held bitwise
PLANS_CHECKED = {"gather": 0, "tap": 0, "bwd_tap": 0, "bwd_matrix": 0}
# the models whose paths run K3 (check_k3 takes every conv shape of each)
K3_MODELS = ("lenet5", "resnet18", "vgg16", "snn")


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
    if model == "vgg16":
        out, h, cin = [], 32, 3
        for si, (c, n) in enumerate(VGG_CFG):
            for bi in range(n):
                out.append((f"c{si}_{bi}", VGG_BATCH, h, cin, 3, c, 1,
                            "SAME"))
                cin = c
            h //= 2
        return out
    if model == "snn":
        w = SNN_WIDTH
        return [("conv1", SNN_BATCH, SNN_HW, 2, 3, w, 1, "SAME"),
                ("conv2", SNN_BATCH, SNN_HW // 2, w, 3, 2 * w, 1, "SAME")]
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
                               "near_zero_gate_mismatches": near_mismatch,
                               "k2_forced_plans":
                                   PLANS_CHECKED["bwd_matrix"]}
    print(f"K1g/K2: {n_checks} checks ok (FC shapes {fc_shapes()}, M 64 / "
          f"128, xbar {XBARS}, relu / identity / sublinear, save_gate "
          f"{cm.SAVE_GATE_MODES}); K2 under "
          f"{PLANS_CHECKED['bwd_matrix']} forced plans, dx bitwise the "
          f"planner's; max err / scale {worst}; gate bit "
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
    dws = [dw] + _k2_plans(cm, g, x, w, gate, mode, kw, dx, tag)
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
    for key, got, want in [("dx", dx, want_dx)] + [("dw", d, want_dw)
                                                   for d in dws]:
        err = track("k2", got, want)
        worst[key] = max(worst[key], err)
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: {key} err / scale {err} > {TRAIN_RTOL}")
    return near


def _k2_plans(cm, g, x, w, gate, mode, kw, dx, tag) -> list:
    """K2 over matrices under every other plan of `bwd_plans` (not counted
    as launches): dx bitwise the planner's, dw the same bits on two runs
    of a plan; returns each plan's dw for the caller's tolerance check."""
    (m, d), n = x.shape, w.shape[1]
    out = []
    for plan in cm.bwd_plans(m, n, d, kw["crossbar_size"], mode)[1:]:
        pdx, pdw = keep_counts(lambda: cm.cadc_segmented_bwd_cuda(
            g, x, w, gate, mode=mode, plan=plan, **kw))
        _, pdw2 = keep_counts(lambda: cm.cadc_segmented_bwd_cuda(
            g, x, w, gate, mode=mode, plan=plan, **kw))
        if not torch.equal(pdx, dx):
            fail(f"{tag}: K2 plan {plan}: dx differs from the planner's")
        if not torch.equal(pdw, pdw2):
            fail(f"{tag}: K2 plan {plan}: dw differs between two runs")
        out.append(pdw)
        PLANS_CHECKED["bwd_matrix"] += 1
    return out


def check_k3(dev, report):
    """K3's forward (with and without its gate, under every plan the shape
    admits) and the conv backward (K2 over im2col patches, then _col2im;
    and the tap dgrad / wgrad kernels where plan_conv_bwd says "tap", under
    every plan) against their plain versions at every conv shape of the
    four models whose paths run K3 (LeNet-5, ResNet-18, VGG-16, the SNN) at
    the paths' batches, xbar 64 / 128 / 256 with relu's packed gate; at
    xbar 64 also vConv (identity), the byte gate, sublinear's fp32 gate
    and recompute."""
    from repro_torch.core.conv import im2col
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(12)
    shapes = sorted({c[1:] for mdl in K3_MODELS for c in conv_layers(mdl)})
    worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "tap_dx": 0.0, "tap_dw": 0.0}
    n_checks = near_mismatch = spanning = n_tap = 0
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
                          ("sublinear", "auto"), ("relu", "recompute")]
            for fn, save_gate in cases:
                tag = (f"K3 B={b} H={h} Cin={cin} K={k} Cout={cout} "
                       f"s={stride} {padding} xbar={xbar} {fn} {save_gate}")
                near, tap = _check_conv_case(
                    cc, cm, x, w, g, patches, psums, xbar, fn, save_gate,
                    (stride, stride), padding, tag, worst)
                near_mismatch += near
                n_tap += tap
                n_checks += 1
    report["k3_checks"] = {"n": n_checks, "shapes": shapes,
                           "tap_bwd_cases": n_tap,
                           "max_err_over_scale": worst,
                           "segments_spanning_taps": spanning,
                           "near_zero_gate_mismatches": near_mismatch,
                           "forced_plans_bitwise": dict(PLANS_CHECKED)}
    print(f"K3: {n_checks} checks ok over {len(shapes)} conv shapes of "
          f"LeNet-5 (B={LENET_BATCH}), ResNet-18 (B={RESNET_BATCH}, width "
          f"{RESNET_WIDTH}), VGG-16 (B={VGG_BATCH}) and the SNN "
          f"(B={SNN_BATCH}), xbar {XBARS}; {spanning} segments span "
          f"several taps; max err / scale {worst}; gate bit mismatches at "
          f"|psum| <= {GATE_NEAR} x scale: {near_mismatch}; forced plans "
          f"bitwise the planner's (packed gate): {PLANS_CHECKED}; the tap "
          f"conv backward in {n_tap} cases, dx bitwise the patches route "
          f"and dw bitwise run to run under every plan", flush=True)


def _check_conv_case(cc, cm, x, w, g, patches, psums, xbar, fn, save_gate,
                     stride, padding, tag, worst) -> tuple:
    """One conv case; returns (gate bit mismatches near psum 0, 1 if the
    tap conv backward ran)."""
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
            # every plan the shape admits gives the planner's bits
            for plan in cc.conv_plans(m, cout, cin, xbar):
                yp, gp = keep_counts(lambda: cc._conv_launch(
                    "cadc_conv2d_cuda", x, w, xbar, fn, stride, padding,
                    fmode, None, plan=plan))
                if not (torch.equal(yp, y) and torch.equal(gp, gate)):
                    fail(f"{tag}: plan {plan} differs from the planner's")
                PLANS_CHECKED[plan.kernel] += 1
    g2 = g.reshape(-1, cout)
    w2d = w.reshape(-1, cout)
    gate2 = None if gate is None else gate.reshape(gate.shape[0],
                                                   g2.shape[0], -1)
    bkw = dict(crossbar_size=xbar, fn=fn)
    dpat, dw = cm.cadc_segmented_bwd_cuda(g2, patches, w2d, gate2, mode=mode,
                                          **bkw)
    dws = [dw]
    if not cc.tap_aligned(cin, xbar):  # K2 over these patches every step
        dws += _k2_plans(cm, g2, patches, w2d, gate2, mode, bkw, dpat, tag)
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
    for key, got, want in [("dx", dx, want_dx)] + [("dw", d, want_dw)
                                                   for d in dws]:
        err = track("k2", got, want)
        worst[key] = max(worst[key], err)
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: {key} err / scale {err} > {TRAIN_RTOL}")
    if cc.plan_conv_bwd(x.shape, w.shape, stride, padding, xbar,
                        mode).kernel != "tap":
        return near, 0
    # the tap dgrad / wgrad: dx bitwise the patches route above (K2's dx,
    # _col2im), dw within TRAIN_RTOL and the same bits on every run, under
    # the planner's plan and every forced one
    ckw = dict(kw, mode=mode)
    tdx, tdw = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **ckw)
    runs = [tdw, cc.cadc_conv2d_bwd_cuda(g, x, w, gate, need_dx=False,
                                         **ckw)[1]]
    if not torch.equal(tdx, dx):
        fail(f"{tag}: the tap dgrad differs from the patches route (max abs "
             f"{float((tdx - dx).abs().max())})")
    if not torch.equal(runs[0], runs[1]):
        fail(f"{tag}: the tap wgrad differs between two runs")
    for plan in cc.conv_bwd_plans(x.shape, w.shape, stride, padding, xbar,
                                  mode):
        pdx, pdw = keep_counts(lambda: cc.cadc_conv2d_bwd_cuda(
            g, x, w, gate, plan=plan, **ckw))
        if not torch.equal(pdx, tdx):
            fail(f"{tag}: conv backward plan {plan}: dx differs from the "
                 f"planner's")
        runs.append(pdw)
        PLANS_CHECKED["bwd_tap"] += 1
    want_dw = want_dw.reshape(w.shape)
    for key, got, want in [("tap_dx", tdx, want_dx)] + [
            ("tap_dw", r, want_dw) for r in runs]:
        err = track("k2c", got, want)
        worst[key] = max(worst[key], err)
        if not err <= TRAIN_RTOL:
            fail(f"{tag}: tap conv backward {key} err / scale {err} > "
                 f"{TRAIN_RTOL}")
    return near, 1


def per_step_launches(model: str, impl: str) -> tuple:
    """(per train step, per eval batch) launches of each kernel, from the
    layer list: every conv runs K3 (with its gate when training CADC
    relu), every FC K1g when training CADC relu (K1 for vConv, whose
    identity gate is nothing to save) and K1 when evaluating; in the
    backward every conv whose plan_conv_bwd plan is "tap" (at crossbar 64)
    runs the tap conv backward once, and every other weight-bearing layer
    K2."""
    from repro_torch.kernels import cadc_conv as cc

    convs = conv_layers(model)
    n_conv = len(convs)
    n_tap = sum(cc.plan_conv_bwd((b, h, h, cin), (k, k, cin, cout),
                                 (s, s), pad, 64, "bytes").kernel == "tap"
                for _, b, h, cin, k, cout, s, pad in convs)
    n_fc = 3 if model in ("lenet5", "vgg16") else 1
    train = {"cadc_conv2d": n_conv, "cadc_conv2d_bwd": n_tap,
             "cadc_segmented_bwd": n_conv - n_tap + n_fc,
             "cadc_matmul_gate": n_fc if impl == "cadc" else 0,
             "cadc_matmul": 0 if impl == "cadc" else n_fc}
    evals = {"cadc_conv2d": n_conv, "cadc_segmented_bwd": 0,
             "cadc_matmul_gate": 0, "cadc_matmul": n_fc}
    return train, evals


def expect(train, evals, steps, batches) -> dict:
    """Launches of every counted kernel over `steps` train steps and
    `batches` eval batches (kernels in neither dict: 0)."""
    out = {k: 0 for k in counters()}
    for k in set(train) | set(evals):
        out[k] = steps * train.get(k, 0) + batches * evals.get(k, 0)
    return out


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


def ckpt_resume(dev, report) -> None:
    """Slice 4's training part: LeNet-5 (CADC relu at crossbar 64: K3, K1g,
    K2) trained 4 steps straight, then 2 steps that save and, in a new
    train() call on the same ckpt_dir, resumed to step 4: the params must
    be bitwise the straight run's; exact launch counts over the three
    calls (8 train steps, 3 eval batches)."""
    import shutil

    from repro_torch import ckpt
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import lenet5
    from repro_torch.models.common import LayerMode
    from repro_torch.train import loop

    d = os.path.join(REPO, "build", "ckpt_resume")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(init_fn=lenet5.init, apply_fn=lenet5.apply,
              batch_fn=synthetic.make_classification_dataset(
                  synthetic.ClassificationSpec(**MNIST), device=dev),
              mode=LayerMode(impl="cadc", crossbar_size=64, fn="relu"),
              device=dev)

    def cfg(steps, ckpt_dir=None):
        return loop.TrainConfig(steps=steps, batch_size=LENET_BATCH,
                                eval_every=1, eval_batches=1,
                                ckpt_dir=ckpt_dir, ckpt_every=2)

    zero_counts()
    t0 = time.perf_counter()
    straight = loop.train(cfg=cfg(4), **kw)
    loop.train(cfg=cfg(2, d), **kw)
    if ckpt.all_steps(d) != [2]:
        fail(f"ckpt_resume: checkpoints {ckpt.all_steps(d)} after 2 steps, "
             "want [2]")
    resumed = loop.train(cfg=cfg(4, d), **kw)
    got = read_counts()
    wall = time.perf_counter() - t0
    tr, ev = per_step_launches("lenet5", "cadc")
    want = expect(tr, ev, 8, 3)
    if got != want:
        fail(f"ckpt_resume launched {got}, want {want}")
    if [h["step"] for h in resumed["history"]] != [2, 3]:
        fail(f"ckpt_resume: the resumed run took steps "
             f"{[h['step'] for h in resumed['history']]}, want [2, 3]")
    names, a = ckpt.checkpoint._flatten(resumed["params"])
    _, b = ckpt.checkpoint._flatten(straight["params"])
    differ = [n for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
    if differ:
        fail(f"ckpt_resume: resumed params differ from the straight run's "
             f"at {differ}")
    shutil.rmtree(d, ignore_errors=True)
    report["ckpt_resume"] = {"wall_s": wall, "launches": got,
                             "leaves_bitwise": len(names)}
    print(f"ckpt_resume: LeNet-5 4 steps straight = 2 steps + save + resume "
          f"to 4, bitwise over {len(names)} param tensors, launches "
          f"{json.dumps(got)}, {wall:.1f} s", flush=True)


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
    counts, result, trained = {}, {}, {}
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
        trained[impl] = (out["params"], out["state"])
        result[impl] = {"losses": losses, "eval": out["eval"],
                        "wall_s": wall, "launches": got}
        print(f"ResNet-18 width {RESNET_WIDTH} {impl}: {RESNET_STEPS} train "
              f"steps at batch {RESNET_BATCH} + 1 eval batch in {wall:.1f} s,"
              f" losses {[round(v, 4) for v in losses]}, launches "
              f"{json.dumps(got)} as the layer list says", flush=True)
    report["resnet18_path"] = result
    return counts["cadc"], trained["cadc"]


def time_resnet_step(dev, report):
    """Train step ms p50 (CUDA events around each step), images/s and peak
    memory of ResNet-18 CADC at full width, then torch.profiler over a few
    steps: device time per kernel per step and the card's idle share."""
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

    def group(key: str) -> str:
        for pat, name in (("ConvGather", "K3 cadc_conv2d (gather)"),
                          ("tap_tile_kernel", "K3 cadc_conv2d (tap)"),
                          ("RowMajor", "K1/K1g cadc_matmul"),
                          ("dgrad_kernel", "K2 conv tap dgrad (dx)"),
                          ("wgrad_kernel", "K2 conv tap wgrad (dw)"),
                          ("bwd_dx", "K2 dx"),
                          ("bwd_dw", "K2 dw")):
            if pat in key:
                return name
        return "other (PyTorch)"

    state = [p, s, o]

    def run(i):
        state[0], state[1], state[2], _ = step(*state, batches[i % 4], 20 + i)

    wall_ms, busy, rows, groups = profile_device(run, 3, group,
                                                 "the ResNet-18 steps")
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
    """(flops, bytes of K3 with its packed gate, bytes of K2 over patches,
    bytes of the tap conv backward) of one conv: each input read once and
    each output written once (K2: g, patches, w, gate in; dpatches, dw out;
    the tap backward: g, x, w, gate in; dx, dw out)."""
    oh = conv_out_hw(h, k, stride, padding)
    m, d = b * oh * oh, k * k * cin
    s = -(-d // xbar)
    gate = s * m * -(-cout // 32) * 4
    flops = 2 * m * d * cout
    k3 = 4 * (b * h * h * cin + d * cout + m * cout) + gate
    k2 = 4 * (m * cout + m * d + d * cout + m * d + d * cout) + gate
    tap = 4 * (m * cout + 2 * b * h * h * cin + 2 * d * cout) + gate
    return flops, k3, k2, tap


def time_train_kernels(dev, launches, report):
    """Device times of K1g, K2 (over patches: the stem and the fc), the tap
    conv backward (the other 19 convs) and K3 for one ResNet-18 CADC train
    step (every conv and the fc at their shapes, batch 128, width 64, xbar
    64, relu's packed gate), beside their plain versions and a PyTorch call
    of the vConv function at the same shapes (F.conv2d / torch.matmul /
    cuDNN's convolution_backward with both grads, TF32 off); for the tap
    conv backward also dx alone, dw alone and the old route (im2col + K2 +
    _col2im); plus LeNet-5's shapes at batch 64. CUDA-graph replay over
    operand copies that hold 3x the L2, as time_k1."""
    import torch.nn.functional as F

    from repro_torch.core.conv import im2col
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(13)
    xbar, fn = 64, "relu"
    per_shape = {}
    tot = {k: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0,
               "ops": 0.0} for k in ("k3", "k2", "k2c", "k1g")}

    def timed(name, count, make, kernel, plain, lib, k_bytes, ops, key,
              extra=None):
        first = make()
        ops_set = [first] + rotation(make, sum(
            t.numel() * t.element_size() for t in first))[1:]
        reps = max(20, len(ops_set))
        pick = itertools.cycle(ops_set).__next__
        k = keep_counts(lambda: device_ms(lambda: kernel(*pick()), reps))
        pl = keep_counts(lambda: device_ms(lambda: plain(*pick()), reps))
        lb = device_ms(lambda: lib(*pick()), reps)
        b_ms, b_by = bound_ms(k_bytes, ops, torch.float32)
        rec = per_shape.setdefault(key, {})[name] = {
            "count_per_step": count, "ms": k, "plain_ms": pl,
            "library_ms": lb, "bound_ms": b_ms, "bound_by": b_by}
        for label, fn in (extra or {}).items():  # more calls, same operands
            rec[label] = keep_counts(lambda: device_ms(
                lambda: fn(*pick()), reps))
        if name.startswith("resnet"):
            t = tot[key]
            t["ms"] += count * k
            t["plain"] += count * pl
            t["lib"] += count * lb
            t["bytes"] += count * k_bytes
            t["ops"] += count * ops
            for label in extra or {}:
                t[label] = t.get(label, 0.0) + count * rec[label]
        del ops_set

    convs, first_convs = {}, set()
    for model in ("resnet18", "lenet5"):
        first_convs.add((model,) + conv_layers(model)[0][1:])
        for c in conv_layers(model):
            key = (model,) + c[1:]
            convs[key] = convs.get(key, 0) + 1
    for key, count in convs.items():
        model, b, h, cin, k, cout, stride, padding = key
        name = f"{model}.B{b}.H{h}.C{cin}.K{k}.O{cout}.s{stride}"
        st = (stride, stride)
        w = torch.randn(k, k, cin, cout, generator=gen, device=dev) / 8
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        flops, k3_bytes, k2_bytes, tap_bytes = _conv_ops_bytes(
            b, h, cin, k, cout, stride, padding, xbar)
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
        oh = conv_out_hw(h, k, stride, padding)
        plan = cc.plan_conv(b * oh * oh, cout, cin, xbar)
        rec = per_shape["k3"][name]
        rec["plan"] = f"{plan.kernel} {plan.tile[0]}x{plan.tile[1]}"
        rec["grid"] = list(plan.grid)
        print(f"K3 {name} x{count}: plan {rec['plan']} ({plan.blocks} "
              f"blocks), {rec['ms']:.4f} ms, F.conv2d {rec['library_ms']:.4f}"
              f" ms, bound {rec['bound_ms']:.4f} ms", flush=True)
        # the conv backward with K3's gate: the tap kernels where the plan
        # says so, else K2 over im2col patches
        x0 = torch.randn(b, h, h, cin, generator=gen, device=dev)
        _, gate = cc.cadc_conv2d_cuda(x0, w, mode="packed", **kw)
        m, d = b * oh * oh, k * k * cin
        del x0
        bplan = cc.plan_conv_bwd((b, h, h, cin), w.shape, st, padding, xbar,
                                 "packed")
        if bplan.kernel == "tap":
            ckw = dict(kw, mode="packed")

            def make_tap():
                return (torch.randn(b, oh, oh, cout, generator=gen,
                                    device=dev),
                        torch.randn(b, h, h, cin, generator=gen, device=dev))

            def cudnn(g, x):  # NCHW views of the NHWC tensors
                return torch.ops.aten.convolution_backward(
                    g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw,
                    None, list(st), [cpad, cpad], [1, 1], False, [0, 0], 1,
                    [True, True, False])

            timed(name, count, make_tap,
                  lambda g, x: cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **ckw),
                  lambda g, x: cc.cadc_conv2d_bwd_torch(g, x, w, gate,
                                                        **ckw),
                  cudnn, tap_bytes, 2 * flops, "k2c",
                  extra={"dx_ms": lambda g, x: cc.cadc_conv2d_bwd_cuda(
                             g, x, w, gate, need_dw=False, **ckw),
                         "dw_ms": lambda g, x: cc.cadc_conv2d_bwd_cuda(
                             g, x, w, gate, need_dx=False, **ckw),
                         "old_route_ms": lambda g, x: cc._bwd_patches(
                             cm.cadc_segmented_bwd_cuda, g, x, w, gate,
                             **ckw)})
            rec = per_shape["k2c"][name]
            rec["plan"] = (f"dx {bplan.dx_tile[0]}x{bplan.dx_tile[1]} "
                           f"({bplan.dx_blocks} blocks), dw "
                           f"{bplan.dw_tile[0]}x{bplan.dw_tile[1]} x "
                           f"{bplan.dw_splits} splits ({bplan.dw_blocks} "
                           f"blocks)")
            print(f"K2 conv tap {name} x{count}: plan {rec['plan']}; dx "
                  f"{rec['dx_ms']:.4f} ms, dw {rec['dw_ms']:.4f}, both "
                  f"{rec['ms']:.4f}; cuDNN convolution_backward "
                  f"{rec['library_ms']:.4f}; old route (im2col + K2 + "
                  f"_col2im) {rec['old_route_ms']:.4f}; bound "
                  f"{rec['bound_ms']:.4f}", flush=True)
            del gate
            continue
        gate = gate.reshape(gate.shape[0], m, -1)
        w2d = w.reshape(d, cout)
        # as the step runs it: no dx where the conv's input is the image
        need_dx = key not in first_convs

        def make_bwd():
            xx = torch.randn(b, h, h, cin, generator=gen, device=dev)
            return (torch.randn(m, cout, generator=gen, device=dev),
                    im2col(xx, (k, k), stride=st,
                           padding=padding).reshape(m, d), xx)

        def cudnn_wgrad(g, pt, x):
            return torch.ops.aten.convolution_backward(
                g.view(b, oh, oh, cout).permute(0, 3, 1, 2),
                x.permute(0, 3, 1, 2), w_oihw, None, list(st), [cpad, cpad],
                [1, 1], False, [0, 0], 1, [False, True, False])

        bkw = dict(crossbar_size=xbar, fn=fn, mode="packed")
        ckw = dict(bkw, stride=st, padding=padding, need_dx=need_dx)
        timed(name, count, make_bwd,
              lambda g, pt, x: cm.cadc_segmented_bwd_cuda(g, pt, w2d, gate,
                                                          **bkw),
              lambda g, pt, x: cm.cadc_segmented_bwd_torch(g, pt, w2d, gate,
                                                           **bkw),
              lambda g, pt, x: (torch.matmul(g, w2d.T),
                                torch.matmul(pt.T, g)),
              k2_bytes, 2 * flops, "k2",
              extra={"step_ms": lambda g, pt, x: cm.cadc_segmented_bwd_cuda(
                         g, pt, w2d, gate, need_dx=need_dx, **bkw),
                     "matmul_dw_ms": lambda g, pt, x: torch.matmul(pt.T, g),
                     "im2col_k2_ms": lambda g, pt, x: cc._bwd_patches(
                         cm.cadc_segmented_bwd_cuda,
                         g.view(b, oh, oh, cout), x, w, gate, **ckw),
                     "cudnn_wgrad_ms": cudnn_wgrad})
        rec = per_shape["k2"][name]
        # the step's bytes: g, the patches and the gate in, dw (and dx) out
        step_bytes = (4 * (m * cout + m * d + d * cout) + gate.nbytes
                      + (4 * m * d if need_dx else 0))
        rec["need_dx"] = need_dx
        rec["step_bound_ms"], _ = bound_ms(
            step_bytes, flops * (2 if need_dx else 1), torch.float32)
        bplan = cm.plan_bwd(m, cout, d, xbar, "packed")
        rec["plan"] = (f"dx {bplan.dx_tile[0]}x{bplan.dx_tile[1]} "
                       f"({math.prod(bplan.dx_grid)} blocks), dw "
                       f"{bplan.dw_tile[0]}x{bplan.dw_tile[1]} x "
                       f"{bplan.dw_splits} splits ({bplan.dw_tiles} tiles)")
        if name.startswith("resnet"):
            tot["k2"]["step_bytes"] = (tot["k2"].get("step_bytes", 0.0)
                                       + count * step_bytes)
            tot["k2"]["step_ops"] = (tot["k2"].get("step_ops", 0.0)
                                     + count * flops * (2 if need_dx else 1))
        print(f"K2 matrix {name} x{count}: plan {rec['plan']}; dx + dw "
              f"{rec['ms']:.4f} ms (torch.matmul pair "
              f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f}); as "
              f"the step runs it ({'dx + dw' if need_dx else 'dw only'}) "
              f"{rec['step_ms']:.4f} (bound {rec['step_bound_ms']:.4f}), "
              f"torch.matmul dw {rec['matmul_dw_ms']:.4f}, im2col + K2 "
              f"{rec['im2col_k2_ms']:.4f}, cuDNN weight grad "
              f"{rec['cudnn_wgrad_ms']:.4f}", flush=True)
        del gate
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

        fc_bytes = 4 * (m * n + 2 * m * dp + 2 * dp * n) + gate_b
        timed(name, 1, make_bwd,
              lambda g, x: cm.cadc_segmented_bwd_cuda(
                  g, x, w, gate, crossbar_size=xbar, fn=fn, mode="packed"),
              lambda g, x: cm.cadc_segmented_bwd_torch(
                  g, x, w, gate, crossbar_size=xbar, fn=fn, mode="packed"),
              lambda g, x: (torch.matmul(g, w.T), torch.matmul(x.T, g)),
              fc_bytes, 2 * flops, "k2")
        rec = per_shape["k2"][name]
        rec["step_ms"] = rec["ms"]  # every FC's input needs its gradient
        rec["step_bound_ms"] = rec["bound_ms"]
        bplan = cm.plan_bwd(m, n, dp, xbar, "packed")
        rec["plan"] = (f"dx {bplan.dx_tile[0]}x{bplan.dx_tile[1]}, dw "
                       f"{bplan.dw_tile[0]}x{bplan.dw_tile[1]} x "
                       f"{bplan.dw_splits} splits")
        if name.startswith("resnet"):
            t = tot["k2"]
            t["step_ms"] = t.get("step_ms", 0.0) + rec["ms"]
            t["step_bytes"] = t.get("step_bytes", 0.0) + fc_bytes
            t["step_ops"] = t.get("step_ops", 0.0) + 2 * flops
        print(f"K2 matrix {name}: plan {rec['plan']}; dx + dw "
              f"{rec['ms']:.4f} ms (torch.matmul pair "
              f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f})",
              flush=True)
    report["train_kernel_timing"] = {
        "unit": f"one ResNet-18 CADC train step: width {RESNET_WIDTH}, "
                f"batch {RESNET_BATCH}, xbar {xbar}, relu, packed gate",
        "l2_bytes": l2_bytes(), "per_shape_one_call": per_shape,
        "library": "vConv yardsticks: F.conv2d (NCHW view of the NHWC "
                   "tensor, TF32 off) for K3; torch.matmul for K1g; the "
                   "dx and dw torch.matmul pair for K2 over patches; "
                   "cuDNN's convolution_backward (dx and dw, NCHW views, "
                   "TF32 off) for the tap conv backward"}
    rows = []
    for key, name, src, rep in (
            ("k1g", "cadc_matmul_gate", "src/repro_torch/csrc/cadc_matmul.cu",
             "src/repro/kernels/cadc_matmul.py:199"),
            ("k2", "cadc_segmented_bwd", "src/repro_torch/csrc/cadc_bwd.cu",
             "src/repro/kernels/cadc_matmul.py:492"),
            ("k2c", "cadc_conv2d_bwd", "src/repro_torch/csrc/cadc_conv_bwd.cu",
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
    t = tot["k2"]
    t["step_bound_ms"], _ = bound_ms(t["step_bytes"], t["step_ops"],
                                     torch.float32)
    report["train_kernel_timing"]["k2_matrix_per_step"] = {
        k: t[k] for k in ("ms", "lib", "step_ms", "step_bound_ms",
                          "matmul_dw_ms", "im2col_k2_ms", "cudnn_wgrad_ms")}
    print(f"cadc_segmented_bwd per ResNet-18 train step: dx + dw "
          f"{t['ms']:.4f} ms (torch.matmul pair {t['lib']:.4f}); as the "
          f"step runs it (the stem's dw only, the fc's dx + dw) "
          f"{t['step_ms']:.4f} (bound {t['step_bound_ms']:.4f}); the stem "
          f"beside it: torch.matmul dw {t['matmul_dw_ms']:.4f}, im2col + K2 "
          f"{t['im2col_k2_ms']:.4f}, cuDNN weight grad "
          f"{t['cudnn_wgrad_ms']:.4f}", flush=True)
    t = tot["k2c"]
    report["train_kernel_timing"]["conv_bwd_tap_per_step"] = {
        k: t[k] for k in ("ms", "dx_ms", "dw_ms", "old_route_ms", "lib")}
    print(f"cadc_conv2d_bwd per ResNet-18 train step: dx {t['dx_ms']:.3f} + "
          f"dw {t['dw_ms']:.3f} ms alone, {t['ms']:.3f} together; cuDNN "
          f"convolution_backward {t['lib']:.3f}; old route (im2col + K2 + "
          f"_col2im) {t['old_route_ms']:.3f}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# slice 3: the paper's 4/2/4b operating point through K4 and K5
# ---------------------------------------------------------------------------

# VGG-16 at its published width on the CIFAR-100 proxy of
# benchmarks/common.py:76 at CIFAR-100's class count; the SNN at snn.init's
# defaults on DVS-Gesture-like events. Only the depth of training is cut.
VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
VGG_BATCH, VGG_STEPS = 128, 3
CIFAR100 = dict(n_classes=100, hw=32, channels=3, noise=0.9, seed=2)
SNN_BATCH, SNN_T, SNN_HW, SNN_WIDTH, SNN_STEPS = 32, 8, 32, 32, 3
Q8_EVAL_BATCHES = 2
Q8_FNS = ("relu", "identity", "sublinear", "supralinear", "tanh")
# The q8 kernels equal their plain versions bitwise (exact int32 psums,
# every later rounding the same), gate bits included; tanh within
# TANH_RTOL of scale (CUDA's tanhf is not torch's). Their straight-through
# backward (K2 on the codes) within TRAIN_RTOL of scale, as K2's checks.
TANH_RTOL = 1e-6
Q8_MAX_ABS = {"k4": 0.0, "k5": 0.0}
# K5 launches under a forced plan, each bitwise the planner's, by kernel.
Q8_PLANS_CHECKED = {"gather": 0, "tap": 0}


def q8_fc_shapes():
    """(name, M = the path's eval batch, D, N) of every q8 FC."""
    return [("vgg16.f1", VGG_BATCH, 512, 512),
            ("vgg16.f2", VGG_BATCH, 512, 512),
            ("vgg16.f3", VGG_BATCH, 512, 100),
            ("resnet18.fc", RESNET_BATCH, 8 * RESNET_WIDTH, 10),
            ("snn.fc", SNN_BATCH, (SNN_HW // 4) ** 2 * 2 * SNN_WIDTH, 11)]


def _q8_same(key, got, want, fn, tag):
    err = float((got - want).abs().max())
    Q8_MAX_ABS[key] = max(Q8_MAX_ABS[key], err)
    if fn == "tanh":
        if not err <= TANH_RTOL * max(1.0, float(want.abs().max())):
            fail(f"{tag}: err {err}")
    elif not torch.equal(got, want):
        fail(f"{tag}: not bitwise equal (max abs err {err})")


def _codes(gen, dev, shape, lo, hi):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def check_k4(dev, report):
    """K4 / K4g against their plain versions at every q8 FC shape of the
    three models, xbar 64 / 128 / 256, every fn: outputs and gate bits
    bitwise (tanh: TANH_RTOL), under the planner's plan and every forced
    plan of `q8_plans` (each bitwise the planner's); the straight-through
    backward through ops.cadc_matmul_q8 on float codes in every save_gate
    mode."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(21)
    n_fwd = n_bwd = n_plans = 0
    worst_bwd = 0.0
    for name, m, d, n in q8_fc_shapes():
        for xbar in XBARS:
            dp = -(-d // xbar) * xbar   # whole crossbars, as ops pads
            x = _codes(gen, dev, (m, dp), -7, 8)
            w = _codes(gen, dev, (dp, n), -1, 2)
            scale = torch.rand((), generator=gen, device=dev) * 0.02 + 1e-3
            g = torch.randn(m, n, generator=gen, device=dev)
            for fn in Q8_FNS:
                tag = f"K4 {name} M={m} xbar={xbar} {fn}"
                kw = dict(crossbar_size=xbar, fn=fn)
                y = cm.cadc_matmul_q8_cuda(x, w, scale, **kw)
                _q8_same("k4", y, cm.cadc_matmul_q8_torch(x, w, scale, **kw),
                         fn, tag)
                n_fwd += 1
                plans = cm.q8_plans(m, n, dp // xbar, xbar)
                for plan in plans[1:]:
                    yp, _ = cm._fwd_launch(x, w, xbar, fn, "none", scale,
                                           plan=plan)
                    if not torch.equal(yp, y):
                        fail(f"{tag} {plan}: not bitwise the planner's")
                    n_plans += 1
                for mode in (("packed", "bytes") if fn == "relu" else
                             () if fn == "identity" else ("bytes",)):
                    yg, gate = cm.cadc_matmul_q8_gate_cuda(x, w, scale,
                                                           mode=mode, **kw)
                    _, wgate = cm.cadc_matmul_q8_gate_torch(
                        x, w, scale, mode=mode, **kw)
                    if not torch.equal(yg, y):
                        fail(f"{tag} {mode}: the gate changed K4's output")
                    _q8_same("k4", gate.float(), wgate.float(), fn,
                             f"{tag} {mode} gate")
                    n_fwd += 1
                    for plan in plans[1:]:
                        yp, gp = cm._fwd_launch(x, w, xbar, fn, mode, scale,
                                                plan=plan)
                        if not (torch.equal(yp, y) and torch.equal(gp, gate)):
                            fail(f"{tag} {mode} {plan}: not bitwise the "
                                 f"planner's")
                        n_plans += 1
                if fn == "tanh":
                    continue
                for save_gate in cm.SAVE_GATE_MODES:
                    if save_gate == "packed" and fn != "relu":
                        continue
                    grads = {}
                    for impl in ("cuda", "torch"):
                        xf = x.float().requires_grad_()
                        wf = w.float().requires_grad_()
                        sf = scale.clone().requires_grad_()
                        yy = ops.cadc_matmul_q8(xf, wf, sf, impl=impl,
                                                save_gate=save_gate, **kw)
                        grads[impl] = torch.autograd.grad((yy * g).sum(),
                                                          (xf, wf, sf))
                    for a, b in zip(grads["cuda"], grads["torch"]):
                        err, _ = rel_err(a, b)
                        worst_bwd = max(worst_bwd, err)
                        if not err <= TRAIN_RTOL:
                            fail(f"{tag} save_gate={save_gate}: STE grad "
                                 f"err / scale {err}")
                    n_bwd += 1
    if int(cm._counters(dev).abs().sum()):
        fail("K4 left the arrival counters nonzero")
    report["k4_checks"] = {"forward": n_fwd, "forced_plans": n_plans,
                           "ste_backward": n_bwd,
                           "max_abs_err": Q8_MAX_ABS["k4"],
                           "ste_max_err_over_scale": worst_bwd}
    print(f"K4 cadc_matmul_q8: {n_fwd} forward / gate checks bitwise (tanh "
          f"within {TANH_RTOL} of scale; max abs err {Q8_MAX_ABS['k4']:.1e}) "
          f"at FC shapes {q8_fc_shapes()}, xbar {XBARS}, fns {Q8_FNS}; "
          f"{n_plans} forced-plan launches bitwise the planner's; "
          f"{n_bwd} STE backward checks (dx, dw, dscale) max err / scale "
          f"{worst_bwd:.1e}", flush=True)


def check_k5(dev, report):
    """K5 (and its gates) against the plain version at every conv shape of
    VGG-16, ResNet-18 and the SNN at the paths' batches, xbar 64 / 128 /
    256, every fn, bitwise (tanh: TANH_RTOL), under the planner's plan and
    every plan the shape admits (the gather kernel, the int8 tap kernel at
    each tile), each bitwise the planner's: relu's packed gate at every
    xbar, relu's byte and sublinear's fp32 gate at xbar 64; at xbar 256
    also codes at -128 / 127 (|psum| up to 2^22)."""
    from repro_torch.kernels import cadc_conv as cc

    gen = torch.Generator(device=dev).manual_seed(22)
    shapes = sorted({c[1:] for mdl in ("vgg16", "resnet18", "snn")
                     for c in conv_layers(mdl)})
    n_checks = 0
    for b, h, cin, k, cout, stride, padding in shapes:
        x = _codes(gen, dev, (b, h, h, cin), -7, 8)
        w = _codes(gen, dev, (k, k, cin, cout), -1, 2)
        scale = torch.rand((), generator=gen, device=dev) * 0.02 + 1e-3
        ext = (torch.full_like(x, -128), torch.where(
            torch.rand(w.shape, generator=gen, device=dev) < 0.5, -128,
            127).to(torch.int8))
        oh = conv_out_hw(h, k, stride, padding)
        for xbar in XBARS:
            plans = cc.conv_plans(b * oh * oh, cout, cin, xbar, q8=True)
            cases = [(fn, "none", x, w) for fn in Q8_FNS]
            cases.append(("relu", "packed", x, w))
            if xbar == XBARS[0]:
                cases += [("relu", "bytes", x, w),
                          ("sublinear", "bytes", x, w)]
            if xbar == 256:
                cases += [("relu", "packed", *ext),
                          ("identity", "none", *ext)]
            for fn, mode, xc, wc in cases:
                tag = (f"K5 B={b} H={h} Cin={cin} K={k} Cout={cout} "
                       f"s={stride} xbar={xbar} {fn} {mode}"
                       + (" -128/127" if xc is ext[0] else ""))
                _check_q8_conv_case(cc, xc, wc, scale, xbar, fn, mode,
                                    (stride, stride), padding, plans, tag)
                n_checks += 1
        del x, w, ext
    report["k5_checks"] = {"n": n_checks, "shapes": shapes,
                           "max_abs_err": Q8_MAX_ABS["k5"],
                           "forced_plans_bitwise": dict(Q8_PLANS_CHECKED)}
    print(f"K5 cadc_conv2d_q8: {n_checks} checks bitwise (tanh within "
          f"{TANH_RTOL} of scale; max abs err {Q8_MAX_ABS['k5']:.1e}) over "
          f"{len(shapes)} conv shapes of VGG-16 (B={VGG_BATCH}), ResNet-18 "
          f"(B={RESNET_BATCH}) and the SNN (B={SNN_BATCH}), xbar {XBARS}, "
          f"fns {Q8_FNS}, packed / byte / fp32 gates, codes at -128 / 127 "
          f"at xbar 256; forced plans bitwise the planner's: "
          f"{Q8_PLANS_CHECKED}", flush=True)


def _check_q8_conv_case(cc, x, w, scale, xbar, fn, mode, stride, padding,
                        plans, tag) -> None:
    """K5 through its wrapper (the planner's plan) against the plain
    version, then under each of `plans`, bitwise the planner's."""
    kw = dict(crossbar_size=xbar, fn=fn, stride=stride, padding=padding,
              mode=mode)
    y, gate = cc.cadc_conv2d_q8_cuda(x, w, scale, **kw)
    want, want_gate = cc.cadc_conv2d_q8_torch(x, w, scale, **kw)
    _q8_same("k5", y, want, fn, tag)
    if gate is not None:
        if fn == "tanh":
            _q8_same("k5", gate, want_gate, fn, f"{tag} gate")
        elif not torch.equal(gate, want_gate):
            fail(f"{tag}: the gate differs from the plain version's")
    for plan in plans:
        yp, gp = cc._conv_launch("cadc_conv2d_q8_cuda", x, w, xbar, fn,
                                 stride, padding, mode, scale, plan=plan)
        if not (torch.equal(yp, y)
                and (gp is None if gate is None else torch.equal(gp, gate))):
            fail(f"{tag}: plan {plan} differs from the planner's (max abs "
                 f"{float((yp - y).abs().max())})")
        Q8_PLANS_CHECKED[plan.kernel] += 1


def q8_modes(fn="relu"):
    """(QAT mode, q8 eval mode, ADC eval mode) at the paper's 4/2/4b."""
    import dataclasses

    from repro_torch.core.adc import AdcConfig
    from repro_torch.core.quant import PAPER_424
    from repro_torch.models.common import LayerMode

    qat = LayerMode(impl="cadc", crossbar_size=64, fn=fn, quant=PAPER_424)
    q8 = dataclasses.replace(qat, q8_fused=True)
    return qat, q8, dataclasses.replace(q8, adc=AdcConfig(bits=4))


def q8_launches(model: str) -> dict:
    """Launches of one q8 eval batch: K5 per conv, K4 per FC (x T for the
    SNN's time steps), nothing else."""
    t = SNN_T if model == "snn" else 1
    n_fc = 3 if model == "vgg16" else 1
    return {"cadc_conv2d_q8": t * len(conv_layers(model)),
            "cadc_matmul_q8": t * n_fc}


def q8_logits_parity(mod, params, state, x, q8, tag, rng=None):
    """Kernel path against plain path on one batch: bitwise logits; the
    plain path launches nothing. Returns the kernel path's launches."""
    import dataclasses

    from repro_torch.models.common import Ctx

    with torch.no_grad():
        zero_counts()
        got, _ = mod.apply(params, state, x, Ctx(q8, rng))
        n_kernel = read_counts()
        want, _ = mod.apply(params, state, x,
                            Ctx(dataclasses.replace(q8, kernel="torch"), rng))
        n_plain = read_counts()
    if n_plain != n_kernel:
        fail(f"{tag}: the plain path launched {n_plain} vs {n_kernel}")
    if not torch.equal(got, want):
        fail(f"{tag}: kernel-path logits differ from the plain path's (max "
             f"abs err {float((got - want).abs().max())})")
    if not bool(torch.isfinite(got).all()):
        fail(f"{tag}: non-finite logits")
    return n_kernel, got


def vgg_main_path(dev, report):
    """The slice's main path: VGG-16 at its published width, QAT through
    train.loop.train (K3 / K1g / K2), the final evaluation in the q8 mode
    (K5 / K4, no K1 / K3), then q8 eval and the Fig. 9 ADC evaluation
    through loop.evaluate. Exact launch counts throughout."""
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import vgg16
    from repro_torch.train import loop, optimizer

    qat, q8, adc = q8_modes()
    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(**CIFAR100), device=dev)
    cfg = loop.TrainConfig(steps=VGG_STEPS, batch_size=VGG_BATCH,
                           eval_every=1, eval_batches=Q8_EVAL_BATCHES)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = loop.train(init_fn=vgg16.init, apply_fn=vgg16.apply, batch_fn=data,
                     mode=qat, eval_mode=q8, optimizer=optimizer.adamw(1e-3),
                     cfg=cfg, init_kwargs={"num_classes": 100}, device=dev)
    got = read_counts()
    wall = time.perf_counter() - t0
    want = expect(per_step_launches("vgg16", "cadc")[0], q8_launches("vgg16"),
                  VGG_STEPS, Q8_EVAL_BATCHES)
    if got != want:
        fail(f"VGG-16 QAT + q8 eval launched {got}, want {want}")
    losses = [h["loss"] for h in out["history"]]
    if not all(math.isfinite(v) for v in losses + [out["eval"]["loss"]]):
        fail(f"VGG-16: non-finite losses {losses}, eval {out['eval']}")
    params, state = out["params"], out["state"]
    n = sum(t.numel() for t in loop._flatten(params))
    print(f"VGG-16 (width_div 1, {n / 1e6:.2f} M params, 100 classes) QAT "
          f"4/2/4b CADC relu xbar 64: {VGG_STEPS} train steps at batch "
          f"{VGG_BATCH} + {Q8_EVAL_BATCHES} q8 eval batches in {wall:.1f} s, "
          f"losses {[round(v, 4) for v in losses]}, q8 eval {out['eval']}, "
          f"launches {json.dumps(got)} as the layer list says", flush=True)

    # q8 inference alone: K5 x 13 and K4 x 3 per batch, nothing else
    zero_counts()
    ev_q8 = loop.evaluate(vgg16.apply, params, state, data, q8,
                          n_batches=Q8_EVAL_BATCHES, batch_size=VGG_BATCH)
    got_q8 = read_counts()
    if got_q8 != expect({}, q8_launches("vgg16"), 0, Q8_EVAL_BATCHES):
        fail(f"VGG-16 q8 eval launched {got_q8}")
    x = data(10_000_000, VGG_BATCH)["image"]
    _, logits = q8_logits_parity(vgg16, params, state, x, q8, "VGG-16 q8")

    # Fig. 9: the ADC needs materialized psums, so every layer takes the
    # core path (models/common.py `_use_fused` / the q8 guard): 0 launches
    zero_counts()
    ev_adc = loop.evaluate(vgg16.apply, params, state, data, adc,
                           n_batches=Q8_EVAL_BATCHES, batch_size=VGG_BATCH)
    ev_noisy = loop.evaluate(vgg16.apply, params, state, data, adc,
                             n_batches=Q8_EVAL_BATCHES, batch_size=VGG_BATCH,
                             rng=1234)
    got_adc = read_counts()
    if any(got_adc.values()):
        fail(f"VGG-16 ADC eval launched {got_adc}; the ADC pass takes the "
             f"core path")
    n_adc, noisy = q8_logits_parity(vgg16, params, state, x, adc,
                                    "VGG-16 ADC (noisy)", rng=1234)
    _, clean = q8_logits_parity(vgg16, params, state, x, adc,
                                "VGG-16 ADC (noise-free)")
    if any(n_adc.values()) or torch.equal(noisy, clean):
        fail("VGG-16 ADC: launched a kernel, or the noise changed nothing")
    report["vgg16_path"] = {
        "params": n, "steps": VGG_STEPS, "batch": VGG_BATCH, "wall_s": wall,
        "qat_losses": losses, "launches_qat_and_q8_eval": got,
        "q8_eval": ev_q8, "launches_q8_eval": got_q8,
        "adc_eval_noise_free": ev_adc, "adc_eval_noisy": ev_noisy,
        "launches_adc_eval": got_adc,
        "q8_vs_adc_logits_max_abs_diff": float((logits - clean).abs().max())}
    print(f"VGG-16 q8 eval: {ev_q8}, launches {json.dumps(got_q8)}; q8 "
          f"logits bitwise equal between kernel and plain paths; Fig. 9 ADC "
          f"(4 bits) noise-free {ev_adc}, noisy {ev_noisy}: 0 launches (core "
          f"path), kernel mode == torch mode bitwise under one seed",
          flush=True)
    return got, (params, state)


def resnet_q8_path(dev, trained, report):
    """ResNet-18 width 64 q8 inference on the params the slice-2 path
    trained: K5 x 20, K4 x 1 per batch; bitwise kernel vs plain logits."""
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import resnet18
    from repro_torch.train import loop

    _, q8, _ = q8_modes()
    params, state = trained
    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(**CIFAR), device=dev)
    zero_counts()
    ev = loop.evaluate(resnet18.apply, params, state, data, q8,
                       n_batches=Q8_EVAL_BATCHES, batch_size=RESNET_BATCH)
    got = read_counts()
    if got != expect({}, q8_launches("resnet18"), 0, Q8_EVAL_BATCHES):
        fail(f"ResNet-18 q8 eval launched {got}")
    q8_logits_parity(resnet18, params, state,
                     data(10_000_000, RESNET_BATCH)["image"], q8,
                     "ResNet-18 q8")
    report["resnet18_q8"] = {"eval": ev, "launches": got}
    print(f"ResNet-18 width {RESNET_WIDTH} q8 eval ({Q8_EVAL_BATCHES} batches "
          f"of {RESNET_BATCH}): {ev}, launches {json.dumps(got)}; logits "
          f"bitwise equal between kernel and plain paths", flush=True)


def snn_path(dev, report):
    """The SNN at snn.init's defaults on DVS-Gesture-like events (T = 8,
    batch 32), CADC sublinear xbar 64: fp32 training through K3 / K1g / K2
    (every time step), then q8 inference through K5 / K4."""
    import dataclasses

    from repro_torch.data import synthetic
    from repro_torch.models.cnn import snn
    from repro_torch.models.common import LayerMode
    from repro_torch.train import loop, optimizer

    _, q8, _ = q8_modes("sublinear")
    mode = dataclasses.replace(q8, quant=LayerMode().quant, q8_fused=False)
    events = synthetic.make_event_dataset(n_classes=11, hw=SNN_HW,
                                          t_steps=SNN_T, seed=3, device=dev)

    def data(step, bs):
        b = events(step, bs)
        return {"image": b["events"], "label": b["label"]}

    cfg = loop.TrainConfig(steps=SNN_STEPS, batch_size=SNN_BATCH,
                           eval_every=1, eval_batches=Q8_EVAL_BATCHES)
    zero_counts()
    t0 = time.perf_counter()
    out = loop.train(init_fn=snn.init, apply_fn=snn.apply, batch_fn=data,
                     mode=mode, eval_mode=q8, optimizer=optimizer.adamw(1e-3),
                     cfg=cfg, device=dev)
    got = read_counts()
    wall = time.perf_counter() - t0
    train = {k: SNN_T * v for k, v in
             per_step_launches("snn", "cadc")[0].items()}
    want = expect(train, q8_launches("snn"), SNN_STEPS, Q8_EVAL_BATCHES)
    if got != want:
        fail(f"SNN launched {got}, want {want}")
    losses = [h["loss"] for h in out["history"]]
    if not all(math.isfinite(v) for v in losses + [out["eval"]["loss"]]):
        fail(f"SNN: non-finite losses {losses}")
    q8_logits_parity(snn, out["params"], out["state"],
                     data(10_000_000, SNN_BATCH)["image"], q8, "SNN q8")
    report["snn_path"] = {"steps": SNN_STEPS, "batch": SNN_BATCH,
                          "t_steps": SNN_T, "wall_s": wall,
                          "losses": losses, "q8_eval": out["eval"],
                          "launches": got}
    print(f"SNN (width {SNN_WIDTH}, hw {SNN_HW}, T {SNN_T}) CADC sublinear: "
          f"{SNN_STEPS} fp32 train steps at batch {SNN_BATCH} + "
          f"{Q8_EVAL_BATCHES} q8 eval batches in {wall:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, launches {json.dumps(got)} as "
          f"the layer list says; q8 logits bitwise equal between kernel and "
          f"plain paths", flush=True)


def time_vgg(dev, trained, report):
    """VGG-16 at full width: the q8 eval batch (ms p50, images/s, peak
    memory, profiler device time by kernel and idle share) and the QAT
    train step (ms p50, images/s, peak memory)."""
    from repro_torch.data import synthetic
    from repro_torch.models.cnn import vgg16
    from repro_torch.train import loop, optimizer

    qat, q8, _ = q8_modes()
    params, state = trained
    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(**CIFAR100), device=dev)
    batches = [data(i, VGG_BATCH) for i in range(4)]

    def timed(fn, n):
        times = []
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), times

    eval_step = loop.make_eval_step(vgg16.apply, q8)
    for i in range(2):
        eval_step(params, state, batches[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev_p50, ev_all = timed(lambda i: eval_step(params, state,
                                               batches[i % 4]), 10)
    ev_peak = torch.cuda.max_memory_allocated()
    def group(key: str) -> str:
        return ("K5 cadc_conv2d_q8 (tap)" if "q8_tap_kernel" in key
                else "K5 cadc_conv2d_q8 (gather)"
                if "ConvGather<signed char" in key
                else "K4 cadc_matmul_q8" if "q8_mma_kernel" in key
                else "other (PyTorch)")

    wall_ms, busy, _, groups = profile_device(
        lambda i: eval_step(params, state, batches[i % 4]), 3, group,
        "the VGG-16 q8 eval")

    opt = optimizer.adamw(1e-3)
    step = loop.make_train_step(vgg16.apply, qat, opt)
    p, s, o = params, state, opt.init(params)
    for i in range(2):
        p, s, o, _ = step(p, s, o, batches[i], i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    holder = [p, s, o]

    def one(i):
        holder[0], holder[1], holder[2], _ = step(*holder, batches[i % 4],
                                                  2 + i)

    tr_p50, tr_all = timed(one, 6)
    tr_peak = torch.cuda.max_memory_allocated()
    report["vgg16_timing"] = {
        "batch": VGG_BATCH,
        "q8_eval_ms_p50": ev_p50, "q8_eval_ms_all": ev_all,
        "q8_eval_images_per_s": VGG_BATCH / (ev_p50 / 1e3),
        "q8_eval_peak_memory_bytes": ev_peak,
        "q8_eval_profiled_wall_ms": wall_ms,
        "q8_eval_device_busy_ms": busy,
        "q8_eval_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "q8_eval_device_ms_by_kernel": groups,
        "qat_step_ms_p50": tr_p50, "qat_step_ms_all": tr_all,
        "qat_images_per_s": VGG_BATCH / (tr_p50 / 1e3),
        "qat_peak_memory_bytes": tr_peak}
    print(f"VGG-16 q8 eval (batch {VGG_BATCH}): p50 {ev_p50:.2f} ms, "
          f"{VGG_BATCH / (ev_p50 / 1e3):.0f} images/s, peak memory "
          f"{ev_peak / 2**30:.2f} GiB; profiler: device busy {busy:.2f} of "
          f"{wall_ms:.2f} ms per batch (idle share "
          f"{max(0.0, 1.0 - busy / wall_ms):.3f})", flush=True)
    for gname, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {gname}: {g['ms']:.3f} ms/batch over {g['calls']:.0f} "
              f"launches", flush=True)
    k5 = [g for gname, g in groups.items() if gname.startswith("K5")]
    report["vgg16_timing"]["q8_eval_k5_ms"] = sum(g["ms"] for g in k5)
    print(f"  K5 in all: {sum(g['ms'] for g in k5):.3f} ms/batch over "
          f"{sum(g['calls'] for g in k5):.0f} launches", flush=True)
    print(f"VGG-16 QAT train step (batch {VGG_BATCH}): p50 {tr_p50:.2f} ms, "
          f"{VGG_BATCH / (tr_p50 / 1e3):.0f} images/s, peak memory "
          f"{tr_peak / 2**30:.2f} GiB", flush=True)


def time_q8_kernels(dev, launches, report):
    """Device ms of K4 and K5 per q8 eval batch of each path (every layer
    at its shape; the kernels line takes VGG-16's, the main path), beside
    the plain version, a library call of the vConv (identity) function —
    F.conv2d on fp32 codes (TF32 off) for K5, torch._int_mm for K4 (N
    padded to a multiple of 8 where its shape rules need it) — and the
    bound: bytes at 3.35 TB/s or int8 operations at 1979 TOPS; K5 also
    per conv shape, with its plan and the gather kernel's time at that
    shape; K4 also per FC shape, with its plan, the int8 tile kernel it
    replaced (OLD_K4) and the launch floor (a one-element add_ under the
    same replay). CUDA-graph replay over operand copies that hold 3x the
    L2, as time_k1."""
    import torch.nn.functional as F

    import profile_k4
    from repro_torch.kernels import cadc_conv as cc
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(23)
    scale = torch.tensor(0.0123, device=dev)
    xbar, fn = 64, "relu"
    per_path = {}
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.add_(1), 20)

    def timed(make, kernel, plain, lib, other=None):
        first = make()
        ops_set = [first] + rotation(make, sum(
            t.numel() * t.element_size() for t in first))[1:]
        reps = max(20, len(ops_set))
        pick = itertools.cycle(ops_set).__next__
        k = keep_counts(lambda: device_ms(lambda: kernel(*pick()), reps))
        pl = keep_counts(lambda: device_ms(lambda: plain(*pick()), reps))
        lb = None if lib is None else device_ms(lambda: lib(*pick()), reps)
        if other is None:
            return k, pl, lb
        return k, pl, lb, device_ms(lambda: other(*pick()), reps)

    for model in ("vgg16", "resnet18", "snn"):
        t = SNN_T if model == "snn" else 1
        tot = {"k5": [0.0, 0.0, 0.0, 0.0, 0.0], "k4": [0.0] * 5}
        shapes = {}
        for _, b, h, cin, k, cout, st, pad in conv_layers(model):
            key = (b, h, cin, k, cout, st, pad)
            shapes[key] = shapes.get(key, 0) + t
        per_shape = {}
        for (b, h, cin, k, cout, st, pad), count in shapes.items():
            w = _codes(gen, dev, (k, k, cin, cout), -1, 2)
            w_oihw = w.float().permute(3, 2, 0, 1).contiguous()
            oh = conv_out_hw(h, k, st, pad)
            m, d = b * oh * oh, k * k * cin
            kw = dict(crossbar_size=xbar, fn=fn, stride=(st, st),
                      padding=pad)
            cpad = 0 if pad == "VALID" else k // 2
            plan = cc.plan_conv_q8(m, cout, cin, xbar)
            gather = cc.plan_conv_q8(m, cout, cin, xbar,
                                     _force=("gather", cc.GATHER_TILE))
            ms, pl, lb, g_ms = timed(
                lambda: (_codes(gen, dev, (b, h, h, cin), -7, 8),),
                lambda x: cc.cadc_conv2d_q8_cuda(x, w, scale, **kw),
                lambda x: cc.cadc_conv2d_q8_torch(x, w, scale, **kw),
                lambda x: F.conv2d(x.float().permute(0, 3, 1, 2), w_oihw,
                                   stride=st, padding=cpad),
                lambda x: cc._conv_launch(
                    "k5", x, w, xbar, fn, (st, st), pad, "none", scale,
                    plan=gather))
            nbytes = b * h * h * cin + d * cout + 4 * m * cout + 4
            for i, v in enumerate((ms, pl, lb, nbytes, 2 * m * d * cout)):
                tot["k5"][i] += count * v
            b_ms, _ = bound_ms(nbytes, 2 * m * d * cout, torch.int8)
            name = f"B{b}.H{h}.C{cin}.K{k}.O{cout}.s{st}"
            per_shape[name] = {
                "count_per_batch": count,
                "plan": f"{plan.kernel} {plan.tile[0]}x{plan.tile[1]}",
                "blocks": plan.blocks, "ms": ms, "gather_ms": g_ms,
                "library_ms": lb, "bound_ms": b_ms}
            print(f"K5 {model} {name} x{count}: plan "
                  f"{per_shape[name]['plan']} ({plan.blocks} blocks), "
                  f"{ms:.4f} ms, gather kernel {g_ms:.4f}, F.conv2d "
                  f"{lb:.4f}, bound {b_ms:.4f}", flush=True)
        fc_shapes = {}
        for name, m, d, n in q8_fc_shapes():
            if not name.startswith(model):
                continue
            dp = -(-d // xbar) * xbar
            w = _codes(gen, dev, (dp, n), -1, 2)
            n8 = -(-n // 8) * 8
            w8 = torch.zeros((dp, n8), dtype=torch.int8, device=dev)
            w8[:, :n] = w
            ms, pl, lb, old = timed(
                lambda m=m, dp=dp: (_codes(gen, dev, (m, dp), -7, 8),),
                lambda x: cm.cadc_matmul_q8_cuda(x, w, scale,
                                                 crossbar_size=xbar, fn=fn),
                lambda x: cm.cadc_matmul_q8_torch(x, w, scale,
                                                  crossbar_size=xbar, fn=fn),
                (lambda x: torch._int_mm(x, w8)) if m > 16 else None,
                lambda x: profile_k4.old_call(OLD_K4["lib"], x, w, scale,
                                              crossbar_size=xbar, fn=fn))
            nbytes = m * dp + dp * n + 4 * m * n + 4
            for i, v in enumerate((ms, pl, lb, nbytes, 2 * m * dp * n)):
                tot["k4"][i] += t * (v if v is not None else math.nan)
            plan = cm.plan_fwd_q8(m, n, dp // xbar, xbar)
            b_ms, _ = bound_ms(nbytes, 2 * m * dp * n, torch.int8)
            fc_shapes[name] = {
                "M": m, "D": dp, "N": n, "count_per_batch": t,
                "plan": f"{plan.groups} group{'s' * (plan.groups > 1)}, "
                        f"{plan.blocks} blocks",
                "ms": ms, "old_tile_kernel_ms": old, "library_ms": lb,
                "bound_ms": b_ms, "launch_floor_ms": floor}
            print(f"K4 {name} M={m} D={dp} N={n} x{t}: plan "
                  f"{fc_shapes[name]['plan']}, {ms * 1e3:.2f} us, old tile "
                  f"kernel {old * 1e3:.2f}, torch._int_mm "
                  f"{'-' if lb is None else f'{lb * 1e3:.2f}'}, bound "
                  f"{b_ms * 1e3:.3f}, launch floor {floor * 1e3:.2f}",
                  flush=True)
        per_path[model] = {}
        for key, (ms, pl, lb, nbytes, ops) in tot.items():
            b_ms, b_by = bound_ms(nbytes, ops, torch.int8)
            per_path[model][key] = {
                "ms": ms, "plain_ms": pl,
                "library_ms": None if math.isnan(lb) else lb,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "ops": ops, "launches_per_batch": q8_launches(model)[
                    "cadc_conv2d_q8" if key == "k5" else "cadc_matmul_q8"]}
            if key == "k5":
                per_path[model][key]["per_shape"] = per_shape
            else:
                per_path[model][key]["per_shape"] = fc_shapes
                per_path[model][key]["launch_floor_ms_per_batch"] = (
                    floor * q8_launches(model)["cadc_matmul_q8"])
            print(f"{model} q8 eval batch, {key.upper()}: {ms:.3f} ms (plain "
                  f"{pl:.3f}, library {lb:.3f}, bound {b_ms:.4f} by {b_by}) "
                  f"over {per_path[model][key]['launches_per_batch']} "
                  f"launches", flush=True)
    report["q8_kernel_timing"] = {
        "unit": "one q8 eval batch of each path (VGG-16 and ResNet-18 at "
                "batch 128, the SNN at batch 32 x T 8), xbar 64, relu",
        "per_path": per_path,
        "library": "vConv yardsticks: F.conv2d on fp32 codes (NCHW view, "
                   "TF32 off) for K5; torch._int_mm for K4 (N padded to a "
                   "multiple of 8)"}
    rows = []
    for key, name, src, rep in (
            ("k4", "cadc_matmul_q8", "src/repro_torch/csrc/cadc_matmul.cu",
             "src/repro/kernels/cadc_matmul.py:419"),
            ("k5", "cadc_conv2d_q8", "src/repro_torch/csrc/cadc_conv.cu",
             "src/repro/kernels/cadc_conv.py:226")):
        r = per_path["vgg16"][key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": Q8_MAX_ABS[key], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
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
    launches, base = serve_main_path(cfg, params, dev, report)
    fp32_logits_check(cfg, params, dev, report)
    gap = verify_gap(cfg, params, dev, report)
    serve_spec(cfg, params, dev, base, gap, report)
    del params
    torch.cuda.empty_cache()

    check_k1_slice5(dev, report)
    check_k6_slice5(dev, report)
    moe_main_path(dev, report)
    moe_fp32_logits(dev, report)
    vit_path(dev, report)

    lenet_path(dev, report)
    ckpt_resume(dev, report)
    training_parity(dev, report)
    train_launches, resnet_trained = resnet_main_path(dev, report)
    time_resnet_step(dev, report)
    torch.cuda.empty_cache()

    # after the training steps' peak-memory readings: device_ms runs each
    # call's warm-up on a new side stream, and PyTorch keeps the cuBLAS
    # workspace it allocates for every stream cuBLAS has run on
    time_k1_slice5(dev, report)
    time_k1(cfg, dev, launches, report, m=N_SLOTS * (SPEC_K + 1))
    kernels = [time_k1(cfg, dev, launches, report),
               time_k6(cfg, dev, launches, report),
               *time_train_kernels(dev, train_launches, report)]
    torch.cuda.empty_cache()

    check_k4(dev, report)
    check_k5(dev, report)
    q8_launch_counts, vgg_trained = vgg_main_path(dev, report)
    resnet_q8_path(dev, resnet_trained, report)
    del resnet_trained
    snn_path(dev, report)
    time_vgg(dev, vgg_trained, report)
    del vgg_trained
    torch.cuda.empty_cache()
    kernels += time_q8_kernels(dev, q8_launch_counts, report)
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
