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

Slice 6, the recurrent LM families (after slice 5's phases):
  6a. K1 against its plain version at each of the 10 linear shapes of
     recurrentgemma-9b and xlstm-1.3b at published width (mLSTM's 4096 ->
     8 gates, sLSTM's 2048 -> 2730 and 2730 -> 2048 padded to 2816, the MQA
     4096 -> 256, xlstm's untied head), M = 8 (a decode step; a recurrent
     prefill's rows a token) and 32 (a verify step's attention rows), fp32
     (TF32 off) and bf16, relu;
  6b. K6 at recurrentgemma-9b's geometry (MQA: 16 q heads over 1 kv head
     of 256, R = 16 rows at decode and 64 at Q = 4) on the main path's
     160-entry rings and the verify step's 176, as phase 3 does: every
     plan, NaN in dead entries, an idle slot;
  6c. recurrentgemma-9b at published width and REC_LAYERS 8 of its 38
     layers (2 x (rglru, rglru, local) + (rglru, rglru); random bf16
     weights from seed 0) on phase 4's engine and the first REC_REQUESTS
     requests of its workload: all
     finish, K1 62 and K6 2 launches a decode step, a prefill's K1 from
     its bucket (the recurrent layers run their cell a token at a time),
     step ms, tok/s, TTFT, peak memory, and the device time per decode
     step under the profiler split into K1, K6, the recurrent cells' own
     PyTorch kernels (profiler ranges, `rec_spans`) and other PyTorch;
     then its verify gap (bf16, kernels on) and `serve_spec` on the same
     requests under the oracle and the anti-oracle (every verify step
     rolls each recurrent layer back to the kept token): exact launch
     counts, the anti-oracle accepts nothing, every stream equal to
     greedy or leaving it at a near-tie below the gap;
  6d. recurrentgemma-9b at 3 layers (rglru, rglru, local) in fp32: phase
     5's kernel-vs-plain logits check;
  6e. xlstm-1.3b at published width and 8 of its 48 layers (7 mlstm +
     slstm; no KV pool) the same way: K1 47 launches a decode
     step, no K6; then at 2 layers (mlstm, slstm) in fp32;
  6f. (timed after the training phases, beside 5f) K1 device times at
     M = 8 at every shape of 6a beside torch.matmul, the plain version and
     the bound; each config's K1 time a decode step.

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

Slice 7, LM training (after slice 2's training phases; bf16 compute on
fp32 masters, TF32 off):
 19. K1g (K1 under 'recompute') and K2 against their plain versions at
     the LM paths' 11 linear shapes (gemma3-1b's 7, hubert-xlarge's, the
     qwen2-moe-a2.7b head's N = 152 064) at M = 2048 rows a microbatch,
     crossbar 256, relu, bf16 and fp32 operands (K2 on their fp32 casts,
     as the backward runs it), save_gate packed / bytes / recompute; K2
     under the planner's plan and one forced plan per shape, dx bitwise;
 20. the slice's main path: gemma3-1b at full width (26 layers, 1.05 B
     parameters, random weights from seed 0, CADC relu at crossbar 256,
     remat on, make_optimizer's AdamW) trained through
     repro_torch.launch.train: 6 steps of 8 x 1024 synthetic LM tokens in
     4 microbatches; a finite loss at every step, exact launch counts (K1g
     1456 and K2 728 a step: 182 CADC linears x 4 micros, K1g once more in
     the non-reentrant remat recompute; no K1), step ms (host clock, and
     CUDA events over 2 more steps), tokens/s, peak memory, and the
     profiler's device time per step split into K1g, K2 dx / dw, the tied
     head's bf16 GEMMs, attention's fp32 GEMMs and other PyTorch;
 21. kernel path against plain path at published width: gemma3-1b at 2
     layers in fp32 (loss and every gradient within 1e-4 of scale) and in
     bf16 (loss within LM_BF16_LOSS_RTOL), hubert-xlarge at 4 layers in
     fp32 (frames, bidirectional attention, the gelu FFN, the untied
     504-way head), qwen2-moe-a2.7b at 2 layers in fp32 and bf16 (the aux
     loss, the expert banks' backward, the 152 064-wide head); exact
     launch counts, none on the plain path; gemma3-1b's prefill step (K1
     only) against the plain path's logits;
 22. lm_resume: gemma3-1b at 2 layers, 4 steps straight against 2 steps
     that save and a resume to 4 through the train CLI's --ckpt-dir: params
     and AdamW moments bitwise, exact launch counts;
 23. the twin of examples/lm_cadc_train.py (gemma3-1b smoke, crossbar 64,
     200 steps): the loss decreases, exact launch counts;
 24. (timed after the training phases, beside phase 12) K1g and K2 device
     times at gemma3-1b's 7 linear shapes at M = 2048, summed over a
     train step, beside their plain versions, torch.matmul (bf16; the
     fp32 dx / dw pair), the bound and the backward's fp32 copies: the
     kernels line's K1g and K2 rows gain the LM step ("lm_step").

Slice 8, the recurrent families trained (after slice 7's gemma3-1b
path; bf16 compute on fp32 masters, TF32 off):
 25. K1g and K2 as in phase 19 at recurrentgemma-9b's and xlstm-1.3b's 10
     train shapes (lm_kernel_shapes: 4096 -> 4096 / 256 / 12 288, 12 288
     -> 4096; 2048 -> 8192, 4096 -> 8 (the mLSTM gates, 2H), 4096 ->
     2048, 2048 -> 2730 and 2730 (2816 padded) -> 2048 (the sLSTM GeGLU),
     the untied head 2048 -> 50 432), M = 2048;
 26. recurrentgemma-9b at full width and 3 layers (rglru, rglru, local;
     1.705 B parameters) trained through repro_torch.launch.train as
     phase 20 does: REC_TRAIN_STEPS steps of 8 x 1024 tokens in 4 micros,
     then 2 timed and 1 profiled; a finite loss at every step, finite
     parameters, one micro's gradients all finite, exact launch counts
     (K1g 184 and K2 92 a step: 23 linears x 4 micros, K1g twice under
     remat; the tied head on torch.matmul), step ms, tokens/s, peak
     memory, the busy split and the idle share;
 27. xlstm-1.3b at full width and 8 layers (7 mLSTM + sLSTM; 0.773 B) the
     same way at 2 x 1024 tokens in 1 micro (the chunkwise mLSTM, 4
     chunks of 256; K1g 93 = 2 x 46 + the untied head and K2 47 a step);
     its sLSTM loop leaves the card waiting on the host;
 28. (in phase 21's lm_parity) recurrentgemma-9b at 3 layers over 1 x
     2560 tokens (its 2048 window bites) and xlstm-1.3b at 8 over 1 x 512
     (two mLSTM chunks), fp32 (loss and every gradient) and bf16 (loss);
 29. each training form against its decode cell at full width in fp32,
     one layer, 2 x REC_FORM_S tokens (rglru_apply / rglru_decode, the
     chunkwise mLSTM / its sequential form / mlstm_decode, slstm_apply /
     slstm_decode) within REC_FORM_RTOL; then the costs of the RG-LRU
     scan, the chunkwise mLSTM and an sLSTM block at a train micro's
     shape under the profiler (wall, busy, device operations; the sLSTM's
     a token, forward and backward);
 30. (after phase 24) the kernels line's K1g and K2 rows gain both
     recurrent paths' launches and "<arch>_step": launches a step, the
     profiler's device ms a step and the bound of the step's linears.

Slice 9, multi-device training (one card: NCCL refuses two ranks on one
device, so the multi-rank step and CLI are tested on the CPU over gloo):
 31. phases 20, 22, 23, 26 and 27 run the train CLI's mesh form: main()
     opens a one-rank NCCL group first, the CLI joins it, and its FSDP
     step (steps.make_fsdp_train_step) makes every collective at world 1
     (the gathers, reduce-scatters and all-reduces; at one rank NCCL
     copies the first two's buffers and skips an in-place all-reduce);
     the timed and profiled steps are the CLI's own step, the profile
     splits out the collectives, and every kernel must run on one stream;
 32. tp_cadc: the tensor-parallel CADC linear (parallel/tp_cadc.py) at
     gemma3-1b's w_down (6912 -> 1152, crossbar 128, 54 segments) and
     w_gate (1152 -> 6912, crossbar 64, 18), M = 8 and 2048: at one rank
     on NCCL, fp32 wire, bitwise the unsharded K1; over 2 ranks spawned
     on the one card over gloo (CUDA tensors), K1 once a rank a call,
     fp32 wire within 1e-5 of scale and bf16 wire within 0.01 relative of
     the unsharded K1 (the JAX test's bounds).

Slice 10, tensor parallelism over "model" inside the LM step:
 33. the step of phase 31 is the TP-aware one (launch/steps.py: FSDP over
     "data", TP over "model", DP over "pod"), here at (data 1, model 1):
     the same exact K1g / K2 counts;
 34. in phase 32's two spawned ranks, after the TP linear: the LM train
     step at (data 1, model 2) over gloo on gemma3-1b at full width, 2
     layers, CADC relu at crossbar 128 (wo over 4 and w_down over 27 local
     segments a rank through K1g / K2, the vocab-parallel tied head and
     loss over 131 072 rows a rank), 2 steps of 2 x 1024 tokens in 2
     micros under AdamW at a constant lr, in bf16 and in fp32, against
     make_train_step on the card: bf16 losses within 1e-3 relative; fp32
     losses within 1e-5, step 1's gradients leaf by leaf and the clip's
     norm within 1e-2, step 2's gradients and the params' change within
     0.1 (read through seeded probes of the whole leaves); two planted
     faults (w_down's all-reduce, the FFN's copy_to backward) must fail
     the 1e-2 gate; the ranks' losses
     equal, K1g / K2 launches a rank exact; the kernels line's K1g and K2
     rows gain them.

Slice 11, the serving steps over the mesh (launch/steps.py
make_mesh_prefill_step / make_mesh_serve_step):
 35. (after the kernel checks) the twin of examples/quickstart.py on the
     card: K1 once, within its bound of the sequential oracle;
 36. (in main()'s one-rank NCCL group, after gemma3-1b's training)
     gemma3-1b at full width (26 layers, bf16 on fp32 masters, CADC relu
     at crossbar 256) at (data 1, model 1): the mesh prefill of 8 prompts
     of 64..128 tokens and 16 decode steps from the dense caches the
     one-device batched prefill filled, fed the one-device steps' tokens:
     logits, tokens and caches bitwise make_prefill_step /
     make_serve_step, K1 exact on both sides (182 a pass);
 37. in phase 32's two spawned ranks, after the TP step, at (data 1,
     model 2) over gloo: gemma3-1b at 6 layers (both ring kinds
     length-parallel) and phi4-mini-3.8b at 2 (head-parallel), a prefill
     and 8 decode steps in fp32 (TF32 off: logits within LOGITS_RTOL of
     the one-device steps on the card, fed the same tokens) and bf16
     (reported), K1 a rank exact; the planted merge fault (each rank's
     own partial softmax) must fail the fp32 gate; the kernels line's K1
     row gains these launches ("mesh_serve_launches").

Slice 12, sequence parallelism over "model" and the RG-LRU
channel-parallel (TP_PHASES, in phase 32's two spawned ranks over gloo):
 38. after the TP step, the SP step: phase 34's runs under seq_sharding
     (the residual stream each rank's 512-token block, the TP regions
     entered by an all-gather along S and left by a reduce-scatter, K1g /
     K2 on the same local segments), held to the same one-rank step at
     the same bounds; the planted fault "norm" (the norms' gradient sums
     over "model" skipped) must fail the 1e-2 gate;
 39. last in the ranks, recurrentgemma-9b at full width, 3 layers
     (rglru, rglru, local), CADC relu at crossbar 256, fp32, 2 steps of
     one micro of 1 x 1024 tokens, the RG-LRU channel-parallel (w_out
     row-parallel over 8 local segments a rank) against make_train_step
     on the card (run after the ranks end) at the same bounds; the
     planted fault "channels" (lam and the conv's bias read at the other
     rank's block) must fail the gate; the RG-LRU leaves' all-gathered
     bytes over "model" a step, before the channel-parallel form and
     now (none);
 40. (main()'s one-rank NCCL group, after phase 32) the SP step at (data
     1, model 1): phase 34's bf16 config, 2 steps with and without
     seq_sharding, bitwise, K1g / K2 exact. The kernels line's K1g and
     K2 rows gain each of these phases' launches a rank.

The bf16 tensor-core kernel of K1 / K1g (`bf16_mma_kernel`, plan kernel
"mma" of `plan_fwd(dtype=bf16)`): phase 19 also holds every mma
plan (`mma_plans`: each row tile at each segment-group count) bitwise the
planner's at each LM shape (y, the packed gate words, and K1's y:
`check_mma_plans`); phases 2, 5a and 6a check it at M = 32 and above;
phases 6, 24 and 30 time the CUDA-core tile kernel it replaced on bf16,
under its former plan, beside it (the verify step's K1, K1 at prefill —
w_gate at M = 1024, also beside torch.matmul and its plain version — and
the LM steps' K1g); the LM profiles count it as K1g, the decode and
verify profiles as K1; it must not spill.

The decode profiles (phase 6 and its later twins) count K1 and K6 with
the wrappers' launch counters over the profiled steps (exact: K1 as
k1_per_pass says, K6 once an attention layer a step) and report the
kernel records the profiler lost beside them (the device times are "not
measured" past 1 %).

Prints the serving and training metrics, the card's name and power limit,
one JSON line of kernel records and, last, {"ok": true, "device": {...}}.
`--report PATH` also writes the full record (per-shape times, ptxas
register counts, profiler breakdown) to PATH as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# Slice 6, the recurrent LM families: recurrentgemma-9b (RG-LRU with local
# MQA attention) and xlstm-1.3b (mLSTM / sLSTM, no attention) at full width
# on the main path's engine, the first REC_REQUESTS requests of its
# workload, and recurrentgemma's speculative path on the same requests:
# a recurrent prefill runs the decode cell a token at a time, ~70
# launches a layer a token, so a 128-token prefill is host-bound for
# seconds (PERF.md §5), and the request count is cut from 16.
# The main paths run recurrentgemma-9b at REC_LAYERS 8 of its 38 layers
# (two (rglru, rglru, local) units and its (rglru, rglru) tail) and
# xlstm-1.3b at 8 of 48 (one 7 mLSTM + sLSTM unit), widths as published:
# the prefill's host time is linear in the depth, and the later slices'
# phases need the time (PERF.md §4; 14 / 16 layers in PRs 20-21, 38 / 48
# before).
SLICE6_ARCHS = ("recurrentgemma_9b", "xlstm_13b")
RG_ARCH, XL_ARCH = SLICE6_ARCHS
REC_REQUESTS = 3
REC_LAYERS = {RG_ARCH: 8, XL_ARCH: 8}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


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


# Windows profile_device takes before it gives up on a profile that shows
# no device time (a window loses ~39 kernel records at its start, so one
# of a few dozen launches can show none: PERF.md §6, PR 26).
PROFILE_TRIES = 3


def profile_device(run, n: int, group, what: str, cpu: bool = True,
                   streams: list = None, required: bool = True):
    """torch.profiler over run(0) .. run(n - 1), CUDA events around them:
    (wall ms per call under the profiler, device-busy ms per call, rows
    [(ms per call, kernel name, launches per call)] largest first, and the
    rows summed by group(name) into {group: {"ms", "calls"}}). cpu=False
    traces the device alone (a train step of ~100 k host ops takes tens of
    seconds to trace on the host; the rows need only the kernels).
    `streams`, a list, gets the id of every stream the device work ran
    on. The window opens after a synchronize: work queued before it
    stays outside. A window whose profile shows no device time is taken
    again, up to PROFILE_TRIES windows in all (run is called again); if
    none shows any, a required profile fails the run, and any other
    returns the CUDA events' wall time with busy None (not measured) and
    no rows."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]
                     + ([ProfilerActivity.CPU] if cpu else [])) as prof:
            start.record()
            for i in range(n):
                run(i)
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end) / n
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
        if busy > 0:
            break
        print(f"profiler: no device time seen over {what} (window "
              f"{attempt} of {PROFILE_TRIES})", flush=True)
    else:
        if required:
            fail(f"profiler: no device time seen over {what} in "
                 f"{PROFILE_TRIES} windows")
        return wall, None, [], {}
    if streams is not None:
        streams.extend(sorted({e.device_resource_id for e in prof.events()
                               if "CUDA" in str(e.device_type)}))
    groups = {}
    for ms, key, calls in rows:
        g = groups.setdefault(group(key), {"ms": 0.0, "calls": 0.0})
        g["ms"] += ms
        g["calls"] += calls
    return wall, busy, rows, groups


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# Kernels that must compile without spills (ptxas' report of each
# instantiation): K3's tap-aligned kernel, the conv backward's dgrad and
# wgrad kernels, K5's int8 tap kernel, K2's dx and dw kernels (saved
# gates and recompute, and the bf16 tensor-core ones), K6, K4's int8
# tensor-core kernel, K1 / K1g's bf16 tensor-core kernel.
NO_SPILL_KERNELS = ("tap_tile_kernel", "dgrad_kernel", "wgrad_kernel",
                    "q8_tap_kernel", "bwd_dx_kernel", "bwd_dw_kernel",
                    "bwd_dx_recompute_kernel", "bwd_dw_recompute_kernel",
                    "paged_attention_kernel", "q8_mma_kernel",
                    "bf16_mma_kernel", "bf16_bwd_dx_kernel",
                    "bf16_bwd_dw_kernel")
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
    a layer's four attention linears and three FFN linears (two for the
    gelu FFN; an MoE layer's shared experts, d_shared wide; a routed-only
    MoE layer has none: its experts are batched GEMMs), then an untied
    head and the vit or audio frontend's projection."""
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
        out += ([] if cfg.ffn_type == "gelu" and not cfg.moe.n_experts
                else [("w_gate", pad(d), d_ff)])
        out += [("w_up", pad(d), d_ff), ("w_down", pad(d_ff), d)]
    if not cfg.tie_embeddings:
        out.append(("head", pad(d), cfg.padded_vocab))
    if cfg.frontend is not None:
        out.append(("frontend_proj", pad(cfg.frontend_dim), d))
    return out


ATTN_KINDS = ("global", "local")


def kind_linear_shapes(cfg, kind: str):
    """(name, D padded to whole crossbars, N) of the K1 launches of one
    token through one layer of `kind`: an attention layer's (linear_shapes
    without the head and the frontend), an rglru layer's five RG-LRU
    linears and its FFN, an mLSTM block's six (its up-projection to 2 x 2d,
    q / k / v over d_inner 2d, the 2H gate pre-activations, the
    down-projection), an sLSTM block's four (the 4d gates, the 4/3 GeGLU
    up / gate and its down-projection)."""
    from repro_torch.core.cadc import num_segments
    from repro_torch.models.lm import xlstm

    if kind in ATTN_KINDS:
        return [s for s in linear_shapes(cfg)
                if s[0] not in ("head", "frontend_proj")]
    xb = cfg.crossbar_size
    pad = lambda d: num_segments(d, xb) * xb  # noqa: E731
    d = cfg.d_model
    if kind == "rglru":
        rw = cfg.rnn_width or d
        return [("w_gate", pad(d), rw), ("w_x", pad(d), rw),
                ("w_r", pad(rw), rw), ("w_i", pad(rw), rw),
                ("w_out", pad(rw), d), ("ffn.w_gate", pad(d), cfg.d_ff),
                ("ffn.w_up", pad(d), cfg.d_ff),
                ("ffn.w_down", pad(cfg.d_ff), d)]
    if kind == "mlstm":
        di = int(xlstm.PROJ_FACTOR_M * d)
        return [("w_up", pad(d), 2 * di), ("w_q", pad(di), di),
                ("w_k", pad(di), di), ("w_v", pad(di), di),
                ("w_if", pad(di), 2 * cfg.n_heads), ("w_down", pad(di), d)]
    if kind == "slstm":
        dp = int(xlstm.PROJ_FACTOR_S * d)
        return [("w_gates", pad(d), 4 * d), ("w_up_gate", pad(d), dp),
                ("w_up", pad(d), dp), ("w_down", pad(dp), d)]
    fail(f"unknown layer kind {kind!r}")


def k1_per_pass(cfg, prefill: bool = False, tokens: int = 1) -> int:
    """K1 launches of one forward: a decode step (tokens 1), a verify step
    of `tokens` columns, or a batched prefill (prefill=True) over a bucket
    of `tokens` positions. Each attention layer's linears launch once (all
    tokens are rows of one product); each recurrent layer's once a token
    (its cell runs a token at a time, as decode does); an untied head once
    (a verify step's once a column); at a vit prefill also the frontend's
    projection."""
    per_kind = {k: len(kind_linear_shapes(cfg, k))
                for k in set(cfg.pattern_for_layers)}
    layers = sum(per_kind[k] * (1 if k in ATTN_KINDS else tokens)
                 for k in cfg.pattern_for_layers)
    head = (not cfg.tie_embeddings) * (1 if prefill else tokens)
    return layers + head + (prefill and cfg.frontend == "vit")


def n_attn_layers(cfg) -> int:
    """K6 launches of a decode or verify step: one an attention layer."""
    return sum(k in ATTN_KINDS for k in cfg.pattern_for_layers)


def record_prefill_buckets(obj) -> list:
    """Wrap obj._prefill_fn (the engine's batched prefill step) to append
    each call's bucket (the prompt width) to the returned list: a
    recurrent layer's K1 launches a prefill follow its bucket."""
    buckets, fn = [], obj._prefill_fn

    def wrapped(params, batch, lengths):
        buckets.append(int(batch["tokens"].shape[1]))
        return fn(params, batch, lengths)

    obj._prefill_fn = wrapped
    return buckets


def k1_prefills(cfg, buckets) -> int:
    return sum(k1_per_pass(cfg, prefill=True, tokens=s) for s in buckets)


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


def serve_main_path(cfg, params, dev, report, key="serve", n_requests=16):
    """The main path (or a later slice's under its own key: qwen2-moe-a2.7b
    "serve_moe", recurrentgemma-9b "serve_rg", xlstm-1.3b "serve_xl"): the
    engine at full width on the main path's workload (its first
    n_requests requests); returns launch counts and the run's streams. K1
    must launch as k1_per_pass says for every decode step and for every
    prefill at its bucket, K6 once an attention layer a decode step; a
    kernel the config runs must have launched."""
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
                                seed=0)[:n_requests]
    buckets = record_prefill_buckets(engine)
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
    want = {"cadc_matmul": k1_per_pass(cfg) * n_dec
            + k1_prefills(cfg, buckets),
            "paged_attention": n_attn_layers(cfg) * n_dec}
    for name, n in launches.items():
        if n != want[name] or (name == "cadc_matmul" and n <= 0):
            fail(f"{name} launched {n} times on the main path, want "
                 f"{want[name]} ({n_dec} decode steps, {n_pre} prefills at "
                 f"buckets {buckets})")
    print(f"serve {cfg.name} full width bf16 cadc: {len(workload)} requests, "
          f"{summary['decode_tokens']} decode tokens, {n_dec} decode steps, "
          f"{n_pre} prefills (buckets {buckets}), {wall:.2f} s", flush=True)
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
                       launches=launches, prefill_buckets=list(buckets),
                       k1_per_decode_step=k1_per_pass(cfg),
                       k6_per_decode_step=n_attn_layers(cfg))
    base = {"workload": workload, "summary": summary,
            "tokens": [engine.results[rid].tokens
                       for rid in sorted(engine.results)]}
    profile_decode(engine, cfg, report, key=key)
    return launches, base


MOE_SPANS = ("moe block", "moe expert products", "moe shared FFN")
REC_SPANS = ("recurrent cell", "linear")


def wrap_spans(targets):
    """Wrap each (module, function name, label) of `targets` in a profiler
    range of that label; returns the function that unwraps them."""
    from torch.profiler import record_function

    saved = [(mod, name, label, getattr(mod, name))
             for mod, name, label in targets]
    for mod, name, label, fn in saved:
        def wrapped(*a, fn=fn, label=label, **kw):
            with record_function(label):
                return fn(*a, **kw)
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, _, fn in saved:
            setattr(mod, name, fn)
    return restore


def moe_spans():
    """Wrap the MoE block, its expert products and its shared FFN in
    profiler ranges (MOE_SPANS)."""
    from repro_torch.models.lm import ffn as ffn_lib
    from repro_torch.models.lm import moe as moe_lib

    return wrap_spans([(moe_lib, "moe_apply", MOE_SPANS[0]),
                       (moe_lib, "_expert_linear", MOE_SPANS[1]),
                       (ffn_lib, "ffn_apply", MOE_SPANS[2])])


def rec_spans():
    """Wrap the recurrent decode cells (rglru_decode, mlstm_decode,
    slstm_decode: their linears, conv step, gates and state arithmetic)
    and every linear_apply in profiler ranges (REC_SPANS): a cell's own
    PyTorch kernels are the cell range less the linear ranges inside it."""
    from repro_torch.models.lm import layers as ll
    from repro_torch.models.lm import rglru as rglru_lib
    from repro_torch.models.lm import xlstm as xlstm_lib

    return wrap_spans([(rglru_lib, "rglru_decode", REC_SPANS[0]),
                       (xlstm_lib, "mlstm_decode", REC_SPANS[0]),
                       (xlstm_lib, "slstm_decode", REC_SPANS[0]),
                       (ll, "linear_apply", REC_SPANS[1])])


def _inside(event, label: str) -> bool:
    """Whether a profiler range event runs inside a range named `label`."""
    parent = getattr(event, "cpu_parent", None)
    while parent is not None:
        if parent.name == label:
            return True
        parent = getattr(parent, "cpu_parent", None)
    return False


def profile_decode(engine, cfg, report, key="serve", max_new=12) -> None:
    """Device busy time per decode step with every slot busy: torch.profiler
    (CUPTI) over 8 pure decode (or verify) steps, summing the device-side
    events, into report[key]. For an MoE config the device time under the
    MoE ranges (moe_spans) is split out: the expert products, and the
    dispatch (the block less its expert products and shared FFN: router,
    top-k, sort, scatter, gather, combine). The launch gate is the
    wrappers' counters over the profiled steps (the profiler drops a few
    kernel records a window: PERF.md §6, PR 22). A diagnostic: if the
    profiler cannot trace here, or lost more than 1 % of the counted
    launches, the device times are recorded as not measured and the run
    goes on."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.RandomState(7)
    for _ in range(engine.ecfg.n_slots):
        engine.submit(rng.randint(0, cfg.vocab_size, size=96).astype(np.int32),
                      max_new)
    engine.step()  # admission, batched prefill, first decode step
    n_steps = 8
    recurrent = n_attn_layers(cfg) < cfg.n_layers
    restore = (moe_spans() if cfg.moe.n_experts else
               rec_spans() if recurrent else (lambda: None))
    # the window opens on an idle card (the first step's kernels stay
    # outside it) and the wrappers count its launches: they, not the
    # profile, are the launch gate
    torch.cuda.synchronize()
    counted = (cm.cadc_matmul_cuda.launches, pa.paged_attention_cuda.launches)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
        counted = {"K1": cm.cadc_matmul_cuda.launches - counted[0],
                   "K6": pa.paged_attention_cuda.launches - counted[1]}
        rows = []
        for e in prof.key_averages():
            # a range's own device-side copy (a user annotation) is no
            # kernel: its time is its kernels'
            if ("CUDA" not in str(getattr(e, "device_type", ""))
                    or e.key in MOE_SPANS + REC_SPANS):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            rows.append((us, e.key, e.count))
        spans = {label: 0.0 for label in MOE_SPANS}
        cell = {"cells": 0.0, "their linears": 0.0}
        for e in prof.events() if cfg.moe.n_experts or recurrent else ():
            if "CPU" not in str(e.device_type):
                continue
            ms = e.device_time_total / 1e3 / n_steps
            if e.name in spans:
                spans[e.name] += ms
            elif e.name == REC_SPANS[0]:
                cell["cells"] += ms
            elif e.name == REC_SPANS[1] and _inside(e, REC_SPANS[0]):
                cell["their linears"] += ms
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
                else "K1 mma kernel" if "bf16_mma_kernel" in kname
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
    if recurrent:
        # a cell range holds its linears' K1 launches (counted in the K1
        # groups) and their casts and bias adds: its own PyTorch kernels
        # are the range less the linear ranges inside it
        other = groups.pop("other (PyTorch)", {"ms": 0.0, "calls": 0.0})
        own = cell["cells"] - cell["their linears"]
        groups["recurrent cells' own PyTorch (conv step, gates, state)"] = {
            "ms": own}
        other["ms"] -= own
        groups["other (PyTorch; the launches count the cells' too)"] = other
        report[key]["recurrent_spans_ms_per_step"] = cell
    report[key]["device_ms_per_step_by_kernel"] = groups
    want = {"K1": k1_per_pass(cfg) * n_steps,
            "K6": n_attn_layers(cfg) * n_steps}
    if counted != want:
        fail(f"decode profile: the wrappers launched {counted} over "
             f"{n_steps} steps, want {want} (K6 once an attention layer)")
    seen = {"K1": sum(g["calls"] for name, g in groups.items()
                      if name.startswith("K1")) * n_steps,
            "K6": groups.get("K6 paged attention", {}).get("calls", 0)
            * n_steps}
    lost = {k: counted[k] - seen[k] for k in counted}
    report[key]["launches_profiled_vs_counted"] = {
        "profiled": seen, "counted": counted, "lost": lost}
    if any(lost.values()):
        # the profiler (kineto / CUPTI) dropped kernel records: a few a
        # window, more with each session a process has run, whatever the
        # window's bounds (PERF.md §6, PR 22); the launch counts above are
        # the wrappers', and the device times lack the dropped kernels
        print(f"profiler ({key}): lost {lost} of the {counted} launches "
              "the wrappers counted", flush=True)
        if sum(lost.values()) > 0.01 * sum(counted.values()):
            report[key]["device_busy_ms_per_step"] = (
                f"not measured: the profiler lost {lost} of {counted}")
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
    # every linear of the prefill (a recurrent layer's once a token of
    # its 128-wide bucket) and of the 4 decode steps, and K6 for every
    # attention layer of each decode step
    need_k1 = (k1_per_pass(cfg, prefill=True, tokens=tokens.shape[1])
               + 4 * k1_per_pass(cfg))
    for name, seen, need in (
            ("plain", n_plain, (0, 0)),
            ("kernel", n_kern, (need_k1, n_attn_layers(cfg) * 4))):
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
    print(f"fp32 {cfg.name} at full width, {cfg.n_layers} layers "
          f"{''.join(k[0] for k in cfg.pattern_for_layers)}: prefill + "
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


def one_state_gap(cfg, params, dev) -> tuple:
    """On one engine state (N_SLOTS slots after a batched prefill of
    prompts of 64..128 tokens on the headroom rings), the max |logit|
    difference between each row t of a verify step (Q = SPEC_K + 1) and a
    Q = 1 decode step at the same prefix, the drafts being the decode
    steps' own greedy picks (so each row's prefix is the decode's), tables
    sliced as the engine slices them; and the head as one GEMM over the
    step's rows against the per-column head the verify step computes.
    Returns (verify gap, head gap)."""
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

    backend = PagedBackend(cfg, N_SLOTS, MAX_LEN, BLOCK, dev,
                           spec_tokens=SPEC_K)
    caches = backend.init_caches()
    tables = BlockTables(N_SLOTS, backend.blocks_per_slot, backend.n_blocks)
    for slot in range(N_SLOTS):
        tables.assign(slot)

    def sliced(max_pos):
        cov = backend.covered_blocks(max_pos)
        return {k: torch.as_tensor(np.ascontiguousarray(v[:, :cov[k]]),
                                   device=dev)
                for k, v in tables.tables.items()}

    p = steps_lib.cast_compute(params, cfg)
    first, _, contribs = steps_lib.make_batched_prefill_step(cfg)(
        p, {"tokens": torch.as_tensor(tokens, device=dev)},
        torch.as_tensor(lengths, device=dev))
    backend.write_prefill(caches, contribs, slot_ids, lengths, tables.tables)
    pos = torch.as_tensor(lengths.astype(np.int64), device=dev)
    top = int(lengths.max())
    dec_caches = tf.copy_caches(caches)
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
    one = head(p, x, cfg)
    per_col = torch.cat([head(p, x[:, t:t + 1], cfg)
                         for t in range(x.shape[1])], dim=1)
    return err, float((one - per_col).abs().max())


def verify_gap(cfg, params, dev, report) -> float:
    """one_state_gap measured in bf16 (the serving path; the kernels-on gap
    bounds the stream check) and in fp32 (TF32 off; finer than bf16's
    rounding of the logits), each with the kernels on, K1 alone (plain
    paged attention), K6 alone (plain linears) and neither; and the device
    time of the verify step's head as one GEMM and per column."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf

    out = {}
    variants = (("kernels", "auto", "auto"), ("K1 only", "auto", "torch"),
                ("K6 only", "torch", "auto"), ("plain", "torch", "torch"))
    for dtype in ("bfloat16", "float32"):
        for name, kimpl, aimpl in variants:
            err, head_one_gemm = one_state_gap(cfg.with_overrides(
                dtype=dtype, kernel_impl=kimpl, paged_attn_impl=aimpl),
                params, dev)
            out.setdefault(dtype, {})[name] = {
                "max_abs_logit_gap": err, "head_as_one_gemm": head_one_gemm}
        print(f"verify step vs Q = 1 decode, max |delta logit| ({dtype}, "
              f"one state, {N_SLOTS} slots, Q = {SPEC_K + 1}): "
              + "; ".join(f"{k} {v['max_abs_logit_gap']:.4g}"
                          for k, v in out[dtype].items())
              + f"; the head as one GEMM over the {N_SLOTS * (SPEC_K + 1)} "
              f"rows against per column: "
              f"{out[dtype]['kernels']['head_as_one_gemm']:.4g}", flush=True)
    gap_all = out["bfloat16"]["kernels"]["max_abs_logit_gap"]
    if not math.isfinite(gap_all):
        fail(f"verify gap is not finite: {gap_all}")
    report["verify_gap"] = out
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
    return gap_all


def serve_spec(cfg, params, dev, base, gap, report, key="serve_spec",
               proposers=("ngram", "model", "oracle", "anti")) -> None:
    """Slice 4's path: the main path's workload through the engine with
    spec_tokens = SPEC_K under four proposers (n-gram, the draft model —
    gemma3-1b at default_draft_config's 3 layers, random weights from seed
    1 — the oracle and its anti-oracle), each after a warm-up, with exact
    launch counts (slice 6 runs recurrentgemma-9b's path under key, with
    the oracle and the anti-oracle: every recurrent layer rolls back to
    the kept token at every verify step). Every stream must equal the
    spec_tokens=0 stream, or leave it first at a token whose top-2 logit
    margin in the greedy run is below the measured verify gap."""
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
    for name in proposers:
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
        buckets = record_prefill_buckets(engine)
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
        if name == "model":  # its rollout and re-feed steps, its prefills
            cfg_d = engine.proposer.cfg_d
            draft = (k1_per_pass(cfg_d) * (SPEC_K * n_ver + advances[0])
                     + k1_prefills(cfg_d, buckets))
        want = {"cadc_matmul": k1_per_pass(cfg, tokens=SPEC_K + 1) * n_ver
                + k1_prefills(cfg, buckets) + draft,
                "paged_attention": n_attn_layers(cfg) * n_ver}
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
        print(f"{key} {cfg.name} {name} (K={SPEC_K}): "
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
    report[key] = out


def time_k1(cfg, dev, launches, report, m=N_SLOTS):
    """One decode step's K1 work: the seven linears at M = 8 slots, bf16,
    relu, x 26 layers (with m = 32: a verify step's). Weights rotate over
    copies that hold 3x the L2 cache, as in a real step that streams 1.5 GB
    of weights."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(3)
    dt, xbar = torch.bfloat16, cfg.crossbar_size
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "tile": 0.0, "bytes": 0.0,
           "ops": 0.0}
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
        plan = cm.plan_fwd(m, n, d // xbar, xbar, vec=8, dtype=dt)
        per_shape[name] = {"D": d, "N": n, "copies": len(ws),
                           "plan": f"{plan.kernel} {plan.width} "
                                   f"split={plan.split} grid={plan.grid}",
                           "ms": k, "host_ms": k_host,
                           "plain_ms": p, "matmul_ms": lib,
                           "bound_ms": bound_ms(nbytes, 2 * m * d * n, dt)[0]}
        if plan.kernel == "mma":  # the CUDA-core tile kernel it replaced
            tile = cm.plan_fwd(m, n, d // xbar, xbar, vec=8)
            per_shape[name]["tile_ms"] = tile_ms = keep_counts(
                lambda: device_ms(lambda: cm._fwd_launch(
                    x, pick(), xbar, "relu", "none", plan=tile), reps))
            tot["tile"] += tile_ms
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
            "tile_ms": tot["tile"] * layers,
            "plain_ms": tot["plain"] * layers,
            "matmul_ms": tot["lib"] * layers, "bound_ms": b_ms}
        print(f"K1 at a verify step (M={m}): {tot['ms'] * layers:.3f} ms "
              f"(the tile kernel {tot['tile'] * layers:.3f}, plain "
              f"{tot['plain'] * layers:.3f}, torch.matmul "
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
    s_g = d_g // xbar
    plan_pre = cm.plan_fwd(m_pre, n_g, s_g, xbar, vec=8, dtype=dt)
    tile_pre = cm.plan_fwd(m_pre, n_g, s_g, xbar, vec=8)
    pre = keep_counts(lambda: {
        "plan": f"{plan_pre.kernel} {plan_pre.width} split={plan_pre.split} "
                f"grid={plan_pre.grid}",
        "ms": device_ms(lambda: cm.cadc_matmul_cuda(
            xp, pick(), crossbar_size=xbar, fn="relu"), len(wps)),
        "tile_ms": device_ms(lambda: cm._fwd_launch(
            xp, pick(), xbar, "relu", "none", plan=tile_pre), len(wps)),
        "plain_ms": device_ms(lambda: cm.cadc_matmul_torch(
            xp, pick(), crossbar_size=xbar, fn="relu"), len(wps)),
        "library_ms": device_ms(lambda: torch.matmul(xp, pick()), len(wps)),
        "bound_ms": bound_ms(
            m_pre * d_g * 2 + d_g * n_g * 2 + m_pre * n_g * 4,
            2 * m_pre * d_g * n_g, dt)[0]})
    del wps
    print(f"K1 at prefill (w_gate, M={m_pre}, {pre['plan']}): "
          f"{pre['ms']:.4f} ms (the tile kernel {pre['tile_ms']:.4f}, plain "
          f"{pre['plain_ms']:.4f}, torch.matmul {pre['library_ms']:.4f}, "
          f"bound {pre['bound_ms']:.4f})", flush=True)
    report["k1_timing"] = {
        "unit": "one decode step: 7 linears x 26 layers, M=8, bf16, relu",
        "l2_bytes": l2_bytes(),
        "per_shape_one_call": per_shape,
        "matmul_ms_per_step": tot["lib"] * layers,
        "prefill_w_gate_M1024_ms": pre["ms"],
        "prefill_w_gate_M1024_bound_ms": pre["bound_ms"],
        "prefill_w_gate_M1024": pre,
    }
    verify = report.get("k1_timing_verify", {})
    return {"name": "cadc_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/cadc_matmul.cu",
            "replaces": "src/repro/kernels/cadc_matmul.py:188",
            "launches": launches["cadc_matmul"],
            "max_abs_err": report["k1_max_abs_err"],
            "ms": tot["ms"] * layers, "plain_ms": tot["plain"] * layers,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["lib"] * layers,
            "verify_step": {k: verify.get(k) for k in (
                "ms", "tile_ms", "plain_ms", "bound_ms", "matmul_ms")},
            "prefill_w_gate_M1024": {k: v for k, v in pre.items()
                                     if k != "plan"}}


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


def time_k1_shapes(dev, shapes: dict, seed: int) -> dict:
    """K1 device ms at M = 8 (a decode step's rows; a recurrent prefill's
    rows a token), bf16, relu, at each shape of `shapes` ({(D, N):
    (configs, names)}), beside its plain version, torch.matmul and the
    bound (weights rotated over copies that hold 3x the L2, as in
    time_k1). Returns {"DxN": record}."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, m, xbar = torch.bfloat16, N_SLOTS, 256
    per_shape = {}
    for (d, n), (archs, names) in sorted(shapes.items()):
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
        plan = cm.plan_fwd(m, n, d // xbar, xbar, vec=8, dtype=dt)
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
    return per_shape


def k1_step_time(cfg, per_shape: dict, shapes) -> dict:
    """A decode step's K1 time from one-call times: each (name, D, N) of
    `shapes` that many times (name, D, N, times)."""
    step = {"ms": 0.0, "matmul_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for _, d, n, times in shapes:
        for key in step:
            step[key] += per_shape[f"{d}x{n}"][key] * times
    step["launches"] = sum(t for *_, t in shapes)
    return step


def time_k1_slice5(dev, report) -> None:
    """K1 device ms at M = 8 at every K1 shape of the six configs
    (time_k1_shapes); then qwen2-moe-a2.7b's K1 time a decode step from
    them."""
    per_shape = time_k1_shapes(dev, slice5_k1_shapes(), 13)
    cfg = slice5_cfg(MOE_ARCH)
    step = k1_step_time(cfg, per_shape, [
        (name, d, n, 1 if name == "head" else cfg.n_layers)
        for name, d, n in linear_shapes(cfg)])
    report["k1_timing_slice5"] = {
        "unit": "one call at M=8, bf16, relu", "per_shape": per_shape,
        "qwen2_moe_decode_step": step}
    print(f"K1 a {cfg.name} decode step (169 launches at M=8): "
          f"{step['ms']:.3f} ms, torch.matmul {step['matmul_ms']:.3f}, "
          f"plain {step['plain_ms']:.3f}, bound {step['bound_ms']:.3f} "
          "(sums of the one-call times)", flush=True)


# ---------------------------------------------------------------------------
# slice 6: the recurrent LM families (RG-LRU; xLSTM's mLSTM and sLSTM)
# ---------------------------------------------------------------------------

def decode_step_shapes(cfg) -> list:
    """(name, D, N, launches) of a decode step's K1 calls: each kind's
    linears times its layers, and an untied head once."""
    kinds = cfg.pattern_for_layers
    out = [(f"{kind}.{name}", d, n, kinds.count(kind))
           for kind in sorted(set(kinds))
           for name, d, n in kind_linear_shapes(cfg, kind)]
    if not cfg.tie_embeddings:
        out += [s + (1,) for s in linear_shapes(cfg) if s[0] == "head"]
    return out


def slice6_k1_shapes() -> dict:
    """{(D, N): (configs, names)} of every K1 shape of the two configs."""
    out = {}
    for arch in SLICE6_ARCHS:
        for name, d, n, _ in decode_step_shapes(slice5_cfg(arch)):
            archs, names = out.setdefault((d, n), (set(), set()))
            archs.add(arch)
            names.add(name)
    return out


def check_k1_slice6(dev, report) -> None:
    """K1 against its plain version at every K1 shape of recurrentgemma-9b
    and xlstm-1.3b at published width (mLSTM's 4096 -> 8 gates, sLSTM's
    2048 -> 2730 and 2730 -> 2048 padded to 2816, the MQA 4096 -> 256,
    xlstm's untied head): M = 8 (a decode step, and a recurrent prefill's
    rows a token: the prefill batch holds the 8 slots) and 32 (a verify
    step's attention rows), fp32 (TF32 off) and bf16, relu."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(21)
    worst, n_checks = 0.0, 0
    shapes = slice6_k1_shapes()
    rows = (N_SLOTS, N_SLOTS * (SPEC_K + 1))
    for (d, n) in sorted(shapes):
        for m in rows:
            for dtype in (torch.float32, torch.bfloat16):
                worst = max(worst, k1_case(cm, gen, dev, 256, d, n, m, dtype,
                                           "relu"))
                n_checks += 1
        torch.cuda.empty_cache()
    plans = sorted({f"{p.kernel} {p.width} split={p.split}" for p in (
        cm.plan_fwd(m, n, d // 256, 256, vec=v, dtype=dt) for d, n in shapes
        for m in rows for v, dt in ((4, torch.float32),
                                    (8, torch.bfloat16)))})
    report["k1_slice6"] = {"checks": n_checks, "max_abs_err": worst,
                           "shapes": sorted(shapes), "plans": plans}
    report["k1_max_abs_err"] = max(report["k1_max_abs_err"], worst)
    print(f"K1 at the recurrent configs' {len(shapes)} shapes "
          f"{sorted(shapes)}: {n_checks} checks ok (M {rows}; plans {plans}),"
          f" max abs err {worst:.3e}", flush=True)


def check_k6_slice6(dev, report) -> None:
    """K6 under every plan at recurrentgemma-9b's geometry (MQA: 16 query
    heads over 1 kv head of 256, so R = 16 q rows at decode and 64 at
    Q = 4), its local window of 2048 cut to the main path's rings (160
    entries, 176 with the verify step's headroom), fp32 and bf16: NaN in
    dead entries, an idle slot, 0 spills (checked at the build)."""
    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(22)
    cfg = slice5_cfg(RG_ARCH)
    cases = ([c + (1,) for c in main_path_k6_cases(cfg)]
             + spec_k6_cases(cfg))
    worst, n_plans = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            err, n = k6_case(pa, cfg, dev, dtype, case, gen)
            worst, n_plans = max(worst, err), n_plans + n
    if int(cm._counters(dev).abs().sum()):
        fail("K6 left the arrival counters nonzero")
    r = cfg.n_heads // cfg.n_kv_heads
    report["k6_slice6"] = {"cases": 2 * len(cases), "runs": n_plans,
                           "max_abs_err": worst,
                           "geometry": [c[:4] + (c[5],) for c in cases]}
    report["k6_max_abs_err"] = max(report["k6_max_abs_err"], worst)
    print(f"K6 at {cfg.name}'s geometry (H/K {cfg.n_heads}/{cfg.n_kv_heads} "
          f"hd {cfg.head_dim}, R {r}/{r * (SPEC_K + 1)}; "
          f"{[c[:4] + (c[5],) for c in cases]}): {2 * len(cases)} cases x "
          f"every plan ({n_plans} runs) ok, max abs err {worst:.3e}",
          flush=True)


def rec_main_path(arch: str, dev, report, want_k1: int, want_k6: int,
                  n_requests: int):
    """A recurrent config at published width and REC_LAYERS depth, random
    bf16 weights from seed 0 drawn layer by layer, CADC relu at crossbar
    256, on the main path's
    engine and workload (its first n_requests requests): exact launch
    counts (want_k1 / want_k6 a decode step; a prefill's K1 from its
    bucket), step ms, tok/s, TTFT, peak memory and the decode profile
    split into K1, K6, the recurrent cells' own PyTorch kernels and other
    PyTorch. Returns (cfg, params, launches, base)."""
    from repro_torch.models.lm import transformer as tf
    from repro_torch.serve.backends import PagedBackend

    cfg = slice5_cfg(arch, n_layers=REC_LAYERS[arch])
    if (k1_per_pass(cfg), n_attn_layers(cfg)) != (want_k1, want_k6):
        fail(f"{cfg.name}: K1 / K6 {k1_per_pass(cfg)} / {n_attn_layers(cfg)}"
             f" a decode step, want {want_k1} / {want_k6}")
    pool = PagedBackend(cfg, N_SLOTS, MAX_LEN, BLOCK, dev).n_blocks
    if bool(pool) != bool(want_k6):
        fail(f"{cfg.name}: KV pool blocks {pool} with {want_k6} attention "
             "layers")
    key = {RG_ARCH: "serve_rg", XL_ARCH: "serve_xl"}[arch]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = n_params(params)
    print(f"{cfg.name}: {n / 1e9:.3f} B parameters drawn in bf16 layer by "
          f"layer in {init_s:.1f} s; KV pool blocks {pool}", flush=True)
    launches, base = serve_main_path(cfg, params, dev, report, key=key,
                                     n_requests=n_requests)
    report[key].update(params=n, init_s=init_s, kv_pool_blocks=pool,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"{cfg.name}: peak device memory {report[key]['peak_gib']:.2f} "
          "GiB", flush=True)
    return cfg, params, launches, base


def rec_fp32_logits(arch: str, dev, report) -> None:
    """A recurrent config at published width and small depth in fp32 (TF32
    off): recurrentgemma-9b at 3 layers (one rglru, rglru, local unit),
    xlstm-1.3b at 2 (mlstm, slstm); phase 5's kernel-vs-plain logits check
    (one batched prefill, the recurrent layers a token at a time, and 4
    decode steps fed the same tokens)."""
    from repro_torch.models.lm import transformer as tf

    kw = (dict(n_layers=3) if arch == RG_ARCH else
          dict(n_layers=2, pattern=("mlstm", "slstm")))
    cfg = slice5_cfg(arch, **kw)
    params = tf.init(cfg, seed=0, device=dev)
    fp32_logits_check(cfg, params, dev, report,
                      key={RG_ARCH: "fp32_logits_rg",
                           XL_ARCH: "fp32_logits_xl"}[arch])
    del params
    torch.cuda.empty_cache()


def recurrent_paths(dev, report) -> dict:
    """Slice 6's paths at REC_LAYERS depth: recurrentgemma-9b (K1 62 and
    K6 2 launches a decode step) with its speculative path under the
    oracle and the anti-oracle, then xlstm-1.3b (K1 47, no K6, no KV pool),
    each then at smaller depth in fp32. Returns their launch counts."""
    out = {}
    cfg, params, out["recurrentgemma-9b"], base = rec_main_path(
        RG_ARCH, dev, report, 62, 2, REC_REQUESTS)
    # the bf16 kernels-on gap: the one the stream check reads
    gap, _ = one_state_gap(cfg.with_overrides(
        dtype="bfloat16", kernel_impl="auto", paged_attn_impl="auto"),
        params, dev)
    if not math.isfinite(gap):
        fail(f"{cfg.name} verify gap is not finite: {gap}")
    report["verify_gap_rg"] = {"bfloat16": {"kernels": {
        "max_abs_logit_gap": gap}}}
    print(f"verify step vs Q = 1 decode, max |delta logit| ({cfg.name}, "
          f"bf16, kernels on, one state, {N_SLOTS} slots, Q = {SPEC_K + 1})"
          f": {gap:.4g}", flush=True)
    serve_spec(cfg, params, dev, base, gap, report, key="serve_spec_rg",
               proposers=("oracle", "anti"))
    del params, base
    torch.cuda.empty_cache()
    rec_fp32_logits(RG_ARCH, dev, report)
    _, params, out["xlstm-1.3b"], _ = rec_main_path(
        XL_ARCH, dev, report, 47, 0, REC_REQUESTS)
    del params
    torch.cuda.empty_cache()
    rec_fp32_logits(XL_ARCH, dev, report)
    return out


def time_k1_slice6(dev, report) -> None:
    """K1 device ms at M = 8 at every K1 shape of the two recurrent configs
    (time_k1_shapes); then each config's K1 time a decode step (292 and
    277 launches) from them."""
    per_shape = time_k1_shapes(dev, slice6_k1_shapes(), 23)
    steps = {}
    for arch in SLICE6_ARCHS:
        cfg = slice5_cfg(arch)
        step = steps[cfg.name] = k1_step_time(cfg, per_shape,
                                              decode_step_shapes(cfg))
        print(f"K1 a {cfg.name} decode step ({step['launches']} launches at "
              f"M=8): {step['ms']:.3f} ms, torch.matmul "
              f"{step['matmul_ms']:.3f}, plain {step['plain_ms']:.3f}, bound "
              f"{step['bound_ms']:.3f} (sums of the one-call times)",
              flush=True)
    report["k1_timing_slice6"] = {
        "unit": "one call at M=8, bf16, relu", "per_shape": per_shape,
        "decode_step": steps}


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
    differ = got != want
    if bool((differ & far).any()):
        fail(f"{tag}: gate bits differ where |psum| > {GATE_NEAR} x scale")
    return int(differ.sum())


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
# slice 7: LM training through K1g and K2
# ---------------------------------------------------------------------------

# gemma3-1b trained at full width through the LM train CLI
# (launch/train.py): LM_BATCH x LM_SEQ tokens a step in LM_MICRO
# microbatches of LM_M rows (two q chunks of 512 and the 512 window bite),
# LM_STEPS steps, CADC relu at crossbar LM_XBAR, bf16 compute on fp32
# masters, remat on; the kernel-vs-plain checks at LM_PARITY_LAYERS layers;
# the twin of examples/lm_cadc_train.py for LM_TWIN_STEPS steps.
LM_ARCH, HUBERT_ARCH = "gemma3_1b", "hubert_xlarge"
LM_BATCH, LM_SEQ, LM_MICRO, LM_STEPS = 8, 1024, 4, 6
LM_M = LM_BATCH * LM_SEQ // LM_MICRO
LM_XBAR = 256
# Slice 8, the recurrent families trained at full width through the same
# CLI (REC_TRAIN: one period of each pattern — recurrentgemma-9b's
# (rglru, rglru, local), xlstm-1.3b's 7 mLSTM + sLSTM —, batch x LM_SEQ
# tokens in micros of LM_M rows, so the chunkwise mLSTM runs 4 chunks of
# 256), REC_TRAIN_STEPS steps (2: at 3 the whole run took 810 s on an H100
# 80GB at 700 W, past the 800 s it aims under), then the 2 timed and 1
# profiled; kernel vs plain at LM_PARITY_LAYERS / LM_PARITY_TOKENS
# (recurrentgemma over 2560 tokens, so its 2048 local window bites; xlstm
# over two mLSTM chunks; one sequence each for gemma3-1b, hubert-xlarge
# and xlstm-1.3b, not two: a cut of the run's time for slice 9's phases;
# for slice 10's, xlstm-1.3b's train phase runs one micro of 2 x 1024 a
# step, not two, since its sLSTM loop holds the host a micro: on the card
# recurrentgemma-9b's is the one recurrent step that sums micros); each
# training form against its decode cell over REC_FORM_S tokens.
REC_TRAIN = {RG_ARCH: dict(layers=3, batch=8, micro=4),
             XL_ARCH: dict(layers=8, batch=2, micro=1)}
REC_TRAIN_STEPS = 2
LM_PARITY_LAYERS = {LM_ARCH: 2, HUBERT_ARCH: 4, MOE_ARCH: 2, RG_ARCH: 3,
                    XL_ARCH: 8}
LM_PARITY_TOKENS = {LM_ARCH: (1, 1024), HUBERT_ARCH: (1, 512),
                    MOE_ARCH: (1, 256), RG_ARCH: (1, 2560),
                    XL_ARCH: (1, 512)}
REC_FORM_S = 512
# A training form against its decode cell at full width in fp32: the
# scans add in another order than the cell, and K1 sums a linear's psums
# at M = B * S rows in the form and at M = B in the cell (each within
# K1_RTOL of the plain version): the JAX package's fp32 bound, 1e-4 of
# scale.
REC_FORM_RTOL = 1e-4
# Calls of a short recurrent form (_linear_scan, _mlstm_chunkwise) in one
# profiled window: the forward of _linear_scan is 42 kernels, ~1.6 ms.
REC_FORM_REPS = 8
# The twin ran 200 steps until slice 12's phases took the whole run
# (813.2 s on an H100 80GB HBM3 at 700 W) past the ~800 s this script
# aims under: 101 steps, whose last (step 100) is the 200-step run's
# sixth logged loss (the twin is bitwise run to run on the card), below
# its first.
LM_RESUME_LAYERS, LM_TWIN_STEPS = 2, 101
# The bf16 loss, kernel path against plain path. The plain path stores
# each segment's psum in bf16 (bf16_wire: a relative rounding of up to
# 2^-9 a psum before f and the segment sum) where the kernels keep fp32,
# so each CADC output differs by up to about a bf16 half-ulp of its psums;
# through 2 layers and the tied head the mean loss over 2048 tokens moves
# by far less than one bf16 ulp of it (2^-7 relative): 1e-2 of the loss.
LM_BF16_LOSS_RTOL = 1e-2


def lm_cfg(arch: str, **kw):
    """An LM config at published width with CADC relu at crossbar LM_XBAR,
    the kernels on ('auto')."""
    from repro_torch.configs import get_config

    return get_config(arch).with_overrides(
        linear_impl="cadc", crossbar_size=LM_XBAR, dendritic_fn="relu",
        kernel_impl="auto", **kw)


def lm_step_launches(cfg, n_micro: int) -> dict:
    """K1g and K2 launches of one train step: every CADC linear runs K1g
    in the forward and K2 in the backward; a layer's linears (each layer
    its kind's, kind_linear_shapes) run K1g once more in the remat
    recompute (non-reentrant checkpoint); an untied head and a frontend
    projection run outside the layers. No K1."""
    from repro_torch.models.lm import transformer as tf

    outside = (not cfg.tie_embeddings) + (cfg.frontend is not None)
    n = sum(len(kind_linear_shapes(cfg, kind)) for kind in tf.layout(cfg))
    return {"cadc_matmul_gate": n_micro * (n * (2 if cfg.remat else 1)
                                           + outside),
            "cadc_segmented_bwd": n_micro * (n + outside)}


def train_linear_shapes(cfg) -> list:
    """(name, D padded to whole crossbars, N) of every CADC linear a train
    step runs, layer by layer (kind_linear_shapes of each layer's kind,
    named "kind.name"), then an untied head and a frontend projection
    (linear_shapes' last)."""
    from repro_torch.models.lm import transformer as tf

    out = [(f"{kind}.{name}", d, n) for kind in tf.layout(cfg)
           for name, d, n in kind_linear_shapes(cfg, kind)]
    return out + [s for s in linear_shapes(cfg)
                  if s[0] in ("head", "frontend_proj")]


def lm_kernel_shapes() -> list:
    """(name, D padded to whole crossbars, N) of the LM paths' CADC linears
    at crossbar 256, each shape once: gemma3-1b's 7 linears, hubert-xlarge's
    (attention, the gelu FFN, the 504-way head, the frame projection),
    qwen2-moe-a2.7b's untied head, and the recurrent configs' (REC_TRAIN:
    recurrentgemma-9b's RG-LRU, FFN and MQA linears; xlstm-1.3b's mLSTM
    gates N = 8 (2H), its sLSTM GeGLU at N and D = 2730 (2816 padded),
    its untied head)."""
    out, seen = [], set()
    for arch in (LM_ARCH, HUBERT_ARCH, MOE_ARCH, *REC_TRAIN):
        cfg = lm_cfg(arch)
        shapes = (train_linear_shapes(cfg.with_overrides(
                      n_layers=REC_TRAIN[arch]["layers"]))
                  if arch in REC_TRAIN else linear_shapes(cfg))
        if arch == MOE_ARCH:
            shapes = [s for s in shapes if s[0] == "head"]
        for name, d, n in shapes:
            if (d, n) not in seen:
                seen.add((d, n))
                out.append((f"{arch}.{name}", d, n))
    return out


def check_mma_plans(cm, x, w, xbar, tag) -> tuple:
    """K1g (packed gate) and K1 on bf16 x, w under every plan of
    `mma_plans` (not counted as launches): y and the gate words bitwise the
    planner's plan's, and K1's y bitwise K1g's. Returns (the planner's
    plan, plans checked)."""
    m, n = x.shape[0], w.shape[1]
    plans = cm.mma_plans(m, n, x.shape[1] // xbar, xbar)
    if plans[0].kernel != "mma":
        fail(f"{tag}: bf16 planned on the {plans[0].kernel} kernel")
    y0, g0 = cm._fwd_launch(x, w, xbar, "relu", "packed", plan=plans[0])
    for plan in plans:
        y, g = cm._fwd_launch(x, w, xbar, "relu", "packed", plan=plan)
        k, _ = cm._fwd_launch(x, w, xbar, "relu", "none", plan=plan)
        if not (torch.equal(y, y0) and torch.equal(g, g0)
                and torch.equal(k, y0)):
            fail(f"{tag}: mma plan {plan} differs from the planner's "
                 f"{plans[0]}")
    return plans[0], len(plans)


def check_k1g_k2_lm(dev, report) -> None:
    """K1g (K1 where the mode saves nothing) and K2 against their plain
    versions at every shape of lm_kernel_shapes, M = LM_M rows, relu, bf16
    and fp32 operands (K2 on them as CadcMatmulFn.backward hands them over:
    g in the operands' dtype), save_gate packed / bytes / recompute; K2
    under the planner's plan and forced plans (dx bitwise the planner's):
    on bf16 under packed and bytes the tensor-core route under every plan
    `bwd_plans` lists (dx bitwise, dw the same bits on two runs), under
    recompute the CUDA-core route on fp32 copies; on fp32 one other plan;
    on bf16 every plan of K1g's tensor-core kernel bitwise the planner's
    (check_mma_plans)."""
    from repro_torch.kernels import cadc_matmul as cm

    gen = torch.Generator(device=dev).manual_seed(20)
    worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    worst16 = {"dx": 0.0, "dw": 0.0}
    n_checks = near = forced = mma_checked = k2_mma = 0
    mma_plan, k2_plan = {}, {}
    for name, d, n in lm_kernel_shapes():
        x32 = torch.randn(LM_M, d, generator=gen, device=dev)
        w32 = torch.randn(d, n, generator=gen, device=dev) / math.sqrt(d)
        g32 = torch.randn(LM_M, n, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, w, g = x32.to(dtype), w32.to(dtype), g32.to(dtype)
            xf, wf = x.float(), w.float()
            if dtype == torch.bfloat16:
                plan, k = check_mma_plans(cm, x, w, LM_XBAR, name)
                mma_plan[name] = (f"{plan.width} rows, {plan.groups} "
                                  f"groups, grid {plan.grid}")
                mma_checked += k
            psums = torch.stack([xf[:, i:i + LM_XBAR] @ wf[i:i + LM_XBAR]
                                 for i in range(0, d, LM_XBAR)])
            for mode in ("packed", "bytes", "recompute"):
                tag = f"{name} M={LM_M} {str(dtype)[6:]} save_gate={mode}"
                kw = dict(crossbar_size=LM_XBAR, fn="relu")
                if mode == "recompute":
                    y, gate = cm.cadc_matmul_cuda(x, w, **kw), None
                    want_y = cm.cadc_matmul_torch(x, w, **kw)
                else:
                    y, gate = cm.cadc_matmul_gate_cuda(x, w, mode=mode, **kw)
                    want_y, want_gate = cm.cadc_matmul_gate_torch(
                        x, w, mode=mode, **kw)
                    near += _check_gate(cm, gate, want_gate, psums,
                                        max(1.0, float(want_y.abs().max())),
                                        n, tag)
                    del want_gate
                err = track("k1g", y, want_y)
                worst["fwd"] = max(worst["fwd"], err)
                if not err <= TRAIN_RTOL:
                    fail(f"{tag}: forward err / scale {err} > {TRAIN_RTOL}")
                del y, want_y
                bkw = dict(mode=mode, **kw)
                dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **bkw)
                want_dx, want_dw = cm.cadc_segmented_bwd_torch(
                    g, x, w, gate, **bkw)
                got = [("dx", dx, want_dx), ("dw", dw, want_dw)]
                plans = cm.bwd_plans(LM_M, n, d, LM_XBAR, mode, dtype=dtype,
                                     fn="relu")
                mma = plans[0].kernel == "mma"
                if mma != (dtype == torch.bfloat16 and mode != "recompute"):
                    fail(f"{tag}: K2 planned on the {plans[0].kernel} "
                         "kernels")
                if mma:
                    k2_plan[name] = (f"dx {plans[0].dx_tile[0]} rows, grid "
                                     f"{plans[0].dx_grid}; dw grid "
                                     f"{plans[0].dw_grid}")
                others = (plans[1:] if mma else
                          [p for p in plans[1:]
                           if p.dw_tile != plans[0].dw_tile][:1])
                if not others:
                    fail(f"{tag}: no other K2 plan than {plans[0]}")
                for other in others:
                    pdx, pdw = keep_counts(lambda: cm.cadc_segmented_bwd_cuda(
                        g, x, w, gate, plan=other, **bkw))
                    if not torch.equal(pdx, dx):
                        fail(f"{tag}: K2 plan {other}: dx differs from the "
                             "planner's")
                    if mma:
                        _, pdw2 = keep_counts(
                            lambda: cm.cadc_segmented_bwd_cuda(
                                g, x, w, gate, plan=other, **bkw))
                        if not torch.equal(pdw, pdw2):
                            fail(f"{tag}: K2 plan {other}: dw differs run "
                                 "to run")
                        k2_mma += 1
                    forced += 1
                    got.append(("dw", pdw, want_dw))
                for key, a, b in got:
                    e = track("k2", a, b)
                    worst[key] = max(worst[key], e)
                    if mma:
                        worst16[key] = max(worst16[key], e)
                    if not e <= TRAIN_RTOL:
                        fail(f"{tag}: {key} err / scale {e} > {TRAIN_RTOL}")
                n_checks += 1
                del dx, dw, want_dx, want_dw, pdx, pdw, gate, got
            del psums, x, w, xf, wf, g
        del x32, w32, g32
        torch.cuda.empty_cache()
    report["k1g_k2_lm_checks"] = {
        "n": n_checks, "m": LM_M, "shapes": lm_kernel_shapes(),
        "max_err_over_scale": worst, "near_zero_gate_mismatches": near,
        "k2_forced_plans": forced, "mma_plans_bitwise": mma_checked,
        "mma_plan": mma_plan, "k2_mma_plans": k2_mma,
        "k2_mma_max_err_over_scale": worst16, "k2_mma_plan": k2_plan}
    print(f"K1g/K2 at the LM shapes: {n_checks} checks ok "
          f"({len(lm_kernel_shapes())} shapes, M {LM_M}, bf16 and fp32, "
          f"relu, save_gate packed / "
          f"bytes / recompute; K2 also under {forced} forced plans, dx "
          f"bitwise, {k2_mma} of them bf16 tensor-core plans with dw "
          f"bitwise run to run; bf16 K1g / K1 under {mma_checked} mma "
          f"plans, bitwise the planner's); max err / scale {worst} (K2's "
          f"tensor-core route {worst16}); gate bit mismatches at "
          f"|psum| <= {GATE_NEAR} x scale: {near}", flush=True)
    for name, plan in mma_plan.items():
        print(f"  mma plan {name} M={LM_M}: K1g {plan}; K2 "
              f"{k2_plan.get(name)}", flush=True)


COLLECTIVES = "device-to-device copies (at one rank the collectives' too)"


def lm_group(key: str) -> str:
    """A profiler kernel name's group on the LM train step: K1g, K2's dx /
    dw, the device-to-device copies and NCCL's kernels (at one rank NCCL
    copies all_gather's and reduce_scatter's buffers with cudaMemcpyAsync
    and launches no kernel; the model makes a few copies of its own:
    lm_train_path counts the collective calls beside them), cuBLAS's
    bf16 GEMMs (Hopper's `nvjet` kernels; on this path only
    the tied head: forward, dx and dW of the table), its fp32 GEMMs
    (attention's scores and PV products, the chunkwise mLSTM's and the
    sLSTM cell's products, forward and backward, fp32 with TF32 off:
    `sm80_xmma_gemm_f32f32`) and the rest."""
    k = key.lower()
    for pat, name in (("cadc::fwd_tile_kernel", "K1g cadc_matmul_gate"),
                      ("bf16_mma_kernel", "K1g cadc_matmul_gate"),
                      ("bwd_dx", "K2 dx"), ("bwd_dw", "K2 dw")):
        if pat in k:
            return name
    if "nccl" in k or k.startswith("memcpy dtod"):
        return COLLECTIVES
    if "nvjet" in k or ("gemm" in k and "bf16" in k):
        return "tied head (torch.matmul, bf16)"
    if "gemm" in k or "xmma" in k or "cutlass" in k:
        return "fp32 GEMMs (attention; the mLSTM / sLSTM products)"
    return "other (PyTorch)"


def count_collectives():
    """Wrap the collectives the data-parallel step makes (parallel.comm's
    all_gather / reduce_scatter, torch.distributed.all_reduce) to count
    their calls; returns (counts, the function that unwraps them)."""
    import torch.distributed as dist

    from repro_torch.parallel import comm

    counts = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    saved = [(comm, "_all_gather", "all_gather"),
             (comm, "_reduce_scatter", "reduce_scatter"),
             (dist, "all_reduce", "all_reduce")]
    saved = [(mod, name, key, getattr(mod, name)) for mod, name, key in saved]
    for mod, name, key, fn in saved:
        def wrapped(*a, fn=fn, key=key, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, _, fn in saved:
            setattr(mod, name, fn)
    return counts, restore


# The dry run's cost audit held on the card: one more step of the
# gemma3-1b train path under launch/dryrun.count_cost against the meta
# audit of the same step (AUDIT_META: the config the train CLI builds,
# its one-rank mesh and its batch's dtypes, rank 0's step on the meta
# device under torch's fake process group, in a subprocess with no card).
AUDIT_META = """
import json, sys
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["src"])
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, train
from repro_torch.launch import mesh as mesh_lib
cfg = get_config(spec["arch"], **spec["overrides"])
mesh = mesh_lib.make_local_mesh(1)
raw = torch.empty(spec["batch"], spec["seq"] + 1, dtype=torch.int64,
                  device="meta")
with dryrun.fake_group(mesh.size):
    coll, tally, _ = dryrun.rank0_train_step(
        cfg, mesh, train.make_batch(raw, cfg, spec["seq"]), spec["micro"],
        audit=True)
print(json.dumps({"cfg": repr(cfg), "mesh": list(mesh), "collectives": coll,
                  "tally": tally.summary()}))
"""


def audit_meta(arch: str, micro: int, batch: int) -> subprocess.Popen:
    """Start the meta audit of the train CLI's step (AUDIT_META)."""
    spec = {"src": os.path.join(REPO, "src"), "arch": arch, "micro": micro,
            "batch": batch, "seq": LM_SEQ,
            "overrides": {"n_microbatches": micro, "linear_impl": "cadc",
                          "crossbar_size": LM_XBAR, "dendritic_fn": "relu"}}
    return subprocess.Popen(
        [sys.executable, "-c", AUDIT_META, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def lm_audit(meta: subprocess.Popen, cfg, step, rec: dict, report) -> None:
    """One more train step (`step()`) under the dry run's work counter on
    the card, against the meta audit `meta` of the same step: the counted
    FLOPs equal to the integer, the aten ops equal op for op, the CADC
    units equal to the K1g / K2 launch counters of the step (and to
    lm_step_launches), and the bytes equal too. Reports the counts,
    useful_ratio (model FLOPs over
    the counted ones) and the achieved rate at the path's CUDA-event step
    p50, beside nvidia-smi's name and power limit."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with dryrun.count_cost() as tally:
            m = step()
        loss = float(m["loss"])  # waits for the step
        wall = time.perf_counter() - t0
        got = read_counts()
        out, err = meta.communicate(timeout=600)
    finally:
        if meta.poll() is None:
            meta.kill()
            meta.wait()
    if meta.returncode != 0:
        fail(f"the meta audit failed: {err[-2000:]}")
    ref = json.loads(out.strip().splitlines()[-1])
    if not math.isfinite(loss):
        fail(f"{cfg.name}: a non-finite loss at the audited step")
    if ref["cfg"] != repr(cfg):
        fail(f"the meta audit's config {ref['cfg']} is not the card's "
             f"{cfg!r}")
    card, want = tally.summary(), ref["tally"]
    for k in ("flops", "bytes"):
        if card[k] != want[k]:
            fail(f"audit: the card counted {card[k]} {k}, the meta audit "
                 f"{want[k]}")
    if card["ops"] != want["ops"]:
        diff = {k: (card["ops"].get(k, 0), want["ops"].get(k, 0))
                for k in set(card["ops"]) | set(want["ops"])
                if card["ops"].get(k, 0) != want["ops"].get(k, 0)}
        fail(f"audit: aten ops (card, meta) differ: {diff}")
    per = lm_step_launches(cfg, cfg.n_microbatches)
    launched = {"cadc_fwd": got.get("cadc_matmul", 0)
                + got["cadc_matmul_gate"],
                "cadc_bwd": got["cadc_segmented_bwd"]}
    want_units = {"cadc_fwd": per["cadc_matmul_gate"],
                  "cadc_bwd": per["cadc_segmented_bwd"]}
    if not card["units"] == want["units"] == launched == want_units:
        fail(f"audit: CADC units card {card['units']}, meta "
             f"{want['units']}, launched {launched}, want {want_units}")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=LM_SEQ,
                                global_batch=rec["batch"])
    mflops = dryrun.model_flops(cfg, shape, rec["params"],
                                dryrun.active_params(cfg, rec["params"]))
    p50 = rec["step_ms_p50"]
    smi = nvidia_smi()
    a = report["lm_audit"] = {
        "flops": card["flops"], "bytes": card["bytes"],
        "units": card["units"],
        "unit_flops": card["unit_flops"], "unit_bytes": card["unit_bytes"],
        "aten_ops": sum(card["ops"].values()),
        "launches": launched, "model_flops": mflops,
        "useful_ratio": mflops / card["flops"],
        "step_ms_p50": p50, "achieved_tflops": card["flops"] / p50 / 1e9,
        "counted_step_s": wall, "collectives_meta": ref["collectives"],
        "top_op_flops": dict(sorted(card["op_flops"].items(),
                                    key=lambda kv: -kv[1])[:8]),
        "nvidia_smi": smi}
    print(f"{cfg.name} train step audit: {a['flops']} FLOPs counted on the "
          f"card == the meta audit's ({a['unit_flops']} of them in "
          f"{card['units']} CADC units = the K1g / K2 launches), "
          f"{a['aten_ops']} aten ops equal op for op, {a['bytes']} bytes "
          f"equal; useful_ratio {a['useful_ratio']:.4f} "
          f"(model FLOPs {mflops:.4e}); achieved "
          f"{a['achieved_tflops']:.2f} TFLOP/s at the step p50 {p50:.1f} ms; "
          f"the counted step {wall:.1f} s; {smi}", flush=True)


def lm_train_path(dev, report, arch=LM_ARCH, layers=None, batch=LM_BATCH,
                  micro=LM_MICRO, steps=LM_STEPS, key="lm_train",
                  audit: bool = False) -> dict:
    """A config trained at full width through repro_torch.launch.train, the
    mesh form on the NCCL group of one rank that main() holds (`steps`
    steps of `batch` x LM_SEQ tokens in `micro` micros; `layers` cuts the
    depth): exact K1g / K2 launch counts, a finite loss at every step,
    finite parameters after them, step ms, tokens/s and peak memory; then
    2 more steps of the CLI's own step (steps.make_fsdp_train_step) timed
    by CUDA events and 1 under the profiler (device busy per step by
    lm_group, the collectives split out; every kernel on one stream; the
    collectives' calls counted, and at one rank the profile's
    device-to-device copies must be all_gather's and reduce_scatter's),
    and one micro's loss and gradients (every one finite) on the trained
    parameters. With `audit`, one more step under the dry run's work
    counter, held to the meta audit of the same step (lm_audit), which
    runs in a subprocess from the start. Returns the counts."""
    import torch.distributed as dist

    from repro_torch.data import synthetic
    from repro_torch.launch import train

    meta = audit_meta(arch, micro, batch) if audit else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, "--cadc", "--crossbar", str(LM_XBAR),
                      "--steps", str(steps), "--batch", str(batch), "--seq",
                      str(LM_SEQ), "--microbatch", str(micro), "--log-every",
                      "1", "--device", "cuda"]
                     + (["--layers", str(layers)] if layers else []))
    got = read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg = out["cfg"]
    want = expect(lm_step_launches(cfg, micro), {}, steps, 0)
    if got != want:
        fail(f"{cfg.name} train path launched {got}, want {want}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{cfg.name}: losses {losses}")
    if not all(bool(torch.isfinite(t).all())
               for t in _leaves(out["params"])):
        fail(f"{cfg.name}: a non-finite parameter after {steps} steps")
    n = n_params(out["params"])
    tokens = batch * LM_SEQ
    host_ms = [1e3 * s for s in out["step_s"]]
    mesh = dict(zip(out["mesh"].axis_names, out["mesh"].shape))
    print(f"{cfg.name} LM training ({n / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers {list(cfg.pattern_for_layers)}, bf16 on "
          f"fp32 masters, CADC relu xbar {LM_XBAR}, remat; mesh {mesh} over "
          f"{dist.get_backend()}, {sum(d is not None for d in out['dims'])} "
          f"of {len(out['dims'])} leaves sharded over 'data'): {steps} steps "
          f"of {batch} x {LM_SEQ} tokens in {micro} micros in {wall:.1f} s; "
          f"losses {[round(v, 4) for v in losses]}; step ms (host) "
          f"{[round(v, 1) for v in host_ms]}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {json.dumps(got)} as "
          f"lm_step_launches says", flush=True)

    step = out["train_step"]
    data = synthetic.make_lm_dataset(synthetic.LMTokenSpec(
        vocab_size=cfg.vocab_size, seq_len=LM_SEQ), device=dev)
    batches = [train.make_batch(data(steps + i, batch)["tokens"], cfg,
                                LM_SEQ) for i in range(2)]
    state = [out["params"], out["opt_state"]]
    del out

    def run(i):
        state[0], state[1], m = step(state[0], state[1], batches[i % 2],
                                     steps + i)
        return m

    times = []
    for i in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = run(i)
        end.record()
        torch.cuda.synchronize()
        if not math.isfinite(float(m["loss"])):
            fail(f"{cfg.name}: a non-finite loss at a timed step")
        times.append(start.elapsed_time(end))
    p50 = float(np.median(times))
    calls, restore = count_collectives()
    streams = []
    try:
        wall_ms, busy, rows, groups = profile_device(
            lambda i: run(2 + i), 1, lm_group, f"the {cfg.name} train step",
            cpu=False, streams=streams)
    finally:
        restore()
    if len(streams) != 1:
        fail(f"{cfg.name} train step: device work on {len(streams)} "
             f"streams ({streams}), want one")
    copies = sum(c for ms, k, c in rows if k.lower().startswith(
        "memcpy dtod"))
    rows_a_micro = batch // micro
    loss, grads = _lm_loss_and_grads(
        cfg, state[0], {k: v[:rows_a_micro] for k, v in batches[0].items()})
    if not (math.isfinite(loss)
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        fail(f"{cfg.name}: a non-finite loss or gradient on one micro")
    del grads
    rec = report[key] = {
        "arch": cfg.name, "params": n, "layers": cfg.n_layers,
        "pattern": list(cfg.pattern_for_layers), "mesh": mesh,
        "backend": dist.get_backend(),
        "batch": batch, "seq": LM_SEQ, "micro": micro,
        "steps": steps, "losses": losses, "wall_s": wall,
        "step_ms_host": host_ms, "step_ms_events": times,
        "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
        "peak_memory_bytes": peak, "launches": got,
        "launches_per_step": lm_step_launches(cfg, micro),
        "collective_calls_per_step": calls, "streams": streams,
        "dtod_copies_per_step": copies,
        "profiled_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_launches_per_step": sum(r[2] for r in rows),
        "device_ms_per_step_by_group": groups,
        "device_top_per_step": [{"name": k[:110], "ms": ms, "calls": c}
                                for ms, k, c in rows[:24]],
        "grads_finite_one_micro": True}
    print(f"{cfg.name} train step (CUDA events, 2 steps): p50 {p50:.1f} ms, "
          f"{tokens / (p50 / 1e3):.0f} tokens/s; profiler: device busy "
          f"{busy:.1f} of {wall_ms:.1f} ms per step (idle share "
          f"{rec['idle_share']:.3f}) over "
          f"{rec['device_launches_per_step']:.0f} launches on one stream; "
          f"collective calls a step {json.dumps(calls)} (at one rank "
          f"{calls['all_gather'] + calls['reduce_scatter']} of the profile's "
          f"{copies:.0f} device-to-device copies); one micro's "
          f"loss {loss:.4f}, every gradient finite", flush=True)
    for gname, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {gname}: {g['ms']:.2f} ms/step over {g['calls']:.0f} "
              f"launches", flush=True)
    for ms, k, c in rows[:12]:
        print(f"    {ms:8.3f} ms x{c:.0f} {k[:100]}", flush=True)
    if meta is not None:
        lm_audit(meta, cfg, lambda: run(3), rec, report)
    del state, batches, step
    torch.cuda.empty_cache()
    return got


def _leaves(tree) -> list:
    from repro_torch.launch import steps as steps_lib

    return steps_lib._leaves(tree)


def _lm_batch(cfg, b: int, s: int, dev, seed: int) -> dict:
    """Random tokens (frames for the audio frontend) and labels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    if cfg.frontend == "audio":
        return {"frames": torch.randn(b, s, cfg.frontend_dim, generator=gen,
                                      device=dev), "labels": labels}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device=dev), "labels": labels}


def _lm_loss_and_grads(cfg, params, batch):
    """lm_loss + 0.01 * aux of forward_train on cast_compute(params), and
    the gradient of every fp32 master, as the train step takes them."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf

    leaves = [p.detach().requires_grad_() for p in steps_lib._leaves(params)]
    live = steps_lib._rebuild(params, leaves)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, aux = tf.forward_train(steps_lib.cast_compute(live, cfg), inputs,
                                   cfg)
    loss = tf.lm_loss(logits, batch["labels"])[0] + 0.01 * aux
    del logits
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


def lm_parity(dev, report) -> None:
    """Kernel path (kernel_impl 'auto': K1g / K2) against plain path
    ('torch') from the same params and batch, at published width and
    LM_PARITY_LAYERS layers: gemma3-1b in fp32 (loss and every gradient
    within 1e-4 of scale) and bf16 (loss within LM_BF16_LOSS_RTOL; the
    gradients' error reported), hubert-xlarge in fp32 (frames,
    bidirectional attention, the gelu FFN, the untied 504-way head),
    qwen2-moe-a2.7b in fp32 (the aux loss, the expert banks' backward,
    K1g / K2 at the 152 064-wide head) and in bf16 (the expert products'
    fp32-output torch.bmm under autograd), recurrentgemma-9b (the RG-LRU
    scan; the local window of 2048 bites at 2560 tokens) and xlstm-1.3b
    (two chunks of the chunkwise mLSTM, the sLSTM loop, the untied head)
    in fp32 and bf16; exact launch counts, none on the plain path. Then
    gemma3-1b's prefill step (no gradient: K1) against the plain path's."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf

    out = {}
    runs = [(LM_ARCH, "float32"), (LM_ARCH, "bfloat16"),
            (HUBERT_ARCH, "float32"), (MOE_ARCH, "float32"),
            (MOE_ARCH, "bfloat16"), (RG_ARCH, "float32"),
            (RG_ARCH, "bfloat16"), (XL_ARCH, "float32"),
            (XL_ARCH, "bfloat16")]
    for arch, dtype in runs:
        t0 = time.perf_counter()
        cfg = lm_cfg(arch, n_layers=LM_PARITY_LAYERS[arch], dtype=dtype)
        b, s = LM_PARITY_TOKENS[arch]
        params = tf.init(cfg, seed=0, device=dev)
        batch = _lm_batch(cfg, b, s, dev, seed=7)
        res = {}
        for impl in ("auto", "torch"):
            zero_counts()
            res[impl] = _lm_loss_and_grads(
                cfg.with_overrides(kernel_impl=impl), params, batch) + (
                read_counts(),)
        (lk, gk, nk), (lp, gp, np_) = res["auto"], res["torch"]
        want = expect(lm_step_launches(cfg, 1), {}, 1, 0)
        if nk != want or any(np_.values()):
            fail(f"{cfg.name} {dtype}: launches kernel path {nk} (want "
                 f"{want}), plain path {np_} (want none)")
        worst_g = max(rel_err(a, c)[0] for a, c in zip(gk, gp))
        loss_err = abs(lk - lp) / max(1.0, abs(lp))
        tol = LOSS0_RTOL if dtype == "float32" else LM_BF16_LOSS_RTOL
        if not (math.isfinite(lk) and loss_err <= tol):
            fail(f"{cfg.name} {dtype}: loss {lk} vs plain {lp} (rel err "
                 f"{loss_err} > {tol})")
        if dtype == "float32" and not worst_g <= TRAIN_RTOL:
            fail(f"{cfg.name} fp32: gradient err / scale {worst_g} > "
                 f"{TRAIN_RTOL}")
        if not all(bool(torch.isfinite(g).all()) for g in gk):
            fail(f"{cfg.name} {dtype}: a non-finite gradient")
        key = f"{arch}.{dtype}"
        out[key] = {"layers": cfg.n_layers, "tokens": [b, s],
                    "loss": [lk, lp], "loss_rel_err": loss_err,
                    "grad_err_over_scale": worst_g, "launches": nk,
                    "s": time.perf_counter() - t0}
        print(f"LM parity {cfg.name} ({cfg.n_layers} layers, {dtype}, "
              f"{b} x {s} tokens): loss {lk:.6f} vs plain {lp:.6f} (rel "
              f"err {loss_err:.2e}, tol {tol}); grads max err / scale "
              f"{worst_g:.2e}{'' if dtype == 'float32' else ' (reported)'};"
              f" launches {json.dumps(nk)}; {out[key]['s']:.1f} s",
              flush=True)
        del params, batch, res, gk, gp
        torch.cuda.empty_cache()
    cfg = lm_cfg(LM_ARCH, n_layers=LM_PARITY_LAYERS[LM_ARCH],
                 dtype="float32")
    params = tf.init(cfg, seed=0, device=dev)
    batch = {"tokens": _lm_batch(cfg, *LM_PARITY_TOKENS[LM_ARCH], dev,
                                 seed=8)["tokens"]}
    zero_counts()
    got = steps_lib.make_prefill_step(cfg)(params, batch)
    nk = read_counts()
    want = steps_lib.make_prefill_step(cfg.with_overrides(
        kernel_impl="torch"))(params, batch)
    err = rel_err(got, want)[0]
    k1 = cfg.n_layers * len(linear_shapes(cfg))
    if nk != {**{k: 0 for k in nk}, "cadc_matmul": k1}:
        fail(f"prefill step launched {nk}, want K1 x {k1} only")
    if not err <= LOGITS_RTOL:
        fail(f"prefill step logits err / scale {err} > {LOGITS_RTOL}")
    out["prefill_step"] = {"logits_err_over_scale": err, "launches": nk}
    print(f"prefill step ({cfg.name}, {cfg.n_layers} layers, fp32): "
          f"next-token logits err / scale {err:.2e} against the plain "
          f"path; K1 x {k1}, no K1g / K2", flush=True)
    report["lm_parity"] = out
    del params
    torch.cuda.empty_cache()


def lm_resume(dev, report) -> None:
    """gemma3-1b at full width and LM_RESUME_LAYERS layers through the
    train CLI: 4 steps straight against 2 steps that save (--ckpt-dir)
    and a second call that resumes to 4: params and AdamW moments
    bitwise, the same losses, exact launch counts over the three calls."""
    import shutil

    from repro_torch import ckpt
    from repro_torch.launch import train

    d = os.path.join(REPO, "build", "lm_resume")
    shutil.rmtree(d, ignore_errors=True)

    def run(steps, ckpt_dir=None):
        argv = ["--arch", LM_ARCH, "--cadc", "--crossbar", str(LM_XBAR),
                "--steps", str(steps), "--batch", str(LM_BATCH), "--seq",
                str(LM_SEQ), "--microbatch", str(LM_MICRO), "--layers",
                str(LM_RESUME_LAYERS), "--log-every", "1", "--device",
                "cuda"]
        if ckpt_dir:
            argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "2",
                     "--keep-k", "1"]
        return train.main(argv)

    zero_counts()
    t0 = time.perf_counter()
    straight = run(4)
    run(2, d)
    if ckpt.all_steps(d) != [2]:
        fail(f"lm_resume: checkpoints {ckpt.all_steps(d)} after 2 steps, "
             "want [2]")
    resumed = run(4, d)
    got = read_counts()
    wall = time.perf_counter() - t0
    want = expect(lm_step_launches(resumed["cfg"], LM_MICRO), {}, 8, 0)
    if got != want:
        fail(f"lm_resume launched {got}, want {want}")
    if [h["step"] for h in resumed["history"]] != [2, 3] or [
            h["loss"] for h in resumed["history"]] != [
            h["loss"] for h in straight["history"][2:]]:
        fail(f"lm_resume: resumed history {resumed['history']} against "
             f"{straight['history']}")
    names, a = ckpt.checkpoint._flatten([resumed["params"],
                                         resumed["opt_state"]])
    _, b = ckpt.checkpoint._flatten([straight["params"],
                                     straight["opt_state"]])
    differ = [nm for nm, x, y in zip(names, a, b) if not torch.equal(x, y)]
    if differ:
        fail(f"lm_resume: resumed state differs from the straight run's at "
             f"{differ[:5]}")
    shutil.rmtree(d, ignore_errors=True)
    report["lm_resume"] = {"layers": LM_RESUME_LAYERS, "wall_s": wall,
                           "launches": got, "tensors_bitwise": len(names)}
    print(f"lm_resume: {resumed['cfg'].name} at {LM_RESUME_LAYERS} layers, "
          f"4 steps straight = 2 steps + save + resume to 4, bitwise over "
          f"{len(names)} tensors (params and AdamW moments), launches "
          f"{json.dumps(got)}, {wall:.1f} s", flush=True)
    del straight, resumed
    torch.cuda.empty_cache()


def lm_twin(dev, report) -> None:
    """The twin of examples/lm_cadc_train.py on the card: gemma3-1b's smoke
    config, CADC at crossbar 64, batch 8, seq 128, LM_TWIN_STEPS steps; the
    loss must decrease (the twin raises otherwise); exact launch counts."""
    from repro_torch.launch import lm_cadc_train

    zero_counts()
    t0 = time.perf_counter()
    out = lm_cadc_train.main(["--steps", str(LM_TWIN_STEPS), "--device",
                              "cuda"])
    got = read_counts()
    wall = time.perf_counter() - t0
    want = expect(lm_step_launches(out["cfg"], 1), {}, LM_TWIN_STEPS, 0)
    if got != want:
        fail(f"lm_cadc_train twin launched {got}, want {want}")
    losses = [h["loss"] for h in out["history"]]
    report["lm_twin"] = {"steps": LM_TWIN_STEPS, "losses": losses,
                         "wall_s": wall, "launches": got}
    print(f"lm_cadc_train twin ({out['cfg'].name} smoke, {LM_TWIN_STEPS} "
          f"steps): loss {losses[0]:.4f} -> {losses[-1]:.4f}, {wall:.1f} s, "
          f"launches {json.dumps(got)}", flush=True)


def lm_linear_work(m: int, d: int, n: int) -> dict:
    """{"k1g", "k2", "k2_fp32": (bytes, operations)} of one call at an LM
    linear of m rows, D = d (whole crossbars) and N = n: K1g reads bf16 x
    and w, writes the fp32 output and the packed gate; K2 (the tensor-core
    route) reads bf16 g, x, w and the gate and writes fp32 dx and dw, twice
    K1g's operations; "k2_fp32" the CUDA-core route's, which reads fp32
    g, x and w."""
    gate_b = d // LM_XBAR * m * -(-n // 32) * 4
    flops = 2 * m * d * n
    out = 4 * (m * d + d * n) + gate_b
    return {"k1g": (2 * (m * d + d * n) + 4 * m * n + gate_b, flops),
            "k2": (2 * (m * n + m * d + d * n) + out, 2 * flops),
            "k2_fp32": (4 * (m * n + m * d + d * n) + out, 2 * flops)}


def _profiled(fn, reps: int = 1) -> dict:
    """reps calls of fn() under the profiler (device activity only), per
    call: wall ms (CUDA events), device busy ms and device operations
    (kernels, copies); the last two None (not measured) where the profiler
    showed no device time."""
    wall, busy, rows, _ = profile_device(lambda i: fn(), reps,
                                         lambda k: "all",
                                         "a recurrent training form",
                                         cpu=False, required=False)
    return {"wall_ms": wall, "busy_ms": busy,
            "launches": None if busy is None else sum(r[2] for r in rows)}


def _sum_or_none(*vals):
    return None if any(v is None for v in vals) else sum(vals)


def _fmt(v, spec: str) -> str:
    return "not measured" if v is None else format(v, spec)


def rec_forms(dev, report) -> None:
    """Slice 8's form checks and costs. (1) Each training form against its
    decode cell run token by token, fp32, one layer at full width, 2 x
    REC_FORM_S tokens, no gradient (K1): rglru_apply against rglru_decode,
    mlstm_apply's chunkwise form (2 chunks of 256) against its sequential
    form (mlstm_chunk 0) and against mlstm_decode, slstm_apply against
    slstm_decode, each within REC_FORM_RTOL of scale and finite. (2) What
    each recurrence costs at a train micro's shape (2 x LM_SEQ tokens, bf16
    inputs as the step gives them): the forward and the forward with its
    backward of _linear_scan (recurrentgemma-9b's a, b), _mlstm_chunkwise
    (xlstm-1.3b's q / k / v / gates) and an sLSTM block (slstm_apply, its
    linears included), each under the profiler — wall ms, device busy ms,
    device operations a call (the two short forms over REC_FORM_REPS calls
    a window, the sLSTM over one); a micro under remat runs the forward
    twice and the backward once. Where the profiler shows no device time
    (profile_device) the busy ms and operations are not measured. The sLSTM's operations a token, forward and backward,
    from the difference between LM_SEQ and LM_SEQ / 2 tokens."""
    from repro_torch.models.lm import rglru as rg
    from repro_torch.models.lm import transformer as tf
    from repro_torch.models.lm import xlstm as xl

    gen = torch.Generator(device=dev).manual_seed(30)
    b, s = 2, REC_FORM_S

    def decode_run(decode, init_state, p, x, cfg):
        state, ys = init_state(cfg, b, dev), []
        for t in range(s):
            y, state = decode(p, x[:, t:t + 1], cfg, state)
            ys.append(y)
        return torch.cat(ys, dim=1)

    checks = {}
    with torch.no_grad():
        cfg = lm_cfg(RG_ARCH, dtype="float32")
        p = rg.rglru_init(gen, cfg, dev)
        x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev)
        checks["rglru_apply vs rglru_decode"] = (
            rg.rglru_apply(p, x, cfg),
            decode_run(rg.rglru_decode, rg.rglru_init_state, p, x, cfg))
        cfg = lm_cfg(XL_ARCH, dtype="float32")
        p = xl.mlstm_init(gen, cfg, dev)
        x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev)
        chunked = xl.mlstm_apply(p, x, cfg)
        checks["mlstm_apply chunkwise vs sequential"] = (
            chunked, xl.mlstm_apply(p, x, cfg.with_overrides(mlstm_chunk=0)))
        checks["mlstm_apply chunkwise vs mlstm_decode"] = (
            chunked,
            decode_run(xl.mlstm_decode, xl.mlstm_init_state, p, x, cfg))
        p = xl.slstm_init(gen, cfg, dev)
        checks["slstm_apply vs slstm_decode"] = (
            xl.slstm_apply(p, x, cfg),
            decode_run(xl.slstm_decode, xl.slstm_init_state, p, x, cfg))
        del p, x, chunked
    out = {"tokens": [b, s], "err_over_scale": {}}
    for name, (got, want) in checks.items():
        err = rel_err(got, want)[0]
        if not (bool(torch.isfinite(got).all()) and err <= REC_FORM_RTOL):
            fail(f"{name} (fp32, full width, {b} x {s} tokens): err / "
                 f"scale {err} > {REC_FORM_RTOL}, or not finite")
        out["err_over_scale"][name] = err
    del checks
    print(f"training forms against their decode cells (fp32, full width, "
          f"{b} x {s} tokens, tol {REC_FORM_RTOL}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in
                      out["err_over_scale"].items()), flush=True)

    bf = torch.bfloat16
    s = LM_SEQ

    def leaf(*shape, dtype=bf, unit=False):
        """A random input that takes a gradient: N(0, 1), or U(0, 1)."""
        draw = torch.rand if unit else torch.randn
        return draw(*shape, generator=gen, device=dev).to(
            dtype).requires_grad_()

    def cost(fwd, tokens=s, reps=REC_FORM_REPS):
        """fwd() -> (out, inputs): the forward, then with the backward."""
        def both():
            y, ins = fwd()
            torch.autograd.grad(y.float().square().sum(), ins)
        both()  # warm up
        return {"tokens": [b, tokens],
                "fwd": _profiled(lambda: fwd()[0], reps),
                "fwd_bwd": _profiled(both, reps)}

    rw = lm_cfg(RG_ARCH).rnn_width
    a, bb = leaf(b, s, rw, dtype=torch.float32, unit=True), leaf(
        b, s, rw, dtype=torch.float32)
    costs = {"rglru _linear_scan": cost(
        lambda: (rg._linear_scan(a, bb), (a, bb)))}
    del a, bb
    cfg = lm_cfg(XL_ARCH)
    di, dh = xl._mlstm_dims(cfg)
    h = cfg.n_heads
    qkvif = [leaf(b, s, h, dh) for _ in range(3)] + [leaf(b, s, h)
                                                     for _ in range(2)]
    costs["mlstm _mlstm_chunkwise"] = cost(lambda: (xl._mlstm_chunkwise(
        *qkvif, chunk=cfg.mlstm_chunk, dh=dh), qkvif))
    del qkvif
    p = tf.cast_params(xl.slstm_init(gen, cfg, dev), bf)
    leaves = []
    tf.tree_map(lambda t: leaves.append(t.requires_grad_()), p)
    for n in (s // 2, s):
        x = leaf(b, n, cfg.d_model)
        costs[f"slstm_apply {n}"] = keep_counts(lambda: cost(
            lambda: (xl.slstm_apply(p, x, cfg), leaves + [x]), n, 1))
        del x
    half, full = costs[f"slstm_apply {s // 2}"], costs[f"slstm_apply {s}"]
    per_token = {k: None if None in (full[k]["launches"],
                                     half[k]["launches"])
                 else (full[k]["launches"] - half[k]["launches"]) / (s // 2)
                 for k in ("fwd", "fwd_bwd")}
    fwd, both = per_token["fwd"], per_token["fwd_bwd"]
    out["slstm_launches_per_token"] = {
        "forward": fwd,
        "backward": None if None in (fwd, both) else both - fwd,
        "micro_under_remat": _sum_or_none(fwd, both)}
    for rec in costs.values():
        rec["micro_under_remat"] = {
            k: _sum_or_none(rec["fwd"][k], rec["fwd_bwd"][k])
            for k in rec["fwd"]}
    out["costs"] = costs
    report["rec_forms"] = out
    for name, rec in costs.items():
        r = rec["micro_under_remat"]
        f, fb = rec["fwd"], rec["fwd_bwd"]
        print(f"  {name} ({rec['tokens'][0]} x {rec['tokens'][1]} tokens): "
              f"forward {f['wall_ms']:.2f} ms wall / "
              f"{_fmt(f['busy_ms'], '.2f')} busy / "
              f"{_fmt(f['launches'], '.0f')} ops; forward + backward "
              f"{fb['wall_ms']:.2f} / {_fmt(fb['busy_ms'], '.2f')} / "
              f"{_fmt(fb['launches'], '.0f')}; a micro under remat "
              f"{r['wall_ms']:.2f} / {_fmt(r['busy_ms'], '.2f')} / "
              f"{_fmt(r['launches'], '.0f')}", flush=True)
    print(f"  the sLSTM loop's device operations a token: "
          f"{json.dumps(out['slstm_launches_per_token'])}", flush=True)
    del p, leaves
    torch.cuda.empty_cache()


def rec_step_rows(rows, launches: dict, report) -> None:
    """The kernels line's K1g and K2 rows gain each recurrent train path's
    launches, and a record of its step (REC_TRAIN): launches a step, the
    device ms a step the profiler gave its group, the bound of its linears'
    work (LM_M rows a micro; K1g's bf16 operands and packed gate, twice a
    layer's linear under remat; K2's tensor-core route on the bf16
    operands, and beside it "bound_fp32_ms": the CUDA-core route's fp32
    operands at the fp32 peak, as time_lm_kernels counts them)."""
    names = {"cadc_matmul_gate": ("k1g", ("K1g cadc_matmul_gate",)),
             "cadc_segmented_bwd": ("k2", ("K2 dx", "K2 dw"))}
    for arch, kw in REC_TRAIN.items():
        rec = report[f"{arch}_train"]
        cfg = lm_cfg(arch, n_layers=kw["layers"])
        outside = {"head", "frontend_proj"}
        tot = {"k1g": [0.0, 0.0], "k2": [0.0, 0.0], "k2_fp32": [0.0, 0.0]}
        for name, d, n in train_linear_shapes(cfg):
            work = lm_linear_work(LM_M, d, n)
            times = {"k1g": kw["micro"] * (1 if name in outside
                                           or not cfg.remat else 2),
                     "k2": kw["micro"], "k2_fp32": kw["micro"]}
            for key, t in tot.items():
                t[0] += times[key] * work[key][0]
                t[1] += times[key] * work[key][1]
        for row in rows:
            if row["name"] not in names:
                continue
            key, groups = names[row["name"]]
            b_ms, b_by = bound_ms(*tot[key], torch.bfloat16)
            ms = sum(rec["device_ms_per_step_by_group"].get(
                g, {"ms": 0.0})["ms"] for g in groups)
            if rec["launches_per_step"][row["name"]] and not ms:
                fail(f"{cfg.name} train step: the profile's {groups} show no "
                     f"device time over {rec['launches_per_step'][row['name']]}"
                     " launches a step (a kernel outside its group?)")
            row["launches"] += launches[arch][row["name"]]
            row[f"{arch}_step"] = {
                "launches": rec["launches_per_step"][row["name"]],
                "ms": ms, "bound_ms": b_ms, "bound_by": b_by}
            if key == "k2":
                row[f"{arch}_step"]["bound_fp32_ms"] = bound_ms(
                    *tot["k2_fp32"], torch.float32)[0]
            print(f"{row['name']} per {cfg.name} train step ({cfg.n_layers} "
                  f"layers): {ms:.2f} ms over "
                  f"{rec['launches_per_step'][row['name']]} launches "
                  f"(profiler), bound {b_ms:.3f} by {b_by}", flush=True)


def time_lm_linear(dev, gen, m: int, d: int, n: int,
                   kernel: bool = True) -> dict:
    """One LM linear at m rows, D = d (whole crossbars), N = n, relu's
    packed gate, bf16 operands as the train step runs them: {"k1g", "k2":
    device ms of one call of the kernel (with `kernel`), its plain version
    and the vConv library call (torch.matmul in bf16: y = x @ w; the dx /
    dw pair g @ wᵀ, xᵀ @ g), and the call's bound at the bf16 peak}; K1g
    also under the CUDA-core tile kernel's plan ("tile_ms": the kernel the
    bf16 route ran before the tensor-core kernel); K2 also as the
    CUDA-core route runs it ("fp32_route_ms": fp32 copies of g, x and w,
    then the fp32 kernels: the route before the tensor-core kernels), the
    fp32 torch.matmul pair on fp32 operands ("library_fp32_ms") and the
    bound at the fp32 peak ("bound_fp32_ms")."""
    from repro_torch.kernels import cadc_matmul as cm

    kw = dict(crossbar_size=LM_XBAR, fn="relu")
    bf = torch.bfloat16
    tile = cm.plan_fwd(m, n, d // LM_XBAR, LM_XBAR)
    plan = cm.plan_fwd(m, n, d // LM_XBAR, LM_XBAR, dtype=bf)
    bplan = cm.plan_bwd(m, n, d, LM_XBAR, "packed", dtype=bf, fn="relu")
    work = lm_linear_work(m, d, n)
    w16 = (torch.randn(d, n, generator=gen, device=dev)
           / math.sqrt(d)).to(bf)
    w32 = w16.float()

    def make_x():
        return (torch.randn(m, d, generator=gen, device=dev).to(bf),)

    def make_bwd():
        return (torch.randn(m, n, generator=gen, device=dev).to(bf),
                torch.randn(m, d, generator=gen, device=dev).to(bf))

    _, gate = keep_counts(lambda: cm.cadc_matmul_gate_cuda(
        make_x()[0], w16, mode="packed", **kw))
    rec = {"d": d, "n": n}
    for key, make, kern, plain, lib, nbytes, ops in (
            ("k1g", make_x,
             lambda x: cm.cadc_matmul_gate_cuda(x, w16, mode="packed",
                                                **kw),
             lambda x: cm.cadc_matmul_gate_torch(x, w16, mode="packed",
                                                 **kw),
             lambda x: torch.matmul(x, w16), *work["k1g"]),
            ("k2", make_bwd,
             lambda g, x: cm.cadc_segmented_bwd_cuda(
                 g, x, w16, gate, mode="packed", **kw),
             lambda g, x: cm.cadc_segmented_bwd_torch(
                 g, x, w16, gate, mode="packed", **kw),
             lambda g, x: (torch.matmul(g, w16.T), torch.matmul(x.T, g)),
             *work["k2"])):
        first = make()
        ops_set = [first] + rotation(make, sum(
            t.numel() * t.element_size() for t in first))[1:]
        reps = max(8, len(ops_set))
        pick = itertools.cycle(ops_set).__next__
        b_ms, b_by = bound_ms(nbytes, ops, bf)
        rec[key] = {
            "plain_ms": keep_counts(
                lambda: device_ms(lambda: plain(*pick()), reps)),
            "library_ms": device_ms(lambda: lib(*pick()), reps),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "ops": ops}
        if kernel:
            rec[key]["ms"] = keep_counts(
                lambda: device_ms(lambda: kern(*pick()), reps))
        if key == "k1g":
            rec[key]["plan"] = f"{plan.kernel} {plan.width} x{plan.groups}"
            rec[key]["tile_ms"] = device_ms(lambda: cm._fwd_launch(
                *pick(), w16, LM_XBAR, "relu", "packed", plan=tile), reps)
        else:
            rec[key]["plan"] = (f"{bplan.kernel} dx {bplan.dx_tile[0]} "
                                f"rows, dw x{bplan.dw_splits}")
            rec[key]["fp32_route_ms"] = keep_counts(lambda: device_ms(
                lambda: (lambda g, x: cm.cadc_segmented_bwd_cuda(
                    g.float(), x.float(), w16.float(), gate, mode="packed",
                    **kw))(*pick()), reps))
            ops32 = [(g.float(), x.float()) for g, x in ops_set]
            pick32 = itertools.cycle(ops32).__next__
            rec[key]["library_fp32_ms"] = device_ms(
                lambda: (lambda g, x: (torch.matmul(g, w32.T),
                                       torch.matmul(x.T, g)))(*pick32()),
                reps)
            rec[key]["bound_fp32_ms"] = bound_ms(*work["k2_fp32"],
                                                 torch.float32)[0]
            del ops32
        del ops_set, first
    del w16, w32, gate
    torch.cuda.empty_cache()
    return rec


def time_lm_kernels(dev, launches, rows, report) -> None:
    """K1g and K2 device times on bf16 operands at gemma3-1b's 7 linear
    shapes, M = LM_M, relu's packed gate, summed over one train step (each
    shape x 26 layers x LM_MICRO micros, K1g twice under remat), beside
    their plain versions, the vConv PyTorch calls (torch.matmul in bf16),
    the bound at the bf16 peak, and for K2 the CUDA-core route the step
    took before (fp32 copies of g, x and w and the fp32 kernels), the fp32
    torch.matmul pair and the fp32 bound (time_lm_linear). Adds each row's
    "lm_step" record and the LM path's launches."""
    cfg = lm_cfg(LM_ARCH)
    per = lm_step_launches(cfg, LM_MICRO)
    k1g_per_shape = per["cadc_matmul_gate"] // (cfg.n_layers * 7)
    k2_per_shape = per["cadc_segmented_bwd"] // (cfg.n_layers * 7)
    gen = torch.Generator(device=dev).manual_seed(21)
    fields = ("ms", "plain_ms", "library_ms", "bytes", "ops", "tile_ms",
              "fp32_route_ms", "library_fp32_ms")
    tot = {k: dict.fromkeys(fields, 0.0) for k in ("k1g", "k2")}
    tot["k2"]["work32"] = [0.0, 0.0]
    per_shape = {}
    m = LM_M
    for name, d, n in linear_shapes(cfg):
        count = cfg.n_layers  # one linear of this name a layer
        rec = per_shape[name] = time_lm_linear(dev, gen, m, d, n)
        for key, t in tot.items():
            r = rec[key]
            mult = r["per_step"] = count * (k1g_per_shape if key == "k1g"
                                            else k2_per_shape)
            for f in fields:
                t[f] += mult * r.get(f, 0.0)
        w32 = lm_linear_work(m, d, n)["k2_fp32"]
        mult = rec["k2"]["per_step"]
        tot["k2"]["work32"] = [a + mult * b for a, b in
                               zip(tot["k2"]["work32"], w32)]
        k1, k2 = rec["k1g"], rec["k2"]
        print(f"LM {name} M={m} D={d} N={n}: K1g {k1['ms']:.4f} ms "
              f"({k1['plan']}; the tile kernel {k1['tile_ms']:.4f}, "
              f"torch.matmul bf16 {k1['library_ms']:.4f}, bound "
              f"{k1['bound_ms']:.4f}), K2 {k2['ms']:.4f} ms ({k2['plan']}; "
              f"the fp32 route with its copies {k2['fp32_route_ms']:.4f}, "
              f"torch.matmul pair bf16 {k2['library_ms']:.4f} / fp32 "
              f"{k2['library_fp32_ms']:.4f}, bound bf16 "
              f"{k2['bound_ms']:.4f} / fp32 {k2['bound_fp32_ms']:.4f})",
              flush=True)
    report["lm_kernel_timing"] = {
        "unit": f"one gemma3-1b train step: {LM_BATCH} x {LM_SEQ} tokens in "
                f"{LM_MICRO} micros of {m} rows, xbar {LM_XBAR}, relu, "
                "packed gate, K1g twice a linear a micro (remat)",
        "per_shape_one_call": per_shape,
        "per_step": {k: dict(v) for k, v in tot.items()}}
    names = {"k1g": "cadc_matmul_gate", "k2": "cadc_segmented_bwd"}
    for row in rows:
        key = next((k for k, v in names.items() if v == row["name"]), None)
        if key is None:
            continue
        t = tot[key]
        b_ms, b_by = bound_ms(t["bytes"], t["ops"], torch.bfloat16)
        row["launches"] += launches[row["name"]]
        row["lm_step"] = {"launches": per[row["name"]], "ms": t["ms"],
                          "plain_ms": t["plain_ms"], "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": t["library_ms"]}
        if key == "k2":
            row["lm_step"].update(
                fp32_route_ms=t["fp32_route_ms"],
                library_fp32_ms=t["library_fp32_ms"],
                bound_fp32_ms=bound_ms(*t["work32"], torch.float32)[0])
        else:
            row["lm_step"]["tile_ms"] = t["tile_ms"]
        step = row["lm_step"]
        print(f"{row['name']} per gemma3-1b train step: {t['ms']:.2f} ms "
              f"over {per[row['name']]} launches ("
              + (f"the tile kernel {t['tile_ms']:.2f}, " if key == "k1g" else
                 f"the fp32 route with its copies {t['fp32_route_ms']:.2f}, ")
              + f"plain {t['plain_ms']:.2f}, vConv library bf16 "
              f"{t['library_ms']:.2f}"
              + (f" / fp32 {t['library_fp32_ms']:.2f}" if key == "k2" else "")
              + f", bound {b_ms:.3f} by {b_by}"
              + (f" / fp32 {step['bound_fp32_ms']:.3f}" if key == "k2"
                 else "") + ")", flush=True)


def rec_library_rows(dev, rows, report) -> None:
    """The plain versions' and the vConv library calls' times of each
    recurrent train step's linears (REC_TRAIN; time_lm_linear at each
    distinct shape, times its calls a step: K1g a micro, twice a layer's
    linear under remat, K2 once), K1g's under the CUDA-core tile kernel
    ("tile_ms", the bf16 route before the tensor-core kernel) and K2's on
    the CUDA-core route ("fp32_route_ms", fp32 copies and the fp32
    kernels: the route before the tensor-core kernels) with the fp32
    torch.matmul pair ("library_fp32_ms"), added to the K1g and K2 rows'
    "<arch>_step" records beside rec_step_rows' profiler ms and bounds."""
    names = {"cadc_matmul_gate": "k1g", "cadc_segmented_bwd": "k2"}
    gen = torch.Generator(device=dev).manual_seed(22)
    for arch, kw in REC_TRAIN.items():
        cfg = lm_cfg(arch, n_layers=kw["layers"])
        outside = {"head", "frontend_proj"}
        calls = {}
        for name, d, n in train_linear_shapes(cfg):
            c = calls.setdefault((d, n), {"k1g": 0, "k2": 0})
            c["k1g"] += kw["micro"] * (1 if name in outside
                                       or not cfg.remat else 2)
            c["k2"] += kw["micro"]
        tot = {k: {"plain_ms": 0.0, "library_ms": 0.0} for k in names.values()}
        tot["k1g"]["tile_ms"] = 0.0
        tot["k2"].update(fp32_route_ms=0.0, library_fp32_ms=0.0)
        for (d, n), c in calls.items():
            rec = time_lm_linear(dev, gen, LM_M, d, n, kernel=False)
            for key, t in tot.items():
                for f in t:
                    t[f] += c[key] * rec[key][f]
        for row in rows:
            key = names.get(row["name"])
            if key is not None:
                row[f"{arch}_step"].update(tot[key])
                step = row[f"{arch}_step"]
                print(f"{row['name']} per {cfg.name} train step "
                      f"({cfg.n_layers} layers): kernel {step['ms']:.2f} ms "
                      f"(profiler)"
                      + (f", the tile kernel {step['tile_ms']:.2f}"
                         if "tile_ms" in step else "")
                      + (f", the fp32 route with its copies "
                         f"{step['fp32_route_ms']:.2f}"
                         if "fp32_route_ms" in step else "")
                      + f", plain {step['plain_ms']:.2f}, vConv "
                      f"library bf16 {step['library_ms']:.2f}"
                      + (f" / fp32 {step['library_fp32_ms']:.2f}"
                         if "library_fp32_ms" in step else "")
                      + f", bound {step['bound_ms']:.3f} by "
                      f"{step['bound_by']}"
                      + (f" / fp32 {step['bound_fp32_ms']:.3f}"
                         if "bound_fp32_ms" in step else ""), flush=True)


# ---------------------------------------------------------------------------
# slice 9: multi-device training — the tensor-parallel CADC linear
# ---------------------------------------------------------------------------

# gemma3-1b's w_down (6912 -> 1152) at crossbar 128 (54 segments, 27 a rank
# at 2 ranks) and w_gate (1152 -> 6912) at crossbar 64 (18 segments), at
# M = 8 (a decode step) and LM_M rows (a train micro). TP_RTOL: the fp32
# wire against the unsharded K1 adds the two ranks' partial sums in
# another order (1e-5 of scale, the JAX test's fp32 bound); TP_BF16_REL:
# the bf16 wire's relative error (the JAX test's bound).
TP_CASES = [("w_down", 6912, 1152, 128), ("w_gate", 1152, 6912, 64)]
TP_M = (8, LM_M)
TP_RANKS = 2
TP_RTOL, TP_BF16_REL = 1e-5, 0.01


# Slice 10: the LM train step tensor-parallel over "model" at (data 1,
# model 2), in the same two spawned ranks as the TP linear (gloo over the
# card's tensors): gemma3-1b at full width and TP_STEP_LAYERS layers, CADC
# relu at crossbar TP_STEP_XBAR, so wo (8 segments) and w_down (54) run
# row-parallel over 4 and 27 local segments and the tied 262 144-row
# vocab splits into 131 072 a rank; TP_STEP_STEPS steps of TP_STEP_BATCH
# x LM_SEQ tokens in TP_STEP_MICRO micros against make_train_step on the
# same card, same params and batches, under AdamW at a constant
# TP_STEP_LR (make_optimizer's warm-up has lr(0) = 0: step 1 would leave
# the params as they were), in bf16 on fp32 masters (the main path's
# dtype) and in fp32. Each step's gradient, leaf by leaf, the clip's
# global norm and the params' change over the steps are read through a
# seeded N(0, 1) probe of each whole leaf (tp_step_err). The row-parallel
# all-reduce adds the two ranks' partial outputs where one rank sums its
# segments in one ordered sum, so the next layer's psums differ by
# roundings, and a psum that close to 0 flips its relu gate, which moves
# that row's gradient by O(1): small leaves move most. The gates: bf16
# losses within TP_STEP_LOSS_RTOL relative (the FSDP step's bf16 bound;
# bf16's gradients are reported, as lm_parity's are: its roundings move
# small leaves by tens of percent); fp32 losses within LOSS0_RTOL, step
# 1's gradients and every step's clip norm within TP_STEP_GRAD_RTOL, and
# the later steps' gradients and the params' change within
# TP_STEP_DRIFT_RTOL (AdamW's first update is about lr x the sign of each
# gradient element, so an element that near 0 moves by 2 lr: the
# params, and the gradients at them, drift apart further). An H100 80GB
# at 700 W read 2.1e-3 for step 1's gradients, 1.5e-2 for step 2's and
# 2.6e-2 for the params' change. Two planted faults, each an fp32 step
# from the same params (`planted`), must fail the gradient gate: w_down's
# row-parallel all-reduce skipped, and the FFN's copy_to backward
# all-reduce skipped (the forward untouched); there they read 1.9 and
# 0.89, with loss errors of 2.0e-4 and 0: the loss gate alone passes both.
TP_STEP_MESH = (("data", "model"), (1, 2))
TP_STEP_XBAR, TP_STEP_LAYERS = 128, 2
TP_STEP_BATCH, TP_STEP_MICRO, TP_STEP_STEPS = 2, 2, 2
TP_STEP_DTYPES = ("bfloat16", "float32")
TP_STEP_LR = 1e-4
TP_STEP_LOSS_RTOL = 1e-3
TP_STEP_GRAD_RTOL, TP_STEP_DRIFT_RTOL = 1e-2, 0.1
TP_STEP_FAULTS = ("w_down", "copy_to")

# Slice 12, in the same two spawned ranks after the TP step:
# "sp_step", the TP step's runs under seq_sharding (sequence parallelism
# over "model": the residual stream each rank's 512-token block, each
# all-reduce of the TP regions a reduce-scatter and an all-gather), held
# to the same one-rank make_train_step at the same bounds, with its
# planted fault "norm" (the norms' gradients, each rank's of its block,
# left unsummed: their all-reduce over the rank alone); "rg_tp_step",
# recurrentgemma-9b at full width and one period of its pattern (rglru,
# rglru, local), CADC relu at crossbar LM_XBAR as its train phase runs
# it, fp32, RG_TP_STEPS steps of one micro of RG_TP_TOKENS, the RG-LRU
# channel-parallel (w_out row-parallel on 8 local segments a rank)
# against make_train_step on the card (run once the ranks have ended) at
# the same bounds, with its planted fault "channels" (lam and the conv's
# bias read at the other rank's channel block); and, on main()'s
# one-rank NCCL group, "sp_one_rank": the TP step's bf16 config at (1, 1)
# with and without seq_sharding, SP_ONE_RANK_STEPS steps, bitwise.
SP_STEP_FAULTS = ("norm",)
RG_TP_TOKENS, RG_TP_STEPS = (1, 1024), 2
RG_TP_FAULTS = ("channels",)
SP_ONE_RANK_STEPS = 2


def tp_step_cfg(dtype: str = "bfloat16", seq: bool = False):
    return lm_cfg(LM_ARCH, n_layers=TP_STEP_LAYERS).with_overrides(
        crossbar_size=TP_STEP_XBAR, dtype=dtype,
        bf16_wire=dtype == "bfloat16", seq_sharding=seq)


def rg_tp_cfg(dtype: str = "float32"):
    return lm_cfg(RG_ARCH, n_layers=REC_TRAIN[RG_ARCH]["layers"]
                  ).with_overrides(dtype=dtype,
                                   bf16_wire=dtype == "bfloat16")


# The TP step phases the spawned ranks run (tp_rank) and tp_step_check
# gates: each phase's config a dtype, its dtypes, planted faults (fp32),
# batch rows, micros and steps.
TP_PHASES = {
    "tp_step": dict(cfg=tp_step_cfg, dtypes=TP_STEP_DTYPES,
                    faults=TP_STEP_FAULTS, batch=TP_STEP_BATCH,
                    micro=TP_STEP_MICRO, steps=TP_STEP_STEPS,
                    label="TP step"),
    "sp_step": dict(cfg=lambda dt: tp_step_cfg(dt, seq=True),
                    dtypes=TP_STEP_DTYPES, faults=SP_STEP_FAULTS,
                    batch=TP_STEP_BATCH, micro=TP_STEP_MICRO,
                    steps=TP_STEP_STEPS, label="SP step"),
    "rg_tp_step": dict(cfg=rg_tp_cfg, dtypes=("float32",),
                       faults=RG_TP_FAULTS, batch=RG_TP_TOKENS[0], micro=1,
                       steps=RG_TP_STEPS, label="RG-LRU TP step"),
}


def planted(fault: str, cfg, solo):
    """A context in which this rank's TP step runs with a deliberate fault
    (a control the gates must catch), by a one-rank group `solo` in place
    of the "model" group at one collective: "w_down", w_down's
    row-parallel all-reduce (each rank keeps its partial output);
    "copy_to", the FFN's copy_to, whose backward all-reduce then leaves
    each rank its own input gradient; "norm" (under seq_sharding), the
    norms' gradient sums over "model" (each rank keeps its block of the
    sequence's). Or by a wrong read: "channels", the RG-LRU's lam and
    conv bias read at the next rank's channel block."""
    import contextlib

    from repro_torch.models.lm import ffn, rglru
    from repro_torch.models.lm import layers as ll
    from repro_torch.parallel import act_sharding, comm, tp_cadc

    @contextlib.contextmanager
    def ctx():
        saved = (tp_cadc.tp_cadc_row_linear, ffn.ll, comm.all_reduce,
                 rglru._channels)
        s_loc = cfg.d_ff // cfg.crossbar_size // TP_STEP_MESH[1][1]

        def row(x_loc, w_loc, **kw):
            if w_loc.shape[0] == s_loc:
                kw["group"] = solo
            return saved[0](x_loc, w_loc, **kw)

        def all_reduce(t, group=None, *args, **kw):
            # the step's gradient sums over a group: a norm's is 1-D
            if group is not None and t.ndim == 1 and t.numel() == cfg.d_model:
                group = solo
            return saved[2](t, group, *args, **kw)

        def channels(t):
            c = act_sharding.current()
            t_ = c.sizes["model"]
            return comm.block(t, t.ndim - 1, (c.rank + 1) % t_, t_)

        class FaultyLayers:   # layers, the FFN's copy_to over `solo`
            def __getattr__(self, name):
                return getattr(ll, name)

            @staticmethod
            def tp_in(x):
                return comm.copy_to(x, solo)

        if fault == "w_down":
            tp_cadc.tp_cadc_row_linear = row
        elif fault == "copy_to":
            ffn.ll = FaultyLayers()
        elif fault == "norm":
            comm.all_reduce = all_reduce
        else:
            rglru._channels = channels
        try:
            yield
        finally:
            (tp_cadc.tp_cadc_row_linear, ffn.ll, comm.all_reduce,
             rglru._channels) = saved

    return ctx()


def tp_step_run(dev, cfg, mesh=None, faults=(), batch=TP_STEP_BATCH,
                n_micro=TP_STEP_MICRO, n_steps=TP_STEP_STEPS) -> dict:
    """`n_steps` steps of `cfg` from seed-0 params on seeded batches of
    `batch` x LM_SEQ tokens in `n_micro` micros (the same on every rank):
    make_fsdp_train_step over `mesh` (this process a rank of the default
    group), or make_train_step with none. Returns the losses, the launch
    counts, the steps' wall seconds
    (the probes' time taken out) and the seconds before them (params,
    step, batches); "grads": each step's gradient as the optimizer gets it
    (this rank's blocks), a (sum of squares, probe dot) pair a leaf and
    the clip's squared global norm; "update": the same pairs of the
    params' change over the steps; "split": whether each leaf is split
    over "model"; "controls": a step from the same params under each of
    `faults` (its loss and gradient pairs; over a mesh only)."""
    import torch.distributed as dist

    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf
    from repro_torch.parallel import fsdp
    from repro_torch.train import optimizer as opt_lib

    t_setup = time.perf_counter()
    params = tf.init(cfg, seed=0, device=dev)
    shapes = [tuple(t.shape) for t in steps_lib._leaves(params)]
    if mesh is None:
        split = [False] * len(shapes)

        def cut(j, t):
            return t
    else:
        dims = fsdp.data_dims(params, cfg, mesh)
        mdims = fsdp.model_dims(params, cfg, mesh)
        split = [md is not None for md in mdims]
        coords, sizes = {}, {}

        def cut(j, t):
            return fsdp.mesh_block(t, dims[j], mdims[j], coords, sizes)

    def probes(leaves):
        """(sum of squares, dot with the seeded probe of the whole leaf,
        cut as this rank's block) a leaf, in fp64 (2^24 elements at a
        time: a full-width table's block is half a billion)."""
        gen = torch.Generator(device=dev)
        out = []
        for j, t in enumerate(leaves):
            gen.manual_seed(j)
            pr = cut(j, torch.randn(shapes[j], generator=gen, device=dev))
            ss = dot = 0.0
            for a, b in zip(t.flatten().split(1 << 24),
                            pr.flatten().split(1 << 24)):
                a = a.double()
                ss += float(a.square().sum())
                dot += float(a.dot(b.double()))
            out.append((ss, dot))
            del pr
        return out

    base = opt_lib.adamw(TP_STEP_LR, weight_decay=0.1, max_grad_norm=1.0)
    records, probe_s = [], [0.0]

    def update(grads, state, prm, step, *, sq_norm=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        records.append((probes(steps_lib._leaves(grads)),
                        None if sq_norm is None else float(sq_norm)))
        probe_s[0] += time.perf_counter() - t
        return base.update(grads, state, prm, step, sq_norm=sq_norm)

    opt = opt_lib.Optimizer(base.init, update)
    if mesh is None:
        step = steps_lib.make_train_step(cfg, opt, n_micro=n_micro)
    else:
        step = steps_lib.make_fsdp_train_step(cfg, mesh, dims, optimizer=opt,
                                              n_micro=n_micro)
        coords.update(step.mesh_groups.coords)
        sizes.update(step.mesh_groups.sizes)
        params = steps_lib._rebuild(params, [
            cut(j, t) for j, t in enumerate(steps_lib._leaves(params))])
    # the initial blocks wait on the host: two ranks' steps share the card
    init = [t.cpu() for t in steps_lib._leaves(params)]
    state = opt.init(params)
    gen = torch.Generator().manual_seed(23)
    batches = []
    for _ in range(n_steps):
        toks = torch.randint(0, cfg.vocab_size,
                             (batch, LM_SEQ + 1), generator=gen)
        batches.append({"tokens": toks[:, :-1].to(dev),
                        "labels": toks[:, 1:].to(dev)})
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state, b, i)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "launches": read_counts(),
           "s": time.perf_counter() - t0 - probe_s[0],
           "setup_s": t0 - t_setup, "grads": list(records),
           "update": probes(a - b.to(dev) for a, b in zip(
               steps_lib._leaves(params), init)), "split": split,
           "controls": {}}
    tree = tf.tree_map(lambda t: None, params)
    del params, state
    torch.cuda.empty_cache()
    if mesh is not None and faults:
        # every rank makes every one-rank group, in the same order
        solo = [dist.new_group([r]) for r in range(dist.get_world_size())]
        for fault in faults:
            del records[:]
            p0 = steps_lib._rebuild(tree, [t.to(dev) for t in init])
            with planted(fault, cfg, solo[dist.get_rank()]):
                _, _, m = step(p0, opt.init(p0), batches[0], 0)
            out["controls"][fault] = {"loss": float(m["loss"]),
                                      "grads": records[0]}
            del p0, m
            torch.cuda.empty_cache()
    return out


def tp_inputs(name: str, m: int, dev):
    """The case's x [m, D] and w [D, N] (fp32, seeded by the case, the
    same on every rank)."""
    i = [c[0] for c in TP_CASES].index(name)
    _, d, n, _ = TP_CASES[i]
    gen = torch.Generator().manual_seed(1000 * i + m)
    x = torch.randn(m, d, generator=gen)
    w = torch.randn(d, n, generator=gen) / math.sqrt(d)
    return x.to(dev), w.to(dev)


def rg_gather_bytes(dev, mesh) -> dict:
    """The bytes a rank's step all-gathers over "model" a micro for
    rg_tp_cfg's RG-LRU leaves (comm.record over steps._gather_leaves on
    this rank's blocks of them): "before", under the plan before the
    channel-parallel form (every RG-LRU leaf read whole), and "after",
    under transformer.tp_leaf_modes."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf
    from repro_torch.parallel import comm, fsdp

    cfg = rg_tp_cfg()
    shape = steps_lib.abstract_params(cfg)
    dims = fsdp.data_dims(shape, cfg, mesh)
    _, _, mdims, modes = steps_lib._mesh_plan(cfg, mesh, dims,
                                              tf.tp_leaf_modes)
    mg = mesh_lib.process_groups(mesh)
    pick = [j for j, (names, _) in enumerate(tf._leaf_paths(shape))
            if names[0] == "layers" and names[2] == "rec"]
    leaves = steps_lib._leaves(shape)
    blocks = [torch.zeros(fsdp.mesh_block(leaves[j], dims[j], mdims[j],
                                          mg.coords, mg.sizes).shape,
                          device=dev) for j in pick]
    out = {}
    for key, plan in (("before", [("full", None)] * len(pick)),
                      ("after", [modes[j] for j in pick])):
        with comm.record() as tally:
            steps_lib._gather_leaves(blocks, cfg, [dims[j] for j in pick],
                                     [mdims[j] for j in pick], plan, mg)
        out[key] = tally["all-gather"]
    return out


def tp_rank(rank: int, store: str, out) -> None:
    """One rank of the 2-rank TP run (a spawned process on the same card,
    gloo over CUDA tensors): every case at fp32 and bf16 wire, K1 counted
    a call; then the TP_PHASES train steps (tp_step_run over
    TP_STEP_MESH, the planted faults in fp32: the TP step, the SP step),
    the mesh serve steps (tp_serve_run), the RG-LRU TP step and its
    leaves' gathered bytes (rg_gather_bytes); puts (rank, results) or
    (rank, the traceback) on `out`."""
    import traceback

    try:
        # two ranks' full-width steps share the card: fewer stranded blocks
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        sys.path.insert(0, os.path.join(REPO, "src"))
        import torch.distributed as dist

        from repro_torch.kernels import cadc_matmul as cm
        from repro_torch.parallel import tp_cadc

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", store=dist.FileStore(store, TP_RANKS),
                                rank=rank, world_size=TP_RANKS)
        res = {}
        for name, _, _, xbar in TP_CASES:
            for m in TP_M:
                x, w = tp_inputs(name, m, dev)
                w_seg = tp_cadc.segment_weights(w, xbar)
                for wire in (None, torch.bfloat16):
                    before = cm.cadc_matmul_cuda.launches
                    y = tp_cadc.tp_cadc_linear(x, w_seg, wire_dtype=wire)
                    torch.cuda.synchronize()
                    res[name, m, str(wire)] = (
                        y.cpu().numpy(), cm.cadc_matmul_cuda.launches - before,
                        str(y.device))
        from repro_torch.launch import mesh as mesh_lib

        mesh = mesh_lib.Mesh(*TP_STEP_MESH)

        def phase(key):
            ph = TP_PHASES[key]
            t0 = time.perf_counter()
            res[key] = {dt: tp_step_run(
                dev, ph["cfg"](dt), mesh,
                ph["faults"] if dt == "float32" else (), ph["batch"],
                ph["micro"], ph["steps"]) for dt in ph["dtypes"]}
            res[key]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()

        phase("tp_step")
        phase("sp_step")
        res["tp_serve"] = tp_serve_run(dev, mesh)
        torch.cuda.empty_cache()
        phase("rg_tp_step")
        res["rg_gather"] = rg_gather_bytes(dev, mesh)
        dist.destroy_process_group()
        out.put((rank, res))
    except BaseException:
        out.put((rank, traceback.format_exc()))


def tp_cadc_path(dev, report) -> dict:
    """parallel/tp_cadc.py on the card: (1) at one rank on main()'s NCCL
    group, fp32 wire, each case bitwise the unsharded K1 (ops.cadc_matmul
    on the whole weight), one K1 launch a call; (2) TP_RANKS ranks on the
    one card over gloo (gloo's all_reduce takes the CUDA tensors; NCCL
    refuses two ranks on one device), spawned here: each rank one K1
    launch a call over its segments, y at fp32 wire within TP_RTOL of
    scale and at bf16 wire within TP_BF16_REL relative of the unsharded
    K1, both ranks bitwise equal; then, in the same ranks, the TP train
    step (tp_step_run over TP_STEP_MESH) against the one-rank step run
    here while they start (tp_step_check), the SP step against the same,
    the mesh serve steps (tp_serve_run, tp_serve_check) and the RG-LRU TP
    step against the one-rank step run here after they end. Returns
    the TP linear's launch counts, each TP_PHASES phase's launches a rank
    ({phase: {kernel: count}}) and the serve steps' K1 a rank."""
    import multiprocessing as mp
    import queue
    import shutil

    from repro_torch.kernels import cadc_matmul as cm
    from repro_torch.kernels import ops
    from repro_torch.parallel import tp_cadc

    t0 = time.perf_counter()
    launches = {"one_rank": 0, "two_ranks": 0}
    want = {}
    for name, _, _, xbar in TP_CASES:
        for m in TP_M:
            x, w = tp_inputs(name, m, dev)
            before = cm.cadc_matmul_cuda.launches
            y = tp_cadc.tp_cadc_linear(x, tp_cadc.segment_weights(w, xbar),
                                       wire_dtype=None)
            launches["one_rank"] += cm.cadc_matmul_cuda.launches - before
            want[name, m] = keep_counts(lambda: ops.cadc_matmul(
                x, w, crossbar_size=xbar, fn="relu"))
            if not torch.equal(y, want[name, m]):
                fail(f"tp_cadc {name} M={m} at one rank (NCCL): not bitwise "
                     "the unsharded K1")
    if launches["one_rank"] != len(TP_CASES) * len(TP_M):
        fail(f"tp_cadc at one rank launched K1 {launches['one_rank']} times")
    one_rank_s = time.perf_counter() - t0

    d = os.path.join(REPO, "build", "tp_cadc")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=tp_rank, args=(r, os.path.join(d, "store"),
                                               out), daemon=True)
             for r in range(TP_RANKS)]
    t1 = time.perf_counter()
    for p in procs:
        p.start()
    # the one-rank step on this process while the ranks start (the SP
    # step's reference too: make_train_step ignores seq_sharding)
    ref = keep_counts(lambda: {dt: tp_step_run(dev, tp_step_cfg(dt))
                               for dt in TP_STEP_DTYPES})
    torch.cuda.empty_cache()
    got = {}
    try:
        while len(got) < TP_RANKS:
            try:
                rank, res = out.get(timeout=240)
            except queue.Empty:
                fail(f"tp_cadc: {TP_RANKS - len(got)} ranks gave no result "
                     "in 240 s")
            if isinstance(res, str):
                fail(f"tp_cadc rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(d, ignore_errors=True)
    two_ranks_s = time.perf_counter() - t1
    # the RG-LRU step's one-rank reference once the ranks have left the
    # card (the three would not fit on it together)
    ph = TP_PHASES["rg_tp_step"]
    rg_ref = keep_counts(lambda: {dt: tp_step_run(
        dev, ph["cfg"](dt), batch=ph["batch"], n_micro=ph["micro"],
        n_steps=ph["steps"]) for dt in ph["dtypes"]})
    torch.cuda.empty_cache()
    refs = {"tp_step": ref, "sp_step": ref, "rg_tp_step": rg_ref}
    step_launches = {key: tp_step_check(got, refs[key], report, key)
                     for key in TP_PHASES}
    gathered = [got[r]["rg_gather"] for r in range(TP_RANKS)]
    report["rg_tp_step"]["rglru_model_gather_bytes_per_rank_step"] = \
        gathered
    if not all(g["after"] == 0 < g["before"] for g in gathered):
        fail(f"RG-LRU TP step: the RG-LRU leaves' all-gathers over "
             f"'model' a step {gathered}: want none after, some before")
    print(f"RG-LRU leaves all-gathered over 'model' a step a rank "
          f"(comm.record): before the channel-parallel form "
          f"{gathered[0]['before'] / 2 ** 20:.1f} MiB, now "
          f"{gathered[0]['after'] / 2 ** 20:.1f} MiB", flush=True)
    serve_k1 = tp_serve_check(got, report)
    worst = {"fp32": 0.0, "bf16": 0.0}
    for key, res in got[0].items():
        if key in ("tp_serve", "rg_gather") or key in TP_PHASES:
            continue
        y0, n0, place = res
        name, m, wire = key
        y1, n1, _ = got[1][key]
        if n0 != 1 or n1 != 1 or place != "cuda:0":
            fail(f"tp_cadc {key}: K1 launches {n0} / {n1} on {place}")
        if not np.array_equal(y0, y1):
            fail(f"tp_cadc {key}: the ranks' outputs differ")
        launches["two_ranks"] += n0 + n1
        ref = want[name, m].cpu().numpy()
        if wire == "None":
            err = float(np.abs(y0 - ref).max()) / max(
                1.0, float(np.abs(ref).max()))
            worst["fp32"] = max(worst["fp32"], err)
            if not err <= TP_RTOL:
                fail(f"tp_cadc {key}: fp32 wire err / scale {err}")
        else:
            rel = float(np.linalg.norm(y0 - ref) / np.linalg.norm(ref))
            worst["bf16"] = max(worst["bf16"], rel)
            if not 0 < rel < TP_BF16_REL:
                fail(f"tp_cadc {key}: bf16 wire relative error {rel}")
    report["tp_cadc"] = {
        "cases": TP_CASES, "m": list(TP_M), "ranks": TP_RANKS,
        "tp_step_launches_per_rank": step_launches,
        "launches": launches, "fp32_wire_err_over_scale": worst["fp32"],
        "bf16_wire_rel_err": worst["bf16"], "one_rank_s": one_rank_s,
        "two_ranks_s": two_ranks_s}
    print(f"tp_cadc: {len(TP_CASES)} gemma3-1b linears x M {list(TP_M)}: "
          f"one rank (NCCL) bitwise the unsharded K1; {TP_RANKS} ranks on "
          f"the card over gloo, K1 once a rank a call, fp32 wire err / scale "
          f"{worst['fp32']:.2e}, bf16 wire relative err {worst['bf16']:.2e}; "
          f"launches {json.dumps(launches)}; {one_rank_s:.1f} s + "
          f"{two_ranks_s:.1f} s", flush=True)
    return launches, step_launches, serve_k1


def sp_one_rank(dev, report) -> dict:
    """The SP step at (data 1, model 1) on main()'s one-rank NCCL group:
    tp_step_cfg's bf16 config, SP_ONE_RANK_STEPS steps of TP_STEP_BATCH x
    LM_SEQ tokens in TP_STEP_MICRO micros, from the same params and
    batches with and without seq_sharding (its all-gathers and
    reduce-scatters then run over the one rank: NCCL copies). The losses
    and the params must be bitwise, and K1g / K2 exact both ways.
    Returns the SP run's launches."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf
    from repro_torch.parallel import fsdp
    from repro_torch.train import optimizer as opt_lib

    mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    gen = torch.Generator().manual_seed(29)
    batches = []
    for _ in range(SP_ONE_RANK_STEPS):
        toks = torch.randint(0, tp_step_cfg().vocab_size,
                             (TP_STEP_BATCH, LM_SEQ + 1), generator=gen)
        batches.append({"tokens": toks[:, :-1].to(dev),
                        "labels": toks[:, 1:].to(dev)})
    runs = {}
    for seq in (False, True):
        cfg = tp_step_cfg("bfloat16", seq=seq)
        params = tf.init(cfg, seed=0, device=dev)
        opt = opt_lib.adamw(TP_STEP_LR, weight_decay=0.1, max_grad_norm=1.0)
        step = steps_lib.make_fsdp_train_step(
            cfg, mesh, fsdp.data_dims(params, cfg, mesh), optimizer=opt,
            n_micro=TP_STEP_MICRO)
        state = opt.init(params)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        losses = []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b, i)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs[seq] = (losses, steps_lib._leaves(params), read_counts(),
                     time.perf_counter() - t0)
        del state
    want = {k: 0 for k in counters()}
    want.update({k: v * SP_ONE_RANK_STEPS for k, v in
                 lm_step_launches(tp_step_cfg(), TP_STEP_MICRO).items()})
    (losses, params, n, s_tp), (sp_losses, sp_params, sp_n, s_sp) = \
        runs[False], runs[True]
    same = sp_losses == losses and all(
        torch.equal(a, b) for a, b in zip(sp_params, params))
    report["sp_one_rank"] = {
        "mesh": {"data": 1, "model": 1}, "backend": "nccl",
        "steps": SP_ONE_RANK_STEPS, "losses": sp_losses, "bitwise": same,
        "launches": sp_n, "wall_s": {"tp": s_tp, "sp": s_sp}}
    print(f"SP step at (1, 1) on NCCL ({tp_step_cfg().name}, "
          f"{TP_STEP_LAYERS} layers, bf16): {SP_ONE_RANK_STEPS} steps, "
          f"losses {sp_losses} bitwise the step without seq_sharding: "
          f"{same}; launches {json.dumps({k: v for k, v in sp_n.items() if v})};"
          f" wall {s_sp:.2f} s vs {s_tp:.2f} s", flush=True)
    if not same:
        fail(f"SP step at (1, 1): losses {sp_losses} vs {losses}, or the "
             "params, not bitwise the step without seq_sharding")
    if n != want or sp_n != want:
        fail(f"SP step at (1, 1) launched {sp_n} (without SP {n}), want "
             f"{want}")
    return sp_n


def tp_step_err(ranks, ref) -> float:
    """The largest relative error of the ranks' (sum of squares, probe
    dot) pairs against the one-rank pairs `ref`, over the leaves: a leaf
    split over "model" summed over the ranks' blocks, a replicated one
    rank 0's; its error the larger of the probe dot's and the norm's
    distance over the one-rank leaf's norm (each about or below the
    relative L2 distance of the two leaves)."""
    worst = 0.0
    for j, (ss, dot) in enumerate(ref):
        parts = [r["pairs"][j] for r in ranks] if ranks[0]["split"][j] \
            else [ranks[0]["pairs"][j]]
        gs, gd = (sum(p[k] for p in parts) for k in (0, 1))
        n = math.sqrt(ss)
        err = (max(abs(gd - dot), abs(math.sqrt(gs) - n)) / n if n
               else (0.0 if gs == 0 else math.inf))
        worst = max(worst, err)
    return worst


def tp_step_check(got, ref, report, key: str = "tp_step") -> dict:
    """A TP_PHASES phase's gates over the ranks' results, for each dtype:
    exact K1g / K2 launches a rank (lm_step_launches a step), nothing else
    launched, the ranks' losses equal; the losses within
    TP_STEP_LOSS_RTOL (bf16) or LOSS0_RTOL (fp32) relative of the one-rank
    step's (`ref`); in fp32 step 1's gradients and the clip norms within
    TP_STEP_GRAD_RTOL of the one-rank step's, the later gradients and the
    params' change within TP_STEP_DRIFT_RTOL (tp_step_err), and each
    planted fault beyond TP_STEP_GRAD_RTOL. Returns the launches a rank,
    summed over the dtypes."""
    ph = TP_PHASES[key]
    label, n_steps = ph["label"], ph["steps"]
    total = {}
    out = report[key] = {"mesh": dict(zip(*TP_STEP_MESH)),
                         "backend": "gloo", "lr": TP_STEP_LR,
                         "phase_s_per_rank": [got[r][key]["phase_s"]
                                              for r in range(TP_RANKS)]}
    for dt in ph["dtypes"]:
        cfg = ph["cfg"](dt)
        per_step = lm_step_launches(cfg, ph["micro"])
        want = {k: 0 for k in counters()}
        want.update({k: v * n_steps for k, v in per_step.items()})
        runs, one = [got[r][key][dt] for r in range(TP_RANKS)], ref[dt]
        for r, run in enumerate(runs):
            if run["launches"] != want:
                fail(f"{label} {dt} rank {r} launched {run['launches']}, "
                     f"want {want}")
            if run["losses"] != runs[0]["losses"]:
                fail(f"{label} {dt}: rank {r}'s losses {run['losses']} "
                     f"differ from rank 0's {runs[0]['losses']}")
        if one["launches"] != want:
            fail(f"one-rank step {dt} launched {one['launches']}, want "
                 f"{want}")
        for k, v in runs[0]["launches"].items():
            total[k] = total.get(k, 0) + v

        def ranks(pairs):
            return [{"pairs": pairs(run), "split": run["split"]}
                    for run in runs]

        errs = [abs(a - b) / abs(b) for a, b in zip(runs[0]["losses"],
                                                    one["losses"])]
        grad_errs = [tp_step_err(ranks(lambda run: run["grads"][i][0]),
                                 one["grads"][i][0])
                     for i in range(n_steps)]
        # the clip's global norm: every rank's the same, each block once
        clip_errs = []
        for i in range(n_steps):
            n = math.sqrt(sum(ss for ss, _ in one["grads"][i][0]))
            clip_errs.append(max(abs(math.sqrt(run["grads"][i][1]) - n)
                                 for run in runs) / n)
        update_err = tp_step_err(ranks(lambda run: run["update"]),
                                 one["update"])
        controls = {
            fault: {"loss_rel_err": abs(runs[0]["controls"][fault]["loss"]
                                        - one["losses"][0])
                    / abs(one["losses"][0]),
                    "grad_rel_err": tp_step_err(
                        ranks(lambda run: run["controls"][fault]["grads"][0]),
                        one["grads"][0][0])}
            for fault in runs[0]["controls"]}
        worst = (max(grad_errs[:1] + clip_errs),
                 max(grad_errs[1:] + [update_err]))
        loss_tol = TP_STEP_LOSS_RTOL if dt == "bfloat16" else LOSS0_RTOL
        out[dt] = {
            "arch": cfg.name, "layers": cfg.n_layers,
            "crossbar": cfg.crossbar_size, "batch": ph["batch"],
            "seq": LM_SEQ, "micro": ph["micro"], "steps": n_steps,
            "seq_sharding": cfg.seq_sharding,
            "losses": runs[0]["losses"], "one_rank_losses": one["losses"],
            "loss_rel_err": errs, "grad_rel_err": grad_errs,
            "clip_norm_rel_err": clip_errs, "update_rel_err": update_err,
            "controls": controls, "launches_per_rank": runs[0]["launches"],
            "wall_s_per_rank": [run["s"] for run in runs],
            "setup_s_per_rank": [run["setup_s"] for run in runs],
            "one_rank_s": one["s"]}
        print(f"{label} {dt} ({cfg.name}, {cfg.n_layers} layers, CADC relu "
              f"xbar {cfg.crossbar_size}, mesh {out['mesh']} over gloo on "
              f"the one card, AdamW at lr {TP_STEP_LR}"
              + (", seq_sharding" if cfg.seq_sharding else "")
              + f"): {n_steps} steps of {ph['batch']} x {LM_SEQ} tokens in "
              f"{ph['micro']} micros, losses "
              f"{[round(v, 5) for v in runs[0]['losses']]} vs one rank "
              f"{[round(v, 5) for v in one['losses']]} (rel err "
              f"{max(errs):.2e}, tol {loss_tol}); gradients rel err "
              f"{[f'{e:.2e}' for e in grad_errs]}, clip norm "
              f"{max(clip_errs):.2e}, params' change {update_err:.2e}"
              + (f" (tol {TP_STEP_GRAD_RTOL} step 1 and clip, "
                 f"{TP_STEP_DRIFT_RTOL} after)" if dt == "float32"
                 else " (reported)")
              + "".join(f"; planted fault {k}: loss {v['loss_rel_err']:.2e},"
                        f" gradients {v['grad_rel_err']:.2e}"
                        for k, v in controls.items())
              + f"; launches a rank "
              f"{json.dumps({k: v for k, v in want.items() if v})}; phase "
              f"{max(out['phase_s_per_rank']):.1f} s; wall "
              f"{[round(run['s'], 1) for run in runs]} s a rank (gloo "
              f"through the host, not a TP cost), one rank {one['s']:.1f} s",
              flush=True)
        if not (all(map(math.isfinite, runs[0]["losses"]))
                and max(errs) <= loss_tol):
            fail(f"{label} {dt} losses {runs[0]['losses']} vs the one-rank "
                 f"step's {one['losses']} (rel err {errs} > {loss_tol})")
        if dt == "bfloat16":
            continue
        if not (worst[0] <= TP_STEP_GRAD_RTOL
                and worst[1] <= TP_STEP_DRIFT_RTOL):
            fail(f"{label} {dt}: step 1's gradients / the clip norms rel err "
                 f"{worst[0]} (tol {TP_STEP_GRAD_RTOL}), later gradients / "
                 f"the params' change {worst[1]} (tol {TP_STEP_DRIFT_RTOL})")
        if set(controls) != set(ph["faults"]):
            fail(f"{label} {dt}: planted faults run {sorted(controls)}")
        for fault, c in controls.items():
            if not c["grad_rel_err"] > TP_STEP_GRAD_RTOL:
                fail(f"{label}: the planted fault {fault!r} passes the "
                     f"gradient gate ({c['grad_rel_err']} <= "
                     f"{TP_STEP_GRAD_RTOL})")
    return total


# ---------------------------------------------------------------------------
# slice 11: the serving steps over the mesh
# ---------------------------------------------------------------------------

# launch/steps.py make_mesh_prefill_step / make_mesh_serve_step. At (data
# 1, model 1), on main()'s one-rank NCCL group: gemma3-1b at full width
# (26 layers, bf16 compute on fp32 masters, CADC relu at crossbar 256), one
# mesh prefill of N_SLOTS prompts of PROMPT_LEN tokens (right-padded to the
# longest) and MESH_SERVE_STEPS decode steps from the dense caches (rings
# of MAX_LEN) the one-device batched prefill filled, fed the one-device
# steps' tokens: bitwise make_prefill_step / make_serve_step, K1 exact
# (k1_per_pass a pass). In phase 32's two spawned ranks over gloo at
# (data 1, model 2) (TP_SERVE): gemma3-1b at 6 layers (one 5:1 period:
# its 1 kv head does not divide 2, its rings of MAX_LEN do, so both ring
# kinds are length-parallel) and phi4-mini-3.8b at 2 (8 kv heads:
# head-parallel), in fp32 (TF32 off: prefill and every step's logits
# within LOGITS_RTOL of the one-device steps on the card) and bf16
# (reported), TP_SERVE_STEPS steps, K1 a rank exact; the planted fault
# (attention._merge_partials replaced by the rank's own partial: each
# rank attends its half of the ring only) must fail the fp32 gate.
MESH_SERVE_STEPS = 16
TP_SERVE = {LM_ARCH: 6, "phi4_mini_38b": 2}
TP_SERVE_STEPS = 8
TP_SERVE_DTYPES = ("float32", "bfloat16")


def serve_cfg(arch: str, layers=None, dtype: str = "bfloat16"):
    """lm_cfg at `layers` (default: all) in `dtype` (bf16_wire with bf16)."""
    kw = {"n_layers": layers} if layers else {}
    return lm_cfg(arch, **kw).with_overrides(
        dtype=dtype, bf16_wire=dtype == "bfloat16")


def serve_prompts(cfg):
    """N_SLOTS seeded prompts of PROMPT_LEN tokens, right-padded with 0 to
    the longest: (tokens [N_SLOTS, PROMPT_LEN[1]], lengths)."""
    rng = np.random.RandomState(31)
    lengths = rng.randint(PROMPT_LEN[0], PROMPT_LEN[1] + 1, N_SLOTS)
    tokens = np.zeros((N_SLOTS, PROMPT_LEN[1]), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(0, cfg.vocab_size, n)
    return tokens, lengths


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def one_device_serve(cfg, params, dev, n_steps: int) -> dict:
    """make_prefill_step's logits on serve_prompts; the dense caches the
    batched prefill fills (as the dense backend writes them; its launches
    left out of the counts); n_steps make_serve_step steps from them, each
    fed the last step's tokens. Returns the prefill logits, the caches
    after the prefill ("start"), the fed tokens, each step's logits and
    tokens, the caches after the steps, ms a step and the launches."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import transformer as tf
    from repro_torch.serve.backends import DenseBackend

    tokens, lengths = serve_prompts(cfg)
    tok = torch.as_tensor(tokens, device=dev)
    zero_counts()
    pre = steps_lib.make_prefill_step(cfg)(params, {"tokens": tok})
    cast = steps_lib.cast_compute(params, cfg)
    backend = DenseBackend(cfg, N_SLOTS, MAX_LEN, dev)
    caches = backend.init_caches()

    def fill():
        nxt, _, contribs = steps_lib.make_batched_prefill_step(cfg)(
            cast, {"tokens": tok}, torch.as_tensor(lengths, device=dev))
        backend.write_prefill(caches, contribs, np.arange(N_SLOTS), lengths,
                              None)
        return nxt

    nxt = keep_counts(fill)
    start = tf.copy_caches(caches)
    serve = steps_lib.make_serve_step(cfg)
    pos = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    out = {"prefill": pre, "start": start, "fed": [], "logits": [],
           "tokens": [], "ms": []}
    for i in range(n_steps):
        out["fed"].append(nxt)
        (nxt, lg), ms = _timed(lambda: serve(cast, nxt, pos + i, caches))
        out["logits"].append(lg)
        out["tokens"].append(nxt)
        out["ms"].append(ms)
    out["caches"], out["launches"] = caches, read_counts()
    return out


def mesh_serve(cfg, params, dev, mesh, ref, fault: bool = False) -> dict:
    """The mesh prefill and serve steps over `mesh` (this process a rank of
    the default group) on this rank's parameter blocks and its blocks of
    ref["start"] (steps.cache_blocks), fed ref["fed"]: the prefill
    logits, each step's logits and tokens, the cache blocks after the
    steps, ms a step, the attention forms and this rank's launches.
    fault: with the planted merge fault."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.lm import attention
    from repro_torch.models.lm import transformer as tf
    from repro_torch.parallel import fsdp

    dims = fsdp.data_dims(params, cfg, mesh)
    mdims = fsdp.model_dims(params, cfg, mesh)
    prefill = steps_lib.make_mesh_prefill_step(cfg, mesh, dims)
    serve = steps_lib.make_mesh_serve_step(cfg, mesh, dims, MAX_LEN)
    mg = serve.mesh_groups
    shards = steps_lib._rebuild(params, [
        fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
        for t, d, md in zip(steps_lib._leaves(params), dims, mdims)])
    blocks = steps_lib.cache_blocks(tf.copy_caches(ref["start"]), cfg, mesh,
                                    N_SLOTS, mg.coords)
    tokens, lengths = serve_prompts(cfg)
    pos = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    saved = attention._merge_partials
    if fault:
        attention._merge_partials = lambda out, top, total, group: out
    try:
        zero_counts()
        pre = prefill(shards, {"tokens": torch.as_tensor(tokens, device=dev)})
        out = {"prefill": pre, "logits": [], "tokens": [], "ms": []}
        for i, fed in enumerate(ref["fed"]):
            (nxt, lg), ms = _timed(lambda: serve(shards, fed, pos + i,
                                                 blocks))
            out["logits"].append(lg)
            out["tokens"].append(nxt)
            out["ms"].append(ms)
        out["launches"] = read_counts()
    finally:
        attention._merge_partials = saved
    out["caches"], out["forms"] = blocks, serve.attention_forms
    return out


def serve_launches(cfg, n_steps: int) -> dict:
    """K1 launches of a prefill step over PROMPT_LEN[1] positions and
    n_steps decode steps (one device, or a rank of the mesh steps: each
    CADC linear is one launch a rank, split or whole); nothing else."""
    want = {k: 0 for k in counters()}
    want["cadc_matmul"] = (k1_per_pass(cfg, prefill=True,
                                       tokens=PROMPT_LEN[1])
                           + n_steps * k1_per_pass(cfg))
    return want


def logits_err(got, ref) -> float:
    """The largest max |got - want| over max(1, max |want|) over the
    prefill's and every step's logits."""
    pairs = [(got["prefill"], ref["prefill"])] + list(zip(got["logits"],
                                                          ref["logits"]))
    return max((g.float() - w.float()).abs().max().item()
               / max(1.0, w.float().abs().max().item()) for g, w in pairs)


def mesh_serve_path(dev, report) -> dict:
    """Slice 11 at (data 1, model 1) on main()'s one-rank NCCL group (see
    MESH_SERVE_STEPS): the mesh steps bitwise the one-device steps, K1
    exact on both. Returns the mesh steps' launches."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import transformer as tf

    t0 = time.perf_counter()
    cfg = serve_cfg(LM_ARCH)
    params = tf.init(cfg, seed=0, device=dev)      # fp32 masters
    ref = one_device_serve(cfg, params, dev, MESH_SERVE_STEPS)
    got = mesh_serve(cfg, params, dev, mesh_lib.Mesh(("data", "model"),
                                                     (1, 1)), ref)
    want = serve_launches(cfg, MESH_SERVE_STEPS)
    for name, run in (("one-device", ref), ("mesh (1, 1)", got)):
        if run["launches"] != want:
            fail(f"mesh serve: the {name} steps launched {run['launches']}, "
                 f"want {want}")
    same = (torch.equal(got["prefill"], ref["prefill"])
            and all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                      ref["logits"]))
            and all(torch.equal(a, b) for a, b in zip(got["tokens"],
                                                      ref["tokens"]))
            and all(torch.equal(x, y) for a, b in zip(got["caches"],
                                                      ref["caches"])
                    for x, y in zip(a, b)))
    if not same:
        fail(f"mesh serve at (1, 1): not bitwise the one-device steps "
             f"(logits err / scale {logits_err(got, ref)})")
    p50 = {k: float(np.median(r["ms"][1:])) for k, r in (("one_device", ref),
                                                         ("mesh", got))}
    report["mesh_serve"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "slots": N_SLOTS,
        "prompt": PROMPT_LEN[1], "steps": MESH_SERVE_STEPS,
        "mesh": {"data": 1, "model": 1}, "backend": "nccl",
        "bitwise": True, "launches": got["launches"]["cadc_matmul"],
        "forms": got["forms"], "step_ms_p50": p50,
        "s": time.perf_counter() - t0}
    print(f"mesh serve ({cfg.name}, {cfg.n_layers} layers, bf16 on fp32 "
          f"masters, mesh (data 1, model 1) on NCCL): prefill of "
          f"{N_SLOTS} x {PROMPT_LEN[1]} and {MESH_SERVE_STEPS} decode steps "
          f"bitwise make_prefill_step / make_serve_step; K1 "
          f"{want['cadc_matmul']} each; decode step ms p50 mesh "
          f"{p50['mesh']:.2f} vs one device {p50['one_device']:.2f}; "
          f"{report['mesh_serve']['s']:.1f} s", flush=True)
    del params, ref, got
    torch.cuda.empty_cache()
    return want["cadc_matmul"]


def quickstart_twin(dev, report) -> None:
    """repro_torch.launch.quickstart on the card: K1 once, within its
    bound of the sequential oracle."""
    import contextlib
    import io

    from repro_torch.launch import quickstart

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = keep_counts(lambda: quickstart.main(["--device", str(dev)]))
    if out["launches"] != 1 or not out["kernel_err"] < quickstart.KERNEL_TOL:
        fail(f"quickstart twin: K1 launched {out['launches']} times, err "
             f"{out['kernel_err']}")
    report["quickstart"] = out
    print(f"quickstart twin: K1 once, max |err| vs the oracle "
          f"{out['kernel_err']:.2e} (tol {quickstart.KERNEL_TOL}); relu "
          f"psum sparsity {out['sparsity']:.1%}", flush=True)


def tp_serve_run(dev, mesh) -> dict:
    """One rank of slice 11's 2-rank phase (see TP_SERVE): for each config
    and dtype, the one-device steps on this rank, then the mesh steps
    (and, for a length-parallel config in fp32, the planted fault), held
    here against the one-device steps: small results only."""
    from repro_torch.models.lm import transformer as tf

    out = {}
    for arch, layers in TP_SERVE.items():
        for dt in TP_SERVE_DTYPES:
            cfg = serve_cfg(arch, layers, dt)
            params = tf.init(cfg, seed=0, device=dev)
            ref = one_device_serve(cfg, params, dev, TP_SERVE_STEPS)
            got = mesh_serve(cfg, params, dev, mesh, ref)
            res = {"err": logits_err(got, ref),
                   "greedy_equal": sum(bool(torch.equal(a, b)) for a, b in
                                       zip(got["tokens"], ref["tokens"])),
                   "launches": got["launches"],
                   "one_device_launches": ref["launches"],
                   "forms": got["forms"], "ms": got["ms"],
                   "one_device_ms": ref["ms"]}
            if dt == "float32" and "length-parallel" in got["forms"].values():
                res["fault_err"] = logits_err(
                    mesh_serve(cfg, params, dev, mesh, ref, fault=True), ref)
            out[arch, dt] = res
            del params, ref, got
            torch.cuda.empty_cache()
    return out


def tp_serve_check(got, report) -> dict:
    """Slice 11's gates over the two ranks' tp_serve_run results: K1 a
    rank exact (serve_launches), the one-device runs' too; fp32 within
    LOGITS_RTOL, the planted fault past it; bf16 reported; the forms
    (gemma3-1b length-parallel on both kinds, phi4-mini head-parallel).
    Returns the K1 launches a rank, summed over the runs."""
    want_forms = {LM_ARCH: {"local": "length-parallel",
                            "global": "length-parallel"},
                  "phi4_mini_38b": {"global": "head-parallel"}}
    out = report["tp_serve"] = {"mesh": {"data": 1, "model": 2},
                                "backend": "gloo", "runs": {}}
    total = 0
    for arch, layers in TP_SERVE.items():
        for dt in TP_SERVE_DTYPES:
            cfg = serve_cfg(arch, layers, dt)
            want = serve_launches(cfg, TP_SERVE_STEPS)
            runs = [got[r]["tp_serve"][arch, dt] for r in range(TP_RANKS)]
            for r, run in enumerate(runs):
                if run["launches"] != want or \
                        run["one_device_launches"] != want:
                    fail(f"TP serve {arch} {dt} rank {r}: launched "
                         f"{run['launches']} (one device "
                         f"{run['one_device_launches']}), want {want}")
                if run["forms"] != want_forms[arch]:
                    fail(f"TP serve {arch}: forms {run['forms']}")
            total += sum(run["launches"]["cadc_matmul"] for run in runs) \
                // TP_RANKS
            err = max(run["err"] for run in runs)
            fault = [run.get("fault_err") for run in runs]
            rec = out["runs"][f"{arch}.{dt}"] = {
                "layers": layers, "err_over_scale": err,
                "greedy_equal": [run["greedy_equal"] for run in runs],
                "steps": TP_SERVE_STEPS, "forms": runs[0]["forms"],
                "k1_per_rank": want["cadc_matmul"], "fault_err": fault,
                "step_ms_p50": [float(np.median(run["ms"][1:]))
                                for run in runs],
                "one_device_step_ms_p50": [
                    float(np.median(run["one_device_ms"][1:]))
                    for run in runs]}
            gated = dt == "float32"
            print(f"TP serve {arch} ({layers} layers, {dt}, mesh (data 1, "
                  f"model 2) over gloo, forms {runs[0]['forms']}): prefill "
                  f"+ {TP_SERVE_STEPS} decode steps, logits err / scale "
                  f"{err:.2e}" + (f" (tol {LOGITS_RTOL})" if gated
                                  else " (reported)")
                  + f"; greedy equal {rec['greedy_equal']} of "
                  f"{TP_SERVE_STEPS}; K1 {want['cadc_matmul']} a rank"
                  + (f"; planted merge fault {max(fault):.2e}"
                     if fault[0] is not None else "")
                  + f"; step ms p50 {rec['step_ms_p50']} a rank (gloo "
                  f"through the host) vs one device "
                  f"{rec['one_device_step_ms_p50']}", flush=True)
            if not gated:
                continue
            if not err <= LOGITS_RTOL:
                fail(f"TP serve {arch} fp32: logits err / scale {err} > "
                     f"{LOGITS_RTOL}")
            if (arch == LM_ARCH) != (fault[0] is not None):
                fail(f"TP serve {arch}: the planted fault ran {fault}")
            if fault[0] is not None and not min(fault) > LOGITS_RTOL:
                fail(f"TP serve: the planted merge fault passes the fp32 "
                     f"gate ({fault} <= {LOGITS_RTOL})")
    return total


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

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()
    phases = report["phase_end_s"] = {}

    def mark(name: str) -> None:
        """Seconds since the start at the end of each group of phases."""
        phases[name] = time.perf_counter() - t_start
        print(f"[{phases[name]:.0f} s] {name} done", flush=True)

    build_kernels(report)
    mark("build")
    cfg = get_config("gemma3_1b").with_overrides(linear_impl="cadc",
                                                 kernel_impl="auto")
    check_k1(cfg, dev, report)
    check_k6(cfg, dev, report)
    check_k1g_k2(dev, report)
    check_k3(dev, report)
    quickstart_twin(dev, report)
    mark("kernel checks (K1, K6, K1g / K2, K3), the quickstart twin")

    params = tf.init(cfg, seed=0, device=dev)        # fp32, random weights
    launches, base = serve_main_path(cfg, params, dev, report)
    fp32_logits_check(cfg, params, dev, report)
    gap = verify_gap(cfg, params, dev, report)
    serve_spec(cfg, params, dev, base, gap, report)
    del params
    torch.cuda.empty_cache()
    mark("gemma3-1b serving, speculative serving")

    check_k1_slice5(dev, report)
    check_k6_slice5(dev, report)
    moe_main_path(dev, report)
    moe_fp32_logits(dev, report)
    vit_path(dev, report)
    mark("slice 5")

    check_k1_slice6(dev, report)
    check_k6_slice6(dev, report)
    report["slice6_launches"] = recurrent_paths(dev, report)
    mark("slice 6")

    lenet_path(dev, report)
    ckpt_resume(dev, report)
    training_parity(dev, report)
    train_launches, resnet_trained = resnet_main_path(dev, report)
    time_resnet_step(dev, report)
    torch.cuda.empty_cache()
    mark("CNN training")

    check_k1g_k2_lm(dev, report)
    mark("K1g / K2 at the LM shapes")
    # the LM train CLI's mesh form joins this group of one rank: the
    # steps make every collective over NCCL, as at any world size
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    lm_launches = lm_train_path(dev, report, audit=True)
    mark("gemma3-1b LM training, its cost audit")
    mesh_serve_k1 = mesh_serve_path(dev, report)
    mark("the mesh serve steps at (1, 1)")
    tp_launches, tp_step_launches, tp_serve_k1 = tp_cadc_path(dev, report)
    mark("tp_cadc, the TP and SP train steps, the TP serve steps, the "
         "RG-LRU TP step")
    tp_step_launches["sp_one_rank"] = sp_one_rank(dev, report)
    mark("the SP step at (1, 1)")
    rec_launches = {}
    for arch, kw in REC_TRAIN.items():
        rec_launches[arch] = lm_train_path(dev, report, arch=arch,
                                           steps=REC_TRAIN_STEPS,
                                           key=f"{arch}_train", **kw)
        mark(f"{arch} LM training")
    lm_parity(dev, report)
    mark("lm_parity")
    lm_resume(dev, report)
    mark("lm_resume")
    lm_twin(dev, report)
    mark("lm_twin")
    rec_forms(dev, report)
    mark("rec_forms")
    dist.destroy_process_group()

    # after the training steps' peak-memory readings: device_ms runs each
    # call's warm-up on a new side stream, and PyTorch keeps the cuBLAS
    # workspace it allocates for every stream cuBLAS has run on
    time_k1_slice5(dev, report)
    time_k1_slice6(dev, report)
    time_k1(cfg, dev, launches, report, m=N_SLOTS * (SPEC_K + 1))
    kernels = [time_k1(cfg, dev, launches, report),
               time_k6(cfg, dev, launches, report),
               *time_train_kernels(dev, train_launches, report)]
    time_lm_kernels(dev, lm_launches, kernels, report)
    rec_step_rows(kernels, rec_launches, report)
    rec_library_rows(dev, kernels, report)
    kernels[0]["tp_cadc_launches"] = tp_launches
    kernels[0]["mesh_serve_launches"] = {
        "one_rank": mesh_serve_k1, "two_ranks_per_rank": tp_serve_k1}
    for row in kernels:
        if row["name"] in ("cadc_matmul_gate", "cadc_segmented_bwd"):
            for key, counts in tp_step_launches.items():
                row[f"{key}_launches_per_rank"] = counts[row["name"]]
    torch.cuda.empty_cache()
    mark("kernel timing")

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

    card = report["nvidia_smi"] = nvidia_smi()
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
