"""Continuous-batching serving CLI — a thin layer over repro_torch.serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_1b \
        --smoke --cadc --slots 4 --requests 12 --rate 0.5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2_moe_a27b --cadc --slots 8 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma_9b --smoke --cadc --device cpu --spec-tokens 3

--arch is any of configs.ARCH_IDS (the attention-only LMs gemma3-1b,
gemma-7b, codeqwen1.5-7b, phi4-mini, mixtral-8x22b, qwen2-moe-a2.7b and
internvl2-1b; the recurrent recurrentgemma-9b, RG-LRU with local MQA
attention, and xlstm-1.3b, mLSTM and sLSTM blocks with no KV cache);
mixtral-8x22b fits one card only at --smoke size. Random
weights are drawn in the compute dtype layer by layer (transformer.init
dtype=), so a full-width model needs no fp32 copy on the card. A vit
arch's requests get a zero image here: patches reach the engine through
ServeEngine.submit(patches=) only, as in the JAX CLI.

The port of repro.launch.serve, plus --device (default cuda; the run
raises when CUDA is absent) and --kernel-impl (the CADC-linear backend;
the config default 'auto' runs the CUDA kernel on a CUDA device and the
plain segmented linear on the CPU). Requests arrive as a Poisson-style
synthetic stream, so the engine exercises admission queueing, eviction
and slot/block reuse. --spec-tokens K turns decode steps into draft/verify
steps (K drafts a slot scored in one multi-token paged append; --draft
picks the proposer) without changing the committed token streams.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.serve import EngineConfig, ServeEngine, poisson_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCH_IDS)}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cadc", action="store_true")
    ap.add_argument("--slots", "--batch", type=int, default=None,
                    dest="slots", help="concurrent cache slots (default: "
                    "cfg.serve_slots; --batch kept as the legacy alias)")
    ap.add_argument("--requests", type=int, default=None,
                    help="total synthetic requests (default 2x slots — "
                    "forces slot reuse)")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrivals per decode step")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--backend", choices=["paged", "dense"], default="paged")
    ap.add_argument("--prefill-via-decode", action="store_true",
                    help="token-at-a-time prefill through the decode step")
    ap.add_argument("--telemetry-every", type=int, default=None,
                    help="sample per-layer CADC psum sparsity every N decode "
                    "steps (default: cfg.serve_telemetry_every, 0 = off)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "cuda", "torch"],
                    help="paged-attention backend (default "
                    "cfg.paged_attn_impl: the CUDA kernel on a CUDA device, "
                    "the gather formulation on the CPU)")
    ap.add_argument("--kernel-impl", default=None,
                    choices=["auto", "cuda", "torch"],
                    help="CADC-linear backend (default cfg.kernel_impl, "
                    "'auto': the CUDA kernel on a CUDA device, the plain "
                    "segmented linear on the CPU)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative decoding: K draft tokens verified "
                    "per slot per step in one multi-token paged append "
                    "(0 = off; committed streams equal plain greedy "
                    "decode)")
    ap.add_argument("--draft", choices=["ngram", "model"], default="ngram",
                    help="draft proposer for --spec-tokens: prompt-lookup "
                    "n-gram (model-free) or a shrunk-config draft model")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch paths)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (smoke_config if args.smoke else get_config)(args.arch)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only: it has no decode step "
                         "to serve (train it: python -m "
                         "repro_torch.launch.train)")
    if args.cadc:
        cfg = cfg.with_overrides(linear_impl="cadc")
    if args.attn_impl is not None:
        cfg = cfg.with_overrides(paged_attn_impl=args.attn_impl)
    if args.kernel_impl is not None:
        cfg = cfg.with_overrides(kernel_impl=args.kernel_impl)

    slots = args.slots or cfg.serve_slots
    block = args.block_size or cfg.serve_block_size
    max_len = args.max_len or (args.prompt_len + args.gen)
    max_len = -(-max_len // block) * block  # round up to block granularity
    n_requests = args.requests or 2 * slots

    # the engine keeps bf16_wire parameters in the compute dtype: draw
    # them so, with no fp32 copy of the model
    params = tf.init(cfg, seed=args.seed, device=args.device,
                     dtype=ll.cdtype(cfg) if cfg.bf16_wire else None)
    engine = ServeEngine(cfg, params, EngineConfig(
        n_slots=slots,
        max_len=max_len,
        block_size=block,
        backend=args.backend,
        prefill_mode="decode" if args.prefill_via_decode else "batched",
        telemetry_every=args.telemetry_every,
        spec_tokens=args.spec_tokens,
        spec_draft=args.draft,
    ), device=args.device)
    workload = poisson_workload(
        n_requests=n_requests, rate=args.rate, vocab_size=cfg.vocab_size,
        prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
        max_new=(max(1, args.gen // 2), args.gen), seed=args.seed)
    summary = engine.run(workload)

    print(f"arch={cfg.name} cadc={args.cadc} backend={args.backend} "
          f"device={engine.device} slots={slots} requests={n_requests} "
          f"prefill={'decode' if args.prefill_via_decode else 'batched'}:")
    print(f"  {summary['tokens_per_s']:.1f} tok/s over "
          f"{summary['decode_tokens']} decode tokens "
          f"({summary['requests_finished']} requests)")
    print(f"  step ms p50/p99 = {summary['step_ms_p50']:.1f}/"
          f"{summary['step_ms_p99']:.1f}  TTFT ms p50/p99 = "
          f"{summary['ttft_ms_p50']:.1f}/{summary['ttft_ms_p99']:.1f}")
    if "speculative" in summary:
        sp = summary["speculative"]
        print(f"  speculative (K={args.spec_tokens}, draft={args.draft}): "
              f"accept rate {sp['accept_rate']:.2f}, "
              f"{sp['tokens_per_step']:.2f} tokens/slot/step "
              f"({sp['accepted']}/{sp['drafted']} drafts over "
              f"{sp['steps']} steps)")
    if "blocks" in summary:
        print(f"  blocks: {json.dumps(summary['blocks'])}")
    if "psum_sparsity" in summary:
        gates = [v["gate_off"] for v in summary["psum_sparsity"].values()]
        print(f"  psum gate-off fraction: mean={float(np.mean(gates)):.3f} "
              f"over {len(gates)} tapped linears")
    rid0 = min(engine.results)
    print(f"sample continuation (req {rid0}): "
          f"{engine.results[rid0].tokens[:12]}")
    return summary


if __name__ == "__main__":
    main()
