"""The LM train CLI, on one device. Port of repro.launch.train.

    python -m repro_torch.launch.train --arch gemma3_1b --smoke --cadc \
        --steps 20 --batch 8 --seq 128 --ckpt-dir runs/gemma3 [--device cpu]

Runs steps.make_train_step (microbatched gradient accumulation, AdamW on
fp32 masters) on the synthetic LM data. With a CUDA device and the
config's kernel_impl 'auto', every CADC linear trains through the CUDA
kernels: K1g forward (twice a step under remat: the forward and the
recompute), K2 backward. Fault tolerance, as in the JAX package:

  * step-atomic checkpoints (write-tmp -> fsync -> rename) every
    --ckpt-every steps, keep-k GC; a restart resumes from the newest
    COMPLETE checkpoint. The files hold {"params", "opt": {"m", "v"}} in
    the JAX package's pytree layout (transformer.params_to_numpy), so
    either package restores the other's;
  * the data is a pure function of (seed, step), so a resumed run takes
    the steps an unbroken one would have, bitwise;
  * a per-step wall-clock watchdog (--step-timeout): on expiry the step
    raises TimeoutError and the process exits nonzero, for the scheduler
    to restart it from the last checkpoint.

The JAX package's device mesh (--production-mesh, the elastic re-lay of a
restored checkpoint onto another mesh) is not ported: this CLI runs on
one device (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import ckpt
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import transformer as tf


class StepWatchdog:
    """SIGALRM-based per-step timeout: straggler / hang mitigation for
    synchronous training — raise, exit nonzero, let the scheduler restart
    from the last checkpoint."""

    def __init__(self, timeout_s: Optional[float]):
        self.timeout_s = timeout_s

    def __enter__(self):
        if self.timeout_s:
            def on_timeout(signum, frame):
                raise TimeoutError(
                    f"step exceeded {self.timeout_s}s — likely straggler/hang; "
                    "exiting for scheduler restart")
            signal.signal(signal.SIGALRM, on_timeout)
            signal.setitimer(signal.ITIMER_REAL, self.timeout_s)
        return self

    def __exit__(self, *exc):
        if self.timeout_s:
            signal.setitimer(signal.ITIMER_REAL, 0)
        return False


def _ckpt_tree(params, opt_state, cfg):
    """{"params", "opt"} in the JAX package's layout (numpy leaves)."""
    return {"params": tf.params_to_numpy(params, cfg),
            "opt": {k: tf.params_to_numpy(v, cfg)
                    for k, v in opt_state.items()}}


def restore(ckpt_dir: str, params, opt_state, cfg, device):
    """(step, params, opt_state) of the newest complete checkpoint in
    ckpt_dir, onto `device`."""
    step, tree = ckpt.restore(ckpt_dir, _ckpt_tree(params, opt_state, cfg))
    return (step, tf.params_from_numpy(tree["params"], cfg, device),
            {k: tf.params_from_numpy(v, cfg, device)
             for k, v in tree["opt"].items()})


def make_batch(raw_tokens: torch.Tensor, cfg, seq: int) -> Dict[str, Any]:
    """The train batch of a [B, seq + 1] token block, as the JAX package
    builds it: inputs tokens[:, :-1], labels tokens[:, 1:]; zero patches
    for vit archs; zero frames (and the labels) for the audio frontend."""
    toks = raw_tokens.to(torch.int64)
    b, dev = toks.shape[0], toks.device
    if cfg.frontend == "audio":
        return {"frames": torch.zeros(b, seq, cfg.frontend_dim, device=dev),
                "labels": toks[:, 1:]}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vit":
        batch["patches"] = torch.zeros(b, cfg.frontend_len, cfg.frontend_dim,
                                       device=dev)
    return batch


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--cadc", action="store_true",
                    help="enable the paper's technique on every matmul")
    ap.add_argument("--crossbar", type=int, default=256)
    ap.add_argument("--fn", default="relu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep-k", type=int, default=3)
    ap.add_argument("--step-timeout", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this many layers (published "
                    "widths kept)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = (smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_overrides(n_microbatches=args.microbatch)
    if args.layers:
        cfg = cfg.with_overrides(n_layers=args.layers)
    if args.cadc:
        cfg = cfg.with_overrides(linear_impl="cadc",
                                 crossbar_size=args.crossbar,
                                 dendritic_fn=args.fn)

    optimizer = steps_lib.make_optimizer(cfg)
    train_step = steps_lib.make_train_step(cfg, optimizer,
                                           n_micro=args.microbatch)
    params = tf.init(cfg, seed=0, device=dev)  # fp32 masters
    opt_state = optimizer.init(params)
    n_params = sum(t.numel() for t in steps_lib._leaves(params))
    print(f"device={dev} arch={cfg.name} cadc={args.cadc} "
          f"layers={cfg.n_layers} params: {n_params / 1e6:.1f}M", flush=True)

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start_step, params, opt_state = restore(args.ckpt_dir, params,
                                                opt_state, cfg, dev)
        print(f"restored step {start_step} from {args.ckpt_dir}", flush=True)

    data = synthetic.make_lm_dataset(synthetic.LMTokenSpec(
        vocab_size=cfg.vocab_size, seq_len=args.seq), device=dev)
    history, step_s = [], []
    for step in range(start_step, args.steps):
        batch = make_batch(data(step, args.batch)["tokens"], cfg, args.seq)
        t0 = time.perf_counter()
        with StepWatchdog(args.step_timeout):
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        step_s.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:8.4f}  {dt * 1e3:7.1f} ms",
                  flush=True)
            history.append({"step": step, "loss": loss, "s": dt})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            fn = ckpt.save(args.ckpt_dir, step + 1,
                           _ckpt_tree(params, opt_state, cfg),
                           keep_k=args.keep_k)
            print(f"ckpt -> {fn}", flush=True)

    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})",
              flush=True)
    return {"history": history, "params": params, "opt_state": opt_state,
            "step_s": step_s, "cfg": cfg}


if __name__ == "__main__":
    main()
