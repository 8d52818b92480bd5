"""The paper's core experiment on LeNet-5: vConv against CADC training.

    python -m repro_torch.launch.train_cnn_cadc [--steps 300] [--device cpu]

Twin of examples/train_cnn_cadc.py. Trains LeNet-5 (paper benchmark #1)
twice — vConv baseline and CADC with ReLU dendrites on 64-row crossbars —
on the synthetic MNIST proxy, then reports the accuracy delta, the psum
sparsity of the trained CADC model, and the system-level energy
reductions that sparsity buys (zero-compression + zero-skipping cost
model).

With a CUDA device and --kernel auto, every conv and FC layer trains
through the CUDA kernels (K3 / K1g forward, K2 backward) and evaluates
through K3 / K1. The sparsity pass at the end collects psum statistics,
which needs the materialized psums: as in the JAX package, its layers
that span more than one crossbar run the core math (no kernel) — the
only part of this script that does.
"""
from __future__ import annotations

import argparse

from repro_torch.core import costmodel as cmodel
from repro_torch.core import sparsity as sp
from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.models.cnn import lenet5
from repro_torch.models.common import Ctx, LayerMode
from repro_torch.train import loop, optimizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--xbar", type=int, default=64)
    ap.add_argument("--kernel", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="segmented-contraction backend: 'auto' trains "
                    "through the CUDA kernels on a CUDA device and their "
                    "plain versions on the CPU; 'torch' is the core einsum")
    ap.add_argument("--save-gate", default="auto",
                    choices=["auto", "packed", "bytes", "recompute"],
                    help="gradient residual of the kernels: 'auto' packs "
                    "the relu gate into uint32 words; 'recompute' saves "
                    "nothing and re-derives the gate in the backward")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "versions)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    data = synthetic.make_classification_dataset(
        synthetic.ClassificationSpec(n_classes=10, hw=28, channels=1,
                                     noise=0.8), device=dev)
    cfg = loop.TrainConfig(steps=args.steps, batch_size=args.batch,
                           eval_every=max(1, args.steps // 6), eval_batches=8,
                           kernel=args.kernel, save_gate=args.save_gate)

    results = {}
    for label, mode in [
        ("vconv", LayerMode(impl="vconv", crossbar_size=args.xbar)),
        ("cadc", LayerMode(impl="cadc", crossbar_size=args.xbar, fn="relu")),
    ]:
        print(f"=== training LeNet-5 [{label}] for {args.steps} steps ===")
        out = loop.train(init_fn=lenet5.init, apply_fn=lenet5.apply,
                         batch_fn=data, mode=mode,
                         optimizer=optimizer.adamw(1e-3), cfg=cfg,
                         device=dev)
        for h in out["history"]:
            print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
                  f"acc {h['acc']:.3f}")
        print(f"  final eval acc: {out['eval']['acc']:.4f}")
        results[label] = out

    delta = results["cadc"]["eval"]["acc"] - results["vconv"]["eval"]["acc"]
    print(f"\naccuracy delta (CADC - vConv): {delta:+.4f} "
          f"(paper: +0.11%..+0.19% on real MNIST)")

    # psum sparsity of the trained CADC model -> system cost model
    mode = LayerMode(impl="cadc", crossbar_size=args.xbar, fn="relu",
                     collect_stats=True, kernel=args.kernel)
    ctx = Ctx(mode)
    batch = data(99_999, args.batch)
    lenet5.apply(results["cadc"]["params"], results["cadc"]["state"],
                 batch["image"], ctx, train=False)
    layers = [
        sp.LayerPsumStats(nm, int(s["segments"]), int(s["count"]),
                          float(s["sparsity"]), float(s["segments"]) > 1)
        for nm, s in ctx.stats_dict().items()
    ]
    agg = sp.summarize(layers)
    print(f"psum sparsity (count-weighted): {agg['eliminated_frac']:.1%} "
          f"(paper: ~80% for LeNet-5)")

    macs = sum(lay.count * args.xbar for lay in layers)
    red = cmodel.evaluate_network(layers, macs=macs, adc_bits=4).reductions()
    print(f"zero-compress+skip: buffer/transfer "
          f"-{red['buffer_transfer_reduction']:.1%}, accumulation "
          f"-{red['accum_reduction']:.1%} "
          f"(paper: -29.3% / -47.9% at 54% sparsity)")
    return {"results": results, "layers": layers, "summary": agg,
            "reductions": red}


if __name__ == "__main__":
    main()
