"""The LM train CLI on a device mesh. Port of repro.launch.train.

    python -m repro_torch.launch.train --arch gemma3_1b --smoke --cadc \
        --steps 20 --batch 8 --seq 128 --ckpt-dir runs/gemma3 [--device cpu]
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m repro_torch.launch.train --arch gemma3_1b --smoke --cadc ...

Runs steps.make_fsdp_train_step (microbatched gradient accumulation,
AdamW on fp32 masters, FSDP over the mesh's "data" axis) on the synthetic
LM data, on whatever group the process is in: under torch.distributed.run
it joins the group from the environment (rank r on cuda:LOCAL_RANK); run
plainly it makes a group of one rank. The backend follows --device: NCCL
on cuda, gloo on cpu; a failed init raises (no other backend, no other
device). The mesh is make_local_mesh() — (world, 1) ("data", "model") —
or, with --production-mesh, the 16 x 16 pod mesh (FSDP over "data",
tensor parallelism over "model"), which needs 256 ranks (ValueError
otherwise). The step makes its collectives at every world size, one rank
included. With a CUDA device and the config's kernel_impl
'auto', every CADC linear trains through the CUDA kernels: K1g forward
(twice a step under remat: the forward and the recompute), K2 backward.
Fault tolerance, as in the JAX package:

  * step-atomic checkpoints (write-tmp -> fsync -> rename) every
    --ckpt-every steps, keep-k GC; a restart resumes from the newest
    COMPLETE checkpoint. The files hold the unsharded {"params", "opt":
    {"m", "v"}} in the JAX package's pytree layout
    (transformer.params_to_numpy): every rank gathers the leaves (over
    "data", then "model"), rank 0 writes them, the others wait at a
    barrier; either package restores the other's;
  * elastic re-lay: every rank restores the whole tree and keeps its
    shards under the CURRENT mesh's rules, whatever world saved the file;
  * the data is a pure function of (seed, step), so a resumed run takes
    the steps an unbroken one would have, bitwise;
  * a per-step wall-clock watchdog (--step-timeout): on expiry the step
    raises TimeoutError and the process exits nonzero, for the scheduler
    to restart it from the last checkpoint.

main() returns the history, this rank's shards of the parameters and the
optimizer state, the step times, the config, the mesh and the step.
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import ckpt
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp


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


def join_group(device: torch.device) -> bool:
    """Join the process group for `device` (NCCL on cuda, gloo on cpu):
    the one already up, the one torch.distributed.run describes in the
    environment, or a new group of one rank. Returns whether this call
    made the group (its maker destroys it). Raises when the group up has
    another backend, or when the init fails."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f"; device {device} needs {backend}")
        return False
    if "WORLD_SIZE" in os.environ:      # torch.distributed.run
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def save(ckpt_dir: str, step: int, shards, opt_state, cfg, keep_k: int,
         dims, mdims, groups) -> Optional[str]:
    """Gather every leaf (one at a time, onto the host: its "data" blocks
    along `dims`, then its "model" blocks along `mdims`, over the mesh's
    groups `groups`, a launch/mesh.MeshGroups) and write the unsharded
    checkpoint from rank 0; the other ranks wait at a barrier. Returns the
    file's path on rank 0, None elsewhere."""
    def whole(tree):
        it = iter(zip(dims, mdims))

        def one(t):
            d, md = next(it)
            t = fsdp.gather(t, d, groups.groups["data"])
            return fsdp.gather(t, md, groups.groups["model"]).cpu()
        return tf.tree_map(one, tree)

    params = whole(shards)
    opt = {k: whole(v) for k, v in opt_state.items()}
    fn = (ckpt.save(ckpt_dir, step, _ckpt_tree(params, opt, cfg),
                    keep_k=keep_k) if dist.get_rank() == 0 else None)
    dist.barrier()
    return fn


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
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 pod mesh (needs 256 ranks)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this many layers (published "
                    "widths kept)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "versions of the kernels over gloo)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    made = join_group(dev)
    try:
        return _train(args, dev)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, dev: torch.device) -> Dict[str, Any]:
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = (smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_overrides(n_microbatches=args.microbatch)
    if args.layers:
        cfg = cfg.with_overrides(n_layers=args.layers)
    if args.cadc:
        cfg = cfg.with_overrides(linear_impl="cadc",
                                 crossbar_size=args.crossbar,
                                 dendritic_fn=args.fn)

    mesh = (mesh_lib.make_production_mesh() if args.production_mesh
            else mesh_lib.make_local_mesh(world))
    if mesh.size != world:
        raise ValueError(f"mesh {mesh_lib.axis_sizes(mesh)} needs "
                         f"{mesh.size} ranks; the group has {world}")
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"mesh: {mesh_lib.axis_sizes(mesh)} arch={cfg.name} "
        f"cadc={args.cadc} device={dev} backend={dist.get_backend()} "
        f"layers={cfg.n_layers}", flush=True)

    optimizer = steps_lib.make_optimizer(cfg)
    shape = steps_lib.abstract_params(cfg)
    dims = fsdp.data_dims(shape, cfg, mesh)
    mdims = fsdp.model_dims(shape, cfg, mesh)
    train_step = steps_lib.make_fsdp_train_step(cfg, mesh, dims,
                                                optimizer=optimizer,
                                                n_micro=args.microbatch)
    mg = train_step.mesh_groups
    params = tf.init(cfg, seed=0, device=dev)  # fp32 masters, whole
    n_params = sum(t.numel() for t in steps_lib._leaves(params))
    log(f"params: {n_params / 1e6:.1f}M", flush=True)

    start_step, opt_state = 0, None
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start_step, params, opt_state = restore(
            args.ckpt_dir, params, optimizer.init(params), cfg, dev)
        log(f"restored step {start_step} from {args.ckpt_dir}", flush=True)

    def lay(tree):  # this rank's blocks under the current mesh's rules
        it = iter(zip(dims, mdims))
        return tf.tree_map(lambda t: fsdp.mesh_block(t, *next(it), mg.coords,
                                                     mg.sizes), tree)

    params = lay(params)
    opt_state = ({k: lay(v) for k, v in opt_state.items()} if opt_state
                 else optimizer.init(params))

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
            log(f"step {step:5d}  loss {loss:8.4f}  {dt * 1e3:7.1f} ms",
                flush=True)
            history.append({"step": step, "loss": loss, "s": dt})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            fn = save(args.ckpt_dir, step + 1, params, opt_state, cfg,
                      args.keep_k, dims, mdims, mg)
            log(f"ckpt -> {fn}", flush=True)

    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        log(f"loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})",
            flush=True)
    return {"history": history, "params": params, "opt_state": opt_state,
            "step_s": step_s, "cfg": cfg, "mesh": mesh, "dims": dims,
            "model_dims": mdims, "train_step": train_step}


if __name__ == "__main__":
    main()
