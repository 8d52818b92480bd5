"""Step functions and abstract inputs. Port of repro.launch.steps.

train_step: microbatched gradient accumulation -> AdamW update, as the JAX
package's make_train_step (fp32 master parameters, cast to the compute
dtype inside the differentiated loss, so the gradients reach the masters
through the cast). make_fsdp_train_step: the same function over the ranks
of a "data" group, each holding its shards of the masters and of AdamW's
moments (parallel/fsdp.py) — what the JAX step computes under a mesh.
prefill_step: the full-sequence forward, last-position logits.
batched_prefill_step / serve_step (decode): the serving steps. Serving
takes no gradient, so there the port casts the parameters once, when the
engine is built (`cast_compute`), and the steps take the cast parameters:
every product sees the values a per-step cast would give.

abstract_params / abstract_opt_state / abstract_caches / input_specs: the
trees on the "meta" device (shapes and dtypes, no storage), what the
sharding rules and the production mesh plan from.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import comm, fsdp
from repro_torch.train import optimizer as opt_lib

Tensor = torch.Tensor
META = torch.device("meta")


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Tensor]:
    """Meta-device stand-ins for a step's batch, as the JAX package's
    ShapeDtypeStructs: int32 tokens / labels, fp32 patches and frames."""
    b, s = shape.global_batch, shape.seq_len

    def t(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device=META)

    if shape.kind == "decode":  # one new token, caches sized at seq_len
        return {"tokens": t((b,)), "position": t(())}
    if cfg.frontend == "audio":
        out = {"frames": t((b, s, cfg.frontend_dim), torch.float32)}
    else:
        out = {"tokens": t((b, s))}
        if cfg.frontend == "vit":
            out["patches"] = t((b, cfg.frontend_len, cfg.frontend_dim),
                               torch.float32)
    if shape.kind == "train":
        out["labels"] = t((b, s))
    return out


def abstract_params(cfg: ArchConfig):
    """tf.init's tree on the meta device, floats in cfg.params_dtype."""
    dt = getattr(torch, cfg.params_dtype)
    return tf.init(cfg, device=META,
                   dtype=None if dt == torch.float32 else dt)


def abstract_caches(cfg: ArchConfig, batch: int, seq_len: int):
    return tf.init_caches(cfg, batch, seq_len, device=META)


def abstract_opt_state(optimizer: opt_lib.Optimizer, params_shape):
    return optimizer.init(params_shape)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_optimizer(cfg: ArchConfig) -> opt_lib.Optimizer:
    return opt_lib.adamw(
        lr=opt_lib.cosine_warmup_schedule(3e-4, 2000, 100_000),
        weight_decay=0.1,
        max_grad_norm=1.0,
    )


def cast_compute(params, cfg: ArchConfig):
    """fp32 parameters cast to the compute dtype (bf16_wire), the JAX
    package's cast at the top of a step. Differentiable: in the train step
    it runs inside the loss, so the gradients of the cast copies flow to
    the fp32 masters (as fp32)."""
    if not cfg.bf16_wire:
        return params
    dt = ll.cdtype(cfg)
    return tf.tree_map(
        lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)


def _leaves(tree) -> list:
    """The leaves of nested dicts / lists, in tf.tree_map's order."""
    return list(opt_lib._leaves(tree))


def _rebuild(like, leaves: list):
    """`leaves` (in _leaves order) in the structure of `like`."""
    it = iter(leaves)
    return tf.tree_map(lambda _: next(it), like)


def make_train_step(cfg: ArchConfig,
                    optimizer: Optional[opt_lib.Optimizer] = None,
                    n_micro: Optional[int] = None) -> Callable:
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss"}). The batch's leading axis is cut into n_micro contiguous
    microbatches (micro i takes rows [i * B / n_micro, (i + 1) * B /
    n_micro)); each one's loss (lm_loss + 0.01 * the MoE aux loss) is
    differentiated, the gradients are summed in fp32 in micro order from
    zero and divided by n_micro, then optimizer.update and apply_updates.
    "loss" is the mean of the micros' losses. New tensors are returned;
    the inputs are left as they were."""
    optimizer = optimizer or make_optimizer(cfg)
    n_micro = n_micro or cfg.n_microbatches

    def loss_fn(params, micro_batch):
        logits, aux = tf.forward_train(cast_compute(params, cfg),
                                       micro_batch, cfg)
        loss, metrics = tf.lm_loss(logits, micro_batch["labels"])
        return loss + 0.01 * aux, metrics

    def train_step(params, opt_state, batch: Dict[str, Tensor], step: int):
        masters = [p.detach() for p in _leaves(params)]
        gsum = [torch.zeros(p.shape, device=p.device) for p in masters]
        lsum = torch.zeros((), device=masters[0].device)
        for i in range(n_micro):
            micro = {k: v.reshape(n_micro, -1, *v.shape[1:])[i]
                     for k, v in batch.items()}
            live = [p.requires_grad_() for p in
                    (m.detach() for m in masters)]
            loss, _ = loss_fn(_rebuild(params, live), micro)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            gsum = [a if g is None else a + g.float()
                    for a, g in zip(gsum, grads)]
            lsum = lsum + loss.detach()
            del loss, grads, live
        with torch.no_grad():
            grads = _rebuild(params, [g / n_micro for g in gsum])
            plain = _rebuild(params, masters)
            updates, opt_state = optimizer.update(grads, opt_state, plain,
                                                  step)
            params = opt_lib.apply_updates(plain, updates)
        return params, opt_state, {"loss": lsum / n_micro}

    return train_step


def make_fsdp_train_step(cfg: ArchConfig, mesh: mesh_lib.Mesh,
                         dims: list, group=None,
                         optimizer: Optional[opt_lib.Optimizer] = None,
                         n_micro: Optional[int] = None) -> Callable:
    """train_step(shards, opt_state, batch, step) -> (shards, opt_state,
    {"loss"}): make_train_step's function over the ranks of the "data"
    group `group` (default: the default process group), FSDP over it.

    shards: this rank's blocks of the fp32 masters (fsdp.shard by `dims`,
    fsdp.data_dims under `mesh`); opt_state the moments' blocks. batch:
    the GLOBAL batch, the same on every rank. Micro i is make_train_step's
    micro i, rows [i * B / n_micro, (i + 1) * B / n_micro), split over the
    ranks in rank order (B must divide by n_micro x world, else
    ValueError). For each micro every leaf is cast to the compute dtype
    where make_train_step casts it (cast_compute: its blocks, before the
    wire) and all-gathered; the loss of the rank's rows over world is
    differentiated with respect to the gathered leaves, and each
    gradient is reduce-scattered back onto the blocks (all-reduced for a
    leaf no rank shards) in the compute dtype, then added in fp32: the
    gradient the cast's backward hands the masters. An MoE block routes
    over the whole micro (moe.moe_apply's token_group). The clip's global
    norm is one all-reduce of the shards' squared sums (a whole leaf's
    counted once); the loss is the mean over the ranks. The collectives
    run at every world size, one rank included, on the default stream:
    at world 1 the step is make_train_step's, bitwise.

    Data parallelism over "pod" and tensor parallelism over "model" inside
    the step are not ported: a mesh with either raises
    NotImplementedError."""
    if "pod" in mesh.axis_names or mesh_lib.axis_size(mesh, "model") != 1:
        raise NotImplementedError(
            f"mesh {mesh_lib.axis_sizes(mesh)}: the step shards over "
            "'data' only (TP over 'model' and DP over 'pod' are not ported)")
    optimizer = optimizer or make_optimizer(cfg)
    n_micro = n_micro or cfg.n_microbatches
    cast = ll.cdtype(cfg) if cfg.bf16_wire else None

    def train_step(shards, opt_state, batch: Dict[str, Tensor], step: int):
        grp = dist.group.WORLD if group is None else group
        world, rank = dist.get_world_size(grp), dist.get_rank(grp)
        masters = [p.detach() for p in _leaves(shards)]
        if len(masters) != len(dims):
            raise ValueError(f"{len(masters)} leaves, {len(dims)} dims")
        b = next(iter(batch.values())).shape[0]
        if b % (n_micro * world):
            raise ValueError(f"batch {b} does not divide into {n_micro} "
                             f"micros over {world} ranks")
        rows = b // (n_micro * world)
        gsum = [torch.zeros(p.shape, device=p.device) for p in masters]
        lsum = torch.zeros((), device=masters[0].device)
        for i in range(n_micro):
            lo = (i * world + rank) * rows
            micro = {k: v[lo:lo + rows] for k, v in batch.items()}
            with torch.no_grad():
                live = [fsdp.gather(p.to(cast) if cast and p.dtype ==
                                    torch.float32 else p, d, grp)
                        .detach().requires_grad_()
                        for p, d in zip(masters, dims)]
            logits, aux = tf.forward_train(_rebuild(shards, live), micro, cfg,
                                           token_group=grp)
            loss = tf.lm_loss(logits, micro["labels"])[0] + 0.01 * aux
            del logits
            grads = list(torch.autograd.grad(loss / world, live,
                                             allow_unused=True))
            lsum = lsum + loss.detach()
            del loss
            # a gradient autograd hands to two leaves is one tensor: the
            # in-place all-reduce takes a copy of it
            shared = collections.Counter(id(g) for g in grads)
            with torch.no_grad():
                for j, d in enumerate(dims):
                    g = grads[j]
                    if g is None:
                        g = torch.zeros_like(live[j])
                    if d is None:
                        if shared[id(g)] > 1 or not g.is_contiguous():
                            g = g.clone(memory_format=torch.contiguous_format)
                        dist.all_reduce(g, group=grp)
                    else:
                        g = comm.reduce_scatter(g, d, grp)
                    gsum[j] = gsum[j] + g.float()
                    grads[j] = live[j] = None
        with torch.no_grad():
            grads = [g / n_micro for g in gsum]
            del gsum
            sq = torch.stack([g.float().square().sum()
                              if d is not None or rank == 0
                              else g.new_zeros(())
                              for g, d in zip(grads, dims)])
            dist.all_reduce(sq, group=grp)
            plain = _rebuild(shards, masters)
            updates, opt_state = optimizer.update(
                _rebuild(shards, grads), opt_state, plain, step,
                sq_norm=sum(sq.unbind()))
            new = opt_lib.apply_updates(plain, updates)
            dist.all_reduce(lsum, group=grp)
        return new, opt_state, {"loss": lsum / world / n_micro}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """prefill_step(params, batch) -> next-token logits [B, V] of the
    full-sequence forward (no gradient: K1 on the card)."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Tensor]):
        logits, _ = tf.forward_train(cast_compute(params, cfg), batch, cfg)
        return logits[:, -1, :]

    return prefill_step


def make_batched_prefill_step(cfg: ArchConfig) -> Callable:
    """Serving prefill over left-aligned ragged prompts. lengths [B] picks
    each slot's own last-token logits and freezes its recurrent states at
    its own length. Returns (next_tokens [B], last_logits [B, V], cache
    contributions)."""

    def batched_prefill_step(params, batch: Dict[str, Tensor],
                             lengths: Tensor):
        logits, contribs = tf.forward_prefill(params, batch, cfg,
                                              lengths=lengths)
        idx = (lengths - 1).clamp(min=0).to(torch.int64)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        return torch.argmax(last, dim=-1).to(torch.int32), last, contribs

    return batched_prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step against dense caches (updated in place). `position`
    is a scalar or a [B] vector of per-slot offsets."""

    def serve_step(params, tokens: Tensor, position, caches):
        logits = tf.decode_step(params, tokens, position, caches, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return serve_step
