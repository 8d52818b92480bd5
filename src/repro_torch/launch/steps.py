"""Step functions and abstract inputs. Port of repro.launch.steps.

train_step: microbatched gradient accumulation -> AdamW update, as the JAX
package's make_train_step (fp32 master parameters, cast to the compute
dtype inside the differentiated loss, so the gradients reach the masters
through the cast). make_fsdp_train_step: the same function over the ranks
of a ("pod", "data", "model") mesh, each holding its blocks of the masters
and of AdamW's moments (parallel/fsdp.py), tensor-parallel over "model" —
what the JAX step computes under a mesh.
prefill_step: the full-sequence forward, last-position logits.
batched_prefill_step / serve_step (decode): the serving steps. Serving
takes no gradient, so there the port casts the parameters once, when the
engine is built (`cast_compute`), and the steps take the cast parameters:
every product sees the values a per-step cast would give.
make_mesh_prefill_step / make_mesh_serve_step: prefill_step and
serve_step over the ranks of a ("pod", "data", "model") mesh, as the JAX
package's dry run shards its steps: the parameters' blocks gathered a
call, TP over "model", DP over "data" and "pod", the dense caches in
blocks under the cache rule (`cache_blocks`).

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
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import act_sharding, comm, fsdp, sharding
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


def cache_blocks(caches, cfg: ArchConfig, mesh: mesh_lib.Mesh, batch: int,
                 coords) -> list:
    """The blocks of dense caches of a global `batch` that the rank at mesh
    coordinates `coords` holds under sharding.cache_specs (the mesh serve
    step's caches)."""
    specs = sharding.cache_specs(caches, cfg, mesh, batch)
    sizes = mesh_lib.axis_sizes(mesh)
    return [type(c)(*(fsdp.spec_block(t, spec, coords, sizes)
                      for t, spec in zip(c, cs)))
            for c, cs in zip(caches, specs)]


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


def _mesh_plan(cfg: ArchConfig, mesh: mesh_lib.Mesh, dims: list,
               leaf_modes) -> tuple:
    """(the axis sizes, the abstract params, each leaf's "model" dim under
    the rules, each leaf's (mode, dim) under the plan `leaf_modes`
    (transformer.tp_leaf_modes or serve_leaf_modes)) of a step over `mesh`.
    A leaf the plan splits along another dim than the rules store it (an
    MoE block's shared expert, which JAX's rules read as a bank) is
    ("cut", dim): gathered, then cut."""
    sizes = {a: mesh_lib.axis_size(mesh, a) for a in mesh_lib.AXES}
    shape = abstract_params(cfg)
    mdims = fsdp.model_dims(shape, cfg, mesh)
    plan = leaf_modes(shape, cfg, sizes)
    if len(dims) != len(plan):
        raise ValueError(f"{len(dims)} dims for {len(plan)} leaves")
    return sizes, shape, mdims, _cut_modes(plan, mdims)


def _cut_modes(plan: list, mdims: list) -> list:
    return [("cut", cd) if m == "split" and md != cd else (m, cd)
            for (m, cd), md in zip(plan, mdims)]


def seq_split(cfg: ArchConfig, seq_len: int, sizes) -> bool:
    """Whether the train step runs a micro of `seq_len` positions
    sequence-parallel over "model": cfg.seq_sharding under act_sharding,
    where the JAX package's _seq_shard constrains the residual stream
    (act_sharding.splits: the length divides the axis; at one rank the
    form runs with its collectives over that rank)."""
    return act_sharding.splits(seq_len, sizes=sizes,
                               enabled=cfg.act_sharding and cfg.seq_sharding)


def _gather_leaves(blocks: list, cfg: ArchConfig, dims: list, mdims: list,
                   modes: list, mg: mesh_lib.MeshGroups) -> list:
    """The leaves a step's layers read, from this rank's blocks: each cast
    to the compute dtype where cast_compute casts it (its block, before the
    wire), all-gathered over "data", and over "model" where the plan does
    not read it split ("cut": then this rank's block along the plan's
    dim)."""
    cast = ll.cdtype(cfg) if cfg.bf16_wire else None
    out = []
    for p, d, md, (mode, cd) in zip(blocks, dims, mdims, modes):
        t = p.to(cast) if cast and p.dtype == torch.float32 else p
        t = fsdp.gather(t, d, mg.groups["data"])
        if mode != "split":
            t = fsdp.gather(t, md, mg.groups["model"])
        if mode == "cut":
            t = comm.block(t, cd, mg.coords["model"], mg.sizes["model"])
        out.append(t)
    return out


def make_fsdp_train_step(cfg: ArchConfig, mesh: mesh_lib.Mesh,
                         dims: list,
                         optimizer: Optional[opt_lib.Optimizer] = None,
                         n_micro: Optional[int] = None) -> Callable:
    """train_step(shards, opt_state, batch, step) -> (shards, opt_state,
    {"loss"}): make_train_step's function over the ranks of `mesh` ("pod",
    "data", "model"; rank r at the mesh coordinate r in row-major order,
    launch/mesh.process_groups, made here by every rank): FSDP over
    "data", tensor parallelism (TP) over "model", data parallelism over
    "data" and "pod". The function's `mesh_groups` is this rank's
    MeshGroups (its coordinates and groups).

    shards: this rank's blocks of the fp32 masters under the sharding
    rules (fsdp.mesh_block by `dims`, fsdp.data_dims under `mesh`, and
    fsdp.model_dims); opt_state the moments' blocks. batch: the GLOBAL
    batch, the same on every rank. Micro i is make_train_step's micro i,
    rows [i * B / n_micro, (i + 1) * B / n_micro), split over the
    data-parallel ranks (pod x data, pod-major; B must divide by n_micro x
    their count, else ValueError); a "model" group reads the same rows.

    For each micro every leaf is cast to the compute dtype where
    make_train_step casts it (cast_compute: its blocks, before the wire)
    and all-gathered over "data"; a leaf the TP plan
    (transformer.tp_leaf_modes) does not use split is all-gathered over
    "model" too. The layers run in the TP context (parallel.act_sharding:
    Megatron's column / row / vocab / expert parallel layers over the
    "model" group, each row-parallel CADC linear on whole local segments
    or on the gathered activation; the vocab-parallel loss). The loss of
    the rank's rows over the data-parallel size is differentiated with
    respect to the gathered leaves; each gradient is summed over "model"
    where the plan uses the leaf in part (reduce-scattered onto the
    block, or all-reduced), cut to the rank's block where every rank
    computes it whole, and reduce-scattered over "data" (all-reduced, in
    a few flat buckets, for the leaves no rank shards over "data"), in the
    compute dtype, then added in fp32; the micros' fp32 sums are
    all-reduced over "pod" once a step, in flat buckets. An
    MoE block routes over the whole micro (moe.moe_apply's token_group:
    the data-parallel group). The clip's global norm is one all-reduce
    of the blocks' squared sums, each block counted once; the loss is the
    mean over the data-parallel ranks. The collectives run at every world
    size, one rank included, on the default stream: at world 1 the step
    is make_train_step's, bitwise, with or without sequence parallelism.

    Sequence parallelism (cfg.seq_sharding; `seq_split` of the micro's
    length): the layers carry the residual stream as the rank's block of
    the sequence, entering each tensor-parallel region by an all-gather
    along S and leaving it by a reduce-scatter in place of the all-reduce
    (Megatron-SP, act_sharding's `seq`), and the plan is
    tp_leaf_modes(seq=True): the norms' and the fallbacks' gradients,
    each rank's of its block, are summed over "model" too. A micro whose
    length does not divide the axis runs as without it."""
    optimizer = optimizer or make_optimizer(cfg)
    n_micro = n_micro or cfg.n_microbatches
    sizes, shape, mdims, modes = _mesh_plan(cfg, mesh, dims,
                                            tf.tp_leaf_modes)
    seq_modes = _cut_modes(tf.tp_leaf_modes(shape, cfg, sizes, seq=True),
                           mdims)
    shape_of = [tuple(x.shape) for x in _leaves(shape)]
    mg = mesh_lib.process_groups(mesh)
    grp, at = mg.groups, mg.coords
    if dist.get_rank() == 0:
        leaves = dict(collections.Counter(m for m, _ in modes))
        print(f"tp plan {mesh_lib.axis_sizes(mesh)}: leaves {leaves}; "
              "row-parallel linears on the gathered activation: "
              f"{tf.tp_fallbacks(cfg, sizes) or 'none'}"
              + ("; sequence-parallel where S divides the model axis"
                 if cfg.seq_sharding and cfg.act_sharding else ""),
              flush=True)

    def train_step(shards, opt_state, batch: Dict[str, Tensor], step: int):
        masters = [p.detach() for p in _leaves(shards)]
        if len(masters) != len(dims):
            raise ValueError(f"{len(masters)} leaves, {len(dims)} dims")
        dp, r = mg.dp_size(), mg.dp_rank()
        b = next(iter(batch.values())).shape[0]
        if b % (n_micro * dp):
            raise ValueError(f"batch {b} does not divide into {n_micro} "
                             f"micros over {dp} data-parallel ranks")
        rows = b // (n_micro * dp)
        seq = seq_split(cfg, batch["labels"].shape[1], sizes)
        plan = seq_modes if seq else modes
        gsum = [torch.zeros(p.shape, device=p.device) for p in masters]
        lsum = torch.zeros((), device=masters[0].device)
        for i in range(n_micro):
            lo = (i * dp + r) * rows
            micro = {k: v[lo:lo + rows] for k, v in batch.items()}
            with torch.no_grad():
                live = [t.detach().requires_grad_() for t in _gather_leaves(
                    masters, cfg, dims, mdims, modes, mg)]
            with act_sharding.tp_context(sizes, grp["model"], at["model"],
                                         seq):
                logits, aux = tf.forward_train(_rebuild(shards, live), micro,
                                               cfg, token_group=grp["dp"])
                loss = (tf.lm_loss(logits, micro["labels"], cfg=cfg)[0]
                        + 0.01 * aux)
                del logits
                grads = list(torch.autograd.grad(loss / dp, live,
                                                 allow_unused=True))
            lsum = lsum + loss.detach()
            del loss
            # a gradient autograd hands to two leaves is one tensor: the
            # in-place collectives take a copy of it for each
            shared = collections.Counter(id(g) for g in grads)
            whole = []          # the leaves no rank shards over "data"
            with torch.no_grad():
                for j, (d, md, (mode, cd)) in enumerate(zip(dims, mdims,
                                                            plan)):
                    g = grads[j]
                    if g is None:
                        g = torch.zeros_like(live[j])
                    elif shared[id(g)] > 1:
                        g = g.clone(memory_format=torch.contiguous_format)
                    if mode == "cut":         # back into the whole leaf
                        full = g.new_zeros(shape_of[j])
                        comm.block(full, cd, at["model"],
                                   sizes["model"]).copy_(g)
                        g, mode = full, "partial"
                    if mode == "partial":
                        if md is None:
                            g = comm.all_reduce(g.contiguous(), grp["model"])
                        else:
                            g = comm.reduce_scatter(g, md, grp["model"])
                    elif md is not None and mode == "full":
                        g = comm.block(g, md, at["model"], sizes["model"])
                    if d is None:
                        whole.append((j, g))
                    else:
                        gsum[j] = gsum[j] + comm.reduce_scatter(
                            g, d, grp["data"]).float()
                    grads[j] = live[j] = None
                comm.all_reduce_coalesced([g for _, g in whole],
                                          grp["data"])
                for j, g in whole:
                    gsum[j] = gsum[j] + g.float()
                del whole
        with torch.no_grad():
            # data parallelism over "pod": the micros' sums, once a step
            comm.all_reduce_coalesced(gsum, grp["pod"])
            grads = [g / n_micro for g in gsum]
            del gsum
            first = {a: at[a] == 0 for a in at}
            sq = torch.stack([
                g.float().square().sum()
                if first["pod"] and (d is not None or first["data"])
                and (md is not None or first["model"])
                else g.new_zeros(())
                for g, d, md in zip(grads, dims, mdims)])
            comm.all_reduce(sq)
            plain = _rebuild(shards, masters)
            updates, opt_state = optimizer.update(
                _rebuild(shards, grads), opt_state, plain, step,
                sq_norm=sum(sq.unbind()))
            new = opt_lib.apply_updates(plain, updates)
            comm.all_reduce(lsum, grp["dp"])
        return new, opt_state, {"loss": lsum / dp / n_micro}

    train_step.mesh_groups = mg
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


def _dp_rows(b: int, mg: mesh_lib.MeshGroups):
    """The rows of a global batch of `b` this rank runs, and the group an
    MoE block routes over: its data-parallel block where b divides the DP
    size (the batch rule of sharding.cache_specs; the "dp" group holds the
    other blocks), else every row and no group."""
    dp = mg.dp_size()
    if b % dp == 0 and b >= dp:
        n = b // dp
        return slice(mg.dp_rank() * n, (mg.dp_rank() + 1) * n), \
            mg.groups["dp"]
    return slice(None), None


def make_mesh_prefill_step(cfg: ArchConfig, mesh: mesh_lib.Mesh,
                           dims: list) -> Callable:
    """prefill_step(shards, batch) -> next-token logits [b, V]:
    make_prefill_step's function over the ranks of `mesh` (as
    make_fsdp_train_step: rank r at mesh coordinate r, its `mesh_groups`
    this rank's groups). shards: this rank's blocks of the parameters
    (fsdp.mesh_block by `dims` and fsdp.model_dims); batch: the GLOBAL
    batch. cfg.seq_sharding changes nothing here, as in the JAX package,
    whose _seq_shard only its train layers call. Each call casts the
    leaves as cast_compute does and gathers them whole over "data", and
    over "model" where the train plan (transformer.tp_leaf_modes: the
    RG-LRU block channel-parallel too) does not split them; forward_train
    then runs in the TP context with no gradient (K1 on the card) over
    this rank's rows (_dp_rows: its data-parallel block, or every row where
    the batch does not divide), an MoE block routing over the whole
    batch; the last position's vocab-parallel logits are gathered over
    "model" into the logical vocab. Returns this rank's rows; every rank
    of a "model" group the same. At world 1 it is make_prefill_step's,
    bitwise. `attention_forms`: each attention kind's form."""
    sizes, _, mdims, modes = _mesh_plan(cfg, mesh, dims, tf.tp_leaf_modes)
    mg = mesh_lib.process_groups(mesh)
    heads = attn.heads_split(cfg, sizes)

    @torch.no_grad()
    def prefill_step(shards, batch: Dict[str, Tensor]):
        live = _gather_leaves(_leaves(shards), cfg, dims, mdims, modes, mg)
        rows, group = _dp_rows(next(iter(batch.values())).shape[0], mg)
        with act_sharding.tp_context(sizes, mg.groups["model"],
                                     mg.coords["model"]):
            logits, _ = tf.forward_train(
                _rebuild(shards, live), {k: v[rows] for k, v in batch.items()},
                cfg, token_group=group)
            return ll.gather_logits(logits[:, -1], cfg)

    prefill_step.mesh_groups = mg
    prefill_step.attention_forms = {
        kind: "head-parallel" if heads else "replicated"
        for kind in tf.ATTN_KINDS if kind in tf.layout(cfg)}
    return prefill_step


def make_mesh_serve_step(cfg: ArchConfig, mesh: mesh_lib.Mesh, dims: list,
                         seq_len: int) -> Callable:
    """serve_step(shards, tokens, position, caches) -> (next tokens [b],
    logits [b, V]): make_serve_step's decode step over the ranks of
    `mesh`, on dense caches of `seq_len` positions (the rings of
    attention.cache_len) held in blocks (cache_blocks: sharding.cache_specs
    — batch over "pod" / "data" where it divides, kv heads over "model"
    where they divide, else the ring length where it divides).

    shards: this rank's parameter blocks, as make_mesh_prefill_step's;
    tokens [B] and position (a scalar or [B]): the GLOBAL batch's;
    caches: this rank's blocks, updated in place (a recurrent layer's list
    entry replaced). Each call casts and gathers the leaves as
    make_mesh_prefill_step does, under the serve plan
    (transformer.serve_leaf_modes); decode_step runs in the TP context
    over this rank's rows (_dp_rows), each attention layer in the form its
    cache block implies (attention.decode_form, `attention_forms`), an MoE
    block routing over the whole batch, the recurrent layers replicated
    over "model" on their rows. The vocab-parallel logits are gathered
    over "model" and cut to the vocab before the argmax, so ties break at
    the first index as in make_serve_step. At world 1 it is
    make_serve_step's, bitwise. No host sync: the step runs on the meta
    device (launch/dryrun.py)."""
    sizes, _, mdims, modes = _mesh_plan(cfg, mesh, dims,
                                        tf.serve_leaf_modes)
    mg = mesh_lib.process_groups(mesh)
    kinds = [k for k in tf.ATTN_KINDS if k in tf.layout(cfg)]
    ring_lens = {k: attn.cache_len(cfg, k, seq_len) for k in kinds}

    @torch.no_grad()
    def serve_step(shards, tokens: Tensor, position, caches):
        live = _gather_leaves(_leaves(shards), cfg, dims, mdims, modes, mg)
        rows, group = _dp_rows(tokens.shape[0], mg)
        if torch.as_tensor(position).ndim:
            position = position[rows]
        with act_sharding.tp_context(sizes, mg.groups["model"],
                                     mg.coords["model"]):
            logits = ll.gather_logits(tf.decode_step(
                _rebuild(shards, live), tokens[rows], position, caches, cfg,
                ring_lens=ring_lens, token_group=group), cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    serve_step.mesh_groups = mg
    serve_step.attention_forms = {
        k: attn.decode_form(cfg, ring_lens[k], sizes["model"])
        for k in kinds}
    return serve_step
