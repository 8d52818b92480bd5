"""Dry run: plan every (arch x shape x mesh) cell at the production meshes
on the meta device, with no card. Twin of repro.launch.dryrun.

    python -m repro_torch.launch.dryrun --arch gemma3_1b --shape train_4k \
        --mesh both [--smoke] [--audit | --audit-diff] \
        [--override n_layers=2] [--out DIR]

The JAX package lowers and compiles each cell's step for 256 / 512 fake
devices and reads XLA's cost analysis. The port has no compiler to ask,
so it plans a cell as one rank of the mesh sees it:

  * a train cell runs rank 0's step (steps.make_fsdp_train_step: FSDP
    over "data", TP over "model", DP over "pod") on rank 0's blocks of the
    fp32 masters and of AdamW's moments and on the global batch, all on
    the meta device (shapes, no storage), in a process group of 256 / 512
    ranks whose collectives do nothing (torch's fake process group); the
    parallel/comm wrappers record each collective's wire bytes per rank
    by kind, with the ring formulas of the JAX package's
    parse_collective_bytes. The step runs over one micro and over two, and
    the bytes of n micros are the first's plus n - 1 times the
    difference: every micro makes the same collectives (the twin of the
    JAX dry run's two-probe extrapolation, exact here);
  * a prefill or decode cell runs rank 0's serving step the same way
    (steps.make_mesh_prefill_step / make_mesh_serve_step: the parameters'
    blocks gathered a call, TP over "model", DP over "data" and "pod")
    on rank 0's parameter blocks and, for a decode cell, its blocks of the
    dense caches under sharding.cache_specs (steps.cache_blocks), once,
    inside the same record: a step has no micros. It reports the form
    each attention kind took ("attention_forms": head-parallel,
    length-parallel or replicated; attention.decode_form for a decode,
    the train form for a prefill) and the bytes of rank 0's cache blocks
    beside the rules' per-rank cache bytes.

A cell planned under --override seq_sharding=True runs the train step
sequence-parallel over "model" (launch/steps.seq_split), as the JAX
package's --override does; prefill and decode steps ignore the flag, as
the JAX package's do, and report as without it. A report carries its
overrides.

Every cell reports n_params, n_active_params and model_flops (the JAX
package's formulas), the per-rank parameter and optimizer bytes under the
rules, the row-parallel linears that fall back to the gathered activation
(transformer.tp_fallbacks), and roofline terms with an H100's datasheet
figures: model FLOPs a chip over the bf16 dense peak; the least bytes a
chip's step moves (train: its parameter and optimizer blocks read and
written once; prefill / decode: its parameter and cache blocks read once)
over the HBM rate; the recorded collective bytes over one NVLink
direction. These are plans, not measurements. Cells the config skips
(cfg.shape_cells / skip_reasons) are reported as SKIP. Reports are
written as JSON under --out (default experiments/dryrun_torch/, ignored
by git).

A train cell runs cfg.n_microbatches micros, or the most below that
give every data-parallel rank whole rows of each (mixtral-8x22b's 16
micros of 256 rows over 512 ranks' 32-way data parallelism: 8), and
reports the count as n_micro.

--smoke plans the reduced configs at seq_len <= 128 and a global batch of
the data-parallel size x n_microbatches (train; x 1 under the audit) or
<= 8 (prefill / decode).

The cost audit (--audit; run_cell(audit=True)), as the JAX package's:
the cell's step at n_microbatches = 1 over all its layers, run once under
count_cost, which counts what the step executes on rank 0: every aten op
(FLOPs by torch.utils.flop_counter's formulas, bytes read and written,
views free) and every CADC product as one unit worked out from its
shapes, whichever route runs it (core/work.py). The report's "cost":
flops_per_chip, bytes_per_chip, flops_global (x n_chips), model_flops and
useful_ratio (model FLOPs over flops_global): the JAX package's fields
without their "hlo_" prefix, since the port has no HLO; its bytes are an
eager, unfused count, not XLA's fused "bytes accessed", and the two are
never compared. The roofline terms are then the counted FLOPs over the
peak, the counted bytes over the HBM rate and the collective bytes over
the link; the mesh tag is "single_audit" / "multi_audit". --audit-diff
(run_cell_audit_diff) extrapolates all of these from a probe of one
pattern unit and one of two, as the JAX package does. The JAX package's
parse_collective_bytes is not ported: it parses post-SPMD HLO, which the
port has not; its ring formulas are parallel/comm.record's, and its
bf16_wire_correction undoes a promotion of the CPU backend the port never
makes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, smoke_config
from repro_torch.core import work
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import comm, fsdp, sharding

OUT_DIR = os.path.join(os.path.dirname(__file__),
                       "../../../experiments/dryrun_torch")

# NVIDIA H100 SXM5 80GB datasheet figures, not measurements
CARD = "NVIDIA H100 SXM5 80GB (datasheet)"
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 B/s
LINK_BW = 450e9          # NVLink 4, B/s one direction (900 GB/s both)


# ops that move no bytes: views with no alias annotation, and allocations
# that write nothing
_FREE_OPS = {"_unsafe_view", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided"}


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of t's distinct elements (a broadcast dim counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def op_bytes(func, args, kwargs, out) -> int:
    """An aten op's bytes: its tensor inputs read and its outputs written,
    each once; a view, an allocation and a collective move none here
    (comm.record counts the collectives)."""
    if func.namespace != "aten" or func._opname in _FREE_OPS:
        return 0
    rets = func._schema.returns
    if rets and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in rets):
        return 0
    return sum(_read_bytes(t) for t in tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor))


class _CountOps(TorchDispatchMode):
    """Adds each aten op run outside a CADC unit to the tally."""

    def __init__(self, tally: work.Tally) -> None:
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.tally.depth:
            formula = flop_registry.get(func._overloadpacket)
            self.tally.add_op(
                str(func),
                formula(*args, **kwargs, out_val=out) if formula else 0,
                op_bytes(func, args, kwargs, out))
        return out


@contextlib.contextmanager
def count_cost():
    """Count the work run while open, on any device, and yield its
    core.work.Tally:

      * every aten op, through a TorchDispatchMode: its FLOPs by the
        formulas torch.utils.flop_counter registers (mm, addmm, bmm,
        baddbmm, convolution, SDPA ...), its bytes as its tensor inputs
        read plus its outputs written, views free. An eager, unfused
        count: not XLA's fused "bytes accessed", and never compared with
        it;
      * every CADC product as one unit, its work from its shapes and
        dtypes (core/work.py; kernels/cadc_matmul.py `product_cost`):
        forward 2 M D N FLOPs, x, w and the fp32 y read or written once
        plus the gate K1g writes; backward 4 M D N FLOPs, g, x, w and the
        gate read, dx and dw written. The aten ops inside are not counted
        again; K1g, its plain version and the plain einsum count the same.

    The tally's `units` count the products by kind ("cadc_fwd": K1 / K1g
    launches on the card, "cadc_bwd": K2's), `ops` the aten ops' calls by
    name. Collective ops (c10d) are counted as calls only."""
    with work.open_tally() as tally, _CountOps(tally):
        yield tally


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_token = 6 * n_active if shape.kind == "train" else 2 * n_active
    return float(per_token) * tokens


def active_params(cfg, n_params: int) -> int:
    """MoE: only top-k (+shared) experts are active per token."""
    if cfg.moe.n_experts == 0:
        return n_params
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    return n_params - m.n_experts * per_expert + m.top_k * per_expert


def block_bytes(tree, specs, mesh: mesh_lib.Mesh) -> int:
    """Bytes of one rank's blocks of `tree` under `specs` (each dim
    divided by the sizes of the axes its spec entry names)."""
    sizes = mesh_lib.axis_sizes(mesh)
    leaves = steps_lib._leaves(tree)
    total = 0
    for t, spec in zip(leaves, fsdp._spec_leaves(specs)):
        n = t.numel()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                n //= sizes.get(a, 1) if a is not None else 1
        total += n * t.element_size()
    return total


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of `world` ranks, this process rank 0, whose
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cell_config(arch: str, shape_name: str, smoke: bool, overrides):
    cfg = (smoke_config if smoke else get_config)(arch, **(overrides or {}))
    shape = SHAPES[shape_name]
    return cfg, shape


def _smoke_shape(shape, dp: int, n_micro: int):
    batch = (dp * n_micro if shape.kind == "train"
             else min(shape.global_batch, 8))
    return dataclasses.replace(shape, seq_len=min(shape.seq_len, 128),
                               global_batch=batch)


def _counting(audit: bool):
    return count_cost() if audit else contextlib.nullcontext()


def rank0_train_step(cfg, mesh: mesh_lib.Mesh, batch: Dict[str, Any],
                     n_micro: int, *, audit: bool = False, optimizer=None):
    """Rank 0's train step (steps.make_fsdp_train_step) over `batch`, the
    global batch, in n_micro micros, once, on rank 0's blocks of the fp32
    masters and of AdamW's moments on the meta device, inside an open
    process group of mesh.size ranks (fake_group): (its collectives'
    bytes, its count_cost Tally with `audit` else None, its shards)."""
    params_shape = steps_lib.abstract_params(cfg)
    optimizer = optimizer or steps_lib.make_optimizer(cfg)
    dims = fsdp.data_dims(params_shape, cfg, mesh)
    mdims = fsdp.model_dims(params_shape, cfg, mesh)
    step = steps_lib.make_fsdp_train_step(cfg, mesh, dims,
                                          optimizer=optimizer,
                                          n_micro=n_micro)
    mg = step.mesh_groups
    shards = steps_lib._rebuild(params_shape, [
        fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
        for t, d, md in zip(steps_lib._leaves(params_shape), dims, mdims)])
    opt_state = optimizer.init(shards)
    with comm.record() as coll, _counting(audit) as cost:
        step(shards, opt_state, batch, 0)
    return coll, cost, shards


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             smoke: bool = False, audit: bool = False,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The plan of one cell (module docstring). audit=True: the cost
    audit, as the JAX package's: the step at n_microbatches = 1, over all
    its layers (the port has no scan to unroll), under count_cost, and
    the roofline from the counted FLOPs and bytes."""
    cfg, shape = _cell_config(arch, shape_name, smoke, overrides)
    tag = ("multi" if multi_pod else "single") + ("_audit" if audit else "")
    if shape_name not in cfg.shape_cells():
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "status": "SKIP", "reason": cfg.skip_reasons()[shape_name]}
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    sizes = {a: mesh_lib.axis_size(mesh, a) for a in mesh_lib.AXES}
    dp = sizes["pod"] * sizes["data"]
    if smoke:
        shape = _smoke_shape(shape, dp, 1 if audit else cfg.n_microbatches)
    t0 = time.perf_counter()

    params_shape = steps_lib.abstract_params(cfg)
    n_params = sum(t.numel() for t in steps_lib._leaves(params_shape))
    n_active = active_params(cfg, n_params)
    pspecs = sharding.param_specs(params_shape, cfg, mesh)
    param_bytes = block_bytes(params_shape, pspecs, mesh)
    report: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": tag, "status": "OK",
        "n_chips": mesh.size, "mesh_axes": mesh_lib.axis_sizes(mesh),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_params": n_params, "n_active_params": n_active,
        "tp_fallbacks": tf.tp_fallbacks(cfg, sizes),
        "overrides": dict(overrides or {}),
    }
    memory = {"param_bytes_per_rank": param_bytes}
    if shape.kind == "train":
        optimizer = steps_lib.make_optimizer(cfg)
        opt_bytes = 2 * block_bytes(
            tf.tree_map(lambda t: t.float(), params_shape), pspecs, mesh)
        memory["opt_bytes_per_rank"] = opt_bytes
        with fake_group(mesh.size):
            # every data-parallel rank takes whole rows of each micro: the
            # micros are cut where the config's would give a rank a part
            # of a row (JAX's GSPMD splits such a micro unevenly)
            n_micro = 1 if audit else cfg.n_microbatches
            while shape.global_batch % (n_micro * dp):
                n_micro -= 1
            report["n_micro"] = n_micro
            rows = shape.global_batch // n_micro

            def run(n):
                # rank 0's step over n micros of the cell's micro rows
                batch = steps_lib.input_specs(cfg, dataclasses.replace(
                    shape, global_batch=rows * n))
                return rank0_train_step(cfg, mesh, batch, n, audit=audit,
                                        optimizer=optimizer)

            one, cost, shards = run(1)
            two = run(2)[0] if n_micro > 1 else one
            coll = {k: one[k] + (n_micro - 1) * (two[k] - one[k])
                    for k in one}
            memory["shard_bytes_rank0"] = sum(
                t.numel() * t.element_size()
                for t in steps_lib._leaves(shards))
        state_bytes = 2 * (param_bytes + opt_bytes)
    else:
        decode = shape.kind == "decode"
        with fake_group(mesh.size):
            dims = fsdp.data_dims(params_shape, cfg, mesh)
            mdims = fsdp.model_dims(params_shape, cfg, mesh)
            step = (steps_lib.make_mesh_serve_step(cfg, mesh, dims,
                                                   shape.seq_len)
                    if decode else
                    steps_lib.make_mesh_prefill_step(cfg, mesh, dims))
            mg = step.mesh_groups
            shards = steps_lib._rebuild(params_shape, [
                fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
                for t, d, md in zip(steps_lib._leaves(params_shape), dims,
                                    mdims)])
            inputs = steps_lib.input_specs(cfg, shape)
            if decode:
                caches = steps_lib.abstract_caches(cfg, shape.global_batch,
                                                   shape.seq_len)
                memory["cache_bytes_per_rank"] = block_bytes(
                    caches, sharding.cache_specs(caches, cfg, mesh,
                                                 shape.global_batch), mesh)
                blocks = steps_lib.cache_blocks(caches, cfg, mesh,
                                                shape.global_batch,
                                                mg.coords)
                memory["cache_block_bytes_rank0"] = sum(
                    t.numel() * t.element_size()
                    for t in steps_lib._leaves(blocks))
                with comm.record() as coll, _counting(audit) as cost:
                    step(shards, inputs["tokens"], inputs["position"],
                         blocks)
            else:
                with comm.record() as coll, _counting(audit) as cost:
                    step(shards, inputs)
        report["attention_forms"] = step.attention_forms
        state_bytes = param_bytes + memory.get("cache_bytes_per_rank", 0)
    mflops = model_flops(cfg, shape, n_params, n_active)
    report.update({
        "plan_s": time.perf_counter() - t0,
        "memory": memory,
        "collectives": coll,
        "card": {"name": CARD, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                 "link_bw": LINK_BW},
    })
    if audit:
        report["cost"] = _audit_cost(cost, mflops, mesh.size)
        report["roofline_s"] = _roofline(
            cost.flops, cost.bytes, coll["total"])
    else:
        report["cost"] = {"model_flops": mflops,
                          "model_flops_per_chip": mflops / mesh.size,
                          "least_bytes_per_chip": state_bytes}
        report["roofline_s"] = _roofline(mflops / mesh.size, state_bytes,
                                         coll["total"])
    terms = report["roofline_s"]
    report["bottleneck"] = max(terms, key=terms.get)
    return report


def _roofline(flops: float, nbytes: float, coll_bytes: float) -> dict:
    return {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
            "collective": coll_bytes / LINK_BW}


def _audit_cost(tally: work.Tally, mflops: float, n_chips: int) -> dict:
    """An audit report's "cost": the JAX package's fields without their
    "hlo_" prefix (the port has no HLO; its counts are count_cost's), and
    the tally's CADC units and aten calls."""
    flops_global = tally.flops * n_chips
    return {"flops_per_chip": tally.flops, "bytes_per_chip": tally.bytes,
            "flops_global": flops_global, "model_flops": mflops,
            "useful_ratio": mflops / flops_global if flops_global else None,
            "cadc_units": dict(tally.units),
            "cadc_unit_flops": tally.unit_flops,
            "aten_ops": sum(tally.ops.values())}


def run_cell_audit_diff(arch: str, shape_name: str, *,
                        multi_pod: bool = False, smoke: bool = False,
                        overrides: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The JAX package's differential cost audit: two audited probes under
    the same mesh,

        probe1: n_layers = len(pattern)     (one unit of the pattern)
        probe2: n_layers = 2 * len(pattern) (two units)

    and cost(L) = max(probe1 - per_unit, 0) + per_unit * L / len(pattern),
    per_unit = probe2 - probe1, for the FLOPs, the bytes, every collective
    kind and n_params / n_active_params. Exact where the layers repeat the
    pattern (tests/test_torch_dryrun_audit.py)."""
    cfg_probe = (smoke_config if smoke else get_config)(
        arch, **(overrides or {}))
    p = len(cfg_probe.pattern)
    n_layers = cfg_probe.n_layers

    ov = dict(overrides or {})
    probe1 = run_cell(arch, shape_name, multi_pod, smoke=smoke, audit=True,
                      overrides={**ov, "n_layers": p})
    if probe1["status"] != "OK":
        return probe1
    probe2 = run_cell(arch, shape_name, multi_pod, smoke=smoke, audit=True,
                      overrides={**ov, "n_layers": 2 * p})
    if probe2["status"] != "OK":
        return probe2

    scale = n_layers / p
    rep = dict(probe2)
    rep["mesh"] = ("multi" if multi_pod else "single") + "_audit"
    rep["audit_method"] = f"diff2(unit={p}L, 2unit={2*p}L, scale={scale:.2f})"
    rep["n_params"] = probe1["n_params"] + int(
        (probe2["n_params"] - probe1["n_params"]) * (scale - 1))
    rep["n_active_params"] = probe1["n_active_params"] + int(
        (probe2["n_active_params"] - probe1["n_active_params"]) * (scale - 1))

    def extrap(b1, b2):
        per_unit = b2 - b1
        return max(b1 - per_unit, 0.0) + per_unit * scale

    shape = SHAPES[shape_name]
    if smoke:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        dp = mesh_lib.axis_size(mesh, "pod") * mesh_lib.axis_size(mesh,
                                                                  "data")
        shape = _smoke_shape(shape, dp, 1)
    cost = {}
    for k in ("flops_per_chip", "bytes_per_chip"):
        cost[k] = extrap(probe1["cost"][k], probe2["cost"][k])
    cost["flops_global"] = cost["flops_per_chip"] * rep["n_chips"]
    cost["model_flops"] = model_flops(
        cfg_probe, shape, rep["n_params"],
        active_params(cfg_probe, rep["n_params"]))
    cost["useful_ratio"] = (
        cost["model_flops"] / cost["flops_global"]
        if cost["flops_global"] else None)
    rep["cost"] = cost

    coll = {}
    for k in probe2["collectives"]:
        coll[k] = extrap(probe1["collectives"].get(k, 0.0),
                         probe2["collectives"][k])
    rep["collectives"] = coll
    rep["roofline_s"] = _roofline(cost["flops_per_chip"],
                                  cost["bytes_per_chip"], coll["total"])
    rep["bottleneck"] = max(rep["roofline_s"], key=rep["roofline_s"].get)
    rep["memory"] = {"note": "memory feasibility comes from the production "
                             "(scan) cell; audit memory is the 1-unit probe"}
    return rep


def save_report(report: Dict[str, Any], out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(
        out_dir, f"{report['arch']}__{report['shape']}__{report['mesh']}.json")
    with open(fn, "w") as f:
        json.dump(report, f, indent=2)
    return fn


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--audit", action="store_true",
                    help="cost audit: one micro, every op counted")
    ap.add_argument("--audit-diff", action="store_true",
                    help="differential cost audit (1-unit + 2-unit probes)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    reports = []
    torch.set_grad_enabled(True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                try:
                    if args.audit_diff:
                        rep = run_cell_audit_diff(arch, shape, multi_pod=mp,
                                                  smoke=args.smoke,
                                                  overrides=overrides)
                    else:
                        rep = run_cell(arch, shape, mp, smoke=args.smoke,
                                       audit=args.audit, overrides=overrides)
                    fn = save_report(rep, args.out)
                    if rep["status"] == "SKIP":
                        print(f"[SKIP] {tag}: {rep['reason']}", flush=True)
                    else:
                        r = rep["roofline_s"]
                        forms = "".join(
                            f" {k}={v}" for k, v in
                            rep.get("attention_forms", {}).items())
                        ratio = rep["cost"].get("useful_ratio")
                        ratio = (f" useful_ratio={ratio:.3f}"
                                 if ratio is not None else "")
                        print(f"[OK]   {tag}: plan={rep['plan_s']:.1f}s "
                              f"bottleneck={rep['bottleneck']}{ratio} "
                              f"compute={r['compute']:.3e}s "
                              f"memory={r['memory']:.3e}s "
                              f"coll={r['collective']:.3e}s{forms} "
                              f"-> {fn}", flush=True)
                except Exception:
                    print(f"[FAIL] {tag}", flush=True)
                    traceback.print_exc()
                    audit = args.audit or args.audit_diff
                    rep = {"arch": arch, "shape": shape,
                           "mesh": ("multi" if mp else "single")
                           + ("_audit" if audit else ""),
                           "status": "FAIL",
                           "error": traceback.format_exc()[-2000:]}
                    save_report(rep, args.out)
                reports.append(rep)
    return reports


if __name__ == "__main__":
    main()
