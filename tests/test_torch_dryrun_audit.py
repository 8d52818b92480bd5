"""The dry run's cost audit (repro_torch.launch.dryrun --audit /
--audit-diff) and its work counter (count_cost, core/work.py) on the CPU.

  * a CADC product is one unit of work on every route: a CADC linear
    (layers.linear_apply's plain einsum), kernels/ops.cadc_matmul's plain
    route (K1g's and K2's plain versions under CadcMatmulFn), a TP row
    linear over core.cadc.cadc_einsum_segments and cadc_einsum_segments
    alone count 2 M D N FLOPs forward and 4 M D N backward, the bytes
    worked out here by hand; each kernel wrapper carries its plain
    version's unit;
  * a smoke gemma3-1b train step at (data 1, model 1) counts the same
    FLOPs, bytes, units and aten ops, op for op, on real CPU tensors over
    gloo as on the meta device under the fake process group;
  * --audit-diff equals --audit at full depth, exactly, in FLOPs, bytes
    and every collective kind, for a train and a decode cell of
    recurrentgemma-9b smoke at 3 units of its pattern;
  * run_cell_audit_diff's extrapolation, n_params and useful_ratio equal
    the JAX package's function on the same two probes (its run_cell
    replaced by the probes; JAX in a subprocess, since repro.launch.dryrun
    sets XLA_FLAGS when imported; the roofline terms are left out: the
    card constants differ);
  * the CLI writes *_audit.json reports under --out.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.core import cadc as cadc_lib
from repro_torch.core import work
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp, tp_cadc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# x [2, 3, 64] (M = 6), D = 64 in 2 segments of 32, N = 40 (2 gate words)
M, D, N, XBAR = 6, 64, 40, 32
GATE = (D // XBAR) * M * 2 * 4                    # packed: int32 words
FWD = (2 * M * D * N, 4 * (M * D + D * N) + 4 * M * N + GATE)
BWD = (4 * M * D * N,
       4 * (M * N + M * D + D * N) + GATE + 4 * M * D + 4 * D * N)


# The same product on bf16 operands: the forward reads bf16 x and w, and
# K2 on its tensor-core route (bf16, relu's gate, XBAR a multiple of 16)
# reads the bf16 g, x and w as they are; dx and dw are written in fp32.
FWD16 = (FWD[0], 2 * (M * D + D * N) + 4 * M * N + GATE)
BWD16 = (BWD[0],
         2 * (M * N + M * D + D * N) + GATE + 4 * M * D + 4 * D * N)


def _operands(dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, D, generator=gen).to(dtype).requires_grad_()
    w = torch.randn(D // XBAR, XBAR, N, generator=gen).to(
        dtype).requires_grad_()
    return x, w


def _linear(x, w):
    cfg = smoke_config("gemma3_1b", linear_impl="cadc", crossbar_size=XBAR,
                       dendritic_fn="relu", dtype=str(x.dtype)[6:])
    return ll.linear_apply({"w": w}, x, cfg)


def _ops_route(x, w):
    return kops.cadc_matmul(x, w.reshape(D, N), crossbar_size=XBAR,
                            fn="relu", impl="torch")


def _tp_row(x, w):
    with dryrun.fake_group(1):
        return tp_cadc.tp_cadc_row_linear(x, w, group=dist.group.WORLD,
                                          fn="relu")


def _segments(x, w):
    return cadc_lib.cadc_einsum_segments(x.reshape(2, 3, D // XBAR, XBAR),
                                         w, "relu")


@pytest.mark.parametrize("route", [_linear, _ops_route, _tp_row, _segments],
                         ids=["linear_apply", "ops_torch", "tp_row_linear",
                              "einsum_segments"])
def test_one_cadc_product_is_one_unit_each_way(route):
    x, w = _operands()
    with dryrun.count_cost() as tally:
        y = route(x, w)
        assert dict(tally.units) == {"cadc_fwd": 1}
        assert (tally.unit_flops, tally.unit_bytes) == FWD
        y.square().sum().backward()
    assert dict(tally.units) == {"cadc_fwd": 1, "cadc_bwd": 1}
    assert (tally.unit_flops, tally.unit_bytes) == (FWD[0] + BWD[0],
                                                    FWD[1] + BWD[1])
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    # no aten op of the product itself is counted again
    assert not any(k.startswith(("aten.bmm", "aten.mm"))
                   for k in tally.ops)


@pytest.mark.parametrize("route", [_linear, _ops_route, _tp_row, _segments],
                         ids=["linear_apply", "ops_torch", "tp_row_linear",
                              "einsum_segments"])
def test_one_bf16_cadc_product_counts_the_bf16_route(route):
    """On bf16 operands every route counts FWD16 / BWD16: K2's bytes those
    of the route its kernel rule (`cm.bwd_kernel`) picks."""
    x, w = _operands(torch.bfloat16)
    with dryrun.count_cost() as tally:
        y = route(x, w)
        assert dict(tally.units) == {"cadc_fwd": 1}
        assert (tally.unit_flops, tally.unit_bytes) == FWD16
        y.float().square().sum().backward()
    assert dict(tally.units) == {"cadc_fwd": 1, "cadc_bwd": 1}
    assert (tally.unit_flops, tally.unit_bytes) == (FWD16[0] + BWD16[0],
                                                    FWD16[1] + BWD16[1])
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16


def test_k2_counts_its_routes_bytes():
    """K2's plain version counts, as its kernel would run: bf16 reads
    under relu's packed gate (the tensor-core route), fp32 under
    sublinear's fp32 byte gate (the CUDA-core route on fp32 copies)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(M, D, generator=gen)
    w = torch.randn(D, N, generator=gen)
    g = torch.randn(M, N, generator=gen)
    kw = dict(crossbar_size=XBAR)
    _, packed = cm.cadc_matmul_gate_torch(x, w, fn="relu", mode="packed",
                                          **kw)
    _, sub = cm.cadc_matmul_gate_torch(x, w, fn="sublinear", mode="bytes",
                                       **kw)
    bf = [t.to(torch.bfloat16) for t in (g, x, w)]
    assert cm.bwd_kernel(torch.bfloat16, "packed", "relu", XBAR) == "mma"
    assert cm.bwd_kernel(torch.bfloat16, "bytes", "sublinear", XBAR) == (
        "tile")
    with dryrun.count_cost() as tally:
        cm.cadc_segmented_bwd_torch(*bf, packed, fn="relu", mode="packed",
                                    **kw)
        assert (tally.unit_flops, tally.unit_bytes) == BWD16
        cm.cadc_segmented_bwd_torch(*bf, sub, fn="sublinear", mode="bytes",
                                    **kw)
        assert tally.unit_bytes == BWD16[1] + BWD[1] - GATE + sub.nbytes
    assert dict(tally.units) == {"cadc_bwd": 2}
    assert set(tally.ops) == set()


def test_counted_route_is_the_plain_one_bitwise():
    x, w = _operands()
    want = _linear(x, w)
    gx, gw = torch.autograd.grad(want.square().sum(), (x, w))
    with dryrun.count_cost():
        got = _linear(x, w)
        hx, hw = torch.autograd.grad(got.square().sum(), (x, w))
    for a, b in ((want, got), (gx, hx), (gw, hw)):
        assert torch.equal(a, b)


def test_kernels_carry_their_plain_versions_units():
    for cuda, plain in ((cm.cadc_matmul_cuda, cm.cadc_matmul_torch),
                        (cm.cadc_matmul_gate_cuda, cm.cadc_matmul_gate_torch),
                        (cm.cadc_segmented_bwd_cuda,
                         cm.cadc_segmented_bwd_torch)):
        assert cuda.unit == plain.unit
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(M, D, generator=gen)
    w = torch.randn(D, N, generator=gen)
    g = torch.randn(M, N, generator=gen)
    kw = dict(crossbar_size=XBAR, fn="relu")
    k1 = (FWD[0], FWD[1] - GATE)
    with dryrun.count_cost() as tally:
        cm.cadc_matmul_torch(x, w, **kw)
        assert (tally.unit_flops, tally.unit_bytes) == k1
        _, gate = cm.cadc_matmul_gate_torch(x, w, mode="packed", **kw)
        assert tally.unit_bytes == k1[1] + FWD[1]
        assert gate.numel() * gate.element_size() == GATE
        cm.cadc_segmented_bwd_torch(g, x, w, gate, mode="packed", **kw)
        assert (tally.unit_flops, tally.unit_bytes) == (
            k1[0] + FWD[0] + BWD[0], k1[1] + FWD[1] + BWD[1])
        with torch.no_grad():
            _segments(x.reshape(2, 3, D), w.reshape(D // XBAR, XBAR, N))
    assert dict(tally.units) == {"cadc_fwd": 3, "cadc_bwd": 1}
    assert tally.unit_flops == 2 * k1[0] + FWD[0] + BWD[0]
    # outside the units only this test's reshapes, views: no bytes
    assert set(tally.ops) == {"aten.view.default"}
    assert (tally.flops, tally.bytes) == (tally.unit_flops, tally.unit_bytes)
    # the kernels' cost functions on the same arguments
    assert cm.cadc_matmul_cuda.unit[1](x, w, **kw) == k1
    assert cm.cadc_matmul_gate_cuda.unit[1](x, w, mode="packed", **kw) == FWD
    assert cm.cadc_segmented_bwd_cuda.unit[1](g, x, w, gate, mode="packed",
                                              **kw) == BWD


def test_no_tally_no_unit():
    x, w = _operands()
    y = _linear(x, w)
    assert work._ACTIVE is None
    assert type(y.grad_fn).__name__ != "_ProductBackward"


def _smoke_step_tally(dev: str) -> work.Tally:
    """One smoke gemma3-1b train step (CADC relu at crossbar 32, remat,
    2 micros of 2 x 16 tokens) at (data 1, model 1) under count_cost."""
    cfg = smoke_config("gemma3_1b", linear_impl="cadc", crossbar_size=32,
                       n_microbatches=2)
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    shape = steps.abstract_params(cfg)
    dims = fsdp.data_dims(shape, cfg, mesh)
    mdims = fsdp.model_dims(shape, cfg, mesh)
    opt = steps.make_optimizer(cfg)
    step = steps.make_fsdp_train_step(cfg, mesh, dims, optimizer=opt,
                                      n_micro=2)
    params = (shape if dev == "meta"
              else tf.init(cfg, seed=0, device=torch.device(dev)))
    mg = step.mesh_groups
    shards = steps._rebuild(params, [
        fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
        for t, d, md in zip(steps._leaves(params), dims, mdims)])
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           dtype=torch.int32).to(dev)
    state = opt.init(shards)
    with dryrun.count_cost() as tally:
        step(shards, state, {"tokens": tokens, "labels": tokens}, 0)
    return tally


def test_smoke_step_counts_the_same_on_cpu_and_meta():
    with dryrun.fake_group(1):
        meta = _smoke_step_tally("meta")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cpu = _smoke_step_tally("cpu")
    finally:
        dist.destroy_process_group()
    assert meta.summary() == cpu.summary()
    # 7 linears a layer x 6 layers x 2 micros; twice forward under remat
    assert dict(cpu.units) == {"cadc_fwd": 2 * 84, "cadc_bwd": 84}
    assert cpu.flops > cpu.unit_flops > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_audit_diff_equals_the_full_audit(shape):
    """recurrentgemma-9b smoke at 9 layers (3 units of its 3-layer
    pattern): the probes at 3 and 6 layers extrapolate to the 9-layer
    audit exactly (every layer of a unit does the same work, and so does
    every unit: integer counts, scale 3.0)."""
    ov = {"linear_impl": "cadc", "n_layers": 9}
    full = dryrun.run_cell("recurrentgemma_9b", shape, False, smoke=True,
                           audit=True, overrides=ov)
    diff = dryrun.run_cell_audit_diff("recurrentgemma_9b", shape,
                                      smoke=True, overrides=ov)
    assert full["status"] == diff["status"] == "OK"
    assert diff["audit_method"] == "diff2(unit=3L, 2unit=6L, scale=3.00)"
    for k in ("flops_per_chip", "bytes_per_chip", "flops_global",
              "model_flops", "useful_ratio"):
        assert diff["cost"][k] == full["cost"][k], k
    assert diff["collectives"] == full["collectives"]
    assert full["collectives"]["total"] > 0
    assert (diff["n_params"], diff["n_active_params"]) == (
        full["n_params"], full["n_active_params"])
    assert full["mesh"] == diff["mesh"] == "single_audit"
    assert full["cost"]["cadc_units"]["cadc_fwd"] > 0


JAX_SIDE = """
import json, sys
from repro.launch import dryrun
probes = json.loads(sys.argv[1])
def fake(arch, shape_name, multi_pod, audit=False, overrides=None, **_):
    return probes[str(overrides["n_layers"])]
dryrun.run_cell = fake
out = {}
for arch, p in json.loads(sys.argv[2]).items():
    for shape in ("train_4k", "decode_32k"):
        rep = dryrun.run_cell_audit_diff(arch, shape)
        out[arch + "/" + shape] = {k: rep[k] for k in (
            "mesh", "audit_method", "n_params", "n_active_params", "cost",
            "collectives", "memory")}
print(json.dumps(out))
"""


def _probe(n_layers: int, jax_names: bool) -> dict:
    """A synthetic audited probe, linear in its layers but for the bytes,
    whose base would go negative (the extrapolation's max(.., 0))."""
    flops = 1.0e12 + 3.0e11 * n_layers
    nbytes = 1.0e9 * (1 + 2 * (n_layers > 3))
    coll = {"all-gather": 4e8 + 1e8 * n_layers, "all-reduce": 7e7 * n_layers,
            "reduce-scatter": 2e8 + 5e7 * n_layers}
    if jax_names:
        coll.update({"all-to-all": 0.0, "collective-permute": 0.0})
    coll["total"] = sum(coll.values())
    prefix = "hlo_" if jax_names else ""
    return {"status": "OK", "n_chips": 256, "mesh": "single_audit",
            "n_params": 10_000_000 + 3_000_000 * n_layers,
            "n_active_params": 9_000_000 + 2_500_000 * n_layers,
            "cost": {f"{prefix}flops_per_chip": flops,
                     f"{prefix}bytes_per_chip": nbytes},
            "collectives": coll}


def test_audit_diff_matches_jax(monkeypatch):
    archs = {"gemma3_1b": 6, "recurrentgemma_9b": 3, "xlstm_13b": 8,
             "mixtral_8x22b": 1}
    layers = sorted({n for p in archs.values() for n in (p, 2 * p)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", JAX_SIDE,
         json.dumps({str(n): _probe(n, True) for n in layers}),
         json.dumps(archs)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, overrides, **k: _probe(
                            overrides["n_layers"], False))
    for key, jax in want.items():
        arch, shape = key.split("/")
        got = dryrun.run_cell_audit_diff(arch, shape)
        for k in ("mesh", "audit_method", "n_params", "n_active_params",
                  "memory"):
            assert got[k] == jax[k], (key, k)
        for k in ("flops_per_chip", "bytes_per_chip", "flops_global"):
            assert got["cost"][k] == jax["cost"]["hlo_" + k], (key, k)
        for k in ("model_flops", "useful_ratio"):
            assert got["cost"][k] == pytest.approx(jax["cost"][k],
                                                   rel=1e-12), (key, k)
        for k, v in got["collectives"].items():
            assert v == jax["collectives"][k], (key, k)


def test_cli_writes_audit_reports(tmp_path, capsys):
    args = ["--arch", "phi4_mini_38b", "--shape", "train_4k", "--smoke",
            "--override", "linear_impl=cadc", "--out", str(tmp_path)]
    for mode in ("--audit", "--audit-diff"):
        (rep,) = dryrun.main(args + [mode])
        assert rep["status"] == "OK", rep.get("error")
        fn = tmp_path / "phi4_mini_38b__train_4k__single_audit.json"
        saved = json.loads(fn.read_text())
        assert saved["cost"]["flops_per_chip"] > 0
        assert 0 < saved["cost"]["useful_ratio"] < 1
        assert saved["bottleneck"] in saved["roofline_s"]
        assert ("audit_method" in saved) == (mode == "--audit-diff")
    assert capsys.readouterr().out.count("[OK]") == 2
