"""The dry-run twin (repro_torch.launch.dryrun) on the CPU, with no card.

  * a smoke train cell on each production mesh (256 and 512 ranks under
    torch's fake process group, rank 0's step on the meta device): the
    step runs, its collectives are recorded, and rank 0's blocks hold the
    bytes the rules give a rank; the bytes extrapolated from one micro and
    two equal a three-micro step's; a skipped cell on each mesh;
  * a smoke prefill and decode cell on each mesh: rank 0's serving step
    runs, its collectives are recorded, each attention kind takes the form
    the cache rule implies (gemma3-1b length-parallel, gemma-7b
    head-parallel at full width on (16, 16)), rank 0's cache blocks hold
    the rules' bytes, and long_500k's batch of 1 is every rank's;
  * n_params, n_active_params and model_flops equal to the JAX package's
    dry run for every architecture and shape at full width (JAX's
    repro.launch.dryrun sets XLA_FLAGS when imported, so its side runs in
    a subprocess);
  * for every architecture at full width on both meshes, the per-rank
    parameter bytes (block_bytes over the rules' specs) equal the bytes
    of rank 0's blocks cut by fsdp.mesh_block;
  * --override seq_sharding=True: a train cell's activation all-reduces
    over "model" become reduce-scatters and all-gathers of equal ring
    bytes, the norms' gradient sums added (and, under remat, one
    all-gather a layer); prefill and decode cells report as without it;
    recurrentgemma-9b's train cell gathers none of its RG-LRU leaves over
    "model".
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.lm import layers as ll
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp, sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SIDE = """
import json
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun
from repro.launch import steps as steps_lib
import jax, numpy as np
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    shape = steps_lib.abstract_params(cfg)
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shape))
    act = dryrun.active_params(cfg, n)
    out[arch] = {"n_params": n, "n_active_params": act,
                 "model_flops": {s: dryrun.model_flops(cfg, SHAPES[s], n, act)
                                 for s in SHAPES}}
print(json.dumps(out))
"""


@pytest.mark.parametrize("multi_pod", [False, True])
def test_smoke_train_cell_runs_rank0s_step(multi_pod):
    rep = dryrun.run_cell("gemma3_1b", "train_4k", multi_pod, smoke=True)
    assert not dist.is_initialized()
    assert rep["status"] == "OK"
    assert rep["n_chips"] == (512 if multi_pod else 256)
    mem = rep["memory"]
    assert mem["shard_bytes_rank0"] == mem["param_bytes_per_rank"] > 0
    assert mem["opt_bytes_per_rank"] == 2 * mem["param_bytes_per_rank"]
    coll = rep["collectives"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0
    assert coll["total"] == sum(coll[k] for k in dryrun.comm.KINDS)
    assert rep["bottleneck"] in rep["roofline_s"]
    assert rep["global_batch"] == (32 if multi_pod else 16)


def test_micros_extrapolate_exactly():
    """The cell's bytes (rank 0's step over one micro and over two) equal
    rank 0's step over all three micros, recorded directly."""
    rep = dryrun.run_cell("gemma3_1b", "train_4k", False, smoke=True,
                          overrides={"n_microbatches": 3})
    assert rep["n_micro"] == 3
    cfg = dryrun._cell_config("gemma3_1b", "train_4k", True,
                              {"n_microbatches": 3})[0]
    mesh = mesh_lib.make_production_mesh()
    shape = steps.abstract_params(cfg)
    opt = steps.make_optimizer(cfg)
    with dryrun.fake_group(mesh.size):
        dims = fsdp.data_dims(shape, cfg, mesh)
        mdims = fsdp.model_dims(shape, cfg, mesh)
        step = steps.make_fsdp_train_step(cfg, mesh, dims, optimizer=opt,
                                          n_micro=3)
        mg = step.mesh_groups
        shards = steps._rebuild(shape, [
            fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
            for t, d, md in zip(steps._leaves(shape), dims, mdims)])
        batch = steps.input_specs(cfg, dataclasses.replace(
            SHAPES["train_4k"], seq_len=128, global_batch=48))
        with dryrun.comm.record() as direct:
            step(shards, opt.init(shards), batch, 0)
    assert rep["global_batch"] == 48 and rep["seq_len"] == 128
    assert rep["collectives"] == pytest.approx(direct, rel=1e-12)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_skipped_cell(multi_pod):
    rep = dryrun.run_cell("gemma_7b", "long_500k", multi_pod)
    assert rep["status"] == "SKIP"
    assert rep["reason"] == get_config("gemma_7b").skip_reasons()["long_500k"]
    enc = dryrun.run_cell("hubert_xlarge", "decode_32k", multi_pod)
    assert enc["status"] == "SKIP" and "encoder" in enc["reason"]


def test_decode_cell_reports_the_rules_bytes():
    """The decode cell runs rank 0's serve step: its collectives are
    recorded, and rank 0's cache blocks hold the bytes the cache rule
    gives a rank."""
    rep = dryrun.run_cell("gemma3_1b", "decode_32k", False, smoke=True)
    assert not dist.is_initialized()
    assert rep["status"] == "OK" and rep["collectives"] is not None
    assert rep["collectives"]["all-gather"] > 0
    assert rep["roofline_s"]["collective"] > 0
    mem = rep["memory"]
    assert mem["cache_bytes_per_rank"] == mem["cache_block_bytes_rank0"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_prefill_cell_runs_rank0s_step(multi_pod):
    rep = dryrun.run_cell("qwen2_moe_a27b", "prefill_32k", multi_pod,
                          smoke=True)
    assert not dist.is_initialized()
    assert rep["status"] == "OK" and rep["collectives"]["total"] > 0
    assert rep["attention_forms"] == {"global": "replicated"}
    assert "cache_bytes_per_rank" not in rep["memory"]


@pytest.mark.parametrize("arch, want", [
    ("gemma3_1b", {"global": "length-parallel", "local": "length-parallel"}),
    ("gemma_7b", {"global": "head-parallel"})])
def test_decode_cell_takes_the_cache_rules_form(arch, want):
    """At full width on (16, 16): gemma3-1b's one kv head does not divide
    16, its rings of 32768 and 512 do (length-parallel); gemma-7b's 16 kv
    heads divide (head-parallel). The forms are those cache_specs
    implies; rank 0's cache blocks hold the rules' bytes."""
    rep = dryrun.run_cell(arch, "decode_32k", False)
    assert rep["status"] == "OK" and rep["attention_forms"] == want
    assert rep["collectives"]["total"] > 0
    mem = rep["memory"]
    assert mem["cache_bytes_per_rank"] == mem["cache_block_bytes_rank0"] > 0
    cfg = get_config(arch)
    caches = steps.abstract_caches(cfg, 128, 32768)
    specs = sharding.cache_specs(caches, cfg,
                                 mesh_lib.make_production_mesh(), 128)
    forms = {kind: {(None, "model"): "head-parallel",
                    ("model", None): "length-parallel"}[spec.k[1:3]]
             for kind, spec in zip(cfg.pattern_for_layers, specs)}
    assert forms == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_500k_batch_of_one_is_replicated_over_dp(multi_pod):
    """long_500k's batch of 1 does not divide the data-parallel ranks:
    every rank holds (and runs) the one row, so a rank's cache block is
    its "model" block of the whole batch."""
    rep = dryrun.run_cell("gemma3_1b", "long_500k", multi_pod, smoke=True)
    assert rep["status"] == "OK" and rep["global_batch"] == 1
    cfg = dryrun._cell_config("gemma3_1b", "long_500k", True, None)[0]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    caches = steps.abstract_caches(cfg, 1, rep["seq_len"])
    specs = sharding.cache_specs(caches, cfg, mesh, 1)
    assert all(spec.k[0] is None for spec in specs)
    whole = sum(t.numel() * t.element_size() for t in steps._leaves(caches))
    mem = rep["memory"]
    assert mem["cache_bytes_per_rank"] == mem["cache_block_bytes_rank0"] \
        == whole // 16


@pytest.fixture(scope="module")
def jax_counts():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", JAX_SIDE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_flops_match_jax(arch, jax_counts):
    cfg = get_config(arch)
    n = sum(t.numel() for t in steps._leaves(steps.abstract_params(cfg)))
    act = dryrun.active_params(cfg, n)
    want = jax_counts[arch]
    assert n == want["n_params"]
    assert act == want["n_active_params"]
    for s in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[s], n, act) \
            == want["model_flops"][s]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_param_bytes_are_the_rules_blocks(arch):
    cfg = get_config(arch, linear_impl="cadc")
    shape = steps.abstract_params(cfg)
    for multi_pod in (False, True):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        sizes = {a: mesh_lib.axis_size(mesh, a) for a in mesh_lib.AXES}
        coords = {a: 0 for a in mesh_lib.AXES}
        want = sum(
            fsdp.mesh_block(t, d, md, coords, sizes).numel() * 4
            for t, d, md in zip(steps._leaves(shape),
                                fsdp.data_dims(shape, cfg, mesh),
                                fsdp.model_dims(shape, cfg, mesh)))
        got = dryrun.block_bytes(shape, sharding.param_specs(shape, cfg,
                                                             mesh), mesh)
        assert got == want
        assert 0 < got < 4 * sum(t.numel() for t in steps._leaves(shape))


def _norm_ar_bytes(cfg, mesh, n_micro):
    """The bytes a rank's step all-reduces over "model" for the norms'
    gradients, summed under sequence parallelism: each norm leaf in the
    compute dtype, 2 x its bytes x (T - 1) / T a micro."""
    t = mesh_lib.axis_size(mesh, "model")
    size = ll.cdtype(cfg).itemsize if cfg.bf16_wire else 4
    n = sum(leaf.numel() for names, leaf in
            tf._leaf_paths(steps.abstract_params(cfg))
            if names[-1] == "scale" and (names[0] == "final_norm"
                                         or names[2] in ("ln1", "ln2")))
    return n_micro * 2 * n * size * (t - 1) / t


@pytest.mark.parametrize("remat", [False, True])
def test_seq_sharding_trades_each_all_reduce_for_rs_and_ag(remat):
    """gemma3-1b smoke with 16 heads (every part split over the model axis
    of 16) on the production mesh: under seq_sharding the activations'
    all-reduces over "model" become reduce-scatters and all-gathers of
    equal ring bytes, and the norms' gradient sums are the only bytes
    added; with remat on, each layer's recompute also re-gathers the FFN's
    input (copy_to's forward moves nothing), one all-gather of the
    micro's [b, S, d] a layer."""
    over = {"n_heads": 16, "n_kv_heads": 16, "remat": remat}
    base = dryrun.run_cell("gemma3_1b", "train_4k", False, smoke=True,
                           overrides=over)
    sp = dryrun.run_cell("gemma3_1b", "train_4k", False, smoke=True,
                         overrides=dict(over, seq_sharding=True))
    assert sp["overrides"]["seq_sharding"] is True
    a, b = base["collectives"], sp["collectives"]
    cfg = dryrun._cell_config("gemma3_1b", "train_4k", True, over)[0]
    mesh = mesh_lib.make_production_mesh()
    norms = _norm_ar_bytes(cfg, mesh, sp["n_micro"])
    assert b["all-reduce"] < a["all-reduce"] / 10
    moved = a["all-reduce"] + norms - b["all-reduce"]
    extra = 0.0
    if remat:
        t = mesh_lib.axis_size(mesh, "model")
        rows = sp["global_batch"] // (sp["n_micro"] * 16)
        extra = (sp["n_micro"] * cfg.n_layers * rows * sp["seq_len"]
                 * cfg.d_model * 4 * (t - 1) / t)
    assert b["all-gather"] + b["reduce-scatter"] - a["all-gather"] \
        - a["reduce-scatter"] == pytest.approx(moved + extra, rel=1e-12)
    assert b["total"] - a["total"] == pytest.approx(norms + extra,
                                                    rel=1e-12)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_seq_sharding_serve_cells_report_as_without_it(shape):
    reps = [dryrun.run_cell("gemma3_1b", shape, False, smoke=True,
                            overrides=ov)
            for ov in ({}, {"seq_sharding": True})]
    for r in reps:
        del r["plan_s"], r["overrides"]
    assert reps[0] == reps[1]


def test_rglru_leaves_are_not_gathered_over_model(monkeypatch):
    """recurrentgemma-9b smoke's train cell (rnn_width 64 over a model
    axis of 16): the step's leaf gathers move less by exactly the RG-LRU
    leaves' all-gathers over "model" than with the block run whole
    (rglru.channels_split off: the plan before the channel-parallel
    form)."""
    from repro_torch.models.lm import rglru

    real, tallies = steps._gather_leaves, []

    def gather(*a, **k):
        with dryrun.comm.record() as tally:
            out = real(*a, **k)
        tallies.append(tally["all-gather"])
        return out

    monkeypatch.setattr(steps, "_gather_leaves", gather)
    now = dryrun.run_cell("recurrentgemma_9b", "train_4k", False, smoke=True)
    calls, moved = len(tallies), sum(tallies)
    monkeypatch.setattr(rglru, "channels_split", lambda *a, **k: False)
    del tallies[:]
    dryrun.run_cell("recurrentgemma_9b", "train_4k", False, smoke=True)
    assert len(tallies) == calls and now["status"] == "OK"
    cfg = dryrun._cell_config("recurrentgemma_9b", "train_4k", True, None)[0]
    mesh = mesh_lib.make_production_mesh()
    shape = steps.abstract_params(cfg)
    rec = sum(leaf.numel() for (names, leaf), md in zip(
        tf._leaf_paths(shape), fsdp.model_dims(shape, cfg, mesh))
        if names[0] == "layers" and names[2] == "rec" and md is not None)
    assert rec > 0
    assert sum(tallies) - moved == pytest.approx(
        calls * rec * 4 * 15 / 16, rel=1e-12)
