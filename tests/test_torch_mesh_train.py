"""The data-parallel (FSDP) train step and the mesh form of the train CLI,
on the CPU over gloo.

  * steps.make_fsdp_train_step over 2 and 4 ranks (spawned processes)
    against steps.make_train_step on one process, the same global batches
    and n_micro, 3 steps, on the smoke configs of gemma3-1b, qwen2-moe-a2.7b
    (its MoE routes over the whole micro) and xlstm-1.3b, all with CADC
    linears. AdamW at a constant lr of 1e-4 with make_optimizer's weight
    decay and clip (the parameters move ~3e-4, well past the bound). Bounds:
    fp32 (dtype float32, bf16_wire off) losses within 1e-6 relative and
    the parameters within 1e-5 of their scale — the ranks add the loss and
    the gradients in another order (a sum over ranks of their rows' sums),
    so fp32 rounding differs; bf16 (dtype bfloat16, bf16_wire on: bf16
    gathers and gradient reductions) losses within 1e-3 relative;
  * at one rank the step is make_train_step's, bitwise (fp32 and bf16);
  * the CLI under torch.distributed.run (--standalone, 2 ranks, --device
    cpu): a run resumed from the step-2 checkpoint of an unbroken run
    writes that run's step-4 checkpoint bitwise; the world-2 checkpoint restores at worlds 1
    and 4 with every shard bitwise the saved leaf's block under the new
    mesh's rules; --production-mesh refuses a world other than 256; the
    step refuses sequence parallelism under a model axis, a mesh the group
    does not fit and a batch its ranks do not divide.

Every spawn and subprocess has its own timeout (run_ranks: 120 s; the CLI:
120 s), so a hung collective fails one test.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_ranks
from repro_torch import ckpt as tckpt
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp
from repro_torch.train import optimizer as opt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma3_1b", "qwen2_moe_a27b", "xlstm_13b"]
DTYPES = {"fp32": dict(dtype="float32", bf16_wire=False),
          "bf16": dict(dtype="bfloat16", bf16_wire=True)}
N_MICRO, B, S, STEPS, LR = 2, 8, 16, 3, 1e-4
LOSS_RTOL = {"fp32": 1e-6, "bf16": 1e-3}
PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch, dt):
    return smoke_config(arch, linear_impl="cadc", **DTYPES[dt])


def _optimizer():
    return opt_lib.adamw(LR, weight_decay=0.1, max_grad_norm=1.0)


def _batches(cfg):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S + 1)))
        out.append({"tokens": toks[:, :-1].long(),
                    "labels": toks[:, 1:].long()})
    return out


def _reference(arch, dt):
    """make_train_step on one process: (losses, parameter leaves)."""
    cfg = _cfg(arch, dt)
    opt = _optimizer()
    step = steps.make_train_step(cfg, opt, n_micro=N_MICRO)
    p = tf.init(cfg, seed=0, device="cpu")
    s = opt.init(p)
    losses = []
    for i, batch in enumerate(_batches(cfg)):
        p, s, m = step(p, s, batch, i)
        losses.append(float(m["loss"]))
    return losses, [t.numpy() for t in steps._leaves(p)]


def _fsdp_run(rank, world, cfg):
    """make_fsdp_train_step over the group: (losses, the parameters
    gathered back whole, this rank's shard count)."""
    opt = _optimizer()
    full = tf.init(cfg, seed=0, device="cpu")
    mesh = mesh_lib.make_local_mesh(world)
    dims = fsdp.data_dims(full, cfg, mesh)
    shards = [fsdp.shard(t, d, rank, world)
              for t, d in zip(steps._leaves(full), dims)]
    p = steps._rebuild(full, shards)
    s = opt.init(p)
    step = steps.make_fsdp_train_step(cfg, mesh, dims, optimizer=opt,
                                      n_micro=N_MICRO)
    losses = []
    for i, batch in enumerate(_batches(cfg)):
        p, s, m = step(p, s, batch, i)
        losses.append(float(m["loss"]))
    whole = [fsdp.gather(t, d).numpy() for t, d in zip(steps._leaves(p),
                                                       dims)]
    return losses, whole, sum(d is not None for d in dims)


def fsdp_rank(rank, world):
    return {(arch, dt): _fsdp_run(rank, world, _cfg(arch, dt))
            for arch in ARCHS for dt in DTYPES}


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """Every config and dtype over 2 and 4 ranks: one spawn a world."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(fsdp_rank, world,
                                    tmp_path_factory.mktemp("fsdp"))
        return runs[world]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_matches_the_single_process_step(arch, world, fsdp_runs):
    outs = [{dt: o[arch, dt] for dt in DTYPES} for o in fsdp_runs(world)]
    for dt in DTYPES:
        want_losses, want_params = _reference(arch, dt)
        init = [t.numpy() for t in steps._leaves(
            tf.init(_cfg(arch, dt), seed=0, device="cpu"))]
        for losses, params, n_sharded in (o[dt] for o in outs):
            assert n_sharded > 0             # the rules shard some leaves
            np.testing.assert_allclose(losses, want_losses,
                                       rtol=LOSS_RTOL[dt], atol=0)
            if dt == "fp32":
                for got, want, p0 in zip(params, want_params, init):
                    scale = max(1.0, float(np.abs(want).max()))
                    assert np.abs(got - want).max() <= PARAM_TOL * scale
                moved = max(float(np.abs(w - p).max())
                            for w, p in zip(want_params, init))
                assert moved > 10 * PARAM_TOL
        # every rank holds the same whole model and reports the same loss
        for o in outs[1:]:
            assert o[dt][0] == outs[0][dt][0]
            assert all(np.array_equal(a, b)
                       for a, b in zip(o[dt][1], outs[0][dt][1]))


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_one_rank_is_the_single_process_step_bitwise(dt, one_rank_group):
    losses, whole, _ = _fsdp_run(0, 1, _cfg("gemma3_1b", dt))
    want_losses, want_params = _reference("gemma3_1b", dt)
    assert losses == want_losses
    assert all(np.array_equal(a, b) for a, b in zip(whole, want_params))


def test_step_refuses_what_it_does_not_shard(one_rank_group):
    cfg = _cfg("gemma3_1b", "fp32")
    p = tf.init(cfg, seed=0, device="cpu")
    for mesh in (mesh_lib.Mesh(("data", "model"), (1, 2)),
                 mesh_lib.make_production_mesh(multi_pod=True)):
        with pytest.raises(ValueError, match="ranks"):
            steps.make_fsdp_train_step(cfg, mesh, fsdp.data_dims(
                p, cfg, mesh))
    mesh = mesh_lib.make_local_mesh()
    # seq_sharding runs: at one rank its step is the step without it
    seq = cfg.with_overrides(seq_sharding=True)
    batch = _batches(cfg)[0]
    got = [steps.make_fsdp_train_step(c, mesh, fsdp.data_dims(p, c, mesh))(
        p, opt_lib.adamw(1e-3).init(p), batch, 0) for c in (cfg, seq)]
    assert got[0][2]["loss"] == got[1][2]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(
        steps._leaves(got[0][0]), steps._leaves(got[1][0])))
    step = steps.make_fsdp_train_step(cfg, mesh, fsdp.data_dims(p, cfg, mesh),
                                      n_micro=2)
    batch = {k: v[:3] for k, v in _batches(cfg)[0].items()}
    with pytest.raises(ValueError, match="does not divide"):
        step(p, opt_lib.adamw(1e-3).init(p), batch, 0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _argv(steps_, ckpt_dir):
    return ["--arch", "gemma3_1b", "--smoke", "--cadc", "--crossbar", "64",
            "--steps", str(steps_), "--batch", "4", "--seq", "16",
            "--microbatch", "2", "--log-every", "1", "--device", "cpu",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "2", "--keep-k", "2"]


def _torchrun(nproc, argv):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "-m", "repro_torch.launch.train",
         *argv], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def world2_runs(tmp_path_factory):
    """Under torch.distributed.run at 2 ranks: an unbroken 4-step run
    saving at steps 2 and 4, and a run resumed from its step-2 checkpoint
    to 4."""
    unbroken = str(tmp_path_factory.mktemp("unbroken"))
    resumed = str(tmp_path_factory.mktemp("resumed"))
    log = _torchrun(2, _argv(4, unbroken))
    assert "mesh: {'data': 2, 'model': 1}" in log
    assert tckpt.all_steps(unbroken) == [2, 4]
    shutil.copy(os.path.join(unbroken, "step_2.npz"), resumed)
    log = _torchrun(2, _argv(4, resumed))
    assert f"restored step 2 from {resumed}" in log
    return unbroken, resumed


def test_cli_resume_at_the_same_world_is_bitwise_the_unbroken_run(
        world2_runs):
    unbroken, resumed = world2_runs
    assert tckpt.all_steps(resumed) == [2, 4]
    a = _npz(os.path.join(unbroken, "step_4.npz"))
    b = _npz(os.path.join(resumed, "step_4.npz"))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def relay_rank(rank, world, argv):
    out = ttrain.main(argv)
    return ([t.numpy() for t in steps._leaves(out["params"])],
            {k: [t.numpy() for t in steps._leaves(v)]
             for k, v in out["opt_state"].items()}, out["history"])


def test_world2_checkpoint_relays_bitwise_at_worlds_1_and_4(world2_runs,
                                                            tmp_path):
    ckpt_dir = world2_runs[0]
    cfg = smoke_config("gemma3_1b", linear_impl="cadc", crossbar_size=64,
                       n_microbatches=2)
    like = tf.init(cfg, seed=0, device="cpu")
    step, params, opt = ttrain.restore(ckpt_dir, like,
                                       opt_lib.adamw(1e-3).init(like), cfg,
                                       "cpu")
    assert step == 4
    saved = [steps._leaves(params)] + [steps._leaves(opt[k])
                                       for k in ("m", "v")]
    argv = _argv(4, ckpt_dir)                 # restores step 4, trains none
    runs = {1: [relay_rank(0, 1, argv)],
            4: run_ranks(relay_rank, 4, tmp_path, argv)}
    for world, outs in runs.items():
        dims = fsdp.data_dims(like, cfg, mesh_lib.make_local_mesh(world))
        assert any(d is not None for d in dims)
        for rank, (p, o, history) in enumerate(outs):
            assert history == []
            for got_tree, want_tree in zip([p, o["m"], o["v"]], saved):
                for got, want, d in zip(got_tree, want_tree, dims):
                    np.testing.assert_array_equal(
                        got, fsdp.shard(want, d, rank, world).numpy())


def test_production_mesh_needs_256_ranks(tmp_path):
    argv = _argv(1, str(tmp_path))[:-6] + ["--production-mesh"]
    with pytest.raises(ValueError, match="256"):
        ttrain.main(argv)
    assert not dist.is_initialized()
