"""The serving steps over the mesh (launch/steps.make_mesh_prefill_step
and make_mesh_serve_step) on the CPU over gloo.

  * over the meshes (data 1, model 2), (2, 1) and (2, 2) — spawned ranks,
    one spawn a mesh — every case, smoke size, CADC relu, fp32: gemma3-1b
    (2 heads over 1 kv head: length-parallel at model 2 on its local
    rings of 32 and its global rings of 48), the same with global rings
    of 47 (replicated; the local rings length-parallel) and a batch of 3
    that does not divide 2 data-parallel ranks (every rank runs every
    row), phi4-mini (4 heads over 2 kv heads: head-parallel),
    qwen2-moe-a2.7b (expert parallel, routing over the data-parallel
    group) and recurrentgemma-9b (the RG-LRU state rows split over
    "data", its local MQA length-parallel). One prefill, held to
    make_prefill_step; then DECODE_STEPS decode steps fed the one-process
    step's tokens, from the caches the one-process batched prefill filled
    (ragged prompts) cut into the ranks' blocks (steps.cache_blocks),
    held to make_serve_step: fp32 logits within RTOL of their scale,
    greedy tokens equal, each rank's cache block equal to the one-process
    cache's block within the same bound;
  * at world 1 the mesh steps are make_prefill_step / make_serve_step,
    bitwise, in fp32 and bf16;
  * the 2-rank logits within JAX_RTOL of the JAX package's
    make_prefill_step and decode_step on the same parameters
    (params_to_numpy) and caches, for gemma3-1b and phi4-mini (JAX runs in
    the test process only: the ranks import no JAX);
  * a planted fault in the ranks — the length-parallel merge replaced by
    the rank's own partial — fails the logits gate by 10x or more;
  * the serve plan against the train plan, and the decode form against
    sharding.cache_specs for every arch at full width;
  * cfg.seq_sharding changes nothing in the mesh prefill and serve steps
    (the JAX package's _seq_shard is a train layer's constraint): at
    (1, 2) their logits and tokens under it are bitwise those without it.

Every spawn is bounded (run_ranks: 240 s).
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_ranks
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import transformer as tf
from repro_torch.parallel import fsdp, sharding
from repro_torch.serve.backends import DenseBackend

MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
LENGTHS = (30, 17, 25, 9)
# case: (arch, seq_len of the caches, prompt lengths)
CASES = {
    "gemma3": ("gemma3_1b", 48, LENGTHS),
    "gemma3.odd": ("gemma3_1b", 47, LENGTHS[:3]),
    "phi4": ("phi4_mini_38b", 48, LENGTHS),
    "qwen2moe": ("qwen2_moe_a27b", 48, LENGTHS),
    "recurrentgemma": ("recurrentgemma_9b", 48, LENGTHS),
}
DTYPES = {"fp32": dict(dtype="float32", bf16_wire=False),
          "bf16": dict(dtype="bfloat16", bf16_wire=True)}
DECODE_STEPS = 6
RTOL, JAX_RTOL = 1e-5, 1e-4
FAULT_CASE = "gemma3"
SEQ_CASES = ("gemma3", "recurrentgemma")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(case, dt="fp32"):
    return smoke_config(CASES[case][0], linear_impl="cadc", **DTYPES[dt])


def _prompts(case):
    cfg = _cfg(case)
    lengths = CASES[case][2]
    rng = np.random.RandomState(11)
    return rng.randint(0, cfg.vocab_size, (len(lengths), max(lengths)))


def _to_numpy(caches):
    """Caches as numpy (fp32: the spawned ranks' inputs and results pickle
    through their queues as arrays, not as shared tensors)."""
    return [type(c)(*(t.numpy() for t in c)) for c in caches]


def _from_numpy(caches):
    return [type(c)(*(torch.from_numpy(a.copy()) for a in c))
            for c in caches]


def _one_process(cfg, params, seq_len, prompts, lengths, feed=None):
    """make_prefill_step's logits; the caches make_batched_prefill_step
    fills (written as the dense backend writes them); then DECODE_STEPS
    make_serve_step steps from them, each fed the previous step's tokens
    (or feed[i]): (prefill logits, the caches after the prefill, the fed
    tokens, each step's logits and tokens, the caches after the steps)."""
    toks = torch.from_numpy(prompts).long()
    prefill = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    cast = steps.cast_compute(params, cfg)
    backend = DenseBackend(cfg, len(lengths), seq_len, torch.device("cpu"))
    caches = backend.init_caches()
    nxt, _, contribs = steps.make_batched_prefill_step(cfg)(
        cast, {"tokens": toks}, torch.tensor(lengths))
    backend.write_prefill(caches, contribs, np.arange(len(lengths)),
                          np.array(lengths), None)
    after_prefill = tf.copy_caches(caches)
    serve = steps.make_serve_step(cfg)
    fed, logits, out = [], [], []
    for i in range(DECODE_STEPS):
        tok = nxt if feed is None else torch.from_numpy(feed[i])
        nxt, lg = serve(cast, tok, torch.tensor(lengths) + i, caches)
        fed.append(tok.numpy())
        logits.append(lg.numpy())
        out.append(nxt.numpy())
    return (prefill.numpy(), after_prefill, fed, logits, out,
            tf.copy_caches(caches))


@functools.lru_cache(maxsize=None)
def _reference(case, dt="fp32"):
    cfg = _cfg(case, dt)
    _, seq_len, lengths = CASES[case]
    params = tf.init(cfg, seed=0, device="cpu")
    return _one_process(cfg, params, seq_len, _prompts(case), lengths)


def _mesh_run(cfg, mesh, seq_len, prompts, lengths, caches, fed):
    """The mesh steps on this rank: (prefill logits, each step's logits and
    tokens, this rank's cache blocks after the steps); rows: this rank's
    (steps._dp_rows)."""
    full = tf.init(cfg, seed=0, device="cpu")
    dims = fsdp.data_dims(full, cfg, mesh)
    mdims = fsdp.model_dims(full, cfg, mesh)
    prefill = steps.make_mesh_prefill_step(cfg, mesh, dims)
    serve = steps.make_mesh_serve_step(cfg, mesh, dims, seq_len)
    mg = serve.mesh_groups
    shards = steps._rebuild(full, [
        fsdp.mesh_block(t, d, md, mg.coords, mg.sizes)
        for t, d, md in zip(steps._leaves(full), dims, mdims)])
    pre = prefill(shards, {"tokens": torch.from_numpy(prompts).long()})
    blocks = steps.cache_blocks(tf.copy_caches(caches), cfg, mesh,
                                len(lengths), mg.coords)
    logits, out = [], []
    for i, tok in enumerate(fed):
        nxt, lg = serve(shards, torch.from_numpy(tok),
                        torch.tensor(lengths) + i, blocks)
        logits.append(lg.numpy())
        out.append(nxt.numpy())
    return pre.numpy(), logits, out, blocks, serve.attention_forms


def serve_rank(rank, world, shape, inputs):
    """Every case's mesh run on this rank; on (1, 2) also the planted
    fault's logits and SEQ_CASES' runs under cfg.seq_sharding."""
    mesh = mesh_lib.Mesh(("data", "model"), shape)
    out = {}
    for case, (caches, fed) in inputs.items():
        _, seq_len, lengths = CASES[case]
        res = _mesh_run(_cfg(case), mesh, seq_len, _prompts(case), lengths,
                        _from_numpy(caches), fed)
        out[case] = res[:3] + (_to_numpy(res[3]),) + res[4:]
    if shape == (1, 2):
        saved = attn._merge_partials
        attn._merge_partials = lambda o, top, total, group: o
        try:
            caches, fed = inputs[FAULT_CASE]
            _, seq_len, lengths = CASES[FAULT_CASE]
            out["fault"] = _mesh_run(_cfg(FAULT_CASE), mesh, seq_len,
                                     _prompts(FAULT_CASE), lengths,
                                     _from_numpy(caches), fed)[1]
        finally:
            attn._merge_partials = saved
        out["seq"] = {}
        for case in SEQ_CASES:
            caches, fed = inputs[case]
            _, seq_len, lengths = CASES[case]
            out["seq"][case] = _mesh_run(
                _cfg(case).with_overrides(seq_sharding=True), mesh, seq_len,
                _prompts(case), lengths, _from_numpy(caches), fed)[:3]
    return out


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Every case over each mesh: one spawn a mesh."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            shape = MESHES[mesh]
            inputs = {case: (_to_numpy(_reference(case)[1]),
                             _reference(case)[2]) for case in CASES}
            runs[mesh] = run_ranks(serve_rank, int(np.prod(shape)),
                                   tmp_path_factory.mktemp(f"serve{mesh}"),
                                   shape, inputs, timeout=240)
        return runs[mesh]
    return get


def _rows(rank, shape, batch):
    """The rows the rank runs (steps._dp_rows on (data, model))."""
    dp = shape[0]
    if batch % dp or batch < dp:
        return slice(None)
    n = batch // dp
    d = rank // shape[1]
    return slice(d * n, (d + 1) * n)


def _err(got, want) -> float:
    """max |got - want| over the scale max(1, max |want|)."""
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_serve_steps_match_the_one_process_steps(mesh, case,
                                                      serve_runs):
    shape = MESHES[mesh]
    cfg = _cfg(case)
    _, seq_len, lengths = CASES[case]
    prefill, _, _, logits, out, caches = _reference(case)
    specs = sharding.cache_specs(caches, cfg,
                                 mesh_lib.Mesh(("data", "model"), shape),
                                 len(lengths))
    for rank, res in enumerate(serve_runs(mesh)):
        pre, got_logits, got_out, blocks, forms = res[case]
        rows = _rows(rank, shape, len(lengths))
        assert _err(pre, prefill[rows]) <= RTOL
        for i in range(DECODE_STEPS):
            assert got_logits[i].shape == logits[i][rows].shape
            assert _err(got_logits[i], logits[i][rows]) <= RTOL, (rank, i)
            np.testing.assert_array_equal(got_out[i], out[i][rows])
        coords = {"pod": 0, "data": rank // shape[1],
                  "model": rank % shape[1]}
        sizes = {"pod": 1, "data": shape[0], "model": shape[1]}
        for got, want, spec in zip(blocks, caches, specs):
            for g, w, sp in zip(got, want, spec):
                w = fsdp.spec_block(w, sp, coords, sizes).numpy()
                assert g.shape == w.shape
                assert _err(g, w) <= RTOL
        want_forms = {k: attn.decode_form(cfg, attn.cache_len(
            cfg, k, seq_len), shape[1]) for k in forms}
        assert forms == want_forms
    if shape == (1, 2):
        want = {"gemma3": {"local": "length-parallel",
                           "global": "length-parallel"},
                "gemma3.odd": {"local": "length-parallel",
                               "global": "replicated"},
                "phi4": {"global": "head-parallel"},
                "qwen2moe": {"global": "head-parallel"},
                "recurrentgemma": {"local": "length-parallel"}}[case]
        assert serve_runs(mesh)[0][case][4] == want


def test_the_planted_merge_fault_fails_the_gate(serve_runs):
    _, _, _, logits, _, _ = _reference(FAULT_CASE)
    for res in serve_runs("1x2"):
        worst = max(_err(g, w) for g, w in zip(res["fault"], logits))
        assert worst >= 10 * RTOL, worst


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_is_the_one_process_steps_bitwise(case, one_rank_group):
    _, seq_len, lengths = CASES[case]
    for dt in DTYPES:
        cfg = _cfg(case, dt)
        prefill, caches, fed, logits, out, final = _reference(case, dt)
        got = _mesh_run(cfg, mesh_lib.Mesh(("data", "model"), (1, 1)),
                        seq_len, _prompts(case), lengths, caches, fed)
        assert np.array_equal(got[0], prefill)
        assert all(np.array_equal(a, b) for a, b in zip(got[1], logits))
        assert all(np.array_equal(a, b) for a, b in zip(got[2], out))
        for a, b in zip(got[3], final):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def _jax_caches(caches, cfg):
    """The port's per-layer dense caches as the JAX package's tree (units
    stacked over the pattern's reps, then the tail)."""
    import jax.numpy as jnp

    from repro.models.lm import attention as jattn

    p = len(cfg.pattern)
    reps = cfg.n_layers // p if cfg.scan_layers else 0
    kv = [jattn.KVCache(*(jnp.asarray(t.numpy()) for t in c))
          for c in caches]
    units = tuple(jattn.KVCache(*(jnp.stack([kv[r * p + j][f]
                                             for r in range(reps)])
                                  for f in range(2)))
                  for j in range(p)) if reps else ()
    return {"units": units, "tail": tuple(kv[reps * p:])}


@pytest.mark.parametrize("case", ["gemma3", "phi4"])
def test_two_ranks_match_jax(case, serve_runs):
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.launch import steps as jsteps
    from repro.models.lm import transformer as jtf

    cfg = _cfg(case)
    jcfg = jsmoke(CASES[case][0], linear_impl="cadc", **DTYPES["fp32"])
    lengths = CASES[case][2]
    tree = tf.params_to_numpy(tf.init(cfg, seed=0, device="cpu"), cfg)
    _, caches, fed, _, _, _ = _reference(case)
    want_pre = np.asarray(jsteps.make_prefill_step(jcfg)(
        tree, {"tokens": jnp.asarray(_prompts(case), jnp.int32)}))
    step = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    jc = _jax_caches(caches, cfg)
    want = []
    for i, tok in enumerate(fed):
        lg, jc = step(tree, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(lengths, jnp.int32) + i, jc)
        want.append(np.asarray(lg))
    for res in serve_runs("1x2"):
        pre, logits = res[case][0], res[case][1]
        assert _err(pre, want_pre) <= JAX_RTOL
        for got, w in zip(logits, want):
            assert _err(got, w) <= JAX_RTOL


def test_serve_plan_follows_the_cache_rule():
    """gemma3-1b at model 2: the train plan splits wq (4 heads divide),
    the serve plan reads every attention leaf whole (its one kv head does
    not: the ring length is split); phi4-mini keeps the train plan."""
    sizes = {"pod": 1, "data": 1, "model": 2}
    for arch, same in (("gemma3_1b", False), ("phi4_mini_38b", True)):
        cfg = get_config(arch, linear_impl="cadc")
        shape = steps.abstract_params(cfg)
        train = tf.tp_leaf_modes(shape, cfg, sizes)
        serve = tf.serve_leaf_modes(shape, cfg, sizes)
        names = [n for n, _ in tf._leaf_paths(shape)]
        for n, a, b in zip(names, train, serve):
            if n[0] == "layers" and n[2] == "attn" and not same:
                assert b == ("full", None), n
            else:
                assert a == b, n
        split = [m for n, (m, _) in zip(names, train)
                 if n[0] == "layers" and n[2] == "attn" and n[3] == "wq"]
        assert set(split) == {"split"}


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).supports_decode()])
def test_decode_form_is_the_cache_rule(arch):
    """decode_form picks the form the cache rule's layout implies, for
    every attention kind at full width on (16, 16), (2, 16, 16) and the
    model axes 2 and 4 at seq_len 32768 and 524288 (batch 128)."""
    cfg = get_config(arch)
    meshes = [mesh_lib.make_production_mesh(),
              mesh_lib.make_production_mesh(multi_pod=True),
              mesh_lib.Mesh(("data", "model"), (1, 2)),
              mesh_lib.Mesh(("data", "model"), (2, 4))]
    for seq_len in (32768, 524288):
        caches = steps.abstract_caches(cfg, 128, seq_len)
        for mesh in meshes:
            t = mesh_lib.axis_size(mesh, "model")
            specs = sharding.cache_specs(caches, cfg, mesh, 128)
            for kind, c, spec in zip(tf.layout(cfg), caches, specs):
                if kind not in tf.ATTN_KINDS:
                    continue
                form = attn.decode_form(cfg, c.k.shape[1], t)
                want = {(None, "model"): "head-parallel",
                        ("model", None): "length-parallel",
                        (None, None): "replicated"}[spec.k[1:3]]
                assert form == want, (kind, mesh, seq_len)


def test_seq_sharding_leaves_the_mesh_serve_steps_bitwise(serve_runs):
    for rank, out in enumerate(serve_runs("1x2")):
        for case in SEQ_CASES:
            (pre, logits, toks), want = out["seq"][case], out[case]
            assert np.array_equal(pre, want[0]), (case, rank)
            assert all(np.array_equal(a, b) for a, b in zip(logits, want[1]))
            assert all(np.array_equal(a, b) for a, b in zip(toks, want[2]))
