"""parallel/act_sharding against the JAX package's.

  * the counterparts of tests/test_act_sharding.py's guard tests: a no-op
    outside a context and when disabled, no axis sizes outside a context,
    and under a (1, 1) mesh every named entry dropped;
  * the guard the port's layers ask (`splits`, through
    layers.vocab_split, attention.heads_split, ffn.hidden_split,
    moe.tp_mode) splits exactly the dims JAX's shard_act constrains, for
    every architecture at full width on (16, 16) and (2, 16, 16): the JAX
    call sites (ffn_apply's hidden, _qkv's heads, lm_head's logits,
    moe_apply's expert hidden and its shared experts' hidden, _seq_shard's
    sequence) run under jax.eval_shape with shard_act's mesh sizes stood
    in and with_sharding_constraint recording the spec it is handed.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import attention as jattn
from repro.models.lm import ffn as jffn
from repro.models.lm import layers as jll
from repro.models.lm import moe as jmoe
from repro.models.lm import transformer as jtf
from repro.parallel import act_sharding as jsa
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import ffn as tffn
from repro_torch.models.lm import layers as tll
from repro_torch.models.lm import moe as tmoe
from repro_torch.parallel import act_sharding as sa

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def constrained(shape, *axes, enabled: bool = True) -> tuple:
    """The spec JAX's shard_act would pin for a tensor of `shape` under the
    port's TP context (an entry a dim: the axis entry kept, or U where a
    guard drops it); all U where the JAX function places no constraint."""
    sizes = sa.current_axis_sizes()
    out = []
    for dim, a in zip(shape, axes):
        if a is None or a == sa.U or not enabled or not sizes:
            out.append(sa.U if a is not None else None)
            continue
        names = a if isinstance(a, tuple) else (a,)
        total = 1
        for n in names:
            total *= sizes.get(n, 1)
        fits = all(n in sizes for n in names) and dim % total == 0
        out.append(a if fits and total > 1 else sa.U)
    return tuple(out)


def test_noop_without_context():
    x = torch.ones(4, 8)
    assert sa.shard_act(x, sa.U, "model") is x
    assert constrained(x.shape, sa.U, "model") == (sa.U, sa.U)


def test_noop_when_disabled():
    x = torch.ones(4, 8)
    assert sa.shard_act(x, sa.U, "model", enabled=False) is x
    with sa.tp_context({"data": 1, "model": 2}, None, 0):
        assert constrained(x.shape, sa.U, "model",
                              enabled=False) == (sa.U, sa.U)
        assert not sa.splits(8, enabled=False)


def test_current_axis_sizes_empty():
    assert sa.current_axis_sizes() == {}
    assert sa.current() is None
    assert not sa.splits(8)


def test_divisibility_guard_under_context():
    # a (1, 1) mesh: every axis of size 1 -> every entry dropped; a dim the
    # axis does not divide, or an axis the mesh lacks, dropped too
    x = torch.ones(4, 8)
    with sa.tp_context({"data": 1, "model": 1}, None, 0):
        assert sa.shard_act(x, "data", "model") is x
        assert constrained(x.shape, "data", "model") == (sa.U, sa.U)
        assert sa.splits(8)          # a group of one holds the whole dim
    with sa.tp_context({"data": 2, "model": 3}, None, 0):
        assert constrained(x.shape, "data", "model") == ("data", sa.U)
        assert constrained(x.shape, "pod", None) == (sa.U, None)
        assert not sa.splits(8) and sa.splits(9)
        assert not sa.splits(9, "pod")


def _jax_records(cfg, sizes, monkeypatch):
    """{site: the specs JAX's shard_act hands with_sharding_constraint}."""
    records = []
    monkeypatch.setattr(jsa, "current_axis_sizes", lambda: dict(sizes))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: records.append(tuple(spec)) or x)
    key = jax.random.PRNGKey(0)
    d = cfg.d_model

    def run(site, fn, *args):
        del records[:]
        jax.eval_shape(fn, *args)
        out[site] = list(records)

    out = {}
    x = jax.ShapeDtypeStruct((1, 8, d), jnp.float32)
    kinds = set(cfg.pattern_for_layers)
    if kinds & {"global", "local"}:
        p = jax.eval_shape(lambda k: jattn.attn_init(k, cfg), key)
        pos = jax.ShapeDtypeStruct((1, 8), jnp.int32)
        run("qkv", lambda p, x, pos: jattn._qkv(p, x, cfg, pos), p, x, pos)
    if cfg.ffn_type != "none" and (cfg.moe.n_experts == 0
                                   or "rglru" in kinds):
        p = jax.eval_shape(lambda k: jffn.ffn_init(k, cfg), key)
        run("ffn", lambda p, x: jffn.ffn_apply(p, x, cfg), p, x)
    if cfg.moe.n_experts:
        p = jax.eval_shape(lambda k: jmoe.moe_init(k, cfg), key)
        run("moe", lambda p, x: jmoe.moe_apply(p, x, cfg), p, x)
    emb = jax.eval_shape(
        lambda k: jll.embedding_init(k, cfg.padded_vocab, d), key)
    head = (None if cfg.tie_embeddings else jax.eval_shape(
        lambda k: jll.linear_init(k, d, cfg.padded_vocab, cfg), key))
    run("logits", lambda h, e, x: jll.lm_head(h, e, x, cfg), head, emb, x)
    seq = cfg.with_overrides(seq_sharding=True)
    run("seq", lambda x: jtf._seq_shard(x, seq),
        jax.ShapeDtypeStruct((1, 4096, d), jnp.float32))
    return out


def _split_dims(specs):
    """The dims a site's recorded specs pin to "model" (one set for all)."""
    dims = {tuple(i for i, e in enumerate(s) if e == "model") for s in specs}
    assert len(dims) <= 1, specs
    return dims.pop() if dims else ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_guard_splits_what_jax_constrains(arch, mesh, monkeypatch):
    sizes = MESHES[mesh]
    tcfg, jcfg = tget(arch), jget(arch)
    got = _jax_records(jcfg, sizes, monkeypatch)
    assert got["logits"] and got["seq"] is not None
    want = {"logits": (2,) if tll.vocab_split(tcfg, sizes) else (),
            "seq": (1,) if sa.splits(4096, sizes=sizes) else ()}
    if "qkv" in got:
        # q's record first, then k's and v's (the heads are dim 2)
        q, *kv = got["qkv"] or [()]
        assert _split_dims([q] if q else []) == (
            (2,) if tattn.heads_split(tcfg, sizes) else ())
        assert _split_dims(kv) == (
            (2,) if sa.splits(tcfg.n_kv_heads, sizes=sizes) else ())
        assert len(got["qkv"]) == tattn.heads_split(tcfg, sizes) + 2 * (
            sa.splits(tcfg.n_kv_heads, sizes=sizes))
    if "ffn" in got:
        want["ffn"] = (2,) if tffn.hidden_split(tcfg, tcfg.d_ff,
                                                sizes) else ()
    if "moe" in got:
        # the expert hidden [E, C, d_e], then the shared experts' [T, d_s]
        got["shared"] = [s for s in got["moe"] if len(s) == 2]
        got["moe"] = [s for s in got["moe"] if len(s) == 3]
        want["moe"] = {"ep": (0,), "etp": (2,),
                       None: ()}[tmoe.tp_mode(tcfg, sizes)]
        m = tcfg.moe
        want["shared"] = (1,) if m.n_shared and tffn.hidden_split(
            tcfg, m.d_shared, sizes) else ()
    for site, dims in want.items():
        assert _split_dims(got[site]) == dims, (site, got[site])
        assert bool(got[site]) == bool(dims)
    assert tattn.kv_split(tcfg, sizes) <= tattn.heads_split(tcfg, sizes)
