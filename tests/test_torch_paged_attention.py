"""The port's paged-attention decode against the JAX package.

The plain version of the CUDA flash-decoding kernel
(kernels/paged_attention.py `paged_attention_torch`, the gather
formulation) must match the JAX package's gather oracle
(`paged_attention_xla`) and its Pallas kernel in interpret mode within
2e-5 (`tests/test_paged_attention.py` TOL), across -1 blocks, NaN garbage,
an idle slot, softcap, GQA/MQA/MHA layouts, covered-prefix tables and
multi-token appends. The CUDA kernel itself is held against the plain
version on a card, in tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.models.lm import attention as jattn
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import transformer as ttf

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _geometry(rng, *, b=3, q_len=1, h=2, kh=1, hd=16, bs=8, nb=4,
              positions=(5, 9, 0), holes=True):
    """Random pools + a fragmented block table (slot rings scattered over
    the pool, trailing -1s where `holes`) — numpy arrays."""
    n_blocks = b * nb + 2
    q = rng.randn(b, q_len, h, hd).astype(np.float32)
    kp = rng.randn(n_blocks, bs, kh, hd).astype(np.float32)
    vp = rng.randn(n_blocks, bs, kh, hd).astype(np.float32)
    perm = rng.permutation(n_blocks)
    tbl = np.full((b, nb), -1, np.int32)
    take = 0
    for i in range(b):
        n_live = nb if not holes else 1 + (i % nb)
        tbl[i, :n_live] = perm[take: take + n_live]
        take += n_live
    return q, kp, vp, tbl, np.asarray(positions[:b], np.int32)


def _jax(args, impl, **kw):
    return np.asarray(jops.paged_attention(*map(jnp.asarray, args),
                                           impl=impl, **kw))


def _port(args, **kw):
    return tops.paged_attention(*map(torch.from_numpy, args), impl="auto",
                                **kw).numpy()


class TestPlainMatchesJax:
    @pytest.mark.parametrize("kind", ["global", "local"])
    def test_basic(self, kind):
        args = _geometry(np.random.RandomState(0))
        got = _port(args, kind=kind, window=16)
        np.testing.assert_allclose(got, _jax(args, "xla", kind=kind,
                                             window=16), **TOL)
        np.testing.assert_allclose(got, _jax(args, "interpret", kind=kind,
                                             window=16), **TOL)

    @pytest.mark.parametrize("h,kh", [(2, 1), (4, 2), (4, 4)])
    @pytest.mark.parametrize("kind", ["global", "local"])
    def test_head_layouts_mqa_gqa_mha(self, h, kh, kind):
        args = _geometry(np.random.RandomState(h * 10 + kh), h=h, kh=kh,
                         positions=(3, 17, 30))
        np.testing.assert_allclose(
            _port(args, kind=kind, window=16),
            _jax(args, "xla", kind=kind, window=16), **TOL)

    def test_softcap(self):
        args = _geometry(np.random.RandomState(3))
        got = _port(args, kind="global", window=32, softcap=5.0)
        np.testing.assert_allclose(
            got, _jax(args, "interpret", kind="global", window=32,
                      softcap=5.0), **TOL)

    @pytest.mark.parametrize("kind", ["global", "local"])
    def test_multi_token_append(self, kind):
        args = _geometry(np.random.RandomState(13), q_len=3,
                         positions=(4, 9, 0), holes=False)
        np.testing.assert_allclose(
            _port(args, kind=kind, window=16),
            _jax(args, "xla", kind=kind, window=16), **TOL)

    def test_nan_garbage_never_reaches_output(self):
        """NaN in every block masked at these positions: the port's plain
        version stays NaN-free and equals the JAX kernel on the dirty pools
        and the JAX oracle on clean ones."""
        q, kp, vp, tbl, pos = _geometry(np.random.RandomState(8),
                                        positions=(2, 3, 1), holes=False)
        dead = tbl[:, 1:].reshape(-1)
        kd, vd = kp.copy(), vp.copy()
        kd[dead] = np.nan
        vd[dead] = np.nan
        dirty = (q, kd, vd, tbl, pos)
        got = _port(dirty, kind="global", window=8)
        assert not np.isnan(got).any()
        np.testing.assert_allclose(
            got, _jax((q, kp, vp, tbl, pos), "xla", kind="global", window=8),
            **TOL)
        np.testing.assert_allclose(
            got, _jax(dirty, "interpret", kind="global", window=8), **TOL)

    def test_idle_slot_outputs_zero(self):
        """An all -1 slot yields exactly 0, as in the JAX kernel; its NaN-
        or garbage-filled pool cannot leak into the live slot."""
        q, kp, vp, _, pos = _geometry(np.random.RandomState(9), b=2,
                                      positions=(4, 0))
        tbl = np.array([[0, 1, 2, 3], [-1, -1, -1, -1]], np.int32)
        kp[4:] = np.nan
        vp[4:] = np.nan
        got = _port((q, kp, vp, tbl, pos), kind="global", window=32)
        want = _jax((q, kp, vp, tbl, pos), "interpret", kind="global",
                    window=32)
        assert np.array_equal(got[1], np.zeros_like(got[1]))
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("h,kh", [(4, 2), (8, 1)])
    @pytest.mark.parametrize("softcap", [None, 30.0])
    def test_row_that_reads_nothing_writes_zero(self, h, kh, softcap):
        """Q = 3, slot 3 at position 47 of a 48-entry local ring, window
        12, blocks 4-5 unallocated: its first token's window holds only
        -1 blocks while the later two read block 0. The plain version
        writes 0 in that row, as `_flash_kernel` (interpret mode) and K6
        do; every other row keeps its value. `paged_attention_xla`
        differs there on purpose (pinned): a uniform softmax over NEG_INF
        scores averages every V it gathered for the slot, the -1 blocks'
        stand-in (pool block 0) included."""
        args = _geometry(np.random.RandomState(h * 10 + kh), b=5, q_len=3,
                         h=h, kh=kh, nb=6, positions=(5, 20, 31, 47, 2))
        q, kp, vp, tbl, pos = args
        assert (tbl[3, 4:] == -1).all() and (tbl[3, :4] >= 0).all()
        kw = dict(kind="local", window=12, softcap=softcap)
        got = _port(args, **kw)
        want = _jax(args, "interpret", **kw)
        assert np.array_equal(got[3, 0], np.zeros_like(got[3, 0]))
        assert np.array_equal(want[3, 0], np.zeros_like(want[3, 0]))
        assert np.abs(got[3, 1:]).min() > 0
        np.testing.assert_allclose(got, want, **TOL)
        xla = _jax(args, "xla", **kw)
        v_ring = vp[np.maximum(tbl[3], 0)].reshape(-1, kh, vp.shape[-1])
        mean = np.repeat(v_ring.mean(axis=0), h // kh, axis=0)  # [h, hd]
        np.testing.assert_allclose(xla[3, 0], mean, **TOL)
        assert np.abs(xla[3, 0]).max() > 1e-3
        rest = np.ones(got.shape[:2], bool)
        rest[3, 0] = False
        np.testing.assert_allclose(got[rest], xla[rest], **TOL)

    @pytest.mark.parametrize("kind", ["global", "local"])
    def test_covered_prefix_slice_equals_full_bitwise(self, kind):
        q, kp, vp, tbl, pos = _geometry(np.random.RandomState(11),
                                        positions=(5, 9, 12), holes=False)
        ring = tbl.shape[1] * kp.shape[1]
        full = _port((q, kp, vp, tbl, pos), kind=kind, window=16,
                     ring_len=ring)
        sliced = _port((q, kp, vp, tbl[:, :2].copy(), pos), kind=kind,
                       window=16, ring_len=ring)
        assert np.array_equal(full, sliced)
        np.testing.assert_allclose(
            sliced, _jax((q, kp, vp, tbl[:, :2], pos), "xla", kind=kind,
                         window=16, ring_len=ring), **TOL)

    @pytest.mark.parametrize("kind", ["global", "local"])
    @pytest.mark.parametrize("q_len", [1, 3])
    def test_ring_mask_matches(self, kind, q_len):
        idx = np.arange(48, dtype=np.int32)
        for p in [0, 1, 5, 11, 12, 31, 40, 77]:
            want = jpa._ring_mask(jnp.int32(p), jnp.asarray(idx), kind=kind,
                                  ring_len=48, window=12, q_len=q_len)
            got = tpa._ring_mask(torch.tensor([p]), torch.from_numpy(idx),
                                 kind=kind, ring_len=48, window=12,
                                 q_len=q_len)[0]
            assert np.array_equal(got.numpy(), np.asarray(want)), (kind, p)


@pytest.mark.parametrize("kind", ["global", "local"])
def test_decode_layer_matches_jax(kind):
    """attention_decode_paged at the smoke gemma3-1b geometry with JAX-
    initialised CADC weights: same output, same pools after the write."""
    jcfg = jsmoke("gemma3_1b", linear_impl="cadc")
    tcfg = tsmoke("gemma3_1b", linear_impl="cadc")
    p = jattn.attn_init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    rng = np.random.RandomState(1)
    b, bs, nb = 2, 8, 4
    shape = (b * nb, bs, jcfg.n_kv_heads, jcfg.head_dim)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    tbl = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
    tbl[1, 3] = -1  # this slot's write at position 20 lands in block 2
    pos = np.array([6, 20], np.int32)
    x = rng.randn(b, 1, jcfg.d_model).astype(np.float32)
    layer = jax.jit(lambda p, x, pos, k, v, t: jattn.attention_decode_paged(
        p, x, jcfg, kind=kind, position=pos, cache=jattn.PagedKV(k, v),
        block_table=t))
    want, pool = layer(p, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kp),
                       jnp.asarray(vp), jnp.asarray(tbl))
    sink = np.zeros((1,) + shape[1:], np.float32)  # the port's write sink
    cache = tattn.PagedKV(torch.from_numpy(np.concatenate([kp, sink])),
                          torch.from_numpy(np.concatenate([vp, sink])))
    got = tattn.attention_decode_paged(
        tp, torch.from_numpy(x), tcfg, kind=kind,
        position=torch.from_numpy(pos), cache=cache,
        block_table=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cache.k[:-1].numpy(), np.asarray(pool.k),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache.v[:-1].numpy(), np.asarray(pool.v),
                               rtol=1e-4, atol=1e-4)


def test_write_to_unallocated_block_goes_to_the_sink():
    """A slot whose table maps no block at its position: its K/V write
    changes no addressable block (JAX drops it), only the sink."""
    tcfg = tsmoke("gemma3_1b")
    p = ttf._layer_init(torch.Generator().manual_seed(0), "global", tcfg,
                        torch.device("cpu"))["attn"]
    pool = tattn.init_paged_pool(tcfg, 4, 8, torch.float32,
                                 torch.device("cpu"))
    before = pool.k.clone()
    tbl = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    x = torch.randn(2, 1, tcfg.d_model)
    tattn.attention_decode_paged(p, x, tcfg, kind="global",
                                 position=torch.tensor([3, 5]), cache=pool,
                                 block_table=tbl)
    assert pool.k.shape[0] == 5
    assert not torch.equal(pool.k[0], before[0])       # slot 0 wrote
    assert torch.equal(pool.k[1:4], before[1:4])       # slot 1 dropped
    assert not torch.equal(pool.k[4], before[4])       # ... into the sink


def test_dispatch_on_cpu():
    args = [torch.from_numpy(a) for a in _geometry(np.random.RandomState(2))]
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_attention(*args, kind="global", window=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(*args, kind="global", window=8)
    assert tpa.paged_attention_cuda.launches == 0


# K6's planner (plan_paged, pure Python): (B, K, nb, R, hd, element
# bytes, bs) of the main path (gemma3-1b: 8 slots, 4 q heads on 1 kv head,
# head_dim 256, bf16, block 16; covered-prefix widths 8 and 10), 3 slots,
# 40 slots on a 512 ring (groups of several chunks), 300 slots (one
# group), more (slot, kv head) tiles than arrival counters, fp32,
# Q = 3 x 8 q heads (3 row tiles), and rows of 1024 (q and acc in shared
# memory, one row a tile)
_PLAN_SHAPES = [(8, 1, 10, 4, 256, 2, 16), (8, 1, 8, 4, 256, 2, 16),
                (3, 1, 4, 4, 256, 2, 16), (40, 1, 32, 4, 256, 2, 16),
                (300, 1, 8, 4, 256, 2, 16), (20000, 4, 8, 4, 64, 4, 16),
                (8, 1, 10, 4, 256, 4, 16), (5, 1, 6, 24, 64, 4, 8),
                (4, 1, 4, 4, 1024, 2, 16)]


@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_plan_groups_cover_the_ring(shape):
    """Under the planner's plan and every forced one the groups cover the
    ring's chunks exactly once, in chunk order, none empty; the row tiles
    cover the R rows; shared memory fits a block; a plan with several
    groups uses no more counters than there are."""
    b, k_, nb, rows, hd, elem, bs = shape
    plans = tpa.paged_plans(*shape)
    assert plans[0] == tpa.plan_paged(*shape)
    for p in plans:
        groups = [list(range(s * p.cps, min(nb, (s + 1) * p.cps)))
                  for s in range(p.groups)]
        assert [c for g in groups for c in g] == list(range(nb))
        assert all(groups)
        assert p.rows in tpa.PAGED_ROWS and p.rows * p.row_tiles >= rows
        assert (p.row_tiles - 1) * p.rows < rows
        assert p.smem <= tpa.PAGED_SMEM_LIMIT
        assert p.blocks == b * k_ * p.row_tiles * p.groups
        if p.groups > 1:
            assert p.tiles <= tpa._cm.N_COUNTERS
            assert p.scratch_floats() == p.blocks * p.rows * (hd + 2)
        else:
            assert p.scratch_floats() == 0


def test_plan_falls_back_to_one_group_past_the_counters():
    """20000 slots x 4 kv heads are 80000 tiles > N_COUNTERS: every plan
    is one group of all chunks, and forcing groups raises."""
    shape = (20000, 4, 8, 4, 64, 4, 16)
    assert all(p.groups == 1 for p in tpa.paged_plans(*shape))
    with pytest.raises(ValueError, match="no such K6 plan"):
        tpa.plan_paged(*shape, _force=(1, 256))


@pytest.mark.parametrize("force", [(0, 256), (11, 256), (1, 96), (1, 512),
                                   (-3, 128)])
def test_plan_force_rejects_plans_that_do_not_exist(force):
    with pytest.raises(ValueError, match="no such K6 plan"):
        tpa.plan_paged(8, 1, 10, 4, 256, 2, 16, _force=force)


@pytest.mark.parametrize("hd,elem", [(6, 4), (36, 2), (1028, 2), (0, 4)])
def test_plan_refuses_rows_off_16_bytes(hd, elem):
    with pytest.raises(ValueError, match="16 bytes"):
        tpa.plan_paged(8, 1, 10, 4, hd, elem, 16)


def test_plan_row_tiles_and_cache():
    """R rows sit in registers up to head_dim 256, 8 a tile at most; wider
    rows take one row a tile; the plan is cached per shape."""
    assert tpa.plan_paged(5, 1, 6, 24, 64, 4, 8).row_tiles == 3
    assert tpa.plan_paged(5, 1, 6, 6, 64, 4, 8).rows == 8
    assert tpa.plan_paged(5, 1, 6, 1, 64, 4, 8).rows == 1
    p = tpa.plan_paged(5, 1, 6, 6, 512, 4, 8)
    assert (p.rows, p.row_tiles) == (1, 6)
    assert tpa.plan_paged(8, 1, 10, 4, 256, 2, 16) is \
        tpa.plan_paged(8, 1, 10, 4, 256, 2, 16)


@pytest.mark.parametrize("hd,elem", [(576, 2), (1024, 4), (3072, 2)])
def test_plan_wide_rows_hold_acc_in_shared_memory(hd, elem):
    """Past head_dim 256 a block holds one row, its acc in shared memory
    (hd floats more than the register form's layout); rows as wide as
    shared memory holds plan, wider ones raise."""
    p = tpa.plan_paged(8, 1, 10, 4, hd, elem, 16, _force=(1, 256))
    assert (p.rows, p.row_tiles) == (1, 4)
    assert p.smem == ((1 + 2 * 16) * hd * elem
                      + (16 + 10 + 2 + hd) * 4 + 4)
    with pytest.raises(ValueError, match="shared memory"):
        tpa.plan_paged(8, 1, 10, 4, 8192, elem, 16)


@pytest.mark.parametrize("nb", [8, 10])
def test_plan_main_path_takes_one_chunk_a_group(nb):
    """At the main path's decode (8 slots, gemma3-1b, bf16, the covered-
    prefix widths 8 and 10) the fitted model picks one chunk a group and
    256 threads — the fastest plan of tools/profile_k6.py's sweep."""
    p = tpa.plan_paged(8, 1, nb, 4, 256, 2, 16)
    assert (p.cps, p.groups, p.threads) == (1, nb, 256)
