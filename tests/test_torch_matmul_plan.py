"""The CADC matmul forward's launch planner (kernels/cadc_matmul.py
`plan_fwd`), a pure function of the shapes: which kernel body, which tile
or strip, and whether the segments split over blocks. It runs here on the
CPU; the card tests (tests/test_torch_kernels_cuda.py) hold every plan's
results to each other and to the plain version."""
import pytest
import torch

from repro_torch.kernels import cadc_matmul as cm

XBAR = 256
# gemma3-1b's seven CADC linears (D padded to whole crossbars, N): the
# decode step's K1 calls, at M = 8 slots.
DECODE = {"wq": (1280, 1024), "wk": (1280, 256), "wv": (1280, 256),
          "wo": (1024, 1152), "w_gate": (1280, 6912), "w_up": (1280, 6912),
          "w_down": (6912, 1152)}
# (M, D, N) of the FC layers at their batches, crossbar 64: LeNet-5 f1-f3
# (batch 64), ResNet-18's fc and VGG-16's f1-f3 (batch 128), the SNN's fc.
FC = [(64, 400, 120), (64, 120, 84), (64, 84, 10), (128, 512, 10),
      (128, 512, 512), (128, 512, 100), (32, 4096, 11)]
VEC = {"fp32": 4, "bf16": 8}


def _segments(d, xbar):
    return -(-d // xbar)


def _candidates(m, n, n_seg, xbar, vec):
    """Every plan the planner may pick for the shape."""
    out = []
    for rows in (64, 8):
        for split in (False, True):
            if split and n_seg < 2:
                continue
            out.append(cm.plan_fwd(m, n, n_seg, xbar,
                                   _force=("tile", rows, split)))
    if vec and m <= 8:
        out += [cm.plan_fwd(m, n, n_seg, xbar, vec=vec,
                            _force=("stream", lanes, n_seg > 1))
                for lanes in (4, 8)]
    return out


def _fills_or_best(plan, m, n, n_seg, xbar, vec):
    best = max(p.blocks for p in _candidates(m, n, n_seg, xbar, vec))
    return plan.blocks >= min(cm.SMS, best)


@pytest.mark.parametrize("dtype", sorted(VEC))
@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_plan_streams_and_fills_the_card(name, dtype):
    d, n = DECODE[name]
    n_seg = _segments(d, XBAR)
    plan = cm.plan_fwd(8, n, n_seg, XBAR, vec=VEC[dtype])
    assert plan.kernel == "stream" and plan.split
    assert _fills_or_best(plan, 8, n, n_seg, XBAR, VEC[dtype])
    if name not in ("wk", "wv"):   # the shapes that carry the bytes
        assert plan.blocks >= cm.SMS


@pytest.mark.parametrize("m,d,n", FC)
def test_fc_plan_fills_the_card(m, d, n):
    n_seg = _segments(d, 64)
    plan = cm.plan_fwd(m, n, n_seg, 64)
    assert plan.kernel == "tile"
    assert _fills_or_best(plan, m, n, n_seg, 64, 0)


def test_fc_plans_fill_the_card_with_8_row_tiles():
    """ResNet-18's fc: 16 row tiles x 8 segments = 128 blocks (2 in a
    single pass); VGG-16's f1: 16 x 8 x 8 = 1024."""
    assert cm.plan_fwd(128, 10, 8, 64) == cm.Plan("tile", 8, True, (1, 16, 8))
    assert cm.plan_fwd(128, 512, 8, 64) == cm.Plan("tile", 8, True,
                                                   (8, 16, 8))


@pytest.mark.parametrize("m,n,vec", [(1, 10, 8), (8, 6912, 8), (8, 1152, 4),
                                     (8, 84, 0), (64, 10, 0), (128, 512, 0),
                                     (1024, 6912, 8), (300, 70, 0)])
def test_never_splits_one_segment(m, n, vec):
    plan = cm.plan_fwd(m, n, 1, 64, vec=vec)
    assert not plan.split and plan.grid[2] == 1


@pytest.mark.parametrize("m", [512, 1024])
def test_prefill_takes_the_single_pass(m):
    """Prefill at w_gate (M = 8 slots x a 64- or 128-token bucket)."""
    d, n = DECODE["w_gate"]
    plan = cm.plan_fwd(m, n, _segments(d, XBAR), XBAR, vec=8)
    assert plan == cm.Plan("tile", 64, False, (108, m // 64, 1))


def test_gate_and_q8_never_stream():
    """vec = 0 (K1g, K4): the tile kernel, even at decode-sized M."""
    for name, (d, n) in DECODE.items():
        assert cm.plan_fwd(8, n, _segments(d, XBAR), XBAR).kernel == "tile"


def test_stream_needs_x_in_shared_memory():
    assert cm.plan_fwd(8, 1152, 2, 512, vec=8).kernel == "stream"
    assert cm.plan_fwd(8, 1152, 2, 1024, vec=8).kernel == "tile"


SWEEP = [(m, n, s, xbar, vec)
         for m in (1, 8, 9, 64, 128, 1024, 65536)
         for n in (1, 10, 256, 6912, 262144, 1 << 24)
         for s in (1, 2, 27)
         for xbar in (64, 256)
         for vec in (0, 4, 8)]


@pytest.mark.parametrize("vec", [0, 4, 8])
def test_counters_cover_every_split_plan(vec):
    """A split plan uses one arrival counter per output tile: the device's
    buffer holds the most any planned launch uses, and the grid fits."""
    for m, n, s, xbar, v in SWEEP:
        if v != vec:
            continue
        plan = cm.plan_fwd(m, n, s, xbar, vec=vec)
        assert s > 1 or not plan.split
        if plan.split:
            assert plan.tiles <= cm.N_COUNTERS, (m, n, s, xbar, plan)
        assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535


@pytest.mark.parametrize("force", [("tile", 16, False), ("tile", 64, True),
                                   ("stream", 4, False), ("stream", 16, True),
                                   ("wgmma", 64, False)])
def test_forced_plan_is_checked(force):
    """`_force` (tests only) builds legal plans and refuses the rest: here
    a tile of 16 rows, a split of one segment, the stream kernel without
    its split over several segments or with a strip it does not have, an
    unknown kernel."""
    n_seg = 1 if force == ("tile", 64, True) else 3
    with pytest.raises(ValueError):
        cm.plan_fwd(8, 256, n_seg, 64, vec=8, _force=force)
    assert cm.plan_fwd(8, 256, 3, 64, vec=8, _force=("stream", 8, True)) \
        == cm.Plan("stream", 8, True, (4, 1, 3))


# ---------------------------------------------------------------------------
# bf16 operands: the tensor-core kernel ("mma")
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# (name, D padded to crossbar 256, N) of the LM paths' CADC linears
# (chip_smoke.py lm_kernel_shapes): gemma3-1b's 7 (wv as wk, w_up as
# w_gate), hubert-xlarge's, qwen2-moe-a2.7b's untied head, the recurrent
# configs' train shapes.
LM_SHAPES = [
    ("gemma3_1b.wq", 1280, 1024), ("gemma3_1b.wk", 1280, 256),
    ("gemma3_1b.wo", 1024, 1152), ("gemma3_1b.w_gate", 1280, 6912),
    ("gemma3_1b.w_down", 6912, 1152), ("hubert_xlarge.wq", 1280, 1280),
    ("hubert_xlarge.w_up", 1280, 5120), ("hubert_xlarge.w_down", 5120, 1280),
    ("hubert_xlarge.head", 1280, 512),
    ("hubert_xlarge.frontend_proj", 512, 1280),
    ("qwen2_moe_a27b.head", 2048, 152064),
    ("recurrentgemma_9b.rglru.w_gate", 4096, 4096),
    ("recurrentgemma_9b.rglru.ffn.w_gate", 4096, 12288),
    ("recurrentgemma_9b.rglru.ffn.w_down", 12288, 4096),
    ("recurrentgemma_9b.local.wk", 4096, 256),
    ("xlstm_13b.mlstm.w_up", 2048, 8192), ("xlstm_13b.mlstm.w_if", 4096, 8),
    ("xlstm_13b.mlstm.w_down", 4096, 2048),
    ("xlstm_13b.slstm.w_up_gate", 2048, 2730),
    ("xlstm_13b.slstm.w_down", 2816, 2048), ("xlstm_13b.head", 2048, 50432)]
_LM_IDS = [s[0] for s in LM_SHAPES]


def _legal_mma(plan, m, n, n_seg):
    """An mma plan whose grid fits CUDA's limits, whose split tiles fit the
    arrival counters, whose groups leave no segment group empty, and whose
    split scratch is indexable by 32-bit offsets."""
    assert plan.kernel == "mma" and plan.width in cm.MMA_ROWS
    assert plan.grid == (-(-n // cm.MMA_COLS), -(-m // plan.width),
                         plan.groups)
    assert plan.grid[0] <= 2**31 - 1 and max(plan.grid[1:]) <= 65535
    assert 1 <= plan.groups <= n_seg and plan.split == (plan.groups > 1)
    per = -(-n_seg // plan.groups)
    assert -(-n_seg // per) == plan.groups
    if plan.split:
        assert plan.tiles <= cm.N_COUNTERS and m * n < 2**31
    return plan


@pytest.mark.parametrize("name,d,n", LM_SHAPES, ids=_LM_IDS)
@pytest.mark.parametrize("m", [2048, 1024, 512, 32])
def test_bf16_lm_shapes_take_the_mma_kernel(name, d, n, m):
    """A train micro (2048 rows), a prefill (1024, 512) and a verify step
    (32) at every LM shape: K1 (vec 8) and K1g (vec 0) on bf16 operands
    plan the same legal mma launch."""
    n_seg = d // XBAR
    plan = cm.plan_fwd(m, n, n_seg, XBAR, vec=8, dtype=BF16)
    assert plan == cm.plan_fwd(m, n, n_seg, XBAR, dtype=BF16)
    _legal_mma(plan, m, n, n_seg)


@pytest.mark.parametrize("name", sorted(DECODE))
def test_bf16_gemma_train_micro_plan_is_the_models_fastest(name):
    """At gemma3-1b's seven shapes at M = 2048 the planner's plan is the
    one `_mma_seconds` rates fastest of every legal mma plan, and it keeps
    at least half the SMs busy."""
    d, n = DECODE[name]
    n_seg = d // XBAR
    plans = cm.mma_plans(2048, n, n_seg, XBAR)
    t = {p: cm._mma_seconds(p, 2048, n, n_seg, XBAR) for p in plans}
    assert t[plans[0]] == min(t.values())
    assert plans[0].blocks >= cm.SMS // 2


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(DECODE))
def test_bf16_decode_k1_streams_and_k1g_takes_mma(m, name):
    """M <= 8: K1 (vec 8) keeps the stream kernel; K1g (vec 0) takes the
    mma kernel with 32-row tiles."""
    d, n = DECODE[name]
    n_seg = d // XBAR
    assert cm.plan_fwd(m, n, n_seg, XBAR, vec=8, dtype=BF16).kernel \
        == "stream"
    plan = cm.plan_fwd(m, n, n_seg, XBAR, dtype=BF16)
    assert _legal_mma(plan, m, n, n_seg).width == 32


@pytest.mark.parametrize("name", sorted(DECODE))
def test_bf16_route_is_stable_under_splits(name):
    """Micro and data-parallel splits of M (2048 down to 9 rows) and
    tensor-parallel shards of the segments (every divisor's local count)
    never move a bf16 product off the mma kernel."""
    d, n = DECODE[name]
    n_seg = d // XBAR
    for m in (8192, 2048, 1024, 512, 256, 128, 64, 33, 32, 16, 9):
        for local in {n_seg // t for t in (1, 2, 4) if n_seg % t == 0}:
            for vec in (0, 8):
                assert cm.plan_fwd(m, n, local, XBAR, vec=vec,
                                   dtype=BF16).kernel == "mma"


@pytest.mark.parametrize("xbar", [8, 24, 40, 100, 250])
def test_bf16_xbar_off_16_takes_the_tile_kernel(xbar):
    """The mma kernel walks segments in whole k16 steps: an xbar off 16
    keeps bf16 on the tile kernel, as fp32, and no mma plan can be
    forced."""
    for m, n, vec in ((2048, 1152, 0), (32, 6912, 8), (8, 256, 0)):
        assert cm.plan_fwd(m, n, 3, xbar, vec=vec, dtype=BF16) \
            == cm.plan_fwd(m, n, 3, xbar, vec=vec)
        with pytest.raises(ValueError):
            cm.plan_fwd(m, n, 3, xbar, dtype=BF16, _force=("mma", 32, 1))


@pytest.mark.parametrize("vec", [0, 4, 8])
def test_fp32_plans_are_unchanged(vec):
    """The dtype keyword defaults to fp32, and fp32 plans never take the
    mma kernel: the stream and tile plans of the sweep are the same with
    and without it."""
    for m, n, s, xbar, v in SWEEP:
        if v != vec:
            continue
        plan = cm.plan_fwd(m, n, s, xbar, vec=vec)
        assert plan.kernel in ("tile", "stream")
        assert plan == cm.plan_fwd(m, n, s, xbar, vec=vec,
                                   dtype=torch.float32)


@pytest.mark.parametrize("xbar", [64, 256])
def test_bf16_plans_fit_over_the_sweep(xbar):
    """Every planned bf16 launch of the sweep has a grid within CUDA's
    limits and, split, tiles within the arrival counters."""
    for m, n, s, xb, vec in SWEEP:
        if xb != xbar:
            continue
        plan = cm.plan_fwd(m, n, s, xbar, vec=vec, dtype=BF16)
        if plan.kernel == "stream":
            assert m <= 8 and vec
            continue
        _legal_mma(plan, m, n, s)


@pytest.mark.parametrize("m,n,n_seg,xbar", [(2048, 1152, 27, 256),
                                            (32, 6912, 5, 256),
                                            (9, 8, 3, 48),
                                            (2047, 2730, 11, 256)])
def test_mma_plans_lists_every_legal_plan(m, n, n_seg, xbar):
    """`mma_plans`: the planner's plan first, then every legal (row tile,
    groups) pair once, a split among them."""
    plans = cm.mma_plans(m, n, n_seg, xbar)
    assert plans[0] == cm.plan_fwd(m, n, n_seg, xbar, dtype=BF16)
    assert len(set(plans)) == len(plans)
    assert any(p.split for p in plans) and any(not p.split for p in plans)
    for p in plans:
        _legal_mma(p, m, n, n_seg)
        assert cm.plan_fwd(m, n, n_seg, xbar, dtype=BF16,
                           _force=("mma", p.width, p.groups)) == p
    want = sum(1 for r in cm.MMA_ROWS for g in range(1, n_seg + 1)
               if (g & (g - 1) == 0 or g == n_seg)
               and -(-n_seg // -(-n_seg // g)) == g)
    assert len(plans) == want


@pytest.mark.parametrize("force", [("mma", 96, 1), ("mma", 16, 1),
                                   ("mma", 64, 1), ("mma", 128, 0),
                                   ("mma", 128, 4), ("mma", 32, 6)])
def test_forced_mma_plan_is_checked(force):
    """`_force` refuses an mma plan with a row tile it has not, no groups,
    an empty segment group (5 segments in 4 groups of 2), or more groups
    than segments; it refuses every mma plan on fp32 operands."""
    with pytest.raises(ValueError):
        cm.plan_fwd(64, 256, 5, 64, dtype=BF16, _force=force)
    with pytest.raises(ValueError):
        cm.plan_fwd(64, 256, 5, 64, _force=("mma", 32, 1))
    assert cm.plan_fwd(64, 256, 5, 64, dtype=BF16, _force=("mma", 32, 5)) \
        == cm.Plan("mma", 32, True, (2, 2, 5))


def test_mma_split_needs_32_bit_offsets():
    """A split's scratch [S, M, N] is indexed by 32-bit offsets a segment:
    no split plan where M * N reaches 2^31; the single pass still plans."""
    m, n = 65536, 1 << 15
    plans = cm.mma_plans(m, n, 4, 64)
    assert plans and not any(p.split for p in plans)
    assert not cm.plan_fwd(m, n, 4, 64, dtype=BF16).split
