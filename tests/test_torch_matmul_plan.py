"""The CADC matmul forward's launch planner (kernels/cadc_matmul.py
`plan_fwd`), a pure function of the shapes: which kernel body, which tile
or strip, and whether the segments split over blocks. It runs here on the
CPU; the card tests (tests/test_torch_kernels_cuda.py) hold every plan's
results to each other and to the plain version."""
import pytest

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
