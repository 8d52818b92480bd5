"""K2's launch planner over matrices (kernels/cadc_matmul.py `plan_bwd`), a
pure function of the shapes and the gate mode: the dx tile (rows of M x
columns of one segment), the dw tile (rows of D in one segment x columns
of N) and dw's splits of M, for the kernels of csrc/cadc_bwd.cu. It runs
here on the CPU; the card tests (tests/test_torch_kernels_cuda.py) hold
every plan's dx bitwise to the planner's and its dw to the plain version.

The shapes are every matrix K2 sees on the models' paths: the FC layers
(D padded to whole crossbars) and every conv's im2col patches (M =
B*OH*OW, D = K*K*Cin, N = Cout): the stems and LeNet-5 on every path, and
every conv under the recompute gate and the q8 straight-through backward.
"""
import itertools

import pytest
import torch
from test_torch_conv_plan import _conv_layers, _out

from repro_torch.kernels import cadc_matmul as cm

XBARS = (64, 128, 256)
MODES = ("none", "packed", "bytes", "recompute")
MODELS = ("lenet5", "resnet18", "vgg16", "snn")
# (M, D, N) of the FC layers at their batches: LeNet-5 f1-f3 (batch 64),
# ResNet-18's fc and VGG-16's f1-f3 (batch 128), the SNN's fc (batch 32).
FC = [(64, 400, 120), (64, 120, 84), (64, 84, 10), (128, 512, 10),
      (128, 512, 512), (128, 512, 100), (32, 4096, 11)]


def _shapes(xbar):
    """(M, D, N) of every K2 matrix of the four models at crossbar xbar."""
    out = {(m, -(-d // xbar) * xbar, n) for m, d, n in FC}
    for model in MODELS:
        for b, h, cin, k, cout, stride, padding in _conv_layers(model):
            oh = _out(h, k, stride, padding)
            out.add((b * oh * oh, k * k * cin, cout))
    return sorted(out)


def _widths(d, xbar):
    """Each segment's columns."""
    return [min(xbar, d - s) for s in range(0, d, xbar)]


def _cases():
    return [(m, d, n, xbar) for xbar in XBARS for m, d, n in _shapes(xbar)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("xbar", XBARS)
def test_dx_tile_is_the_narrowest_that_covers(xbar, mode):
    """dx: the segment width of the tile is the narrowest of BWD_SEG_COLS
    that covers the widest segment (a 27-, 25- or 18-wide stem segment takes
    32, not 64), every segment's columns are covered by whole tiles of the
    grid, and every row tile by one block (a wave of blocks, each taking
    every grid[0]-th row tile); recompute's dx keeps 64 x 64, a block a
    tile."""
    for m, d, n in _shapes(xbar):
        plan = cm.plan_bwd(m, n, d, xbar, mode)
        rows, cols = plan.dx_tile
        widths = _widths(d, xbar)
        if mode == "recompute":
            assert plan.kernel == "recompute"
            assert plan.dx_tile == cm.BWD_RECOMPUTE_DX
        else:
            assert plan.kernel == "tile"
            covering = [c for c in cm.BWD_SEG_COLS if c >= max(widths)]
            assert cols == (covering[0] if covering else
                            cm.BWD_SEG_COLS[-1])
            assert plan.dx_tile in cm.BWD_DX_TILES
        col_tiles = sum(-(-wd // cols) for wd in widths)
        assert plan.dx_grid[1] == col_tiles
        row_tiles = -(-m // rows)
        if mode == "recompute":  # a block a tile
            assert plan.dx_grid[0] == row_tiles
        else:  # a wave of blocks striding over the row tiles
            assert plan.dx_grid[0] == min(row_tiles,
                                          -(-2 * cm.SMS // col_tiles))
        assert plan.dx_grid[2] == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("xbar", XBARS)
def test_dw_splits_whole_k_tiles_about_one_wave(xbar, mode):
    """dw: rows of D narrowed as dx's columns (or 32), N covered by whole
    tiles,
    M split into ranges of whole 32-row k-tiles that cover it once; the
    grid holds at most one wave (two blocks an SM) unless unsplit, and at
    least half of what the rows allow (one or half a wave)."""
    for m, d, n in _shapes(xbar):
        plan = cm.plan_bwd(m, n, d, xbar, mode)
        rw, nw = plan.dw_tile
        widths = _widths(d, xbar)
        assert rw in (cm.BWD_SEG_COLS[0],
                      cm.plan_bwd(m, n, d, xbar, "packed").dx_tile[1])
        assert nw in cm.BWD_DW_COLS
        assert nw == cm.BWD_DW_COLS[0] or 2 * n > nw
        assert plan.dw_grid[0] == -(-n // nw)
        assert plan.dw_grid[1] == sum(-(-wd // rw) for wd in widths)
        rows, splits = plan.dw_rows, plan.dw_splits
        assert rows % 32 == 0 and rows >= 32
        assert splits * rows >= m > (splits - 1) * rows
        tiles = plan.dw_tiles
        blocks = tiles * splits
        assert splits == 1 or blocks <= 2 * cm.SMS
        most = tiles * max(1, min(2 * cm.SMS // tiles, -(-m // 256)))
        if tiles <= cm.N_COUNTERS:
            assert 2 * blocks + tiles >= most, (m, d, n, plan)


@pytest.mark.parametrize("need_dx,need_dw", [(True, True), (True, False),
                                             (False, True)])
@pytest.mark.parametrize("mode", MODES)
def test_launches_and_fits(mode, need_dx, need_dw):
    """At most two launches, one where only dx or dw is wanted (a zero grid
    is a launch not made); every grid within CUDA's limits; the tiles do
    not depend on which of dx and dw is wanted."""
    for m, d, n, xbar in _cases():
        plan = cm.plan_bwd(m, n, d, xbar, mode, need_dx, need_dw)
        both = cm.plan_bwd(m, n, d, xbar, mode)
        assert plan.fits()
        assert plan.launches == need_dx + need_dw <= 2
        assert (plan.dx_grid == both.dx_grid) == need_dx
        assert (plan.dw_grid == both.dw_grid) == need_dw
        assert (plan.dx_tile, plan.dw_tile) == (both.dx_tile, both.dw_tile)
        if not need_dw:
            assert plan.dw_rows == 0


@pytest.mark.parametrize("xbar", XBARS)
def test_dw_plan_does_not_depend_on_the_gate(xbar):
    """Every gate mode, the recompute gate too, gets one dw tile and split
    for a shape, so the recomputed gate's dw is bitwise the saved gate's."""
    for m, d, n in _shapes(xbar):
        plans = {cm.plan_bwd(m, n, d, xbar, mode)[3:] for mode in MODES}
        assert len(plans) == 1


def test_the_stems_take_narrow_tiles():
    """ResNet-18's and VGG-16's stems (M 131072, D 27, N 64), the SNN's conv1
    (D 18, N 32) and LeNet-5's c1 (D 25, N 6): 32-wide tiles for dx and dw;
    dw splits M so that each tile's last block adds few partials."""
    for m, d, n in [(131072, 27, 64), (32768, 18, 32), (50176, 25, 6)]:
        plan = cm.plan_bwd(m, n, d, 64, "packed")
        assert plan.dx_tile == (128, 32), plan
        assert plan.dw_tile[0] == 32, plan
        assert plan.dw_splits > 1 and plan.dw_tiles * plan.dw_splits >= 64
    stem = cm.plan_bwd(131072, 64, 27, 64, "packed")
    assert stem.dw_tile[1] < 64 and stem.dw_tiles * stem.dw_splits >= cm.SMS


def test_fc_layers_do_not_split():
    """M <= 128: too few rows to split (each split at least 256 rows)."""
    for m, d, n in FC:
        plan = cm.plan_bwd(m, n, -(-d // 64) * 64, 64, "packed")
        assert plan.dw_splits == 1 and plan.dw_rows >= m


@pytest.mark.parametrize("mode", MODES)
def test_every_listed_plan_is_admitted(mode):
    """bwd_plans: the planner's plan first, then every dx and dw tile of
    the tables (recompute's one dx tile) and the unsplit and twice-split
    dw, each a plan `_force` builds again."""
    for m, d, n in [(131072, 27, 64), (6400, 150, 16), (128, 512, 10),
                    (64, 128, 84)]:
        plans = cm.bwd_plans(m, n, d, 64, mode)
        assert plans[0] == cm.plan_bwd(m, n, d, 64, mode)
        assert len(set(plans)) == len(plans)
        for p in plans:
            assert p == cm.plan_bwd(m, n, d, 64, mode,
                                    _force=(p.dx_tile, p.dw_tile,
                                            p.dw_splits))
        assert {p.dx_tile for p in plans} == (
            {cm.BWD_RECOMPUTE_DX} if mode == "recompute" else
            set(cm.BWD_DX_TILES))
        assert {p.dw_tile for p in plans} == set(
            itertools.product(cm.BWD_SEG_COLS, cm.BWD_DW_COLS))
        splits = {p.dw_splits for p in plans}
        assert 1 in splits


@pytest.mark.parametrize("force,mode", [
    (((64, 64), (32, 16), 1), "packed"),     # dx tile not in the table
    (((256, 64), (32, 16), 1), "packed"),    # dx tile not in the table
    (((128, 32), (16, 16), 1), "packed"),    # dw rows not in the table
    (((128, 32), (32, 128), 1), "packed"),   # dw columns not in the table
    (((128, 32), (32, 16), 0), "none"),      # no split
    (((128, 32), (32, 16), 4097), "bytes"),  # more splits than k-tiles
    (((128, 32), (32, 16), 1), "recompute"),  # recompute's dx is 64 x 64
    (((64, 64), (64, 64), 8), "recompute"),   # fine: the control case
])
def test_force_rejects_what_the_shape_does_not_admit(force, mode):
    m, d, n = 131072, 27, 64
    if force == ((64, 64), (64, 64), 8):
        plan = cm.plan_bwd(m, n, d, 64, mode, _force=force)
        assert plan.dw_splits == 8 and plan.kernel == "recompute"
        return
    with pytest.raises(ValueError, match="no such plan"):
        cm.plan_bwd(m, n, d, 64, mode, _force=force)


def test_force_rejects_grids_past_cuda_limits():
    """70000 segments of 32 columns: dx's and dw's grid.y exceed 65535."""
    d = 32 * 70000
    with pytest.raises(ValueError, match="exceed CUDA's grid"):
        cm.plan_bwd(64, 16, d, 32, "packed")
    with pytest.raises(ValueError, match="no such plan"):
        cm.plan_bwd(64, 16, d, 32, "packed",
                    _force=((64, 32), (32, 16), 1))


def test_plans_are_cached_and_lists_accepted():
    """The same plan object for the same shape; _force takes lists."""
    a = cm.plan_bwd(131072, 64, 27, 64, "packed")
    assert cm.plan_bwd(131072, 64, 27, 64, "packed") is a
    b = cm.plan_bwd(131072, 64, 27, 64, "packed",
                    _force=[list(a.dx_tile), list(a.dw_tile), a.dw_splits])
    assert b == a


def test_bad_mode_and_sizes_raise():
    with pytest.raises(ValueError, match="resolved gate mode"):
        cm.plan_bwd(64, 16, 64, 64, "auto")
    with pytest.raises(ValueError, match=">= 1"):
        cm.plan_bwd(0, 16, 64, 64, "packed")


# ---------------------------------------------------------------------------
# the bf16 route: the tensor-core kernels (plan kernel "mma")
# ---------------------------------------------------------------------------

# (name, D padded to crossbar 256, N) of every CADC linear the LM train
# paths run (chip_smoke.py lm_kernel_shapes): gemma3-1b's seven (wv = wk,
# w_up = w_gate), hubert-xlarge's, qwen2-moe-a2.7b's untied head, the
# recurrent configs'
LM_SHAPES = [
    ("gemma3_1b.wq", 1280, 1024), ("gemma3_1b.wk", 1280, 256),
    ("gemma3_1b.wv", 1280, 256), ("gemma3_1b.wo", 1024, 1152),
    ("gemma3_1b.w_gate", 1280, 6912), ("gemma3_1b.w_up", 1280, 6912),
    ("gemma3_1b.w_down", 6912, 1152),
    ("hubert_xlarge.wq", 1280, 1280), ("hubert_xlarge.w_up", 1280, 5120),
    ("hubert_xlarge.w_down", 5120, 1280), ("hubert_xlarge.head", 1280, 512),
    ("hubert_xlarge.frontend_proj", 512, 1280),
    ("qwen2_moe_a27b.head", 2048, 152064),
    ("recurrentgemma_9b.rglru.w_gate", 4096, 4096),
    ("recurrentgemma_9b.ffn.w_gate", 4096, 12288),
    ("recurrentgemma_9b.ffn.w_down", 12288, 4096),
    ("recurrentgemma_9b.local.wk", 4096, 256),
    ("xlstm_13b.mlstm.w_up", 2048, 8192), ("xlstm_13b.mlstm.w_if", 4096, 8),
    ("xlstm_13b.mlstm.w_down", 4096, 2048),
    ("xlstm_13b.slstm.w_up_gate", 2048, 2730),
    ("xlstm_13b.slstm.w_down", 2816, 2048), ("xlstm_13b.head", 2048, 50432)]
# (name, local D, N, xbar) of the TP / SP row linears' local segments at 2
# ranks: gemma3-1b's wo and w_down at crossbar 128 (4 and 27 segments a
# rank), recurrentgemma-9b's RG-LRU output (8 segments of 256 a rank)
TP_LOCAL = [("gemma3_1b.wo", 4 * 128, 1152, 128),
            ("gemma3_1b.w_down", 27 * 128, 1152, 128),
            ("recurrentgemma_9b.rglru.w_out", 8 * 256, 4096, 256)]
LM_M = 2048
BF16 = torch.bfloat16
GATES01 = [("identity", "none"), ("relu", "packed"), ("relu", "bytes")]


def _check_mma_plan(plan, m, n, d, xbar):
    """An mma plan: its tiles, a block a dx tile covering every segment
    column once, dw's tiles over the segments' rows and N, M split into
    whole slices covering it once, grids within CUDA's limits and a
    split's tiles within the arrival counters."""
    assert plan.kernel == "mma"
    assert plan.dx_tile in cm.MMA_BWD_DX_TILES
    assert plan.dw_tile == cm.MMA_BWD_DW_TILE
    widths = [min(xbar, d - s) for s in range(0, d, xbar)]
    assert plan.dx_grid == (-(-m // plan.dx_tile[0]),
                            sum(-(-wd // 128) for wd in widths), 1)
    assert plan.dw_grid[:2] == (-(-n // 128),
                                sum(-(-wd // 128) for wd in widths))
    rows, splits = plan.dw_rows, plan.dw_splits
    assert rows % 64 == 0 and splits * rows >= m > (splits - 1) * rows
    assert plan.fits() and plan.launches == 2
    assert splits == 1 or plan.dw_tiles <= cm.N_COUNTERS


@pytest.mark.parametrize("fn,mode", GATES01)
@pytest.mark.parametrize("name,d,n", LM_SHAPES, ids=[s[0] for s in LM_SHAPES])
def test_bf16_lm_shapes_plan_the_mma_kernels(name, d, n, fn, mode):
    """Every LM train path's linear at a micro's M = 2048, crossbar 256, on
    bf16 operands under a gate of 0s and 1s plans the tensor-core kernels,
    with a legal plan (`_check_mma_plan`), and so does every plan
    `bwd_plans` lists for it."""
    plan = cm.plan_bwd(LM_M, n, d, 256, mode, dtype=BF16, fn=fn)
    _check_mma_plan(plan, LM_M, n, d, 256)
    plans = cm.bwd_plans(LM_M, n, d, 256, mode, dtype=BF16, fn=fn)
    assert plans[0] == plan and len(set(plans)) == len(plans)
    for p in plans:
        _check_mma_plan(p, LM_M, n, d, 256)
        assert p == cm.plan_bwd(LM_M, n, d, 256, mode, dtype=BF16, fn=fn,
                                _force=(p.dx_tile, p.dw_tile, p.dw_splits))
    assert {p.dx_tile for p in plans} == set(cm.MMA_BWD_DX_TILES)
    assert 1 in {p.dw_splits for p in plans}


@pytest.mark.parametrize("name,d,n,xbar", TP_LOCAL,
                         ids=[s[0] for s in TP_LOCAL])
@pytest.mark.parametrize("m", [LM_M, LM_M // 2, 1024 // 2, 1000])
def test_bf16_route_is_stable_under_splits_of_m(name, d, n, xbar, m):
    """The TP / SP row linears' local segments plan the mma kernels at a
    micro's rows and at its splits over data-parallel ranks and sequence
    blocks: the route follows the dtype and the gate, never M."""
    for fn, mode in GATES01:
        _check_mma_plan(cm.plan_bwd(m, n, d, xbar, mode, dtype=BF16, fn=fn),
                        m, n, d, xbar)


@pytest.mark.parametrize("m", [1, 9, 33, 2047])
@pytest.mark.parametrize("n,xbar", [(8, 64), (200, 48), (2730, 256),
                                    (11, 64), (504, 128), (1000, 16)])
def test_bf16_ragged_shapes_plan_the_mma_kernels(m, n, xbar):
    """The card tests' ragged cases: every M and N, xbar 48 and 16 (tiles
    wider than a segment), D of three segments."""
    for fn, mode in GATES01:
        _check_mma_plan(cm.plan_bwd(m, n, 3 * xbar, xbar, mode, dtype=BF16,
                                    fn=fn), m, n, 3 * xbar, xbar)


@pytest.mark.parametrize("fn,mode,kernel", [
    ("sublinear", "bytes", "tile"), ("supralinear", "bytes", "tile"),
    ("tanh", "bytes", "tile"), ("relu", "recompute", "recompute"),
    ("sublinear", "recompute", "recompute")])
@pytest.mark.parametrize("name,d,n", LM_SHAPES[:7],
                         ids=[s[0] for s in LM_SHAPES[:7]])
def test_bf16_fp32_gates_plan_the_cuda_core_kernels(name, d, n, fn, mode,
                                                    kernel):
    """The fp32-gate fns (g ⊙ f' is no bf16 value) and the recompute gate
    keep today's kernels on bf16 operands: the kernel's name says so and
    the plan is the fp32 call's."""
    plan = cm.plan_bwd(LM_M, n, d, 256, mode, dtype=BF16, fn=fn)
    assert plan.kernel == kernel
    assert plan == cm.plan_bwd(LM_M, n, d, 256, mode)
    assert cm.bwd_kernel(BF16, mode, fn, 256) == kernel


@pytest.mark.parametrize("xbar", [24, 40, 100, 200])
def test_bf16_xbar_off_16_plans_the_cuda_core_kernels(xbar):
    """An xbar of no whole k16 steps keeps the bf16 call on the CUDA-core
    kernels, under every gate."""
    for fn, mode in GATES01:
        plan = cm.plan_bwd(LM_M, 300, 3 * xbar, xbar, mode, dtype=BF16,
                           fn=fn)
        assert plan.kernel == "tile"
        assert plan == cm.plan_bwd(LM_M, 300, 3 * xbar, xbar, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("xbar", XBARS)
def test_fp32_plans_do_not_change(xbar, mode):
    """fp32 operands plan as before whatever the fn (the default dtype is
    fp32, and fp32 never takes the mma kernels), the LM shapes too."""
    cases = [(m, d, n) for m, d, n in _shapes(xbar)]
    cases += [(LM_M, -(-d // xbar) * xbar, n) for _, d, n in LM_SHAPES[:7]]
    for m, d, n in cases:
        plan = cm.plan_bwd(m, n, d, xbar, mode)
        assert plan.kernel == ("recompute" if mode == "recompute" else
                               "tile")
        for fn in ("relu", "sublinear", "identity"):
            assert cm.plan_bwd(m, n, d, xbar, mode, dtype=torch.float32,
                               fn=fn) == plan


def test_bf16_bytes_needs_the_fn():
    """Under 'bytes' the gate's dtype decides the bf16 kernel, so the
    planner needs the fn; fp32 does not."""
    with pytest.raises(ValueError, match="needs the fn"):
        cm.plan_bwd(LM_M, 1152, 1024, 256, "bytes", dtype=BF16)
    assert cm.plan_bwd(LM_M, 1152, 1024, 256, "bytes").kernel == "tile"


@pytest.mark.parametrize("force", [
    ((128, 32), (128, 128), 1),     # a CUDA-core dx tile
    ((128, 128), (32, 16), 1),      # a CUDA-core dw tile
    ((256, 128), (128, 128), 1),    # dx rows not in the table
    ((128, 128), (128, 128), 0),    # no split
    ((128, 128), (128, 128), 33),   # more splits than M has slices
])
def test_bf16_force_rejects_what_the_mma_kernels_do_not_take(force):
    with pytest.raises(ValueError, match="no such plan"):
        cm.plan_bwd(LM_M, 1152, 1024, 256, "packed", dtype=BF16, fn="relu",
                    _force=force)
    ok = cm.plan_bwd(LM_M, 1152, 1024, 256, "packed", dtype=BF16, fn="relu",
                     _force=((64, 128), (128, 128), 32))
    assert ok.dw_splits == 32 and ok.dw_rows == 64


# gemma3-1b's plans at M = 2048 and 512, the fastest that
# tools/profile_k2_matrix.py --set lm timed (H100 80GB HBM3, 700 W) within
# 3 % where the planner's pick is not it: (dx rows, dw splits)
GEMMA_PLANS = {2048: {"wq": (64, 3), "wk": (64, 4), "wo": (128, 3),
                      "w_gate": (64, 1), "w_down": (128, 1)},
               512: {"wq": (64, 1), "wk": (64, 1), "wo": (64, 1),
                     "w_gate": (64, 1), "w_down": (128, 1)}}


@pytest.mark.parametrize("m", sorted(GEMMA_PLANS))
def test_bf16_gemma_plans(m):
    """At gemma3-1b's shapes the fitted model picks the timed plans: dw's
    M split where its tiles are fewer than the SMs at a micro's 2048 rows
    (wq, wk, wo) and not where they are many (the FFN) or the rows few;
    the 64-row dx tile where the 128-row one leaves a wave short."""
    shapes = {name.split(".")[1]: (d, n) for name, d, n in LM_SHAPES[:7]}
    for name, (rows, splits) in GEMMA_PLANS[m].items():
        d, n = shapes[name]
        plan = cm.plan_bwd(m, n, d, 256, "packed", dtype=BF16, fn="relu")
        assert (plan.dx_tile[0], plan.dw_splits) == (rows, splits), (
            name, plan)
