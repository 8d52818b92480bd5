"""K4's launch planner (kernels/cadc_matmul.py `plan_fwd_q8`), a pure
function of the shapes: the single pass or the segments split over blocks
in groups, on the int8 tensor-core kernel (csrc/cadc_matmul.cu
`q8_mma_kernel`), which takes every shape. Also the exact int32 -> fp32
step of that kernel's epilogue and the launch wrapper's plan check, which
comes before any CUDA call. All run here on the CPU; the card tests
(tests/test_torch_kernels_cuda.py) hold every plan's results to each
other and to the plain version, bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cadc_matmul as cm

# (name, M, D, N) of every q8 FC layer at its eval batch: VGG-16 f1-f3
# (batch 128, 100 classes), ResNet-18's fc (batch 128, 10 classes), the
# SNN's fc (batch 32, 8 x 8 x 2 x 32 features, 11 classes)
Q8_FC = [("vgg16.f1", 128, 512, 512), ("vgg16.f2", 128, 512, 512),
         ("vgg16.f3", 128, 512, 100), ("resnet18.fc", 128, 512, 10),
         ("snn.fc", 32, 4096, 11)]
XBARS = (32, 64, 128, 256, 512)


def _segments(d, xbar):
    return -(-d // xbar)


@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("name,m,d,n", Q8_FC)
def test_every_q8_fc_has_a_plan_on_the_mma_kernel(name, m, d, n, xbar):
    """Every q8 FC shape gets a plan of the int8 tensor-core kernel (it
    takes every shape: there is no other K4 route): a grid of 16 x 32 tiles
    that covers the output, within CUDA's limits, segment groups the
    planner weighs, none of them empty, and a split's tiles within the
    arrival counters."""
    s = _segments(d, xbar)
    plan = cm.plan_fwd_q8(m, n, s, xbar)
    assert isinstance(plan, cm.Q8Plan)
    assert plan.grid[0] * cm.Q8_ROWS >= m and plan.grid[1] * cm.Q8_COLS >= n
    assert plan.grid[0] * cm.Q8_ROWS < m + cm.Q8_ROWS
    assert plan.grid[1] * cm.Q8_COLS < n + cm.Q8_COLS
    assert plan.grid[2] == plan.groups and plan.groups in cm._q8_groups(s)
    assert -(-s // -(-s // plan.groups)) == plan.groups
    assert plan.fits() and plan.grid[0] <= cm._GRID_X_MAX
    assert max(plan.grid[1:]) <= cm._GRID_YZ_MAX
    assert plan.split == (plan.groups > 1)
    if plan.split:
        assert plan.tiles <= cm.N_COUNTERS


@pytest.mark.parametrize("name,m,d,n", Q8_FC)
def test_main_path_plans(name, m, d, n):
    """At the paths' crossbar (64) the planner takes the single pass for
    VGG-16's and ResNet-18's FCs (8 segments, 8 warps a block: one round)
    and splits the SNN's 64 segments over blocks, as the sweep of
    tools/profile_k4.py found fastest on an H100."""
    plan = cm.plan_fwd_q8(m, n, _segments(d, 64), 64)
    if name.startswith("snn"):
        assert plan.split and plan.groups >= 8
    else:
        assert not plan.split and plan.blocks == plan.tiles


@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("name,m,d,n", Q8_FC)
def test_q8_plans_lists_every_group_count(name, m, d, n, xbar):
    """q8_plans: the planner's plan first, then every other group count of
    `_q8_groups` that leaves no group empty, each once."""
    s = _segments(d, xbar)
    plans = cm.q8_plans(m, n, s, xbar)
    assert plans[0] == cm.plan_fwd_q8(m, n, s, xbar)
    assert len(set(plans)) == len(plans)
    want = {g for g in cm._q8_groups(s) if cm._q8_group_ok(s, g)}
    assert {p.groups for p in plans} == want
    assert 1 in want and s in want


@pytest.mark.parametrize("force,m,n,s", [
    (0, 128, 512, 8),            # no groups
    (9, 128, 512, 8),            # more groups than segments
    (7, 128, 512, 8),            # groups of 2: only 4 are not empty
    (3, 32, 11, 4),              # groups of 2: the third is empty
    (1, 16 * 2**31, 10, 8),      # M tiles past grid x
    (1, 128, 32 * 65536, 8),     # N tiles past grid y
    (70000, 128, 10, 70000),     # groups past grid z
    (2, 16 * 2**16 + 1, 32, 8),  # a split's tiles past the counters
])
def test_forced_q8_plan_is_checked(force, m, n, s):
    with pytest.raises(ValueError, match="K4"):
        cm.plan_fwd_q8(m, n, s, 64, _force=force)


def test_forced_q8_plans_are_built():
    assert cm.plan_fwd_q8(100, 96, 8, 64, _force=4) == cm.Q8Plan(
        4, (7, 3, 4))
    assert cm.plan_fwd_q8(32, 11, 64, 64, _force=1) == cm.Q8Plan(
        1, (2, 1, 1))
    assert cm.plan_fwd_q8(32, 11, 5, 64, _force=3) == cm.Q8Plan(
        3, (2, 1, 3))   # groups of 2, 2 and 1
    with pytest.raises(ValueError, match="K4 plans"):
        cm.plan_fwd_q8(0, 10, 8, 64)


def test_planner_is_cached():
    """The plan is the same object on a second call, from the cache."""
    cm._plan_fwd_q8.cache_clear()
    a = cm.plan_fwd_q8(128, 512, 8, 64)
    b = cm.plan_fwd_q8(128, 512, 8, 64)
    assert a is b and cm._plan_fwd_q8.cache_info().hits == 1
    assert cm.plan_fwd_q8(128, 512, 8, 64, _force=2) is cm.plan_fwd_q8(
        128, 512, 8, 64, _force=2)


def test_model_rates_the_measured_costs():
    """The planner's model (`_q8_seconds`): more rounds of segments or more
    waves of blocks cost more, and a split pays for its merge."""
    single = cm._q8_plan(1, 128, 512)
    assert cm._q8_seconds(single, 16, 64) > cm._q8_seconds(single, 8, 64)
    assert cm._q8_seconds(single, 8, 256) > cm._q8_seconds(single, 8, 64)
    split = cm._q8_plan(2, 128, 512)   # 256 blocks: two waves
    assert cm._q8_seconds(split, 8, 64) > cm._q8_seconds(single, 8, 64)
    snn = [cm._q8_seconds(cm._q8_plan(g, 32, 11), 64, 64)
           for g in (1, 16)]
    assert snn[1] < snn[0]


def test_magic_conversion_is_exact_up_to_its_xbar():
    """The kernel's psums start at the bits Q8_MAGIC_BITS (1.5 * 2^23) up
    to Q8_MAGIC_MAX_XBAR; for every |p| <= 2^22 (that xbar with int8
    codes: 256 * 128 * 128) the float of those bits minus 1.5 * 2^23 is
    float(p), exactly. Past it (xbar 512: |p| up to 2^23) the trick is not
    exact, so the kernel converts with __int2float_rn there."""
    top = cm.Q8_MAGIC_MAX_XBAR * 128 * 128
    assert top == 1 << 22
    p = np.arange(-top, top + 1, dtype=np.int32)
    magic = np.float32(np.int32(cm.Q8_MAGIC_BITS).view(np.float32))
    assert magic == np.float32(12582912)
    got = (p + np.int32(cm.Q8_MAGIC_BITS)).view(np.float32) - magic
    np.testing.assert_array_equal(got, p.astype(np.float32))
    past = np.array([top + 1, -(2 * top) - 1], np.int32)
    bad = (past + np.int32(cm.Q8_MAGIC_BITS)).view(np.float32) - magic
    assert not np.array_equal(bad, past.astype(np.float32))


def _codes(m, d, n):
    return (torch.zeros(m, d, dtype=torch.int8),
            torch.zeros(d, n, dtype=torch.int8), torch.ones(()))


def test_q8_launch_refuses_another_shapes_plan():
    """A plan of another shape, or K1's kind of plan, is refused before any
    CUDA call."""
    x, w, scale = _codes(128, 512, 10)
    other = cm.plan_fwd_q8(128, 100, 8, 64, _force=1)
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm._fwd_launch(x, w, 64, "relu", "none", scale, plan=other)
    tile = cm.plan_fwd(128, 10, 8, 64)
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm._fwd_launch(x, w, 64, "relu", "none", scale, plan=tile)
    wrong_groups = cm.Q8Plan(7, (8, 1, 7))
    with pytest.raises(ValueError, match="K4"):
        cm._fwd_launch(x, w, 64, "relu", "none", scale, plan=wrong_groups)
