"""K3's launch planner (kernels/cadc_conv.py `plan_conv`), a pure function
of the shapes: the tap-aligned kernel or the gather kernel, and the tile.
It runs here on the CPU, as do the launch wrapper's checks that come
before any CUDA call; the card tests (tests/test_torch_kernels_cuda.py)
hold every plan's results to each other and to the plain version."""
import pytest
import torch

from repro_torch.kernels import cadc_conv as cc
from repro_torch.kernels import cadc_matmul as cm

XBARS = (64, 128, 256)
VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def _out(h, k, stride, padding):
    if padding == "VALID":
        return (h - k) // stride + 1
    return -(-h // stride)


def _conv_layers(model):
    """(B, H, Cin, K, Cout, stride, padding) of every conv of the model at
    the batch and width its training or eval path runs (as chip_smoke.py
    `conv_layers`)."""
    if model == "lenet5":
        return [(64, 32, 1, 5, 6, 1, "VALID"), (64, 14, 6, 5, 16, 1, "VALID")]
    if model == "vgg16":
        out, h, cin = [], 32, 3
        for c, n in VGG_CFG:
            for _ in range(n):
                out.append((128, h, cin, 3, c, 1, "SAME"))
                cin = c
            h //= 2
        return out
    if model == "snn":
        return [(32, 32, 2, 3, 32, 1, "SAME"), (32, 16, 32, 3, 64, 1, "SAME")]
    out, h, cin = [(128, 32, 3, 3, 64, 1, "SAME")], 32, 64
    for si, cout in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            s = 2 if si > 0 and bi == 0 else 1
            out.append((128, h, cin, 3, cout, s, "SAME"))
            ho = -(-h // s)
            out.append((128, ho, cout, 3, cout, 1, "SAME"))
            if s != 1 or cin != cout:
                out.append((128, h, cin, 1, cout, s, "SAME"))
            h, cin = ho, cout
    return out


@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("model", ["lenet5", "resnet18", "vgg16", "snn"])
def test_every_model_conv_has_a_plan(model, xbar):
    """A plan for every conv of the four models: the tap kernel exactly
    where Cin and xbar are multiples of 32, a grid within CUDA's limits
    that covers the output, and SMS blocks wherever a tap tile gives them."""
    for b, h, cin, k, cout, stride, padding in _conv_layers(model):
        oh = _out(h, k, stride, padding)
        m = b * oh * oh
        plan = cc.plan_conv(m, cout, cin, xbar)
        aligned = cin % 32 == 0 and xbar % 32 == 0
        assert plan.kernel == ("tap" if aligned else "gather")
        assert plan.fits()
        bm, bn = plan.tile
        rows, cols = ((plan.grid[0], plan.grid[1]) if plan.kernel == "tap"
                      else (plan.grid[1], plan.grid[0]))
        assert rows * bm >= m and cols * bn >= cout and plan.grid[2] == 1
        best = max(p.blocks for p in cc.conv_plans(m, cout, cin, xbar)
                   if p.kernel == plan.kernel)
        assert plan.blocks >= min(cm.SMS, best), (model, m, cout, plan)


@pytest.mark.parametrize("cin", [1, 2, 3, 6, 16, 31, 32, 48, 64, 96, 512])
def test_tap_kernel_exactly_when_aligned(cin):
    for xbar in (16, 32, 48, 64, 96, 100, 128, 256):
        plan = cc.plan_conv(8192, 256, cin, xbar)
        assert (plan.kernel == "tap") == (cin % 32 == 0 and xbar % 32 == 0)
        assert cc.tap_aligned(cin, xbar) == (plan.kernel == "tap")


def test_resnet18_plans_fill_the_card():
    """ResNet-18 at batch 128, xbar 64: 128 x 64 tiles while they give SMS
    blocks (stages 0-2), 64 x 64 at stage 3 (M = 2048: 128 vs 256
    blocks); the stem takes the gather kernel."""
    want = {(131072, 64, 64): ("tap", (128, 64), (1024, 1, 1)),
            (32768, 128, 128): ("tap", (128, 64), (256, 2, 1)),
            (8192, 256, 256): ("tap", (128, 64), (64, 4, 1)),
            (2048, 512, 512): ("tap", (64, 64), (32, 8, 1)),
            (131072, 64, 3): ("gather", (64, 64), (1, 2048, 1))}
    for (m, n, cin), (kernel, tile, grid) in want.items():
        assert cc.plan_conv(m, n, cin, 64) == cc.ConvPlan(kernel, tile, grid)


@pytest.mark.parametrize("m,n", [(1, 1), (75, 10), (2048, 512),
                                 (131072, 64), (1 << 24, 96),
                                 (1 << 30, 512)])
def test_grids_are_within_cuda_limits(m, n):
    """Pixel tiles ride the tap kernel's x axis (2^31 - 1 blocks), so every
    planned tap grid fits; the gather kernel keeps them on y (65535)."""
    for cin, xbar in ((64, 64), (32, 256), (3, 64), (6, 64)):
        plan = cc.plan_conv(m, n, cin, xbar)
        gather_fits = -(-m // 64) <= 65535
        assert plan.fits() == (plan.kernel == "tap" or gather_fits)
        for p in cc.conv_plans(m, n, cin, xbar):
            assert p.grid[0] <= 2 ** 31 - 1


@pytest.mark.parametrize("force,cin,xbar", [
    (("tap", (128, 64)), 3, 64),      # not tap-aligned: Cin
    (("tap", (64, 64)), 64, 48),      # not tap-aligned: xbar
    (("tap", (32, 32)), 64, 64),      # a tile the kernel does not have
    (("tap", (128, 128)), 64, 64),
    (("gather", (128, 64)), 3, 64),   # the gather kernel has 64 x 64 only
    (("wgmma", (64, 64)), 64, 64),    # no such kernel
])
def test_forced_plan_is_checked(force, cin, xbar):
    with pytest.raises(ValueError):
        cc.plan_conv(1000, 128, cin, xbar, _force=force)


def test_forced_plans_are_built():
    assert cc.plan_conv(1000, 96, 64, 64, _force=("tap", (64, 64))) == \
        cc.ConvPlan("tap", (64, 64), (16, 2, 1))
    assert cc.plan_conv(1000, 96, 64, 64, _force=("gather", (64, 64))) == \
        cc.ConvPlan("gather", (64, 64), (2, 16, 1))
    assert [p.kernel for p in cc.conv_plans(1000, 96, 64, 64)] == \
        ["gather"] + ["tap"] * len(cc.TAP_TILES)
    assert cc.conv_plans(1000, 96, 3, 64) == [
        cc.plan_conv(1000, 96, 3, 64)]


def _args(b=2, h=8, cin=32, cout=16, offset=0):
    x = torch.zeros(b * h * h * cin + offset)[offset:].view(b, h, h, cin)
    return x, torch.zeros(3, 3, cin, cout)


def test_launch_refuses_a_gather_grid_past_65535_rows():
    """B*OH*OW = 4097 * 1024 needs 65552 row tiles of 64 on the gather
    kernel's y axis: refused before any launch. The same M fits the tap
    kernel, whose pixel tiles are on x."""
    x, w = torch.zeros(4097, 32, 32, 1), torch.zeros(3, 3, 1, 8)
    with pytest.raises(ValueError, match="grid"):
        cc._conv_launch("k3", x, w, 64, "relu", (1, 1), "SAME", "none", None)
    assert cc.plan_conv(4097 * 1024, 8, 32, 64).fits()


def test_launch_refuses_a_tap_plan_off_16_bytes():
    """x starting 4 bytes past a 16-byte boundary: a forced tap plan is
    refused before any launch (the planner's own choice would take the
    gather kernel instead)."""
    x, w = _args(offset=1)
    assert x.data_ptr() % 16 != 0
    plan = cc.plan_conv(2 * 64, 16, 32, 64, _force=("tap", (64, 64)))
    with pytest.raises(ValueError, match="16-byte"):
        cc._conv_launch("k3", x, w, 64, "relu", (1, 1), "SAME", "none",
                        None, plan=plan)


def test_launch_refuses_another_shapes_plan():
    x, w = _args()
    plan = cc.plan_conv(999, 16, 32, 64, _force=("tap", (64, 64)))
    with pytest.raises(ValueError, match="not one of"):
        cc._conv_launch("k3", x, w, 64, "relu", (1, 1), "SAME", "none",
                        None, plan=plan)


def test_q8_conv_takes_no_plan():
    """K5 takes no plan but its own (`plan_conv_q8`'s for the shape): a
    plan of another M, a tile its tap kernel does not have and a tap plan
    for a Cin it does not take are refused before any launch."""
    x, w = _args()
    xq, wq, scale = x.to(torch.int8), w.to(torch.int8), torch.ones(())
    refused = [cc.plan_conv_q8(999, 16, 32, 64, _force=("tap", (64, 32))),
               cc.ConvPlan("tap", (32, 32), (4, 1, 1)),
               cc.ConvPlan("gather", (128, 64), (1, 1, 1))]
    for plan in refused:
        with pytest.raises(ValueError):
            cc._conv_launch("k5", xq, wq, 64, "relu", (1, 1), "SAME", "none",
                            scale, plan=plan)
    x3, w3 = torch.zeros(2, 8, 8, 3, dtype=torch.int8), torch.zeros(
        3, 3, 3, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        cc._conv_launch("k5", x3, w3, 64, "relu", (1, 1), "SAME", "none",
                        scale, plan=cc.ConvPlan("tap", (64, 32), (2, 1, 1)))
