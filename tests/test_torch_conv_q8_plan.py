"""K5's launch planner (kernels/cadc_conv.py `plan_conv_q8`), a pure
function of the shapes, the [Cout, D] layout of the codes its int8 tap
kernel reads (`q8_tap_weights`), the exact int32 -> fp32 step of that
kernel's epilogue, and the launch wrapper's checks that come before any
CUDA call. All run here on the CPU; the card tests
(tests/test_torch_kernels_cuda.py) hold every plan's results to each other
and to the plain version, bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cadc_conv as cc
from repro_torch.kernels import cadc_matmul as cm
from test_torch_conv_plan import _conv_layers, _out

XBARS = (64, 128, 256)


def _mn(b, h, k, cout, stride, padding):
    oh = _out(h, k, stride, padding)
    return b * oh * oh, cout


@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("model", ["vgg16", "resnet18", "snn"])
def test_every_q8_conv_has_a_plan(model, xbar):
    """A plan for every conv of the three q8 models: the int8 tap kernel
    exactly where `tap_aligned` holds, a grid within CUDA's limits that
    covers the output, and SMS blocks wherever a tile no wider than Cout
    gives them (else the smallest such tile)."""
    for b, h, cin, k, cout, stride, padding in _conv_layers(model):
        m, n = _mn(b, h, k, cout, stride, padding)
        plan = cc.plan_conv_q8(m, n, cin, xbar)
        assert plan.kernel == ("tap" if cc.tap_aligned(cin, xbar)
                               else "gather")
        assert plan.fits()
        bm, bn = plan.tile
        rows, cols = ((plan.grid[0], plan.grid[1]) if plan.kernel == "tap"
                      else (plan.grid[1], plan.grid[0]))
        assert rows * bm >= m and cols * bn >= n and plan.grid[2] == 1
        if plan.kernel == "gather":
            assert plan.tile == cc.GATHER_TILE
            continue
        fitting = [t for t in cc.Q8_TAP_TILES if t[1] <= max(n, 32)]
        blocks = [-(-m // t[0]) * -(-n // t[1]) for t in fitting]
        want = next((t for t, nb in zip(fitting, blocks) if nb >= cm.SMS),
                    fitting[-1])
        assert plan.tile == want, (model, m, n, plan)
        if max(blocks) >= cm.SMS:
            assert plan.blocks >= cm.SMS


def test_q8_tap_kernel_takes_the_models_convs():
    """The int8 tap kernel takes 12 of VGG-16's 13 convs, 19 of
    ResNet-18's 20 and the SNN's conv2 at every crossbar; the gather kernel
    the first convs (Cin 3, the SNN's Cin 2)."""
    for model, n_tap in (("vgg16", 12), ("resnet18", 19), ("snn", 1)):
        for xbar in XBARS:
            kernels = [cc.plan_conv_q8(*_mn(b, h, k, cout, s, pad), cin,
                                       xbar).kernel
                       for b, h, cin, k, cout, s, pad in _conv_layers(model)]
            assert kernels.count("tap") == n_tap, (model, xbar)
            assert kernels[0] == "gather"


def test_vgg16_q8_plans_fill_the_card():
    """VGG-16 at batch 128, xbar 64: 128 x 64 while it gives SMS blocks,
    then narrower tiles down to 64 x 32 at stage 4 (M = 512: 32 blocks at
    128 x 64, 128 at 64 x 32)."""
    want = {(131072, 64, 64): ("tap", (128, 64), (1024, 1, 1)),
            (32768, 128, 64): ("tap", (128, 64), (256, 2, 1)),
            (32768, 128, 128): ("tap", (128, 64), (256, 2, 1)),
            (8192, 256, 128): ("tap", (128, 64), (64, 4, 1)),
            (2048, 512, 256): ("tap", (64, 64), (32, 8, 1)),
            (512, 512, 512): ("tap", (64, 32), (8, 16, 1)),
            (131072, 64, 3): ("gather", (64, 64), (1, 2048, 1))}
    for (m, n, cin), (kernel, tile, grid) in want.items():
        assert cc.plan_conv_q8(m, n, cin, 64) == cc.ConvPlan(kernel, tile,
                                                             grid)


@pytest.mark.parametrize("force,cin,xbar", [
    (("tap", (128, 64)), 3, 64),      # not tap-aligned: Cin
    (("tap", (64, 32)), 2, 64),       # the SNN's conv1
    (("tap", (64, 64)), 64, 48),      # not tap-aligned: xbar
    (("tap", (32, 32)), 64, 64),      # a tile the kernel does not have
    (("tap", (128, 128)), 64, 64),
    (("gather", (128, 128)), 3, 64),  # the gather kernel has 64 x 64 only
    (("wgmma", (128, 128)), 64, 64),  # no such kernel
])
def test_forced_q8_plan_is_checked(force, cin, xbar):
    with pytest.raises(ValueError, match="K5"):
        cc.plan_conv_q8(1000, 128, cin, xbar, _force=force)


def test_forced_q8_plans_are_built():
    assert cc.plan_conv_q8(1000, 96, 64, 64, _force=("tap", (128, 64))) \
        == cc.ConvPlan("tap", (128, 64), (8, 2, 1))
    assert cc.plan_conv_q8(1000, 96, 64, 64, _force=("tap", (64, 32))) == \
        cc.ConvPlan("tap", (64, 32), (16, 3, 1))
    assert cc.plan_conv_q8(1000, 96, 64, 64, _force=("gather", (64, 64))) \
        == cc.ConvPlan("gather", (64, 64), (2, 16, 1))
    plans = cc.conv_plans(1000, 96, 64, 64, q8=True)
    assert [(p.kernel, p.tile) for p in plans] == \
        [("gather", (64, 64))] + [("tap", t) for t in cc.Q8_TAP_TILES]
    assert cc.conv_plans(1000, 96, 3, 64, q8=True) == [
        cc.plan_conv_q8(1000, 96, 3, 64)]


@pytest.mark.parametrize("k1,k2,cin,cout", [(3, 3, 32, 64), (1, 1, 64, 128),
                                            (3, 3, 512, 40), (2, 3, 96, 10)])
def test_q8_tap_weights_are_the_codes_as_cout_by_d(k1, k2, cin, cout):
    """The [Cout, D] int8 matrix the wrapper passes the tap kernel: row n
    holds channel n's codes in the contraction's order (taps outer,
    channels fastest), contiguous."""
    rng = np.random.RandomState(k1 * 100 + cin + cout)
    w = rng.randint(-128, 128, (k1, k2, cin, cout)).astype(np.int8)
    wt = cc.q8_tap_weights(torch.from_numpy(w))
    assert wt.dtype == torch.int8 and wt.is_contiguous()
    assert tuple(wt.shape) == (cout, k1 * k2 * cin)
    got = wt.numpy()
    for n in (0, cout // 2, cout - 1):
        for i in range(k1):
            for j in range(k2):
                d0 = (i * k2 + j) * cin
                np.testing.assert_array_equal(got[n, d0:d0 + cin],
                                              w[i, j, :, n])


def test_magic_conversion_is_exact():
    """The tap kernel's psums start at the bits of 1.5 * 2^23; for every
    |p| <= 2^22 (xbar <= 256 with int8 codes: 256 * 128 * 128) the float
    of those bits minus 1.5 * 2^23 is float(p), exactly."""
    p = np.arange(-(1 << 22), (1 << 22) + 1, dtype=np.int32)
    got = (p + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, p.astype(np.float32))


def _q8_args(offset=0, cin=32):
    buf = torch.zeros(2 * 8 * 8 * cin + offset, dtype=torch.int8)
    x = buf[offset:].view(2, 8, 8, cin)
    return x, torch.zeros(3, 3, cin, 16, dtype=torch.int8), torch.ones(())


def test_q8_launch_refuses_a_tap_plan_off_16_bytes():
    """x starting 1 byte past a 16-byte boundary: a forced tap plan is
    refused before any launch (the planner's own choice would take the
    gather kernel instead)."""
    x, w, scale = _q8_args(offset=1)
    assert x.data_ptr() % 16 != 0
    plan = cc.plan_conv_q8(2 * 64, 16, 32, 64, _force=("tap", (64, 32)))
    with pytest.raises(ValueError, match="16-byte"):
        cc._conv_launch("k5", x, w, 64, "relu", (1, 1), "SAME", "none",
                        scale, plan=plan)


def test_q8_launch_refuses_another_shapes_plan():
    x, w, scale = _q8_args()
    plan = cc.plan_conv_q8(999, 16, 32, 64, _force=("tap", (64, 64)))
    with pytest.raises(ValueError, match="not one of"):
        cc._conv_launch("k5", x, w, 64, "relu", (1, 1), "SAME", "none",
                        scale, plan=plan)
