"""The conv backward of the port on the CPU: its planner and its plain
version.

`plan_conv_bwd` (kernels/cadc_conv.py) is a pure function of the shapes and
the gate mode: the tap-aligned dgrad / wgrad kernels (csrc/cadc_conv_bwd.cu)
or the patches route (im2col, K2, `_col2im`), with tiles, splits and grids.
The card tests (tests/test_torch_kernels_cuda.py) hold the kernels to the
plain version; here the plain version (`cadc_conv2d_bwd_torch`, the patches
route with K2's plain version) is held to jax.vjp of the JAX package's
`repro.core.conv.cadc_conv2d` (the XLA path: the Pallas conv cannot run on
jax 0.9.0) within 1e-4 of each gradient's scale — the JAX package's TOL —
for every gate mode, stride 2 and the 1x1 stride-2 projection, SAME, VALID
and explicit pads, segments spanning taps (xbar 96 over Cin 64) and ragged
Cout (10, 96). Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conv_plan import _conv_layers, _out

from repro.core import conv as jconv
from repro_torch.kernels import cadc_conv as cc
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops

TOL = 1e-4
XBARS = (64, 128, 256)
MODELS = ("lenet5", "resnet18", "vgg16", "snn")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _plan(b, h, cin, k, cout, stride, padding, xbar, mode="packed"):
    return cc.plan_conv_bwd((b, h, h, cin), (k, k, cin, cout),
                            (stride, stride), padding, xbar, mode)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xbar", XBARS)
@pytest.mark.parametrize("model", MODELS)
def test_tap_exactly_for_the_tap_aligned_convs(model, xbar):
    """Every conv of the four models: the tap kernels exactly where Cin and
    xbar are multiples of 32 (all model Couts are multiples of 4), grids
    within CUDA's limits that cover dx (every pixel of every stride class,
    every channel) and dw (every row of D, every column, every output
    pixel in one split); dx has SMS blocks wherever a tile gives them, dw
    as many splits as one wave of three blocks an SM holds."""
    for b, h, cin, k, cout, stride, padding in _conv_layers(model):
        plan = _plan(b, h, cin, k, cout, stride, padding, xbar)
        assert plan.kernel == ("tap" if cin % 32 == 0 and xbar % 32 == 0
                               else "patches")
        if plan.kernel == "patches":
            assert plan.why == "Cin or xbar not a multiple of 32"
            continue
        assert plan.fits()
        (bm, bn), (dbm, dbn) = plan.dx_tile, plan.dw_tile
        wide = cin % 64 == 0 and xbar % 64 == 0
        assert bn == 64 or not wide or plan.dx_tile == cc.DX_TILES[-1]
        assert dbm == (64 if wide else 32)
        assert dbn == 64 or (dbn == 128 and cout >= 128)
        px = b * (-(-h // stride)) ** 2
        assert plan.dx_grid == (-(-px // bm), cin // bn, stride * stride)
        m = b * _out(h, k, stride, padding) ** 2
        gx, gy, splits = plan.dw_grid
        assert gx * dbn >= cout and gy * dbm == k * k * cin
        assert plan.dw_rows % 32 == 0 and (splits - 1) * plan.dw_rows < m
        assert splits * plan.dw_rows >= m
        assert splits <= 64 and gx * gy <= cm.N_COUNTERS
        best = max(p.dx_blocks for p in cc.conv_bwd_plans(
            (b, h, h, cin), (k, k, cin, cout), (stride, stride), padding,
            xbar, "packed"))
        assert plan.dx_blocks >= min(cm.SMS, best), (model, plan)
        assert plan.dw_blocks <= 3 * cm.SMS or splits == 1
        assert (plan.dw_blocks + gx * gy > 3 * cm.SMS or splits == 64
                or plan.dw_rows <= 288), (model, plan)


@pytest.mark.parametrize("shape,why", [
    ((128, 32, 3, 3, 64, 1, "SAME"), "Cin or xbar"),    # ResNet-18's stem
    ((128, 32, 3, 3, 64, 1, "SAME"), "Cin or xbar"),    # VGG-16's first conv
    ((32, 32, 2, 3, 32, 1, "SAME"), "Cin or xbar"),     # the SNN's conv1
    ((64, 32, 1, 5, 6, 1, "VALID"), "Cin or xbar"),     # LeNet-5
    ((64, 14, 6, 5, 16, 1, "VALID"), "Cin or xbar"),
    ((128, 1, 512, 1, 10, 1, "VALID"), "Cout not"),     # ResNet-18's fc
    ((64, 1, 400, 1, 120, 1, "VALID"), "Cin or xbar"),  # LeNet-5's fcs
    ((64, 1, 120, 1, 84, 1, "VALID"), "Cin or xbar"),
    ((64, 1, 84, 1, 10, 1, "VALID"), "Cin or xbar"),
])
def test_patches_for_the_stems_lenet_and_fc_shapes(shape, why):
    """The stems, LeNet-5 and the FC layers (as 1x1 convs: they run K2 over
    matrices through CadcMatmulFn) take the patches route, saying why."""
    plan = _plan(*shape, 64)
    assert plan.kernel == "patches" and plan.why.startswith(why)
    assert plan.dx_blocks == plan.dw_blocks == 0


@pytest.mark.parametrize("fn", ["relu", "sublinear"])
def test_recompute_takes_the_patches_route(fn):
    mode = cm.gate_mode("recompute", fn)
    plan = _plan(128, 32, 64, 3, 64, 1, "SAME", 64, mode)
    assert plan == cc.ConvBwdPlan("patches", "the recompute gate")
    assert cc.conv_bwd_plans((128, 32, 32, 64), (3, 3, 64, 64), (1, 1),
                             "SAME", 64, mode) == []
    for auto_fn in ("relu", "sublinear", "identity"):  # auto never recomputes
        auto = cm.gate_mode("auto", auto_fn)
        assert _plan(128, 32, 64, 3, 64, 1, "SAME", 64, auto).kernel == "tap"


def test_resnet18_plans():
    """ResNet-18 at batch 128, xbar 64: dx on 128 x 64 tiles but where the
    grid or its longest blocks would leave the card waiting — stage 3
    (2048 pixels: 128 blocks) and its stride-2 conv (the 4-tap class) take
    64 x 64; dw split over M to fill waves of three blocks an SM where its
    tiles are few (9 at stage 0: 44 splits, 396 blocks), on 64 x 128 tiles
    where they fill the waves best (396 of 396 slots at stage 1, 360 at
    stage 2), else 64 x 64."""
    want = {
        (32, 64, 3, 64, 1): ((128, 64), (1024, 1, 1), (1, 9, 44), 3008),
        (32, 64, 3, 128, 2): ((128, 64), (256, 1, 4), (2, 9, 22), 1504),
        (32, 64, 1, 128, 2): ((128, 64), (256, 1, 4), (2, 1, 64), 512),
        (16, 128, 3, 128, 1): ((128, 64), (256, 2, 1), (1, 18, 22), 1504),
        (8, 256, 3, 256, 1): ((128, 64), (64, 4, 1), (2, 36, 5), 1664),
        (8, 256, 3, 512, 2): ((64, 64), (32, 4, 4), (4, 36, 2), 1024),
        (4, 512, 3, 512, 1): ((64, 64), (32, 8, 1), (8, 72, 1), 2048),
    }
    for (h, cin, k, cout, s), (tile, dx_grid, dw_grid, rows) in want.items():
        plan = _plan(128, h, cin, k, cout, s, "SAME", 64)
        assert (plan.dx_tile, plan.dx_grid, plan.dw_grid, plan.dw_rows) == \
            (tile, dx_grid, dw_grid, rows), (h, cin, k, cout, s)


@pytest.mark.parametrize("b,h", [(1, 1), (3, 9), (128, 32), (4096, 64),
                                 (1 << 16, 128)])
def test_grids_are_within_cuda_limits(b, h):
    """Pixel tiles ride the x axes (2^31 - 1 blocks); channels, D tiles,
    stride classes and splits stay far below 65535."""
    for cin, cout, k, s in ((64, 64, 3, 1), (32, 96, 3, 2), (512, 512, 1, 2)):
        plan = _plan(b, h, cin, k, cout, s, "SAME", 64)
        assert plan.kernel == "tap" and plan.fits()
        assert plan.dx_grid[0] <= 2 ** 31 - 1
        assert max(plan.dx_grid[1:] + plan.dw_grid[1:]) <= 65535


@pytest.mark.parametrize("force,cin,cout,xbar,mode", [
    (((128, 64), (64, 64), 1), 3, 64, 64, "packed"),    # not tap-aligned
    (((128, 32), (32, 64), 1), 64, 64, 48, "packed"),   # xbar 48
    (((128, 64), (64, 64), 1), 64, 10, 64, "packed"),   # Cout 10
    (((128, 64), (64, 64), 1), 64, 64, 64, "recompute"),  # patches' mode
    (((128, 64), (32, 64), 1), 96, 64, 96, "packed"),   # 64 channels straddle
    (((128, 32), (64, 128), 1), 96, 64, 96, "packed"),  # dw rows straddle
    (((32, 32), (32, 64), 1), 64, 64, 64, "packed"),    # no such dx tile
    (((128, 64), (128, 64), 1), 128, 64, 128, "packed"),  # no such dw tile
    (((128, 64), (64, 64), 0), 64, 64, 64, "packed"),   # no split
    (((128, 64), (64, 64), 9), 64, 64, 64, "packed"),   # more splits than
])                                                        # k-tiles
def test_forced_plan_is_checked(force, cin, cout, xbar, mode):
    """2 x 8 x 8 pixels: 128 output pixels, so at most 4 splits."""
    with pytest.raises(ValueError, match="no such plan"):
        cc.plan_conv_bwd((2, 8, 8, cin), (3, 3, cin, cout), (1, 1), "SAME",
                         xbar, mode, _force=force)


def test_forced_plans_are_built():
    shape = ((2, 16, 16, 64), (3, 3, 64, 96), (2, 2), "SAME", 64, "packed")
    p = cc.plan_conv_bwd(*shape, _force=((64, 32), (32, 64), 4))
    assert p == cc.ConvBwdPlan("tap", "", (64, 32), (2, 2, 4), (32, 64),
                               (2, 18, 4), 32)
    # splits round to whole 32-pixel k-tiles: 3 splits of 128 are 2 of 64
    assert cc.plan_conv_bwd(*shape, _force=((64, 32), (32, 64), 3)
                            ).dw_rows == 64
    plans = cc.conv_bwd_plans(*shape)
    assert plans[0] == cc.plan_conv_bwd(*shape)
    assert {q.dx_tile for q in plans} == set(cc.DX_TILES)
    assert {q.dw_tile for q in plans} == set(cc.DW_TILES)
    assert sorted({q.dw_splits for q in plans}) == [1, 2]
    # Cin 32: the 64-channel tiles do not apply
    plans = cc.conv_bwd_plans((2, 8, 8, 32), (3, 3, 32, 64), (1, 1), "SAME",
                              64, "packed")
    assert {q.dx_tile for q in plans} == {(128, 32), (64, 32)}
    assert {q.dw_tile for q in plans} == {(32, 128), (32, 64)}


# ---------------------------------------------------------------------------
# the plain version against jax.vjp of the JAX package
# ---------------------------------------------------------------------------

# (B, H, W, Cin, K, Cout, stride, padding, xbar)
CASES = [
    (2, 8, 8, 32, 3, 64, (2, 2), "SAME", 64),         # stride 2
    (2, 8, 8, 32, 1, 64, (2, 2), "SAME", 64),         # the 1x1 projection
    (2, 9, 9, 32, 3, 96, (1, 1), "VALID", 96),        # VALID, Cout 96
    (1, 7, 6, 32, 3, 10, (1, 1), ((1, 0), (2, 1)), 32),  # explicit, Cout 10
    (2, 6, 6, 64, 3, 16, (1, 1), "SAME", 96),         # segments span taps
]
# (fn, save_gate): every gate mode the backward takes
MODES = [("relu", "packed"), ("relu", "bytes"), ("relu", "recompute"),
         ("identity", "auto"), ("sublinear", "bytes"),
         ("sublinear", "recompute")]


def _case_inputs(case, seed=0):
    b, h, w, cin, k, cout, stride, padding, _ = case
    rng = np.random.RandomState(seed + 7 * h + cin + cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(
        np.float32)
    _, _, oh, ow = cc._geometry(x.shape, wt.shape, stride, padding)
    g = rng.randn(b, oh, ow, cout).astype(np.float32)
    return x, wt, g


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale


@pytest.mark.parametrize("fn,save_gate", MODES)
@pytest.mark.parametrize("case", CASES)
def test_bwd_torch_matches_jax_vjp(case, fn, save_gate):
    """cadc_conv2d_bwd_torch over K3's plain gate of the mode (the gate the
    forward saves) equals jax.vjp of cadc_conv2d."""
    *_, k, _, stride, padding, xbar = case
    x, w, g = _case_inputs(case)
    kw = dict(crossbar_size=xbar, fn=fn, stride=stride, padding=padding)
    _, vjp = jax.vjp(lambda a, b: jconv.cadc_conv2d(a, b, **kw), x, w)
    hx, hw = vjp(jnp.asarray(g))
    mode = cm.gate_mode(save_gate, fn)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _, gate = cc.cadc_conv2d_torch(
        xt, wt, mode=mode if mode in ("packed", "bytes") else "none", **kw)
    assert (gate is None) == (mode in ("none", "recompute"))
    dx, dw = cc.cadc_conv2d_bwd_torch(torch.from_numpy(g), xt, wt, gate,
                                      mode=mode, **kw)
    assert dx.shape == xt.shape and dw.shape == wt.shape
    _close(dx.numpy(), hx)
    _close(dw.numpy(), hw)
    only_dw = cc.cadc_conv2d_bwd_torch(torch.from_numpy(g), xt, wt, gate,
                                       mode=mode, need_dx=False, **kw)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


@pytest.mark.parametrize("save_gate", ["auto", "bytes", "recompute"])
@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]])
def test_conv_fn_on_cpu_gives_the_plain_backward(case, save_gate):
    """CadcConv2dFn on CPU tensors (ops.cadc_conv2d under autograd) gives
    exactly cadc_conv2d_bwd_torch's gradients — the patches route — and
    they are jax.vjp's."""
    *_, k, _, stride, padding, xbar = case
    x, w, g = _case_inputs(case, seed=3)
    kw = dict(crossbar_size=xbar, fn="relu", stride=stride, padding=padding)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.cadc_conv2d(xt, wt, save_gate=save_gate, **kw)
    (y * torch.from_numpy(g)).sum().backward()
    mode = cm.gate_mode(save_gate, "relu")
    _, gate = cc.cadc_conv2d_torch(
        xt.detach(), wt.detach(),
        mode=mode if mode in ("packed", "bytes") else "none", **kw)
    dx, dw = cc.cadc_conv2d_bwd_torch(torch.from_numpy(g), xt.detach(),
                                      wt.detach(), gate, mode=mode, **kw)
    assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dw)
    _, vjp = jax.vjp(lambda a, b: jconv.cadc_conv2d(a, b, **kw), x, w)
    hx, hw = vjp(jnp.asarray(g))
    _close(dx.numpy(), hx)
    _close(dw.numpy(), hw)


def test_the_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the tap kernels' wrapper raises before any launch: the
    plain version is cadc_conv2d_bwd_torch, and CadcConv2dFn takes it for
    CPU tensors."""
    x, w, g = (torch.from_numpy(a) for a in _case_inputs(CASES[0]))
    before = cc.cadc_conv2d_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cc.cadc_conv2d_bwd_cuda(g, x, w, None, crossbar_size=64,
                                fn="identity", stride=(2, 2), mode="none")
    assert cc.cadc_conv2d_bwd_cuda.launches == before
