"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and are
marked `cuda`; elsewhere they skip. They import only torch and numpy, so
they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the fp32 kernels and their plain versions both sum fp32
psums, in other orders, so outputs and gradients agree within 1e-4 of
their scale (the JAX package's TOL); the q8 kernels K4 and K5 equal their
plain versions bitwise (exact integer psums, every later rounding the
same), gates included, but for tanh (CUDA's tanhf is not torch's: 1e-6 of
scale); gate bits agree wherever the psum is not
within 1e-5 of the output's scale of zero (elsewhere its sign can differ
with the summation order), and fp32 gates of curved fns within 1e-4 of
their scale where the psum exceeds 1e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.conv import im2col
from repro_torch.kernels import cadc_conv as cc
from repro_torch.kernels import cadc_matmul as cm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa

FNS = ["identity", "relu", "sublinear", "supralinear", "tanh"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("m", [1, 8, 70])
def test_cadc_matmul_kernel_matches_plain(cuda_device, dtype, fn, m):
    """Ragged M and N (N = 200 is not a multiple of the 64-column tile);
    fp32 psums on both sides, so only the summation order differs."""
    rng = np.random.RandomState(m)
    x = torch.from_numpy(rng.randn(m, 3 * 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(3 * 64, 200) / 14).astype(np.float32))
    x, w = x.to(cuda_device, dtype), w.to(cuda_device, dtype)
    before = cm.cadc_matmul_cuda.launches
    got = cm.cadc_matmul_cuda(x, w, crossbar_size=64, fn=fn)
    want = cm.cadc_matmul_torch(x, w, crossbar_size=64, fn=fn)
    torch.cuda.synchronize()
    assert cm.cadc_matmul_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_auto_dispatch_launches_the_kernel(cuda_device):
    x = torch.randn(4, 100, device=cuda_device)
    w = torch.randn(100, 30, device=cuda_device)
    before = cm.cadc_matmul_cuda.launches
    got = ops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="auto")
    assert cm.cadc_matmul_cuda.launches == before + 1
    want = ops.cadc_matmul(x, w, crossbar_size=32, fn="relu", impl="torch")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _geometry(rng, *, b=3, q_len=1, h=2, kh=1, hd=64, bs=8, nb=4,
              positions=(5, 20, 31)):
    n_blocks = b * nb + 2
    q = rng.randn(b, q_len, h, hd).astype(np.float32)
    kp = rng.randn(n_blocks, bs, kh, hd).astype(np.float32)
    vp = rng.randn(n_blocks, bs, kh, hd).astype(np.float32)
    tbl = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    tbl[0, 2:] = -1
    return q, kp, vp, tbl, np.asarray(positions, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["global", "local"])
@pytest.mark.parametrize("q_len,h,kh", [(1, 4, 1), (3, 4, 2), (1, 2, 2)])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_attention_kernel_matches_plain(cuda_device, kind, q_len, h,
                                              kh, softcap):
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(q_len + h),
                                    q_len=q_len, h=h, kh=kh)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, tbl, pos)]
    kw = dict(kind=kind, window=12, softcap=softcap)
    got = pa.paged_attention_cuda(*args, **kw)
    want = pa.paged_attention_torch(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_paged_attention_kernel_is_nan_proof(cuda_device):
    """NaN in unallocated blocks and in masked entries of live blocks
    leaves the output unchanged; an all -1 slot writes exactly 0."""
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(7))
    tbl[2] = -1
    dev = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    clean = pa.paged_attention_cuda(dev(q), dev(kp), dev(vp), dev(tbl),
                                     dev(pos), kind="global", window=64)
    used = set(tbl[tbl >= 0].tolist())
    for j in range(kp.shape[0]):
        if j not in used:
            kp[j] = vp[j] = np.nan
    kp[tbl[1, 2], 5:] = vp[tbl[1, 2], 5:] = np.nan   # slot 1 at position 20
    dirty = pa.paged_attention_cuda(dev(q), dev(kp), dev(vp), dev(tbl),
                                    dev(pos), kind="global", window=64)
    torch.cuda.synchronize()
    assert torch.equal(clean, dirty)
    assert torch.equal(dirty[2], torch.zeros_like(dirty[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 40, 300])
def test_paged_attention_kernel_chunk_groups(cuda_device, b):
    """plan_paged cuts the ring into groups of chunks: under the planner's
    plan and every forced one, at 3, 40 and 300 slots, the groups merged
    in chunk order by the last block of each tile equal the plain
    version, and an all -1 slot writes exactly 0."""
    rng = np.random.RandomState(b)
    q, kp, vp, tbl, _ = _geometry(rng, b=b, h=4, kh=1, nb=8,
                                  positions=np.zeros(b))
    tbl[1] = -1
    pos = rng.randint(0, 80, size=b).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, tbl, pos)]
    plans = [None] + pa.paged_plans(b, 1, 8, 4, 64, 4, 8)
    for kind in ("global", "local"):
        want = pa.paged_attention_torch(*args, kind=kind, window=24)
        for plan in plans:
            got = pa.paged_attention_cuda(*args, kind=kind, window=24,
                                          plan=plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            assert torch.equal(got[1], torch.zeros_like(got[1]))


# K6 under every plan: (Q, H, K) with R = Q * H / K rows of 2 (one tile
# of 2), 6 (a tile of 8, 2 padded) and 24 (3 tiles of 8); fp32 within
# 2e-5 of the plain version, bf16 within 3e-2 (chip_smoke.py K6_TOL)
_K6_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len,h,kh", [(1, 4, 2), (3, 4, 2), (3, 8, 1)])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_paged_attention_every_plan(cuda_device, dtype, q_len, h, kh,
                                    softcap, kind):
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(q_len * h + kh),
                                    b=5, q_len=q_len, h=h, kh=kh, nb=6,
                                    positions=(5, 20, 31, 47, 2))
    tbl[3, 4:] = -1
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [
        torch.from_numpy(a).to(cuda_device) for a in (tbl, pos)]
    kw = dict(kind=kind, window=12, softcap=softcap)
    want = pa.paged_attention_torch(*args, **kw)
    shape = (5, kh, 6, q_len * h // kh, 64, args[0].element_size(), 8)
    plans = pa.paged_plans(*shape)
    assert len(plans) == 2 * 4   # cps 1, 2, 3, 6 x 128 / 256 threads
    for plan in plans:
        got = pa.paged_attention_cuda(*args, plan=plan, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= _K6_TOL[dtype], (plan, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 256),
                                      (torch.bfloat16, 512),
                                      (torch.float32, 576),
                                      (torch.bfloat16, 1024),
                                      (torch.bfloat16, 2048)])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_paged_attention_wide_rows_every_plan(cuda_device, dtype, hd, kind):
    """Rows of 1 KB and more: the two-stage plans take more than 48 KB of
    shared memory (the opt-in path), the one-stage ones less; past
    head_dim 256, q and acc sit in shared memory, one row a tile, and
    rows of more 16-byte vectors than threads (576 fp32 and 2048 bf16 at
    128 threads) take several vectors a thread."""
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(hd), b=4, h=4,
                                    kh=1, hd=hd, bs=16, nb=4,
                                    positions=(5, 40, 63, 17))
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [
        torch.from_numpy(a).to(cuda_device) for a in (tbl, pos)]
    want = pa.paged_attention_torch(*args, kind=kind, window=32)
    plans = pa.paged_plans(4, 1, 4, 4, hd, args[0].element_size(), 16)
    assert max(p.smem for p in plans) > 48 * 1024
    for plan in plans:
        got = pa.paged_attention_cuda(*args, kind=kind, window=32,
                                      plan=plan)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= _K6_TOL[dtype], (plan, err)


@pytest.mark.cuda
def test_paged_attention_counters_read_zero(cuda_device):
    """Every plan with several groups leaves the arrival counters zero, in
    eager calls and in a CUDA graph replayed twice (equal to eager)."""
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(5), b=4, h=4,
                                    kh=2, nb=6, positions=(5, 20, 31, 47))
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, tbl, pos)]
    plans = [p for p in pa.paged_plans(4, 2, 6, 2, 64, 4, 8)
             if p.groups > 1]
    assert plans
    calls = [lambda p=p: pa.paged_attention_cuda(*args, kind="local",
                                                 window=16, plan=p)
             for p in plans]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    counters = cm._counters(cuda_device)
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_paged_attention_back_to_back_is_bitwise(cuda_device):
    """Two calls on one stream, no sync between: the same bits (the groups
    merge in chunk order whatever block arrives last)."""
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(6), b=8, h=4,
                                    kh=1, nb=6,
                                    positions=(5, 20, 31, 47, 9, 13, 40, 0))
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, tbl, pos)]
    for plan in pa.paged_plans(8, 1, 6, 4, 64, 4, 8):
        a = pa.paged_attention_cuda(*args, kind="global", window=8, plan=plan)
        b = pa.paged_attention_cuda(*args, kind="global", window=8, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(a, b), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 6),
                                      (torch.bfloat16, 36),
                                      (torch.bfloat16, 1028)])
def test_paged_attention_refuses_rows_off_16_bytes(cuda_device, dtype, hd):
    """Rows are copied 16 bytes at a time: a head_dim whose rows are not a
    multiple of 16 bytes raises, and nothing launches."""
    q, kp, vp, tbl, pos = _geometry(np.random.RandomState(8), hd=hd)
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [
        torch.from_numpy(a).to(cuda_device) for a in (tbl, pos)]
    before = pa.paged_attention_cuda.launches
    with pytest.raises(ValueError, match="16 bytes"):
        pa.paged_attention_cuda(*args, kind="global", window=8)
    assert pa.paged_attention_cuda.launches == before


def _rel_close(got, want, tol=1e-4):
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _seg_psums(x, w, xbar):
    """[S, M, N] fp32 psums (plain), for masking near-zero gate bits."""
    d = x.shape[1]
    return torch.stack([x[:, s:s + xbar].float() @ w[s:s + xbar].float()
                        for s in range(0, d, xbar)])


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", [("relu", "packed"), ("relu", "bytes"),
                                     ("sublinear", "bytes"),
                                     ("tanh", "bytes")])
@pytest.mark.parametrize("m,n", [(8, 84), (64, 10), (200, 120)])
def test_cadc_matmul_gate_kernel_matches_plain(cuda_device, mode, fn, m, n):
    """K1g under the planner's plan (at these small shapes one block per
    8-row tile and segment, summed in order by the last block of each
    tile), N not a multiple of a 32-bit word; only indicator gates (relu)
    pack. test_matmul_plans_are_bitwise holds every other plan to it."""
    xbar = 64
    rng = np.random.RandomState(m + n)
    x = torch.from_numpy(rng.randn(m, 3 * xbar).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy((rng.randn(3 * xbar, n) / 14).astype(np.float32)
                         ).to(cuda_device)
    before = cm.cadc_matmul_gate_cuda.launches
    y, gate = cm.cadc_matmul_gate_cuda(x, w, crossbar_size=xbar, fn=fn,
                                       mode=mode)
    want_y, want_gate = cm.cadc_matmul_gate_torch(x, w, crossbar_size=xbar,
                                                  fn=fn, mode=mode)
    torch.cuda.synchronize()
    assert cm.cadc_matmul_gate_cuda.launches == before + 1
    _rel_close(y, want_y)
    assert gate.shape == want_gate.shape and gate.dtype == want_gate.dtype
    assert gate.nbytes == cm.gate_residual_nbytes(
        m, 3 * xbar, n, crossbar_size=xbar, fn=fn, save_gate=mode)
    psums = _seg_psums(x, w, xbar)
    far = psums.abs() > 1e-5 * max(1.0, float(want_y.abs().max()))
    if mode == "packed":
        got_bits = cm._unpack_mask(gate, n).bool()
        want_bits = cm._unpack_mask(want_gate, n).bool()
        assert torch.equal(got_bits[far], want_bits[far])
    elif fn == "relu":
        assert torch.equal(gate[far], want_gate[far])
    else:
        # f'(p) of a curved fn amplifies the psum's rounding by |f''(p)|
        # (sublinear: p^-1.5 / 4): compare where that stays below ~1e2
        ok = psums.abs() > 1e-2
        _rel_close(gate[ok], want_gate[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "packed", "bytes", "recompute"])
@pytest.mark.parametrize("xbar", [64, 128])
@pytest.mark.parametrize("m,d,n", [(8, 150, 84), (300, 200, 70),
                                   (4096, 576, 64)])
def test_segmented_bwd_kernel_matches_plain(cuda_device, mode, xbar, m, d, n):
    """K2 dx and dw against the plain version, D not a multiple of xbar;
    M = 4096 splits dw over blocks, summed in a fixed order: two runs give
    the same bits. x and w hold small integers over powers of two, so every
    psum is exact in any order and a recomputed gate cannot differ from
    the plain version's."""
    fn = "identity" if mode == "none" else "relu"
    rng = np.random.RandomState(m + d)
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    x = dev(rng.randint(-2, 3, size=(m, d)))
    w = dev(rng.randint(-2, 3, size=(d, n)) / 4)
    g = dev(rng.randn(m, n))
    gate = None
    if mode in ("packed", "bytes"):
        p = torch.stack([x[:, i:i + xbar] @ w[i:i + xbar]
                         for i in range(0, d, xbar)])
        gate = cm._gate_of(p, lambda t: (t > 0).float(), mode, fn)
    before = cm.cadc_segmented_bwd_cuda.launches
    dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, crossbar_size=xbar,
                                        fn=fn, mode=mode)
    _, dw2 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, crossbar_size=xbar,
                                        fn=fn, mode=mode, need_dx=False)
    want_dx, want_dw = cm.cadc_segmented_bwd_torch(
        g, x, w, gate, crossbar_size=xbar, fn=fn, mode=mode)
    torch.cuda.synchronize()
    assert cm.cadc_segmented_bwd_cuda.launches == before + 2
    _rel_close(dx, want_dx)
    _rel_close(dw, want_dw)
    assert torch.equal(dw, dw2)


# K2 over matrices (csrc/cadc_bwd.cu, `plan_bwd`): (M, D, N) at the stems'
# widths (D 27, 25, 18), LeNet-5's c2 (D 150: segments of 64, 64, 22) and N
# 64 / 32 / 16 / 10 / 6 (N 10 and 6 on 4-byte loads), M off whole k-tiles;
# (fn, mode) of every gate kind: none, packed words, bytes, fp32, recompute.
_K2_SHAPES = [(4096, 27, 64), (3000, 18, 32), (2050, 25, 6),
              (1500, 150, 16), (700, 150, 10), (130, 27, 10)]
_K2_GATES = [("identity", "none"), ("relu", "packed"), ("relu", "bytes"),
             ("sublinear", "bytes"), ("relu", "recompute")]


def _k2_case(dev, m, d, n, fn, mode, xbar=64):
    """g, x, w and the plain gate of `mode`. x and w hold small integers
    over powers of two, so every psum is exact in any order: the kernel's
    recomputed gate cannot differ from the plain one."""
    from repro_torch.core import dendritic

    rng = np.random.RandomState(m + d + n)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.randint(-2, 3, size=(m, d)))
    w = t(rng.randint(-2, 3, size=(d, n)) / 4)
    g = t(rng.randn(m, n))
    gate = None
    if mode in ("packed", "bytes"):
        p = torch.stack([x[:, i:i + xbar] @ w[i:i + xbar]
                         for i in range(0, d, xbar)])
        gate = cm._gate_of(p, dendritic.grad(fn), mode, fn)
    return g, x, w, gate


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _K2_GATES)
@pytest.mark.parametrize("m,d,n", _K2_SHAPES)
def test_k2_every_plan(cuda_device, m, d, n, fn, mode):
    """Every plan of `bwd_plans` (each dx tile, each dw tile, dw unsplit
    and twice split), forced: dx bitwise the planner's, dw within 1e-4 of
    scale of the plain version and the same bits on two runs of a plan; the
    recompute gate bitwise the saved byte gate under the same plan; the
    arrival counters zero after every call."""
    g, x, w, gate = _k2_case(cuda_device, m, d, n, fn, mode)
    kw = dict(crossbar_size=64, fn=fn, mode=mode)
    dx0, dw0 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    want_dx, want_dw = cm.cadc_segmented_bwd_torch(g, x, w, gate, **kw)
    _rel_close(dx0, want_dx)
    _rel_close(dw0, want_dw)
    counters = cm._counters(x.device)
    plans = cm.bwd_plans(m, n, d, 64, mode)
    assert len(plans) >= 3
    for plan in plans:
        dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
        _, dw2 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(dx, dx0), plan
        assert torch.equal(dw, dw2), plan
        _rel_close(dw, want_dw)
        assert int(counters.abs().sum()) == 0
        if mode == "recompute":
            _, _, _, saved = _k2_case(cuda_device, m, d, n, fn, "bytes")
            sdx, sdw = cm.cadc_segmented_bwd_cuda(
                g, x, w, saved, crossbar_size=64, fn=fn, mode="bytes",
                plan=cm.plan_bwd(m, n, d, 64, "bytes",
                                 _force=((128, 32), plan.dw_tile,
                                         plan.dw_splits)))
            assert torch.equal(sdx, dx) and torch.equal(sdw, dw), plan


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "recompute"])
@pytest.mark.parametrize("need_dx,need_dw", [(True, True), (True, False),
                                             (False, True)])
def test_k2_launches_at_most_two_kernels(cuda_device, mode, need_dx,
                                         need_dw):
    """One call launches one dx kernel where dx is wanted and one dw kernel
    where dw is (split or not: its splits are added in the launch), and no
    other kernel: torch.profiler's device events of five calls, each call
    at most those, the most seen exactly those (the profiler now and then
    drops a call's first kernel event; it never adds one)."""
    from torch.profiler import ProfilerActivity, profile

    g, x, w, gate = _k2_case(cuda_device, 4096, 27, 64, "relu", mode)
    kw = dict(crossbar_size=64, fn="relu", mode=mode, need_dx=need_dx,
              need_dw=need_dw)
    assert cm.plan_bwd(4096, 64, 27, 64, mode).dw_splits > 1
    cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)  # build, counters
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", ""))]
        counts = (sum("bwd_dx" in k for k in names),
                  sum("bwd_dw" in k for k in names), len(names))
        assert counts[0] <= need_dx and counts[1] <= need_dw, names
        assert counts[2] == counts[0] + counts[1], names
        seen.append(counts)
    assert max(seen) == (need_dx, need_dw, need_dx + need_dw), seen


@pytest.mark.cuda
def test_k2_counters_read_zero_under_graph_replay(cuda_device):
    """A split dw leaves the arrival counters zero, eagerly and replayed
    from a CUDA graph (the replays equal the eager results)."""
    g, x, w, gate = _k2_case(cuda_device, 4096, 27, 64, "relu", "packed")
    kw = dict(crossbar_size=64, fn="relu", mode="packed")
    eager = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    counters = cm._counters(x.device)
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))


@pytest.mark.cuda
def test_k2_refuses_another_shapes_plan(cuda_device):
    g, x, w, gate = _k2_case(cuda_device, 4096, 27, 64, "relu", "packed")
    other = cm.plan_bwd(2048, 64, 27, 64, "packed")
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm.cadc_segmented_bwd_cuda(g, x, w, gate, crossbar_size=64,
                                   fn="relu", mode="packed", plan=other)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "packed", "bytes"])
@pytest.mark.parametrize("case", [
    # (B, H, Cin, K, Cout, stride, padding, xbar)
    (4, 32, 1, 5, 6, 1, "VALID", 64),        # LeNet conv1: D = 25 < xbar
    (4, 14, 6, 5, 16, 1, "VALID", 64),       # LeNet conv2: segments span taps
    (2, 32, 3, 3, 64, 1, "SAME", 64),        # ResNet stem: D = 27
    (2, 16, 64, 3, 128, 2, "SAME", 128),     # stride 2
    (2, 16, 64, 1, 128, 2, "SAME", 256),     # 1x1 projection
    (2, 9, 16, 3, 40, 2, ((1, 0), (2, 1)), 64),  # explicit pads
])
def test_cadc_conv_kernel_matches_plain(cuda_device, mode, case):
    b, h, cin, k, cout, stride, padding, xbar = case
    fn = "identity" if mode == "none" else "relu"
    rng = np.random.RandomState(h + cin)
    x = torch.from_numpy(rng.randn(b, h, h, cin).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy((rng.randn(k, k, cin, cout) / 8).astype(np.float32)
                         ).to(cuda_device)
    kw = dict(crossbar_size=xbar, fn=fn, stride=(stride, stride),
              padding=padding, mode=mode)
    before = cc.cadc_conv2d_cuda.launches
    y, gate = cc.cadc_conv2d_cuda(x, w, **kw)
    want_y, want_gate = cc.cadc_conv2d_torch(x, w, **kw)
    torch.cuda.synchronize()
    assert cc.cadc_conv2d_cuda.launches == before + 1
    _rel_close(y, want_y)
    if mode == "none":
        assert gate is None and want_gate is None
        return
    assert gate.shape == want_gate.shape and gate.dtype == want_gate.dtype
    if mode == "packed":
        n = cout
        got = cm._unpack_mask(gate, n).bool()
        want = cm._unpack_mask(want_gate, n).bool()
    else:
        got, want = gate.bool(), want_gate.bool()
    assert float((got != want).float().mean()) < 1e-3


# (B, H, Cin, K, Cout, stride, padding, xbar): tap-aligned shapes
_TAP_CASES = [
    (2, 8, 32, 3, 64, 1, "SAME", 64),          # halo, SAME
    (2, 9, 32, 3, 96, 1, "VALID", 96),         # VALID; Cout 96, xbar 96
    (3, 9, 64, 3, 40, 2, "SAME", 64),          # stride 2; M = 75, Cout 40
    (2, 16, 64, 1, 128, 2, "SAME", 128),       # the 1x1 stride-2 projection
    (5, 7, 32, 3, 10, 1, ((1, 0), (2, 1)), 32),  # explicit pads, Cout 10
    (2, 8, 128, 3, 256, 1, "SAME", 256),       # segments span taps
]
_TAP_MODES = [("relu", "none"), ("relu", "packed"), ("relu", "bytes"),
              ("sublinear", "bytes"), ("identity", "none")]


def _conv_inputs(dev, case, seed=0):
    b, h, cin, k, cout, *_ = case
    rng = np.random.RandomState(seed + h + cin + cout)
    x = torch.from_numpy(rng.randn(b, h, h, cin).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin))
                         .astype(np.float32)).to(dev)
    return x, w


def _conv_plans_of(x, w, case):
    b, h, cin, k, cout, stride, padding, xbar = case
    *_, oh, ow = cc._geometry(x.shape, w.shape, (stride, stride), padding)
    return cc.conv_plans(b * oh * ow, cout, cin, xbar)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _TAP_MODES)
@pytest.mark.parametrize("case", _TAP_CASES)
def test_conv_plans_match_plain_and_each_other(cuda_device, case, fn, mode):
    """K3 under every plan (the gather kernel, the tap kernel at each tile)
    against the plain version within 1e-4 of scale, gates as
    test_cadc_conv_kernel_matches_plain; and every plan's output and gate
    (packed words, bytes, fp32) bitwise the gather kernel's."""
    x, w = _conv_inputs(cuda_device, case)
    b, h, cin, k, cout, stride, padding, xbar = case
    st = (stride, stride)
    want_y, want_gate = cc.cadc_conv2d_torch(
        x, w, crossbar_size=xbar, fn=fn, stride=st, padding=padding,
        mode=mode)
    plans = _conv_plans_of(x, w, case)
    assert [p.kernel for p in plans] == ["gather"] + ["tap"] * len(
        cc.TAP_TILES)
    y0, g0 = cc._conv_launch("k3", x, w, xbar, fn, st, padding, mode, None,
                             plan=plans[0])
    torch.cuda.synchronize()
    _rel_close(y0, want_y)
    if mode == "packed":
        got = cm._unpack_mask(g0, cout).bool()
        want = cm._unpack_mask(want_gate, cout).bool()
        assert float((got != want).float().mean()) < 1e-3
    elif mode == "bytes" and fn == "relu":
        assert float((g0 != want_gate).float().mean()) < 1e-3
    elif mode == "bytes":
        patches = im2col(x, (k, k), stride=st, padding=padding)
        psums = _seg_psums(patches.reshape(-1, k * k * cin),
                           w.reshape(-1, cout), xbar)
        ok = psums.reshape(g0.shape).abs() > 1e-2
        _rel_close(g0[ok], want_gate[ok])
    for plan in plans[1:]:
        y, g = cc._conv_launch("k3", x, w, xbar, fn, st, padding, mode, None,
                               plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(y, y0), plan
        assert (g is None and g0 is None) or torch.equal(g, g0), plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", _TAP_CASES)
def test_conv_recompute_equals_the_tap_kernels_gate(cuda_device, case):
    """K2 recomputing the gate over the im2col patches equals K2 over the
    byte gate of the tap kernel (each tile), bitwise: the same psums in
    the same order."""
    x, w = _conv_inputs(cuda_device, case, seed=1)
    b, h, cin, k, cout, stride, padding, xbar = case
    st = (stride, stride)
    patches = im2col(x, (k, k), stride=st, padding=padding).reshape(
        -1, k * k * cin)
    w2d = w.reshape(-1, cout)
    g = torch.randn(patches.shape[0], cout, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    kw = dict(crossbar_size=xbar, fn="relu")
    rdx, rdw = cm.cadc_segmented_bwd_cuda(g, patches, w2d, None,
                                          mode="recompute", **kw)
    for plan in _conv_plans_of(x, w, case)[1:]:
        _, gate = cc._conv_launch("k3", x, w, xbar, "relu", st, padding,
                                  "bytes", None, plan=plan)
        dx, dw = cm.cadc_segmented_bwd_cuda(
            g, patches, w2d, gate.reshape(gate.shape[0], g.shape[0], -1),
            mode="bytes", **kw)
        torch.cuda.synchronize()
        assert torch.equal(dx, rdx) and torch.equal(dw, rdw), plan


@pytest.mark.cuda
def test_conv_off_16_bytes_takes_the_gather_kernel(cuda_device):
    """x whose data starts 4 bytes past a 16-byte boundary (a storage
    offset): the planner's tap plan gives way to the gather kernel, with
    the bits of the aligned copy; a forced tap plan is refused."""
    case = (2, 8, 32, 3, 64, 1, "SAME", 64)
    x, w = _conv_inputs(cuda_device, case)
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    kw = dict(crossbar_size=64, fn="relu", mode="packed")
    before = cc.cadc_conv2d_cuda.launches
    y, gate = cc.cadc_conv2d_cuda(xo, w, **kw)
    want_y, want_gate = cc.cadc_conv2d_cuda(x, w, **kw)
    torch.cuda.synchronize()
    assert cc.cadc_conv2d_cuda.launches == before + 2
    assert torch.equal(y, want_y) and torch.equal(gate, want_gate)
    tap = _conv_plans_of(x, w, case)[1]
    with pytest.raises(ValueError, match="16-byte"):
        cc._conv_launch("k3", xo, w, 64, "relu", (1, 1), "SAME", "packed",
                        None, plan=tap)


@pytest.mark.cuda
@pytest.mark.parametrize("save_gate", ["auto", "bytes", "recompute"])
def test_conv_and_linear_grads_through_kernels(cuda_device, save_gate):
    """ops.cadc_conv2d / cadc_matmul under autograd: K3 / K1g forward, K2
    backward, against the plain path's gradients."""
    rng = np.random.RandomState(3)
    dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)  # noqa: E731
    x0, w0 = dev(rng.randn(2, 12, 12, 6)), dev(rng.randn(5, 5, 6, 16) / 8)
    a0, b0 = dev(rng.randn(8, 150)), dev(rng.randn(150, 84) / 12)
    grads = {}
    for impl in ("cuda", "torch"):
        x, w, a, b = (t.clone().requires_grad_() for t in (x0, w0, a0, b0))
        kw = dict(crossbar_size=64, fn="relu", impl=impl,
                  save_gate=save_gate)
        y = ops.cadc_conv2d(x, w, stride=(2, 2), padding="SAME", **kw)
        z = ops.cadc_matmul(a, b, **kw)
        (y.square().sum() + z.square().sum()).backward()
        grads[impl] = [t.grad for t in (x, w, a, b)]
    for got, want in zip(grads["cuda"], grads["torch"]):
        _rel_close(got, want)


# gemma3-1b's attention output projection at crossbar 256 (LM training
# runs it on bf16 operands), M = 512 rows of a microbatch
_LM_M, _LM_D, _LM_N, _LM_XBAR = 512, 1024, 1152, 256


def _lm_operands(dev, dtype, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, dtype)  # noqa: E731
    return (t(rng.randn(_LM_M, _LM_D)),
            t(rng.randn(_LM_D, _LM_N) / np.sqrt(_LM_D)),
            torch.from_numpy(rng.randn(_LM_M, _LM_N).astype(np.float32)).to(
                dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "bytes"])
def test_k1g_bf16_at_an_lm_shape(cuda_device, mode):
    """K1g on bf16 operands at an LM shape against its plain version: the
    fp32 output within 1e-4 of scale (both sum fp32 psums of exact bf16
    products, in other orders), the gate bits equal wherever the psum is
    not within 1e-5 of scale of 0."""
    x, w, _ = _lm_operands(cuda_device, torch.bfloat16)
    kw = dict(crossbar_size=_LM_XBAR, fn="relu", mode=mode)
    before = cm.cadc_matmul_gate_cuda.launches
    y, gate = cm.cadc_matmul_gate_cuda(x, w, **kw)
    want_y, want_gate = cm.cadc_matmul_gate_torch(x, w, **kw)
    torch.cuda.synchronize()
    assert cm.cadc_matmul_gate_cuda.launches == before + 1
    assert y.dtype == torch.float32 and gate.dtype == want_gate.dtype
    _rel_close(y, want_y)
    far = _seg_psums(x, w, _LM_XBAR).abs() > 1e-5 * max(
        1.0, float(want_y.float().abs().max()))
    if mode == "packed":
        gate = cm._unpack_mask(gate, _LM_N).bool()
        want_gate = cm._unpack_mask(want_gate, _LM_N).bool()
    assert torch.equal(gate[far], want_gate[far])


@pytest.mark.cuda
@pytest.mark.parametrize("save_gate", ["auto", "packed", "bytes",
                                       "recompute"])
def test_lm_linear_bf16_under_autograd(cuda_device, save_gate):
    """ops.cadc_matmul as an LM linear trains it (bf16 operands; K1g, or
    K1 then the recomputing K2 under 'recompute'; K2 on the bf16
    operands, or on fp32 copies under 'recompute')
    against the plain path on the same card: y, dx and dw (all bf16)
    within 1e-2 of scale."""
    x0, w0, g = _lm_operands(cuda_device, torch.bfloat16, seed=1)
    out = {}
    for impl in ("cuda", "torch"):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = ops.cadc_matmul(x, w, crossbar_size=_LM_XBAR, fn="relu",
                            impl=impl, save_gate=save_gate)
        y.backward(g.to(y.dtype))
        out[impl] = (y.detach(), x.grad, w.grad)
    for got, want in zip(out["cuda"], out["torch"]):
        assert got.dtype == torch.bfloat16
        _rel_close(got, want, tol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "recompute"])
def test_k2_at_an_lm_shape(cuda_device, mode):
    """K2 at the LM shape on fp32 operands, under the planner's
    plan and one forced plan (another dw tile): dx bitwise across them, dw
    the same bits on two runs, both within 1e-4 of scale of the plain
    version (the gate saved by K1g for 'packed')."""
    x, w, g = _lm_operands(cuda_device, torch.float32, seed=2)
    kw = dict(crossbar_size=_LM_XBAR, fn="relu", mode=mode)
    gate = (cm.cadc_matmul_gate_cuda(x, w, crossbar_size=_LM_XBAR, fn="relu",
                                     mode=mode)[1]
            if mode == "packed" else None)
    dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    want_dx, want_dw = cm.cadc_segmented_bwd_torch(g, x, w, gate, **kw)
    _rel_close(dx, want_dx)
    _rel_close(dw, want_dw)
    plan = cm.plan_bwd(_LM_M, _LM_N, _LM_D, _LM_XBAR, mode)
    other = next(p for p in cm.bwd_plans(_LM_M, _LM_N, _LM_D, _LM_XBAR,
                                         mode)[1:]
                 if p.dw_tile != plan.dw_tile)
    fdx, fdw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=other, **kw)
    _, fdw2 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=other, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fdx, dx) and torch.equal(fdw, fdw2)
    _rel_close(fdw, want_dw)


def _linear_vs_plain(x0, w0, g, xbar=_LM_XBAR):
    """ops.cadc_matmul under autograd on bf16 x0 [M, d], w0 [d, N] (relu,
    the packed gate), kernel path against plain path on the same card: one
    K1g and one K2 launch; y within 1e-2 of scale of the plain path's; the
    kernel's gate bits the plain version's wherever the psum is not within
    1e-5 of scale of 0; dx and dw (bf16) within 1e-2 of scale of the plain
    backward under the kernel's gate. A psum within its rounding of 0 may
    flip its relu gate, and each flip moves a row of dx by g * w and a
    column of dw by x * g: the tensor cores round the psums otherwise than
    the plain version's fp32 product does, so the backward is held to the
    gate the forward saved, and the gates to each other away from 0."""
    from repro_torch.core.cadc import pad_to_segments

    m, d = x0.shape
    out = {}
    for impl in ("cuda", "torch"):
        before = (cm.cadc_matmul_gate_cuda.launches,
                  cm.cadc_segmented_bwd_cuda.launches)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = ops.cadc_matmul(x, w, crossbar_size=xbar, fn="relu",
                            impl=impl)
        y.backward(g)
        torch.cuda.synchronize()
        assert (cm.cadc_matmul_gate_cuda.launches,
                cm.cadc_segmented_bwd_cuda.launches) == (
            (before[0] + 1, before[1] + 1) if impl == "cuda" else before)
        out[impl] = (y.detach(), x.grad, w.grad)
        for t in out[impl]:
            assert t.dtype == torch.bfloat16 and torch.isfinite(t).all()
    xp = pad_to_segments(x0, -1, xbar)
    wp = pad_to_segments(w0, 0, xbar)
    kw = dict(crossbar_size=xbar, fn="relu", mode="packed")
    y32, gate = cm.cadc_matmul_gate_cuda(xp, wp, **kw)
    want_y, want_gate = cm.cadc_matmul_gate_torch(xp, wp, **kw)
    n = w0.shape[1]
    far = _seg_psums(xp, wp, xbar).abs() > 1e-5 * max(
        1.0, float(want_y.abs().max()))
    assert torch.equal(cm._unpack_mask(gate, n).bool()[far],
                       cm._unpack_mask(want_gate, n).bool()[far])
    dx, dw = cm.cadc_segmented_bwd_torch(g.float(), xp.float(), wp.float(),
                                         gate, **kw)
    _rel_close(out["cuda"][0], out["torch"][0], tol=1e-2)
    _rel_close(out["cuda"][1], dx[:, :d].to(torch.bfloat16), tol=1e-2)
    _rel_close(out["cuda"][2], dw[:d].to(torch.bfloat16), tol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(4096, 8), (2048, 2730), (2730, 2048)],
                         ids=["mlstm-w_if", "slstm-w_up", "slstm-w_down"])
def test_lm_linear_bf16_under_autograd_at_recurrent_shapes(cuda_device, d,
                                                           n):
    """The recurrent configs' odd linears as training runs them (bf16, K1g
    forward, K2 backward on the bf16 operands): N = 8 (xlstm-1.3b's mLSTM
    gate pre-activations, 2H), and N or D = 2730 (its sLSTM GeGLU: bf16 rows of
    5460 bytes, off 16; D padded to 2816, a ragged last segment of 170).
    Held to the plain path as `_linear_vs_plain` says."""
    rng = np.random.RandomState(5)
    x0 = torch.from_numpy(rng.randn(_LM_M, d).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    w0 = torch.from_numpy((rng.randn(d, n) / np.sqrt(d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.randn(_LM_M, n).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    _linear_vs_plain(x0, w0, g)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128])
def test_mlstm_chunkwise_equals_sequential_on_cuda(cuda_device, chunk):
    """The chunkwise mLSTM on the card (fp32, TF32 off) against its
    sequential form from m = -inf: h within 1e-4 (relative norm, as
    tests/test_mlstm_chunkwise.py holds the JAX pair), the gradients of
    q, k, v and the gates finite and within 1e-3 of scale."""
    from repro_torch.models.lm import xlstm

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    b, s, h, dh = 2, 256, 4, 64
    ins = [torch.randn(b, s, h, dh, generator=gen, device=cuda_device)
           for _ in range(3)]
    ins += [2 * torch.randn(b, s, h, generator=gen, device=cuda_device)
            for _ in range(2)]
    cot = torch.randn(b, s, h, dh, generator=gen, device=cuda_device)
    out = []
    for run in (lambda *t: xlstm._mlstm_chunkwise(*t, chunk=chunk, dh=dh),
                lambda *t: xlstm._mlstm_sequential(*t, dh=dh)):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = run(*leaves)
        grads = torch.autograd.grad((y * cot).sum(), leaves)
        assert all(torch.isfinite(t).all() for t in (y, *grads))
        out.append((y.detach(), grads))
    (yc, gc), (ys, gs) = out
    assert float(torch.linalg.norm(yc - ys) / torch.linalg.norm(ys)) < 1e-4
    for got, want in zip(gc, gs):
        _rel_close(got, want, tol=1e-3)


@pytest.mark.cuda
def test_moe_expert_product_is_differentiable_in_bf16(cuda_device):
    """The MoE expert products (torch.bmm with an fp32 output, which torch
    does not differentiate) under autograd on bf16 operands: the output is
    the fp32 product, the gradients those of a.float() @ b.float()
    rounded to bf16 (the CPU path's)."""
    from repro_torch.models.lm import moe

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a0 = torch.randn(6, 24, 64, generator=gen, device=cuda_device)
    b0 = torch.randn(6, 64, 40, generator=gen, device=cuda_device)
    g = torch.randn(6, 24, 40, generator=gen, device=cuda_device)
    a, b = (t.to(torch.bfloat16).requires_grad_() for t in (a0, b0))
    y = moe._bmm32(a, b)
    y.backward(g)
    a32, b32 = (t.detach().float().requires_grad_() for t in (a, b))
    want = torch.bmm(a32, b32)
    want.backward(g)
    assert y.dtype == torch.float32
    _rel_close(y, want)
    for got, ref in ((a.grad, a32.grad), (b.grad, b32.grad)):
        assert got.dtype == torch.bfloat16
        _rel_close(got, ref.to(torch.bfloat16), tol=1e-2)


@pytest.mark.cuda
def test_serve_cli_default_runs_the_kernel(cuda_device):
    """kernel_impl defaults to 'auto': the serve CLI with --cadc and no
    --kernel-impl launches K1 on a card."""
    from repro_torch.launch import serve as serve_cli

    before = cm.cadc_matmul_cuda.launches
    serve_cli.main(["--arch", "gemma3_1b", "--smoke", "--cadc", "--slots",
                    "2", "--requests", "2", "--prompt-len", "8", "--gen",
                    "4"])
    assert cm.cadc_matmul_cuda.launches > before


Q8_FNS = ["relu", "identity", "sublinear", "supralinear"]


def _codes(dev, seed, shape, lo, hi):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8)).to(
        dev)


def _q8_equal(got, want, fn):
    if fn == "tanh":
        assert (got - want).abs().max().item() <= 1e-6 * max(
            1.0, want.abs().max().item())
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", Q8_FNS + ["tanh"])
@pytest.mark.parametrize("xbar", [64, 128, 256])
@pytest.mark.parametrize("m,d,n", [(128, 512, 100), (32, 4096, 11),
                                   (5, 512, 512)])
def test_q8_matmul_kernel_matches_plain(cuda_device, fn, xbar, m, d, n):
    """K4 (and K4g's gates) bitwise against the plain version: the FC
    shapes of VGG-16, the SNN and a small M (the split path)."""
    x = _codes(cuda_device, m + xbar, (m, d), -7, 8)
    w = _codes(cuda_device, n + xbar, (d, n), -1, 2)
    scale = torch.tensor(0.0123, device=cuda_device)
    before = cm.cadc_matmul_q8_cuda.launches
    y = cm.cadc_matmul_q8_cuda(x, w, scale, crossbar_size=xbar, fn=fn)
    want = cm.cadc_matmul_q8_torch(x, w, scale, crossbar_size=xbar, fn=fn)
    torch.cuda.synchronize()
    assert cm.cadc_matmul_q8_cuda.launches == before + 1
    _q8_equal(y, want, fn)
    for mode in (("packed", "bytes") if fn == "relu" else
                 () if fn == "identity" else ("bytes",)):
        yg, gate = cm.cadc_matmul_q8_gate_cuda(x, w, scale, crossbar_size=xbar,
                                               fn=fn, mode=mode)
        wy, wgate = cm.cadc_matmul_q8_gate_torch(
            x, w, scale, crossbar_size=xbar, fn=fn, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(yg, y)
        if fn == "tanh":
            _q8_equal(gate, wgate, fn)
        else:
            assert torch.equal(gate, wgate)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", Q8_FNS + ["tanh"])
@pytest.mark.parametrize("b,h,cin,k,cout,stride,padding,xbar", [
    (8, 32, 3, 3, 64, 1, "SAME", 64),      # VGG-16's first conv: Cin 3
    (8, 4, 512, 3, 512, 1, "SAME", 256),   # its deepest
    (4, 32, 2, 3, 32, 1, "SAME", 64),      # the SNN's conv1: Cin 2
    (8, 16, 64, 1, 128, 2, "SAME", 64),    # ResNet-18's 1x1 projection
    (8, 16, 64, 3, 128, 2, "SAME", 128),
    (3, 9, 5, 3, 70, 2, "VALID", 16),      # segments spanning taps
])
def test_q8_conv_kernel_matches_plain(cuda_device, fn, b, h, cin, k, cout,
                                      stride, padding, xbar):
    x = _codes(cuda_device, h + cin, (b, h, h, cin), -7, 8)
    w = _codes(cuda_device, cout, (k, k, cin, cout), -1, 2)
    scale = torch.tensor(0.0071, device=cuda_device)
    kw = dict(crossbar_size=xbar, fn=fn, stride=(stride, stride),
              padding=padding)
    before = cc.cadc_conv2d_q8_cuda.launches
    y, _ = cc.cadc_conv2d_q8_cuda(x, w, scale, **kw)
    want, _ = cc.cadc_conv2d_q8_torch(x, w, scale, **kw)
    torch.cuda.synchronize()
    assert cc.cadc_conv2d_q8_cuda.launches == before + 1
    _q8_equal(y, want, fn)
    if fn == "relu":
        yg, gate = cc.cadc_conv2d_q8_cuda(x, w, scale, mode="packed", **kw)
        _, wgate = cc.cadc_conv2d_q8_torch(x, w, scale, mode="packed", **kw)
        torch.cuda.synchronize()
        assert torch.equal(yg, y) and torch.equal(gate, wgate)


# (B, H, Cin, K, Cout, stride, padding, xbar): shapes K5's int8 tap kernel
# takes (Cin and xbar multiples of 32)
_Q8_TAP_CASES = [
    (2, 8, 32, 3, 64, 1, "SAME", 64),          # Cin 32: 32-byte k-tiles
    (3, 9, 64, 3, 40, 2, "SAME", 64),          # stride 2; M = 75, Cout 40
    (2, 16, 64, 1, 128, 2, "SAME", 128),       # the 1x1 stride-2 projection
    (5, 7, 32, 3, 10, 1, ((1, 0), (2, 1)), 32),  # explicit pads, Cout 10
    (2, 9, 96, 3, 70, 1, "VALID", 96),         # Cin, xbar 96: 32-byte tiles
    (2, 8, 128, 3, 256, 1, "SAME", 256),       # segments span taps
    (1, 5, 64, 3, 33, 1, "SAME", 64),          # odd Cout: scalar stores
    (4, 4, 512, 3, 512, 1, "SAME", 512),       # xbar > 256: int2float
]
_Q8_TAP_MODES = [("relu", "none"), ("relu", "packed"), ("relu", "bytes"),
                 ("identity", "none"), ("sublinear", "bytes"),
                 ("supralinear", "none"), ("tanh", "bytes")]


def _q8_plans_bitwise(x, w, scale, case, fn, mode):
    """K5 under every plan `conv_plans(q8=True)` gives for the case: the
    gather plan within _q8_equal of the plain version, and every plan's
    output and gate bitwise the gather plan's."""
    b, h, cin, k, cout, stride, padding, xbar = case
    st = (stride, stride)
    want, want_gate = cc.cadc_conv2d_q8_torch(
        x, w, scale, crossbar_size=xbar, fn=fn, stride=st, padding=padding,
        mode=mode)
    *_, oh, ow = cc._geometry(x.shape, w.shape, st, padding)
    plans = cc.conv_plans(b * oh * ow, cout, cin, xbar, q8=True)
    assert [p.kernel for p in plans] == ["gather"] + ["tap"] * len(
        cc.Q8_TAP_TILES)
    out = [cc._conv_launch("k5", x, w, xbar, fn, st, padding, mode, scale,
                           plan=p) for p in plans]
    torch.cuda.synchronize()
    y0, g0 = out[0]
    _q8_equal(y0, want, fn)
    if mode != "none":
        if fn == "tanh":
            _q8_equal(g0, want_gate, fn)
        else:
            assert torch.equal(g0, want_gate)
    for plan, (y, g) in zip(plans[1:], out[1:]):
        assert torch.equal(y, y0), plan
        assert (g is None and g0 is None) or torch.equal(g, g0), plan
        if fn != "tanh":
            assert torch.equal(y, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _Q8_TAP_MODES)
@pytest.mark.parametrize("case", _Q8_TAP_CASES)
def test_q8_conv_plans_are_bitwise(cuda_device, case, fn, mode):
    """K5's int8 tap kernel at each tile and the gather kernel, against
    the plain version and each other: outputs and packed, byte and fp32
    gates bitwise (tanh: the plans bitwise each other, within 1e-6 of
    scale of the plain version)."""
    b, h, cin, k, cout, *_ = case
    x = _codes(cuda_device, h + cin, (b, h, h, cin), -7, 8)
    w = _codes(cuda_device, cout + k, (k, k, cin, cout), -1, 2)
    scale = torch.tensor(0.0071, device=cuda_device)
    _q8_plans_bitwise(x, w, scale, case, fn, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["max", "min", "mixed"])
@pytest.mark.parametrize("fn,mode", [("relu", "packed"),
                                     ("identity", "none")])
def test_q8_conv_extreme_codes_at_xbar_256(cuda_device, fill, fn, mode):
    """Codes at -128 / 127 at xbar 256: every full segment of an interior
    pixel sums 256 products of 2^14 (|psum| = 2^22, "max"), of -128 * 127
    ("min"), or a mix of both signs; every plan bitwise the plain
    version."""
    case = (2, 6, 256, 3, 64, 1, "SAME", 256)
    b, h, cin, k, cout, *_ = case
    dev = cuda_device
    if fill == "mixed":
        rng = np.random.RandomState(5)
        pick = lambda shape: torch.from_numpy(  # noqa: E731
            np.where(rng.rand(*shape) < 0.5, -128, 127).astype(np.int8)
        ).to(dev)
        x, w = pick((b, h, h, cin)), pick((k, k, cin, cout))
    else:
        x = torch.full((b, h, h, cin), -128, dtype=torch.int8, device=dev)
        w = torch.full((k, k, cin, cout), -128 if fill == "max" else 127,
                       dtype=torch.int8, device=dev)
    scale = torch.tensor(3.0e-7, device=dev)
    _q8_plans_bitwise(x, w, scale, case, fn, mode)


@pytest.mark.cuda
def test_q8_conv_off_16_bytes_takes_the_gather_kernel(cuda_device):
    """x codes starting 1 byte past a 16-byte boundary: the planner's tap
    plan gives way to the gather kernel, with the aligned copy's bits; a
    forced tap plan is refused."""
    x = _codes(cuda_device, 7, (2, 8, 8, 32), -7, 8)
    w = _codes(cuda_device, 8, (3, 3, 32, 64), -1, 2)
    scale = torch.tensor(0.0071, device=cuda_device)
    buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda_device)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    kw = dict(crossbar_size=64, fn="relu", mode="packed")
    y, gate = cc.cadc_conv2d_q8_cuda(xo, w, scale, **kw)
    want_y, want_gate = cc.cadc_conv2d_q8_cuda(x, w, scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(gate, want_gate)
    tap = cc.conv_plans(2 * 64, 64, 32, 64, q8=True)[1]
    with pytest.raises(ValueError, match="16-byte"):
        cc._conv_launch("k5", xo, w, 64, "relu", (1, 1), "SAME", "packed",
                        scale, plan=tap)


@pytest.mark.cuda
@pytest.mark.parametrize("save_gate", ["auto", "bytes", "recompute"])
def test_q8_ste_grads_through_kernels(cuda_device, save_gate):
    """ops.cadc_matmul_q8 / cadc_conv2d_q8 under autograd on float codes:
    K4g / K5 forward, K2 backward (recompute with the scale), against the
    plain path's gradients, d(scale) included."""
    dev = cuda_device
    xc, wc = _codes(dev, 1, (2, 10, 10, 6), -7, 8), _codes(dev, 2,
                                                          (3, 3, 6, 40), -1, 2)
    ac, bc = _codes(dev, 3, (16, 300), -7, 8), _codes(dev, 4, (300, 50), -1, 2)
    grads = {}
    for impl in ("cuda", "torch"):
        x, w, a, b = (t.float().requires_grad_() for t in (xc, wc, ac, bc))
        s1 = torch.tensor(0.05, device=dev, requires_grad=True)
        s2 = torch.tensor(0.03, device=dev, requires_grad=True)
        kw = dict(crossbar_size=64, fn="relu", impl=impl,
                  save_gate=save_gate)
        y = ops.cadc_conv2d_q8(x, w, s1, stride=(2, 2), **kw)
        z = ops.cadc_matmul_q8(a, b, s2, **kw)
        (y.square().sum() + z.square().sum()).backward()
        grads[impl] = [t.grad for t in (x, w, s1, a, b, s2)]
    for got, want in zip(grads["cuda"], grads["torch"]):
        _rel_close(got, want)


@pytest.mark.cuda
def test_q8_model_eval_runs_the_q8_kernels(cuda_device):
    """A q8 forward of VGG-16 (width_div 8) launches K5 for each of its 13
    convs and K4 for each of its 3 FCs, and no fp32 kernel; its logits equal
    the plain path's bitwise."""
    from repro_torch.core.quant import PAPER_424
    from repro_torch.models.cnn import vgg16
    from repro_torch.models.common import Ctx, LayerMode

    p, s = vgg16.init(torch.Generator(device=cuda_device).manual_seed(0),
                      width_div=8, device=cuda_device)
    x = torch.randn(4, 32, 32, 3, device=cuda_device)
    counters = (cc.cadc_conv2d_q8_cuda, cm.cadc_matmul_q8_cuda,
                cc.cadc_conv2d_cuda, cm.cadc_matmul_cuda)
    before = [f.launches for f in counters]
    logits = {}
    for kernel in ("auto", "torch"):
        mode = LayerMode(impl="cadc", crossbar_size=64, quant=PAPER_424,
                         q8_fused=True, kernel=kernel)
        logits[kernel], _ = vgg16.apply(p, s, x, Ctx(mode))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [13, 3, 0, 0]
    assert torch.equal(logits["auto"], logits["torch"])


# ---------------------------------------------------------------------------
# the forward's launch plans: the stream kernel (K1 at decode) and the
# ordered segment sum of split plans
# ---------------------------------------------------------------------------

def _stream_inputs(dev, dtype, m, n, n_seg, xbar, seed):
    rng = np.random.RandomState(seed)
    d = n_seg * xbar
    x = torch.from_numpy(rng.randn(m, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, n) / np.sqrt(d)).astype(np.float32))
    return x.to(dev, dtype), w.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("n", [10, 100, 256, 1152, 6912])
def test_stream_kernel_matches_plain(cuda_device, dtype, m, n):
    """K1 at M <= 8 through the public wrapper takes the stream kernel (N
    10 and 100 are not multiples of the strip, 10 and 100 not of the
    bf16 vector: scalar loads); S 1 (no split), 2, 5 and 27 (w_down's),
    every fn; within 1e-4 of scale of the plain version."""
    xbar = 256
    for n_seg in (1, 2, 5, 27):
        x, w = _stream_inputs(cuda_device, dtype, m, n, n_seg, xbar,
                              m + n + n_seg)
        plan = cm.plan_fwd(m, n, n_seg, xbar, vec=16 // x.element_size())
        assert plan.kernel == "stream" and plan.split == (n_seg > 1)
        for fn in FNS:
            before = cm.cadc_matmul_cuda.launches
            got = cm.cadc_matmul_cuda(x, w, crossbar_size=xbar, fn=fn)
            want = cm.cadc_matmul_torch(x, w, crossbar_size=xbar, fn=fn)
            torch.cuda.synchronize()
            assert cm.cadc_matmul_cuda.launches == before + 1
            _rel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("n,xbar", [(1152, 256), (100, 64), (512, 512),
                                    (96, 100)])
def test_stream_kernel_every_strip(cuda_device, dtype, lanes, n, xbar):
    """Every strip width of the stream kernel, forced through the planner's
    private argument, on the vector path (N = 1152, 512) and the scalar one
    (N = 100; xbar = 100 is not a multiple of the vector), xbar up to its
    512 limit."""
    x, w = _stream_inputs(cuda_device, dtype, 8, n, 3, xbar, lanes + n)
    plan = cm.plan_fwd(8, n, 3, xbar, vec=16 // x.element_size(),
                       _force=("stream", lanes, True))
    for fn in ("relu", "identity"):
        got, _ = cm._fwd_launch(x, w, xbar, fn, "none", plan=plan)
        want = cm.cadc_matmul_torch(x, w, crossbar_size=xbar, fn=fn)
        torch.cuda.synchronize()
        _rel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_is_deterministic(cuda_device, dtype):
    """The same bits on every run (fixed-order reductions, no atomics in
    the sums), at w_down's decode shape."""
    x, w = _stream_inputs(cuda_device, dtype, 8, 1152, 27, 256, 5)
    a = cm.cadc_matmul_cuda(x, w, crossbar_size=256, fn="relu")
    b = cm.cadc_matmul_cuda(x, w, crossbar_size=256, fn="relu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _all_plans(m, n, n_seg, xbar):
    return [cm.plan_fwd(m, n, n_seg, xbar, _force=("tile", rows, split))
            for rows in (64, 8) for split in (False, True)
            if n_seg > 1 or not split]


# chip_smoke.py's fc_shapes (LeNet-5, ResNet-18's fc) and VGG-16's f1-f3
_FC_SHAPES = [(400, 120), (120, 84), (84, 10), (512, 10), (512, 512),
              (512, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", _FC_SHAPES)
@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("fn,mode", [("relu", "packed"), ("relu", "bytes"),
                                     ("sublinear", "bytes")])
def test_matmul_plans_are_bitwise(cuda_device, d, n, m, fn, mode):
    """K1g's outputs and gates (packed words, bytes, fp32) under every plan
    (64- or 8-row tiles, single pass or split with the ordered segment
    sum) are bitwise the single pass's; so is K1's output."""
    from repro_torch.core.cadc import pad_to_segments

    xbar = 64
    rng = np.random.RandomState(d + n + m)
    x = pad_to_segments(torch.from_numpy(rng.randn(m, d).astype(
        np.float32)).to(cuda_device), -1, xbar)
    w = pad_to_segments(torch.from_numpy((rng.randn(d, n) / np.sqrt(d))
                                         .astype(np.float32)).to(cuda_device),
                        0, xbar)
    plans = _all_plans(m, n, x.shape[1] // xbar, xbar)
    y0, g0 = cm._fwd_launch(x, w, xbar, fn, mode, plan=plans[0])
    k0, _ = cm._fwd_launch(x, w, xbar, fn, "none", plan=plans[0])
    for plan in plans[1:]:
        y, g = cm._fwd_launch(x, w, xbar, fn, mode, plan=plan)
        k, _ = cm._fwd_launch(x, w, xbar, fn, "none", plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(y, y0) and torch.equal(g, g0), plan
        assert torch.equal(k, k0), plan
    assert torch.equal(y0, k0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n", [(128, 512, 512), (128, 512, 100),
                                   (128, 512, 10), (32, 4096, 11)])
@pytest.mark.parametrize("fn", ["relu", "sublinear"])
def test_q8_matmul_plans_are_bitwise(cuda_device, m, d, n, fn):
    """K4 and K4g under every plan of `q8_plans` equal the plain version
    bitwise (the q8 FC shapes of VGG-16, ResNet-18 and the SNN)."""
    xbar = 64
    x = _codes(cuda_device, m + n, (m, d), -7, 8)
    w = _codes(cuda_device, d + n, (d, n), -1, 2)
    scale = torch.tensor(0.0123, device=cuda_device)
    want = cm.cadc_matmul_q8_torch(x, w, scale, crossbar_size=xbar, fn=fn)
    wy, wgate = cm.cadc_matmul_q8_gate_torch(x, w, scale, crossbar_size=xbar,
                                             fn=fn, mode="bytes")
    plans = cm.q8_plans(m, n, d // xbar, xbar)
    assert len(plans) > 1
    for plan in plans:
        y, _ = cm._fwd_launch(x, w, xbar, fn, "none", scale, plan=plan)
        yg, gate = cm._fwd_launch(x, w, xbar, fn, "bytes", scale, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(y, want) and torch.equal(yg, wy), plan
        assert torch.equal(gate, wgate), plan


# K4's int8 tensor-core kernel: the five q8 FC shapes (VGG-16 f1-f3,
# ResNet-18's fc, the SNN's fc), then ragged M (5, 33) x N (10, 11, 33, 100)
_Q8_MMA_SHAPES = ([(128, 512, 512), (128, 512, 512), (128, 512, 100),
                   (128, 512, 10), (32, 4096, 11)]
                  + [(m, 256, n) for m in (5, 33) for n in (10, 11, 33, 100)])
# (fn, gate mode) of every gate layout: none, packed words, bytes, fp32
_Q8_MMA_MODES = [("relu", "none"), ("relu", "packed"), ("relu", "bytes"),
                 ("sublinear", "bytes"), ("identity", "none"),
                 ("tanh", "none")]


def _q8_every_plan(x, w, scale, xbar, modes=_Q8_MMA_MODES):
    """Every plan of `q8_plans` bitwise the plain version (tanh within 1e-6
    of scale) and bitwise each other plan, outputs and gates."""
    m, n = x.shape[0], w.shape[1]
    plans = cm.q8_plans(m, n, x.shape[1] // xbar, xbar)
    for fn, mode in modes:
        if mode == "none":
            want, wgate = cm.cadc_matmul_q8_torch(
                x, w, scale, crossbar_size=xbar, fn=fn), None
        else:
            want, wgate = cm.cadc_matmul_q8_gate_torch(
                x, w, scale, crossbar_size=xbar, fn=fn, mode=mode)
        first = None
        for plan in plans:
            y, gate = cm._fwd_launch(x, w, xbar, fn, mode, scale, plan=plan)
            torch.cuda.synchronize()
            _q8_equal(y, want, fn)
            if wgate is not None:
                assert torch.equal(gate, wgate), (fn, mode, plan)
            if first is None:
                first = y, gate
            assert torch.equal(y, first[0]), (fn, mode, plan)
            assert gate is None or torch.equal(gate, first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("xbar", [32, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("m,d,n", _Q8_MMA_SHAPES)
def test_q8_mma_every_plan_is_bitwise(cuda_device, m, d, n, xbar):
    """D padded to whole crossbars as ops pads it; xbar 96 ends its
    segments inside a 64-code chunk, 32 in the first half of one."""
    dp = -(-d // xbar) * xbar
    x = _codes(cuda_device, m + n + xbar, (m, dp), -7, 8)
    w = _codes(cuda_device, dp + n, (dp, n), -1, 2)
    _q8_every_plan(x, w, torch.tensor(0.0123, device=cuda_device), xbar)


@pytest.mark.cuda
@pytest.mark.parametrize("xbar", [256, 512])
@pytest.mark.parametrize("fx,fw", [(-128, -128), (127, -128), (-128, 127)])
def test_q8_mma_extreme_codes(cuda_device, xbar, fx, fw):
    """Codes at -128 / 127: |psum| reaches 2^22 at xbar 256 (the top of the
    magic conversion) and 2^23 at 512 (past it: __int2float_rn)."""
    m, n = 33, 40
    x = torch.full((m, 2 * xbar), fx, dtype=torch.int8, device=cuda_device)
    w = torch.full((2 * xbar, n), fw, dtype=torch.int8, device=cuda_device)
    x[::3] = 127 if fx == -128 else -128   # psums of both signs
    _q8_every_plan(x, w, torch.tensor(3e-7, device=cuda_device), xbar,
                   [("identity", "none"), ("relu", "packed"),
                    ("relu", "bytes"), ("sublinear", "bytes")])


@pytest.mark.cuda
def test_q8_mma_off_alignment(cuda_device):
    """x and w starting off 16 bytes (byte loads), N a multiple of 4 (4-byte
    copies) and xbar off 16: every plan still the plain version's bits."""
    m, n, xbar = 33, 100, 40
    xb = _codes(cuda_device, 1, (m * 3 * xbar + 1,), -7, 8)
    wb = _codes(cuda_device, 2, (3 * xbar * n + 3,), -1, 2)
    x, w = xb[1:].view(m, 3 * xbar), wb[3:].view(3 * xbar, n)
    assert x.data_ptr() % 16 and w.data_ptr() % 4
    _q8_every_plan(x, w, torch.tensor(0.0123, device=cuda_device), xbar)
    _q8_every_plan(x.clone(), w.clone(),
                   torch.tensor(0.0123, device=cuda_device), xbar)


@pytest.mark.cuda
def test_q8_mma_one_launch_a_call(cuda_device):
    """K4 and K4g each launch once a call, under the planner's plan, single
    pass and split alike."""
    scale = torch.tensor(0.0123, device=cuda_device)
    for m, d, n in ((128, 512, 512), (32, 4096, 11)):
        x = _codes(cuda_device, 3, (m, d), -7, 8)
        w = _codes(cuda_device, 4, (d, n), -1, 2)
        before = (cm.cadc_matmul_q8_cuda.launches,
                  cm.cadc_matmul_q8_gate_cuda.launches)
        cm.cadc_matmul_q8_cuda(x, w, scale, crossbar_size=64, fn="relu")
        cm.cadc_matmul_q8_gate_cuda(x, w, scale, crossbar_size=64,
                                    fn="relu", mode="packed")
        assert (cm.cadc_matmul_q8_cuda.launches,
                cm.cadc_matmul_q8_gate_cuda.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert cm.plan_fwd_q8(32, 11, 64, 64).split


@pytest.mark.cuda
def test_q8_mma_counters_read_zero_and_replay(cuda_device):
    """Every split plan leaves the arrival counters zero, eager and in a
    CUDA graph replayed twice; the replays and back-to-back calls with no
    sync between them give the same bits."""
    scale = torch.tensor(0.0123, device=cuda_device)
    x = _codes(cuda_device, 5, (32, 4096), -7, 8)
    w = _codes(cuda_device, 6, (4096, 11), -1, 2)
    plans = [p for p in cm.q8_plans(32, 11, 64, 64) if p.split]
    assert len(plans) >= 5
    calls = [lambda p=p: cm._fwd_launch(x, w, 64, "relu", "packed", scale,
                                        plan=p) for p in plans]
    eager = [c() for c in calls]
    again = [c() for c in calls]
    torch.cuda.synchronize()
    counters = cm._counters(cuda_device)
    assert int(counters.abs().sum()) == 0
    for (y0, g0), (y1, g1) in zip(eager, again):
        assert torch.equal(y0, y1) and torch.equal(g0, g1)
        assert torch.equal(y0, eager[0][0])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        for (y, g), (y0, g0) in zip(outs, eager):
            assert torch.equal(y, y0) and torch.equal(g, g0)


@pytest.mark.cuda
def test_q8_mma_refuses_another_shapes_plan(cuda_device):
    scale = torch.tensor(0.0123, device=cuda_device)
    x = _codes(cuda_device, 7, (128, 512), -7, 8)
    w = _codes(cuda_device, 8, (512, 10), -1, 2)
    other = cm.plan_fwd_q8(128, 100, 8, 64)
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm._fwd_launch(x, w, 64, "relu", "none", scale, plan=other)
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm._fwd_launch(x, w, 64, "relu", "none", scale,
                       plan=cm.plan_fwd(128, 10, 8, 64))


@pytest.mark.cuda
def test_arrival_counters_read_zero(cuda_device):
    """Every split launch leaves the device's arrival counters zero: eager
    calls of both kernels, then calls captured in a CUDA graph and
    replayed twice (the replays equal the eager results)."""
    x8, w8 = _stream_inputs(cuda_device, torch.bfloat16, 8, 1152, 27, 256, 1)
    xf = torch.randn(128, 512, device=cuda_device)
    wf = torch.randn(512, 10, device=cuda_device)
    calls = [
        lambda: cm.cadc_matmul_cuda(x8, w8, crossbar_size=256, fn="relu"),
        lambda: cm.cadc_matmul_gate_cuda(xf, wf, crossbar_size=64, fn="relu",
                                         mode="packed")[0]]
    assert cm.plan_fwd(8, 1152, 27, 256, vec=8).split
    assert cm.plan_fwd(128, 10, 8, 64).split
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    counters = cm._counters(x8.device)
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K1 / K1g on bf16 operands: the tensor-core kernel (plan kernel "mma")
# ---------------------------------------------------------------------------

# (name, D padded to crossbar 256, N) of the LM paths' linears
# (chip_smoke.py lm_kernel_shapes): gemma3-1b's seven, hubert-xlarge's 504-way
# head, the recurrent configs' odd ones (xlstm-1.3b's mLSTM gates N = 8, its
# sLSTM GeGLU at N and D = 2730 (2816 padded), recurrentgemma-9b's 12 288)
_MMA_LM = [("wq", 1280, 1024), ("wk", 1280, 256), ("wo", 1024, 1152),
           ("w_gate", 1280, 6912), ("w_down", 6912, 1152),
           ("hubert.head", 1280, 504), ("mlstm.w_if", 4096, 8),
           ("slstm.w_up", 2048, 2730), ("slstm.w_down", 2816, 2048),
           ("rg.ffn.w_up", 4096, 12288)]


def _bf16_inputs(dev, m, d, n, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, n) / np.sqrt(d)).astype(np.float32))
    return x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)


def _mma_vs_plain(x, w, xbar, fn, mode, plan=None):
    """The kernel (K1 for mode 'none', else K1g) under `plan` against the
    plain version: y within 1e-4 of scale, gate bits equal where the psum
    is not within 1e-5 of scale of 0, fp32 gates within 1e-4 of scale where
    |psum| > 1e-2. Returns (y, gate)."""
    y, gate = cm._fwd_launch(x, w, xbar, fn, mode, plan=plan)
    want_y, want_gate = cm.cadc_matmul_gate_torch(
        x, w, crossbar_size=xbar, fn=fn, mode=mode)
    torch.cuda.synchronize()
    _rel_close(y, want_y)
    if gate is None:
        return y, gate
    assert gate.shape == want_gate.shape and gate.dtype == want_gate.dtype
    psums = _seg_psums(x, w, xbar)
    far = psums.abs() > 1e-5 * max(1.0, float(want_y.abs().max()))
    if mode == "packed":
        n = w.shape[1]
        assert torch.equal(cm._unpack_mask(gate, n).bool()[far],
                           cm._unpack_mask(want_gate, n).bool()[far])
    elif gate.dtype == torch.bool:
        assert torch.equal(gate[far], want_gate[far])
    else:
        ok = psums.abs() > 1e-2
        _rel_close(gate[ok], want_gate[ok])
    return y, gate


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,n", _MMA_LM, ids=[s[0] for s in _MMA_LM])
@pytest.mark.parametrize("m", [2048, 1024, 32])
def test_mma_at_the_lm_shapes(cuda_device, name, d, n, m):
    """K1 and K1g (packed and byte gates) on bf16 operands at the LM
    paths' shapes, at a train micro's rows (2048), a prefill's (1024) and a
    verify step's (32), through the public wrappers: the planner's mma plan,
    one launch a call, within the bounds against the plain version."""
    xbar = 256
    x, w = _bf16_inputs(cuda_device, m, d, n, seed=d + n + m)
    plan = cm.plan_fwd(m, n, d // xbar, xbar, dtype=torch.bfloat16)
    assert plan.kernel == "mma"
    kw = dict(crossbar_size=xbar, fn="relu")
    before = (cm.cadc_matmul_cuda.launches, cm.cadc_matmul_gate_cuda.launches)
    y = cm.cadc_matmul_cuda(x, w, **kw)
    _rel_close(y, cm.cadc_matmul_torch(x, w, **kw))
    for mode in ("packed", "bytes"):
        yg, _ = cm.cadc_matmul_gate_cuda(x, w, mode=mode, **kw)
        torch.cuda.synchronize()
        assert torch.equal(yg, y)
        _mma_vs_plain(x, w, xbar, "relu", mode)
    assert (cm.cadc_matmul_cuda.launches,
            cm.cadc_matmul_gate_cuda.launches) == (before[0] + 1,
                                                   before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("m", [1, 9, 33, 2047])
@pytest.mark.parametrize("n,xbar", [(8, 64), (200, 48), (2730, 256),
                                    (11, 64), (504, 128)])
def test_mma_every_fn_and_gate_kind(cuda_device, fn, m, n, xbar):
    """Ragged M and N (N = 8: one n8 tile; 2730: rows off 16 bytes, 4-byte
    copies; 11: odd, 2-byte loads; 504 and 200: off the 128-column tile),
    xbar 48 (a segment ends half way through a 32-wide slice), every fn
    under every gate kind it has (none; packed words for relu; bytes: one
    byte for relu, one fp32 for the curved fns), under the planner's plan
    and under a split into segment groups."""
    d = 3 * xbar
    x, w = _bf16_inputs(cuda_device, m, d, n, seed=m * n + xbar)
    modes = ["none"] + (["packed", "bytes"] if fn == "relu" else
                        [] if fn == "identity" else ["bytes"])
    plans = [p for p in cm.mma_plans(m, n, 3, xbar)
             if p == cm.plan_fwd(m, n, 3, xbar, dtype=torch.bfloat16)
             or p.groups == 3]
    assert plans[0].kernel == "mma" and any(p.split for p in plans)
    for plan in plans:
        for mode in modes:
            _mma_vs_plain(x, w, xbar, fn, mode, plan=plan)


def _mma_plans_bitwise(x, w, xbar, modes=("none", "packed", "bytes")):
    m, n = x.shape[0], w.shape[1]
    plans = cm.mma_plans(m, n, x.shape[1] // xbar, xbar)
    assert len(plans) >= 4 and any(p.split for p in plans)
    first = {mode: cm._fwd_launch(x, w, xbar, "relu", mode, plan=plans[0])
             for mode in modes}
    for plan in plans[1:]:
        for mode in modes:
            y, g = cm._fwd_launch(x, w, xbar, "relu", mode, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(y, first[mode][0]), (plan, mode)
            assert g is None or torch.equal(g, first[mode][1]), (plan, mode)
            assert torch.equal(y, first["none"][0]), (plan, mode)
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("name,d,n", _MMA_LM[:5], ids=[s[0] for s in
                                                       _MMA_LM[:5]])
@pytest.mark.parametrize("m", [2048, 32])
def test_mma_plans_are_bitwise(cuda_device, name, d, n, m):
    """Every mma plan (each row tile, the single pass and every segment
    group split) gives the planner's y and gates bit for bit at gemma3-1b's
    shapes: each psum is one chain of k16 steps in increasing k, and every
    split continues the single pass's chain of f(psum) sums."""
    x, w = _bf16_inputs(cuda_device, m, d, n, seed=n + m)
    _mma_plans_bitwise(x, w, 256)


@pytest.mark.cuda
def test_mma_off_alignment(cuda_device):
    """x off 16 bytes (2-byte loads), w off 4 bytes (2-byte loads) or on 4
    but off 16 (4-byte copies): the same bits as aligned copies, every
    plan."""
    m, xbar, n = 70, 64, 200
    d = 3 * xbar
    xa, wa = _bf16_inputs(cuda_device, m, d, n, seed=3)
    for xo, wo in ((1, 1), (1, 2), (0, 2)):
        xb = torch.zeros(m * d + xo, device=cuda_device, dtype=torch.bfloat16)
        wb = torch.zeros(d * n + wo, device=cuda_device, dtype=torch.bfloat16)
        x, w = xb[xo:].view(m, d), wb[wo:].view(d, n)
        x.copy_(xa)
        w.copy_(wa)
        assert x.data_ptr() % 16 or w.data_ptr() % 16
        for plan in cm.mma_plans(m, n, 3, xbar):
            for mode in ("none", "packed"):
                got = cm._fwd_launch(x, w, xbar, "relu", mode, plan=plan)
                want = cm._fwd_launch(xa, wa, xbar, "relu", mode, plan=plan)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (xo, wo, plan)
                assert mode == "none" or torch.equal(got[1], want[1])
    _mma_vs_plain(x, w, xbar, "relu", "packed")


@pytest.mark.cuda
def test_mma_counters_read_zero_and_replay(cuda_device):
    """Every split mma plan leaves the arrival counters zero, eager and in
    a CUDA graph replayed twice; replays and back-to-back calls give the
    same bits."""
    x, w = _bf16_inputs(cuda_device, 32, 6912, 1152, seed=9)
    plans = [p for p in cm.mma_plans(32, 1152, 27, 256) if p.split]
    assert len(plans) >= 4
    calls = [lambda p=p: cm._fwd_launch(x, w, 256, "relu", "packed", plan=p)
             for p in plans]
    eager = [c() for c in calls]
    again = [c() for c in calls]
    torch.cuda.synchronize()
    counters = cm._counters(cuda_device)
    assert int(counters.abs().sum()) == 0
    for (y0, g0), (y1, g1) in zip(eager, again):
        assert torch.equal(y0, y1) and torch.equal(g0, g1)
        assert torch.equal(y0, eager[0][0])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        for (y, g), (y0, g0) in zip(outs, eager):
            assert torch.equal(y, y0) and torch.equal(g, g0)


@pytest.mark.cuda
def test_mma_refuses_what_it_does_not_take(cuda_device):
    """Another shape's mma plan, an mma plan on fp32 operands, and an mma
    plan at an xbar off 16 raise; a bf16 call at xbar 40 takes the tile
    kernel (the plan says so) and matches the plain version."""
    x, w = _bf16_inputs(cuda_device, 64, 3 * 64, 100, seed=4)
    other = cm.plan_fwd(64, 200, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm._fwd_launch(x, w, 64, "relu", "none", plan=other)
    mine = cm.plan_fwd(64, 100, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cm._fwd_launch(x.float(), w.float(), 64, "relu", "none", plan=mine)
    with pytest.raises(ValueError):
        cm.plan_fwd(64, 100, 3, 40, dtype=torch.bfloat16,
                    _force=("mma", 64, 1))
    x40, w40 = _bf16_inputs(cuda_device, 64, 3 * 40, 100, seed=5)
    assert cm.plan_fwd(64, 100, 3, 40, dtype=torch.bfloat16).kernel == "tile"
    _mma_vs_plain(x40, w40, 40, "relu", "packed")


@pytest.mark.cuda
def test_lm_linear_bf16_runs_the_mma_kernel(cuda_device):
    """A bf16 CADC linear under autograd at a train micro's shape (gemma3-1b's
    w_down, M = 2048) plans the mma kernel, and runs K1g once and K2 once,
    held to the plain path as `_linear_vs_plain` says."""
    m, d, n = 2048, 6912, 1152
    assert cm.plan_fwd(m, n, d // 256, 256,
                       dtype=torch.bfloat16).kernel == "mma"
    x0, w0 = _bf16_inputs(cuda_device, m, d, n, seed=8)
    g = torch.randn(m, n, device=cuda_device).to(torch.bfloat16)
    _linear_vs_plain(x0, w0, g)


# ---------------------------------------------------------------------------
# K2 on bf16 operands: the tensor-core kernels (plan kernel "mma")
# ---------------------------------------------------------------------------

# the gates of 0s and 1s the bf16 route takes: (fn, mode)
_BF16_K2_GATES = [("identity", "none"), ("relu", "packed"), ("relu", "bytes")]


def _bf16_k2_case(dev, m, d, n, xbar, fn, mode, seed):
    """bf16 g, x, w and the plain version's gate of `mode` (None for
    'none')."""
    x, w = _bf16_inputs(dev, m, d, n, seed)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(m, n).astype(
        np.float32)).to(dev, torch.bfloat16)
    gate = (cm.cadc_matmul_gate_torch(x, w, crossbar_size=xbar, fn=fn,
                                      mode=mode)[1]
            if mode != "none" else None)
    return g, x, w, gate


def _bf16_k2_vs_plain(g, x, w, gate, xbar, fn, mode, plan=None):
    """K2 under `plan` (default the planner's, which must be 'mma') on the
    bf16 operands against the plain version on the same operands and gate:
    dx and dw within 1e-4 of scale (both sum exact products of bf16 values
    in fp32, in other orders). Returns (dx, dw)."""
    m, d = x.shape
    n = w.shape[1]
    kw = dict(crossbar_size=xbar, fn=fn, mode=mode)
    assert cm.plan_bwd(m, n, d, xbar, mode, dtype=torch.bfloat16,
                       fn=fn).kernel == "mma"
    dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
    want_dx, want_dw = cm.cadc_segmented_bwd_torch(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    assert dx.dtype == dw.dtype == torch.float32
    _rel_close(dx, want_dx)
    _rel_close(dw, want_dw)
    return dx, dw


def _bf16_k2_plans(g, x, w, gate, xbar, fn, mode):
    """Every plan of `bwd_plans` on the mma kernels: dx bitwise the
    planner's, dw the same bits on two runs of a plan and within 1e-4 of
    scale of the plain version; the arrival counters zero after each."""
    m, d = x.shape
    n = w.shape[1]
    kw = dict(crossbar_size=xbar, fn=fn, mode=mode)
    plans = cm.bwd_plans(m, n, d, xbar, mode, dtype=torch.bfloat16, fn=fn)
    assert all(p.kernel == "mma" for p in plans) and len(plans) >= 2
    _, want_dw = cm.cadc_segmented_bwd_torch(g, x, w, gate, **kw)
    dx0, _ = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    counters = cm._counters(x.device)
    for plan in plans:
        dx, dw = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
        _, dw2 = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(dx, dx0), plan
        assert torch.equal(dw, dw2), plan
        _rel_close(dw, want_dw)
        assert int(counters.abs().sum()) == 0
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _BF16_K2_GATES)
@pytest.mark.parametrize("name,d,n", _MMA_LM, ids=[s[0] for s in _MMA_LM])
def test_bf16_k2_at_the_lm_shapes(cuda_device, name, d, n, fn, mode):
    """K2 on bf16 operands at the LM paths' shapes, M = 2048 (a train
    micro's rows), under every gate of 0s and 1s: the planner's mma plan
    against the plain version, one launch a call, and every other mma plan
    (each dx tile, dw unsplit, halved and twice split) as
    `_bf16_k2_plans` says."""
    m, xbar = 2048, 256
    g, x, w, gate = _bf16_k2_case(cuda_device, m, d, n, xbar, fn, mode,
                                  seed=d + n)
    before = cm.cadc_segmented_bwd_cuda.launches
    _bf16_k2_vs_plain(g, x, w, gate, xbar, fn, mode)
    assert cm.cadc_segmented_bwd_cuda.launches == before + 1
    _bf16_k2_plans(g, x, w, gate, xbar, fn, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _BF16_K2_GATES)
@pytest.mark.parametrize("m", [1, 9, 33, 2047])
@pytest.mark.parametrize("n,xbar", [(8, 64), (200, 48), (2730, 256),
                                    (11, 64), (504, 128), (1000, 16)])
def test_bf16_k2_ragged(cuda_device, fn, mode, m, n, xbar):
    """Ragged M and N (N = 8: a contraction shorter than one k16 step for
    dx; 2730: rows off 16 bytes, 11: odd — both on 2-byte loads; 504 and
    200: off the 128-column tile), xbar 48 and 16 (a tile wider than the
    segment), under every gate of 0s and 1s and every mma plan."""
    d = 3 * xbar
    g, x, w, gate = _bf16_k2_case(cuda_device, m, d, n, xbar, fn, mode,
                                  seed=m * n + xbar)
    _bf16_k2_vs_plain(g, x, w, gate, xbar, fn, mode)
    _bf16_k2_plans(g, x, w, gate, xbar, fn, mode)


@pytest.mark.cuda
def test_bf16_k2_at_the_qwen2_moe_head(cuda_device):
    """qwen2-moe-a2.7b's untied head (D 2048, N 152 064) at 512 rows: dx
    contracts 152 064 deep, dw writes [2048, 152 064]; the packed gate."""
    g, x, w, gate = _bf16_k2_case(cuda_device, 512, 2048, 152064, 256,
                                  "relu", "packed", seed=11)
    _bf16_k2_vs_plain(g, x, w, gate, 256, "relu", "packed")


@pytest.mark.cuda
def test_bf16_k2_off_alignment(cuda_device):
    """g, x, w and the byte gate off 16 bytes (2-byte loads, the gate read
    as it is applied): the same bits as aligned copies, every plan."""
    m, xbar, n = 300, 64, 200
    d = 3 * xbar
    ga, xa, wa, gatea = _bf16_k2_case(cuda_device, m, d, n, xbar, "relu",
                                      "bytes", seed=6)

    def off(t, k):
        buf = torch.zeros(t.numel() + k, device=t.device, dtype=t.dtype)
        v = buf[k:].view(t.shape)
        v.copy_(t)
        return v

    kw = dict(crossbar_size=xbar, fn="relu", mode="bytes")
    for k in (1, 2):
        g, x, w, gate = off(ga, k), off(xa, k), off(wa, k), off(gatea, k)
        assert x.data_ptr() % 16 and gate.data_ptr() % 8
        for plan in cm.bwd_plans(m, n, d, xbar, "bytes",
                                 dtype=torch.bfloat16, fn="relu"):
            got = cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=plan, **kw)
            want = cm.cadc_segmented_bwd_cuda(ga, xa, wa, gatea, plan=plan,
                                              **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx,need_dw", [(True, True), (True, False),
                                             (False, True)])
def test_bf16_k2_launches_at_most_two_kernels(cuda_device, need_dx,
                                              need_dw):
    """One call on the mma route launches one dx kernel where dx is wanted
    and one dw kernel where dw is (split: gemma3-1b's wk, whose dw tiles
    are few), no copy and no other kernel: torch.profiler's device events
    of ten windows, each 64 fills of a one-element tensor and then the
    call (a window may lose records at its start: the fills take that
    place; the profiler never adds one), each window at most those, the
    most seen exactly those."""
    from torch.profiler import ProfilerActivity, profile

    g, x, w, gate = _bf16_k2_case(cuda_device, 2048, 1280, 256, 256, "relu",
                                  "packed", seed=7)
    kw = dict(crossbar_size=256, fn="relu", mode="packed", need_dx=need_dx,
              need_dw=need_dw)
    assert cm.plan_bwd(2048, 256, 1280, 256, "packed", dtype=torch.bfloat16,
                       fn="relu").dw_splits > 1
    pad = torch.empty(1, device=cuda_device)
    cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    seen = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.fill_(1.0)
            cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", ""))]
        counts = (sum("bf16_bwd_dx" in k for k in names),
                  sum("bf16_bwd_dw" in k for k in names))
        other = [k for k in names
                 if "bf16_bwd_d" not in k and "FillFunctor" not in k]
        assert counts[0] <= need_dx and counts[1] <= need_dw, names
        assert not other, other
        seen.append(counts)
    assert max(seen) == (need_dx, need_dw), seen


@pytest.mark.cuda
def test_bf16_k2_counters_read_zero_under_graph_replay(cuda_device):
    """Split dw plans on the mma route leave the arrival counters zero,
    eagerly and replayed from a CUDA graph (the replays equal the eager
    results)."""
    g, x, w, gate = _bf16_k2_case(cuda_device, 2048, 1280, 256, 256, "relu",
                                  "packed", seed=8)
    kw = dict(crossbar_size=256, fn="relu", mode="packed")
    plans = [p for p in cm.bwd_plans(2048, 256, 1280, 256, "packed",
                                     dtype=torch.bfloat16, fn="relu")
             if p.dw_splits > 1]
    assert len(plans) >= 2
    calls = [lambda p=p: cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=p,
                                                    **kw) for p in plans]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    counters = cm._counters(x.device)
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        for got, want in zip(outs, eager):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", [("sublinear", "bytes"),
                                     ("tanh", "bytes"),
                                     ("relu", "recompute")])
def test_bf16_k2_fp32_gate_fns_take_the_fp32_kernels(cuda_device, fn, mode):
    """On bf16 operands the fp32-gate fns and the recompute gate plan the
    CUDA-core kernels ('tile', 'recompute'), which run on fp32 copies: the
    same bits as the call on the copies made by hand, and the plain
    version's values within 1e-4 of scale (x and w small integers over
    powers of two, as `_k2_case`'s: every psum exact, so the recomputed
    gate is the plain one)."""
    m, d, n, xbar = 700, 512, 300, 128
    g, _, _, _ = _bf16_k2_case(cuda_device, m, d, n, xbar, "relu", "none",
                               seed=9)
    _, x, w, _ = _k2_case(cuda_device, m, d, n, fn, "none", xbar=xbar)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    gate = (cm.cadc_matmul_gate_torch(x, w, crossbar_size=xbar, fn=fn,
                                      mode=mode)[1]
            if mode == "bytes" else None)
    plan = cm.plan_bwd(m, n, d, xbar, mode, dtype=torch.bfloat16, fn=fn)
    assert plan.kernel == ("recompute" if mode == "recompute" else "tile")
    assert plan == cm.plan_bwd(m, n, d, xbar, mode)
    kw = dict(crossbar_size=xbar, fn=fn, mode=mode)
    got = cm.cadc_segmented_bwd_cuda(g, x, w, gate, **kw)
    want = cm.cadc_segmented_bwd_cuda(g.float(), x.float(), w.float(), gate,
                                      **kw)
    plain = cm.cadc_segmented_bwd_torch(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, plain):
        assert torch.equal(a, b)
        _rel_close(a, c)


@pytest.mark.cuda
def test_bf16_k2_refuses_what_it_does_not_take(cuda_device):
    """Another shape's mma plan, a CUDA-core plan on an mma call and mixed
    dtypes raise; an xbar off 16 on bf16 plans the CUDA-core kernel."""
    g, x, w, gate = _bf16_k2_case(cuda_device, 256, 192, 200, 64, "relu",
                                  "packed", seed=10)
    kw = dict(crossbar_size=64, fn="relu", mode="packed")
    other = cm.plan_bwd(512, 200, 192, 64, "packed", dtype=torch.bfloat16,
                        fn="relu")
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=other, **kw)
    tile = cm.plan_bwd(256, 200, 192, 64, "packed")
    with pytest.raises(ValueError, match="not one of this shape's"):
        cm.cadc_segmented_bwd_cuda(g, x, w, gate, plan=tile, **kw)
    with pytest.raises(ValueError, match="one dtype"):
        cm.cadc_segmented_bwd_cuda(g.float(), x, w, gate, **kw)
    assert cm.plan_bwd(256, 200, 120, 40, "packed", dtype=torch.bfloat16,
                       fn="relu").kernel == "tile"


@pytest.mark.cuda
def test_bf16_lm_linear_backward_takes_bf16_into_k2(cuda_device):
    """A bf16 CADC linear under autograd (gemma3-1b's w_gate at a train
    micro) hands K2 its bf16 cotangent, x and w as they are (no fp32 copy:
    a spy on the wrapper sees bf16), K2 plans the mma kernels, and the
    gradients are the plain path's as `_linear_vs_plain` holds them."""
    m, d, n = 2048, 1280, 6912
    x0, w0 = _bf16_inputs(cuda_device, m, d, n, seed=12)
    g = torch.randn(m, n, device=cuda_device).to(torch.bfloat16)
    seen = []
    real = cm.cadc_segmented_bwd_cuda

    def spy(g_, x_, w_, *a, **kw):
        seen.append((g_.dtype, x_.dtype, w_.dtype))
        return real(g_, x_, w_, *a, **kw)

    spy.launches = 0
    cm.cadc_segmented_bwd_cuda = spy
    try:
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        ops.cadc_matmul(x, w, crossbar_size=256, fn="relu").backward(g)
        torch.cuda.synchronize()
    finally:
        cm.cadc_segmented_bwd_cuda = real
    assert seen == [(torch.bfloat16,) * 3]
    assert cm.plan_bwd(m, n, d, 256, "packed", dtype=torch.bfloat16,
                       fn="relu").kernel == "mma"
    _linear_vs_plain(x0, w0, g)


# The tap conv backward (csrc/cadc_conv_bwd.cu): (fn, mode) of every saved
# gate kind it takes — none, packed words, bytes, fp32
_BWD_GATES = [("identity", "none"), ("relu", "packed"), ("relu", "bytes"),
              ("sublinear", "bytes")]


def _bwd_case(dev, case, fn, mode, seed=0):
    """x, w, g and K3's gate of `mode` for a _TAP_CASES conv."""
    x, w = _conv_inputs(dev, case, seed)
    b, h, cin, k, cout, stride, padding, xbar = case
    st = (stride, stride)
    *_, oh, ow = cc._geometry(x.shape, w.shape, st, padding)
    gen = torch.Generator(dev).manual_seed(seed + 5)
    g = torch.randn(b, oh, ow, cout, device=dev, generator=gen)
    _, gate = cc.cadc_conv2d_cuda(x, w, crossbar_size=xbar, fn=fn, stride=st,
                                  padding=padding, mode=mode)
    kw = dict(crossbar_size=xbar, fn=fn, stride=st, padding=padding,
              mode=mode)
    return x, w, g, gate, kw


@pytest.mark.cuda
@pytest.mark.parametrize("fn,mode", _BWD_GATES)
@pytest.mark.parametrize("case", _TAP_CASES)
def test_conv_bwd_dx_is_bitwise_the_patches_route(cuda_device, case, fn,
                                                  mode):
    """The dgrad kernel's dx equals the patches route on the card (K2's dx,
    then `_col2im`) bitwise; the wgrad kernel's dw is within 1e-4 of scale
    of the plain version and the same bits on two runs. Where the plan
    names the patches route (Cout 10: not a multiple of 4) the kernel
    wrapper refuses."""
    x, w, g, gate, kw = _bwd_case(cuda_device, case, fn, mode)
    plan = cc.plan_conv_bwd(x.shape, w.shape, kw["stride"], kw["padding"],
                            kw["crossbar_size"], mode)
    if plan.kernel == "patches":
        assert case[4] % 4 and plan.why == "Cout not a multiple of 4"
        with pytest.raises(ValueError, match="patches route"):
            cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
        return
    before = cc.cadc_conv2d_bwd_cuda.launches
    dx, dw = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
    _, dw2 = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, need_dx=False, **kw)
    ref_dx, _ = cc._bwd_patches(cm.cadc_segmented_bwd_cuda, g, x, w, gate,
                                **kw)
    want_dx, want_dw = cc.cadc_conv2d_bwd_torch(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    assert cc.cadc_conv2d_bwd_cuda.launches == before + 2
    assert torch.equal(dx, ref_dx)
    _rel_close(dx, want_dx)
    _rel_close(dw, want_dw)
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in _TAP_CASES if c[4] % 4 == 0])
def test_conv_bwd_every_plan(cuda_device, case):
    """Every dx tile and dw split the shape admits, forced: dx bitwise the
    planner's, dw within 1e-4 of scale of the plain version (the splits
    change its summation order)."""
    x, w, g, gate, kw = _bwd_case(cuda_device, case, "relu", "packed", 1)
    dx0, dw0 = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
    _, want_dw = cc.cadc_conv2d_bwd_torch(g, x, w, gate, **kw)
    plans = cc.conv_bwd_plans(x.shape, w.shape, kw["stride"], kw["padding"],
                              kw["crossbar_size"], "packed")
    assert len(plans) >= 3
    for plan in plans:
        dx, dw = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(dx, dx0), plan
        _rel_close(dw, want_dw)
    _rel_close(dw0, want_dw)


@pytest.mark.cuda
def test_conv_bwd_counters_read_zero(cuda_device):
    """A split wgrad leaves the device's arrival counters zero, eagerly and
    replayed from a CUDA graph (the replays equal the eager results)."""
    case = (8, 16, 64, 3, 64, 1, "SAME", 64)
    x, w, g, gate, kw = _bwd_case(cuda_device, case, "relu", "packed", 2)
    plan = cc.plan_conv_bwd(x.shape, w.shape, kw["stride"], kw["padding"],
                            kw["crossbar_size"], "packed")
    assert plan.dw_splits > 1
    eager = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
    torch.cuda.synchronize()
    counters = cm._counters(x.device)
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("fn,save_gate", [
    ("relu", "auto"), ("relu", "bytes"), ("relu", "recompute"),
    ("identity", "auto")])
def test_conv_bwd_autograd_matches_plain(cuda_device, fn, save_gate):
    """ops.cadc_conv2d under autograd on the card: K3 forward and the tap
    conv backward (recompute: the patches route with K2) against the plain
    path's gradients, within 1e-4 of scale. Each path computes its own
    gate, so a curved fn's (sublinear: f'(p) = 0.5 / sqrt(p)) would differ
    with the psums' rounding near p = 0; the fp32 gate is held with one
    gate for both in test_conv_bwd_dx_is_bitwise_the_patches_route."""
    case = (2, 9, 64, 3, 96, 2, "SAME", 64)
    x0, w0 = _conv_inputs(cuda_device, case, 3)
    grads, launches = {}, {}
    for impl in ("cuda", "torch"):
        x, w = (t.clone().requires_grad_() for t in (x0, w0))
        before = (cc.cadc_conv2d_bwd_cuda.launches,
                  cm.cadc_segmented_bwd_cuda.launches)
        y = ops.cadc_conv2d(x, w, crossbar_size=64, fn=fn, stride=(2, 2),
                            impl=impl, save_gate=save_gate)
        y.square().sum().backward()
        torch.cuda.synchronize()
        launches[impl] = (cc.cadc_conv2d_bwd_cuda.launches - before[0],
                          cm.cadc_segmented_bwd_cuda.launches - before[1])
        grads[impl] = (x.grad, w.grad)
    tap = save_gate != "recompute"
    assert launches["cuda"] == ((1, 0) if tap else (0, 1))
    assert launches["torch"] == (0, 0)
    for got, want in zip(grads["cuda"], grads["torch"]):
        _rel_close(got, want)


@pytest.mark.cuda
def test_conv_bwd_off_16_bytes_takes_the_patches_route(cuda_device):
    """x whose data starts 4 bytes past a 16-byte boundary: the autograd
    backward takes the patches route (K2) with dx the bits of the aligned
    tap run; the kernel wrapper refuses it."""
    case = (2, 8, 32, 3, 64, 1, "SAME", 64)
    x, w, g, gate, kw = _bwd_case(cuda_device, case, "relu", "packed", 4)
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        cc.cadc_conv2d_bwd_cuda(g, xo, w, gate, **kw)
    want_dx, _ = cc.cadc_conv2d_bwd_cuda(g, x, w, gate, **kw)
    grads = {}
    for name, xx in (("aligned", x), ("off", xo)):
        xr = xx.detach().requires_grad_()
        before = (cc.cadc_conv2d_bwd_cuda.launches,
                  cm.cadc_segmented_bwd_cuda.launches)
        y = ops.cadc_conv2d(xr, w, crossbar_size=64, fn="relu",
                            save_gate="packed", impl="cuda")
        (y * g).sum().backward()
        torch.cuda.synchronize()
        grads[name] = (xr.grad, (cc.cadc_conv2d_bwd_cuda.launches - before[0],
                                 cm.cadc_segmented_bwd_cuda.launches
                                 - before[1]))
    assert grads["aligned"][1] == (1, 0) and grads["off"][1] == (0, 1)
    assert torch.equal(grads["aligned"][0], want_dx)
    assert torch.equal(grads["off"][0], want_dx)


# ---------------------------------------------------------------------------
# multi-device training at one rank on NCCL: the tensor-parallel CADC
# linear (no-grad and row-parallel forms) and the mesh train step
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_one_rank(cuda_device):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("d,n,xbar", [(6912, 1152, 128), (1152, 6912, 64)])
def test_tp_cadc_linear_one_rank_is_bitwise_k1(nccl_one_rank, m, d, n,
                                                xbar):
    """At one rank the TP linear's local work is the whole product: one K1
    launch, bitwise the unsharded kernel (fp32 wire); the NCCL all_reduce
    of one rank changes nothing."""
    from repro_torch.parallel import tp_cadc

    dev = nccl_one_rank
    gen = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn(m, d, generator=gen, device=dev)
    w = torch.randn(d, n, generator=gen, device=dev) / d ** 0.5
    before = cm.cadc_matmul_cuda.launches
    y = tp_cadc.tp_cadc_linear(x, tp_cadc.segment_weights(w, xbar),
                               wire_dtype=None)
    torch.cuda.synchronize()
    assert cm.cadc_matmul_cuda.launches == before + 1
    assert torch.equal(y, ops.cadc_matmul(x, w, crossbar_size=xbar,
                                          fn="relu"))
    y16 = tp_cadc.tp_cadc_linear(x, tp_cadc.segment_weights(w, xbar))
    assert y16.dtype == torch.float32
    assert torch.equal(y16, y.to(torch.bfloat16).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,xbar", [(1024, 256), (6912, 256), (6912, 128)])
def test_tp_cadc_row_linear_one_rank_is_bitwise_k1g_k2(nccl_one_rank, d,
                                                        xbar, dtype):
    """The differentiable row-parallel CADC linear at one rank on NCCL, at
    gemma3-1b's wo (1024 -> 1152) and w_down (6912 -> 1152) shapes: its
    local segments are all of them, so its K1g forward and K2 backward
    are the unsharded ops.cadc_matmul's, bitwise (y, dx, dw), one launch
    each; the one-rank all_reduce changes nothing, nor does the
    sequence-parallel form's one-rank reduce-scatter (scatter_dim)."""
    import torch.distributed as dist

    from repro_torch.parallel import tp_cadc

    dev = nccl_one_rank
    gen = torch.Generator(device=dev).manual_seed(d + xbar)
    x = torch.randn(512, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, 1152, generator=gen, device=dev) / d ** 0.5).to(dtype)
    g = torch.randn(512, 1152, generator=gen, device=dev).to(dtype)
    out = {}
    for form in ("tp", "sp", "whole"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = (cm.cadc_matmul_gate_cuda.launches,
                  cm.cadc_segmented_bwd_cuda.launches)
        if form != "whole":
            y = tp_cadc.tp_cadc_row_linear(
                xr, wr.reshape(d // xbar, xbar, 1152),
                group=dist.group.WORLD, fn="relu",
                scatter_dim=0 if form == "sp" else None)
        else:
            y = ops.cadc_matmul(xr, wr, crossbar_size=xbar, fn="relu")
        y.backward(g)
        torch.cuda.synchronize()
        out[form] = (y.detach(), xr.grad, wr.grad,
                     (cm.cadc_matmul_gate_cuda.launches - before[0],
                      cm.cadc_segmented_bwd_cuda.launches - before[1]))
    assert out["tp"][3] == out["sp"][3] == out["whole"][3] == (1, 1)
    for form in ("tp", "sp"):
        for a, b in zip(out[form][:3], out["whole"][:3]):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_fsdp_step_one_rank_is_bitwise_the_train_step(nccl_one_rank):
    """gemma3-1b at full width and 2 layers, CADC relu at crossbar 256,
    bf16 on fp32 masters: steps.make_fsdp_train_step (the TP-aware step:
    FSDP over "data", the column / row / vocab-parallel layers over a
    "model" group of one) at one rank on NCCL (K1g / K2, the gathers and
    reduce-scatters as device copies) against steps.make_train_step, 2
    steps of 2 x 256 tokens in 2 micros: the losses and every parameter
    and moment bitwise, the same launches; and so under seq_sharding (the
    sequence-parallel form's gathers and reduce-scatters over the one
    rank)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.lm import transformer as tf
    from repro_torch.parallel import fsdp
    from repro_torch.train import optimizer as opt_lib

    dev = nccl_one_rank
    cfg = get_config("gemma3_1b", n_layers=2, linear_impl="cadc",
                     crossbar_size=256, kernel_impl="auto")
    opt = opt_lib.adamw(1e-4, weight_decay=0.1, max_grad_norm=1.0)
    mesh = mesh_lib.make_local_mesh()
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = []
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                             device=dev)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    runs = []
    for make in ("plain", "fsdp", "fsdp_seq"):
        p = tf.init(cfg, seed=0, device=dev)
        s = opt.init(p)
        c = cfg.with_overrides(seq_sharding=make == "fsdp_seq")
        step = (steps.make_train_step(cfg, opt, n_micro=2) if make == "plain"
                else steps.make_fsdp_train_step(
                    c, mesh, fsdp.data_dims(p, c, mesh), optimizer=opt,
                    n_micro=2))
        before = cm.cadc_matmul_gate_cuda.launches
        losses = []
        for i, b in enumerate(batches):
            p, s, m = step(p, s, b, i)
            losses.append(float(m["loss"]))
        runs.append((losses, steps._leaves([p, s]),
                     cm.cadc_matmul_gate_cuda.launches - before))
        del p, s
    (la, ta, na), *others = runs
    for lb, tb, nb in others:
        assert la == lb and na == nb > 0
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
