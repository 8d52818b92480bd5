"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and are
marked `cuda`; elsewhere they skip. They import only torch and numpy, so
they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the kernels and their plain versions both sum fp32 psums,
in other orders, so outputs and gradients agree within 1e-4 of their
scale (the JAX package's TOL); gate bits agree wherever the psum is not
within 1e-5 of the output's scale of zero (elsewhere its sign can differ
with the summation order), and fp32 gates of curved fns within 1e-4 of
their scale where the psum exceeds 1e-2.
"""
import numpy as np
import pytest
import torch

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
    """The ring is cut into groups of chunks so that (kv head, slot, group)
    blocks fill the card: on a 132-SM card one chunk per group at 3 slots,
    two at 40, and one group of all 8 chunks at 300; the second kernel
    combines the groups in chunk order."""
    rng = np.random.RandomState(b)
    q, kp, vp, tbl, _ = _geometry(rng, b=b, h=4, kh=1, nb=8,
                                  positions=np.zeros(b))
    tbl[1] = -1
    pos = rng.randint(0, 80, size=b).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, tbl, pos)]
    for kind in ("global", "local"):
        got = pa.paged_attention_cuda(*args, kind=kind, window=24)
        want = pa.paged_attention_torch(*args, kind=kind, window=24)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert torch.equal(got[1], torch.zeros_like(got[1]))


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
    """K1g on both paths (M <= 64: one block per column tile and segment;
    M = 200: the single pass), N not a multiple of a 32-bit word; only
    indicator gates (relu) pack."""
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
