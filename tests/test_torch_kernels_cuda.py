"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and are
marked `cuda`; elsewhere they skip. They import only torch and numpy, so
they run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

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
