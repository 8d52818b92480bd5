"""Paged-attention decode over block tables: CUDA flash-decoding kernel and
its plain PyTorch version (the gather formulation).

Port of repro.kernels.paged_attention. The serve engine's paged KV cache
keeps every slot's logical [L, K, hd] ring scattered over
[n_blocks, block_size, K, hd] pools named by a per-slot block table.

  * paged_attention_cuda  — the kernel (csrc/paged_attention.cu): split-K
                            flash decoding; one block per (slot, kv head,
                            group of chunks) walks its part of the slot's
                            table row with an online softmax, skips -1 and
                            fully masked chunks, and never computes on a
                            masked entry (NaN-proof); a second kernel
                            combines the groups in chunk order; rows with
                            no valid entry write 0. Replaces
                            `_flash_kernel`.
  * paged_attention_torch — the plain version, the gather formulation of
                            `paged_attention_xla`: blocks gathered back
                            into the ring layout, then the masked SDPA of
                            models/lm/attention.py (`masked_sdpa`, defined
                            here so both layers share one form).

The plain version makes two choices beyond the JAX gather:
  * a covered-prefix table slice (fewer blocks than the ring holds) is
    padded back to the full ring length before the SDPA. torch's CPU
    reductions group their terms by the reduced length, so only equal
    shapes keep the paged cache bitwise equal to the dense one;
  * entries no q token may read are zeroed after the gather, so garbage
    (NaN) in dead or unallocated blocks never meets a 0 weight, and an
    idle slot (all -1) yields 0, as in the kernel.

Ring-validity mask (`_ring_mask`, shared by both): for q token t of a
slot at base position pos (absolute position qp = pos + t), ring entry i
(l = ring_len) is valid iff
  global:  i <= qp
  local:   p_i = P - ((P - i) mod l), P = pos + q_len - 1;
           0 <= p_i <= qp and p_i > qp - window.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

Tensor = torch.Tensor

# The masking value of the attention stack (models/lm/attention.py imports
# it from here): finite, so masked scores underflow to exact-0 softmax
# weight instead of producing NaNs on all-masked rows.
NEG_INF = -2.0 ** 30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "paged_attention.cu"
# Shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448


def _softcap(scores: Tensor, cap: Optional[float]) -> Tensor:
    """Logit softcap shared by the SDPA layers and the paged kernels."""
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _ring_mask(pos: Tensor, idx: Tensor, *, kind: str, ring_len: int,
               window: int, q_len: int) -> Tensor:
    """[B, q_len, n] validity of ring entries `idx` [n] for the q tokens of
    slots at base positions `pos` [B]."""
    pos = pos.to(torch.int64).reshape(-1, 1, 1)
    idx = idx.to(torch.int64).reshape(1, 1, -1)
    qp = pos + torch.arange(q_len, device=pos.device).reshape(1, -1, 1)
    if kind == "local":
        newest = pos + q_len - 1
        held = newest - torch.remainder(newest - idx, ring_len)
        return (held >= 0) & (held <= qp) & (held > qp - window)
    return idx <= qp


def masked_sdpa(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                softcap: Optional[float]) -> Tensor:
    """q [B, C, H, hd], k/v [B, L, K, hd], valid [B, C, L] bool (True =
    keep) -> [B, C, H, hd] in q.dtype. The forms of the JAX `_sdpa`: fp32
    scores, softcap, NEG_INF masking, softmax, probabilities rounded to
    v.dtype before an fp32-accumulated PV product."""
    b, c, h, hd = q.shape
    k_ = k.shape[2]
    qg = q.reshape(b, c, k_, h // k_, hd)
    scores = torch.einsum("bckgd,blkd->bkgcl", qg.float(), k.float())
    scores = _softcap(scores * (hd ** -0.5), softcap)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcl,blkd->bckgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def paged_attention_torch(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                          block_table: Tensor, positions: Tensor, *,
                          kind: str, window: int,
                          ring_len: Optional[int] = None,
                          softcap: Optional[float] = None) -> Tensor:
    """Plain version. q [B, Q, H, hd] (rope'd), pools [n_blocks, bs, K, hd],
    block_table [B, nb] (-1 = unallocated; may be a covered-prefix slice,
    ring_len then carries the true ring length), positions [B] base
    positions -> [B, Q, H, hd] in q.dtype."""
    b, q_len, h, hd = q.shape
    bs, k_ = k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    l_eff = nb * bs
    ring_len = l_eff if ring_len is None else ring_len
    if l_eff > ring_len:
        raise ValueError(f"table covers {l_eff} entries > ring_len={ring_len}")

    tbl = block_table.to(torch.int64)
    k_c = k_pool[tbl.clamp(min=0)].reshape(b, l_eff, k_, hd)
    v_c = v_pool[tbl.clamp(min=0)].reshape(b, l_eff, k_, hd)
    live = (tbl >= 0).repeat_interleave(bs, dim=1)          # [B, l_eff]
    pad = ring_len - l_eff
    if pad:
        k_c = F.pad(k_c, (0, 0, 0, 0, 0, pad))
        v_c = F.pad(v_c, (0, 0, 0, 0, 0, pad))
        live = F.pad(live, (0, pad))
    idx = torch.arange(ring_len, device=q.device)
    valid = _ring_mask(positions, idx, kind=kind, ring_len=ring_len,
                       window=window, q_len=q_len) & live[:, None, :]
    read = valid.any(dim=1)[:, :, None, None]
    k_c = torch.where(read, k_c, torch.zeros((), dtype=k_c.dtype,
                                             device=k_c.device))
    v_c = torch.where(read, v_c, torch.zeros((), dtype=v_c.dtype,
                                             device=v_c.device))
    return masked_sdpa(q, k_c, v_c, valid, softcap)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(b: int, k_: int, nb: int, sms: int):
    """(chunks per group, groups): enough (slot, kv head, group) blocks to
    fill the card's SMs twice, at most one group per chunk."""
    want = max(1, -(-2 * sms // max(1, b * k_)))
    cps = -(-nb // max(1, min(nb, want)))
    return cps, max(1, -(-nb // cps))


def paged_attention_cuda(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                         block_table: Tensor, positions: Tensor, *,
                         kind: str, window: int,
                         ring_len: Optional[int] = None,
                         softcap: Optional[float] = None) -> Tensor:
    """The CUDA kernel; same contract as paged_attention_torch. Tensors on
    one CUDA device; q and pools both fp32 or both bf16. Table entries
    must be -1 or name a block of the pool. Counts its launches in
    `paged_attention_cuda.launches`."""
    b, q_len, h, hd = q.shape
    n_blocks, bs, k_, hd_p = k_pool.shape
    nb = block_table.shape[1]
    tensors = (q, k_pool, v_pool, block_table, positions)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda needs every tensor on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention_cuda takes fp32 or bf16 q and "
                         f"pools of one dtype; got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if (hd_p != hd or v_pool.shape != k_pool.shape or h % k_
            or block_table.shape[0] != b or positions.numel() != b):
        raise ValueError("paged_attention_cuda: inconsistent shapes "
                         f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"table {tuple(block_table.shape)}")
    if kind not in ("global", "local"):
        raise ValueError(f"unknown attention kind {kind!r}")
    ring_len = nb * bs if ring_len is None else ring_len
    if nb * bs > ring_len:
        raise ValueError(f"table covers {nb * bs} entries > "
                         f"ring_len={ring_len}")
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(q_len, h, k_, hd, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention_cuda needs {smem} B of shared "
                         f"memory per block (limit {SMEM_LIMIT})")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), \
        v_pool.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).reshape(b).contiguous()
    out = torch.empty_like(q)
    if b == 0 or q_len == 0:
        return out
    cps, n_split = _splits(b, k_, nb, _sm_count(q.device.index))
    rows = b * k_ * n_split * q_len * (h // k_)
    part = torch.empty(rows * (hd + 2), dtype=torch.float32,
                       device=q.device)
    part_m, part_l, part_acc = (part[:rows], part[rows:2 * rows],
                                part[2 * rows:])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib, "paged_attention", lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), b, q_len, h, k_, hd, bs, nb, cps, n_split,
        ring_len, window, int(kind == "local"),
        0.0 if softcap is None else float(softcap), hd ** -0.5,
        _DTYPES[q.dtype], stream))
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
