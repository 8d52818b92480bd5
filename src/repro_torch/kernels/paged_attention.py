"""Paged-attention decode over block tables: CUDA flash-decoding kernel and
its plain PyTorch version (the gather formulation).

Port of repro.kernels.paged_attention. The serve engine's paged KV cache
keeps every slot's logical [L, K, hd] ring scattered over
[n_blocks, block_size, K, hd] pools named by a per-slot block table.

  * paged_attention_cuda  — the kernel (csrc/paged_attention.cu), one
                            launch under `plan_paged`: one block per
                            (kv head, row tile, slot, group of chunks)
                            stages its live chunks by 16-byte cp.async
                            (zero-filling entries no q token may read, so
                            garbage never meets a multiply: NaN-proof),
                            skips -1 and fully masked chunks, and the last
                            block of each (slot, kv head, row tile) to
                            arrive merges the groups in chunk order; rows
                            with no valid entry write 0. Replaces
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
    (NaN) in dead or unallocated blocks never meets a 0 weight;
  * a q row with no valid entry writes 0 — an idle slot (all -1), or with
    Q > 1 a token whose window holds only -1 blocks while a later token
    of its slot reads — the rule of `_flash_kernel` and of the kernel,
    where `paged_attention_xla` averages every gathered V of the slot.

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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import cadc_matmul as _cm

Tensor = torch.Tensor

# The masking value of the attention stack (models/lm/attention.py imports
# it from here): finite, so masked scores underflow to exact-0 softmax
# weight instead of producing NaNs on all-masked rows.
NEG_INF = -2.0 ** 30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "paged_attention.cu"
# K6's dynamic shared memory at most: a block's 227 KB on Hopper less 1 KB
# kept for its static shared memory (csrc/paged_attention.cu kSmemMax).
PAGED_SMEM_LIMIT = 232_448 - 1024
# K6's launch plans (`plan_paged`): rows of q a block holds (a row tile;
# csrc/paged_attention.cu instantiates each for head_dim up to 128 — the
# `--smoke` config's 32 — and up to 256, gemma3-1b's: 1 for MHA decode, 2
# the smoke config's decode, 4 gemma3-1b's, 8 multi-token appends and
# wider GQA groups), block sizes, and the widest row whose q and acc sit
# in registers (wider rows keep them in shared memory, one row a tile).
PAGED_ROWS = (1, 2, 4, 8)
PAGED_THREADS = (128, 256)
PAGED_REG_HD = 256
# The planner's model of a launch (us), fitted by tools/profile_k6.py
# --refit to its --set plans and fit sweeps of this kernel on an H100 80GB
# HBM3 at 700 W (`_paged_cost`): a block's latency a_t + b_t x cps,
# the card's throughput blocks x (e_t + f_t x cps) / SMs, by threads t;
# their smooth maximum (power _PAGED_P); then, with several groups, the
# last block's merge c + d x groups.
_PAGED_LAT = {128: (3.617, 2.493), 256: (2.961, 1.955)}
_PAGED_THR = {128: (1.441, 1.092), 256: (3.450, 1.938)}
_PAGED_MERGE = (2.424, 0.138)
_PAGED_P = 1.832


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


def _masked_scores(q: Tensor, k: Tensor, valid: Tensor,
                   softcap: Optional[float]) -> Tensor:
    """masked_sdpa's fp32 scores [B, K, G, C, L] (G = H / K), NEG_INF
    where `valid` is False."""
    b, c, h, hd = q.shape
    k_ = k.shape[2]
    qg = q.reshape(b, c, k_, h // k_, hd)
    scores = torch.einsum("bckgd,blkd->bkgcl", qg.float(), k.float())
    scores = _softcap(scores * (hd ** -0.5), softcap)
    return torch.where(valid[:, None, None], scores, NEG_INF)


def _weighted_v(probs: Tensor, v: Tensor) -> Tensor:
    """probs [B, K, G, C, L] rounded to v.dtype, times v [B, L, K, hd] in
    fp32: [B, C, H, hd] fp32."""
    out = torch.einsum("bkgcl,blkd->bckgd", probs.to(v.dtype).float(),
                       v.float())
    return out.flatten(2, 3)


def masked_sdpa(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                softcap: Optional[float]) -> Tensor:
    """q [B, C, H, hd], k/v [B, L, K, hd], valid [B, C, L] bool (True =
    keep) -> [B, C, H, hd] in q.dtype. The forms of the JAX `_sdpa`: fp32
    scores, softcap, NEG_INF masking, softmax, probabilities rounded to
    v.dtype before an fp32-accumulated PV product."""
    scores = _masked_scores(q, k, valid, softcap)
    return _weighted_v(torch.softmax(scores, dim=-1), v).to(q.dtype)


def partial_sdpa(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                 softcap: Optional[float]) -> Tuple[Tensor, Tensor, Tensor]:
    """masked_sdpa over one block of the keys, for a merge with the other
    blocks' (the length-parallel decode, models/lm/attention.py): (the
    block's output in fp32 [B, C, H, hd], the scores' max over the block
    and the sum of exp(score - max) [B, C, H]). A block with no valid
    entry has max NEG_INF and its softmax is uniform, as masked_sdpa's."""
    b, c, h, _ = q.shape
    scores = _masked_scores(q, k, valid, softcap)
    top = scores.amax(dim=-1)
    total = torch.exp(scores - top[..., None]).sum(dim=-1)
    out = _weighted_v(torch.softmax(scores, dim=-1), v)

    def per_head(t):                   # [B, K, G, C] -> [B, C, H]
        return t.permute(0, 3, 1, 2).reshape(b, c, h)

    return out, per_head(top), per_head(total)


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
    out = masked_sdpa(q, k_c, v_c, valid, softcap)
    # a row that reads nothing: 0, not the softmax of its NEG_INF scores
    empty = ~valid.any(dim=-1)[:, :, None, None]             # [B, Q, 1, 1]
    return torch.where(empty, torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class PagedPlan(NamedTuple):
    """One K6 launch: grid (K * row_tiles, B, groups) of `threads`-thread
    blocks; a block holds `rows` resident rows of q (one row tile) and
    walks `cps` consecutive chunks of its slot's ring in `smem` bytes of
    shared memory. With groups > 1 the last block of each (slot, kv head,
    row tile) merges the groups."""
    cps: int
    groups: int
    threads: int
    rows: int
    row_tiles: int
    smem: int
    shape: Tuple[int, ...]   # (B, K, nb, R, hd, element bytes, bs)

    @property
    def tiles(self) -> int:
        """(slot, kv head, row tile) tiles: the arrival counters used."""
        return self.shape[0] * self.shape[1] * self.row_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.groups

    def scratch_floats(self) -> int:
        """fp32 scratch of the groups' partials (m, l, acc); 0 for one."""
        if self.groups == 1:
            return 0
        return self.blocks * self.rows * (self.shape[4] + 2)


def _row_tile(rows: int, hd: int) -> Tuple[int, int]:
    """(rows a block holds, row tiles): the fewest of PAGED_ROWS >= R, else
    the most; one past PAGED_REG_HD."""
    if hd > PAGED_REG_HD:
        return 1, rows
    kr = next((r for r in PAGED_ROWS if r >= rows), PAGED_ROWS[-1])
    return kr, -(-rows // kr)


def _smem(kr: int, bs: int, hd: int, elem: int, cps: int,
          groups: int) -> int:
    """csrc/paged_attention.cu `smem_bytes`: q rows, K/V stages, scores,
    merge weights, alpha / 1/l, acc of rows past PAGED_REG_HD, the group's
    table slice."""
    stages = 2 if cps > 1 else 1
    wide = kr * hd if hd > PAGED_REG_HD else 0
    return ((kr + 2 * stages * bs) * hd * elem
            + (bs * kr + (groups * kr if groups > 1 else 0) + 2 * kr
               + wide) * 4
            + cps * 4)


def _make_paged(shape, cps: int, threads: int) -> Optional[PagedPlan]:
    b, k_, nb, rows, hd, elem, bs = shape
    kr, row_tiles = _row_tile(rows, hd)
    groups = -(-nb // cps)
    smem = _smem(kr, bs, hd, elem, cps, groups)
    if smem > PAGED_SMEM_LIMIT or (groups > 1
                                   and b * k_ * row_tiles > _cm.N_COUNTERS):
        return None
    return PagedPlan(cps, groups, threads, kr, row_tiles, smem, shape)


def _paged_cost(plan: PagedPlan, sms: int) -> float:
    """The planner's model of a launch's time (us): see _PAGED_LAT."""
    a, b = _PAGED_LAT[plan.threads]
    e, f = _PAGED_THR[plan.threads]
    lat = a + b * plan.cps
    thr = plan.blocks * (e + f * plan.cps) / sms
    t = (lat ** _PAGED_P + thr ** _PAGED_P) ** (1 / _PAGED_P)
    if plan.groups > 1:
        t += _PAGED_MERGE[0] + plan.groups * _PAGED_MERGE[1]
    return t


@functools.lru_cache(maxsize=None)
def plan_paged(b: int, k_: int, nb: int, rows: int, hd: int, elem: int,
               bs: int, sms: int = _cm.SMS, *, _force=None) -> PagedPlan:
    """The launch plan of K6 over B slots, K kv heads, an nb-chunk table,
    R = Q * H / K resident rows of head_dim hd (`elem` bytes an element:
    4 fp32, 2 bf16), block size bs, on a card of `sms` SMs; pure Python,
    cached per shape.

    The rows are cut into tiles of PAGED_ROWS; the ring into groups of
    `cps` chunks. Fewer, longer groups merge less; more blocks keep more
    loads in flight: the planner takes the plan of least `_paged_cost`
    over every chunks-a-group count and PAGED_THREADS, and falls back to
    one group where the tiles outnumber the arrival counters. `_force` =
    (cps, threads) builds that plan instead, for tests and the profiler;
    it raises ValueError for a plan that does not exist."""
    if hd <= 0 or hd * elem % 16:
        raise ValueError(
            f"paged_attention_cuda copies q / K / V rows 16 bytes at a time: "
            f"head_dim {hd} x {elem} B must be a multiple of 16 bytes")
    if min(b, k_, nb, rows, bs) < 1:
        raise ValueError(f"no K6 plan for B={b} K={k_} nb={nb} R={rows} "
                         f"bs={bs}")
    shape = (b, k_, nb, rows, hd, elem, bs)
    if _force is not None:
        cps, threads = _force
        plan = (_make_paged(shape, cps, threads)
                if 1 <= cps <= nb and threads in PAGED_THREADS else None)
        if plan is None:
            raise ValueError(f"no such K6 plan {_force} for shape {shape}")
        return plan
    plans = [p for p in (_make_paged(shape, c, t) for c in _cps_options(nb)
                         for t in PAGED_THREADS) if p is not None]
    if not plans:
        raise ValueError(f"K6 needs more shared memory than a block has at "
                         f"shape {shape}")
    return min(plans, key=lambda p: (_paged_cost(p, sms), p.cps, -p.threads))


def _cps_options(nb: int):
    """Chunks-a-group counts that give distinct group counts, every group
    non-empty."""
    return sorted({-(-nb // s) for s in range(1, nb + 1)})


def paged_plans(b: int, k_: int, nb: int, rows: int, hd: int, elem: int,
                bs: int):
    """Every plan of a shape, the planner's first (for tests and
    tools/profile_k6.py)."""
    first = plan_paged(b, k_, nb, rows, hd, elem, bs)
    rest = (_make_paged(first.shape, c, t) for c in _cps_options(nb)
            for t in PAGED_THREADS)
    return [first] + [p for p in rest if p is not None and p != first]


def paged_attention_cuda(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                         block_table: Tensor, positions: Tensor, *,
                         kind: str, window: int,
                         ring_len: Optional[int] = None,
                         softcap: Optional[float] = None,
                         plan: Optional[PagedPlan] = None) -> Tensor:
    """The CUDA kernel; same contract as paged_attention_torch. Tensors on
    one CUDA device; q and pools both fp32 or both bf16, rows of head_dim
    a multiple of 16 bytes, q and pools 16-byte aligned; positions int32
    or int64. Table entries must be -1 or name a block of the pool. One
    launch under `plan` (default: plan_paged's). Counts its launches in
    `paged_attention_cuda.launches`."""
    b, q_len, h, hd = q.shape
    n_blocks, bs, k_, hd_p = k_pool.shape
    nb = block_table.shape[1]
    dev = q.device
    if not (q.is_cuda and k_pool.device == dev and v_pool.device == dev
            and block_table.device == dev and positions.device == dev):
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
    elem = q.element_size()
    if not q.is_contiguous():
        q = q.contiguous()
    if not k_pool.is_contiguous():
        k_pool = k_pool.contiguous()
    if not v_pool.is_contiguous():
        v_pool = v_pool.contiguous()
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention_cuda needs q and the pools "
                         "16-byte aligned")
    tbl = block_table
    if tbl.dtype != torch.int32 or not tbl.is_contiguous():
        tbl = tbl.to(torch.int32).contiguous()
    pos = positions
    if pos.dtype not in (torch.int32, torch.int64) \
            or not pos.is_contiguous():
        pos = pos.to(torch.int64).contiguous()
    out = torch.empty_like(q)
    if b == 0 or q_len == 0:
        return out
    rows = q_len * (h // k_)
    if plan is None:
        plan = plan_paged(b, k_, nb, rows, hd, elem, bs,
                          _sm_count(dev.index))
    elif plan.shape != (b, k_, nb, rows, hd, elem, bs):
        raise ValueError(f"plan for shape {plan.shape} given at shape "
                         f"{(b, k_, nb, rows, hd, elem, bs)}")
    part = counters = 0
    if plan.groups > 1:
        scratch = torch.empty(plan.scratch_floats(), dtype=torch.float32,
                              device=dev)
        part, counters = scratch.data_ptr(), _cm._counters(dev).data_ptr()
    lib = _lib()
    _build.check(lib, "paged_attention", lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part, counters, b, q_len, h, k_, hd,
        bs, nb, ring_len, window, int(kind == "local"),
        int(pos.dtype == torch.int64), plan.rows, plan.row_tiles, plan.cps,
        plan.groups, plan.threads, plan.smem,
        0.0 if softcap is None else float(softcap), hd ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream))
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
