// Flash-decoding over paged-KV block tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// `_flash_kernel` (launched by `paged_attention_pallas`). Same contract as
// the gather formulation `paged_attention_torch` in
// repro_torch/kernels/paged_attention.py: q [B, Q, H, hd] (rope'd), K/V pools
// [n_blocks, bs, K, hd], block table [B, nb] int32 (-1 = unallocated; may be
// a covered-prefix slice of the full table, ring_len then carries the true
// ring length), base positions [B] int32 or int64 -> out [B, Q, H, hd] in
// q's dtype.
//
// What bounds it. A decode call is tiny: at gemma3-1b (8 slots, 4 q heads
// on 1 kv head, hd 256, a 160-entry ring) it reads ~1 MB of live K/V and
// does ~3.7 MFLOP, 0.3 us of HBM and less of arithmetic. What it costs is
// latency: dependent loads, serial phases, barriers and launches. So the
// design is about the critical path, not the roofline:
//
//  * One launch. The TPU kernel walks a slot's chunks in order on one core;
//    here the ring is cut into n_split groups of `cps` consecutive chunks
//    (kernels/paged_attention.py `plan_paged`), and one block handles one
//    (kv head, row tile, slot, group). The GQA group of q heads of the kv
//    head, times the Q tokens, are R = Q * (H / K) resident rows, cut into
//    tiles of kR rows (row r = t * g + gi). A block with the only group
//    normalises and writes out itself. Otherwise it writes its partial
//    (m, l, unnormalised acc) to fp32 scratch and arrives at its (slot, kv
//    head, row tile) counter (`arrive_last`, csrc/cadc_tile.cuh); the last
//    block to arrive merges the groups in chunk order, writes out and
//    resets the counter, so the counters read zero between launches.
//  * Every load in flight at once. The block reads its table slice and
//    position together, then issues 16-byte cp.async copies of its q rows
//    and of the first live chunk's K and V entry rows, all before the first
//    wait; with more than one chunk in the group, chunk c + 1's copies fly
//    while chunk c is computed (a two-stage ring). An entry no q token of
//    the slot may read (the ring mask of `_ring_mask`) is zero-filled by a
//    copy of source size 0: no garbage, NaN included, enters shared
//    memory, and a -1 block or a chunk with no readable entry is skipped
//    without a load. A (row, entry) pair masked for its row gets score
//    -inf and probability exactly 0 against a finite V, so no masked or
//    unread entry meets a multiply that reaches the output.
//  * No division in the inner loops: each thread's copy slot, entry and
//    row offsets are set once; ring positions advance by one per entry.
//  * Scores: the kR rows of q sit in registers, a warp takes one entry (or
//    32 / kLPE entries) with its lanes over hd in 16-byte vectors, one
//    shuffle reduction per (entry, row). The online softmax (m, l) of a
//    row lives in the registers of one warp; PV has each thread own
//    columns x kR rows of acc in registers, reading V from shared memory
//    and the probabilities as a broadcast. fp32 accumulation throughout.
//    Rows wider than 256 (kHD = 0: any width shared memory holds, one row
//    a tile) keep q and acc in shared memory instead, the same arithmetic
//    in the same order.
//    The chunk order, the online-softmax updates and the merge's
//    arithmetic are those of the two-launch kernel this replaces.
//  * CUDA cores, not tensor cores: a call is a few MFLOP. bf16 mma.sync
//    (entries as M, rows padded to 8) is the lever for long rings and
//    speculative decoding, not for this decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "cadc_tile.cuh"

namespace {

using cadc::arrive_last;
using cadc::copy16;
using cadc::copy_commit;
using cadc::copy_wait;
using cadc::to_f32;

constexpr int kMaxThreads = 256;
// A block's shared memory on Hopper, less 1 KB for the kernel's static
// shared memory (arrive_last's flag): the dynamic part a launch may take.
constexpr int kSmemMax = 232448 - 1024;
// The widest row whose q and acc sit in registers; wider rows take the
// kHD = 0 instantiation, one row a tile.
constexpr int kRegHD = 256;

// 16 bytes of T, widened to floats.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* s, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* s, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over aligned groups of kLanes lanes (every lane gets its group's sum).
template <int kLanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int pmod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const void* positions;  // int32, or int64 where pos64
  void* out;
  float* part;    // [tiles, n_split, kR, hd] acc, then [tiles, n_split, kR, 2]
  int* counters;  // [tiles]: one per (slot, kv head, row tile)
  int Q, H, K, hd, bs, nb, ring_len, window, local, pos64;
  int rows, row_tiles, cps, n_split;
  float softcap, scale;
};

// The chunk-level view of the ring mask. Ring entry idx of a local ring
// holds position held = newest - ((newest - idx) mod ring_len), newest =
// pos + Q - 1; a global entry holds idx. Row r (q token t) may read held in
// [lo_r, hi_r] = [max(0, pos + t - window + 1) or 0, pos + t]; some token
// of the slot may read it iff held is in [lo_any, newest].
struct Ring {
  int newest, lo_any, ring_len, bs, local;

  // (newest - c * bs) mod ring_len: entry i of chunk c sits d0 - i back
  __device__ int d0(int c) const {
    return local ? pmod(newest - c * bs, ring_len) : 0;
  }
  __device__ int held(int c, int i, int d0) const {
    if (!local) return c * bs + i;
    int d = d0 - i;  // > -ring_len
    if (d < 0) d += ring_len;
    return newest - d;
  }
  // whether any entry of chunk c is readable by some token of the slot
  __device__ bool any(int c) const {
    if (!local) return c * bs <= newest;
    const int d = d0(c);  // the chunk's entries sit d, d - 1, ... back
    return d < bs - 1 || d - (bs - 1) <= newest - lo_any;
  }
};

// grid (K * row_tiles, B, n_split); blockDim 128 or 256. kHD >= hd is the
// widest row the instantiation takes (hd a multiple of 16 bytes); kHD = 0
// takes any hd, with q and acc in shared memory.
// (kMaxThreads, 1): ptxas may take up to 255 registers; capped at 128 it
// spills the kR = 8 instantiations.
template <typename T, int kR, int kHD>
__global__ void __launch_bounds__(kMaxThreads, 1)
paged_attention_kernel(const Args a) {
  constexpr bool kWide = kHD == 0;            // q and acc in shared memory
  constexpr int kVec = Vec16<T>::kN;          // elements in 16 bytes
  constexpr int kNV = kWide ? 32 : kHD / kVec;  // 16-byte vectors of a row
  constexpr int kLPE = kNV < 32 ? kNV : 32;   // lanes over one entry's row
  constexpr int kQV = kNV / kLPE;             // vectors a lane holds a row
  constexpr int kEPW = 32 / kLPE;             // entries a warp scores at once
  constexpr int kCols = kWide ? 1 : kHD / 128;  // columns a thread owns (>= 128 threads)
  // groups whose partials the merge has in flight at once
  constexpr int kSB = 64 / (kR * kCols) < 16 ? 64 / (kR * kCols) : 16;

  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int kh = blockIdx.x / a.row_tiles, rt = blockIdx.x - kh * a.row_tiles;
  const int b = blockIdx.y, split = blockIdx.z;
  const int g = a.H / a.K, hd = a.hd, bs = a.bs, nv = hd / kVec;
  const int r0 = rt * kR, nr = min(kR, a.rows - r0);
  const int stages = a.cps > 1 ? 2 : 1;  // K/V buffers: a ring of two

  extern __shared__ __align__(16) unsigned char k6_smem[];
  T* qs = reinterpret_cast<T*>(k6_smem);                       // [kR][hd]
  T* ks = qs + kR * hd;                                        // [stages][bs][hd]
  T* vs = ks + stages * bs * hd;                               // [stages][bs][hd]
  float* sc = reinterpret_cast<float*>(vs + stages * bs * hd);  // [bs][kR]
  float* wts = sc + bs * kR;           // [n_split][kR] (n_split > 1)
  float* alpha = wts + (a.n_split > 1 ? a.n_split * kR : 0);  // [kR]
  float* inv = alpha + kR;             // [kR]
  float* accs = inv + kR;              // [kR][hd] (kWide)
  int* phys_s = reinterpret_cast<int*>(accs + (kWide ? kR * hd : 0));  // [cps]

  // the group's table slice and the slot's position, loaded together
  const int c_begin = split * a.cps, c_end = min(a.nb, c_begin + a.cps);
  for (int i = tid; i < c_end - c_begin; i += nthreads)
    phys_s[i] = a.table[static_cast<size_t>(b) * a.nb + c_begin + i];
  const int pos = a.pos64
      ? static_cast<int>(static_cast<const long long*>(a.positions)[b])
      : static_cast<const int*>(a.positions)[b];
  Ring ring;
  ring.newest = pos + a.Q - 1;
  ring.lo_any = a.local ? max(0, pos - a.window + 1) : 0;
  ring.ring_len = a.ring_len;
  ring.bs = bs;
  ring.local = a.local;

  // this thread's 16-byte copy slot: vector cv of rows / entries e0,
  // e0 + estep, ...; threads past estep * nv copy nothing. A wide row of
  // more vectors than threads: vectors cv, cv + nthreads, ... of each row.
  const bool long_rows = kWide && nv > nthreads;
  const int e0 = long_rows ? 0 : tid / nv;
  const int estep = long_rows ? 1 : nthreads / nv;
  const int cv = long_rows ? tid : tid - e0 * nv;
  const int vstep = long_rows ? nthreads : nv;
  const bool copier = e0 < estep;
  auto copy_row = [&](T* dst, const T* src, bool rd) {  // this slot's vectors
    if constexpr (kWide) {
      for (int v = 0; cv + v < nv; v += vstep)
        copy16(dst + v * kVec, rd ? src + v * kVec : src, rd);
    } else {
      copy16(dst, src, rd);
    }
  };
  const T* q = static_cast<const T*>(a.q);
  if (copier) {
    for (int r = e0; r < kR; r += estep) {
      const int rr = r0 + r, t = rr / g;
      const T* src = r < nr
          ? q + ((static_cast<size_t>(b) * a.Q + t) * a.H + kh * g + rr - t * g)
                    * hd + cv * kVec
          : q;
      copy_row(qs + r * hd + cv * kVec, src, r < nr);
    }
  }

  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const size_t entry_stride = static_cast<size_t>(a.K) * hd;
  auto stage = [&](int c, int buf) {  // issue chunk c's copies, one group
    const size_t base =
        static_cast<size_t>(phys_s[c - c_begin]) * bs * entry_stride +
        static_cast<size_t>(kh) * hd + cv * kVec;
    T* kd = ks + buf * bs * hd + cv * kVec;
    T* vd = vs + buf * bs * hd + cv * kVec;
    const int d0 = ring.d0(c);
    if (copier) {
      for (int i = e0; i < bs; i += estep) {
        const int held = ring.held(c, i, d0);
        const bool rd = held >= ring.lo_any && held <= ring.newest;
        copy_row(kd + i * hd, kp + base + i * entry_stride, rd);
        copy_row(vd + i * hd, vp + base + i * entry_stride, rd);
      }
    }
    copy_commit();
  };
  auto live = [&](int c) {
    return phys_s[c - c_begin] >= 0 && ring.any(c);
  };

  // per-row bounds of the readable held positions (padded rows: none)
  int lo_r[kR], hi_r[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = (r0 + r) / g;
    hi_r[r] = r < nr ? pos + t : -1;
    lo_r[r] = r < nr && a.local ? max(0, pos + t - a.window + 1) : 0;
  }
  float qf[kR][kQV * kVec];
  float acc[kCols][kR], m[kR], l[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j][r] = 0.f;
  }
  if constexpr (kWide)
    for (int d = tid; d < kR * hd; d += nthreads) accs[d] = 0.f;

  __syncthreads();  // phys_s
  int c = c_begin;
  while (c < c_end && !live(c)) ++c;
  if (c < c_end) stage(c, 0);
  else copy_commit();

  const int ls = lane % kLPE, eg = lane / kLPE;
  int buf = 0;
  bool first = true;
  while (c < c_end) {
    copy_wait<0>();
    __syncthreads();  // chunk c (and q) landed; the last chunk's PV is done
    if (!kWide && first) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int v = 0; v < kQV; ++v) {
          const int vi = v * kLPE + ls;
          if (vi < nv) {
            Vec16<T>::load(qs + r * hd + vi * kVec, qf[r] + v * kVec);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) qf[r][v * kVec + e] = 0.f;
          }
        }
      first = false;
    }
    int nxt = c + 1;
    while (nxt < c_end && !live(nxt)) ++nxt;
    if (nxt < c_end) stage(nxt, buf ^ 1);

    // scores: a group of kLPE lanes per entry, lanes over hd
    const T* kb = ks + buf * bs * hd;
    const int d0 = ring.d0(c);
    for (int i0 = warp * kEPW; i0 < bs; i0 += nwarps * kEPW) {
      const int i = i0 + eg;
      float dot[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dot[r] = 0.f;
      if constexpr (kWide) {
        for (int vi = ls; i < bs && vi < nv; vi += kLPE) {
          float kf[kVec], qv[kVec];
          Vec16<T>::load(kb + i * hd + vi * kVec, kf);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            Vec16<T>::load(qs + r * hd + vi * kVec, qv);
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot[r] = fmaf(qv[e], kf[e], dot[r]);
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < kQV; ++v) {
          const int vi = v * kLPE + ls;
          if (i < bs && vi < nv) {
            float kf[kVec];
            Vec16<T>::load(kb + i * hd + vi * kVec, kf);
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                dot[r] = fmaf(qf[r][v * kVec + e], kf[e], dot[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) dot[r] = lanes_sum<kLPE>(dot[r]);
      if (i < bs && ls == 0) {
        const int held = ring.held(c, i, d0);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float s = dot[r] * a.scale;
          if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
          sc[i * kR + r] = held >= lo_r[r] && held <= hi_r[r] ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: row r's (m, l) live in warp r mod nwarps
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if ((r & (nwarps - 1)) != warp) continue;
      float mx = -INFINITY;
      for (int i = lane; i < bs; i += 32) mx = fmaxf(mx, sc[i * kR + r]);
      mx = warp_max(mx);
      float al = 1.f;
      if (mx == -INFINITY) {  // no valid entry for this row in this chunk
        for (int i = lane; i < bs; i += 32) sc[i * kR + r] = 0.f;
      } else {
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.f;
        for (int i = lane; i < bs; i += 32) {
          const float pr = expf(sc[i * kR + r] - m_new);  // masked: exp(-inf) = 0
          sc[i * kR + r] = pr;
          sum += pr;
        }
        sum = lanes_sum<32>(sum);
        al = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
        l[r] = al * l[r] + sum;
        m[r] = m_new;
      }
      if (lane == 0) alpha[r] = al;
    }
    __syncthreads();

    // PV: thread owns columns tid + j * nthreads, all kR rows
    const T* vb = vs + buf * bs * hd;
    float al[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) al[r] = alpha[r];
    if constexpr (kWide) {
      for (int d = tid; d < hd; d += nthreads) {
        float aw[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) aw[r] = al[r] * accs[r * hd + d];
#pragma unroll 4
        for (int i = 0; i < bs; ++i) {
          const float v = to_f32(vb[i * hd + d]);
#pragma unroll
          for (int r = 0; r < kR; ++r) aw[r] = fmaf(sc[i * kR + r], v, aw[r]);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) accs[r * hd + d] = aw[r];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tid + j * nthreads;
      if (!kWide && d < hd) {
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[j][r] = al[r] * acc[j][r];
#pragma unroll 4
        for (int i = 0; i < bs; ++i) {
          const float v = to_f32(vb[i * hd + d]);
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[j][r] = fmaf(sc[i * kR + r], v, acc[j][r]);
        }
      }
    }
    c = nxt;
    buf ^= 1;
  }
  copy_wait<0>();  // a group with no live chunk: the q copies

  T* out = static_cast<T*>(a.out);
  size_t row_off[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int rr = r0 + r, t = rr / g;
    row_off[r] = ((static_cast<size_t>(b) * a.Q + t) * a.H + kh * g + rr - t * g)
                 * hd;
  }

  if (a.n_split == 1) {  // the only group: normalise and write
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if ((r & (nwarps - 1)) == warp && lane == 0)
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __syncthreads();
    if constexpr (kWide) {
      for (int d = tid; d < hd; d += nthreads)
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (r < nr) out[row_off[r] + d] = from_f32<T>(accs[r * hd + d] * inv[r]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tid + j * nthreads;
      if (!kWide && d < hd)
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (r < nr) out[row_off[r] + d] = from_f32<T>(acc[j][r] * inv[r]);
    }
    return;
  }

  // partial of this group; the last block of the tile merges them
  const int S = a.n_split;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t tiles = static_cast<size_t>(gridDim.x) * gridDim.y;
  float* part_acc = a.part + static_cast<size_t>(tile) * S * kR * hd;
  float* part_ml = a.part + tiles * S * kR * hd +
                   static_cast<size_t>(tile) * S * kR * 2;
  if constexpr (kWide) {
    for (int d = tid; d < hd; d += nthreads)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        part_acc[(static_cast<size_t>(split) * kR + r) * hd + d] = accs[r * hd + d];
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int d = tid + j * nthreads;
    if (!kWide && d < hd)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        part_acc[(static_cast<size_t>(split) * kR + r) * hd + d] = acc[j][r];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if ((r & (nwarps - 1)) == warp && lane == 0) {
      part_ml[(split * kR + r) * 2] = m[r];
      part_ml[(split * kR + r) * 2 + 1] = l[r];
    }
  if (!arrive_last(a.counters + tile, S)) return;
  if (tid == 0) a.counters[tile] = 0;

  // the first kSB groups' partials fly while the weights are made
  float pv[kSB][kCols][kR];
  auto fetch = [&](int s0, int d0) {
#pragma unroll
    for (int u = 0; u < kSB; ++u)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int d = d0 + j * nthreads;
#pragma unroll
        for (int r = 0; r < kR; ++r)
          pv[u][j][r] = s0 + u < S && d < hd
              ? __ldcg(part_acc + (static_cast<size_t>(s0 + u) * kR + r) * hd + d)
              : 0.f;
      }
  };
  fetch(0, tid);

  // weights exp(m_s - M) / L of each group, by row; a group with l = 0 saw
  // no valid entry and gets weight 0 (its acc is exactly 0)
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if ((r & (nwarps - 1)) != warp) continue;
    const float* ml = part_ml + r * 2;  // group s at ml + s * kR * 2
    float m_l = -INFINITY, l_l = 0.f;   // group `lane`, loaded once
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const float ms = __ldcg(ml + s * kR * 2), ls = __ldcg(ml + s * kR * 2 + 1);
      if (s == lane) {
        m_l = ms;
        l_l = ls;
      }
      if (ls > 0.f) mx = fmaxf(mx, ms);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ms = s == lane ? m_l : __ldcg(ml + s * kR * 2);
      const float ls = s == lane ? l_l : __ldcg(ml + s * kR * 2 + 1);
      const float w = ls > 0.f ? expf(ms - mx) : 0.f;
      wts[s * kR + r] = w;
      lsum = fmaf(w, ls, lsum);
    }
    lsum = lanes_sum<32>(lsum);
    const float iv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int s = lane; s < S; s += 32) wts[s * kR + r] *= iv;
  }
  __syncthreads();

  // out = sum_s w_s acc_s in group order, over columns d0 + j * nthreads
  auto merge = [&](int d0) {
    float o[kCols][kR];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int r = 0; r < kR; ++r) o[j][r] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kSB) {
      if (s0 || d0 != tid) fetch(s0, d0);
#pragma unroll
      for (int u = 0; u < kSB; ++u)
        if (s0 + u < S)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
#pragma unroll
            for (int r = 0; r < kR; ++r)
              o[j][r] = fmaf(wts[(s0 + u) * kR + r], pv[u][j][r], o[j][r]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = d0 + j * nthreads;
      if (d < hd)
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (r < nr) out[row_off[r] + d] = from_f32<T>(o[j][r]);
    }
  };
  if constexpr (kWide) {
    for (int d0 = tid; d0 < hd; d0 += nthreads) merge(d0);
  } else {
    merge(tid);
  }
}

// Shared memory of a launch, in bytes (kernels/paged_attention.py
// `plan_paged` computes the same and passes it).
size_t smem_bytes(const Args& a, int kr, size_t elem) {
  const size_t stages = a.cps > 1 ? 2 : 1;
  return (static_cast<size_t>(kr) + 2 * stages * a.bs) *
             a.hd * elem +
         (static_cast<size_t>(a.bs) * kr + (a.n_split > 1 ? a.n_split * kr : 0) +
          2 * kr + (a.hd > kRegHD ? static_cast<size_t>(kr) * a.hd : 0)) *
             sizeof(float) +
         static_cast<size_t>(a.cps) * sizeof(int);
}

template <typename T, int kR, int kHD>
int launch_rows(const Args& a, int B, int threads, int smem,
                cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};
  auto kernel = paged_attention_kernel<T, kR, kHD>;
  if (smem > 48 * 1024)
    if (const int e = cadc::opt_in(kernel, kSmemMax, opted)) return e;
  kernel<<<dim3(a.K * a.row_tiles, B, a.n_split), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kHD>
int launch_hd(const Args& a, int B, int kr, int threads, int smem,
              cudaStream_t stream) {
  switch (kr) {
    case 1: return launch_rows<T, 1, kHD>(a, B, threads, smem, stream);
    case 2: return launch_rows<T, 2, kHD>(a, B, threads, smem, stream);
    case 4: return launch_rows<T, 4, kHD>(a, B, threads, smem, stream);
    case 8: return launch_rows<T, 8, kHD>(a, B, threads, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const Args& a, int B, int kr, int threads, int smem,
           cudaStream_t stream) {
  if (a.hd * sizeof(T) % 16 || a.hd <= 0 ||
      (threads != 128 && threads != 256) ||
      smem_bytes(a, kr, sizeof(T)) > static_cast<size_t>(smem) ||
      smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.hd <= 128) return launch_hd<T, 128>(a, B, kr, threads, smem, stream);
  if (a.hd <= kRegHD) return launch_hd<T, kRegHD>(a, B, kr, threads, smem, stream);
  if (kr != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<T, 1, 0>(a, B, threads, smem, stream);
}

}  // namespace

// One launch. dtype 0 = fp32, 1 = bf16 (q, pools and out share it); pos64
// 1 = int64 positions; softcap <= 0 means none. The plan (rows kr per tile,
// row_tiles, cps chunks a group, n_split groups, threads, smem) is
// `plan_paged`'s; a group of several chunks rings two K/V buffers. With
// n_split > 1, part holds B * K * row_tiles * n_split * kr * (hd + 2)
// floats and counters B * K * row_tiles zeroed ints (left zero). Returns
// the CUDA error code after the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const void* positions, void* out, void* part, void* counters, int B,
    int Q, int H, int K, int hd, int bs, int nb, int ring_len, int window,
    int local, int pos64, int kr, int row_tiles, int cps, int n_split,
    int threads, int smem, float softcap, float scale, int dtype,
    void* stream) {
  Args a{q, k_pool, v_pool, table, positions, out,
         static_cast<float*>(part), static_cast<int*>(counters),
         Q, H, K, hd, bs, nb, ring_len, window, local, pos64,
         Q * (H / K), row_tiles, cps, n_split, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, kr, threads, smem, st);
  return launch<__nv_bfloat16>(a, B, kr, threads, smem, st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
