// Flash-decoding over paged-KV block tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// `_flash_kernel` (launched by `paged_attention_pallas`). Same contract as
// the gather formulation `paged_attention_torch` in
// repro_torch/kernels/paged_attention.py: q [B, Q, H, hd] (rope'd), K/V pools
// [n_blocks, bs, K, hd], block table [B, nb] int32 (-1 = unallocated; may be
// a covered-prefix slice of the full table, ring_len then carries the true
// ring length), base positions [B] int32 -> out [B, Q, H, hd] in q's dtype.
//
// Split-K flash decoding. The TPU kernel walks a slot's chunks in order on
// one core; here that would leave B * K blocks (8 at gemma3-1b's decode) on
// 132 SMs, each walking its ring in series. So the ring is cut into
// n_split groups of `cps` consecutive chunks, and one block handles one
// (kv head, slot, group): it reads its own table row (the TPU kernel got
// it by scalar prefetch) and walks its chunks. A chunk whose entry is -1,
// or whose ring positions are all masked for every q token (the ring mask
// of `_ring_mask`), is skipped without a load. In a live chunk only
// unmasked (row, entry) pairs are computed on: the kernel never multiplies
// garbage by 0, so NaN in a dead or stale entry cannot reach the output.
// The GQA group of q heads of this kv head (and all Q tokens) stays
// resident as R = Q * (H / K) rows. The online softmax keeps m, l and acc
// in fp32 shared memory across the group's chunks; its bookkeeping runs one
// warp per row. Each block writes its partial (m, l, unnormalised acc) to
// fp32 scratch, and a second kernel combines the groups of each (slot, kv
// head) in chunk order. A row with no valid entry in any group ends with
// l = 0 and writes 0.
//
// Bound on this card: every live K/V entry is read once and used for 4*R*hd
// flops, so the kernel is bound by the bytes of the live K/V over HBM
// bandwidth. This version runs on CUDA cores; each thread keeps 8 K and 8 V
// loads in flight while staging a chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 8;  // K/V elements a thread has in flight at once

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Ring-entry validity for q token t (absolute position pos + t), the
// `_ring_mask` rule: global entries hold position idx; local entries hold
// the newest position congruent to idx mod ring_len.
__device__ __forceinline__ bool ring_valid(int pos, int t, int idx, int q_len,
                                           int ring_len, int window,
                                           int local) {
  const int qp = pos + t;
  if (!local) return idx <= qp;
  const int newest = pos + q_len - 1;
  int d = (newest - idx) % ring_len;
  if (d < 0) d += ring_len;
  const int held = newest - d;
  return held >= 0 && held <= qp && held > qp - window;
}

// Offset of q/out element (b, t, head kh*g + gi, d) for resident row r.
__device__ __forceinline__ size_t row_offset(int b, int r, int d, int Q,
                                             int H, int g, int kh, int hd) {
  const int t = r / g, gi = r % g;
  return ((static_cast<size_t>(b) * Q + t) * H + kh * g + gi) * hd + d;
}

// grid (K, B, n_split). Group s writes part_m/part_l [B, K, n_split, R] and
// part_acc [B, K, n_split, R, hd] (unnormalised).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ positions,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int Q, int H, int K,
                       int hd, int bs, int nb, int cps, int ring_len,
                       int window, int local, float softcap, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int g = H / K;
  const int R = Q * g;  // resident rows: row r = t * g + gi -> head kh*g+gi

  extern __shared__ float smem[];
  float* qs = smem;             // [R][hd]
  float* acc = qs + R * hd;     // [R][hd]
  float* ks = acc + R * hd;     // [bs][hd]
  float* vs = ks + bs * hd;     // [bs][hd]
  float* sc = vs + bs * hd;     // [R][bs] scores, then probabilities
  float* m = sc + R * bs;       // [R] running max
  float* l = m + R;             // [R] running normaliser
  float* alpha = l + R;         // [R] rescale of this chunk
  unsigned char* vm = reinterpret_cast<unsigned char*>(alpha + R);  // [Q][bs]

  const int pos = positions[b];
  const size_t row_stride = static_cast<size_t>(K) * hd;  // one pool entry

  for (int e = threadIdx.x; e < R * hd; e += kThreads) {
    qs[e] = to_f32(q[row_offset(b, e / hd, e % hd, Q, H, g, kh, hd)]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_end = min(nb, (split + 1) * cps);
  for (int c = split * cps; c < c_end; ++c) {
    const int phys = table[static_cast<size_t>(b) * nb + c];
    if (phys < 0) continue;  // unallocated: uniform over the block

    int any = 0;
    for (int e = threadIdx.x; e < Q * bs; e += kThreads) {
      const int t = e / bs, i = e % bs;
      const bool ok =
          ring_valid(pos, t, c * bs + i, Q, ring_len, window, local);
      vm[e] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // whole chunk masked: skip

    const T* kb = k_pool + static_cast<size_t>(phys) * bs * row_stride + kh * hd;
    const T* vb = v_pool + static_cast<size_t>(phys) * bs * row_stride + kh * hd;
    const int n_kv = bs * hd;
    for (int e0 = threadIdx.x; e0 < n_kv; e0 += kThreads * kLoadBatch) {
      float kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n_kv) {
          const size_t off = (e / hd) * row_stride + e % hd;
          kr[u] = to_f32(kb[off]);
          vr[u] = to_f32(vb[off]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n_kv) {
          ks[e] = kr[u];
          vs[e] = vr[u];
        }
      }
    }
    __syncthreads();

    // scores: one warp per (row, entry) pair, lanes over hd
    for (int p = warp; p < R * bs; p += kWarps) {
      const int r = p / bs, i = p % bs;
      if (!vm[(r / g) * bs + i]) {
        if (lane == 0) sc[p] = -INFINITY;
        continue;
      }
      float part = 0.f;
      for (int d = lane; d < hd; d += 32)
        part = fmaf(qs[r * hd + d], ks[i * hd + d], part);
      part = warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sc[p] = s;
      }
    }
    __syncthreads();

    // online-softmax bookkeeping, one warp per row, lanes over entries
    for (int r = warp; r < R; r += kWarps) {
      const unsigned char* rv = vm + (r / g) * bs;
      float* sr = sc + r * bs;
      float mx = -INFINITY;
      for (int i = lane; i < bs; i += 32)
        if (rv[i]) mx = fmaxf(mx, sr[i]);
      mx = warp_max(mx);
      if (mx == -INFINITY) {  // no valid entry for this row in this chunk
        for (int i = lane; i < bs; i += 32) sr[i] = 0.f;
        if (lane == 0) alpha[r] = 1.f;
        continue;
      }
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < bs; i += 32) {
        const float pr = rv[i] ? expf(sr[i] - m_new) : 0.f;
        sr[i] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        l[r] = a * l[r] + sum;
        m[r] = m_new;
        alpha[r] = a;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < R * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const unsigned char* rv = vm + (r / g) * bs;
      float a = alpha[r] * acc[e];
      for (int i = 0; i < bs; ++i)
        if (rv[i]) a = fmaf(sc[r * bs + i], vs[i * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  const size_t base =
      (static_cast<size_t>(b) * K + kh) * gridDim.z + split;  // [B, K, S]
  for (int e = threadIdx.x; e < R * hd; e += kThreads)
    part_acc[base * R * hd + e] = acc[e];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    part_m[base * R + r] = m[r];
    part_l[base * R + r] = l[r];
  }
}

// grid (K, B): merges the n_split partials of one (slot, kv head) in group
// order. One warp per row first turns the groups' (m, l) into weights
// exp(m_s - M) / L in shared memory; groups with l = 0 saw no valid entry
// and get weight 0, and their (zero) acc is never read. Then each output
// element sums its groups' acc with independent loads. A row with no valid
// entry at all writes 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int Q, int H, int K,
                               int hd, int n_split) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / K;
  const int R = Q * g;
  const size_t base = (static_cast<size_t>(b) * K + kh) * n_split;
  extern __shared__ float wts[];  // [R][n_split]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < n_split; s += 32)
      if (part_l[(base + s) * R + r] > 0.f)
        mx = fmaxf(mx, part_m[(base + s) * R + r]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float ls = part_l[(base + s) * R + r];
      const float w = ls > 0.f ? expf(part_m[(base + s) * R + r] - mx) : 0.f;
      wts[r * n_split + s] = w;
      lsum = fmaf(w, ls, lsum);
    }
    lsum = warp_sum(lsum);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int s = lane; s < n_split; s += 32) wts[r * n_split + s] *= inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * hd; e += kThreads) {
    const int r = e / hd;
    const float* w = wts + r * n_split;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (w[s] != 0.f) a = fmaf(w[s], part_acc[(base + s) * R * hd + e], a);
    out[row_offset(b, r, e % hd, Q, H, g, kh, hd)] = from_f32<T>(a);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* positions, void* out, float* part_m,
           float* part_l, float* part_acc, int B, int Q, int H, int K, int hd,
           int bs, int nb, int cps, int n_split, int ring_len, int window,
           int local, float softcap, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(K, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, positions, part_m, part_l,
      part_acc, Q, H, K, hd, bs, nb, cps, ring_len, window, local, softcap,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto combine = paged_attention_combine_kernel<T>;
  const size_t wsmem = static_cast<size_t>(Q) * (H / K) * n_split *
                       sizeof(float);
  if (wsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(combine,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(wsmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine<<<dim3(K, B), kThreads, wsmem, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), Q, H, K, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it against
// the card's per-block limit before launching).
extern "C" size_t paged_attention_smem_bytes(int Q, int H, int K, int hd,
                                             int bs) {
  const size_t R = static_cast<size_t>(Q) * (H / K);
  return (2 * R * hd + 2 * static_cast<size_t>(bs) * hd + R * bs + 3 * R) *
             sizeof(float) +
         static_cast<size_t>(Q) * bs;
}

// dtype 0 = fp32, 1 = bf16 (q, pools and out share it); softcap <= 0 means
// none. The ring's nb chunks are cut into n_split groups of cps chunks;
// part_m/part_l hold B*K*n_split*R floats and part_acc B*K*n_split*R*hd
// (R = Q*H/K). Returns the CUDA error code after the launches (0 =
// success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* positions, void* out, void* part_m, void* part_l,
    void* part_acc, int B, int Q, int H, int K, int hd, int bs, int nb,
    int cps, int n_split, int ring_len, int window, int local, float softcap,
    float scale, int dtype, void* stream) {
  const size_t smem = paged_attention_smem_bytes(Q, H, K, hd, bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, positions, out, pm, pl, pa,
                         B, Q, H, K, hd, bs, nb, cps, n_split, ring_len,
                         window, local, softcap, scale, smem, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, positions, out, pm,
                               pl, pa, B, Q, H, K, hd, bs, nb, cps, n_split,
                               ring_len, window, local, softcap, scale, smem,
                               st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
