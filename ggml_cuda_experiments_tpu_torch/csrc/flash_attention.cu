// Flash-attention forward for prefill on Hopper (sm_90a): causal and/or an
// additive f32 mask.
//
// Replaces ops/flash_attention.py::_flash_kernel of the JAX package.
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] bf16 -> out [B, Hq, Sq, D] bf16;
//   score = (q . k) * scale + mask[b, h, i, j] (mask optional, read through
//   four element strides, any of them 0 for a broadcast dim); with `causal`
//   query i attends key j iff j <= i + Sk - Sq (the reference's decode
//   convention); GQA maps query head h to KV head h / (Hq / Hkv). A row whose
//   every key is masked gives 0.
//   lse (optional, f32 [B, Hq, Sq]): the row's log-sum-exp m + log l of the
//   scaled, masked scores, from the (m, l) state the softmax already holds;
//   -inf for a row whose every key is masked (l = 0), as the reference's
//   _store writes it (return_residuals=True, ring attention's merge input).
//   Bound on the H100: the tensor cores (4 * Sq * Sk * D / 2 FLOPs per head
//   against 2 * Sk * D bytes of K/V per query tile). Design: one CTA per
//   (64-query tile, head), 4 warps, each owning 16 query rows end to end, so
//   the softmax needs no CTA-wide barrier. Per 64-key tile: S = Q K^T with
//   WMMA bf16 m16n16k16 (f32 accumulation), f32 online softmax (m, l),
//   P rounded to bf16 as the reference does before P.V, and O += P V with
//   the f32 accumulator kept in shared memory so it can be rescaled by row.
//   Key tiles past the causal frontier of the query tile are never loaded.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 128;

template <int D>
struct FaSmem {
  static constexpr int LDQ = D + 8;       // bf16 Q/K/V tile rows
  static constexpr int LDS = FA_BK + 4;   // f32 scores
  static constexpr int LDP = FA_BK + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;       // f32 output accumulator
  static constexpr int BYTES = 3 * FA_BQ * LDQ * 2 + FA_BQ * LDS * 4 +
                               FA_BQ * LDP * 2 + FA_BQ * LDO * 4 +
                               2 * FA_BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ lse, int Hq, int Hkv, int Sq,
                       int Sk, float scale, int causal, long long smb,
                       long long smh, long long smq, long long smk) {
  using L = FaSmem<D>;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + FA_BQ * L::LDQ;
  bf16* Vs = Ks + FA_BK * L::LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + FA_BK * L::LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + FA_BQ * L::LDS);
  float* Os = reinterpret_cast<float*>(Ps + FA_BQ * L::LDP);
  float* m_s = Os + FA_BQ * L::LDO;
  float* l_s = m_s + FA_BQ;

  const int q0 = blockIdx.x * FA_BQ, bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int offset = Sk - Sq;
  const bf16* qh = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const float* mh = mask ? mask + b * smb + h * smh : nullptr;

  constexpr int VEC = D / 8;           // 16-byte vectors per row
  for (int i = tid; i < FA_BQ * VEC; i += FA_THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qh + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * L::LDQ + c) = val;
  }
  for (int i = tid; i < FA_BQ * L::LDO; i += FA_THREADS) Os[i] = 0.f;
  if (tid < FA_BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  int n_tiles = (Sk + FA_BK - 1) / FA_BK;
  if (causal) {
    const int last_q = min(q0 + FA_BQ, Sq) - 1;
    n_tiles = min(n_tiles, (last_q + offset) / FA_BK + 1);
  }
  __syncthreads();

  const int r0 = warp * 16;            // this warp's query rows
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FA_BK;
    for (int i = tid; i < FA_BK * VEC; i += FA_THREADS) {
      const int r = i / VEC, c = (i % VEC) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::LDQ + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * L::LDQ + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for rows r0 .. r0 + 15
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[FA_BK / 16];
#pragma unroll
      for (int j = 0; j < FA_BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int j = 0; j < FA_BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + (j * 16) * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sacc[j], a, kb, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < FA_BK / 16; ++j)
        wmma::store_matrix_sync(Ss + r0 * L::LDS + j * 16, sacc[j], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax per row; lanes hold keys lane and lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      const bool ok0 = kp0 < Sk && (!causal || kp0 <= qpos + offset);
      const bool ok1 = kp1 < Sk && (!causal || kp1 <= qpos + offset);
      float s0 = ok0 ? Ss[r * L::LDS + lane] * scale : -INFINITY;
      float s1 = ok1 ? Ss[r * L::LDS + lane + 32] * scale : -INFINITY;
      if (mh && qpos < Sq) {
        const float* mr = mh + qpos * smq;
        if (ok0) s0 += mr[kp0 * smk];
        if (ok1) s1 += mr[kp1 * smk];
      }
      const float m_old = m_s[r], l_old = l_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      }
      const float l_new = l_old * alpha + warp_sum(p0 + p1);
      Ps[r * L::LDP + lane] = __float2bfloat16(p0);
      Ps[r * L::LDP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) Os[r * L::LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
      }
    }
    __syncwarp();

    // O += P V for rows r0 .. r0 + 15
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + r0 * L::LDO + c * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FA_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + r0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(vb, Vs + kk * L::LDQ + c * 16, L::LDQ);
        wmma::mma_sync(oacc, pa, vb, oacc);
      }
      wmma::store_matrix_sync(Os + r0 * L::LDO + c * 16, oacc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();                   // K/V tiles are reloaded next
  }

  bf16* oh = out + ((size_t)b * Hq + h) * (size_t)Sq * D;
  if (lse && tid < FA_BQ && q0 + tid < Sq) {
    const float l = l_s[tid];
    lse[((size_t)b * Hq + h) * Sq + q0 + tid] =
        l == 0.f ? -INFINITY : m_s[tid] + logf(l);
  }
  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < Sq) {
      const float l = l_s[r];
      oh[(size_t)(q0 + r) * D + d] =
          __float2bfloat16(Os[r * L::LDO + d] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int D>
static int launch_flash_attention(const bf16* q, const bf16* k, const bf16* v,
                                  const float* mask, bf16* out, float* lse,
                                  int B, int Hq, int Hkv, int Sq, int Sk,
                                  float scale,
                                  int causal, const long long* ms,
                                  cudaStream_t stream) {
  static int granted = 0;
  constexpr int smem = FaSmem<D>::BYTES;
  cudaError_t e = allow_smem(flash_attention_kernel<D>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * Hq);
  flash_attention_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, mask, out, lse, Hq, Hkv, Sq, Sk, scale, causal, ms[0], ms[1],
      ms[2], ms[3]);
  return (int)cudaGetLastError();
}

// mask: null, or f32 read at mask[b*smb + h*smh + i*smq + j*smk];
// lse: null, or f32 [B, Hq, Sq] written beside out
GCT_EXPORT int flash_attention_fwd(const bf16* q, const bf16* k,
                                   const bf16* v, const float* mask,
                                   bf16* out, float* lse, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D,
                                   float scale, int causal,
                                   long long smb, long long smh,
                                   long long smq, long long smk,
                                   void* stream) {
  if (Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long ms[4] = {smb, smh, smq, smk};
  if (D == 128)
    return launch_flash_attention<128>(q, k, v, mask, out, lse, B, Hq, Hkv,
                                       Sq, Sk, scale, causal, ms, st);
  if (D == 64)
    return launch_flash_attention<64>(q, k, v, mask, out, lse, B, Hq, Hkv,
                                      Sq, Sk, scale, causal, ms, st);
  return (int)cudaErrorInvalidValue;
}
