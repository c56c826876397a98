// Split-KV flash decode for Hopper (sm_90a): single-token attention against
// the stacked bf16 KV cache [L, B, Hkv, S, D], plus the LSE merge.
//
// Replaces ops/flash_decode.py::_decode_kernel (GQA) and ::_decode_kernel_ht
// (MHA) of the JAX package, and the pure-jnp lse_combine_stacked /
// lse_finalize that merge their splits (ops/lse.py).
//   Bound on the H100: bytes. One 7B layer at S = 1024 holds 16.8 MB of
//   K/V; the work per byte is a multiply-add per query head.
//   Design: grid (B * Hkv, n_splits). A CTA takes the G query heads of one
//   KV head as rows that share every K/V row it reads (no replicated query)
//   and walks its split in chunks of 64 keys with an f32 online softmax.
//   Scores: one warp per key, lanes across D (coalesced K rows), one warp
//   reduction per query head. P.V: one thread per (head, d) output element,
//   reading V rows coalesced. The CTA reads `lengths` from device memory and
//   stops at the length, so a split wholly past it emits the LSE identity
//   (m = -inf, s = 0, o = 0). The layer is a pointer offset: no per-layer
//   copy of the cache exists.
//   lse_merge folds the n_splits partials of every (sequence, head) with the
//   guarded combine of ops/lse.py (an empty split weighs 0, never NaN) and
//   writes o / s in bf16.
#include <math.h>

#include "common.cuh"

constexpr int FD_THREADS = 128;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_CHUNK = 64;        // keys per online-softmax step
constexpr int FD_MAXG = 16;         // query heads per KV head
constexpr int FD_MAXD = 128;
constexpr int FD_PER_THREAD = FD_MAXG * FD_MAXD / FD_THREADS;

__global__ void __launch_bounds__(FD_THREADS)
flash_decode_partials_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const int* __restrict__ lengths,
                             float* __restrict__ o_part,
                             float* __restrict__ m_part,
                             float* __restrict__ s_part, int B, int Hq,
                             int Hkv, int S, int D, int layer, int n_splits,
                             float scale) {
  __shared__ float q_sm[FD_MAXG * FD_MAXD];
  __shared__ float p_sm[FD_MAXG][FD_CHUNK];
  __shared__ float m_sm[FD_MAXG], l_sm[FD_MAXG], a_sm[FD_MAXG];

  const int bh = blockIdx.x, sp = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, GD = G * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head_off = (((size_t)layer * B + b) * Hkv + h) * (size_t)S * D;
  const bf16* kh = k + head_off;
  const bf16* vh = v + head_off;
  const bf16* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;

  for (int i = tid; i < GD; i += FD_THREADS) q_sm[i] = __bfloat162float(qg[i]);
  if (tid < G) {
    m_sm[tid] = -INFINITY;
    l_sm[tid] = 0.f;
  }
  float acc[FD_PER_THREAD];
#pragma unroll
  for (int i = 0; i < FD_PER_THREAD; ++i) acc[i] = 0.f;

  const int len = min(lengths[b], S);
  const int span = (S + n_splits - 1) / n_splits;
  const int lo = sp * span;
  const int hi = min(min(lo + span, S), len);
  const int dpl = D / 32;            // elements of a K row per lane: 2 or 4
  __syncthreads();

  for (int c0 = lo; c0 < hi; c0 += FD_CHUNK) {
    // scores of this chunk, scaled; keys past `hi` are -inf
    for (int j = warp; j < FD_CHUNK; j += FD_WARPS) {
      const int key = c0 + j;
      if (key < hi) {
        const bf16* kr = kh + (size_t)key * D + lane * dpl;
        float kv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kv[e] = e < dpl ? __bfloat162float(kr[e]) : 0.f;
        for (int g = 0; g < G; ++g) {
          const float* qr = q_sm + g * D + lane * dpl;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < dpl) part += qr[e] * kv[e];
          part = warp_sum(part);
          if (lane == 0) p_sm[g][j] = part * scale;
        }
      } else if (lane < G) {
        p_sm[lane][j] = -INFINITY;
      }
    }
    __syncthreads();
    // online-softmax update, one warp per query head; the chunk holds at
    // least one valid key, so m_new is finite
    for (int g = warp; g < G; g += FD_WARPS) {
      const float s0 = p_sm[g][lane], s1 = p_sm[g][lane + 32];
      const float m_old = m_sm[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      p_sm[g][lane] = p0;
      p_sm[g][lane + 32] = p1;
      if (lane == 0) {
        m_sm[g] = m_new;
        l_sm[g] = l_sm[g] * alpha + psum;
        a_sm[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V, one thread per (head, d)
    const int nk = min(FD_CHUNK, hi - c0);
#pragma unroll
    for (int i = 0; i < FD_PER_THREAD; ++i) {
      const int idx = tid + i * FD_THREADS;
      if (idx < GD) {
        const int g = idx / D, d = idx % D;
        const bf16* vc = vh + (size_t)c0 * D + d;
        float a = acc[i] * a_sm[g];
        for (int j = 0; j < nk; ++j)
          a += p_sm[g][j] * __bfloat162float(vc[(size_t)j * D]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const size_t part = (size_t)bh * n_splits + sp;
#pragma unroll
  for (int i = 0; i < FD_PER_THREAD; ++i) {
    const int idx = tid + i * FD_THREADS;
    if (idx < GD) o_part[part * GD + idx] = acc[i];
  }
  if (tid < G) {
    m_part[part * G + tid] = m_sm[tid];
    s_part[part * G + tid] = l_sm[tid];
  }
}

// grid B * Hq (row = (b * Hkv + h) * G + g), block D threads
__global__ void lse_merge_kernel(const float* __restrict__ o,
                                 const float* __restrict__ m,
                                 const float* __restrict__ s,
                                 bf16* __restrict__ out, int G, int D,
                                 int n_splits) {
  const int row = blockIdx.x, bh = row / G, g = row % G, d = threadIdx.x;
  float mx = -INFINITY;
  for (int sp = 0; sp < n_splits; ++sp)
    mx = fmaxf(mx, m[((size_t)bh * n_splits + sp) * G + g]);
  float st = 0.f, ot = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t pi = ((size_t)bh * n_splits + sp) * G + g;
    const float mi = m[pi];
    const float w = mi == -INFINITY ? 0.f : expf(mi - mx);
    st += s[pi] * w;
    ot += o[pi * D + d] * w;
  }
  out[(size_t)row * D + d] = __float2bfloat16(ot / (st == 0.f ? 1.f : st));
}

GCT_EXPORT int flash_decode_partials(const bf16* q, const bf16* k,
                                     const bf16* v, const int* lengths,
                                     float* o, float* m, float* s, int B,
                                     int Hq, int Hkv, int S, int D, int layer,
                                     int n_splits, float scale, void* stream) {
  if ((D != 64 && D != 128) || Hq % Hkv || Hq / Hkv > FD_MAXG ||
      n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hkv, n_splits);
  flash_decode_partials_kernel<<<grid, FD_THREADS, 0, (cudaStream_t)stream>>>(
      q, k, v, lengths, o, m, s, B, Hq, Hkv, S, D, layer, n_splits, scale);
  return (int)cudaGetLastError();
}

GCT_EXPORT int lse_merge(const float* o, const float* m, const float* s,
                         bf16* out, int B, int Hq, int Hkv, int D,
                         int n_splits, void* stream) {
  lse_merge_kernel<<<B * Hq, D, 0, (cudaStream_t)stream>>>(
      o, m, s, out, Hq / Hkv, D, n_splits);
  return (int)cudaGetLastError();
}
