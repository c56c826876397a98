// Paged-KV decode for Hopper (sm_90a): single-token attention over a
// page-major pool [(L,) n_pages, Hkv, page_size, D] through a page table,
// with bf16, int8 or fp8 (e4m3) pages.
//
// Replaces ops/paged_attention.py::_paged_kernel of the JAX package.
//   q [B, Hq, D] bf16; lengths [B] int32 (>= 1); page_indices [B, pps]
//   int32 (each entry clamped to n_pages - 1); the layer is a pointer
//   offset into the 5-D pool, never a copy. Quantized pages carry f32
//   per-token scales [(L,) n_pages, Hkv, page_size]: the k scale multiplies
//   the score row, the v scale the probability row (the row sum l stays
//   unscaled), as the reference does.
//   Bound on the H100: bytes. At the engine's 7B shapes (B = 8, MHA, up to
//   1024 keys) a call reads at most 67 MB of bf16 pages (34 MB int8/fp8),
//   and does one multiply-add per query head per byte read.
//   Design: one CTA per (sequence, KV head), 256 CTAs at B = 8 in MHA, so no
//   split of the keys and no merge pass is needed to fill the card. The CTA
//   reads its length and page row from device memory (the launch needs no
//   host value from them) and walks the sequence 64 keys at a time: each
//   key's K and V rows (and scales) are looked up through the page table and
//   staged in shared memory as f32 with 16-byte loads; then the G query
//   heads of the KV head (GQA groups as rows) take the scores, an f32 online
//   softmax and P.V, as in flash_decode.cu.
#include <cuda_fp8.h>
#include <math.h>

#include "common.cuh"

constexpr int PD_THREADS = 128;
constexpr int PD_WARPS = PD_THREADS / 32;
constexpr int PD_CHUNK = 64;        // keys staged per online-softmax step
constexpr int PD_MAXG = 16;         // query heads per KV head

enum { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

template <int KIND> struct PdElem { typedef bf16 T; };
template <> struct PdElem<KV_INT8> { typedef int8_t T; };
template <> struct PdElem<KV_FP8> { typedef __nv_fp8_storage_t T; };

// 16 bytes of pool elements -> 16 / sizeof(element) floats
template <int KIND>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  if constexpr (KIND == KV_BF16) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else if constexpr (KIND == KV_INT8) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)p[i];
  } else {
    const __nv_fp8_storage_t* p =
        reinterpret_cast<const __nv_fp8_storage_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 x;
      x.__x = p[i];
      f[i] = static_cast<float>(x);
    }
  }
}

template <int D>
struct PdSmem {
  static constexpr int LDK = D + 4;   // f32 K rows: conflict-free float4 reads
  static constexpr int FLOATS = PD_MAXG * D + PD_CHUNK * LDK + PD_CHUNK * D +
                                PD_MAXG * PD_CHUNK + 2 * PD_CHUNK;
  static constexpr int BYTES = FLOATS * 4;
};

template <int KIND, int D>
__global__ void __launch_bounds__(PD_THREADS)
paged_decode_kernel(const bf16* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices,
                    bf16* __restrict__ out, int Hq, int Hkv, int n_pages,
                    int ps, int pps, int layer, float scale) {
  typedef typename PdElem<KIND>::T Elem;
  using L = PdSmem<D>;
  constexpr int EPV = 16 / sizeof(Elem);         // elements per 16 bytes
  constexpr int VPR = D / EPV;                   // 16-byte vectors per row
  constexpr int PT = PD_MAXG * D / PD_THREADS;   // (head, d) outputs/thread
  extern __shared__ __align__(16) float pd_smem[];
  float* q_sm = pd_smem;                         // [G][D]
  float* k_sm = q_sm + PD_MAXG * D;              // [CHUNK][LDK]
  float* v_sm = k_sm + PD_CHUNK * L::LDK;        // [CHUNK][D]
  float* p_sm = v_sm + PD_CHUNK * D;             // [G][CHUNK]
  float* ks_sm = p_sm + PD_MAXG * PD_CHUNK;      // [CHUNK]
  float* vs_sm = ks_sm + PD_CHUNK;               // [CHUNK]
  __shared__ float m_sm[PD_MAXG], l_sm[PD_MAXG], a_sm[PD_MAXG];

  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;
  const Elem* kpool = static_cast<const Elem*>(kp);
  const Elem* vpool = static_cast<const Elem*>(vp);
  const int* prow = page_indices + (size_t)b * pps;
  const size_t layer_pages = (size_t)layer * n_pages;

  for (int i = tid; i < G * D; i += PD_THREADS)
    q_sm[i] = __bfloat162float(qg[i]);
  if (tid < G) {
    m_sm[tid] = -INFINITY;
    l_sm[tid] = 0.f;
  }
  float acc[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) acc[i] = 0.f;
  const int len = min(lengths[b], pps * ps);
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += PD_CHUNK) {
    const int nk = min(PD_CHUNK, len - c0);
    // stage this chunk's K / V rows (and scales) through the page table
    for (int i = tid; i < PD_CHUNK * VPR; i += PD_THREADS) {
      const int j = i / VPR, c = (i % VPR) * EPV;
      float kf[EPV], vf[EPV];
      if (j < nk) {
        const int pos = c0 + j;
        const int page = min(prow[pos / ps], n_pages - 1);
        const size_t row =
            ((layer_pages + page) * Hkv + h) * (size_t)ps + pos % ps;
        unpack16<KIND>(*reinterpret_cast<const uint4*>(kpool + row * D + c),
                       kf);
        unpack16<KIND>(*reinterpret_cast<const uint4*>(vpool + row * D + c),
                       vf);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; e += 4) {
        *reinterpret_cast<float4*>(k_sm + j * L::LDK + c + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(v_sm + j * D + c + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    if (KIND != KV_BF16) {
      for (int j = tid; j < PD_CHUNK; j += PD_THREADS) {
        float ks = 0.f, vs = 0.f;
        if (j < nk) {
          const int pos = c0 + j;
          const int page = min(prow[pos / ps], n_pages - 1);
          const size_t row =
              ((layer_pages + page) * Hkv + h) * (size_t)ps + pos % ps;
          ks = k_scale[row];
          vs = v_scale[row];
        }
        ks_sm[j] = ks;
        vs_sm[j] = vs;
      }
    }
    __syncthreads();
    // scores, one thread per (head, key); keys past the length are -inf
    for (int i = tid; i < G * PD_CHUNK; i += PD_THREADS) {
      const int g = i / PD_CHUNK, j = i % PD_CHUNK;
      float s = -INFINITY;
      if (j < nk) {
        const float4* qr = reinterpret_cast<const float4*>(q_sm + g * D);
        const float4* kr = reinterpret_cast<const float4*>(k_sm + j * L::LDK);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D / 4; ++d) {
          const float4 a = qr[d], k4 = kr[d];
          dot += a.x * k4.x + a.y * k4.y + a.z * k4.z + a.w * k4.w;
        }
        s = KIND == KV_BF16 ? dot * scale : dot * (ks_sm[j] * scale);
      }
      p_sm[g * PD_CHUNK + j] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head; the chunk holds at least one
    // key, so m_new is finite. P.V takes p * v_scale, l takes p.
    for (int g = warp; g < G; g += PD_WARPS) {
      float* pr = p_sm + g * PD_CHUNK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_sm[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      pr[lane] = KIND == KV_BF16 ? p0 : p0 * vs_sm[lane];
      pr[lane + 32] = KIND == KV_BF16 ? p1 : p1 * vs_sm[lane + 32];
      if (lane == 0) {
        m_sm[g] = m_new;
        l_sm[g] = l_sm[g] * alpha + psum;
        a_sm[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V, one thread per (head, d)
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int idx = tid + i * PD_THREADS;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* pr = p_sm + g * PD_CHUNK;
        float a = acc[i] * a_sm[g];
        for (int j = 0; j < nk; ++j) a += pr[j] * v_sm[j * D + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  bf16* og = out + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int idx = tid + i * PD_THREADS;
    if (idx < G * D) {
      const float l = l_sm[idx / D];
      og[idx] = __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int KIND, int D>
static int launch_paged(const bf16* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* lengths,
                        const int* page_indices, bf16* out, int B, int Hq,
                        int Hkv, int n_pages, int ps, int pps, int layer,
                        float scale, cudaStream_t stream) {
  static int granted = 0;
  constexpr int smem = PdSmem<D>::BYTES;
  cudaError_t e = allow_smem(paged_decode_kernel<KIND, D>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  paged_decode_kernel<KIND, D><<<B * Hkv, PD_THREADS, smem, stream>>>(
      q, kp, vp, ks, vs, lengths, page_indices, out, Hq, Hkv, n_pages, ps,
      pps, layer, scale);
  return (int)cudaGetLastError();
}

template <int KIND>
static int launch_paged_d(const bf16* q, const void* kp, const void* vp,
                          const float* ks, const float* vs,
                          const int* lengths, const int* page_indices,
                          bf16* out, int B, int Hq, int Hkv, int n_pages,
                          int ps, int D, int pps, int layer, float scale,
                          cudaStream_t st) {
  if (D == 128)
    return launch_paged<KIND, 128>(q, kp, vp, ks, vs, lengths, page_indices,
                                   out, B, Hq, Hkv, n_pages, ps, pps, layer,
                                   scale, st);
  if (D == 64)
    return launch_paged<KIND, 64>(q, kp, vp, ks, vs, lengths, page_indices,
                                  out, B, Hq, Hkv, n_pages, ps, pps, layer,
                                  scale, st);
  return (int)cudaErrorInvalidValue;
}

// kv_kind: 0 bf16 pages, 1 int8, 2 fp8 e4m3 (1 and 2 need the scales)
GCT_EXPORT int paged_decode(const bf16* q, const void* k_pages,
                            const void* v_pages, const float* k_scale,
                            const float* v_scale, const int* lengths,
                            const int* page_indices, bf16* out, int B, int Hq,
                            int Hkv, int n_pages, int page_size, int D,
                            int pages_per_seq, int layer, int kv_kind,
                            float scale, void* stream) {
  if (Hq % Hkv || Hq / Hkv > PD_MAXG || page_size < 1 || n_pages < 1 ||
      (kv_kind != KV_BF16 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_kind) {
    case KV_BF16:
      return launch_paged_d<KV_BF16>(q, k_pages, v_pages, k_scale, v_scale,
                                     lengths, page_indices, out, B, Hq, Hkv,
                                     n_pages, page_size, D, pages_per_seq,
                                     layer, scale, st);
    case KV_INT8:
      return launch_paged_d<KV_INT8>(q, k_pages, v_pages, k_scale, v_scale,
                                     lengths, page_indices, out, B, Hq, Hkv,
                                     n_pages, page_size, D, pages_per_seq,
                                     layer, scale, st);
    case KV_FP8:
      return launch_paged_d<KV_FP8>(q, k_pages, v_pages, k_scale, v_scale,
                                    lengths, page_indices, out, B, Hq, Hkv,
                                    n_pages, page_size, D, pages_per_seq,
                                    layer, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
