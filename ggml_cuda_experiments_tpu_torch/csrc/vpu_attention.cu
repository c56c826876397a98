// Online-softmax attention on the CUDA cores (no tensor cores), with its lse,
// for few queries and head dims below 128, on Hopper (sm_90a).
//
// Replaces ops/vpu_attention.py::_vpu_attn_kernel of the JAX package (the
// TPU's counterpart of xformers' CUDA-core memory-efficient attention).
//   q [B, H, T, D], k/v [B, H, S, D], f32 or bf16, D <= 128; lengths [B] int32
//   -> o [B, H, T, D] (q's dtype), lse [B, H, T] f32.
//   s = (scale * q) . k in f32; key j is visible to query row t iff
//   j < lengths[b] and, when causal, j <= q0_pos + t. A hidden score is
//   MASK = -0.7 * FLT_MAX, not -inf, as in the reference: a row with no
//   visible key (lengths[b] == 0) gets the mean of v over all S keys and
//   lse = MASK + log(S).
//   Bound on the H100: the K / V bytes (2 * S * D * bytes per head against
//   4 * T * S * D FLOPs); at a verify window (T = 5) the work is ~1.3 FLOP per
//   byte, far below the f32 ridge.
//   Design, simple first: one CTA of 128 threads per (b * h, tile of 8 query
//   rows). q is held in shared memory as scaled f32, zero-padded to whole
//   16-byte chunks. K / V stream through shared memory in tiles of 64 keys,
//   double-buffered by cp.async (16-byte chunks where a row is a whole number
//   of them and the base is aligned, else element by element), each row
//   padded to an odd number of chunks so that lanes reading different rows
//   hit different banks. Scores: a thread owns one key of the tile and half
//   of the tile's query rows; softmax: a warp owns a row, (m, l) in f32
//   carried across tiles; P.V: a thread owns one output column of every row,
//   its f32 accumulator in registers. Tiles wholly past every row's frontier
//   are not loaded: exact while a row has a visible key, since
//   exp(MASK - m) underflows to 0; a row with none needs all S keys.
#include <math.h>

#include "common.cuh"

constexpr int VA_THREADS = 128, VA_BK = 64, VA_TQ = 8;
// the reference's DEFAULT_MASK_VALUE, -0.7 * float32 max rounded to f32
constexpr float VA_MASK = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ unsigned va_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void va_cp_async16(unsigned dst, const void* src,
                                              bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void va_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void va_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float va_f32(float x) { return x; }
__device__ __forceinline__ float va_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T va_cast(float x);
template <>
__device__ __forceinline__ float va_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 va_cast<bf16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte chunk of shared memory as floats (4 f32 or 8 bf16)
__device__ __forceinline__ void va_chunk(const float* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void va_chunk(const bf16* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = two.x;
    f[2 * i + 1] = two.y;
  }
}

template <typename T>
struct VaLayout {
  static constexpr int CH = 16 / sizeof(T);   // elements per 16-byte chunk
  int nc, rse, dp;                              // chunks, row stride, padded D
  __host__ __device__ explicit VaLayout(int D) {
    nc = (D + CH - 1) / CH;
    dp = nc * CH;
    rse = (nc | 1) * CH;                       // an odd number of chunks
  }
  __host__ __device__ int tile_elems() const { return VA_BK * rse; }
  __host__ __device__ int bytes() const {
    return 4 * tile_elems() * (int)sizeof(T) +            // K, V x 2 buffers
           (VA_TQ * dp + VA_TQ * VA_BK + 3 * VA_TQ) * 4;  // q, p, m / l / a
  }
};

template <typename T>
__device__ __forceinline__ void va_load_tile(T* dst, const T* src, int k0,
                                             int S, int D,
                                             const VaLayout<T>& L, bool vec,
                                             int tid) {
  if (vec) {
    for (int i = tid; i < VA_BK * L.nc; i += VA_THREADS) {
      const int r = i / L.nc, c = i % L.nc;
      const bool ok = k0 + r < S;
      const T* p = ok ? src + (size_t)(k0 + r) * D + c * L.CH : src;
      va_cp_async16(va_smem_u32(dst + r * L.rse + c * L.CH), p, ok);
    }
  } else {
    for (int i = tid; i < VA_BK * L.dp; i += VA_THREADS) {
      const int r = i / L.dp, d = i % L.dp;
      dst[r * L.rse + d] = (k0 + r < S && d < D)
                               ? src[(size_t)(k0 + r) * D + d]
                               : va_cast<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(VA_THREADS)
vpu_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                     int S, int D, float scale, int causal, int q0_pos,
                     int vec) {
  const VaLayout<T> L(D);
  constexpr int CH = VaLayout<T>::CH;
  extern __shared__ __align__(16) unsigned char va_smem[];
  T* ks = reinterpret_cast<T*>(va_smem);
  T* vs = ks + 2 * L.tile_elems();
  float* qs = reinterpret_cast<float*>(vs + 2 * L.tile_elems());
  float* ps = qs + VA_TQ * L.dp;
  float* m_s = ps + VA_TQ * VA_BK;
  float* l_s = m_s + VA_TQ;
  float* a_s = l_s + VA_TQ;

  const int t0 = blockIdx.x * VA_TQ, bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = min(VA_TQ, Tq - t0);
  const T* qh = q + ((size_t)bh * Tq + t0) * D;
  const T* kh = k + (size_t)bh * S * D;
  const T* vh = v + (size_t)bh * S * D;
  const int len = min(max(lengths[b], 0), S);

  // keys this tile of rows needs: up to the last row's frontier, or all S
  // for a row with no visible key (its MASK scores all weigh the same)
  int kmax = 0;
  for (int t = 0; t < rows; ++t) {
    const int lim = causal ? min(len, q0_pos + t0 + t + 1) : len;
    kmax = max(kmax, lim > 0 ? lim : S);
  }
  const int n_tiles = (kmax + VA_BK - 1) / VA_BK;

  va_load_tile(ks, kh, 0, S, D, L, vec, tid);
  va_load_tile(vs, vh, 0, S, D, L, vec, tid);
  va_commit();
  for (int i = tid; i < VA_TQ * L.dp; i += VA_THREADS) {
    const int t = i / L.dp, d = i % L.dp;
    qs[i] = (t < rows && d < D) ? va_f32(qh[(size_t)t * D + d]) * scale : 0.f;
  }
  if (tid < VA_TQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[VA_TQ];
#pragma unroll
  for (int t = 0; t < VA_TQ; ++t) acc[t] = 0.f;

  const int j = tid % VA_BK, rg = tid / VA_BK;  // score: key j, rows rg + 2r
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = it * VA_BK;
    const T* kt = ks + buf * L.tile_elems();
    const T* vt = vs + buf * L.tile_elems();
    if (it + 1 < n_tiles) {
      va_load_tile(ks + (buf ^ 1) * L.tile_elems(), kh, k0 + VA_BK, S, D, L,
                   vec, tid);
      va_load_tile(vs + (buf ^ 1) * L.tile_elems(), vh, k0 + VA_BK, S, D, L,
                   vec, tid);
      va_commit();
      va_wait<1>();
    } else {
      va_wait<0>();
    }
    __syncthreads();

    // scores of key k0 + j against rows rg, rg + 2, ...
    {
      float s[VA_TQ / 2];
#pragma unroll
      for (int r = 0; r < VA_TQ / 2; ++r) s[r] = 0.f;
      for (int c = 0; c < L.nc; ++c) {
        float kf[CH];
        va_chunk(kt + j * L.rse + c * CH, kf);
#pragma unroll
        for (int r = 0; r < VA_TQ / 2; ++r) {
          const int t = rg + 2 * r;
          if (t < rows) {
            const float* qr = qs + t * L.dp + c * CH;
#pragma unroll
            for (int e = 0; e < CH; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              s[r] = fmaf(qv.x, kf[e], s[r]);
              s[r] = fmaf(qv.y, kf[e + 1], s[r]);
              s[r] = fmaf(qv.z, kf[e + 2], s[r]);
              s[r] = fmaf(qv.w, kf[e + 3], s[r]);
            }
          }
        }
      }
      const int key = k0 + j;
#pragma unroll
      for (int r = 0; r < VA_TQ / 2; ++r) {
        const int t = rg + 2 * r;
        const bool vis = key < len && (!causal || key <= q0_pos + t0 + t);
        ps[t * VA_BK + j] = key >= S ? -INFINITY : (vis ? s[r] : VA_MASK);
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w and w + 4; lanes hold keys lane and
    // lane + 32
    for (int t = warp; t < VA_TQ; t += VA_THREADS / 32) {
      const float s0 = ps[t * VA_BK + lane], s1 = ps[t * VA_BK + lane + 32];
      const float m_old = m_s[t];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_old - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[t * VA_BK + lane] = p0;
      ps[t * VA_BK + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        m_s[t] = m_new;
        l_s[t] = l_s[t] * alpha + psum;
        a_s[t] = alpha;
      }
    }
    __syncthreads();

    // O += P V: thread tid owns output column tid of every row
    if (tid < D) {
#pragma unroll
      for (int t = 0; t < VA_TQ; ++t) acc[t] *= a_s[t];
      for (int jj = 0; jj < VA_BK; ++jj) {
        const float vv = va_f32(vt[jj * L.rse + tid]);
#pragma unroll
        for (int t = 0; t < VA_TQ; ++t)
          acc[t] = fmaf(ps[t * VA_BK + jj], vv, acc[t]);
      }
    }
    __syncthreads();                   // the buffers and P are reused next
  }

  if (tid < D) {
#pragma unroll
    for (int t = 0; t < VA_TQ; ++t) {
      if (t < rows) {
        const float l = l_s[t];
        o[((size_t)bh * Tq + t0 + t) * D + tid] =
            va_cast<T>(acc[t] / (l == 0.f ? 1.f : l));
      }
    }
  }
  if (tid < rows) {
    const float l = l_s[tid];
    lse[(size_t)bh * Tq + t0 + tid] = m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T>
static int launch_vpu_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, float* lse, int B,
                                int H, int Tq, int S, int D, float scale,
                                int causal, int q0_pos, int vec,
                                cudaStream_t stream) {
  static int granted = 0;
  const int smem = VaLayout<T>(D).bytes();
  cudaError_t e = allow_smem(vpu_attention_kernel<T>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + VA_TQ - 1) / VA_TQ, B * H);
  vpu_attention_kernel<T><<<grid, VA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), lse, H, Tq, S, D,
      scale, causal, q0_pos, vec);
  return (int)cudaGetLastError();
}

// dtype: 0 f32, 1 bf16 (q, k, v and o alike); vec: K / V rows are whole
// 16-byte chunks from 16-byte-aligned bases (cp.async), else element loads
GCT_EXPORT int vpu_attention_fwd(const void* q, const void* k, const void* v,
                                 const int* lengths, void* o, float* lse,
                                 int B, int H, int Tq, int S, int D,
                                 float scale, int causal, int q0_pos,
                                 int dtype, int vec, void* stream) {
  if (D < 1 || D > VA_THREADS || Tq < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_vpu_attention<float>(q, k, v, lengths, o, lse, B, H, Tq, S,
                                       D, scale, causal, q0_pos, vec, st);
  if (dtype == 1)
    return launch_vpu_attention<bf16>(q, k, v, lengths, o, lse, B, H, Tq, S,
                                      D, scale, causal, q0_pos, vec, st);
  return (int)cudaErrorInvalidValue;
}
