// Online-softmax attention on the CUDA cores (no tensor cores), with its lse,
// for few queries and head dims below 128, on Hopper (sm_90a), split over the
// keys.
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
// Design: two launches. vpu_attention_partials_kernel: one CTA of 4 warps per
// (b * h, tile of 8 query rows, split of the keys); a split is a whole number
// of 64-key tiles (the wrapper picks it for about two waves of the card), so
// the K / V stream of one head spreads over many SMs. Per split the CTA
// writes f32 partials: o un-normalized, and the row's max m and sum l. A row
// whose visible keys all lie before the split (it has some) gets the
// identity, m = -inf, l = 0, o = 0: its MASK scores here weigh
// exp(MASK - m) = 0 against any visible score; a split that is the identity
// for all its rows loads nothing. A row with no visible key computes every
// split (m = MASK, l = its keys below S). Inside a split, K / V stream
// through shared memory in 64-key tiles, double-buffered by cp.async (16-byte
// chunks where a row is a whole number of them from an aligned base, else
// element by element), rows padded to an odd number of chunks so that lanes
// reading different rows hit different banks; one barrier per tile. Each
// warp owns 16 keys of every tile for all 8 rows: its scores (a lane: one
// key, four rows), its own online softmax (m, l) reduced over 16 lanes by
// shuffles, and its own P.V accumulator (a lane: 8 rows x D / 32 columns),
// with P passed through the warp's own shared memory; the 4 warps' states
// fold in warp order at the end of the split. vpu_attention_merge_kernel
// folds the splits of each row in split order (no atomics, so the result
// does not depend on the schedule) into o in q's dtype and the f32 lse.
#include <math.h>

#include "common.cuh"

constexpr int VA_THREADS = 128, VA_WARPS = VA_THREADS / 32;
constexpr int VA_BK = 64, VA_TQ = 8;
constexpr int VA_KW = VA_BK / VA_WARPS;        // keys of a tile per warp
constexpr int VA_CPL = 4;                      // output columns per lane
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

__device__ __forceinline__ void va_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  // K, V x 2 buffers (their space holds the warps' states at the end), q
  // (f32, scaled), and each warp's P [8][16] and alpha [8]
  __host__ __device__ int bytes() const {
    return 4 * tile_elems() * (int)sizeof(T) +
           (VA_TQ * dp + VA_WARPS * (VA_TQ * VA_KW + VA_TQ)) * 4;
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

// keys row t0 + t can see: lengths[b] clipped to the causal frontier; 0 for
// a row with no visible key
__device__ __forceinline__ int va_limit(int len, int causal, int q0_pos,
                                        int t) {
  return causal ? min(len, q0_pos + t + 1) : len;
}

// partials [B * H * T, n_splits] (o with D more floats per entry)
template <typename T>
__global__ void __launch_bounds__(VA_THREADS)
vpu_attention_partials_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lengths,
                              float* __restrict__ o_part,
                              float* __restrict__ m_part,
                              float* __restrict__ l_part, int H, int Tq,
                              int S, int D, float scale, int causal,
                              int q0_pos, int span, int n_splits, int vec) {
  const VaLayout<T> L(D);
  constexpr int CH = VaLayout<T>::CH;
  extern __shared__ __align__(16) unsigned char va_smem[];
  T* ks = reinterpret_cast<T*>(va_smem);
  T* vs = ks + 2 * L.tile_elems();
  float* qs = reinterpret_cast<float*>(vs + 2 * L.tile_elems());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ps = qs + VA_TQ * L.dp + warp * (VA_TQ * VA_KW + VA_TQ);
  float* as = ps + VA_TQ * VA_KW;

  const int n_qt = (Tq + VA_TQ - 1) / VA_TQ;
  const int sp = blockIdx.x % n_splits;
  const int rest = blockIdx.x / n_splits;
  const int t0 = (rest % n_qt) * VA_TQ, bh = rest / n_qt, b = bh / H;
  const int rows = min(VA_TQ, Tq - t0);
  const T* qh = q + ((size_t)bh * Tq + t0) * D;
  const T* kh = k + (size_t)bh * S * D;
  const T* vh = v + (size_t)bh * S * D;
  const int len = min(max(lengths[b], 0), S);
  const int start = sp * span;

  // keys this CTA's rows need: up to the last row's frontier, or all S for a
  // row with no visible key (its MASK scores all weigh the same)
  int kmax = 0;
  for (int t = 0; t < rows; ++t) {
    const int lim = va_limit(len, causal, q0_pos, t0 + t);
    kmax = max(kmax, lim > 0 ? lim : S);
  }
  const size_t row0 = (size_t)bh * Tq + t0;    // first row of the partials
  if (start >= kmax) {                         // the identity for every row
    for (int i = tid; i < rows * D; i += VA_THREADS)
      o_part[((row0 + i / D) * n_splits + sp) * D + i % D] = 0.f;
    if (tid < rows) {
      m_part[(row0 + tid) * n_splits + sp] = -INFINITY;
      l_part[(row0 + tid) * n_splits + sp] = 0.f;
    }
    return;
  }
  const int n_tiles = (min(start + span, kmax) - start + VA_BK - 1) / VA_BK;

  va_load_tile(ks, kh, start, S, D, L, vec, tid);
  va_load_tile(vs, vh, start, S, D, L, vec, tid);
  va_commit();
  for (int i = tid; i < VA_TQ * L.dp; i += VA_THREADS) {
    const int t = i / L.dp, d = i % L.dp;
    qs[i] = (t < rows && d < D) ? va_f32(qh[(size_t)t * D + d]) * scale : 0.f;
  }

  // scores: lane -> key kw of the warp's 16 and rows rg, rg + 2, rg + 4,
  // rg + 6; the warp's softmax state for those rows sits in every lane of
  // its half; P.V: lane -> columns lane + 32 c of all 8 rows
  const int kw = lane & (VA_KW - 1), rg = lane >> 4;
  float m_r[VA_TQ / 2], l_r[VA_TQ / 2], acc[VA_TQ][VA_CPL];
#pragma unroll
  for (int r = 0; r < VA_TQ / 2; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < VA_TQ; ++t)
#pragma unroll
    for (int c = 0; c < VA_CPL; ++c) acc[t][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = start + it * VA_BK;
    va_wait_all();                    // tile it has landed (this thread's
    __syncthreads();                  // copies, then everyone's); tile
                                      // it - 1's buffer is free
    if (it + 1 < n_tiles) {
      va_load_tile(ks + (buf ^ 1) * L.tile_elems(), kh, k0 + VA_BK, S, D, L,
                   vec, tid);
      va_load_tile(vs + (buf ^ 1) * L.tile_elems(), vh, k0 + VA_BK, S, D, L,
                   vec, tid);
      va_commit();
    }
    const T* kt = ks + buf * L.tile_elems();
    const T* vt = vs + buf * L.tile_elems();
    const int key = warp * VA_KW + kw;          // within the tile

    float s[VA_TQ / 2];
#pragma unroll
    for (int r = 0; r < VA_TQ / 2; ++r) s[r] = 0.f;
    for (int c = 0; c < L.nc; ++c) {
      float kf[CH];
      va_chunk(kt + key * L.rse + c * CH, kf);
#pragma unroll
      for (int r = 0; r < VA_TQ / 2; ++r) {
        if (rg + 2 * r < rows) {
          const float* qr = qs + (rg + 2 * r) * L.dp + c * CH;
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

    // the warp's online softmax over its 16 keys: a half-warp holds a row
#pragma unroll
    for (int r = 0; r < VA_TQ / 2; ++r) {
      const int t = rg + 2 * r, kj = k0 + key;
      const bool vis = kj < len && (!causal || kj <= q0_pos + t0 + t);
      const float x = kj >= S ? -INFINITY : (vis ? s[r] : VA_MASK);
      float mx = x;
#pragma unroll
      for (int o2 = 1; o2 < VA_KW; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m_r[r], mx);
      // a warp whose keys so far all lie past S keeps m = -inf
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_r[r] - mu);
      const float p = expf(x - mu);
      float ps_sum = p;
#pragma unroll
      for (int o2 = 1; o2 < VA_KW; o2 <<= 1)
        ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o2);
      m_r[r] = m_new;
      l_r[r] = l_r[r] * alpha + ps_sum;
      ps[t * VA_KW + kw] = p;
      if (kw == 0) as[t] = alpha;
    }
    __syncwarp();

    // O += P V over the warp's 16 keys
#pragma unroll
    for (int t = 0; t < VA_TQ; ++t) {
      const float a = as[t];
#pragma unroll
      for (int c = 0; c < VA_CPL; ++c) acc[t][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < VA_KW; ++j) {
      const T* vr = vt + (warp * VA_KW + j) * L.rse;
      float vv[VA_CPL];
#pragma unroll
      for (int c = 0; c < VA_CPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? va_f32(vr[d]) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < VA_TQ; ++t) {
        const float p = ps[t * VA_KW + j];
#pragma unroll
        for (int c = 0; c < VA_CPL; ++c) acc[t][c] = fmaf(p, vv[c], acc[t][c]);
      }
    }
    __syncwarp();                     // P is rewritten on the next tile
  }

  // fold the 4 warps' states in warp order; the K / V buffers hold them
  __syncthreads();
  float* red = reinterpret_cast<float*>(va_smem);     // [warp][row][D]
  float* mw = red + VA_WARPS * VA_TQ * D;             // [warp][row]
  float* lw = mw + VA_WARPS * VA_TQ;
#pragma unroll
  for (int t = 0; t < VA_TQ; ++t)
#pragma unroll
    for (int c = 0; c < VA_CPL; ++c)
      if (lane + 32 * c < D)
        red[(warp * VA_TQ + t) * D + lane + 32 * c] = acc[t][c];
  if (kw == 0) {
#pragma unroll
    for (int r = 0; r < VA_TQ / 2; ++r) {
      mw[warp * VA_TQ + rg + 2 * r] = m_r[r];
      lw[warp * VA_TQ + rg + 2 * r] = l_r[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += VA_THREADS) {
    const int t = i / D, d = i % D;
    // a row whose visible keys all lie before this split: the identity
    const int lim = va_limit(len, causal, q0_pos, t0 + t);
    const bool ident = lim > 0 && start >= lim;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < VA_WARPS; ++w) mx = fmaxf(mx, mw[w * VA_TQ + t]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < VA_WARPS; ++w) {
      const float mi = mw[w * VA_TQ + t];
      const float e = mi == -INFINITY ? 0.f : expf(mi - mx);
      l += lw[w * VA_TQ + t] * e;
      o += red[(w * VA_TQ + t) * D + d] * e;
    }
    const size_t pi = (row0 + t) * n_splits + sp;
    o_part[pi * D + d] = ident ? 0.f : o;
    if (d == 0) {
      m_part[pi] = ident ? -INFINITY : mx;
      l_part[pi] = ident ? 0.f : l;
    }
  }
}

// one CTA per row: o = sum_i w_i o_i / sum_i w_i l_i with
// w_i = exp(m_i - max m), lse = max m + log(sum_i w_i l_i), in split order
template <typename T>
__global__ void __launch_bounds__(VA_THREADS)
vpu_attention_merge_kernel(const float* __restrict__ o_part,
                           const float* __restrict__ m_part,
                           const float* __restrict__ l_part,
                           T* __restrict__ o, float* __restrict__ lse, int D,
                           int n_splits) {
  const size_t row = blockIdx.x;
  const float* mr = m_part + row * n_splits;
  const float* lr = l_part + row * n_splits;
  float mx = -INFINITY;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, mr[i]);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i)
    if (mr[i] != -INFINITY) l += lr[i] * expf(mr[i] - mx);
  const float ld = l == 0.f ? 1.f : l;
  for (int d = threadIdx.x; d < D; d += VA_THREADS) {
    float acc = 0.f;
    for (int i = 0; i < n_splits; ++i)
      if (mr[i] != -INFINITY)
        acc += o_part[(row * n_splits + i) * D + d] * expf(mr[i] - mx);
    o[row * D + d] = va_cast<T>(acc / ld);
  }
  if (threadIdx.x == 0) lse[row] = mx + logf(ld);
}

template <typename T>
static int launch_vpu_partials(const void* q, const void* k, const void* v,
                               const int* lengths, float* o_part,
                               float* m_part, float* l_part, int B, int H,
                               int Tq, int S, int D, float scale, int causal,
                               int q0_pos, int span, int n_splits, int vec,
                               cudaStream_t stream) {
  static int granted = 0;
  const int smem = VaLayout<T>(D).bytes();
  cudaError_t e = allow_smem(vpu_attention_partials_kernel<T>, smem,
                             &granted);
  if (e != cudaSuccess) return (int)e;
  const long long ctas =
      (long long)B * H * ((Tq + VA_TQ - 1) / VA_TQ) * n_splits;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  vpu_attention_partials_kernel<T><<<(unsigned)ctas, VA_THREADS, smem,
                                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, o_part, m_part, l_part, H, Tq, S, D,
      scale, causal, q0_pos, span, n_splits, vec);
  return (int)cudaGetLastError();
}

// dtype: 0 f32, 1 bf16 (q, k and v alike); vec: K / V rows are whole 16-byte
// chunks from 16-byte-aligned bases (cp.async), else element loads; span:
// keys per split, a multiple of 64, n_splits * span >= S > (n_splits - 1) *
// span; o_part f32 [B, H, T, n_splits, D], m_part / l_part f32
// [B, H, T, n_splits]
GCT_EXPORT int vpu_attention_partials(const void* q, const void* k,
                                      const void* v, const int* lengths,
                                      float* o_part, float* m_part,
                                      float* l_part, int B, int H, int Tq,
                                      int S, int D, float scale, int causal,
                                      int q0_pos, int span, int n_splits,
                                      int dtype, int vec, void* stream) {
  if (D < 1 || D > VA_CPL * 32 || Tq < 1 || S < 1 || span < VA_BK ||
      span % VA_BK || n_splits < 1 || (long long)n_splits * span < S ||
      (long long)(n_splits - 1) * span >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_vpu_partials<float>(q, k, v, lengths, o_part, m_part,
                                      l_part, B, H, Tq, S, D, scale, causal,
                                      q0_pos, span, n_splits, vec, st);
  if (dtype == 1)
    return launch_vpu_partials<bf16>(q, k, v, lengths, o_part, m_part, l_part,
                                     B, H, Tq, S, D, scale, causal, q0_pos,
                                     span, n_splits, vec, st);
  return (int)cudaErrorInvalidValue;
}

// rows = B * H * T; o [rows, D] in dtype (0 f32, 1 bf16), lse f32 [rows]
GCT_EXPORT int vpu_attention_merge(const float* o_part, const float* m_part,
                                   const float* l_part, void* o, float* lse,
                                   int rows, int D, int n_splits, int dtype,
                                   void* stream) {
  if (rows < 1 || D < 1 || n_splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    vpu_attention_merge_kernel<float><<<rows, VA_THREADS, 0, st>>>(
        o_part, m_part, l_part, static_cast<float*>(o), lse, D, n_splits);
  else if (dtype == 1)
    vpu_attention_merge_kernel<bf16><<<rows, VA_THREADS, 0, st>>>(
        o_part, m_part, l_part, static_cast<bf16*>(o), lse, D, n_splits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// registers, shared memory and occupancy of the partials kernel (see
// kernel_info in common.cuh)
GCT_EXPORT int vpu_attention_info(int dtype, int D, int* out) {
  if (D < 1 || D > VA_CPL * 32) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return kernel_info(vpu_attention_partials_kernel<float>, VA_THREADS,
                       VaLayout<float>(D).bytes(), out);
  if (dtype == 1)
    return kernel_info(vpu_attention_partials_kernel<bf16>, VA_THREADS,
                       VaLayout<bf16>(D).bytes(), out);
  return (int)cudaErrorInvalidValue;
}
