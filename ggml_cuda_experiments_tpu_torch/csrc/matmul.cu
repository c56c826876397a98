// Dense GEMM on Hopper (sm_90a): C = op(x) @ op(w), any M, N, K.
//
// Replaces ops/matmul.py::_matmul_kernel of the JAX package (the reference's
// WMMA HMMA / IMMA GEMMs, tensor-core.cu:87-254, :513-589).
//   bf16 / f16 operands: tensor cores, mma.sync m16n8k16, f32 accumulators;
//   int8 operands: mma.sync m16n8k32 s8 x s8 -> s32, bitwise exact;
//   f32 operands: FFMA on the CUDA cores (TF32 keeps 10 mantissa bits and
//   would miss the JAX test's 1e-4 at K = 512).
// op(x)[m, k] lies at x[m * sxm + k * sxk] with one of the two strides 1
// (the "K-major" layout when sxk == 1, "M-major" when sxm == 1), and the same
// for w; so the four transpose combos are read through strides, with no
// transposed copy. Output C [M, N] row-major: f32, bf16, f16 or int32,
// rounded from the accumulator at the store.
//
// Bound on the H100: operations at the GEMM sizes (2 M N K at 989 TFLOP/s
// bf16 / f16, 1,979 TOP/s int8, 67 TFLOP/s f32); bytes at M = 1.
// Design (a simple, correct tiled kernel, not yet the wgmma + TMA one that
// reaches the card's rate): 128 x 128 output tiles, 8 warps of 64 x 32, a
// 64-byte K slice per stage (32 bf16 / 64 int8 values), two stages in shared
// memory. A tile is copied in its global layout with 16-byte cp.async
// (zero-filled past the edges, so no padded copy) where rows are 16-byte
// aligned, else element by element; fragments come from ldmatrix (.trans for
// an M- / N-major 16-bit tile) or, for an int8 M- / N-major tile, from byte
// loads. Rows are padded by 16 bytes, so ldmatrix is free of bank conflicts.
#include "common.cuh"
#include <cuda_fp16.h>

namespace {

constexpr int MM_TILE = 128;                 // output tile rows and columns
constexpr int MM_KB = 64;                    // K bytes per stage
constexpr int MM_THREADS = 256;              // 8 warps: 2 (M) x 4 (N)
constexpr int MM_KPITCH = MM_KB + 16;        // bytes per row, K-major tile
constexpr int MM_STAGE = MM_TILE * MM_KPITCH;  // bytes per operand and stage

enum { IN_BF16 = 0, IN_F16 = 1, IN_S8 = 2, IN_F32 = 3 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2, OUT_S32 = 3 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2], bf16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2], __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2], int8_t) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T> struct Acc { typedef float type; };
template <> struct Acc<int8_t> { typedef int type; };

// raw storage of an element, so a zero and a copy need no arithmetic type
template <int ES> struct Raw;
template <> struct Raw<1> { typedef uint8_t type; };
template <> struct Raw<2> { typedef uint16_t type; };
template <> struct Raw<4> { typedef uint32_t type; };

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int kind) {
  if (kind == OUT_F32) static_cast<float*>(out)[i] = v;
  else if (kind == OUT_BF16) static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else static_cast<__half*>(out)[i] = __float2half(v);
}

__device__ __forceinline__ void store_out(void* out, size_t i, int v,
                                          int kind) {
  if (kind == OUT_S32) static_cast<int*>(out)[i] = v;
  else static_cast<float*>(out)[i] = (float)v;      // OUT_F32
}

// One stage of one operand into shared memory, in its global layout: a
// K-major tile is [128 rows][64 K bytes] (pitch 80), an M- / N-major one
// [64 / ES K rows][128 * ES bytes] (pitch 128 ES + 16). 512 chunks of 16
// bytes, two per thread. ``vec``: every chunk is wholly inside or outside
// the matrix and 16-byte aligned (checked by the host), so it goes by
// cp.async; else element by element with a mask.
template <typename T, bool KMAJ>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          int r0, int R, int k0, int K,
                                          long long ld, bool vec, int tid) {
  constexpr int ES = sizeof(T), VEC = 16 / ES;
  constexpr int CPR = MM_TILE * ES / 16;          // chunks per M-major row
  constexpr int MNP = MM_TILE * ES + 16;
  typedef typename Raw<ES>::type U;
  const U* s = reinterpret_cast<const U*>(src);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * MM_THREADS;
    int r, kk, off;
    if (KMAJ) {
      r = c >> 2;
      kk = (c & 3) * VEC;
      off = r * MM_KPITCH + (c & 3) * 16;
    } else {
      kk = c / CPR;
      r = (c % CPR) * VEC;
      off = kk * MNP + (c % CPR) * 16;
    }
    const int gr = r0 + r, gk = k0 + kk;
    if (vec) {
      const bool ok = gr < R && gk < K;
      const U* p = ok ? s + (KMAJ ? (long long)gr * ld + gk
                                  : (long long)gk * ld + gr)
                      : s;
      cp_async16(smem_u32(dst + off), p, ok);
    } else {
      U* d = reinterpret_cast<U*>(dst + off);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int rr = KMAJ ? gr : gr + e, ke = KMAJ ? gk + e : gk;
        d[e] = (rr < R && ke < K)
                   ? s[KMAJ ? (long long)rr * ld + ke : (long long)ke * ld + rr]
                   : U(0);
      }
    }
  }
}

__device__ __forceinline__ unsigned pack4(const unsigned char* p, int pitch) {
  return (unsigned)p[0] | ((unsigned)p[pitch] << 8) |
         ((unsigned)p[2 * pitch] << 16) | ((unsigned)p[3 * pitch] << 24);
}

template <typename T, bool AK, bool BK>
__global__ void __launch_bounds__(MM_THREADS)
mma_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                void* __restrict__ out, int M, int N, int K, long long lda,
                long long ldb, int vec_a, int vec_b, int out_kind) {
  typedef typename Acc<T>::type A;
  constexpr int ES = sizeof(T), BKE = MM_KB / ES;
  constexpr int MNP = MM_TILE * ES + 16;
  __shared__ __align__(128) unsigned char smem[2][2][MM_STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * MM_TILE, n0 = blockIdx.x * MM_TILE;
  const int nk = (K + BKE - 1) / BKE;
  A acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = A(0);

  load_tile<T, AK>(smem[0][0], x, m0, M, 0, K, lda, vec_a, tid);
  load_tile<T, BK>(smem[0][1], w, n0, N, 0, K, ldb, vec_b, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile<T, AK>(smem[st ^ 1][0], x, m0, M, (kt + 1) * BKE, K, lda,
                       vec_a, tid);
      load_tile<T, BK>(smem[st ^ 1][1], w, n0, N, (kt + 1) * BKE, K, ldb,
                       vec_b, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sa = smem[st][0];
    const unsigned char* sb = smem[st][1];
    const unsigned ua = smem_u32(sa), ub = smem_u32(sb);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {              // two 32-byte K steps
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mr = wm * 64 + i * 16;
        if (AK) {
          ldsm_x4(ua + (mr + (lane & 15)) * MM_KPITCH + ks * 32 +
                      (lane >> 4) * 16, a[i]);
        } else if (ES == 2) {
          ldsm_x4_t(ua + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * MNP +
                        (mr + ((lane >> 3) & 1) * 8) * 2, a[i]);
        } else {                                  // int8, M-major
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[i][r] = pack4(sa + (ks * 32 + t * 4 + (r >> 1) * 16) * MNP +
                                mr + g + (r & 1) * 8, MNP);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nc = wn * 32 + jj * 16;
        if (BK || ES == 2) {
          unsigned r[4];
          if (BK)
            ldsm_x4(ub + (nc + (lane & 7) + (lane >> 4) * 8) * MM_KPITCH +
                        ks * 32 + ((lane >> 3) & 1) * 16, r);
          else
            ldsm_x4_t(ub + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               MNP + (nc + (lane >> 4) * 8) * 2, r);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        } else {                                  // int8, N-major
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              b[2 * jj + f][h] = pack4(sb + (ks * 32 + t * 4 + h * 16) * MNP +
                                           nc + f * 8 + g, MNP);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j], T());
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + t * 2 + e;
          if (n < N) store_out(out, (size_t)m * N + n, acc[i][j][h * 2 + e],
                               out_kind);
        }
    }
}

// f32: 128 x 128 tiles, 8 K values per stage, each thread 8 x 8 outputs
// by FFMA, staged through registers into a second shared-memory buffer.
constexpr int SG_BK = 8, SG_P = MM_TILE + 4;

template <bool AK, bool BK>
__global__ void __launch_bounds__(MM_THREADS)
sgemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
             void* __restrict__ out, int M, int N, int K, long long lda,
             long long ldb, int out_kind) {
  __shared__ __align__(16) float As[2][SG_BK][SG_P];
  __shared__ __align__(16) float Bs[2][SG_BK][SG_P];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * MM_TILE, n0 = blockIdx.x * MM_TILE;
  const int nk = (K + SG_BK - 1) / SG_BK;
  float ra[4], rb[4];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * MM_THREADS;
      const int m = AK ? idx >> 3 : idx & 127, ka = AK ? idx & 7 : idx >> 7;
      const int n = BK ? idx >> 3 : idx & 127, kb = BK ? idx & 7 : idx >> 7;
      const int gm = m0 + m, gka = k0 + ka, gn = n0 + n, gkb = k0 + kb;
      ra[i] = (gm < M && gka < K)
                  ? x[AK ? (long long)gm * lda + gka : (long long)gka * lda + gm]
                  : 0.f;
      rb[i] = (gn < N && gkb < K)
                  ? w[BK ? (long long)gn * ldb + gkb : (long long)gkb * ldb + gn]
                  : 0.f;
    }
  };
  auto sstore = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * MM_THREADS;
      As[s][AK ? idx & 7 : idx >> 7][AK ? idx >> 3 : idx & 127] = ra[i];
      Bs[s][BK ? idx & 7 : idx >> 7][BK ? idx >> 3 : idx & 127] = rb[i];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * SG_BK);
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) sstore(s ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store_out(out, (size_t)m * N + n, acc[i][j], out_kind);
    }
  }
}

// every 16-byte chunk of a tile wholly inside or outside the matrix, and
// 16-byte aligned: base aligned, the leading dim and the contiguous extent
// multiples of 16 bytes
bool vec_ok(const void* p, long long ld, int extent, int es) {
  const int v = 16 / es;
  return ((uintptr_t)p % 16 == 0) && ld % v == 0 && extent % v == 0;
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* w, void* out, int M, int N,
                       int K, long long lda, long long ldb, int ak, int bk,
                       int out_kind, cudaStream_t s) {
  const dim3 grid((N + MM_TILE - 1) / MM_TILE, (M + MM_TILE - 1) / MM_TILE);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int es = sizeof(T);
  const int va = vec_ok(x, lda, ak ? K : M, es);
  const int vb = vec_ok(w, ldb, bk ? K : N, es);
#define MM_LAUNCH(AKV, BKV)                                                  \
  mma_gemm_kernel<T, AKV, BKV><<<grid, MM_THREADS, 0, s>>>(               \
      xt, wt, out, M, N, K, lda, ldb, va, vb, out_kind)
  if (ak && bk) MM_LAUNCH(true, true);
  else if (ak) MM_LAUNCH(true, false);
  else if (bk) MM_LAUNCH(false, true);
  else MM_LAUNCH(false, false);
#undef MM_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// x, w, out: device pointers. op(x)[m, k] = x[m * lda + k] when a_kmajor,
// else x[k * lda + m]; op(w)[k, n] = w[n * ldb + k] when b_kmajor, else
// w[k * ldb + n]. in_kind: 0 bf16, 1 f16, 2 int8, 3 f32; out_kind: 0 f32,
// 1 bf16, 2 f16, 3 int32 (float inputs take 0-2, int8 takes 0 or 3).
GCT_EXPORT int matmul_nt(const void* x, const void* w, void* out, int M,
                         int N, int K, long long lda, long long ldb,
                         int a_kmajor, int b_kmajor, int in_kind, int out_kind,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const bool int_in = in_kind == IN_S8;
  if (int_in ? (out_kind != OUT_S32 && out_kind != OUT_F32)
             : (out_kind < OUT_F32 || out_kind > OUT_F16))
    return (int)cudaErrorInvalidValue;
  if ((M + MM_TILE - 1) / MM_TILE > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_kind) {
    case IN_BF16:
      return (int)launch_mma<bf16>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                   b_kmajor, out_kind, s);
    case IN_F16:
      return (int)launch_mma<__half>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                     b_kmajor, out_kind, s);
    case IN_S8:
      return (int)launch_mma<int8_t>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                     b_kmajor, out_kind, s);
    case IN_F32: {
      const dim3 grid((N + MM_TILE - 1) / MM_TILE, (M + MM_TILE - 1) / MM_TILE);
      const float* xf = static_cast<const float*>(x);
      const float* wf = static_cast<const float*>(w);
#define SG_LAUNCH(AKV, BKV)                                                  \
  sgemm_kernel<AKV, BKV><<<grid, MM_THREADS, 0, s>>>(xf, wf, out, M, N, K, \
                                                     lda, ldb, out_kind)
      if (a_kmajor && b_kmajor) SG_LAUNCH(true, true);
      else if (a_kmajor) SG_LAUNCH(true, false);
      else if (b_kmajor) SG_LAUNCH(false, true);
      else SG_LAUNCH(false, false);
#undef SG_LAUNCH
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
