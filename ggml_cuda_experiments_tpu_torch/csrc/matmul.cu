// Dense GEMM on Hopper (sm_90a): C = op(x) @ op(w), any M, N, K.
//
// Replaces ops/matmul.py::_matmul_kernel of the JAX package (the reference's
// WMMA HMMA / IMMA GEMMs, tensor-core.cu:87-254, :513-589): C = op(x) op(w)
// with f32 accumulation (int32 for int8). op(x)[m, k] lies at
// x[m * lda + k] ("K-major") or x[k * lda + m] ("M-major"), and op(w)^T
// [N, K] likewise, so the four transpose combinations are read through
// strides with no transposed copy. Output C [M, N] row-major: f32, bf16, f16
// or int32, rounded from the accumulator at the store.
//
// Bound on the H100: operations at the GEMM sizes (2 M N K at 989 TFLOP/s
// bf16 / f16, 1,979 TOP/s int8, 67 TFLOP/s f32); bytes at M = 1.
//
// Three kernels; ops/matmul.py::route picks one from dtype, layout and
// alignment, and matmul_nt refuses (cudaErrorInvalidValue) a route the
// operands cannot take:
//   0 "wgmma" -- wgmma_gemm_kernel: bf16 / f16 in every transpose
//     combination, and int8 when both operands are K-major (8-bit wgmma
//     reads K-major operands only), wherever TMA can describe both operands
//     (base 16-byte aligned, leading stride a multiple of 16 bytes). A CTA
//     of 3 warpgroups computes a 128 x WG_BN tile: warpgroup 0 is the
//     producer (one thread issues cp.async.bulk.tensor loads of 128-byte K
//     slices -- 64 bf16 / 128 int8 -- into a WG_STAGES-deep ring with full
//     and empty mbarriers per stage; setmaxnreg gives it 40 registers),
//     warpgroups 1 and 2 each own 64 rows and run wgmma.mma_async
//     m64nWG_BNk16 (bf16 / f16, f32 accumulators) or m64nWG_BNk32 (s8 x s8
//     -> s32, bitwise exact) from the 128-byte-swizzled tiles (setmaxnreg:
//     232 registers). An M- / N-major 16-bit operand is read through the
//     descriptor's transpose bit, in boxes of 64 M / N x 64 K. TMA fills
//     zeros past every edge, so ragged M, N and K need no mask in the loop.
//     The epilogue stages the tile through the ring's shared memory and
//     writes 16-byte rows. Tiles are rastered in groups of WG_GROUP_M row
//     tiles so that a wave reuses A and B panels from the L2. The tensor
//     maps are encoded on the host for each call (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint: no -lcuda) and passed as
//     __grid_constant__ parameters, so a CUDA-graph capture keeps them.
//     M = 1 takes this route too: at 1 x 4096 x 4096 it takes half the
//     mma.sync kernel's time (PERF.md row 18).
//     Tile 128 x 256, 4 stages of 48 KB (192 KB + barriers, one CTA an SM):
//     faster at bf16 4096^3 than 128 x 256 with 3 stages and 128 x 128 with
//     4 or 6 (PERF.md §6: each variant built apart and timed). ptxas:
//     168 registers a thread at launch, no spill; setmaxnreg moves them to
//     the consumers.
//   1 "mma" -- mma_gemm_kernel: mma.sync m16n8k16 / m16n8k32 on 128 x 128
//     tiles, two 64-byte K stages by cp.async: int8 with an M- or N-major
//     operand, and any 16-bit or 8-bit operand TMA cannot describe (a base
//     not 16-byte aligned, a leading stride not a multiple of 16 bytes).
//   2 "ffma" -- sgemm_kernel: f32 by FFMA on the CUDA cores (TF32 keeps 10
//     mantissa bits and would miss the JAX test's 1e-4 at K = 512).

#include <cuda.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MM_TILE = 128;                 // output tile rows and columns
constexpr int MM_KB = 64;                    // K bytes per stage
constexpr int MM_THREADS = 256;              // 8 warps: 2 (M) x 4 (N)
constexpr int MM_KPITCH = MM_KB + 16;        // bytes per row, K-major tile
constexpr int MM_STAGE = MM_TILE * MM_KPITCH;  // bytes per operand and stage

enum { IN_BF16 = 0, IN_F16 = 1, IN_S8 = 2, IN_F32 = 3 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2, OUT_S32 = 3 };
enum { ROUTE_WGMMA = 0, ROUTE_MMA = 1, ROUTE_FFMA = 2 };

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

// The mma.sync route: 128 x 128 output tiles, 8 warps of 64 x 32, a 64-byte
// K slice per stage (32 bf16 / 64 int8 values), two stages in shared memory.
// A tile is copied in its global layout with 16-byte cp.async (zero-filled
// past the edges) where rows are 16-byte aligned, else element by element;
// fragments come from ldmatrix (.trans for an M- / N-major 16-bit tile) or,
// for an int8 M- / N-major tile, from byte loads. Rows are padded by 16
// bytes, so ldmatrix is free of bank conflicts.
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


// ---------------------------------------------------------------- wgmma

constexpr int WG_BM = 128;                   // output rows: 2 consumers x 64
constexpr int WG_BN = 256;                   // output columns
constexpr int WG_STAGES = 4;                 // ring depth
constexpr int WG_KB = 128;                   // K bytes a stage: one swizzle row
constexpr int WG_THREADS = 384;              // producer + 2 consumer warpgroups
constexpr int WG_GROUP_M = 8;                // row tiles per raster group
constexpr int WG_A_BYTES = WG_BM * WG_KB;
constexpr int WG_STAGE = (WG_BM + WG_BN) * WG_KB;
constexpr int WG_RING = WG_STAGES * WG_STAGE;
constexpr int WG_SMEM = WG_RING + 1024 + 2 * WG_STAGES * 8;  // + align, bars
static_assert(WG_BM * (WG_BN * 4 + 16) <= WG_RING,
              "the epilogue's staging must fit in the ring");

// wgmma wrappers over the 256-column tile, m64n256k16 (16-bit, f32
// accumulators, transpose bits TA / TB) and m64n256k32 (s8, s32)
#define WG_F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_I8(i)                                                            \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),               \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40),
        WG_F8(48), WG_F8(56), WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88),
        WG_F8(96), WG_F8(104), WG_F8(112), WG_F8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_f16_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40),
        WG_F8(48), WG_F8(56), WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88),
        WG_F8(96), WG_F8(104), WG_F8(112), WG_F8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : WG_I8(0), WG_I8(8), WG_I8(16), WG_I8(24), WG_I8(32), WG_I8(40),
        WG_I8(48), WG_I8(56), WG_I8(64), WG_I8(72), WG_I8(80), WG_I8(88),
        WG_I8(96), WG_I8(104), WG_I8(112), WG_I8(120)
      : "l"(da), "l"(db), "r"(1));
}


#undef WG_F8
#undef WG_I8

// one k16 (16-bit) or k32 (8-bit) step over a 64-row A slice and the whole
// WG_BN-column B tile; TA / TB: the operand is M- / N-major (always 0 for
// 8-bit operands, which wgmma reads K-major only)
template <typename T, int TA, int TB, typename A>
__device__ __forceinline__ void wgmma_step(A (&d)[WG_BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (std::is_same<T, int8_t>::value)
    wgmma_s8_n256<TA, TB>(d, da, db);
  else if constexpr (std::is_same<T, bf16>::value)
    wgmma_bf16_n256<TA, TB>(d, da, db);
  else
    wgmma_f16_n256<TA, TB>(d, da, db);
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <typename A>
__device__ __forceinline__ void fence_acc(A (&d)[WG_BN / 2]) {
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) {
    if constexpr (std::is_same<A, int>::value)
      asm volatile("" : "+r"(d[i])::"memory");
    else
      asm volatile("" : "+f"(d[i])::"memory");
  }
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (bytes, multiples of 16)
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// a 2-D box of `map` at element coordinates (c0 inner, c1 outer) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_THREADS - 128) : "memory");
}

// two adjacent outputs of one row into the staging tile
__device__ __forceinline__ void stage2(unsigned char* p, float a, float b,
                                       int kind) {
  if (kind == OUT_F32) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else if (kind == OUT_BF16)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ void stage2(unsigned char* p, int a, int b,
                                       int kind) {
  if (kind == OUT_S32) *reinterpret_cast<int2*>(p) = make_int2(a, b);
  else *reinterpret_cast<float2*>(p) = make_float2((float)a, (float)b);
}

// A: op(x) [M, K], K-major (AK) as rows of K, else M-major as rows of M;
// B: op(w)^T [N, K], K-major (BK) as rows of K, else N-major as rows of N.
// Each tensor map's box is 128 bytes of its inner dimension (128B swizzle):
// K-major A 128 rows, K-major B WG_BN rows, an M- / N-major box 64 K rows.
template <typename T, bool AK, bool BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  void* __restrict__ out, int M, int N, int K, int out_kind,
                  int out_vec) {
  typedef typename Acc<T>::type A;
  constexpr int KE = WG_KB / sizeof(T);      // K elements a stage
  extern __shared__ unsigned char wg_raw[];
  const unsigned raw = smem_u32(wg_raw);
  const unsigned base = (raw + 1023) & ~1023u;   // the swizzle's 1 KB atoms
  unsigned char* ring = wg_raw + (base - raw);
  const unsigned bars = base + WG_RING;      // full[s], then empty[s]
  const int tid = threadIdx.x, wg = tid / 128;

  // the tile of this CTA, rastered in groups of WG_GROUP_M row tiles
  const int tiles_m = (M + WG_BM - 1) / WG_BM;
  const int tiles_n = (N + WG_BN - 1) / WG_BN;
  const int per_group = WG_GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * WG_GROUP_M;
  const int rows_in = min(tiles_m - first_m, WG_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % rows_in) * WG_BM;
  const int n0 = (in_group / rows_in) * WG_BN;
  const int nk = (K + KE - 1) / KE;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (WG_STAGES + s), WG_THREADS - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        const unsigned full = bars + 8 * s;
        mbar_wait(bars + 8 * (WG_STAGES + s), ((kt / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full, WG_STAGE);
        const unsigned sa = base + s * WG_STAGE, sb = sa + WG_A_BYTES;
        if (AK) {
          tma_load(sa, &map_a, kt * KE, m0, full);
        } else {
#pragma unroll
          for (int j = 0; j < WG_BM / 64; ++j)
            tma_load(sa + j * 8192, &map_a, m0 + 64 * j, kt * KE, full);
        }
        if (BK) {
          tma_load(sb, &map_b, kt * KE, n0, full);
        } else {
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j)
            tma_load(sb + j * 8192, &map_b, n0 + 64 * j, kt * KE, full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                   // which 64 rows of the tile
    A acc[WG_BN / 2];
#pragma unroll
    for (int i = 0; i < WG_BN / 2; ++i) acc[i] = A(0);
    // a K-major tile: 8-row groups 1 KB apart, a k step 32 bytes along the
    // swizzled row; an M- / N-major tile: boxes of 64 rows 8 KB apart, 8-K-
    // row groups 1 KB apart, a k step 16 K rows (2 KB)
    constexpr unsigned STEP_A = AK ? 32 : 2048, STEP_B = BK ? 32 : 2048;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES;
      mbar_wait(bars + 8 * s, (kt / WG_STAGES) & 1);
      const unsigned sa = base + s * WG_STAGE + cw * 8192;
      const unsigned sb = base + s * WG_STAGE + WG_A_BYTES;
      const uint64_t da = sw128_desc(sa, AK ? 16 : 8192, 1024);
      const uint64_t db = sw128_desc(sb, BK ? 16 : 8192, 1024);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_KB / 32; ++kk)
        wgmma_step<T, AK ? 0 : 1, BK ? 0 : 1>(acc, da + (kk * STEP_A >> 4),
                                              db + (kk * STEP_B >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      // the previous k slice's products are done: its stage is free
      if (kt > 0) mbar_arrive(bars + 8 * (WG_STAGES + (kt - 1) % WG_STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // epilogue: both consumers are past their last product, so the ring is
    // free; stage the tile row-major (pitch WG_BN * oes + 16) and write it
    // out in 16-byte rows
    const int oes = (out_kind == OUT_BF16 || out_kind == OUT_F16) ? 2 : 4;
    const int pitch = WG_BN * oes + 16;
    consumers_sync();
    const int lt = tid - 128, warp = (lt & 127) >> 5, lane = lt & 31;
    const int r0 = cw * 64 + warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      unsigned char* p = ring + r0 * pitch + (j * 8 + c0) * oes;
      stage2(p, acc[4 * j], acc[4 * j + 1], out_kind);
      stage2(p + 8 * pitch, acc[4 * j + 2], acc[4 * j + 3], out_kind);
    }
    consumers_sync();
    const int cpr = WG_BN * oes / 16, per = 16 / oes;
    for (int c = lt; c < WG_BM * cpr; c += WG_THREADS - 128) {
      const int r = c / cpr, n = n0 + (c % cpr) * per, m = m0 + r;
      if (m >= M || n >= N) continue;
      const unsigned char* src = ring + r * pitch + (c % cpr) * 16;
      unsigned char* dst =
          static_cast<unsigned char*>(out) + ((size_t)m * N + n) * oes;
      if (out_vec && n + per <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < per && n + e < N; ++e)
          for (int b = 0; b < oes; ++b) dst[e * oes + b] = src[e * oes + b];
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// can TMA describe a matrix of `rows` rows of `inner` elements, row i at
// base + i * ld elements: base 16-byte aligned, ld * es a multiple of 16
// (one row needs no stride)
bool tma_ok(const void* p, long long ld, int rows, int es) {
  return (uintptr_t)p % 16 == 0 && (rows == 1 || (ld * es) % 16 == 0);
}

// a 2-D map of rows x inner elements, box: 128 bytes x box_rows, swizzled
bool make_map(CUtensorMap* map, const void* p, int es, int in_kind,
              long long inner, long long rows, long long ld, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const CUtensorMapDataType dt =
      in_kind == IN_BF16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : in_kind == IN_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const long long stride = rows == 1 ? ((inner * es + 15) / 16) * 16 : ld * es;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)(WG_KB / es), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, dt, 2, const_cast<void*>(p), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool AK, bool BK>
cudaError_t launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                         void* out, int M, int N, int K, int out_kind,
                         int out_vec, cudaStream_t s) {
  static int granted = 0;
  auto kernel = wgmma_gemm_kernel<T, AK, BK>;
  cudaError_t e = allow_smem(kernel, WG_SMEM, &granted);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((M + WG_BM - 1) / WG_BM) *
                          ((N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, WG_THREADS, WG_SMEM, s>>>(ma, mb, out, M, N, K,
                                                      out_kind, out_vec);
  return cudaGetLastError();
}

// the wgmma route: both operands described by TMA, else refused
template <typename T>
cudaError_t run_wgmma(const void* x, const void* w, void* out, int M, int N,
                      int K, long long lda, long long ldb, int ak, int bk,
                      int in_kind, int out_kind, cudaStream_t s) {
  const int es = sizeof(T);
  if ((es == 1 && !(ak && bk)) || !tma_ok(x, lda, ak ? M : K, es) ||
      !tma_ok(w, ldb, bk ? N : K, es))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok_a = ak ? make_map(&ma, x, es, in_kind, K, M, lda, WG_BM)
                       : make_map(&ma, x, es, in_kind, M, K, lda, 64);
  const bool ok_b = bk ? make_map(&mb, w, es, in_kind, K, N, ldb, WG_BN)
                       : make_map(&mb, w, es, in_kind, N, K, ldb, 64);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const int oes = (out_kind == OUT_BF16 || out_kind == OUT_F16) ? 2 : 4;
  const int vec =
      (uintptr_t)out % 16 == 0 && ((long long)N * oes) % 16 == 0;
#define WG_LAUNCH(AKV, BKV)                                                 \
  launch_wgmma<T, AKV, BKV>(ma, mb, out, M, N, K, out_kind, vec, s)
  if constexpr (sizeof(T) == 1) {
    return WG_LAUNCH(true, true);
  } else {
    if (ak && bk) return WG_LAUNCH(true, true);
    if (ak) return WG_LAUNCH(true, false);
    if (bk) return WG_LAUNCH(false, true);
    return WG_LAUNCH(false, false);
  }
#undef WG_LAUNCH
}

}  // namespace

// x, w, out: device pointers. op(x)[m, k] = x[m * lda + k] when a_kmajor,
// else x[k * lda + m]; op(w)[k, n] = w[n * ldb + k] when b_kmajor, else
// w[k * ldb + n]. in_kind: 0 bf16, 1 f16, 2 int8, 3 f32; out_kind: 0 f32,
// 1 bf16, 2 f16, 3 int32 (float inputs take 0-2, int8 takes 0 or 3);
// route: 0 wgmma, 1 mma.sync, 2 FFMA (ops/matmul.py::route). A route the
// operands cannot take returns cudaErrorInvalidValue.
GCT_EXPORT int matmul_nt(const void* x, const void* w, void* out, int M,
                         int N, int K, long long lda, long long ldb,
                         int a_kmajor, int b_kmajor, int in_kind, int out_kind,
                         int route, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const bool int_in = in_kind == IN_S8;
  if (int_in ? (out_kind != OUT_S32 && out_kind != OUT_F32)
             : (out_kind < OUT_F32 || out_kind > OUT_F16))
    return (int)cudaErrorInvalidValue;
  if ((route == ROUTE_FFMA) != (in_kind == IN_F32) || route < ROUTE_WGMMA ||
      route > ROUTE_FFMA)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == ROUTE_WGMMA) {
    switch (in_kind) {
      case IN_BF16:
        return (int)run_wgmma<bf16>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                    b_kmajor, in_kind, out_kind, s);
      case IN_F16:
        return (int)run_wgmma<__half>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                      b_kmajor, in_kind, out_kind, s);
      default:
        return (int)run_wgmma<int8_t>(x, w, out, M, N, K, lda, ldb, a_kmajor,
                                      b_kmajor, in_kind, out_kind, s);
    }
  }
  if ((M + MM_TILE - 1) / MM_TILE > 65535) return (int)cudaErrorInvalidValue;
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
    default: {
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
  }
}
