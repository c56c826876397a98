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
//   against 2 * Sk * D bytes of K/V per query tile).
// Design (FlashAttention-2 on mma.sync): one CTA per (64-query tile, head),
// 4 warps, each owning 16 query rows end to end. Q is loaded once into
// registers as mma A fragments. K / V stream through a ring of FA_STAGES
// 64-key tiles filled by cp.async 16-byte copies (rows XOR-swizzled by
// 16-byte chunk so that ldmatrix is free of bank conflicts); the copies of
// tile t + 2 are issued before tile t's math, behind one barrier per tile.
// S = Q K^T (mma.sync m16n8k16 bf16, f32 accumulation) stays in registers;
// the online softmax works on them in log2 units (exp2f with scale * log2 e
// folded into one multiply), each row's max and sum over the 4 lanes that
// hold it by two shuffles; P is rounded to bf16 as A fragments straight from
// the S accumulators (the reference's rounding point) and O += P V runs with
// V fragments from ldmatrix.trans; O's rescale by alpha is a register
// multiply, and O is divided by the f32 row sum l after the loop. Only key
// tiles that cross a warp's causal diagonal or the end of the keys, or any
// tile under a mask, take the per-element test; key tiles past the query
// tile's causal frontier are never loaded, and a warp skips the math of a
// tile wholly past its own frontier or rows wholly past Sq. Query tiles
// launch heaviest first (the tile index is reversed), so the longest causal
// rows do not form the grid's tail.
#include <math.h>

#include "common.cuh"

constexpr int FA_BK = 64;           // keys per tile
constexpr int FA_STAGES = 3;        // K / V tiles in the cp.async ring
constexpr int FA_WARPS = 4;         // 16 query rows per warp
constexpr float FA_LOG2E = 1.4426950408889634f;
constexpr float FA_LN2 = 0.6931471805599453f;

template <int D>
struct FaTile {
  static constexpr int BQ = 16 * FA_WARPS;
  static constexpr int THREADS = 32 * FA_WARPS;
  static constexpr int Q_ELEMS = BQ * D;
  static constexpr int KV_ELEMS = FA_BK * D;
  static constexpr int BYTES = (Q_ELEMS + 2 * FA_STAGES * KV_ELEMS) * 2;
};

__device__ __forceinline__ unsigned fa_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fa_cp_async16(unsigned dst, const void* src,
                                              bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void fa_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fa_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fa_ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void fa_ldsm_x4_t(unsigned addr,
                                             unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void fa_mma(float (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned fa_pack(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&two);
}

// element offset of 16-byte chunk c of row r in a tile of D-wide bf16 rows:
// the chunk is stored at c ^ (r & 7), so the 8 rows an ldmatrix reads at one
// logical chunk land in 8 different bank groups
template <int D>
__device__ __forceinline__ int fa_swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows [row0, row0 + ROWS) of a [n_rows, D] array into a swizzled tile, by
// cp.async; rows past n_rows are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void fa_load(bf16* dst, const bf16* src, int row0,
                                        int n_rows, int tid) {
  constexpr int C = D / 8;
  static_assert(ROWS * C % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int n = 0; n < ROWS * C / THREADS; ++n) {
    const int i = tid + n * THREADS, r = i / C, c = i % C;
    const bool ok = row0 + r < n_rows;
    const bf16* p = ok ? src + (size_t)(row0 + r) * D + c * 8 : src;
    fa_cp_async16(fa_smem_u32(dst + fa_swz<D>(r, c)), p, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * FA_WARPS, FA_WARPS == 4 ? 2 : 1)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ lse, int Hq, int Hkv, int Sq,
                       int Sk, float scale, int causal, long long smb,
                       long long smh, long long smq, long long smk) {
  using L = FaTile<D>;
  constexpr int KSTEPS = D / 16;      // 16-wide slices of the head dim
  constexpr int NT = FA_BK / 8;       // 8-key column tiles of S
  constexpr int DT = D / 8;           // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + L::Q_ELEMS;         // FA_STAGES K tiles, then the V tiles
  bf16* Vs = Ks + FA_STAGES * L::KV_ELEMS;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int offset = Sk - Sq;
  const bf16* qh = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const float* mh = mask ? mask + b * smb + h * smh : nullptr;

  int n_tiles = (Sk + FA_BK - 1) / FA_BK;
  if (causal)
    n_tiles = min(n_tiles, (min(q0 + L::BQ, Sq) - 1 + offset) / FA_BK + 1);

  // the ring's prologue: Q with tile 0, then tiles 1 .. FA_STAGES - 2, one
  // commit group each (empty past the last tile, so the counts stay fixed)
  fa_load<D, L::BQ, L::THREADS>(Qs, qh, q0, Sq, tid);
#pragma unroll
  for (int s = 0; s < FA_STAGES - 1; ++s) {
    if (s < n_tiles) {
      fa_load<D, FA_BK, L::THREADS>(Ks + s * L::KV_ELEMS, kh, s * FA_BK, Sk,
                                    tid);
      fa_load<D, FA_BK, L::THREADS>(Vs + s * L::KV_ELEMS, vh, s * FA_BK, Sk,
                                    tid);
    }
    fa_commit();
  }

  const int r0 = warp * 16;           // this warp's rows in the query tile
  const int row_a = q0 + r0 + g, row_b = row_a + 8;   // this thread's rows
  const float sl2 = scale * FA_LOG2E;
  unsigned qf[KSTEPS][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    fa_wait<FA_STAGES - 2>();         // tile t (and Q) have landed
    __syncthreads();                  // ... for every thread; tile t - 1's
                                      // stage is free
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        fa_ldsm_x4(fa_smem_u32(Qs + fa_swz<D>(r0 + (lane & 15),
                                              2 * kk + (lane >> 4))),
                   qf[kk]);
    }
    {
      const int nt = t + FA_STAGES - 1;
      if (nt < n_tiles) {
        const int st = nt % FA_STAGES;
        fa_load<D, FA_BK, L::THREADS>(Ks + st * L::KV_ELEMS, kh, nt * FA_BK,
                                      Sk, tid);
        fa_load<D, FA_BK, L::THREADS>(Vs + st * L::KV_ELEMS, vh, nt * FA_BK,
                                      Sk, tid);
      }
      fa_commit();
    }
    const int k0 = t * FA_BK;
    // warp-uniform: rows wholly past Sq, or a tile wholly past the warp's
    // causal frontier, add nothing
    if (q0 + r0 >= Sq || (causal && k0 > q0 + r0 + 15 + offset)) continue;
    const bf16* kt = Ks + (t % FA_STAGES) * L::KV_ELEMS;
    const bf16* vt = Vs + (t % FA_STAGES) * L::KV_ELEMS;

    // S = Q K^T: 16 rows x 64 keys, two 8-key column tiles per ldmatrix
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned kb[4];
        fa_ldsm_x4(fa_smem_u32(kt + fa_swz<D>(16 * jp + (lane & 7) +
                                                  ((lane >> 4) << 3),
                                              2 * kk + ((lane >> 3) & 1))),
                   kb);
        fa_mma(s[2 * jp], qf[kk], kb[0], kb[1]);
        fa_mma(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scores in log2 units; element (j, e) is row (e < 2 ? row_a : row_b),
    // key k0 + 8 j + 2 t4 + (e & 1)
    const bool edge = mh != nullptr || k0 + FA_BK > Sk ||
                      (causal && k0 + FA_BK - 1 > q0 + r0 + offset);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? row_a : row_b;
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool vis = kj < Sk && (!causal || kj <= qi + offset);
          float x = s[j][e] * sl2;
          if (mh && vis && qi < Sq)
            x = fmaf(__ldg(mh + qi * smq + kj * smk), FA_LOG2E, x);
          s[j][e] = vis ? x : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    }

    // online softmax: row_a holds elements 0, 1 and row_b 2, 3 of each
    // column tile; the 4 lanes of a row share its max by two shuffles
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps m = -inf: subtract 0 there, so
    // that p = 0 and alpha = 0, never NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }
    // P as A fragments: 16-key slice kk is column tiles 2 kk (a0, a1) and
    // 2 kk + 1 (a2, a3); l sums the unrounded p of this lane's columns
    unsigned pf[FA_BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - mu_a), p1 = exp2f(s[j][1] - mu_a);
      const float p2 = exp2f(s[j][2] - mu_b), p3 = exp2f(s[j][3] - mu_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = fa_pack(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = fa_pack(p2, p3);
    }

    // O += P V: two 8-wide column tiles of O per ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];
        fa_ldsm_x4_t(fa_smem_u32(vt + fa_swz<D>(16 * kk + (lane & 7) +
                                                    (((lane >> 3) & 1) << 3),
                                                2 * dp + (lane >> 4))),
                     vb);
        fa_mma(o[2 * dp], pf[kk], vb[0], vb[1]);
        fa_mma(o[2 * dp + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  // the rows' sums over their 4 lanes, O / l in bf16 staged through this
  // warp's own rows of the Q tile (read only by this warp, at t = 0), then
  // 16-byte stores
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<unsigned*>(Qs + fa_swz<D>(r0 + g, d) + 2 * t4) =
        fa_pack(o[d][0] * inv_a, o[d][1] * inv_a);
    *reinterpret_cast<unsigned*>(Qs + fa_swz<D>(r0 + g + 8, d) + 2 * t4) =
        fa_pack(o[d][2] * inv_b, o[d][3] * inv_b);
  }
  __syncwarp();
  bf16* oh = out + ((size_t)b * Hq + h) * (size_t)Sq * D;
#pragma unroll
  for (int n = 0; n < 16 * (D / 8) / 32; ++n) {
    const int i = lane + 32 * n, r = i / (D / 8), c = i % (D / 8);
    if (q0 + r0 + r < Sq)
      *reinterpret_cast<uint4*>(oh + (size_t)(q0 + r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + fa_swz<D>(r0 + r, c));
  }
  if (lse && t4 == 0) {
    float* lh = lse + ((size_t)b * Hq + h) * Sq;
    // m is in log2 units: lse = m ln 2 + log l
    if (row_a < Sq)
      lh[row_a] = l_a == 0.f ? -INFINITY : m_a * FA_LN2 + logf(l_a);
    if (row_b < Sq)
      lh[row_b] = l_b == 0.f ? -INFINITY : m_b * FA_LN2 + logf(l_b);
  }
}

template <int D>
static int launch_flash_attention(const bf16* q, const bf16* k, const bf16* v,
                                  const float* mask, bf16* out, float* lse,
                                  int B, int Hq, int Hkv, int Sq, int Sk,
                                  float scale, int causal, const long long* ms,
                                  cudaStream_t stream) {
  using L = FaTile<D>;
  static int granted = 0;
  auto kernel = flash_attention_kernel<D>;
  cudaError_t e = allow_smem(kernel, L::BYTES, &granted);
  // the largest shared-memory carveout, so that two CTAs fit on an SM
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hq, (Sq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
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

// registers, shared memory and occupancy of the kernel at head dim D (see
// kernel_info in common.cuh)
GCT_EXPORT int flash_attention_info(int D, int* out) {
  if (D == 128)
    return kernel_info(flash_attention_kernel<128>, FaTile<128>::THREADS,
                       FaTile<128>::BYTES, out);
  if (D == 64)
    return kernel_info(flash_attention_kernel<64>, FaTile<64>::THREADS,
                       FaTile<64>::BYTES, out);
  return (int)cudaErrorInvalidValue;
}
