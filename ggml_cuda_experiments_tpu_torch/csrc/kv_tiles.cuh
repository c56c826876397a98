// The K / V tile machinery shared by the split-KV decode kernels: the
// contiguous cache's flash_decode_partials (flash_decode.cu) and the paged
// pool's paged_decode (paged_attention.cu). A caller cuts a sequence's valid
// keys into 64-key tiles, gives each CTA (256 threads, 8 warps) a split of
// them (fd_split), and hands fd_attend a functor that fills one ring stage
// with one tile; fd_attend streams the tiles through a 4-stage cp.async
// ring, takes the scores, an online softmax and P.V with warps that own 8
// keys of every tile, folds the warps in warp order and gives each output
// element of the split to the caller's store functor. The design and its
// numbers are in flash_decode.cu's header.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

#include "common.cuh"

constexpr int FD_THREADS = 256;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_TILE = 64;                   // keys a tile
constexpr int FD_KW = FD_TILE / FD_WARPS;     // keys of a tile a warp owns
constexpr int FD_MAXG = 16;                   // query heads per KV head
constexpr int FD_STAGES = 4;                  // the K / V ring's depth

enum { FD_BF16 = 0, FD_INT8 = 1, FD_FP8 = 2 };

__device__ __forceinline__ unsigned fd_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16); src-size 0 reads nothing and zero-fills
template <int BYTES>
__device__ __forceinline__ void fd_cp_async(unsigned dst, const void* src,
                                            bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void fd_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fd_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2 packed elements of the given kind as floats
template <int KIND>
__device__ __forceinline__ float2 fd_pair(unsigned v) {
  if constexpr (KIND == FD_BF16) {
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
  } else if constexpr (KIND == FD_INT8) {
    // through the exponent bits, not int-to-float conversion (an eighth of
    // the FMA rate): 0x4B000000 | (byte ^ 0x80) is 2^23 + 128 + q, exactly
    const unsigned u = v ^ 0x8080u;
    return make_float2(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u)) - 8388736.f,
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441u)) - 8388736.f);
  } else {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xffff),
                                   __NV_E4M3);
    return __half22float2(__half2(h));
  }
}

// N elements of a K / V row in shared memory as floats (N * bytes a
// multiple of 2 bytes; 16-byte vectors where N fills one)
template <int KIND, int N>
__device__ __forceinline__ void fd_load(const unsigned char* p,
                                        float (&f)[N]) {
  constexpr int ES = KIND == FD_BF16 ? 2 : 1;
  constexpr int BYTES = N * ES;
  unsigned w[(BYTES + 3) / 4];
  if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  if constexpr (ES == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = fd_pair<KIND>(w[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = fd_pair<KIND>(w[i / 2] >> (16 * (i & 1)));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// the split [t0, t1) of 64-key tiles of a sequence of length len
__device__ __forceinline__ void fd_split(int len, int n_splits, int sp,
                                         int* t0, int* t1) {
  const int tiles = (len + FD_TILE - 1) / FD_TILE;
  const int per = (tiles + n_splits - 1) / n_splits;
  *t0 = min(sp * per, tiles);
  *t1 = min(*t0 + per, tiles);
}

// the bytes of one K / V tile and of one ring stage (K, V and, for int8 /
// fp8, the 64 k and 64 v scales)
template <int KIND, int D>
struct FdTile {
  static constexpr int ES = KIND == FD_BF16 ? 2 : 1;
  static constexpr int ROW = D * ES;           // bytes of a K / V row
  static constexpr int KV = FD_TILE * ROW;     // bytes of a K (or V) tile
  static constexpr int STAGE = 2 * KV + (KIND == FD_BF16 ? 0 : 2 * FD_TILE * 4);
};

// dynamic shared memory of fd_attend: the ring, q and p
template <int KIND, int GP, int D>
__host__ __device__ constexpr int fd_smem_bytes() {
  return FD_STAGES * FdTile<KIND, D>::STAGE +
         (GP * D + FD_WARPS * FD_KW * (GP >= 4 ? GP + 4 : GP)) * 4;
}

// One split's attention: the G query heads of one KV head (q at qg, bf16)
// over the tiles [t0, t0 + nt), whose keys at or past hi are invalid (the
// caller's issue zero-fills them). issue(t, stage) copies tile t into ring
// stage `stage` with cp.async (no commit); store(i, g, acc, m, s) takes
// output element i = g * D + d of the split: o un-normalized, the split's
// running max m and sum s of head g. GP: G rounded up to a power of two
// (the unrolled head loop); D 64 or 128. Every thread of the CTA calls it.
template <int KIND, int GP, int D, class Issue, class Store>
__device__ __forceinline__ void fd_attend(unsigned char* fd_smem,
                                          const bf16* __restrict__ qg, int G,
                                          int t0, int nt, int hi,
                                          int round_pv, float scale,
                                          Issue&& issue, Store&& store) {
  constexpr bool QUANT = KIND != FD_BF16;
  constexpr int ES = FdTile<KIND, D>::ES;
  constexpr int ROW = FdTile<KIND, D>::ROW;
  constexpr int EPC = 16 / ES;                 // elements of a 16-byte chunk
  constexpr int LPK = ROW / 16;                // lanes reading one key row
  constexpr int KPL = 32 / LPK;                // keys one 16-byte load covers
  constexpr int NL = FD_KW / KPL;              // loads for a warp's 8 keys
  constexpr int DUP = LPK / NL;                // lanes left holding one key
  constexpr int DPL = D / 32;                  // P.V columns a lane holds
  constexpr int STAGES = FD_STAGES;
  constexpr int KV = FdTile<KIND, D>::KV;
  constexpr int STAGE = FdTile<KIND, D>::STAGE;
  constexpr int PP = GP >= 4 ? GP + 4 : GP;    // p row pitch, floats
  constexpr bool QREG = GP * EPC <= 32;       // q of my chunk in registers
  static_assert(NL >= 1 && NL * DUP == LPK, "keys of a warp per load");
  static_assert(FD_WARPS * GP * D * 4 <= STAGES * STAGE,
                "the warps' fold fits in the ring");

  unsigned char* ring = fd_smem;                          // STAGES * STAGE
  float* q_sm = reinterpret_cast<float*>(fd_smem + STAGES * STAGE);
  float* p_sm = q_sm + GP * D;                            // [warp][8][PP]
  __shared__ float m_fold[FD_WARPS][GP], l_fold[FD_WARPS][GP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) issue(t0 + s, s);
    fd_commit();
  }

  // q of the G heads in f32 (heads past G: zeros)
  for (int i = tid; i < GP * D; i += FD_THREADS)
    q_sm[i] = i < G * D ? __bfloat162float(qg[i]) : 0.f;
  __syncthreads();

  float m[GP], l[GP], o[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[g][e] = 0.f;
  }
  const int c = lane % LPK;                   // the 16-byte chunk of a row
  const int kl = lane / LPK;                  // the key within a load
  const int my_key = (c / DUP) * KPL + kl;    // the key whose score I hold
  float* pw = p_sm + warp * FD_KW * PP;
  float qr[QREG ? GP : 1][EPC];
  if constexpr (QREG) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < EPC; ++e) qr[g][e] = q_sm[g * D + c * EPC + e];
  }

  for (int it = 0; it < nt; ++it) {
    fd_wait<STAGES - 2>();
    __syncthreads();            // tile it landed; every warp left tile it-1
    if (it + STAGES - 1 < nt)
      issue(t0 + it + STAGES - 1, (it + STAGES - 1) % STAGES);
    fd_commit();

    const unsigned char* st = ring + (it % STAGES) * STAGE;
    const unsigned char* ks = st + warp * FD_KW * ROW;   // my 8 K rows
    const unsigned char* vs = st + KV + warp * FD_KW * ROW;
    const int key0 = (t0 + it) * FD_TILE + warp * FD_KW;
    const bool valid = key0 + my_key < hi;
    float mult = scale, vmul = 1.f;
    if constexpr (QUANT) {
      const float* sc = reinterpret_cast<const float*>(st + 2 * KV);
      mult = sc[warp * FD_KW + my_key] * scale;
      vmul = sc[FD_TILE + warp * FD_KW + my_key];
    }

#pragma unroll
    for (int g = 0; g < GP; ++g) {
      // partial dot products of my chunk for the keys of each load
      float part[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float kv[EPC], qv[EPC];
        fd_load<KIND, EPC>(ks + (i * KPL + kl) * ROW + c * 16, kv);
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) qv[e] = qr[g][e];
        } else {
          const float* qs = q_sm + g * D + c * EPC;
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 t = *reinterpret_cast<const float4*>(qs + e);
            qv[e] = t.x; qv[e + 1] = t.y; qv[e + 2] = t.z; qv[e + 3] = t.w;
          }
        }
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) a = fmaf(qv[e], kv[e], a);
        part[i] = a;
      }
      // reduce-scatter over the LPK lanes of a row: each step over the top
      // chunk bit left halves the keys a lane holds; the DUP lanes of a
      // chunk group that end with load i's key then sum plainly
      int mask = LPK / 2;
#pragma unroll
      for (int n = NL; n > 1; n >>= 1, mask >>= 1) {
        const bool up = c & mask;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float send = up ? part[i] : part[i + n / 2];
          const float keep = up ? part[i + n / 2] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
      }
      float s = part[0];
#pragma unroll
      for (int x = DUP / 2; x >= 1; x >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, x);
      s = valid ? s * mult : -INFINITY;
      // the warp's online softmax over its 8 keys (DUP lanes hold one)
      float tmax = s;
#pragma unroll
      for (int x = DUP; x < 32; x <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, x));
      const float m_new = fmaxf(m[g], tmax);
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = expf(s - m_new);
        alpha = expf(m[g] - m_new);
      }
      float ps = p;
#pragma unroll
      for (int x = DUP; x < 32; x <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, x);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[g][e] *= alpha;
      if constexpr (QUANT) {
        p *= vmul;
        if (round_pv) p = __bfloat162float(__float2bfloat16(p));
      }
      if (c % DUP == 0) pw[my_key * PP + g] = p;
    }
    __syncwarp();
    // P.V over my 8 keys: a lane holds columns lane * DPL .. + DPL
#pragma unroll
    for (int j = 0; j < FD_KW; ++j) {
      float vv[DPL];
      fd_load<KIND, DPL>(vs + j * ROW + lane * DPL * ES, vv);
      const float* pj = pw + j * PP;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float pg = pj[g];
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[g][e] = fmaf(pg, vv[e], o[g][e]);
      }
    }
    __syncwarp();
  }

  // fold the warps in warp order; the ring is free once every warp is here
  fd_wait<0>();
  __syncthreads();
  float* o_fold = reinterpret_cast<float*>(ring);          // [warp][GP][D]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      o_fold[(warp * GP + g) * D + lane * DPL + e] = o[g][e];
    if (lane == 0) {
      m_fold[warp][g] = m[g];
      l_fold[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += FD_THREADS) {
    const int g = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) mx = fmaxf(mx, m_fold[w][g]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float mw = m_fold[w][g];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
      acc += o_fold[w * GP * D + i] * wt;
      sum += l_fold[w][g] * wt;
    }
    store(i, g, acc, mx, sum);
  }
}
