// The int8-activation 4-bit block dot shared by q4k_q8.cu and
// fused_decode.cu: the numerics of the JAX package's _chunk8_compute /
// _quant_rows_blockwise / _act_quant_build, in logical column order, for
// Q4_K-E and (through its scale trait, quant_formats.cuh: es = d,
// em = 8 d) Q4_0.
//
// Activations, per 32-block b (xl = elements 0..15, xh = 16..31, the two
// nibbles of one weight byte): a = xl - xh/16 and b = xh/16 quantized to
// int8 with scale amax/127 (1 where amax == 0; IEEE division, rintf: round
// half to even), clipped to +-127; c = 8 * sum(xh), xs = sum(xl + xh).
// Row n: y = sum_b es * (sa * zl + sb * zp + c) - em * xs, with
// zl = sum(lo * aq) over the low nibbles and zp = sum(p * bq) over the
// bytes XOR 0x80 read as int8 (p = lo + 16*hi - 128). Both dots are exact
// int32 __dp4a sums, four bytes at a time from one 16-byte load per block.
//
// Every CTA builds the operands of a whole vector in its own shared memory
// (16 + 16 + 16 bytes per block), so a matvec needs no cross-CTA step
// between its activation and its rows. All CTAs run the same code on the
// same data, so their operands are identical bit for bit.
#pragma once

#include "quant_formats.cuh"

constexpr int Q8_THREADS = 512;
constexpr int Q8_WARPS = Q8_THREADS / 32;

// Operands of one vector of K = 32 * kb, in shared memory.
struct Q8Act {
  int8_t* aq;   // [kb][16]
  int8_t* bq;   // [kb][16]
  float* c;     // [kb]
  float* xs;
  float* sa;
  float* sb;
  int kb;
};

__host__ __device__ constexpr int q8_act_bytes(int kb) { return 48 * kb; }

__device__ __forceinline__ Q8Act q8_act_at(unsigned char* base, int kb) {
  Q8Act a;
  a.kb = kb;
  a.aq = reinterpret_cast<int8_t*>(base);
  a.bq = reinterpret_cast<int8_t*>(base + 16 * kb);
  float* f = reinterpret_cast<float*>(base + 32 * kb);
  a.c = f;
  a.xs = f + kb;
  a.sa = f + 2 * kb;
  a.sb = f + 3 * kb;
  return a;
}

__device__ __forceinline__ int q8_round(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// max / sum over the 16 lanes of a half-warp (both halves at once)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The operands of block b from its values xl = element t and xh = element
// t + 16, by the half-warp of lane t (0..15) of it. Both halves of the
// warp must call it together, as the shuffles need.
__device__ __forceinline__ void q8_quant_vals(float xl, float xh,
                                              const Q8Act& a, int b, int t) {
  const float bv = __fdiv_rn(xh, 16.f);              // exact
  const float av = __fsub_rn(xl, bv);
  const float ma = half_max(fabsf(av)), mb = half_max(fabsf(bv));
  const float sxh = half_sum(xh), sx = half_sum(__fadd_rn(xl, xh));
  const float sa = ma == 0.f ? 1.f : __fdiv_rn(ma, 127.f);
  const float sb = mb == 0.f ? 1.f : __fdiv_rn(mb, 127.f);
  a.aq[16 * b + t] = (int8_t)q8_round(av, sa);
  a.bq[16 * b + t] = (int8_t)q8_round(bv, sb);
  if (t == 0) {
    a.c[b] = __fmul_rn(8.f, sxh);
    a.xs[b] = sx;
    a.sa[b] = sa;
    a.sb[b] = sb;
  }
}

// The operands of block b of the vector src(i), by the half-warp of lane
// t (0..15) of it: each lane one nibble pair (elements t and t + 16).
template <class Src>
__device__ __forceinline__ void q8_quant_block(const Src& src, const Q8Act& a,
                                               int b, int t) {
  q8_quant_vals(src(32 * b + t), src(32 * b + 16 + t), a, b, t);
}

// Build the operands of every block of the vector src(i), i < 32 * kb;
// ends with __syncthreads(). A half-warp takes a block. kb must be a
// multiple of blockDim.x / 16 (kb % 128 == 0 here), so whole warps take the
// loop together.
template <class Src>
__device__ void q8_quant(const Src& src, const Q8Act& a) {
  const int t = threadIdx.x & 15;
  for (int b = threadIdx.x >> 4; b < a.kb; b += blockDim.x >> 4)
    q8_quant_block(src, a, b, t);
  __syncthreads();
}

// A vector in device memory, read through L2 (it may have been written by
// other CTAs of the same launch, so never through the read-only path).
struct GlobalVec {
  const float* x;
  __device__ float operator()(int i) const { return __ldcg(x + i); }
};

// One row's dot: qs [.., kb*16] bytes, the block scales and mins through
// the trait f (Q4K, Q40, or Q4KS6 through its at()); kb % 128 == 0.
// Returns the full sum in every lane.
template <class F>
__device__ __forceinline__ float q8_row_dot(const uint8_t* qs, const F& f,
                                            size_t n, const Q8Act& a,
                                            int lane) {
  static_assert(F::QB == 16, "a 4-bit format");
  const int kb = a.kb;
  const uint4* q = reinterpret_cast<const uint4*>(qs + n * (size_t)kb * 16);
  const size_t i0 = n * (size_t)kb;
  float acc = 0.f;
  for (int b0 = lane; b0 < kb; b0 += 128) {
    uint4 w[4];
    float s[4], mn[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = __ldg(q + b0 + 32 * u);
      if constexpr (F::S6) {
        f.at(n, b0 + 32 * u, kb, s[u], mn[u]);
      } else {
        s[u] = f.scale(i0 + b0 + 32 * u);
        mn[u] = f.min(i0 + b0 + 32 * u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = b0 + 32 * u;
      const int4 av = *reinterpret_cast<const int4*>(a.aq + 16 * b);
      const int4 bv = *reinterpret_cast<const int4*>(a.bq + 16 * b);
      int zl = __dp4a((int)(w[u].x & 0x0F0F0F0Fu), av.x, 0);
      zl = __dp4a((int)(w[u].y & 0x0F0F0F0Fu), av.y, zl);
      zl = __dp4a((int)(w[u].z & 0x0F0F0F0Fu), av.z, zl);
      zl = __dp4a((int)(w[u].w & 0x0F0F0F0Fu), av.w, zl);
      int zp = __dp4a((int)(w[u].x ^ 0x80808080u), bv.x, 0);
      zp = __dp4a((int)(w[u].y ^ 0x80808080u), bv.y, zp);
      zp = __dp4a((int)(w[u].z ^ 0x80808080u), bv.z, zp);
      zp = __dp4a((int)(w[u].w ^ 0x80808080u), bv.w, zp);
      const float z = a.sa[b] * (float)zl + a.sb[b] * (float)zp + a.c[b];
      acc += s[u] * z - mn[u] * a.xs[b];
    }
  }
  return warp_sum(acc);
}

// Rows n < N spread over every warp of the grid; store(n, y) by lane 0.
template <class F, class Store>
__device__ void q8_rows(const uint8_t* qs, const F& f, int N, const Q8Act& a,
                        const Store& store) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * (blockDim.x >> 5);
  for (int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); n < N;
       n += nw) {
    const float y = q8_row_dot(qs, f, (size_t)n, a, lane);
    if (lane == 0) store(n, y);
  }
}

// The Q4_K-E rows of the fused kernels (fused_decode.cu)
template <class Store>
__device__ void q8_rows(const uint8_t* qs, const bf16* es, const bf16* em,
                        int N, const Q8Act& a, const Store& store) {
  q8_rows(qs, Q4K{es, em}, N, a, store);
}
