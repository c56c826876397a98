// The per-format traits of the 32-block weight formats that share the port's
// matvec, int8-activation matvec and GEMM kernels (ops/quant_matmul.py).
//
// A trait holds a weight's scale arrays and says, for 32-block i of the
// weight (row n, block b: i = n * K/32 + b), its scale and min, so that
// w = q * scale - min:
//   Q4K  Q4_K-E: scale = bf16 es[i], min = bf16 em[i];
//   Q40  Q4_0:   scale = fp16 d[i],  min = 8 d[i] (exact: w = (q - 8) d);
//   Q80  Q8_0:   scale = fp16 d[i],  min = 0;
//   Q4KS6 Q4_K "s6" (S6): the 6-bit sub-scales and mins one byte each, sm
//        int8 [N, 2 K/32] (row n: the sc of its K/32 blocks, then their
//        mn), and the superblock scales dd bf16 [N, 2 K/256] (row n: the d
//        of its K/256 superblocks, then their dmin); for block b of row n,
//        scale = f32(d[b / 8]) * sc[b] and min = f32(dmin[b / 8]) * mn[b],
//        both exact in f32 (an 8-bit mantissa times 6 bits). A kernel
//        reads it through at(), or copies its own layout of the bytes
//        (K % 4096 == 0: K / 32 is a multiple of 128).
// QB is the payload bytes of one block: 16 (planar nibbles, byte j holds
// element j low and element j + 16 high) or 32 (the int8 values).
// q * scale is exact in f32 (4 or 8 bits times an 8- or 11-bit mantissa),
// and so is q * scale - min for Q4_0 (the exact difference is (q - 8) d).
//
// For the GEMM (q4k_gemm.cu), which copies the raw scale arrays into shared
// memory: NARR scale arrays (arr(j)), scale_min() from their raw 16-bit
// words, and the unsigned code of a payload byte: byte ^ QXOR, which as the
// low byte of the float 2^23 + code gives q = float - QOFF exactly.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

struct Q4K {
  static constexpr int QB = 16;
  static constexpr bool S6 = false;
  const bf16* es;
  const bf16* em;
  __device__ __forceinline__ float scale(size_t i) const {
    return __bfloat162float(es[i]);
  }
  __device__ __forceinline__ float min(size_t i) const {
    return __bfloat162float(em[i]);
  }
  static constexpr int NARR = 2;
  static constexpr uint32_t QXOR = 0u;
  static constexpr float QOFF = 8388608.f;
  __host__ __device__ const void* arr(int j) const {
    return j ? static_cast<const void*>(em) : static_cast<const void*>(es);
  }
  __device__ static void scale_min(uint16_t a, uint16_t b, float& s,
                                   float& m) {
    s = __uint_as_float((uint32_t)a << 16);
    m = __uint_as_float((uint32_t)b << 16);
  }
};

struct Q40 {
  static constexpr int QB = 16;
  static constexpr bool S6 = false;
  const __half* d;
  __device__ __forceinline__ float scale(size_t i) const {
    return __half2float(d[i]);
  }
  __device__ __forceinline__ float min(size_t i) const {
    return 8.f * scale(i);
  }
  static constexpr int NARR = 1;
  static constexpr uint32_t QXOR = 0u;
  static constexpr float QOFF = 8388608.f;
  __host__ __device__ const void* arr(int) const { return d; }
  __device__ static void scale_min(uint16_t a, uint16_t, float& s,
                                   float& m) {
    s = __half2float(__ushort_as_half(a));
    m = 8.f * s;
  }
};

struct Q80 {
  static constexpr int QB = 32;
  static constexpr bool S6 = false;
  const __half* d;
  __device__ __forceinline__ float scale(size_t i) const {
    return __half2float(d[i]);
  }
  __device__ __forceinline__ float min(size_t) const { return 0.f; }
  static constexpr int NARR = 1;
  static constexpr uint32_t QXOR = 0x80808080u;   // int8 q -> q + 128
  static constexpr float QOFF = 8388608.f + 128.f;
  __host__ __device__ const void* arr(int) const { return d; }
  __device__ static void scale_min(uint16_t a, uint16_t, float& s,
                                   float& m) {
    s = __half2float(__ushort_as_half(a));
    m = 0.f;
  }
};

struct Q4KS6 {
  static constexpr int QB = 16;
  static constexpr bool S6 = true;
  static constexpr int NARR = 1;        // one row of sc | mn | d | dmin
  static constexpr uint32_t QXOR = 0u;
  static constexpr float QOFF = 8388608.f;
  const int8_t* sm;
  const bf16* dd;
  // scale and min of block b of row n, kb blocks a row
  __device__ __forceinline__ void at(size_t n, int b, int kb, float& s,
                                     float& m) const {
    const int8_t* r = sm + n * 2 * (size_t)kb;
    const bf16* q = dd + n * (size_t)(kb / 4);
    s = __bfloat162float(q[b >> 3]) * (float)r[b];
    m = __bfloat162float(q[kb / 8 + (b >> 3)]) * (float)r[kb + b];
  }
  // the same from a row's bytes copied into shared memory: sc, mn at
  // blocks j of the copy, d, dmin its superblocks' bf16 words
  __device__ __forceinline__ static void from(int8_t sc, int8_t mn,
                                              uint16_t d, uint16_t dmin,
                                              float& s, float& m) {
    s = __uint_as_float((uint32_t)d << 16) * (float)sc;
    m = __uint_as_float((uint32_t)dmin << 16) * (float)mn;
  }
};

// The CTAs of a kernel resident on one SM at a dynamic shared-memory size,
// and the SM count: queried once per size and kept in *c (a model that
// alternates K, as tinyllama's 2048 / 5632 linears do, pays the host query
// once per K and never again).
struct GridCap {
  static constexpr int SLOTS = 8;
  int granted = 0, sms = 0, used = 0;
  int smem[SLOTS] = {}, per_sm[SLOTS] = {};
};

template <typename Kernel>
static cudaError_t resident_ctas(Kernel kernel, int threads, int smem,
                                 GridCap* c, int* per_sm) {
  cudaError_t e = allow_smem(kernel, smem, &c->granted);
  if (e != cudaSuccess) return e;
  const int n = c->used < GridCap::SLOTS ? c->used : GridCap::SLOTS;
  for (int i = 0; i < n; ++i)
    if (c->smem[i] == smem) {
      *per_sm = c->per_sm[i];
      return cudaSuccess;
    }
  int dev = 0, got = 0;
  if (c->sms == 0) {
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &got, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (got < 1) return cudaErrorInvalidConfiguration;
  const int slot = c->used++ % GridCap::SLOTS;
  c->smem[slot] = smem;
  c->per_sm[slot] = got;
  *per_sm = got;
  return cudaSuccess;
}

// The grid of a matvec that walks its rows over every warp of the grid:
// N / (rows per CTA) CTAs, capped at the CTAs that are resident.
template <typename Kernel>
static cudaError_t grid_for(Kernel kernel, int threads, int smem, int N,
                            GridCap* c, int* grid) {
  int per_sm = 0;
  cudaError_t e = resident_ctas(kernel, threads, smem, c, &per_sm);
  if (e != cudaSuccess) return e;
  const int rows = threads / 32;
  *grid = (N + rows - 1) / rows;
  if (*grid > per_sm * c->sms) *grid = per_sm * c->sms;
  return cudaSuccess;
}
