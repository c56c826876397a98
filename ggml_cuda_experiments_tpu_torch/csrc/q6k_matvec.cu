// Q6_K-E matvecs (B = 1) for Hopper (sm_90a): the head of the Q4_K_M mix.
//
// Weights (logical column order, ops/quant_matmul.py): per 16-element block
// b, qs bytes 8b..8b+7 (byte j: the low 4 bits of element j, those of
// element j + 8 in the high nibble), qh bytes 4b..4b+3 (byte i: the high 2
// bits of elements i, i + 4, i + 8, i + 12 at bits 0-1, 2-3, 4-5, 6-7) and
// es[b] bf16. Dequantization: w = f32(es) * (q - 32), q in 0..63.
//
// q6k_matvec replaces ops/quant_matmul.py::_chunk6_kernel of the JAX package
//   (B = 1, (K/16) % 128 == 0: tinyllama's head, 32000 x 2048): exact f32
//   activations, y_n = sum_b es_b * sum_j x_j (q_j - 32), folded in f32.
// q6k_q8_matvec replaces ::_chunk6h_kernel (B = 1, K % 4096 == 0: the
//   llama2-7b head, 32000 x 4096) and reproduces its numerics. Per 16-block
//   and j < 8, with xl = x[16b + j] and xh = x[16b + j + 8]: a = xl - xh/16
//   and b = xh/16 are quantized to int8 with scale amax/127 over the block's
//   8 values (1 where amax is 0; IEEE division, round half to even, clip
//   +-127); z1 = sum lo * aq and z2 = sum p * bq are exact integer dots
//   (__dp4a; lo the low nibbles, p = the byte XOR 0x80 as int8 =
//   lo + 16 hi - 128); cc = 8 sum(xh) - 32 sum(xl + xh); zbit = sum h x over
//   the block's 16 elements (h the high 2 bits) in f32; and
//   y = sum_b es_b (sa z1 + sb z2 + cc + 16 zbit).
//
// Bound on the H100: bytes. A row is 0.875 K bytes: the 7B head is 114.7 MB
// (34.2 us at 3.35 TB/s), tinyllama's 57.3 MB (17.1 us), against 16 KB of x.
// Design, as q4k_q8_matvec (q4k_q8.cu): the grid is capped at what is
// resident, and every CTA first builds the activation operands in its own
// shared memory (for the hybrid, an 8-lane group per 16-block with shuffles
// for its max and sums), x padded to 36 floats per 32 elements so that the
// lanes' float4 reads miss each other's banks. Then one warp per row at a
// time: a lane takes a 32-element group (two blocks) per step, 16 bytes of
// qs, 8 of qh and 4 of es, with 2 (exact) or 4 (hybrid) groups in flight.
// The 6-bit values (or the 2-bit ones) are assembled four at a time with
// 32-bit masks; a byte becomes a float through the exponent bits
// (0x4B000000 | byte is 2^23 + byte), so an element costs a byte permute,
// an add and a fused multiply-add.
#include "quant_formats.cuh"

constexpr int Q6_THREADS = 512;
constexpr int Q6_WARPS = Q6_THREADS / 32;
constexpr int Q6_XPAD = 36;           // floats per 32 elements of x in smem

// byte `sel` of v as a float, less `off` (exact: both are below 2^24)
template <int SEL>
__device__ __forceinline__ float byte_f(uint32_t v, float off) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | SEL)) -
         (8388608.f + off);
}

// acc + sum_i (byte_i(v) - off) * x_i over the four bytes of v
__device__ __forceinline__ float dot4(uint32_t v, float off, const float4& x,
                                      float acc) {
  acc = fmaf(byte_f<0>(v, off), x.x, acc);
  acc = fmaf(byte_f<1>(v, off), x.y, acc);
  acc = fmaf(byte_f<2>(v, off), x.z, acc);
  return fmaf(byte_f<3>(v, off), x.w, acc);
}

// The high 2 bits of a block's elements 4s .. 4s + 3, one per byte.
template <int S>
__device__ __forceinline__ uint32_t high2(uint32_t h) {
  return (h >> (2 * S)) & 0x03030303u;
}

// sum_j x_j (q_j - 32) over one 16-block: qs words w0 (elements 0-3 | 8-11)
// and w1 (4-7 | 12-15), qh word h, x the block's 16 floats
__device__ __forceinline__ float block_dot(uint32_t w0, uint32_t w1,
                                           uint32_t h, const float* xb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  float z = dot4((w0 & 0x0F0F0F0Fu) | (high2<0>(h) << 4), 32.f, x4[0], 0.f);
  z = dot4((w1 & 0x0F0F0F0Fu) | (high2<1>(h) << 4), 32.f, x4[1], z);
  z = dot4(((w0 >> 4) & 0x0F0F0F0Fu) | (high2<2>(h) << 4), 32.f, x4[2], z);
  return dot4(((w1 >> 4) & 0x0F0F0F0Fu) | (high2<3>(h) << 4), 32.f, x4[3],
              z);
}

// zbit = sum_j h_j x_j over one 16-block in f32
__device__ __forceinline__ float block_bits(uint32_t h, const float* xb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  float z = dot4(high2<0>(h), 0.f, x4[0], 0.f);
  z = dot4(high2<1>(h), 0.f, x4[1], z);
  z = dot4(high2<2>(h), 0.f, x4[2], z);
  return dot4(high2<3>(h), 0.f, x4[3], z);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// x [K] into shared memory, 36 floats per 32 elements
__device__ __forceinline__ void stage_x(const float* x, float* xs, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xs[(i >> 5) * Q6_XPAD + (i & 31)] = x[i];
}

// max / sum over the 8 lanes of a group (all four groups of a warp at once)
__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int q8_round(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// One row's sum over its G = K/32 groups, U groups in flight per lane
// (G % (32 U) == 0); block(g, w, h, e) returns the group's two-block sum.
template <int U, class Block>
__device__ __forceinline__ float q6_row(const uint8_t* qs, const uint8_t* qh,
                                        const bf16* es, size_t n, int K,
                                        int lane, const Block& block) {
  const int G = K / 32;
  const uint4* q = reinterpret_cast<const uint4*>(qs + n * (size_t)(K / 2));
  const uint2* hq = reinterpret_cast<const uint2*>(qh + n * (size_t)(K / 4));
  const uint32_t* e =
      reinterpret_cast<const uint32_t*>(es + n * (size_t)(K / 16));
  float acc = 0.f;
  for (int g0 = lane; g0 < G; g0 += 32 * U) {
    uint4 w[U];
    uint2 h[U];
    uint32_t s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = __ldg(q + g0 + 32 * u);
      h[u] = __ldg(hq + g0 + 32 * u);
      s[u] = __ldg(e + g0 + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += block(g0 + 32 * u, w[u], h[u], s[u]);
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(Q6_THREADS, 2)
q6k_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ qh, const bf16* __restrict__ es,
                  float* __restrict__ y, int N, int K) {
  extern __shared__ __align__(16) float q6_smem[];
  float* xs = q6_smem;                           // [K/32][Q6_XPAD]
  stage_x(x, xs, K);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const auto block = [&](int g, const uint4& w, const uint2& h, uint32_t s) {
    const float* xb = xs + g * Q6_XPAD;
    return bf16_lo(s) * block_dot(w.x, w.y, h.x, xb) +
           bf16_hi(s) * block_dot(w.z, w.w, h.y, xb + 16);
  };
  for (int n = blockIdx.x * Q6_WARPS + (threadIdx.x >> 5); n < N;
       n += gridDim.x * Q6_WARPS) {
    const float v = q6_row<2>(qs, qh, es, (size_t)n, K, lane, block);
    if (lane == 0) y[n] = v;
  }
}

// Shared memory of the hybrid: x padded, then aq, bq [K/16][8] int8, then
// sa, sb, cc [K/16] f32.
__host__ __device__ constexpr int q6h_smem_bytes(int K) {
  return K / 32 * Q6_XPAD * 4 + K + 3 * (K / 16) * 4;
}

__global__ void __launch_bounds__(Q6_THREADS, 2)
q6k_q8_matvec_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ qs,
                     const uint8_t* __restrict__ qh,
                     const bf16* __restrict__ es, float* __restrict__ y,
                     int N, int K) {
  extern __shared__ __align__(16) float q6_smem[];
  const int NB = K / 16;
  float* xs = q6_smem;                                    // [K/32][36]
  int8_t* aq = reinterpret_cast<int8_t*>(xs + K / 32 * Q6_XPAD);
  int8_t* bq = aq + K / 2;
  float* sa = reinterpret_cast<float*>(bq + K / 2);
  float* sb = sa + NB;
  float* cc = sb + NB;
  stage_x(x, xs, K);
  // the operands: an 8-lane group per block, a lane per nibble pair (j, j +
  // 8); NB is a multiple of blockDim.x / 8, so whole warps take the loop
  const int t = threadIdx.x & 7;
  for (int b = threadIdx.x >> 3; b < NB; b += blockDim.x >> 3) {
    const float xl = __ldg(x + 16 * b + t), xh = __ldg(x + 16 * b + 8 + t);
    const float bv = __fdiv_rn(xh, 16.f);              // exact
    const float av = __fsub_rn(xl, bv);
    const float ma = group8_max(fabsf(av)), mb = group8_max(fabsf(bv));
    const float sxh = group8_sum(xh), sx = group8_sum(__fadd_rn(xl, xh));
    const float s_a = ma == 0.f ? 1.f : __fdiv_rn(ma, 127.f);
    const float s_b = mb == 0.f ? 1.f : __fdiv_rn(mb, 127.f);
    aq[8 * b + t] = (int8_t)q8_round(av, s_a);
    bq[8 * b + t] = (int8_t)q8_round(bv, s_b);
    if (t == 0) {
      sa[b] = s_a;
      sb[b] = s_b;
      cc[b] = __fsub_rn(__fmul_rn(8.f, sxh), __fmul_rn(32.f, sx));
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // one 16-block: qs words w0, w1, qh word h, block index b
  const auto one = [&](uint32_t w0, uint32_t w1, uint32_t h, int b,
                       const float* xb, int2 a8, int2 b8) {
    int z1 = __dp4a((int)(w0 & 0x0F0F0F0Fu), a8.x, 0);
    z1 = __dp4a((int)(w1 & 0x0F0F0F0Fu), a8.y, z1);
    int z2 = __dp4a((int)(w0 ^ 0x80808080u), b8.x, 0);
    z2 = __dp4a((int)(w1 ^ 0x80808080u), b8.y, z2);
    return sa[b] * (float)z1 + sb[b] * (float)z2 + cc[b] +
           16.f * block_bits(h, xb);
  };
  const auto block = [&](int g, const uint4& w, const uint2& h, uint32_t s) {
    const int4 a16 = *reinterpret_cast<const int4*>(aq + 16 * g);
    const int4 b16 = *reinterpret_cast<const int4*>(bq + 16 * g);
    const float* xb = xs + g * Q6_XPAD;
    return bf16_lo(s) * one(w.x, w.y, h.x, 2 * g, xb, make_int2(a16.x, a16.y),
                            make_int2(b16.x, b16.y)) +
           bf16_hi(s) * one(w.z, w.w, h.y, 2 * g + 1, xb + 16,
                            make_int2(a16.z, a16.w), make_int2(b16.z, b16.w));
  };
  for (int n = blockIdx.x * Q6_WARPS + (threadIdx.x >> 5); n < N;
       n += gridDim.x * Q6_WARPS) {
    const float v = q6_row<4>(qs, qh, es, (size_t)n, K, lane, block);
    if (lane == 0) y[n] = v;
  }
}

GCT_EXPORT int q6k_matvec(const float* x, const uint8_t* qs, const uint8_t* qh,
                          const bf16* es, float* y, int N, int K,
                          void* stream) {
  static GridCap cap;
  if (K % 2048 || N < 1) return (int)cudaErrorInvalidValue;
  const int smem = K / 32 * Q6_XPAD * (int)sizeof(float);
  int grid = 0;
  cudaError_t e = grid_for(q6k_matvec_kernel, Q6_THREADS, smem, N, &cap,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  q6k_matvec_kernel<<<grid, Q6_THREADS, smem, (cudaStream_t)stream>>>(
      x, qs, qh, es, y, N, K);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q6k_q8_matvec(const float* x, const uint8_t* qs,
                             const uint8_t* qh, const bf16* es, float* y,
                             int N, int K, void* stream) {
  static GridCap cap;
  if (K % 4096 || N < 1) return (int)cudaErrorInvalidValue;
  const int smem = q6h_smem_bytes(K);
  int grid = 0;
  cudaError_t e = grid_for(q6k_q8_matvec_kernel, Q6_THREADS, smem, N, &cap,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  q6k_q8_matvec_kernel<<<grid, Q6_THREADS, smem, (cudaStream_t)stream>>>(
      x, qs, qh, es, y, N, K);
  return (int)cudaGetLastError();
}
