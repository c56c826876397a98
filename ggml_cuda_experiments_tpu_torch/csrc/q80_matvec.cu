// Q8_0 matvec (B = 1) for Hopper (sm_90a).
//
// Weights (logical column order, ops/quant_matmul.py): qs int8 [N, K], d
// fp16 [N, K/32], w = q * d per 32-block.
//
// q80_matvec replaces ops/quant_matmul.py::_mxu_kernel of the JAX package
// for q8_0 at B = 1 (its route at every repeat-aligned K/32: all of
// llama2-7b's linears and tinyllama's K = 2048 ones) and reproduces its
// rounding: y_n = sum_j bf16(x_j) * bf16(q_j * d_b) with f32 accumulation
// (q * d is exact in f32, and so is the product of two bf16 values; only the
// order of the f32 sum differs). It also takes ::_vpu_e_kernel's q8_0 route
// (K/32 outside the repeat-aligned counts, tinyllama's w_down at K = 5632),
// which rounds bf16(q_j * x_j) instead: there the two agree to the bf16
// class of error (the JAX test's 2e-2 * max).
//
// Bound on the H100: bytes. A row is 1.0625 K bytes: the 7B w_gu
// [24576, 4096] is 107.0 MB (31.9 us at 3.35 TB/s), the head [32000, 4096]
// 139.3 MB, against 16 KB of x. Design, as q6k_matvec (q6k_matvec.cu): the
// grid is capped at what is resident and every CTA stages bf16(x) once (as
// f32, 36 floats per 32-block so that the lanes' float4 reads miss each
// other's banks); then one warp per row at a time, each lane one 32-block
// (two 16-byte loads; a warp reads 1 KB contiguous) with two blocks in
// flight. Per element the ALU work is a byte permute and a subtract (int8 to
// float through the exponent bits, 0x4B000000 | (byte ^ 0x80) being
// 2^23 + 128 + q), the multiply by d, half of a packed f32x2 -> bf16x2
// conversion, a shift or mask back to f32 and a fused multiply-add.
#include "quant_formats.cuh"

constexpr int Q80_THREADS = 512;
constexpr int Q80_XPAD = 36;          // floats per 32 elements of x in smem

// byte SEL of v (already XOR 0x80) as the signed value it encodes
template <int SEL>
__device__ __forceinline__ float sbyte_f(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | SEL)) -
         8388736.f;                                   // 2^23 + 128
}

// bf16(a), bf16(b) (round to nearest even) back as floats
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}

// acc + sum over the 4 int8 values of word v of bf16(q * s) * x
__device__ __forceinline__ float dot4(uint32_t v, float s, const float4& x,
                                      float acc) {
  v ^= 0x80808080u;
  const float2 w01 = bf16_round2(sbyte_f<0>(v) * s, sbyte_f<1>(v) * s);
  const float2 w23 = bf16_round2(sbyte_f<2>(v) * s, sbyte_f<3>(v) * s);
  acc = fmaf(w01.x, x.x, acc);
  acc = fmaf(w01.y, x.y, acc);
  acc = fmaf(w23.x, x.z, acc);
  return fmaf(w23.y, x.w, acc);
}

// one 32-block: payload words lo (elements 0-15) and hi (16-31)
__device__ __forceinline__ float block_dot(const uint4& lo, const uint4& hi,
                                           float s, const float* xb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  float z = dot4(lo.x, s, x4[0], 0.f);
  z = dot4(lo.y, s, x4[1], z);
  z = dot4(lo.z, s, x4[2], z);
  z = dot4(lo.w, s, x4[3], z);
  z = dot4(hi.x, s, x4[4], z);
  z = dot4(hi.y, s, x4[5], z);
  z = dot4(hi.z, s, x4[6], z);
  return dot4(hi.w, s, x4[7], z);
}

__global__ void __launch_bounds__(Q80_THREADS, 2)
q80_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                  const __half* __restrict__ d, float* __restrict__ y, int N,
                  int K) {
  extern __shared__ __align__(16) float q80_smem[];   // [K/32][Q80_XPAD]
  const int KB = K / 32;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    q80_smem[(i >> 5) * Q80_XPAD + (i & 31)] =
        __bfloat162float(__float2bfloat16(x[i]));
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int n = blockIdx.x * warps + (threadIdx.x >> 5); n < N;
       n += gridDim.x * warps) {
    const uint4* q = reinterpret_cast<const uint4*>(qs + (size_t)n * K);
    const __half* dr = d + (size_t)n * KB;
    float acc = 0.f;
    int b = lane;
    for (; b + 32 < KB; b += 64) {       // two blocks in flight per lane
      const uint4 l0 = __ldg(q + 2 * b), h0 = __ldg(q + 2 * b + 1);
      const uint4 l1 = __ldg(q + 2 * b + 64), h1 = __ldg(q + 2 * b + 65);
      const float s0 = __half2float(dr[b]), s1 = __half2float(dr[b + 32]);
      acc += block_dot(l0, h0, s0, q80_smem + b * Q80_XPAD);
      acc += block_dot(l1, h1, s1, q80_smem + (b + 32) * Q80_XPAD);
    }
    if (b < KB)
      acc += block_dot(__ldg(q + 2 * b), __ldg(q + 2 * b + 1),
                       __half2float(dr[b]), q80_smem + b * Q80_XPAD);
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

GCT_EXPORT int q80_matvec(const float* x, const uint8_t* qs, const __half* d,
                          float* y, int N, int K, void* stream) {
  static GridCap cap;
  if (K % 32 || N < 1) return (int)cudaErrorInvalidValue;
  const int smem = K / 32 * Q80_XPAD * (int)sizeof(float);
  int grid = 0;
  cudaError_t e = grid_for(q80_matvec_kernel, Q80_THREADS, smem, N, &cap,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  q80_matvec_kernel<<<grid, Q80_THREADS, smem, (cudaStream_t)stream>>>(
      x, qs, d, y, N, K);
  return (int)cudaGetLastError();
}

// registers, shared memory and occupancy at this K (kernel_info)
GCT_EXPORT int q80_matvec_info(int K, int* out) {
  return kernel_info(q80_matvec_kernel, Q80_THREADS,
                     K / 32 * Q80_XPAD * (int)sizeof(float), out);
}
