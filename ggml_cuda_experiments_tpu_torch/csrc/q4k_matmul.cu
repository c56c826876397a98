// Q4_K-E and Q4_0 fused dequant matvec for Hopper (sm_90a).
//
// Weights (logical column order, oracle/quant.py packing): the 4-bit
// formats' qs uint8 [N, K/2], where byte j of each 32-block holds element j
// (low nibble) and element j + 16 (high nibble); Q8_0's qs int8 [N, K]; and
// each format's scale arrays, read through its trait (quant_formats.cuh):
// w = q * scale - min per 32-block, with (scale, min) = (es, em) bf16 for
// Q4_K-E, (d, 8 d) fp16 for Q4_0 and (d, 0) for Q8_0.
//
// q4k_matvec / q40_matvec (one template, two instances) replace
// ops/quant_matmul.py::_chunk_kernel (and ::_vpu2_kernel, and at K/32
// outside its repeat-aligned counts ::_vpu_e_kernel) of the JAX package:
// B = 1, exact f32 activations.
//   Bound on the H100: bytes. A 4096 x 4096 weight is 10.5 MB of payload and
//   scales against ~16 KB of x. Design: one warp per row (two rows in turn),
//   each lane streams one 32-block (16 bytes) per load, so a warp reads 512
//   contiguous bytes per step. x sits in shared memory padded to 36 floats
//   per block so that the lanes' float4 reads hit distinct banks, next to
//   the per-block sums of x. The row is sum_b es_b * dot_b - em_b * xsum_b,
//   with each block dot in f32 (the JAX kernel's exact fold).
//
//   The row is sum_b scale_b * dot_b - min_b * xsum_b: for Q4_0,
//   d_b * dot_b - 8 d_b * xsum_b, the JAX kernel's es = d, em = 8 d.
//
// The GEMMs of the same formats (q4k_gemm / q40_gemm / q80_gemm) are in
// q4k_gemm.cu.
#include "quant_formats.cuh"

// ---------------------------------------------------------------- matvec

constexpr int MV_WARPS = 8;
constexpr int MV_ROWS_PER_WARP = 2;
constexpr int MV_ROWS = MV_WARPS * MV_ROWS_PER_WARP;
constexpr int MV_XPAD = 36;   // floats per 32-block of x in shared memory

template <class F>
__global__ void __launch_bounds__(MV_WARPS * 32)
q4_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                 const F f, float* __restrict__ y, int N, int K) {
  static_assert(F::QB == 16, "a 4-bit format");
  extern __shared__ __align__(16) float mv_smem[];
  const int KB = K / 32;
  float* xs = mv_smem;                  // [KB][MV_XPAD]
  float* xsum = mv_smem + KB * MV_XPAD; // [KB]
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xs[(i >> 5) * MV_XPAD + (i & 31)] = x[i];
  __syncthreads();
  for (int b = threadIdx.x; b < KB; b += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += xs[b * MV_XPAD + j];
    xsum[b] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * MV_WARPS + warp) * MV_ROWS_PER_WARP;
  for (int r = 0; r < MV_ROWS_PER_WARP; ++r) {
    const int n = row0 + r;
    if (n >= N) break;                  // uniform across the warp
    const uint4* qrow =
        reinterpret_cast<const uint4*>(qs + (size_t)n * (K / 2));
    const size_t i0 = (size_t)n * KB;
    float acc = 0.f;
    for (int b = lane; b < KB; b += 32) {
      const uint4 p = __ldg(qrow + b);
      const uint32_t w[4] = {p.x, p.y, p.z, p.w};
      const float* xb = xs + b * MV_XPAD;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 xl = *reinterpret_cast<const float4*>(xb + 4 * t);
        const float4 xh = *reinterpret_cast<const float4*>(xb + 16 + 4 * t);
        const uint32_t v = w[t];
        dot += (float)(v & 0xF) * xl.x + (float)((v >> 4) & 0xF) * xh.x;
        dot += (float)((v >> 8) & 0xF) * xl.y + (float)((v >> 12) & 0xF) * xh.y;
        dot += (float)((v >> 16) & 0xF) * xl.z + (float)((v >> 20) & 0xF) * xh.z;
        dot += (float)((v >> 24) & 0xF) * xl.w + (float)(v >> 28) * xh.w;
      }
      acc += f.scale(i0 + b) * dot - f.min(i0 + b) * xsum[b];
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

template <class F>
static int q4_matvec(const float* x, const uint8_t* qs, F f, float* y, int N,
                     int K, void* stream) {
  static int granted = 0;
  const int KB = K / 32;
  const int smem = (KB * MV_XPAD + KB) * (int)sizeof(float);
  cudaError_t e = allow_smem(q4_matvec_kernel<F>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + MV_ROWS - 1) / MV_ROWS);
  q4_matvec_kernel<F><<<grid, MV_WARPS * 32, smem, (cudaStream_t)stream>>>(
      x, qs, f, y, N, K);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q4k_matvec(const float* x, const uint8_t* qs, const bf16* es,
                          const bf16* em, float* y, int N, int K,
                          void* stream) {
  return q4_matvec(x, qs, Q4K{es, em}, y, N, K, stream);
}

GCT_EXPORT int q40_matvec(const float* x, const uint8_t* qs, const __half* d,
                          float* y, int N, int K, void* stream) {
  return q4_matvec(x, qs, Q40{d}, y, N, K, stream);
}

GCT_EXPORT const char* kernels_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
