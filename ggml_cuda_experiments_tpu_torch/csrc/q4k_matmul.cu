// Q4_K-E fused dequant matvec and GEMM for Hopper (sm_90a).
//
// Weights (logical column order, oracle/quant.py packing): qs uint8 [N, K/2]
// where byte j of each 32-block holds element j (low nibble) and element
// j + 16 (high nibble); es, em bf16 [N, K/32] effective per-block scale and
// min. Dequantization: w = q * f32(es) - f32(em).
//
// q4k_matvec replaces ops/quant_matmul.py::_chunk_kernel (and
// ::_vpu2_kernel) of the JAX package: B = 1, exact f32 activations.
//   Bound on the H100: bytes. A 4096 x 4096 weight is 10.5 MB of payload and
//   scales against ~16 KB of x. Design: one warp per row (two rows in turn),
//   each lane streams one 32-block (16 bytes) per load, so a warp reads 512
//   contiguous bytes per step. x sits in shared memory padded to 36 floats
//   per block so that the lanes' float4 reads hit distinct banks, next to
//   the per-block sums of x. The row is sum_b es_b * dot_b - em_b * xsum_b,
//   with each block dot in f32 (the JAX kernel's exact fold).
//
// q4k_gemm replaces ::_mxu_kernel, ::_pipe_sub_kernel and ::_pipe_kernel:
//   y[M, N] = bf16(x) . bf16(deq(W))^T with f32 accumulation, M >= 2.
//   Bound: bytes at small M, the tensor cores at M = 512. Design: 64 x 64
//   output tiles, 4 warps of 32 x 32 WMMA bf16 m16n16k16 products; each
//   64-wide K step dequantizes its W tile in f32, rounds it to bf16 into
//   shared memory, and multiplies. Ragged M and N are masked.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

// ---------------------------------------------------------------- matvec

constexpr int MV_WARPS = 8;
constexpr int MV_ROWS_PER_WARP = 2;
constexpr int MV_ROWS = MV_WARPS * MV_ROWS_PER_WARP;
constexpr int MV_XPAD = 36;   // floats per 32-block of x in shared memory

__global__ void __launch_bounds__(MV_WARPS * 32)
q4k_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                  const bf16* __restrict__ es, const bf16* __restrict__ em,
                  float* __restrict__ y, int N, int K) {
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
    const bf16* esr = es + (size_t)n * KB;
    const bf16* emr = em + (size_t)n * KB;
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
      acc += __bfloat162float(esr[b]) * dot - __bfloat162float(emr[b]) * xsum[b];
    }
    acc = warp_sum(acc);
    if (lane == 0) y[n] = acc;
  }
}

GCT_EXPORT int q4k_matvec(const float* x, const uint8_t* qs, const bf16* es,
                          const bf16* em, float* y, int N, int K,
                          void* stream) {
  static int granted = 0;
  const int KB = K / 32;
  const int smem = (KB * MV_XPAD + KB) * (int)sizeof(float);
  cudaError_t e = allow_smem(q4k_matvec_kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + MV_ROWS - 1) / MV_ROWS);
  q4k_matvec_kernel<<<grid, MV_WARPS * 32, smem, (cudaStream_t)stream>>>(
      x, qs, es, em, y, N, K);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ GEMM

constexpr int GM = 64, GN = 64, GK = 64, GPAD = 8;

__global__ void __launch_bounds__(128)
q4k_gemm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ qs,
                const bf16* __restrict__ es, const bf16* __restrict__ em,
                float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[GM][GK + GPAD];
  __shared__ __align__(128) bf16 Bs[GN][GK + GPAD];
  __shared__ __align__(128) float Cs[GM][GN + 4];
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 2 x 2 warps of 32 x 32
  const int KB = K / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    // activations: 64 rows x 64 bf16, 16 bytes per load, ragged M zeroed
    for (int i = tid; i < GM * GK / 8; i += 128) {
      const int r = i / (GK / 8), c = (i % (GK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // weights: thread -> (row, 32-block), dequantized in f32, stored bf16
    {
      const int r = tid >> 1, blk = tid & 1;
      const int n = n0 + r, b = k0 / 32 + blk;
      bf16* dst = &Bs[r][blk * 32];
      if (n < N) {
        const uint4 p = *reinterpret_cast<const uint4*>(
            qs + (size_t)n * (K / 2) + (size_t)b * 16);
        const uint32_t w[4] = {p.x, p.y, p.z, p.w};
        const float s = __bfloat162float(es[(size_t)n * KB + b]);
        const float mn = __bfloat162float(em[(size_t)n * KB + b]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t byte = (w[t] >> (8 * i)) & 0xFFu;
            dst[4 * t + i] = __float2bfloat16(
                __fsub_rn(__fmul_rn((float)(byte & 0xF), s), mn));
            dst[16 + 4 * t + i] = __float2bfloat16(
                __fsub_rn(__fmul_rn((float)(byte >> 4), s), mn));
          }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) dst[i] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], GK + GPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], &Bs[wn * 32 + j * 16][kk], GK + GPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], GN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < GM * GN; i += 128) {
    const int r = i / GN, c = i % GN;
    if (m0 + r < M && n0 + c < N)
      y[(size_t)(m0 + r) * N + n0 + c] = Cs[r][c];
  }
}

GCT_EXPORT int q4k_gemm(const bf16* x, const uint8_t* qs, const bf16* es,
                        const bf16* em, float* y, int M, int N, int K,
                        void* stream) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  q4k_gemm_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(x, qs, es, em, y,
                                                          M, N, K);
  return (int)cudaGetLastError();
}

GCT_EXPORT const char* kernels_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
