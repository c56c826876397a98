// Q4_K-E matvec with int8 activations (B = 1) for Hopper (sm_90a).
//
// Replaces ops/quant_matmul.py::_chunk8_kernel (with _chunk8_compute) of
// the JAX package: the x_quant8 decode matvec, for (K/32) % 128 == 0.
// Numerics: q8_common.cuh (the JAX package's, to the f32 fold order).
//
// Bound on the H100: bytes. The weight is 0.625 bytes per element (4-bit
// payload plus bf16 es / em per 32 elements): the 7B lm_head [32000, 4096]
// is 81.9 MB, 24.5 us at 3.35 TB/s, against 16 KB of x. Design: one warp
// per row at a time, each lane one 16-byte load per 32-block (a warp reads
// 512 contiguous bytes per load), four blocks in flight per lane; the
// block dot is eight __dp4a on the raw bytes (no nibble unpack beyond one
// AND and one XOR per word), so the integer work stays far below the byte
// time. Each CTA quantizes x into shared memory itself (the grid is capped
// at what is resident, so that costs a few hundred 16 KB reads of L2).
#include "q8_common.cuh"

__global__ void __launch_bounds__(Q8_THREADS, 2)
q4k_q8_matvec_kernel(const float* x, const uint8_t* __restrict__ qs,
                     const bf16* __restrict__ es, const bf16* __restrict__ em,
                     float* __restrict__ y, int N, int K) {
  extern __shared__ __align__(16) unsigned char q8_smem[];
  const Q8Act a = q8_act_at(q8_smem, K / 32);
  q8_quant(GlobalVec{x}, a);
  q8_rows(qs, es, em, N, a, [&](int n, float v) { y[n] = v; });
}

GCT_EXPORT int q4k_q8_matvec(const float* x, const uint8_t* qs, const bf16* es,
                             const bf16* em, float* y, int N, int K,
                             void* stream) {
  static int granted = 0, sms = 0, per_sm = 0, for_smem = -1;
  const int smem = q8_act_bytes(K / 32);
  cudaError_t e = allow_smem(q4k_q8_matvec_kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (for_smem != smem) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, q4k_q8_matvec_kernel, Q8_THREADS, smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    for_smem = smem;
  }
  int grid = (N + Q8_WARPS - 1) / Q8_WARPS;
  if (grid > per_sm * sms) grid = per_sm * sms;
  q4k_q8_matvec_kernel<<<grid, Q8_THREADS, smem, (cudaStream_t)stream>>>(
      x, qs, es, em, y, N, K);
  return (int)cudaGetLastError();
}
