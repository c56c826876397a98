// Q4_K-E and Q4_0 matvecs with int8 activations (B = 1) for Hopper (sm_90a).
//
// q4k_q8_matvec / q40_q8_matvec (one template, two instances) replace
// ops/quant_matmul.py::_chunk8_kernel (with _chunk8_compute) of the JAX
// package: the x_quant8 decode matvec, for (K/32) % 128 == 0. Numerics:
// q8_common.cuh (the JAX package's, to the f32 fold order; for Q4_0 its
// es = d, em = 8 d).
//
// Bound on the H100: bytes. The weight is 0.625 bytes per element (4-bit
// payload plus bf16 es / em per 32 elements): the 7B lm_head [32000, 4096]
// is 81.9 MB, 24.5 us at 3.35 TB/s, against 16 KB of x (Q4_0: 0.5625
// bytes per element, 73.7 MB, 22.0 us). Design: one warp
// per row at a time, each lane one 16-byte load per 32-block (a warp reads
// 512 contiguous bytes per load), four blocks in flight per lane; the
// block dot is eight __dp4a on the raw bytes (no nibble unpack beyond one
// AND and one XOR per word), so the integer work stays far below the byte
// time. Each CTA quantizes x into shared memory itself (the grid is capped
// at what is resident, so that costs a few hundred 16 KB reads of L2).
// q4k_s6_q8_matvec is the Q4_K "s6" instance (quant_formats.cuh: 0.578125
// bytes per element, the lm_head 75.8 MB, 22.6 us): a lane reads its
// block's sc and mn bytes and its superblock's bf16 d and dmin where the
// Q4_K-E instance reads its bf16 es and em.
#include "q8_common.cuh"

template <class F>
__global__ void __launch_bounds__(Q8_THREADS, 2)
q4_q8_matvec_kernel(const float* x, const uint8_t* __restrict__ qs, const F f,
                    float* __restrict__ y, int N, int K) {
  extern __shared__ __align__(16) unsigned char q8_smem[];
  const Q8Act a = q8_act_at(q8_smem, K / 32);
  q8_quant(GlobalVec{x}, a);
  q8_rows(qs, f, N, a, [&](int n, float v) { y[n] = v; });
}

template <class F>
static int q4_q8_matvec(const float* x, const uint8_t* qs, F f, float* y,
                        int N, int K, void* stream) {
  static GridCap cap;
  if (K % 4096 || N < 1) return (int)cudaErrorInvalidValue;
  const int smem = q8_act_bytes(K / 32);
  int grid = 0;
  cudaError_t e = grid_for(q4_q8_matvec_kernel<F>, Q8_THREADS, smem, N, &cap,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  q4_q8_matvec_kernel<F><<<grid, Q8_THREADS, smem, (cudaStream_t)stream>>>(
      x, qs, f, y, N, K);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q4k_q8_matvec(const float* x, const uint8_t* qs, const bf16* es,
                             const bf16* em, float* y, int N, int K,
                             void* stream) {
  return q4_q8_matvec(x, qs, Q4K{es, em}, y, N, K, stream);
}

// registers, shared memory and occupancy of the q4_k instance at this K
// (kernel_info, common.cuh): the benchmark entry's context line
GCT_EXPORT int q4k_q8_matvec_info(int K, int* out) {
  return kernel_info(q4_q8_matvec_kernel<Q4K>, Q8_THREADS,
                     q8_act_bytes(K / 32), out);
}

GCT_EXPORT int q4k_s6_q8_matvec(const float* x, const uint8_t* qs,
                                const int8_t* sm, const bf16* dd, float* y,
                                int N, int K, void* stream) {
  return q4_q8_matvec(x, qs, Q4KS6{sm, dd}, y, N, K, stream);
}

GCT_EXPORT int q40_q8_matvec(const float* x, const uint8_t* qs,
                             const __half* d, float* y, int N, int K,
                             void* stream) {
  return q4_q8_matvec(x, qs, Q40{d}, y, N, K, stream);
}
