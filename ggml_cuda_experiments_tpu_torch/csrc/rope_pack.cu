// Prefill RoPE + head-major repack on Hopper (sm_90a).
//
// Replaces ops/prefill_fuse.py::_rope_pack_kernel of the JAX package.
//   y [T, (Hq + 2 Hkv) D] bf16 (the wqkv GEMM output), C / S2 [T, D] f32
//   (C = [cos | cos], S2 = [-sin | sin], made by the wrapper)
//   -> qT [Hq, T, D], kT [Hkv, T, D] roped in f32, vT [Hkv, T, D], bf16.
//   Rotate-half: out[i] = x[i] * C[i] + x[(i + D/2) % D] * S2[i], each
//   product and the sum rounded on their own (__fmul_rn / __fadd_rn, no FMA
//   contraction), so the kernel equals the plain PyTorch version bit for bit.
//   Bound on the H100: bytes (one read and one write of y; 25 MB at T = 512
//   for llama2-7b), no reuse. Design: one CTA per token row; its threads
//   walk the row's (head, pair) elements, reading y coalesced and writing
//   each head's D-wide output row contiguously. The v heads are a copy.
#include "common.cuh"

constexpr int RP_THREADS = 256;

__global__ void __launch_bounds__(RP_THREADS)
rope_pack_kernel(const bf16* __restrict__ y, const float* __restrict__ C,
                 const float* __restrict__ S2, bf16* __restrict__ qo,
                 bf16* __restrict__ ko, bf16* __restrict__ vo, int T, int nH,
                 int nKV, int D) {
  const int t = blockIdx.x, half = D / 2;
  const int width = (nH + 2 * nKV) * D;
  const bf16* yr = y + (size_t)t * width;
  const float* cr = C + (size_t)t * D;
  const float* sr = S2 + (size_t)t * D;
  // roped heads (q then k): one thread per (head, i < D/2) pair
  const int n_pairs = (nH + nKV) * half;
  for (int e = threadIdx.x; e < n_pairs; e += RP_THREADS) {
    const int h = e / half, i = e % half;
    const float x0 = __bfloat162float(yr[h * D + i]);
    const float x1 = __bfloat162float(yr[h * D + i + half]);
    const float r0 = __fadd_rn(__fmul_rn(x0, cr[i]), __fmul_rn(x1, sr[i]));
    const float r1 = __fadd_rn(__fmul_rn(x1, cr[i + half]),
                               __fmul_rn(x0, sr[i + half]));
    bf16* out = h < nH ? qo + ((size_t)h * T + t) * D
                       : ko + ((size_t)(h - nH) * T + t) * D;
    out[i] = __float2bfloat16(r0);
    out[i + half] = __float2bfloat16(r1);
  }
  // v heads: a copy into the head-major layout
  const bf16* yv = yr + (nH + nKV) * D;
  for (int e = threadIdx.x; e < nKV * D; e += RP_THREADS) {
    const int h = e / D, i = e % D;
    vo[((size_t)h * T + t) * D + i] = yv[e];
  }
}

GCT_EXPORT int rope_pack(const bf16* y, const float* C, const float* S2,
                         bf16* qo, bf16* ko, bf16* vo, int T, int nH, int nKV,
                         int D, void* stream) {
  if (D % 2 || T < 1) return (int)cudaErrorInvalidValue;
  rope_pack_kernel<<<T, RP_THREADS, 0, (cudaStream_t)stream>>>(
      y, C, S2, qo, ko, vo, T, nH, nKV, D);
  return (int)cudaGetLastError();
}
