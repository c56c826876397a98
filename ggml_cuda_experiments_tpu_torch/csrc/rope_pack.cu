// Prefill RoPE + head-major repack on Hopper (sm_90a).
//
// Replaces ops/prefill_fuse.py::_rope_pack_kernel of the JAX package.
//   y [T, (Hq + 2 Hkv) D] bf16 (the wqkv GEMM output), C / S2 [T, D] f32
//   (C = [cos | cos], S2 = [-sin | sin], made once a prefill by the caller
//   or by the wrapper)
//   -> qT [Hq, T, D], kT [Hkv, T, D] roped in f32, vT [Hkv, T, D], bf16.
//   Rotate-half: out[i] = x[i] * C[i] + x[(i + D/2) % D] * S2[i], each
//   product and the sum rounded on their own (__fmul_rn / __fadd_rn, no FMA
//   contraction), so the kernel equals the plain PyTorch version bit for bit.
//
// Bound on the H100: bytes (one read and one write of y; 25.2 MB at T = 512
// for llama2-7b, 7.5 us), no reuse. Design: every access is a 16-byte
// vector. A thread owns 8 elements [8c, 8c + 8) of the first half of a head
// row and their rotate-half partners at + D/2: two 16-byte loads of y and
// two 16-byte stores a head, with the 32 table values of its (token, c)
// loaded once as float4s and kept in registers for the CTA's RP_HEADS
// heads. A CTA takes RP_THREADS / (D / 16) tokens (32 at D = 128) and
// RP_HEADS heads (blockIdx.y), so each head's output rows go out as one
// contiguous run of 32 rows; all of a thread's loads issue before its math.
// The v heads are the same two vectors copied. Tokens past T (the ragged
// tail) and heads past Hq + 2 Hkv are masked.
#include "common.cuh"

constexpr int RP_THREADS = 256;
constexpr int RP_HEADS = 8;                      // heads a CTA

__device__ __forceinline__ void rp_rope8(const uint4& x, const uint4& px,
                                         const float (&c)[8],
                                         const float (&s)[8], uint4* out) {
  const unsigned* a = reinterpret_cast<const unsigned*>(&x);
  const unsigned* b = reinterpret_cast<const unsigned*>(&px);
  unsigned* o = reinterpret_cast<unsigned*>(out);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float x0 = __uint_as_float(a[w] << 16);
    const float x1 = __uint_as_float(a[w] & 0xffff0000u);
    const float p0 = __uint_as_float(b[w] << 16);
    const float p1 = __uint_as_float(b[w] & 0xffff0000u);
    const float r0 = __fadd_rn(__fmul_rn(x0, c[2 * w]),
                               __fmul_rn(p0, s[2 * w]));
    const float r1 = __fadd_rn(__fmul_rn(x1, c[2 * w + 1]),
                               __fmul_rn(p1, s[2 * w + 1]));
    const __nv_bfloat162 r = __floats2bfloat162_rn(r0, r1);
    o[w] = *reinterpret_cast<const unsigned*>(&r);
  }
}

__device__ __forceinline__ void rp_load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(RP_THREADS)
rope_pack_kernel(const bf16* __restrict__ y, const float* __restrict__ C,
                 const float* __restrict__ S2, bf16* __restrict__ qo,
                 bf16* __restrict__ ko, bf16* __restrict__ vo, int T, int nH,
                 int nKV, int D) {
  const int cpr = D / 16;                        // threads a token row
  const int tpc = RP_THREADS / cpr;              // tokens a CTA
  const int tt = threadIdx.x / cpr, c = threadIdx.x % cpr;
  const int t = blockIdx.x * tpc + tt;
  if (tt >= tpc || t >= T) return;
  const int half = D / 2, nr = nH + nKV, nh = nr + nKV;
  const int h0 = blockIdx.y * RP_HEADS;
  const int i0 = 8 * c, i1 = half + 8 * c;
  const bf16* yr = y + (size_t)t * nh * D;
  uint4 a[RP_HEADS], b[RP_HEADS];
#pragma unroll
  for (int j = 0; j < RP_HEADS; ++j) {
    if (h0 + j < nh) {
      a[j] = __ldg(reinterpret_cast<const uint4*>(yr + (h0 + j) * D + i0));
      b[j] = __ldg(reinterpret_cast<const uint4*>(yr + (h0 + j) * D + i1));
    }
  }
  float c0[8], c1[8], s0[8], s1[8];
  if (h0 < nr) {
    const float* cr = C + (size_t)t * D;
    const float* sr = S2 + (size_t)t * D;
    rp_load8(cr + i0, c0);
    rp_load8(cr + i1, c1);
    rp_load8(sr + i0, s0);
    rp_load8(sr + i1, s1);
  }
#pragma unroll
  for (int j = 0; j < RP_HEADS; ++j) {
    const int h = h0 + j;
    if (h >= nh) break;
    bf16* out = h < nH   ? qo + ((size_t)h * T + t) * D
                : h < nr ? ko + ((size_t)(h - nH) * T + t) * D
                         : vo + ((size_t)(h - nr) * T + t) * D;
    uint4 ra = a[j], rb = b[j];
    if (h < nr) {
      // out[i] = x[i] C[i] + x[i + D/2] S2[i]; out[i + D/2] = x[i + D/2]
      // C[i + D/2] + x[i] S2[i + D/2]
      rp_rope8(a[j], b[j], c0, s0, &ra);
      rp_rope8(b[j], a[j], c1, s1, &rb);
    }
    *reinterpret_cast<uint4*>(out + i0) = ra;
    *reinterpret_cast<uint4*>(out + i1) = rb;
  }
}

// D a multiple of 16 (at most 4096); y, C and S2 on 16 bytes (the wrapper
// checks; the outputs are its own allocations)
GCT_EXPORT int rope_pack(const bf16* y, const float* C, const float* S2,
                         bf16* qo, bf16* ko, bf16* vo, int T, int nH, int nKV,
                         int D, void* stream) {
  if (D % 16 || D < 16 || D > 16 * RP_THREADS || T < 1 || nH < 1 ||
      nKV < 1 || (((uintptr_t)y | (uintptr_t)C | (uintptr_t)S2) & 15))
    return (int)cudaErrorInvalidValue;
  const int tpc = RP_THREADS / (D / 16);
  const dim3 grid((T + tpc - 1) / tpc,
                  (nH + 2 * nKV + RP_HEADS - 1) / RP_HEADS);
  rope_pack_kernel<<<grid, RP_THREADS, 0, (cudaStream_t)stream>>>(
      y, C, S2, qo, ko, vo, T, nH, nKV, D);
  return (int)cudaGetLastError();
}
