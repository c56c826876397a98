// The q6_k head's probe rungs for Hopper (sm_90a): the JAX package's
// tools/q6_probe.py::_probe_kernel, mode by mode, on its random operands at
// K = 4096 (qs int8 [N, 2048], qh int8 [N, 1024], es bf16 [N, 256], the
// selectors ea / eb int8 [2048, 256], xc f32 [4, 1024]). The operands have
// no logical order, so each rung computes the JAX rung's function on the
// very same arrays (column j of qh belongs to scale column j mod 256).
//
//   stream  o[n] = sum(qs[n, :128]) + sum(qh[n, :128]) + sum(es[n, :]), as
//           f32 (the int8 sums exact); every byte of qs, qh and es is
//           loaded (the bytes the sums skip feed a store the compiler
//           cannot drop), as the JAX rung's BlockSpecs stream them whole:
//           the floor of the head.
//   bits2   the 2-bit planes of qh: u = qh ^ 0x80, h0..h3 its bit pairs,
//           t2[j] = h0 xc0[j] + h1 xc1[j] + h2 xc2[j] + h3 xc3[j],
//           z[c] = t2[c] + t2[256 + c] + t2[512 + c] + t2[768 + c],
//           o[n] = sum_c es[n, c] z[c]. A warp per row: each lane two
//           16-byte loads of qh (a warp reads the row's 1 KB contiguous),
//           the four planes of 16 columns summed across a lane pair.
//   nib_global / nib_seg  the nibble part as int8 products against the
//           selectors: z = [p | hi4] @ [ea; eb] (global) or, per 1 KB
//           segment s of qs, [p_s | hi4_s] @ [ea_s; eb_s][:, :128]
//           (segment-local, half the MACs), hi4 = floor(p / 16) + 8, then
//           o[n] = sum_c es[n, c] z[n, c]. The products run on the port's
//           int8 tensor-core GEMM (ops/matmul.py, csrc/matmul.cu); this
//           file has its prologue (q6_nib_lhs: [p | hi4] rows, per segment
//           for nib_seg) and its epilogue (q6_nib_fold).
// Bound on the H100: bytes for stream and bits2 (3,584 B a row: qs, qh and
// es); operations for the nib rungs (2 N 4096 256 int8 MACs, global).
#include "quant_formats.cuh"

constexpr int Q6P_THREADS = 512;
constexpr int Q6P_KH = 2048, Q6P_KQ = 1024, Q6P_KB = 256;

__device__ __forceinline__ uint4 q6p_ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned q6p_xor(const uint4& w) {
  return w.x ^ w.y ^ w.z ^ w.w;
}

__device__ __forceinline__ int q6p_sum_bytes(const uint4& w, int acc) {
  acc = __dp4a((int)w.x, 0x01010101, acc);   // signed bytes times 1
  acc = __dp4a((int)w.y, 0x01010101, acc);
  acc = __dp4a((int)w.z, 0x01010101, acc);
  return __dp4a((int)w.w, 0x01010101, acc);
}

__device__ __forceinline__ int q6p_warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(Q6P_THREADS)
q6_stream_kernel(const int8_t* __restrict__ qs, const int8_t* __restrict__ qh,
                 const bf16* __restrict__ es, float* __restrict__ o,
                 unsigned* sink, int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int8_t* qr = qs + (size_t)n * Q6P_KH;
  const int8_t* hr = qh + (size_t)n * Q6P_KQ;
  uint4 wq[4], wh[2];
#pragma unroll
  for (int u = 0; u < 4; ++u) wq[u] = q6p_ld16(qr + 16 * (lane + 32 * u));
#pragma unroll
  for (int u = 0; u < 2; ++u) wh[u] = q6p_ld16(hr + 16 * (lane + 32 * u));
  const uint4 we = q6p_ld16(es + (size_t)n * Q6P_KB + 8 * lane);
  // bytes 0..127 of qs and qh are the first 16-byte loads of lanes 0..7
  int sq = lane < 8 ? q6p_sum_bytes(wq[0], 0) : 0;
  int sh = lane < 8 ? q6p_sum_bytes(wh[0], 0) : 0;
  const uint32_t e4[4] = {we.x, we.y, we.z, we.w};
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    se += __uint_as_float(e4[k] << 16);
    se += __uint_as_float(e4[k] & 0xFFFF0000u);
  }
  sq = q6p_warp_isum(sq);
  sh = q6p_warp_isum(sh);
  se = warp_sum(se);
  if (lane == 0) o[n] = ((float)sq + (float)sh) + se;
  // the bytes the sums skip go to a sink that is never written (null at run
  // time, which the compiler cannot know), so that every load stays
  if (sink)
    sink[n * 32 + lane] = q6p_xor(wq[1]) ^ q6p_xor(wq[2]) ^ q6p_xor(wq[3]) ^
                          q6p_xor(wh[1]) ^ (lane < 8 ? 0u : q6p_xor(wq[0]) ^
                                                              q6p_xor(wh[0]));
}

// the four 2-bit planes of byte v (int8 in the JAX rung; u = v + 128)
__device__ __forceinline__ float q6p_t2(uint32_t v, const float* x, int j) {
  const uint32_t u = (v ^ 0x80u) & 0xFFu;
  const float h0 = (float)(u & 3u), h1 = (float)((u >> 2) & 3u);
  const float h2 = (float)((u >> 4) & 3u), h3 = (float)(u >> 6);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(h0, x[j]), __fmul_rn(h1, x[Q6P_KQ + j])),
                __fmul_rn(h2, x[2 * Q6P_KQ + j])),
      __fmul_rn(h3, x[3 * Q6P_KQ + j]));
}

__global__ void __launch_bounds__(Q6P_THREADS, 2)
q6_bits2_kernel(const int8_t* __restrict__ qh, const float* __restrict__ xc,
                const bf16* __restrict__ es, float* __restrict__ o, int N) {
  extern __shared__ __align__(16) float q6p_x[];        // xc [4][1024]
  for (int i = threadIdx.x; i < 4 * Q6P_KQ / 4; i += blockDim.x)
    reinterpret_cast<float4*>(q6p_x)[i] =
        __ldg(reinterpret_cast<const float4*>(xc) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int cb = 16 * (lane & 15), half = lane >> 4;
  const int nw = gridDim.x * (blockDim.x >> 5);
  for (int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); n < N;
       n += nw) {
    const int8_t* hr = qh + (size_t)n * Q6P_KQ;
    // this lane: plane rows s = half and half + 2 of columns cb .. cb + 15
    const uint4 w0 = q6p_ld16(hr + 16 * lane);
    const uint4 w1 = q6p_ld16(hr + 16 * (lane + 32));
    const uint4 we = q6p_ld16(es + (size_t)n * Q6P_KB + cb + 8 * half);
    const uint32_t a4[4] = {w0.x, w0.y, w0.z, w0.w};
    const uint32_t b4[4] = {w1.x, w1.y, w1.z, w1.w};
    float ta[16], tb[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t va = a4[k >> 2] >> (8 * (k & 3));
      const uint32_t vb = b4[k >> 2] >> (8 * (k & 3));
      ta[k] = q6p_t2(va, q6p_x, 256 * half + cb + k);
      tb[k] = q6p_t2(vb, q6p_x, 256 * (half + 2) + cb + k);
    }
    const uint32_t e4[4] = {we.x, we.y, we.z, we.w};
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float pa = __shfl_xor_sync(0xffffffffu, ta[k], 16);
      const float pb = __shfl_xor_sync(0xffffffffu, tb[k], 16);
      // z = ((t0 + t1) + t2) + t3, as the JAX rung adds its four slices
      const float t0 = half ? pa : ta[k], t1 = half ? ta[k] : pa;
      const float t2 = half ? pb : tb[k], t3 = half ? tb[k] : pb;
      const float z = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
      const int c = k - 8 * half;         // this lane's 8 of the 16 columns
      if (c >= 0 && c < 8) {
        const uint32_t e = e4[c >> 1];
        acc += __uint_as_float((c & 1) ? (e & 0xFFFF0000u) : (e << 16)) * z;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) o[n] = acc;
  }
}

// lhs [N, 4096] int8: [p | hi4] (global) or [p_0 | hi4_0 | p_1 | hi4_1]
// (seg, 1 KB segments of qs), hi4 = floor(p / 16) + 8 = (p + 128) >> 4
__global__ void q6_nib_lhs_kernel(const int8_t* __restrict__ qs,
                                  int8_t* __restrict__ lhs, int N, int seg) {
  const size_t total = (size_t)N * (Q6P_KH / 16);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t n = i / (Q6P_KH / 16);
    const int j = 16 * (int)(i % (Q6P_KH / 16));
    const uint4 w = q6p_ld16(qs + n * Q6P_KH + j);
    const uint4 h = make_uint4(((w.x ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu,
                               ((w.y ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu,
                               ((w.z ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu,
                               ((w.w ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu);
    int8_t* row = lhs + n * (2 * Q6P_KH);
    const int jp = seg ? (j / 1024) * 2048 + j % 1024 : j;
    const int jh = seg ? jp + 1024 : j + Q6P_KH;
    *reinterpret_cast<uint4*>(row + jp) = w;
    *reinterpret_cast<uint4*>(row + jh) = h;
  }
}

// o[n] = sum_c es[n, c] f32(z[n, c]), columns 0..127 from z0, 128..255
// from z1 (rows ld int32 apart)
__global__ void __launch_bounds__(Q6P_THREADS)
q6_nib_fold_kernel(const int* __restrict__ z0, const int* __restrict__ z1,
                   int ld, const bf16* __restrict__ es, float* __restrict__ o,
                   int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int c0 = 8 * lane;
  const int* zr = (c0 < 128 ? z0 + c0 : z1 + c0 - 128) + (size_t)n * ld;
  const int4 za = *reinterpret_cast<const int4*>(zr);
  const int4 zb = *reinterpret_cast<const int4*>(zr + 4);
  const uint4 we = q6p_ld16(es + (size_t)n * Q6P_KB + c0);
  const int z[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
  const uint32_t e4[4] = {we.x, we.y, we.z, we.w};
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t e = e4[k >> 1];
    acc += __uint_as_float((k & 1) ? (e & 0xFFFF0000u) : (e << 16)) *
           (float)z[k];
  }
  acc = warp_sum(acc);
  if (lane == 0) o[n] = acc;
}

static int q6p_rows_grid(int N) {
  return (N + Q6P_THREADS / 32 - 1) / (Q6P_THREADS / 32);
}

GCT_EXPORT int q6_stream(const void* qs, const void* qh, const bf16* es,
                         float* o, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  q6_stream_kernel<<<q6p_rows_grid(N), Q6P_THREADS, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const int8_t*>(qs), reinterpret_cast<const int8_t*>(qh),
      es, o, nullptr, N);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q6_bits2(const void* qh, const float* xc, const bf16* es,
                        float* o, int N, void* stream) {
  static GridCap cap;
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int smem = 4 * Q6P_KQ * (int)sizeof(float);
  int grid = 0;
  cudaError_t e = grid_for(q6_bits2_kernel, Q6P_THREADS, smem, N, &cap, &grid);
  if (e != cudaSuccess) return (int)e;
  q6_bits2_kernel<<<grid, Q6P_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const int8_t*>(qh), xc, es, o, N);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q6_nib_lhs(const void* qs, void* lhs, int N, int seg,
                          void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)N * (Q6P_KH / 16);
  const int grid = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                     : 8192);
  q6_nib_lhs_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int8_t*>(qs), reinterpret_cast<int8_t*>(lhs), N,
      seg);
  return (int)cudaGetLastError();
}

GCT_EXPORT int q6_nib_fold(const int* z0, const int* z1, int ld,
                           const bf16* es, float* o, int N, void* stream) {
  if (N < 1 || ld % 4) return (int)cudaErrorInvalidValue;
  q6_nib_fold_kernel<<<q6p_rows_grid(N), Q6P_THREADS, 0,
                       (cudaStream_t)stream>>>(z0, z1, ld, es, o, N);
  return (int)cudaGetLastError();
}
