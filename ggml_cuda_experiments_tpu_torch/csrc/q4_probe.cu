// The q4_k stage ladder for Hopper (sm_90a): one kernel template over a
// mode, each mode one rung of the JAX package's probe kernels, and the
// activation prep of the int8-activation matvec as a kernel of its own.
//
// Replaces (ops/probes.py has the table and every mode's plain version):
//   floor      tools/exp_q4.py::_floor_kernel, the stream floor, which is
//              also bench.py's stream-only ceiling (the CHUNK8_STREAM_ONLY
//              branch of ops/quant_matmul.py::_chunk8_kernel, which sums
//              only qs[:, :128]: a CUDA kernel reads only what it touches,
//              so the floor takes _floor_kernel's function, every int32
//              word of qs, and es + em);
//   chunk, chunk32  exp_q4.py::_chunk_kernel (int8_ops true / false): the
//              exact-f32 matvec on prepared rows a = xl - xh/16, b = xh/16;
//   ponly, loonly, nochunk, floorhi, bf16   exp_q4.py::_probe_kernel;
//   dma, zponly, zlonly, full, noand, cols256, split_f32
//              tools/exp_q4_r2.py::k_dma, k_zponly, k_zlonly, k_full (and
//              k_onedot, k_onedot_sub, k_subtile: full's function, fed to
//              the MXU another way), k_noand, k_cols256, k_split_f32.
// q8_prep quantizes x into device memory once: with the `full` rung it is
// tools/shape_probe.py's --preprep (the activation prep hoisted out of the
// matvec), bit-equal to q4k_q8_matvec.
//
// Every mode has the production kernel's load pattern and grid
// (q4k_q8.cu, q8_common.cuh): 512 threads, a warp per row at a time, each
// lane one 16-byte load per 32-block of the logical q4_k bytes, four blocks
// in flight, the bf16 es / em of those blocks beside them, and the grid
// capped at the CTAs that are resident (or `ctas` per SM, the ladder's
// knob: the counterpart of the JAX tools' block_n). The JAX rungs index the
// interleaved layout; here block b of a row is bytes 16b .. 16b + 15 (byte
// t: elements t and t + 16), its prepared operands a / b (f32) or aq / bq
// (int8) at [b][t], so each rung computes the JAX rung's function on the
// same operands in logical order. So a rung's time prices that stage of the
// port's kernel. Bound on the H100: bytes, 2,560 B a row at K = 4096.
//
// Operands are prepared outside the kernel (ops/probes.py act_operands, or
// q8_prep) into one byte block, which every CTA copies into shared memory:
//   f32 modes    [a f32 16kb | b f32 16kb | c f32 kb | xs f32 kb]
//   int8 modes   a Q8Act block [aq 16kb | bq 16kb | c | xs | sa | sb]
//                (cols256 keeps a second copy of aq | bq beside it)
//   split_f32    [af f32 16kb | the Q8Act block]
//   floor        none (it reads x[0] only)
#include "q8_common.cuh"

enum LadderMode {
  FLOOR = 0, CHUNK, CHUNK32, PONLY, LOONLY, NOCHUNK, FLOORHI, BF16,
  DMA, ZPONLY, ZLONLY, FULL, NOAND, COLS256, SPLIT_F32, N_MODES
};

__host__ __device__ constexpr bool f32_mode(int m) {
  return m >= CHUNK && m <= BF16;
}

// operand bytes per 32-block in device memory, and in shared memory
__host__ __device__ constexpr int act_per_block(int m) {
  return m == FLOOR ? 0 : f32_mode(m) ? 136 : m == SPLIT_F32 ? 112 : 48;
}
__host__ __device__ constexpr int smem_per_block(int m) {
  return m == COLS256 ? 80 : act_per_block(m);
}

struct Ladder {
  const float *a, *b, *c, *xs, *af;
  const int8_t *aq2, *bq2;
  Q8Act q;
};

template <int M>
__device__ __forceinline__ Ladder ladder_at(unsigned char* base, int kb) {
  Ladder S{};
  if (f32_mode(M)) {
    S.a = reinterpret_cast<const float*>(base);
    S.b = S.a + 16 * kb;
    S.c = S.b + 16 * kb;
    S.xs = S.c + kb;
  } else if (M == SPLIT_F32) {
    S.af = reinterpret_cast<const float*>(base);
    S.q = q8_act_at(base + 64 * kb, kb);
  } else if (M != FLOOR) {
    S.q = q8_act_at(base, kb);
    S.aq2 = reinterpret_cast<const int8_t*>(base + 48 * kb);
    S.bq2 = S.aq2 + 16 * kb;
  }
  return S;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned warp_sum_u32(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int dot4(const uint4& w, const int4& v, int acc) {
  acc = __dp4a((int)w.x, v.x, acc);
  acc = __dp4a((int)w.y, v.y, acc);
  acc = __dp4a((int)w.z, v.z, acc);
  return __dp4a((int)w.w, v.w, acc);
}

__device__ __forceinline__ uint4 lo_of(const uint4& w) {
  return make_uint4(w.x & 0x0F0F0F0Fu, w.y & 0x0F0F0F0Fu, w.z & 0x0F0F0F0Fu,
                    w.w & 0x0F0F0F0Fu);
}

__device__ __forceinline__ uint4 p_of(const uint4& w) {
  return make_uint4(w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                    w.w ^ 0x80808080u);
}

// The f32 rungs' block sum z = sum_t term(lo_t, p_t, a_t, b_t) over the 16
// bytes of one block, in byte order, each term rounded as the JAX rung
// rounds it. lo is the low nibble, p = byte - 128 = lo + 16 hi - 128 (the
// byte XOR 0x80 read as int8). chunk unpacks with word-wide AND / XOR (four
// bytes an operation, the JAX int8_ops path); chunk32 byte by byte in int32.
template <int M>
__device__ __forceinline__ float f32_block(const uint4& w, const float* a,
                                           const float* b) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 av = reinterpret_cast<const float4*>(a)[k];
    const float4 bv = reinterpret_cast<const float4*>(b)[k];
    const float aa[4] = {av.x, av.y, av.z, av.w};
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
    const uint32_t lo4 = u[k] & 0x0F0F0F0Fu, p4 = u[k] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo, p;
      if (M == CHUNK32) {
        const int v = (int)((u[k] >> (8 * i)) & 0xFFu);
        lo = (float)(v & 15);
        p = (float)(v - 128);
      } else {
        lo = (float)((lo4 >> (8 * i)) & 0xFFu);
        p = (float)(int8_t)((p4 >> (8 * i)) & 0xFFu);
      }
      float t;
      if (M == PONLY) {
        t = __fmul_rn(p, bb[i]);
      } else if (M == LOONLY) {
        t = __fmul_rn(lo, aa[i]);
      } else if (M == FLOORHI) {          // hi = floor(p / 16 + 8), no mask
        const float hi = floorf(__fadd_rn(__fmul_rn(p, 0.0625f), 8.f));
        t = __fadd_rn(__fmul_rn(p, aa[i]), __fmul_rn(hi, bb[i]));
      } else if (M == BF16) {             // every step rounded to bf16
        t = bf16r(__fadd_rn(bf16r(__fmul_rn(lo, bf16r(aa[i]))),
                            bf16r(__fmul_rn(p, bf16r(bb[i])))));
      } else {                            // chunk, chunk32, nochunk
        t = __fadd_rn(__fmul_rn(lo, aa[i]), __fmul_rn(p, bb[i]));
      }
      z += t;
    }
  }
  return z;
}

// One row of mode M; the sum in every lane.
template <int M>
__device__ __forceinline__ float ladder_row(const uint8_t* qs, const bf16* es,
                                            const bf16* em, size_t n, int kb,
                                            const Ladder& S, float x0,
                                            unsigned* sink, int lane) {
  if (M == FULL) return q8_row_dot(qs, Q4K{es, em}, n, S.q, lane);
  const uint4* q = reinterpret_cast<const uint4*>(qs + n * (size_t)kb * 16);
  const size_t i0 = n * (size_t)kb;
  float acc = 0.f;
  unsigned iacc = 0u;
  for (int b0 = lane; b0 < kb; b0 += 128) {
    uint4 w[4];
    float s[4], mn[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = __ldg(q + b0 + 32 * u);
      s[u] = __bfloat162float(es[i0 + b0 + 32 * u]);
      mn[u] = __bfloat162float(em[i0 + b0 + 32 * u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = b0 + 32 * u;
      if (M == FLOOR) {                   // int32 words wrap; es + em in f32
        iacc += w[u].x + w[u].y + w[u].z + w[u].w;
        acc += s[u] + mn[u];
      } else if (f32_mode(M)) {
        const float z = f32_block<M>(w[u], S.a + 16 * b, S.b + 16 * b);
        if (M == NOCHUNK)                 // no scales; 0 * (es + em)
          acc += z + 0.f * (s[u] + mn[u]);  // keeps their stream
        else
          acc += s[u] * (z + S.c[b]) - mn[u] * S.xs[b];
      } else if (M == DMA) {              // byte 0 of the block, as int8
        iacc ^= w[u].x ^ w[u].y ^ w[u].z ^ w[u].w;   // every byte read
        const float z = (float)((int)(w[u].x & 0xFFu) - 128);
        acc += s[u] * z - mn[u] * S.q.xs[b];
      } else {
        const int4 av = *reinterpret_cast<const int4*>(S.q.aq + 16 * b);
        const int4 bv = *reinterpret_cast<const int4*>(S.q.bq + 16 * b);
        const uint4 lo = lo_of(w[u]), p = p_of(w[u]);
        float z;
        if (M == ZPONLY) {
          z = S.q.sb[b] * (float)dot4(p, bv, 0) + S.q.c[b];
        } else if (M == ZLONLY) {
          z = S.q.sa[b] * (float)dot4(lo, av, 0) + S.q.c[b];
        } else if (M == SPLIT_F32) {      // the low nibbles in f32, exact a
          const float* af = S.af + 16 * b;
          const uint32_t l4[4] = {lo.x, lo.y, lo.z, lo.w};
          float zl = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            zl += (float)((l4[k >> 2] >> (8 * (k & 3))) & 0xFFu) * af[k];
          z = zl + S.q.sb[b] * (float)dot4(p, bv, 0) + S.q.c[b];
        } else {
          int zl, zp;
          if (M == NOAND) {               // both dots on p: no AND
            zl = dot4(p, av, 0);
            zp = dot4(p, bv, 0);
          } else {                        // cols256: each dot twice
            const int4 av2 =
                *reinterpret_cast<const int4*>(S.aq2 + 16 * b);
            const int4 bv2 =
                *reinterpret_cast<const int4*>(S.bq2 + 16 * b);
            zl = (dot4(lo, av, 0) + dot4(lo, av2, 0)) >> 1;
            zp = (dot4(p, bv, 0) + dot4(p, bv2, 0)) >> 1;
          }
          z = S.q.sa[b] * (float)zl + S.q.sb[b] * (float)zp + S.q.c[b];
        }
        acc += s[u] * z - mn[u] * S.q.xs[b];
      }
    }
  }
  if (M == FLOOR) {
    iacc = warp_sum_u32(iacc);
    acc = warp_sum(acc);
    return ((float)(int)iacc + acc) + x0;
  }
  // the dma rung's unused bytes go to a sink that is never written (its
  // pointer is null at run time, which the compiler cannot know), so their
  // loads stay
  if (M == DMA && sink) sink[n] = iacc;
  return warp_sum(acc);
}

template <int M>
__global__ void __launch_bounds__(Q8_THREADS, 2)
q4_ladder_kernel(const unsigned char* __restrict__ act,
                 const float* __restrict__ x, const uint8_t* __restrict__ qs,
                 const bf16* __restrict__ es, const bf16* __restrict__ em,
                 float* __restrict__ y, unsigned* sink, int N, int K) {
  extern __shared__ __align__(16) unsigned char lad_smem[];
  const int kb = K / 32;
  const int n16 = act_per_block(M) * kb / 16;
  const uint4* src = reinterpret_cast<const uint4*>(act);
  uint4* dst = reinterpret_cast<uint4*>(lad_smem);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = __ldg(src + i);
  if (M == COLS256)                       // the second copy of aq | bq
    for (int i = threadIdx.x; i < 2 * kb; i += blockDim.x)
      dst[n16 + i] = __ldg(src + i);
  __syncthreads();
  const Ladder S = ladder_at<M>(lad_smem, kb);
  const float x0 = M == FLOOR ? __ldg(x) : 0.f;
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * (blockDim.x >> 5);
  for (int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); n < N;
       n += nw) {
    const float v =
        ladder_row<M>(qs, es, em, (size_t)n, kb, S, x0, sink, lane);
    if (lane == 0) y[n] = v;
  }
}

template <int M>
static int ladder_launch(const void* act, const float* x, const uint8_t* qs,
                         const bf16* es, const bf16* em, float* y, int N,
                         int K, int ctas, void* stream) {
  static GridCap cap;
  const int smem = smem_per_block(M) * (K / 32);
  int grid = 0;
  cudaError_t e = grid_for(q4_ladder_kernel<M>, Q8_THREADS, smem, N, &cap,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  if (ctas > 0) {
    const int rows = Q8_THREADS / 32;
    grid = (N + rows - 1) / rows;
    if (grid > ctas * cap.sms) grid = ctas * cap.sms;
  }
  q4_ladder_kernel<M><<<grid, Q8_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned char*>(act), x, qs, es, em, y, nullptr,
      N, K);
  return (int)cudaGetLastError();
}

#define GCT_LADDER_MODES(X)                                                \
  X(FLOOR) X(CHUNK) X(CHUNK32) X(PONLY) X(LOONLY) X(NOCHUNK) X(FLOORHI)    \
  X(BF16) X(DMA) X(ZPONLY) X(ZLONLY) X(FULL) X(NOAND) X(COLS256)           \
  X(SPLIT_F32)

// y [N] = rung `mode` of the q4_k weight (qs, es, em) [N, K] on the operand
// block act (16-byte aligned; its size by mode above) and x (floor: x[0]).
// K % 4096 == 0. ctas: CTAs per SM (0: as many as are resident).
GCT_EXPORT int q4_ladder(int mode, const void* act, const float* x,
                         const uint8_t* qs, const bf16* es, const bf16* em,
                         float* y, int N, int K, int ctas, void* stream) {
  if (K % 4096 || N < 1 || ctas < 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
#define GCT_CASE(m)                                                        \
  case m:                                                                  \
    return ladder_launch<m>(act, x, qs, es, em, y, N, K, ctas, stream);
    GCT_LADDER_MODES(GCT_CASE)
#undef GCT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// registers, shared memory and occupancy of rung `mode` at this K
GCT_EXPORT int q4_ladder_info(int mode, int K, int* out) {
  switch (mode) {
#define GCT_CASE(m)                                                        \
  case m:                                                                  \
    return kernel_info(q4_ladder_kernel<m>, Q8_THREADS,                    \
                       smem_per_block(m) * (K / 32), out);
    GCT_LADDER_MODES(GCT_CASE)
#undef GCT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The operands of q4k_q8_matvec for x [K] quantized once into device
// memory: the Q8Act block (48 K/32 bytes) that every CTA of q4k_q8_matvec
// builds in its own shared memory, by the same code (q8_quant_block), so
// that `full` on it is bit-equal to q4k_q8_matvec. K / 1024 CTAs, each 32
// blocks (a half-warp a block), in one pass.
__global__ void __launch_bounds__(Q8_THREADS)
q8_prep_kernel(const float* __restrict__ x, unsigned char* out, int K) {
  const Q8Act a = q8_act_at(out, K / 32);
  const int per = blockDim.x >> 4;
  for (int b = blockIdx.x * per + (threadIdx.x >> 4); b < a.kb;
       b += gridDim.x * per)
    q8_quant_block(GlobalVec{x}, a, b, threadIdx.x & 15);
}

GCT_EXPORT int q8_prep(const float* x, void* out, int K, void* stream) {
  if (K % 4096) return (int)cudaErrorInvalidValue;
  q8_prep_kernel<<<K / 32 / (Q8_THREADS / 16), Q8_THREADS, 0,
                   (cudaStream_t)stream>>>(
      x, reinterpret_cast<unsigned char*>(out), K);
  return (int)cudaGetLastError();
}
