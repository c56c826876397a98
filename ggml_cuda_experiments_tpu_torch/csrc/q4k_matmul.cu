// Q4_K-E and Q4_0 fused dequant matvec for Hopper (sm_90a).
//
// Weights (logical column order, oracle/quant.py packing): the 4-bit
// formats' qs uint8 [N, K/2], where byte j of each 32-block holds element j
// (low nibble) and element j + 16 (high nibble); and each format's scale
// arrays, read through its trait (quant_formats.cuh): w = q * scale - min
// per 32-block, with (scale, min) = (es, em) bf16 for Q4_K-E and (d, 8 d)
// fp16 for Q4_0.
//
// q4k_matvec / q40_matvec (one template, two instances) replace
// ops/quant_matmul.py::_chunk_kernel (and ::_vpu2_kernel, and at K/32
// outside its repeat-aligned counts ::_vpu_e_kernel) of the JAX package:
// B = 1, exact f32 activations. Row n is sum_b scale_b * dot_b - min_b *
// xsum_b over its 32-blocks b, each block dot in f32 (the JAX kernel's
// exact fold; for Q4_0 d_b * dot_b - 8 d_b * xsum_b).
//
//   Bound on the H100: bytes, 0.625 B an element for Q4_K-E (16 bytes of
//   payload and 4 of scales a block), 0.5625 for Q4_0, 0.578125 for the
//   Q4_K "s6" encoding (q4k_s6_matvec: 16 bytes of payload, the block's
//   6-bit sc and mn one byte each, and a quarter of its superblock's bf16
//   d and dmin). The 7B w_gu
//   [24576, 4096] is 62.9 MB (18.8 us at 3.35 TB/s).
//
//   Design. A persistent grid: at most MV_CTAS_PER_SM CTAs an SM (what is
//   resident, queried once per K), each staging x (36 floats a 32-block, so
//   that the lanes' float4 reads miss each other's banks) and the block sums
//   of x once, then walking row tiles. A warp takes MV_R = 4 rows at once,
//   a lane one block of each per step (a warp reads 4 x 512 contiguous
//   bytes a step), so every float4 of x read from shared memory serves 4
//   rows: the x traffic was 8 bytes of shared memory a weight byte with one
//   row a warp. Each warp streams its steps through its own ring of
//   MV_STAGES stages in shared memory by cp.async (a stage: the 4 rows' 32
//   payload vectors and their scales and mins, 2.5 KB), MV_STAGES - 1 steps
//   ahead of its math: 40-80 KB in flight an SM, whatever the compiler does
//   with registers. x is copied in by cp.async too, beside the first steps
//   (a CTA staging it by plain loads waited one L2 round trip a pass).
//   Nibbles widen to f32 through the exponent bits (0x4B000000 | q is
//   2^23 + q) rather than by int-to-float conversion: a PRMT, an FADD and
//   the FFMA an element, the floor of this arithmetic. On an H100 80GB HBM3
//   (PERF.md): a register double buffer one step ahead ran w_gu in
//   44 us; 3 stages beat 4 and 6; without the math the stream alone takes
//   25 us of the kernel's 29, the math ~10 us of issue.
//   Rows too few to fill the card (W_o, tinyllama's linears, N <= ~8192):
//   the host splits each row's blocks over `splits` warps of one CTA
//   (ops/quant_matmul.py::matvec_splits, a function of N, K and the SM
//   count), split s taking blocks [s KB / S, (s + 1) KB / S) in groups of 8
//   blocks where KB allows (so that a step's scales start on 16 bytes); the
//   warps of a row group leave their partial sums in shared memory, meet at
//   a named barrier, and the group's first warp adds them in split order. No
//   atomics: a row's sum does not depend on the schedule, so two calls give
//   the same bits.
//
//   s6 (K % 4096 == 0): the same warps and ring; a step's scale bytes are
//   each row's 32 sc and 32 mn bytes (two 16-byte runs K / 32 bytes apart)
//   and its 4 superblocks' d and dmin (two 8-byte runs), so a stage holds
//   80 bytes a row of them instead of 128, copied by one cp.async a lane
//   (16 bytes of sc or mn, or 4 of d or dmin). A lane decodes its block's
//   f32(d) * sc and f32(dmin) * mn as the s6 route of the JAX kernel does.
//
// The GEMMs of the same formats (q4k_gemm / q40_gemm / q80_gemm) are in
// q4k_gemm.cu.
#include "quant_formats.cuh"

// ---------------------------------------------------------------- matvec

constexpr int MV_WARPS = 8;
constexpr int MV_R = 4;            // rows a warp takes at once
constexpr int MV_XPAD = 36;        // floats per 32-block of x in shared memory
constexpr int MV_STAGES = 3;       // a warp's ring of steps
constexpr int MV_SW = 17;          // scale words a row a step (32 halves + 1)
constexpr int MV_CTAS_PER_SM = 2;  // the grid's cap (x is staged a CTA)

__device__ __forceinline__ unsigned mv_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes (src_size 0 or 16) or 4 bytes (src_size 0..4; the
// rest zero-filled)
__device__ __forceinline__ void mv_cp16(unsigned dst, const void* src,
                                        bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mv_cp4(unsigned dst, const void* src,
                                       int src_size) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_size)
               : "memory");
}

// nibble byte SEL of v (already masked to 0x0F0F0F0F) as a float: the
// byte under the exponent bits of e = 0x4B000000 is 2^23 + q. e is a kernel
// argument so that the selector stays the instruction's immediate (with
// both constants known the compiler moved a selector into a register for
// every nibble).
template <int SEL>
__device__ __forceinline__ float mv_nib(uint32_t v, uint32_t e) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(f) : "r"(v), "r"(e), "n"(0x7440 | SEL));
  return __uint_as_float(f) - 8388608.f;              // 2^23
}

// acc + the 8 products of payload word w (elements 4t..4t+3 low, +16 high)
__device__ __forceinline__ float mv_word(uint32_t w, const float4& xl,
                                         const float4& xh, float acc,
                                         uint32_t e) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  acc = fmaf(mv_nib<0>(lo, e), xl.x, acc);
  acc = fmaf(mv_nib<0>(hi, e), xh.x, acc);
  acc = fmaf(mv_nib<1>(lo, e), xl.y, acc);
  acc = fmaf(mv_nib<1>(hi, e), xh.y, acc);
  acc = fmaf(mv_nib<2>(lo, e), xl.z, acc);
  acc = fmaf(mv_nib<2>(hi, e), xh.z, acc);
  acc = fmaf(mv_nib<3>(lo, e), xl.w, acc);
  return fmaf(mv_nib<3>(hi, e), xh.w, acc);
}

// One step of a warp in its ring: the payload [MV_R][32 lanes][16 B], then
// the rows' scales and mins. A16 (K a multiple of 256, scale arrays on 16
// bytes, split bounds on 8 blocks): [MV_R][NARR] runs of 32 halves, 4
// chunks of 16 bytes each. Otherwise [MV_R][NARR][MV_SW] 4-byte words that
// hold the 32 halves, the first one's half given by the address.
// s6: [MV_R][sc 32 | mn 32] bytes, then [MV_R][d 4 | dmin 4] bf16.
template <class F, bool A16>
struct MvStage {
  static constexpr int PAY = MV_R * 32 * 16;
  static constexpr int S6D = PAY + MV_R * 64;     // s6: the d | dmin words
  static constexpr int BYTES =
      F::S6 ? S6D + MV_R * 16
            : PAY + MV_R * F::NARR * (A16 ? 64 : MV_SW * 4);
  static_assert(BYTES % 16 == 0, "16-byte stages");
};

// dynamic shared memory: x [KB][MV_XPAD] and its block sums, then the rings
__host__ __device__ constexpr int mv_x_bytes(int KB) {
  return (KB * (MV_XPAD + 1) * 4 + 15) / 16 * 16;
}

template <class F, bool A16>
__host__ __device__ constexpr int mv_smem_bytes(int KB) {
  return mv_x_bytes(KB) + MV_WARPS * MV_STAGES * MvStage<F, A16>::BYTES;
}

// the first block of split s of S over KB blocks: whole groups of 8 blocks
// where KB allows (ops/quant_matmul.py::matvec_blocks)
__device__ __forceinline__ int mv_split_start(int s, int S, int KB) {
  const int u = KB % 8 ? 1 : 8;
  return u * (s * (KB / u) / S);
}

// grid: row tiles of (MV_WARPS / splits) * MV_R rows, walked by every CTA
template <class F, bool A16>
__global__ void __launch_bounds__(MV_WARPS * 32, MV_CTAS_PER_SM)
q4_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                 const F f, float* __restrict__ y, int N, int K, int splits,
                 uint32_t e) {
  static_assert(F::QB == 16, "a 4-bit format");
  using S = MvStage<F, A16>;
  constexpr int NP = MV_R * F::NARR;    // (row, scale array) pairs a step
  extern __shared__ __align__(16) unsigned char mv_smem[];
  __shared__ float part[2][MV_WARPS][MV_R];
  const int KB = K / 32;
  float* xs = reinterpret_cast<float*>(mv_smem);   // [KB][MV_XPAD]
  float* xsum = xs + KB * MV_XPAD;                  // [KB]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = mv_smem + mv_x_bytes(KB) +
                        warp * MV_STAGES * S::BYTES;
  const int G = MV_WARPS / splits;      // row groups of a tile
  const int g = warp / splits, sp = warp % splits;
  const int b0 = mv_split_start(sp, splits, KB);
  const int b1 = mv_split_start(sp + 1, splits, KB);
  const int nst = (b1 - b0 + 31) / 32;  // steps of my split
  const int TR = G * MV_R;
  const int tiles = (N + TR - 1) / TR;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int items = mine * nst;         // (tile, step) pairs of this warp
  const int row_step = (int)gridDim.x * TR;
  const size_t scale_end = (size_t)N * KB * 2;   // bytes of a scale array

  // copy item (row0, st) into ring stage `stage`: the payload (lane l takes
  // block l of each row), then the rows' scales (A16: lane l one 16-byte
  // chunk; else lane l takes pair l % NP, words l / NP, + 32 / NP, ...)
  auto issue = [&](int row0, int st, int stage) {
    const unsigned dst = mv_smem_u32(ring + stage * S::BYTES);
    const int bs = b0 + st * 32;
    const bool okb = bs + lane < b1;
    const uint4* src =
        reinterpret_cast<const uint4*>(qs) + (size_t)row0 * KB + bs + lane;
#pragma unroll
    for (int r = 0; r < MV_R; ++r)            // (src-size 0 reads nothing)
      mv_cp16(dst + r * 512 + lane * 16, src + r * KB, okb && row0 + r < N);
    if constexpr (F::S6) {
      // lanes 0-15: 16 bytes of a row's sc (h 0) or mn (h 1), chunk c;
      // lanes 16-31: one 4-byte word of its d (h 0) or dmin (h 1): the
      // superblocks of blocks bs + 16 c .. + 15
      const int j = lane & 15, r = j >> 2, h = (j >> 1) & 1, c = j & 1;
      const bool ok = row0 + r < N && bs + 16 * c < b1;
      const size_t n = ok ? (size_t)(row0 + r) : 0;
      if (lane < 16)
        mv_cp16(dst + S::PAY + r * 64 + h * 32 + c * 16,
                f.sm + n * 2 * KB + h * KB + bs + 16 * c, ok);
      else
        mv_cp4(dst + S::S6D + r * 16 + h * 8 + c * 4,
               f.dd + n * (KB / 4) + h * (KB / 8) + bs / 8 + 2 * c,
               ok ? 4 : 0);
    } else if constexpr (A16) {
      const int pr = lane >> 2, c = lane & 3;
      const int r = pr / F::NARR, a = pr % F::NARR;
      if (pr < NP)                      // (a zero-fill still writes)
        mv_cp16(dst + S::PAY + lane * 16,
                static_cast<const char*>(f.arr(a)) +
                    ((size_t)(row0 + r) * KB + bs + 8 * c) * 2,
                row0 + r < N && bs + 8 * c < KB);
    } else {
      const int nb = min(32, b1 - bs);
      const int pr = lane % NP, r = pr / F::NARR, a = pr % F::NARR;
      const int n = row0 + r;
      const char* base = static_cast<const char*>(f.arr(a));
      const uintptr_t A = (uintptr_t)base + ((size_t)n * KB + bs) * 2;
      const uintptr_t W = A & ~(uintptr_t)3;
      const int words = n < N ? (int)((A - W + 2 * nb + 3) / 4) : 0;
      const uintptr_t end = (uintptr_t)base + scale_end;
      for (int i = lane / NP; i < MV_SW; i += 32 / NP) {
        const uintptr_t w = W + 4 * i;
        const int bytes = i < words ? (int)min((uintptr_t)4, end - w) : 0;
        mv_cp4(dst + S::PAY + (pr * MV_SW + i) * 4,
               bytes ? reinterpret_cast<const void*>(w) : base, bytes);
      }
    }
  };

  // x into shared memory, then the first steps, all in flight at once (x
  // is the oldest cp.async group, so it can be waited for alone)
  if (((uintptr_t)x & 15) == 0) {
    for (int i = threadIdx.x; i < K / 4; i += blockDim.x)
      mv_cp16(mv_smem_u32(xs + (i >> 3) * MV_XPAD + (i & 7) * 4), x + 4 * i,
              true);
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      xs[(i >> 5) * MV_XPAD + (i & 31)] = x[i];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int irow0 = (int)blockIdx.x * TR + g * MV_R, ist = 0;
#pragma unroll
  for (int s = 0; s < MV_STAGES - 1; ++s) {
    if (s < items) {
      issue(irow0, ist, s);
      if (++ist == nst) ist = 0, irow0 += row_step;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(MV_STAGES - 1) : "memory");
  __syncthreads();
  for (int b = threadIdx.x; b < KB; b += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += xs[b * MV_XPAD + j];
    xsum[b] = s;
  }
  __syncthreads();

  float acc[MV_R];
#pragma unroll
  for (int r = 0; r < MV_R; ++r) acc[r] = 0.f;
  int row0 = (int)blockIdx.x * TR + g * MV_R, st = 0;
  for (int j = 0; j < items; ++j) {
    // step j landed (my copies; x and the items before it are older
    // groups), and every lane is past step j - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(MV_STAGES - 2) : "memory");
    __syncwarp();
    if (j + MV_STAGES - 1 < items) {
      issue(irow0, ist, (j + MV_STAGES - 1) % MV_STAGES);
      if (++ist == nst) ist = 0, irow0 += row_step;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const unsigned char* stg = ring + (j % MV_STAGES) * S::BYTES;
    const int bs = b0 + st * 32, b = bs + lane;
    if (b < b1) {
      const float4* xb = reinterpret_cast<const float4*>(xs + b * MV_XPAD);
      uint4 q[MV_R];
#pragma unroll
      for (int r = 0; r < MV_R; ++r)
        q[r] = *reinterpret_cast<const uint4*>(stg + r * 512 + lane * 16);
      float dot[MV_R];
#pragma unroll
      for (int r = 0; r < MV_R; ++r) dot[r] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 xl = xb[t], xh = xb[4 + t];
#pragma unroll
        for (int r = 0; r < MV_R; ++r) {
          const uint32_t w = t == 0   ? q[r].x
                             : t == 1 ? q[r].y
                             : t == 2 ? q[r].z
                                      : q[r].w;
          dot[r] = mv_word(w, xl, xh, dot[r], e);
        }
      }
      const float xsb = xsum[b];
      if constexpr (F::S6) {
        const int8_t* sb = reinterpret_cast<const int8_t*>(stg + S::PAY);
        const unsigned short* dw =
            reinterpret_cast<const unsigned short*>(stg + S::S6D);
#pragma unroll
        for (int r = 0; r < MV_R; ++r) {
          float sc, mn;
          F::from(sb[r * 64 + lane], sb[r * 64 + 32 + lane],
                  dw[r * 8 + (lane >> 3)], dw[r * 8 + 4 + (lane >> 3)], sc,
                  mn);
          acc[r] += sc * dot[r] - mn * xsb;
        }
      } else {
        const unsigned short* sw =
            reinterpret_cast<const unsigned short*>(stg + S::PAY);
#pragma unroll
        for (int r = 0; r < MV_R; ++r) {
          uint16_t raw[2] = {0, 0};
#pragma unroll
          for (int a = 0; a < F::NARR; ++a) {
            if constexpr (A16) {
              raw[a] = sw[(r * F::NARR + a) * 32 + lane];
            } else {
              const uintptr_t A =
                  (uintptr_t)f.arr(a) + ((size_t)(row0 + r) * KB + bs) * 2;
              raw[a] = sw[(r * F::NARR + a) * MV_SW * 2 + ((A >> 1) & 1) +
                          lane];
            }
          }
          float sc, mn;
          F::scale_min(raw[0], raw[1], sc, mn);
          acc[r] += sc * dot[r] - mn * xsb;
        }
      }
    }
    if (st == nst - 1) {                // the tile's rows are summed
#pragma unroll
      for (int r = 0; r < MV_R; ++r) acc[r] = warp_sum(acc[r]);
      if (splits == 1) {
#pragma unroll
        for (int r = 0; r < MV_R; ++r)
          if (lane == r && row0 + r < N) y[row0 + r] = acc[r];
      } else {
        const int buf = (j / nst) & 1;
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < MV_R; ++r) part[buf][warp][r] = acc[r];
        }
        // the group's warps: partials in, then its first warp folds them
        asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(splits * 32)
                     : "memory");
        if (sp == 0 && lane < MV_R && row0 + lane < N) {
          float t = part[buf][warp][lane];
          for (int s = 1; s < splits; ++s) t += part[buf][warp + s][lane];
          y[row0 + lane] = t;
        }
      }
#pragma unroll
      for (int r = 0; r < MV_R; ++r) acc[r] = 0.f;
      st = 0;
      row0 += row_step;
    } else {
      ++st;
    }
  }
}

template <class F, bool A16>
static int q4_matvec_launch(const float* x, const uint8_t* qs, F f, float* y,
                            int N, int K, int splits, cudaStream_t stream) {
  static GridCap cap;
  const int smem = mv_smem_bytes<F, A16>(K / 32);
  int per_sm = 0;
  cudaError_t e = resident_ctas(q4_matvec_kernel<F, A16>, MV_WARPS * 32,
                                smem, &cap, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const int TR = MV_WARPS / splits * MV_R;
  int grid = (N + TR - 1) / TR;
  const int most = (per_sm < MV_CTAS_PER_SM ? per_sm : MV_CTAS_PER_SM) *
                   cap.sms;
  if (grid > most) grid = most;
  q4_matvec_kernel<F, A16><<<grid, MV_WARPS * 32, smem, stream>>>(
      x, qs, f, y, N, K, splits, 0x4B000000u);
  return (int)cudaGetLastError();
}

// the 16-byte scale path where K / 32 is a multiple of 8 and every scale
// array starts on 16 bytes (then every row's run of a step does)
template <class F>
static int q4_matvec(const float* x, const uint8_t* qs, F f, float* y, int N,
                     int K, int splits, void* stream) {
  const int KB = K / 32;
  if (K % 32 || N < 1 || KB < 1 || splits < 1 || MV_WARPS % splits ||
      splits > (KB % 8 ? KB : KB / 8))        // no split may be empty
    return (int)cudaErrorInvalidValue;
  bool a16 = KB % 8 == 0;
  for (int a = 0; a < F::NARR; ++a)
    a16 = a16 && ((uintptr_t)f.arr(a) & 15) == 0;
  return a16 ? q4_matvec_launch<F, true>(x, qs, f, y, N, K, splits,
                                         (cudaStream_t)stream)
             : q4_matvec_launch<F, false>(x, qs, f, y, N, K, splits,
                                          (cudaStream_t)stream);
}

GCT_EXPORT int q4k_matvec(const float* x, const uint8_t* qs, const bf16* es,
                          const bf16* em, float* y, int N, int K, int splits,
                          void* stream) {
  return q4_matvec(x, qs, Q4K{es, em}, y, N, K, splits, stream);
}

// s6: K % 4096 == 0 (splits start on 16 blocks), sm on 16 bytes, dd on 4
GCT_EXPORT int q4k_s6_matvec(const float* x, const uint8_t* qs,
                             const int8_t* sm, const bf16* dd, float* y,
                             int N, int K, int splits, void* stream) {
  if (K % 4096 || N < 1 || splits < 1 || MV_WARPS % splits ||
      ((uintptr_t)sm & 15) || ((uintptr_t)dd & 3))
    return (int)cudaErrorInvalidValue;
  return q4_matvec_launch<Q4KS6, true>(x, qs, Q4KS6{sm, dd}, y, N, K, splits,
                                       (cudaStream_t)stream);
}

GCT_EXPORT int q40_matvec(const float* x, const uint8_t* qs, const __half* d,
                          float* y, int N, int K, int splits, void* stream) {
  return q4_matvec(x, qs, Q40{d}, y, N, K, splits, stream);
}

// registers, shared memory and occupancy of the 16-byte scale instance at
// this K (kernel_info); fmt 0 Q4_K, 1 Q4_0, 2 Q4_K s6
GCT_EXPORT int q4_matvec_info(int fmt, int K, int* out) {
  if (fmt == 2)
    return kernel_info(q4_matvec_kernel<Q4KS6, true>, MV_WARPS * 32,
                       mv_smem_bytes<Q4KS6, true>(K / 32), out);
  return fmt ? kernel_info(q4_matvec_kernel<Q40, true>, MV_WARPS * 32,
                           mv_smem_bytes<Q40, true>(K / 32), out)
             : kernel_info(q4_matvec_kernel<Q4K, true>, MV_WARPS * 32,
                           mv_smem_bytes<Q4K, true>(K / 32), out);
}

GCT_EXPORT const char* kernels_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
