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
//   Bound on the H100: bytes. A row is 1.0625 K bytes: the 7B w_gu
//   [24576, 4096] is 107.0 MB (31.9 us at 3.35 TB/s), the head [32000,
//   4096] 139.3 MB, against 16 KB of x.
//
//   Design: q4k_matmul.cu's persistent grid, on the tensor cores. A warp
//   takes Q8_R = 2 rows at once and 64 blocks of each a step (2 x 2 KB of
//   payload, contiguous in each row), streamed through its own ring of
//   `stages` steps in shared memory by cp.async, stages - 1 steps ahead of
//   its math. x is copied in by cp.async beside the first steps, then
//   rounded to bf16 once, in place, and zero-padded by a step. Rows too few
//   to fill the card are split over 1-8 warps of one CTA
//   (ops/quant_matmul.py::q80_plan, a function of N, K and the SM count,
//   passed in with the stage count and the grid); split s takes blocks
//   [s KB / S, (s + 1) KB / S) in groups of 8 blocks where KB allows, the
//   warps of a row group meet at a named barrier and the group's first warp
//   adds their sums in split order. No atomics: two calls give the same
//   bits.
//
//   The products run on mma.sync m16n8k16 (bf16 in, f32 accumulation),
//   weight as A: the 16 rows of A are the warp's 2 rows x 8 segments of 8
//   blocks of the step, B's column s segment s of x, and C[r + 2 s][s] row
//   r's sum over segment s. Lane (g, t) (g = lane / 4, t = lane % 4) holds
//   row g % 2 of segments g / 2 and g / 2 + 4 and x of segment g, blocks t
//   and t + 4 of each segment; its 16-byte chunks are read in an order
//   rotated by t / 2 (the same for weight and x, so their k slots still
//   meet), which with a row stride of 2,112 bytes, and 16 bytes of pad
//   after each 8 blocks of x, keeps its shared-memory reads free of bank
//   conflicts. An element costs a PRMT and an FFMA for q * d (the byte under
//   the exponent bits of 0x47000000 is 2^15 + q + 128 after the XOR, and
//   32896 d is exact in f32, so fma(f, d, -32896 d) is q * d exactly), half
//   an F2F to bf16x2 (round to nearest even, as the reference) and a quarter
//   of the word's XOR; the multiply-add is an eighth of an HMMA
//   (tools/sass_loop.py counts them; PERF.md).
//
//   Shared memory a CTA (8 warps): x, max(4 K, 64 (K/32 + 64) + pad) bytes,
//   and 8 rings of `stages` x 4,496 bytes (a step's payload, 2 rows of
//   2,112, and its scales). Two stages and two CTAs an SM where both fit (K
//   up to 8,192: 88 KB a CTA at K 4,096, 94 KB at 5,632), else three stages
//   and one CTA (157 KB at K 12,288), else two (K to ~40,000): 16 or 8
//   warps an SM, ~70 KB of weight in flight an SM either way (35 KB past K
//   ~31,000). On an H100 (PERF.md) three and four stages at one CTA an SM
//   (8 warps, 70 and 104 KB in flight) ran every 7B linear within a few
//   percent of two at two CTAs, and 4-row warps of 1 KB a row a step a
//   little slower than these.
#include "quant_formats.cuh"

constexpr int Q8_WARPS = 8;
constexpr int Q8_R = 2;            // rows a warp takes at once
constexpr int Q8_SB = 64;          // blocks a step: 8 segments of 8
constexpr int Q8_ROW = 2112;       // a row's 64 blocks in a stage (+64 pad)
constexpr int Q8_PAY = Q8_R * Q8_ROW;
constexpr int Q8_SW = 33;          // scale words a row a step (65 halves)
constexpr int Q8_STAGE = (Q8_PAY + Q8_R * Q8_SW * 4 + 15) / 16 * 16;  // 4,496

// byte of bf16 x's block b in shared memory: 16 bytes of pad after every 8
// blocks, so that neighbouring segments' reads miss each other's banks
__host__ __device__ constexpr int q8_xoff(int b) { return 64 * b + 16 * (b >> 3); }

// dynamic shared memory: x (f32 staging, then bf16 with 64 zero blocks
// after K), then the warps' rings
__host__ __device__ constexpr int q8_x_bytes(int KB) {
  return ((KB * 128 > q8_xoff(KB + Q8_SB) ? KB * 128 : q8_xoff(KB + Q8_SB)) +
          15) / 16 * 16;
}

__host__ __device__ constexpr int q8_smem_bytes(int KB, int stages) {
  return q8_x_bytes(KB) + Q8_WARPS * stages * Q8_STAGE;
}

__device__ __forceinline__ unsigned q8_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes (src_size 0 or 16), the L2 asked to fetch 256
// bytes at a miss: the stream ran ~1.5 points of HBM faster in bench.py's
// size marginal on an H100 (PERF.md)
__device__ __forceinline__ void q8_cp16(unsigned dst, const void* src,
                                        bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void q8_cp4(unsigned dst, const void* src,
                                       int src_size) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_size)
               : "memory");
}

// q * d of byte SEL of v (already XOR 0x80808080): the byte under the
// exponent bits of e = 0x47000000 is 2^15 + q + 128, c2 = -32896 d. e is a
// kernel argument so that the selector stays the instruction's immediate.
template <int SEL>
__device__ __forceinline__ float q8_qd(uint32_t v, uint32_t e, float d,
                                       float c2) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(f)
      : "r"(v), "r"(e), "n"(0x7404 | (SEL << 4)));
  return fmaf(__uint_as_float(f), d, c2);
}

__device__ __forceinline__ uint32_t q8_pack(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// c += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulation
__device__ __forceinline__ void q8_mma(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t q8_word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the first block of split s of S over KB blocks: whole groups of 8 blocks
// where KB allows (ops/quant_matmul.py::matvec_blocks)
__device__ __forceinline__ int q8_split_start(int s, int S, int KB) {
  const int u = KB % 8 ? 1 : 8;
  return u * (s * (KB / u) / S);
}

// grid: row tiles of (Q8_WARPS / splits) * Q8_R rows, walked by every CTA.
// A16: K a multiple of 256 and d on 16 bytes (a row's scales of a segment
// are one 16-byte cp.async); else 4-byte words, the first half's place
// given by the address.
template <bool A16, int STAGES>
__global__ void __launch_bounds__(Q8_WARPS * 32, STAGES == 2 ? 2 : 1)
q80_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                  const __half* __restrict__ d, float* __restrict__ y, int N,
                  int K, int splits, uint32_t e) {
  extern __shared__ __align__(16) unsigned char q8_smem[];
  __shared__ float part[2][Q8_WARPS][Q8_R];
  const int KB = K / 32;
  float* xs = reinterpret_cast<float*>(q8_smem);
  const unsigned char* xb = q8_smem;               // bf16 x, after rounding

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = q8_smem + q8_x_bytes(KB) + warp * STAGES * Q8_STAGE;
  const int g = warp / splits, sp = warp % splits;
  const int b0 = q8_split_start(sp, splits, KB);
  const int b1 = q8_split_start(sp + 1, splits, KB);
  const int nst = (b1 - b0 + Q8_SB - 1) / Q8_SB;  // steps of my split
  const int TR = Q8_WARPS / splits * Q8_R;
  const int tiles = (N + TR - 1) / TR;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int items = mine * nst;         // (tile, step) pairs of this warp
  const int row_step = (int)gridDim.x * TR;

  // copy item (row0, st) into ring stage `stage`: the payload (lane l takes
  // 16-byte chunks l, l + 32, l + 64 and l + 96 of each row), then the
  // rows' scales
  auto issue = [&](int row0, int st, int stage) {
    const unsigned dst = q8_smem_u32(ring + stage * Q8_STAGE);
    const int bs = b0 + st * Q8_SB;
    const uint8_t* src = qs + (size_t)row0 * K + (size_t)bs * 32 + lane * 16;
    const int rows = N - row0;                // rows of the group there
    bool ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) ok[q] = bs + 16 * q + (lane >> 1) < b1;
#pragma unroll
    for (int r = 0; r < Q8_R; ++r) {          // (src-size 0 reads nothing)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        q8_cp16(dst + r * Q8_ROW + q * 512 + lane * 16, src + q * 512,
                r < rows && ok[q]);
      src += K;
    }
    if constexpr (A16) {
      if (lane < 8 * Q8_R) {            // (a zero-fill still writes)
        const int r = lane >> 3, c = lane & 7;
        q8_cp16(dst + Q8_PAY + r * 128 + c * 16,
                d + (size_t)(row0 + r) * KB + bs + 8 * c,
                r < rows && bs + 8 * c < b1);
      }
    } else {
      const int nb = min(Q8_SB, b1 - bs);
      const int r = lane & 1, n = row0 + r;
      const uintptr_t base = reinterpret_cast<uintptr_t>(d);
      const uintptr_t A = base + ((size_t)n * KB + bs) * 2;
      const uintptr_t W = A & ~(uintptr_t)3;
      const int words = n < N ? (int)((A - W + 2 * nb + 3) / 4) : 0;
      const uintptr_t end = base + (size_t)N * KB * 2;
      for (int i = lane >> 1; i < Q8_SW; i += 16) {
        const uintptr_t w = W + 4 * i;
        const int bytes = i < words ? (int)min((uintptr_t)4, end - w) : 0;
        q8_cp4(dst + Q8_PAY + (r * Q8_SW + i) * 4,
               reinterpret_cast<const void*>(bytes ? w : base), bytes);
      }
    }
  };

  // x into shared memory, then the first steps, all in flight at once (x
  // is the oldest cp.async group, so it can be waited for alone)
  if (((uintptr_t)x & 15) == 0) {
    for (int i = threadIdx.x; i < K / 4; i += blockDim.x)
      q8_cp16(q8_smem_u32(xs + 4 * i), x + 4 * i, true);
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x) xs[i] = x[i];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int irow0 = (int)blockIdx.x * TR + g * Q8_R, ist = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < items) {
      issue(irow0, ist, s);
      if (++ist == nst) ist = 0, irow0 += row_step;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
  __syncthreads();
  // bf16(x) in place: float4 i becomes 8 bytes at q8_xoff's place for its
  // elements. A round reads all of its float4s before any is written, and
  // writes only below what the next round reads.
  {
    constexpr int U = 4, RND = U * Q8_WARPS * 32;
    const int n4 = K / 4;
    for (int r0 = 0; r0 < n4; r0 += RND) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = r0 + u * Q8_WARPS * 32 + threadIdx.x;
        if (i < n4) v[u] = reinterpret_cast<const float4*>(xs)[i];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = r0 + u * Q8_WARPS * 32 + threadIdx.x;
        if (i < n4)
          *reinterpret_cast<uint2*>(q8_smem + 8 * i + 16 * (i >> 6)) =
              make_uint2(q8_pack(v[u].x, v[u].y), q8_pack(v[u].z, v[u].w));
      }
    }
    // Q8_SB zero blocks after K: a split's last step reads x up to
    // Q8_SB - 1 blocks past its end, against zero-filled weights
    for (int i = q8_xoff(KB) / 16 + threadIdx.x; i < q8_xoff(KB + Q8_SB) / 16;
         i += blockDim.x)
      reinterpret_cast<uint4*>(q8_smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // lane (gq, t): A rows (row r, segments s1 and s1 + 4), B x of segment
  // gq, blocks t and t + 4 of a segment; its chunks in an order rotated by
  // tr (see the header)
  const int t = lane & 3, gq = lane >> 2;
  const int r = gq & 1, s1 = gq >> 1, tr = t >> 1;
  const int woff = r * Q8_ROW + s1 * 256 + t * 32;     // + 1024 for s1 + 4
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int row0 = (int)blockIdx.x * TR + g * Q8_R, st = 0;
  for (int j = 0; j < items; ++j) {
    // step j landed (my copies; x and the items before it are older
    // groups), and every lane is past step j - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncwarp();
    if (j + STAGES - 1 < items) {
      issue(irow0, ist, (j + STAGES - 1) % STAGES);
      if (++ist == nst) ist = 0, irow0 += row_step;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const unsigned char* stg = ring + (j % STAGES) * Q8_STAGE;
    const int bs = b0 + st * Q8_SB;
    const unsigned short* sw =
        reinterpret_cast<const unsigned short*>(stg + Q8_PAY);
    int so = A16 ? r * Q8_SB : r * 2 * Q8_SW;   // row r's first half
    if (!A16)
      so += (int)((((uintptr_t)d >> 1) + (size_t)(row0 + r) * KB + bs) & 1);
    float c[2][4] = {};
#pragma unroll
    for (int bsel = 0; bsel < 2; ++bsel) {
      const int blk = t + 4 * bsel;            // block of a segment
      const float da = __half2float(__ushort_as_half(sw[so + 8 * s1 + blk]));
      const float db =
          __half2float(__ushort_as_half(sw[so + 8 * (s1 + 4) + blk]));
      const float ca = -32896.f * da, cb = -32896.f * db;
      const unsigned char* xp = xb + q8_xoff(bs + 8 * gq + blk);
      uint4 xv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        xv[ii] = *reinterpret_cast<const uint4*>(xp + 16 * ((ii + 2 * tr) & 3));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const unsigned char* wp = stg + woff + bsel * 128 + 16 * (hh ^ tr);
        const uint4 wa = *reinterpret_cast<const uint4*>(wp);
        const uint4 wb = *reinterpret_cast<const uint4*>(wp + 1024);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t va = q8_word(wa, jj) ^ 0x80808080u;
          const uint32_t vb = q8_word(wb, jj) ^ 0x80808080u;
          const uint4& xq = xv[2 * hh + (jj >> 1)];
          q8_mma(c[hh],
                 q8_pack(q8_qd<0>(va, e, da, ca), q8_qd<1>(va, e, da, ca)),
                 q8_pack(q8_qd<0>(vb, e, db, cb), q8_qd<1>(vb, e, db, cb)),
                 q8_pack(q8_qd<2>(va, e, da, ca), q8_qd<3>(va, e, da, ca)),
                 q8_pack(q8_qd<2>(vb, e, db, cb), q8_qd<3>(vb, e, db, cb)),
                 jj & 1 ? xq.z : xq.x, jj & 1 ? xq.w : xq.y);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += c[0][i] + c[1][i];
    if (st == nst - 1) {                // the tile's rows are summed
      // C[gq][s1] (segment s1 of row r) sits in lane t = s1 / 2, C[gq +
      // 8][s1 + 4] (segment s1 + 4) in lane t = s1 / 2 + 2, odd columns in
      // the second register of the pair
      const int odd = s1 & 1;
      float v = t == s1 >> 1         ? (odd ? acc[1] : acc[0])
                : t == (s1 >> 1) + 2 ? (odd ? acc[3] : acc[2])
                                     : 0.f;
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      // lane 4 r (r < 2) holds row r's sum
      if (splits == 1) {
        if (t == 0 && gq < Q8_R && row0 + gq < N) y[row0 + gq] = v;
      } else {
        const int buf = (j / nst) & 1;
        if (t == 0 && gq < Q8_R) part[buf][warp][gq] = v;
        // the group's warps: partials in, then its first warp folds them
        asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(splits * 32)
                     : "memory");
        if (sp == 0 && lane < Q8_R && row0 + lane < N) {
          float s = part[buf][warp][lane];
          for (int k = 1; k < splits; ++k) s += part[buf][warp + k][lane];
          y[row0 + lane] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = 0.f;
      st = 0;
      row0 += row_step;
    } else {
      ++st;
    }
  }
}

template <bool A16, int STAGES>
static int q80_launch(const float* x, const uint8_t* qs, const __half* d,
                      float* y, int N, int K, int splits, int grid,
                      cudaStream_t stream) {
  static int granted = 0;
  const int smem = q8_smem_bytes(K / 32, STAGES);
  cudaError_t e =
      allow_smem(q80_matvec_kernel<A16, STAGES>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  q80_matvec_kernel<A16, STAGES><<<grid, Q8_WARPS * 32, smem, stream>>>(
      x, qs, d, y, N, K, splits, 0x47000000u);
  return (int)cudaGetLastError();
}

// splits, stages and grid from ops/quant_matmul.py::q80_plan
GCT_EXPORT int q80_matvec(const float* x, const uint8_t* qs, const __half* d,
                          float* y, int N, int K, int splits, int stages,
                          int grid, void* stream) {
  const int KB = K / 32;
  if (K % 32 || N < 1 || KB < 1 || splits < 1 || Q8_WARPS % splits ||
      splits > (KB % 8 ? KB : KB / 8) ||      // no split may be empty
      (stages != 2 && stages != 3) || grid < 1 ||
      q8_smem_bytes(KB, stages) + (int)sizeof(float) * 2 * Q8_WARPS * Q8_R >
          232448)
    return (int)cudaErrorInvalidValue;
  const bool a16 = KB % 8 == 0 && ((uintptr_t)d & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (stages == 2)
    return a16 ? q80_launch<true, 2>(x, qs, d, y, N, K, splits, grid, s)
               : q80_launch<false, 2>(x, qs, d, y, N, K, splits, grid, s);
  return a16 ? q80_launch<true, 3>(x, qs, d, y, N, K, splits, grid, s)
             : q80_launch<false, 3>(x, qs, d, y, N, K, splits, grid, s);
}

// registers, shared memory and occupancy of the 16-byte scale instance of
// `stages` stages at this K (kernel_info)
GCT_EXPORT int q80_matvec_info(int K, int stages, int* out) {
  const int smem = q8_smem_bytes(K / 32, stages);
  return stages == 2
             ? kernel_info(q80_matvec_kernel<true, 2>, Q8_WARPS * 32, smem,
                           out)
             : kernel_info(q80_matvec_kernel<true, 3>, Q8_WARPS * 32, smem,
                           out);
}
