// Q4_K-E, Q4_K "s6", Q4_0 and Q8_0 dequantizing GEMM for Hopper (sm_90a).
//
// q4k_gemm / q4k_s6_gemm / q40_gemm / q80_gemm (two route templates, four
// format instances each) replace ggml_cuda_experiments_tpu/ops/quant_matmul.py's
// _mxu_kernel (:1154), _pipe_sub_kernel (:1084) and _pipe_kernel (:1115):
//   y[M, N] f32 = sum_K bf16(x) . bf16(deq(W)), f32 accumulation,
// deq(W) = q * scale - min per 32-block through the format's trait
// (quant_formats.cuh), computed as fma(q, scale, -min) in f32: q * scale is
// exact, so this is the reference's dequantize bit for bit.
//
// Both routes compute y^T = deq(W) . x^T: the weight rows fill the 16 / 64
// rows of the tensor-core instruction and the tokens its n side. A thread
// dequantizes its A fragment in registers from the packed bytes: thread
// (g, t) of a warp reads bytes 2t, 2t+1, 2t+8, 2t+9 of a block row (rows g
// and g + 8); their low nibbles are its m16n8k16 A fragment of the block's
// k 0-15 and their high nibbles that of k 16-31, since the planar packing
// puts element j in the low and j + 16 in the high nibble of byte j. Q8_0
// reads bytes 0-15 and 16-31 the same way. wgmma's register-A fragment is
// that layout in each warp of the warpgroup, so both routes share it. A
// code becomes a float through PRMT into 2^23 + code, one FADD, one FFMA
// with the block's scale and min, and half a cvt.rn.bf16x2.f32.
//
// Every operand arrives through a cp.async ring in shared memory (W's
// bytes, x, and the rows' scale words: a row's scales for a stage are
// copied as the aligned 16-byte chunks that hold them, since a scale row
// need not start on 16 bytes). Ragged N, M and K (a last stage
// past K / 32 blocks, K % 64 == 32 included) are zero-filled, and a block
// past K gets scale = min = 0. Every sum runs in a fixed order and nothing
// is atomic: the output is bitwise the same across calls and graph replays.
//
// Route 0, "stream" (M <= 32; ops/quant_matmul.py::gemm_route picks it to
// 32 rows). Bound by W's bytes. mma.sync m16n8k16 with x (all M tokens, 8
// a tile) as B from padded shared memory, the k slots of each step
// permuted so that a thread reads one word of a block row and one 8-byte
// word of x. A CTA owns 32 weight rows (64 where N still gives two waves of
// them: half the re-reads of x from L2); its 8 warps are row slices of 16
// x K slices of each 512-k stage, folded in shared memory in index order;
// a ~110 KB ring (two CTAs an SM) keeps 1-4 stages in flight.
// Route 1, "tc" (the rest, to any M): wgmma m64nBNk16, BN = 64, 128 or 256
// tokens a CTA, A (the dequantized W) from registers and B (x) from
// 128-byte-swizzled shared memory. A CTA owns 128 weight rows (two
// warpgroups of 64) x BN tokens, so M = 512 dequantizes each weight twice.
// x arrives in 64-k stages through a 4-stage ring, W in stages of 256 bytes
// a row (double-buffered: short runs a row starve HBM), A double-buffered so
// that a stage's dequantization overlaps the previous stage's wgmma. The
// tile is staged in shared memory for coalesced stores. The grid's fast
// index is the token tile, so the CTAs sharing a weight tile run together
// and W streams from HBM once. Its kernel takes a phase (TC_ALL in
// production): measurement-only variants without the wgmma, without the
// dequantization, or with neither (q4k_gemm_phase; tools/profile_decode.py
// --pipe prices the phases with them).
// The tc route splits K over 2 CTAs of a thread-block cluster where its
// row tiles alone would fill less than 3/4 of the card (the 7B's N = 4096
// and 12288): the ranks' partials are added through distributed shared
// memory in rank order, so the launch stays one and needs no workspace. The split is a function of N and K alone, so that every M
// sums an output in one order. The stream route does not split (a split
// saved at most 3 us at the 7B's N = 4096 shapes).
//
// s6 (q4k_s6_gemm, K % 4096 == 0): both routes' stages are 16 blocks, two
// superblocks, so a row's scale bytes of a stage are 16 of sc, 16 of mn
// (two aligned runs K / 32 bytes apart) and the two superblocks' bf16 d
// and dmin (two 4-byte words). They are copied as they are into a
// 48-byte row of shared memory (load_scales_s6), the pitch the raw scale
// words of the other formats take, and a thread decodes f32(d) * sc and
// f32(dmin) * mn of its block there (block_scales_s6): the weight is never
// expanded to Q4_K-E in device memory.

#include <cooperative_groups.h>
#include <stdint.h>

#include "quant_formats.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GT = 256;                 // threads a CTA, both routes

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// bf16x2 of (code(i) - off) * s + nm and (code(i + 1) - off) * s + nm,
// code(i) the unsigned byte i of v (the lower k in the low half)
template <class F, int I>
__device__ __forceinline__ uint32_t deq2(uint32_t v, float s, float nm) {
  const float a =
      __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u + I)) - F::QOFF;
  const float b =
      __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441u + I)) - F::QOFF;
  __nv_bfloat162 h = __floats2bfloat162_rn(fmaf(a, s, nm), fmaf(b, s, nm));
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragments from codes c[row][k half] (4 codes each: the register's two
// bf16 pairs) and the rows' scales and mins
template <class F>
__device__ __forceinline__ void frags(const uint32_t (&c)[2][2],
                                      const float (&s)[2],
                                      const float (&m)[2], uint32_t (&lo)[4],
                                      uint32_t (&hi)[4]) {
  const float n0 = -m[0], n1 = -m[1];
  lo[0] = deq2<F, 0>(c[0][0], s[0], n0);
  lo[1] = deq2<F, 0>(c[1][0], s[1], n1);
  lo[2] = deq2<F, 2>(c[0][0], s[0], n0);
  lo[3] = deq2<F, 2>(c[1][0], s[1], n1);
  hi[0] = deq2<F, 0>(c[0][1], s[0], n0);
  hi[1] = deq2<F, 0>(c[1][1], s[1], n1);
  hi[2] = deq2<F, 2>(c[0][1], s[0], n0);
  hi[3] = deq2<F, 2>(c[1][1], s[1], n1);
}

// The m16n8k16 A fragments of one 32-block for rows g (p0: the block's
// bytes in that row) and g + 8 (p1): lo = k 0-15, hi = k 16-31.
template <class F>
__device__ __forceinline__ void block_frags(const uint8_t* p0,
                                            const uint8_t* p1, int t,
                                            const float (&s)[2],
                                            const float (&m)[2],
                                            uint32_t (&lo)[4],
                                            uint32_t (&hi)[4]) {
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  const int w = 4 * (t >> 1);
  uint32_t c[2][2];                     // [row][k half]: 4 codes each
  if constexpr (F::QB == 16) {
    const uint32_t b0 = __byte_perm(lds32(p0 + w), lds32(p0 + 8 + w), sel);
    const uint32_t b1 = __byte_perm(lds32(p1 + w), lds32(p1 + 8 + w), sel);
    c[0][0] = b0 & 0x0F0F0F0Fu;
    c[0][1] = (b0 >> 4) & 0x0F0F0F0Fu;
    c[1][0] = b1 & 0x0F0F0F0Fu;
    c[1][1] = (b1 >> 4) & 0x0F0F0F0Fu;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* q0 = p0 + 16 * h + w;
      const uint8_t* q1 = p1 + 16 * h + w;
      c[0][h] = __byte_perm(lds32(q0), lds32(q0 + 8), sel) ^ F::QXOR;
      c[1][h] = __byte_perm(lds32(q1), lds32(q1 + 8), sel) ^ F::QXOR;
    }
  }
  frags<F>(c, s, m, lo, hi);
}

// The stream route's A fragments of one 32-block, with the k slots of each
// k16 step permuted (x is read the same way, so the product is unchanged):
// slots 2t, 2t+1 hold elements 4t, 4t+1 and slots 2t+8, 2t+9 elements
// 4t+2, 4t+3, so a thread reads one word of a block row, and its x one
// 8-byte word.
template <class F>
__device__ __forceinline__ void block_frags_perm(const uint8_t* p0,
                                                 const uint8_t* p1, int t,
                                                 const float (&s)[2],
                                                 const float (&m)[2],
                                                 uint32_t (&lo)[4],
                                                 uint32_t (&hi)[4]) {
  uint32_t c[2][2];                     // [row][k half]: 4 codes each
  if constexpr (F::QB == 16) {
    const uint32_t b0 = lds32(p0 + 4 * t), b1 = lds32(p1 + 4 * t);
    c[0][0] = b0 & 0x0F0F0F0Fu;
    c[0][1] = (b0 >> 4) & 0x0F0F0F0Fu;
    c[1][0] = b1 & 0x0F0F0F0Fu;
    c[1][1] = (b1 >> 4) & 0x0F0F0F0Fu;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[0][h] = lds32(p0 + 16 * h + 4 * t) ^ F::QXOR;
      c[1][h] = lds32(p1 + 16 * h + 4 * t) ^ F::QXOR;
    }
  }
  frags<F>(c, s, m, lo, hi);
}

// Scale and min of block j of a stage for the rows whose scale chunks sit
// at row0 / row1 (array 1 arr_stride bytes after array 0), lo: each
// row's byte offset into its first chunk; 0 and 0 past K / 32 blocks.
template <class F>
__device__ __forceinline__ void block_scales(const uint8_t* row0,
                                             const uint8_t* row1,
                                             int arr_stride,
                                             const unsigned (&lo)[2][2],
                                             int j, bool valid, float (&s)[2],
                                             float (&m)[2]) {
  const uint8_t* rows[2] = {row0, row1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint16_t a = lds16(rows[h] + lo[0][h] + 2 * j);
    const uint16_t b = F::NARR == 2
                           ? lds16(rows[h] + arr_stride + lo[1][h] + 2 * j)
                           : uint16_t(0);
    F::scale_min(a, b, s[h], m[h]);
    if (!valid) s[h] = m[h] = 0.f;
  }
}

// The 16-byte chunks that hold SB scale words from any 2-byte offset, and
// a row pitch of an odd number of chunks (rows g = 0..7 on distinct banks)
template <int SB>
struct ScaleRows {
  static constexpr int NCH = (2 * SB + 14) / 16 + 1;
  static constexpr int P = 16 * (NCH | 1);
};

// Copy the stage's scale words of rows n0 .. n0 + R - 1, blocks kb0 .. kb0 +
// SB - 1: per row and array the aligned 16-byte chunks that hold them (a
// chunk past the last word is not read), P bytes a row.
template <class F, int R, int SB, int P>
__device__ __forceinline__ void load_scales(uint8_t* dst, const F& f, int N,
                                            int KB, int n0, int kb0) {
  using SR = ScaleRows<SB>;
  static_assert(P >= 16 * SR::NCH, "a row's chunks must fit its pitch");
  const int nv = min(SB, KB - kb0);
  for (int i = threadIdx.x; i < F::NARR * R * SR::NCH; i += GT) {
    const int c = i % SR::NCH, r = (i / SR::NCH) % R;
    const int a = i / (SR::NCH * R), n = n0 + r;
    if (n >= N) continue;
    const uintptr_t at =
        reinterpret_cast<uintptr_t>(f.arr(a)) + 2 * ((size_t)n * KB + kb0);
    if (c > 0 && (int)(at & 15) + 2 * nv <= 16 * c) continue;
    cp_async16(smem_u32(dst + (a * R + r) * P + 16 * c),
               reinterpret_cast<const void*>((at & ~(uintptr_t)15) + 16 * c),
               true);
  }
}

// s6: a row's scale bytes of a stage of 16 blocks, S6_P bytes a row: sc
// [16] | mn [16] | the bf16 d, dmin of its 2 superblocks as 4-byte words
// [d0 d1 | dmin0 dmin1] | 8 bytes of pad (rows g = 0..7 on distinct banks)
constexpr int S6_P = 48;

template <class F, int R, int SB>
__device__ __forceinline__ void load_scales_s6(uint8_t* dst, const F& f,
                                               int N, int KB, int n0,
                                               int kb0) {
  static_assert(SB == 16, "an s6 stage is two superblocks");
  for (int i = threadIdx.x; i < 4 * R; i += GT) {
    const int r = i >> 2, c = i & 3, n = n0 + r;
    if (n >= N) continue;
    uint8_t* d = dst + r * S6_P;
    if (c < 2)
      cp_async16(smem_u32(d + 16 * c),
                 f.sm + (size_t)n * 2 * KB + c * KB + kb0, true);
    else
      cp_async4(smem_u32(d + 32 + 4 * (c - 2)),
                f.dd + (size_t)n * (KB / 4) + (c - 2) * (KB / 8) + kb0 / 8);
  }
}

// s6 scale and min of block j of a stage for rows row0 / row1 (their
// S6_P-byte rows); 0 and 0 past K / 32 blocks
__device__ __forceinline__ void block_scales_s6(const uint8_t* row0,
                                                const uint8_t* row1, int j,
                                                bool valid, float (&s)[2],
                                                float (&m)[2]) {
  const uint8_t* rows[2] = {row0, row1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint8_t* p = rows[h];
    Q4KS6::from((int8_t)p[j], (int8_t)p[16 + j], lds16(p + 32 + 2 * (j >> 3)),
                lds16(p + 36 + 2 * (j >> 3)), s[h], m[h]);
    if (!valid) s[h] = m[h] = 0.f;
  }
}

// Copy W's bytes of rows n0 .. n0 + R - 1, blocks kb0 .. kb0 + SB - 1, at
// row pitch P; rows past N and blocks past K / 32 zero-filled.
template <class F, int R, int SB, int P>
__device__ __forceinline__ void load_weights(uint8_t* dst, const uint8_t* qs,
                                             int N, int KB, int n0, int kb0) {
  constexpr int C = SB * F::QB / 16;    // chunks a row
  for (int i = threadIdx.x; i < R * C; i += GT) {
    const int r = i / C, c = i % C;
    const int n = n0 + r, kb = kb0 + c * 16 / F::QB;
    const bool ok = n < N && kb < KB;
    const uint8_t* src =
        ok ? qs + ((size_t)n * KB + kb0) * F::QB + 16 * c : qs;
    cp_async16(smem_u32(dst + r * P + 16 * c), src, ok);
  }
}

// each (row, array)'s byte offset into its first scale chunk at stage kb0
template <class F>
__device__ __forceinline__ void scale_offsets(const F& f, int KB, int n,
                                              unsigned (&base)[2][2]) {
  if constexpr (F::S6) {              // s6 rows start on their own bytes
    base[0][0] = base[0][1] = base[1][0] = base[1][1] = 0u;
  } else {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        base[a][h] = a < F::NARR
                         ? (unsigned)reinterpret_cast<uintptr_t>(f.arr(a)) +
                               2u * (unsigned)(n + 8 * h) * (unsigned)KB
                         : 0u;
  }
}

__device__ __forceinline__ void at_stage(const unsigned (&base)[2][2],
                                         int kb0, unsigned (&lo)[2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) lo[a][h] = (base[a][h] + 2u * kb0) & 15u;
}

__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------ route 0: stream

constexpr int ST_R = 32;                // weight rows a CTA; where N
constexpr int ST_R_WIDE = 64;           // gives 2 waves of these, these
constexpr int ST_SB = 16;               // 32-blocks a stage (512 k)
constexpr int ST_RING = 110 * 1024;     // ring bytes: two CTAs an SM
constexpr int ST_SP = ScaleRows<ST_SB>::P;
static_assert(ST_SP == S6_P, "s6 rows take the scale rows' pitch");

template <class F, int MT, int R>
struct StreamCfg {
  static constexpr int RG = R / 16;               // 16-row slices (warps)
  static constexpr int KG = 8 / RG;               // K slices (warps)
  static constexpr int WP = ST_SB * F::QB + 16;   // W row pitch
  static constexpr int XR = 8 * MT;               // token rows
  static constexpr int XP = ST_SB * 64 + 32;      // x row pitch (8-byte
                                                  // reads conflict-free)
  static constexpr int W = R * WP;
  static constexpr int S = F::NARR * R * ST_SP;
  static constexpr int STAGE = W + S + XR * XP;
  static constexpr int FIT = ST_RING / STAGE;
  static constexpr int NS = FIT < 2 ? 2 : FIT < 8 ? FIT : 8;
  static constexpr int SMEM = NS * STAGE;
  static constexpr int RP = R + 4;                // fold pitch (floats)
  static_assert(SMEM <= 227 * 1024, "stage too large");
  static_assert(KG * XR * RP * 4 <= SMEM, "fold must fit in the ring");
  static_assert(ST_SB % KG == 0, "a warp takes whole blocks");
};

template <class F, int MT, int R>
__device__ __forceinline__ void stream_load(uint8_t* st, const bf16* x,
                                            const uint8_t* qs, const F& f,
                                            int M, int N, int K, int n0,
                                            int kb0) {
  using C = StreamCfg<F, MT, R>;
  const int KB = K / 32;
  load_weights<F, R, ST_SB, C::WP>(st, qs, N, KB, n0, kb0);
  if constexpr (F::S6)
    load_scales_s6<F, R, ST_SB>(st + C::W, f, N, KB, n0, kb0);
  else
    load_scales<F, R, ST_SB, ST_SP>(st + C::W, f, N, KB, n0, kb0);
  constexpr int XC = ST_SB * 64 / 16;   // 16-byte chunks of a token row
  for (int i = threadIdx.x; i < C::XR * XC; i += GT) {
    const int r = i / XC, c = i % XC, k = kb0 * 32 + 8 * c;
    const bool ok = r < M && k < K;
    cp_async16(smem_u32(st + C::W + C::S + r * C::XP + 16 * c),
               ok ? x + (size_t)r * K + k : x, ok);
  }
}

// one stage of a warp: its K slice's blocks, each dequantized into the
// permuted A fragments and multiplied by every 8-token tile of x; FULL: no
// block of the stage lies past K / 32
template <class F, int MT, int R, bool FULL>
__device__ __forceinline__ void stream_stage(const uint8_t* S, int kb0,
                                             int KB, int kg, int r0, int g,
                                             int t,
                                             const unsigned (&sbase)[2][2],
                                             float (&acc)[MT][4]) {
  using C = StreamCfg<F, MT, R>;
  unsigned lo[2][2];
  at_stage(sbase, kb0, lo);
#pragma unroll
  for (int jj = 0; jj < ST_SB / C::KG; ++jj) {
    const int j = kg * (ST_SB / C::KG) + jj;
    float s[2], m[2];
    if constexpr (F::S6)
      block_scales_s6(S + C::W + r0 * ST_SP, S + C::W + (r0 + 8) * ST_SP, j,
                      FULL || kb0 + j < KB, s, m);
    else
      block_scales<F>(S + C::W + r0 * ST_SP, S + C::W + (r0 + 8) * ST_SP,
                      R * ST_SP, lo, j, FULL || kb0 + j < KB, s, m);
    uint32_t alo[4], ahi[4];
    block_frags_perm<F>(S + r0 * C::WP + j * F::QB,
                        S + (r0 + 8) * C::WP + j * F::QB, t, s, m, alo, ahi);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint8_t* xr =
          S + C::W + C::S + (8 * i + g) * C::XP + 64 * j + 8 * t;
      const uint2 b0 = *reinterpret_cast<const uint2*>(xr);
      const uint2 b1 = *reinterpret_cast<const uint2*>(xr + 32);
      mma16816(acc[i], alo, b0.x, b0.y);
      mma16816(acc[i], ahi, b1.x, b1.y);
    }
  }
}

template <class F, int MT, int R>
__global__ void __launch_bounds__(GT, 2)
gemm_stream_kernel(const bf16* __restrict__ x,
                   const uint8_t* __restrict__ qs, const F f,
                   float* __restrict__ y, int M, int N, int K) {
  using C = StreamCfg<F, MT, R>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int KB = K / 32, nst = (KB + ST_SB - 1) / ST_SB;
  const int n0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / C::RG, r0 = 16 * (warp % C::RG) + g;   // r0, r0 + 8
  unsigned sbase[2][2];
  scale_offsets(f, KB, n0 + r0, sbase);

#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < nst)
      stream_load<F, MT, R>(smem + s * C::STAGE, x, qs, f, M, N, K, n0,
                            s * ST_SB);
    cp_async_commit();
  }
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<C::NS - 2>();
    __syncthreads();                    // stage st landed; st - 1 consumed
    const int ls = st + C::NS - 1;
    if (ls < nst)
      stream_load<F, MT, R>(smem + (ls % C::NS) * C::STAGE, x, qs, f, M, N,
                            K, n0, ls * ST_SB);
    cp_async_commit();
    const uint8_t* sg = smem + (st % C::NS) * C::STAGE;
    const int kb0 = st * ST_SB;
    if (kb0 + ST_SB <= KB)
      stream_stage<F, MT, R, true>(sg, kb0, KB, kg, r0, g, t, sbase, acc);
    else
      stream_stage<F, MT, R, false>(sg, kb0, KB, kg, r0, g, t, sbase, acc);
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free
  // fold the K slices: red[kg][token][row]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float* p = red + (kg * C::XR + 8 * i + 2 * t) * C::RP + r0;
    p[0] = acc[i][0];
    p[C::RP] = acc[i][1];
    p[8] = acc[i][2];
    p[C::RP + 8] = acc[i][3];
  }
  __syncthreads();
  constexpr int KS = C::XR * C::RP;     // one K slice's floats
  for (int i = threadIdx.x; i < C::XR * R; i += GT) {
    const int tk = i / R, r = i % R;
    if (tk < M && n0 + r < N) {
      const float* p = red + tk * C::RP + r;
      float v = p[0];
#pragma unroll
      for (int h = 1; h < C::KG; ++h) v += p[h * KS];
      y[(size_t)tk * N + n0 + r] = v;
    }
  }
}

// ---------------------------------------------------------- route 1: tc

constexpr int TC_R = 128;               // weight rows a CTA: 2 warpgroups
constexpr int TC_SB = 2;                // 32-blocks an x stage (64 k)
constexpr int TC_NS = 4;                // x ring depth; loads 2 stages ahead
constexpr int TC_BN = 256;              // the widest token tile
constexpr int TC_WBYTES = 256;         // bytes of each row a W stage

// shared memory: the x ring (TC_NS stages of BN token rows x 128 bytes,
// 128-byte swizzle), then two W stages (TC_R rows x 256 bytes of W: WB
// 32-blocks, WS x stages; and the rows' scale chunks), so that W streams
// in runs of 256 bytes a row
template <class F, int BN>
struct TcCfg {
  static constexpr int WB = TC_WBYTES / F::QB;    // 32-blocks a W stage
  static constexpr int WS = WB / TC_SB;           // x stages a W stage
  static constexpr int SP = ScaleRows<WB>::P;     // scale row pitch
  static constexpr int X = BN * 128;              // 1024-byte multiple
  static constexpr int WP = WB * F::QB + 16;      // W row pitch
  static constexpr int W = TC_R * WP;
  static constexpr int S = F::NARR * TC_R * SP;
  static constexpr int WSTAGE = W + S;
  static constexpr int RING = TC_NS * X + 2 * WSTAGE;
  static constexpr int SMEM = RING + 1024;        // + alignment
  static constexpr int OP = TC_R + 4;             // epilogue pitch (floats)
  static_assert(X % 1024 == 0, "x stages must stay 1024-byte aligned");
  static_assert(BN * OP * 4 <= RING, "the epilogue must fit the ring");
  static_assert(SMEM <= 227 * 1024, "shared memory");
  static_assert(WS >= TC_NS - 2, "W stage ws + 1 must land before its use");
  static_assert(!F::S6 || SP == S6_P, "s6 rows take the scale rows' pitch");
};

#define GQ_F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// wgmma m64nBNk16, f32 += bf16 A (registers, this warp's 16 rows in the
// m16n8k16 layout) x bf16 B (K-major, 128-byte swizzle, descriptor db)
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : GQ_F8(0), GQ_F8(8), GQ_F8(16), GQ_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : GQ_F8(0), GQ_F8(8), GQ_F8(16), GQ_F8(24), GQ_F8(32), GQ_F8(40),
        GQ_F8(48), GQ_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : GQ_F8(0), GQ_F8(8), GQ_F8(16), GQ_F8(24), GQ_F8(32), GQ_F8(40),
        GQ_F8(48), GQ_F8(56), GQ_F8(64), GQ_F8(72), GQ_F8(80), GQ_F8(88),
        GQ_F8(96), GQ_F8(104), GQ_F8(112), GQ_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef GQ_F8

// keep the compiler from moving register reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle, K-major: 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// x stage `st` (64 k): BN token rows of 128 bytes, 16-byte chunk c of row
// r at chunk c ^ (r & 7)
template <int BN>
__device__ __forceinline__ void tc_load_x(uint8_t* dst, const bf16* x, int M,
                                          int K, int m0, int st) {
  for (int i = threadIdx.x; i < BN * 8; i += GT) {
    const int r = i >> 3, c = i & 7, m = m0 + r;
    const int k = st * TC_SB * 32 + 8 * c;
    const bool ok = m < M && k < K;
    cp_async16(smem_u32(dst + r * 128 + ((c ^ (r & 7)) << 4)),
               ok ? x + (size_t)m * K + k : x, ok);
  }
}

// W stage `ws`: the bytes and scale chunks of rows n0 .. n0 + 127
template <class F, int BN>
__device__ __forceinline__ void tc_load_w(uint8_t* dst, const uint8_t* qs,
                                          const F& f, int N, int KB, int n0,
                                          int ws) {
  using C = TcCfg<F, BN>;
  load_weights<F, TC_R, C::WB, C::WP>(dst, qs, N, KB, n0, ws * C::WB);
  if constexpr (F::S6)
    load_scales_s6<F, TC_R, C::WB>(dst + C::W, f, N, KB, n0, ws * C::WB);
  else
    load_scales<F, TC_R, C::WB, C::SP>(dst + C::W, f, N, KB, n0,
                                       ws * C::WB);
}

// The tc route's phases, a template argument of its kernel: TC_ALL is the
// production kernel; the others are measurement-only variants (q4_k only,
// q4k_gemm_phase) that price the phases of a stage apart and give wrong
// outputs. TC_DEQUANT skips the wgmma and folds the A registers into the
// accumulator with one XOR (so the dequantization is no dead code);
// TC_DOT skips the dequantization and runs the wgmma on the raw W words;
// TC_STREAM runs only the ring's copies. Every variant stages every byte
// of W, its scales and x.
constexpr int TC_ALL = 0, TC_DEQUANT = 1, TC_DOT = 2, TC_STREAM = 3;

// one x stage: dequantize this thread's A fragments (4 k16 steps) from W
// stage `wst` (blocks jb, jb + 1 of it, its first block kb0) into buffer a,
// then the warpgroup's 4 wgmma on x stage `xs`; leaves the group in flight
template <class F, int BN, int PH>
__device__ __forceinline__ void tc_stage(const uint8_t* xs,
                                         const uint8_t* wst, int kb0, int jb,
                                         int KB, int r0, int t,
                                         const unsigned (&sbase)[2][2],
                                         float (&acc)[BN / 2],
                                         uint32_t (&a)[4][4]) {
  using C = TcCfg<F, BN>;
  if constexpr (PH == TC_ALL || PH == TC_DEQUANT) {
    unsigned lo[2][2];
    at_stage(sbase, kb0, lo);
#pragma unroll
    for (int j = 0; j < TC_SB; ++j) {
      float s[2], m[2];
      if constexpr (F::S6)
        block_scales_s6(wst + C::W + r0 * C::SP,
                        wst + C::W + (r0 + 8) * C::SP, jb + j,
                        kb0 + jb + j < KB, s, m);
      else
        block_scales<F>(wst + C::W + r0 * C::SP,
                        wst + C::W + (r0 + 8) * C::SP, TC_R * C::SP, lo,
                        jb + j, kb0 + jb + j < KB, s, m);
      block_frags<F>(wst + r0 * C::WP + (jb + j) * F::QB,
                     wst + (r0 + 8) * C::WP + (jb + j) * F::QB, t, s, m,
                     a[2 * j], a[2 * j + 1]);
    }
  } else if constexpr (PH == TC_DOT) {
    // the raw words of the rows' blocks as A: no decode, no scales
#pragma unroll
    for (int j = 0; j < TC_SB; ++j) {
      const uint32_t w0 = lds32(wst + r0 * C::WP + (jb + j) * F::QB + 4 * t);
      const uint32_t w1 =
          lds32(wst + (r0 + 8) * C::WP + (jb + j) * F::QB + 4 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[2 * j + h][0] = a[2 * j + h][2] = w0;
        a[2 * j + h][1] = a[2 * j + h][3] = w1;
      }
    }
  }
  if constexpr (PH == TC_ALL || PH == TC_DOT) {
    const uint64_t db = sw128_desc(smem_u32(xs));
    fence_regs(acc);
    fence_regs(a);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, a[kk], db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(acc);
  } else if constexpr (PH == TC_DEQUANT) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc[kk] = __uint_as_float(__float_as_uint(acc[kk]) ^ a[kk][0] ^
                                a[kk][1] ^ a[kk][2] ^ a[kk][3]);
  }
}

template <class F, int BN, int PH>
__global__ void __launch_bounds__(GT, 1)
gemm_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ qs,
               const F f, float* __restrict__ y, int M, int N, int K) {
  using C = TcCfg<F, BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = ring + TC_NS * C::X;
  const int KB = K / 32, nst = (KB + TC_SB - 1) / TC_SB;
  const int nws = (KB + C::WB - 1) / C::WB;
  const int m0 = blockIdx.x * BN, n0 = blockIdx.y * TC_R;
  // this CTA's share of the W stages (and their x stages): rank blockIdx.z
  // of the cluster's gridDim.z K splits
  const int S = gridDim.z, rank = blockIdx.z;
  const int ws0 = rank * nws / S, ws1 = (rank + 1) * nws / S;
  const int st0 = ws0 * C::WS, st1 = min(nst, ws1 * C::WS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;         // rows r0, r0 + 8 (warpgroup warp / 4)
  unsigned sbase[2][2];
  scale_offsets(f, KB, n0 + r0, sbase);

  // groups: W stage 0 with x stage 0, then one a stage; W stage ws + 1 is
  // copied with x stage WS ws + 2, WS stages before its first use, into
  // the buffer W stage ws - 1 left (its last reader passed the barrier)
  tc_load_w<F, BN>(wring + (ws0 & 1) * C::WSTAGE, qs, f, N, KB, n0, ws0);
#pragma unroll
  for (int s = 0; s < TC_NS - 2; ++s) {
    if (st0 + s < st1) tc_load_x<BN>(ring + s * C::X, x, M, K, m0, st0 + s);
    cp_async_commit();
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];          // A, double-buffered across stages

  for (int st = st0; st < st1; ++st) {
    cp_async_wait<TC_NS - 3>();
    // x stage st (and its W stage) landed; every thread has waited out
    // stage st - 2's wgmma, so its x slot (that of st + 2) is free
    __syncthreads();
    const int ws = st / C::WS;
    if (st % C::WS == 0 && ws + 1 < ws1)
      tc_load_w<F, BN>(wring + ((ws + 1) & 1) * C::WSTAGE, qs, f, N, KB, n0,
                       ws + 1);
    const int ls = st + TC_NS - 2;
    if (ls < st1)
      tc_load_x<BN>(ring + ((ls - st0) % TC_NS) * C::X, x, M, K, m0, ls);
    cp_async_commit();
    const uint8_t* xs = ring + ((st - st0) % TC_NS) * C::X;
    const uint8_t* wst = wring + (ws & 1) * C::WSTAGE;
    const int jb = (st % C::WS) * TC_SB;
    if (st & 1)
      tc_stage<F, BN, PH>(xs, wst, ws * C::WB, jb, KB, r0, t, sbase, acc,
                          a1);
    else
      tc_stage<F, BN, PH>(xs, wst, ws * C::WB, jb, KB, r0, t, sbase, acc,
                          a0);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free
  // the tile, token-major: stage[token][row]
  float* o = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* p = o + (8 * j + 2 * t) * C::OP + r0;
    p[0] = acc[4 * j];
    p[C::OP] = acc[4 * j + 1];
    p[8] = acc[4 * j + 2];
    p[C::OP + 8] = acc[4 * j + 3];
  }
  // every rank's tile is staged (a cluster of S > 1 CTAs); rank r sums
  // tokens [t0, t1) of all ranks' tiles in rank order and stores them
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster.sync();
  else __syncthreads();
  const bool vec = N % 4 == 0;
  const int t0 = rank * BN / S, t1 = (rank + 1) * BN / S;
  for (int i = threadIdx.x; i < (t1 - t0) * TC_R / 4; i += GT) {
    const int tk = t0 + i / (TC_R / 4), c = 4 * (i % (TC_R / 4));
    const int m = m0 + tk, n = n0 + c;
    if (m >= M || n >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(
        (S > 1 ? cluster.map_shared_rank(o, 0) : o) + tk * C::OP + c);
    for (int q = 1; q < S; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(o, q) + tk * C::OP + c);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    float* dst = y + (size_t)m * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int q = 0; q < 4 && n + q < N; ++q) dst[q] = e[q];
    }
  }
  if (S > 1) cluster.sync();            // the peers' tiles stay until read
}

// ------------------------------------------------------------------ host

cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached;
  return cudaSuccess;
}

// The tc route's K splits a cluster: 2 where its row tiles fill less than
// 3/4 of the card (one CTA an SM) and each split keeps 2 W stages, else 1.
// (4 splits at N = 4096 were slower at M = 512: PERF.md §6.)
int k_splits(int row_tiles, int sms, int w_stages) {
  return 4 * row_tiles < 3 * sms && w_stages >= 4 ? 2 : 1;
}

// launch `kernel` on grid.x x grid.y x S CTAs, S > 1 to a cluster along z
template <typename Kernel, typename... Args>
cudaError_t launch_split(Kernel kernel, dim3 grid, int S, int smem,
                         cudaStream_t s, Args... args) {
  if (S == 1) {
    kernel<<<grid, GT, smem, s>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x, grid.y, S);
  cfg.blockDim = dim3(GT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <class F, int MT, int R>
cudaError_t launch_stream(const bf16* x, const uint8_t* qs, const F& f,
                          float* y, int M, int N, int K, cudaStream_t s) {
  using C = StreamCfg<F, MT, R>;
  static int granted = 0;
  cudaError_t e =
      allow_smem(gemm_stream_kernel<F, MT, R>, C::SMEM, &granted);
  if (e != cudaSuccess) return e;
  gemm_stream_kernel<F, MT, R><<<(N + R - 1) / R, GT, C::SMEM, s>>>(
      x, qs, f, y, M, N, K);
  return cudaGetLastError();
}

// the stream route's row tile: ST_R_WIDE rows where that still gives two
// CTAs an SM (half the re-reads of x), else ST_R
template <class F, int MT>
cudaError_t run_stream(const bf16* x, const uint8_t* qs, const F& f,
                       float* y, int M, int N, int K, cudaStream_t s) {
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  if ((N + ST_R_WIDE - 1) / ST_R_WIDE >= 2 * sms)
    return launch_stream<F, MT, ST_R_WIDE>(x, qs, f, y, M, N, K, s);
  return launch_stream<F, MT, ST_R>(x, qs, f, y, M, N, K, s);
}

template <class F, int BN, int PH>
cudaError_t run_tc(const bf16* x, const uint8_t* qs, const F& f, float* y,
                   int M, int N, int K, cudaStream_t s) {
  using C = TcCfg<F, BN>;
  static int granted = 0;
  int sms = 0;
  cudaError_t e = allow_smem(gemm_tc_kernel<F, BN, PH>, C::SMEM, &granted);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BN - 1) / BN, (N + TC_R - 1) / TC_R);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  // from N and K alone, so that every M sums each output in one order (a
  // chunked prefill equals a whole one)
  const int S = k_splits(grid.y, sms, (K / 32 + C::WB - 1) / C::WB);
  return launch_split(gemm_tc_kernel<F, BN, PH>, grid, S, C::SMEM, s, x, qs,
                      f, y, M, N, K);
}

// route: 0 stream (M <= 32), 1 tc (ops/quant_matmul.py::gemm_route). x and
// the payload must start on 16 bytes; a route that cannot take M is refused.
// the tc route at M tokens in phase PH
template <class F, int PH>
int run_tc_m(const bf16* x, const uint8_t* qs, const F& f, float* y, int M,
             int N, int K, cudaStream_t s) {
  if (M <= 64) return (int)run_tc<F, 64, PH>(x, qs, f, y, M, N, K, s);
  if (M <= 128) return (int)run_tc<F, 128, PH>(x, qs, f, y, M, N, K, s);
  return (int)run_tc<F, TC_BN, PH>(x, qs, f, y, M, N, K, s);
}

template <class F>
int gemm(const bf16* x, const uint8_t* qs, F f, float* y, int M, int N,
         int K, int route, void* stream) {
  if (K % 32 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qs) % 16)
    return (int)cudaErrorMisalignedAddress;
  if constexpr (F::S6) {                // whole superblock pairs a stage
    if (K % 4096) return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(f.sm) % 16 ||
        reinterpret_cast<uintptr_t>(f.dd) % 4)
      return (int)cudaErrorMisalignedAddress;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    if (M <= 8) return (int)run_stream<F, 1>(x, qs, f, y, M, N, K, s);
    if (M <= 16) return (int)run_stream<F, 2>(x, qs, f, y, M, N, K, s);
    if (M <= 32) return (int)run_stream<F, 4>(x, qs, f, y, M, N, K, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) return run_tc_m<F, TC_ALL>(x, qs, f, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

GCT_EXPORT int q4k_gemm(const bf16* x, const uint8_t* qs, const bf16* es,
                        const bf16* em, float* y, int M, int N, int K,
                        int route, void* stream) {
  return gemm(x, qs, Q4K{es, em}, y, M, N, K, route, stream);
}

// The Q4_K-E tc route in a measurement-only phase (TC_DEQUANT, TC_DOT,
// TC_STREAM; TC_ALL is q4k_gemm's own kernel): any M, the checks of gemm.
GCT_EXPORT int q4k_gemm_phase(const bf16* x, const uint8_t* qs,
                              const bf16* es, const bf16* em, float* y, int M,
                              int N, int K, int phase, void* stream) {
  if (K % 32 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qs) % 16)
    return (int)cudaErrorMisalignedAddress;
  const Q4K f{es, em};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case TC_ALL: return run_tc_m<Q4K, TC_ALL>(x, qs, f, y, M, N, K, s);
    case TC_DEQUANT:
      return run_tc_m<Q4K, TC_DEQUANT>(x, qs, f, y, M, N, K, s);
    case TC_DOT: return run_tc_m<Q4K, TC_DOT>(x, qs, f, y, M, N, K, s);
    case TC_STREAM:
      return run_tc_m<Q4K, TC_STREAM>(x, qs, f, y, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

GCT_EXPORT int q4k_s6_gemm(const bf16* x, const uint8_t* qs,
                           const int8_t* sm, const bf16* dd, float* y, int M,
                           int N, int K, int route, void* stream) {
  return gemm(x, qs, Q4KS6{sm, dd}, y, M, N, K, route, stream);
}

GCT_EXPORT int q40_gemm(const bf16* x, const uint8_t* qs, const __half* d,
                        float* y, int M, int N, int K, int route,
                        void* stream) {
  return gemm(x, qs, Q40{d}, y, M, N, K, route, stream);
}

GCT_EXPORT int q80_gemm(const bf16* x, const uint8_t* qs, const __half* d,
                        float* y, int M, int N, int K, int route,
                        void* stream) {
  return gemm(x, qs, Q80{d}, y, M, N, K, route, stream);
}
