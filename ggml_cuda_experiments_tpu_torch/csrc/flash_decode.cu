// Split-KV flash decode for Hopper (sm_90a): single-token attention against
// the stacked KV cache [L, B, Hkv, S, D], plus the LSE merge.
//
// Replaces ops/flash_decode.py::_decode_kernel (GQA) and ::_decode_kernel_ht
// (MHA) of the JAX package, and the pure-jnp lse_combine_stacked /
// lse_finalize that merge their splits (ops/lse.py, the merge at
// ops/flash_decode.py:386).
//   Bound on the H100: bytes. The K / V rows of the valid length (one 7B
//   layer at length 1024: 16.8 MB of bf16), q, and the f32 partials; the
//   work is two multiply-adds a K / V element per query head.
//
// flash_decode_partials_kernel: grid (B * Hkv, n_splits), 8 warps. A CTA
// takes the G = Hq / Hkv query heads of one KV head (G <= 16, D 64 or 128).
//   The split covers the valid keys, not the padded cache: the CTA reads
//   lengths[b] itself (the host reads nothing, so a captured graph replays
//   with new lengths), cuts [0, len), len = min(lengths[b], S), into
//   ceil(len / 64) tiles of 64 keys and takes tiles [sp * t, sp * t + t)
//   with t = ceil(tiles / n_splits)
//   (ops/flash_decode.py::pick_splits chooses n_splits for about one CTA an
//   SM over a full cache: 4 splits of 4 tiles at 7B MHA, S = 1024). A split
//   with no tile (every split when len == 0) writes the identity m = -inf,
//   s = 0, o = 0 and reads nothing.
//   K and V of one (layer, sequence, KV head) are contiguous [S, D] rows, so
//   a tile is one contiguous block (16 KB of K and 16 KB of V at bf16 D 128;
//   8 KB each at int8 / fp8, with its 64 k and 64 v scales). The tiles
//   stream through a ring of 4 stages by 16-byte cp.async (4-byte for the
//   scales), keys past the split's end zero-filled; the copies of tile
//   t + 3 are issued before tile t's math, and one CTA barrier a tile frees
//   the stage. The entry refuses (cudaErrorInvalidValue) a K or V base that
//   is not 16-byte aligned.
//   Each warp owns 8 keys of every tile, with its own m, l and o (G x D / 32
//   floats a lane). Scores: the lanes of a key row each read one 16-byte
//   vector of it (16 lanes a bf16 row at D 128), multiply by q in f32 (q in
//   registers where G x 16 bytes of it fit), and a reduce-scatter of
//   shuffles leaves every key's score with the lanes of one chunk group; m
//   and l over the warp's 8 keys by shuffles. p goes through the warp's own
//   shared memory to P.V, where a lane holds D / 32 columns of every head
//   and reads V rows as 2 / 4 contiguous elements. No phase waits on
//   another warp. At the end of the split the 8 warps fold in warp order
//   through shared memory, so o, m and s do not depend on the schedule.
//   Shared memory: the 4-stage ring (128 KB at bf16 D 128, 66 KB at int8 /
//   fp8 D 128), q and p (0.8-13 KB). ptxas (chip_smoke.py phase 2 prints
//   each instance): 68 registers at bf16 G 1 D 128, 114 at G 4, 196 at
//   G 16; 70 at int8 G 1 D 128; no spill.
//
// flash_decode_partials_q is the quantized cache's variant (the k_scale /
// v_scale path of the same two TPU kernels): int8 or fp8 (e4m3) K / V with
// f32 per-token scales [L, B, Hkv, S]. As the reference does, the k scale
// multiplies each score row (s = (q . k) * (k_scale * scale)) and the v
// scale each probability row in P.V (the row sum l takes p unscaled), and
// with GQA groups (G > 1, its _decode_kernel) p * v_scale is rounded to
// bf16 before the product; its MHA kernel (_decode_kernel_ht) keeps it in
// f32.
//
// lse_merge folds the n_splits partials of every (sequence, head) in split
// order with the guarded combine of ops/lse.py (an empty split weighs 0,
// never NaN) and writes o / s in bf16; one warp a row, its lanes loading
// the m and s of 32 splits at once, a lane D / 32 columns.
//
// The tile ring, the warps' math and their fold live in kv_tiles.cuh
// (fd_attend), shared with paged_attention.cu's paged_decode.
#include "kv_tiles.cuh"

template <int KIND, int GP, int D>
__global__ void __launch_bounds__(FD_THREADS, 1)
flash_decode_partials_kernel(const bf16* __restrict__ q,
                             const unsigned char* __restrict__ k,
                             const unsigned char* __restrict__ v,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ lengths,
                             float* __restrict__ o_part,
                             float* __restrict__ m_part,
                             float* __restrict__ s_part, int B, int Hq,
                             int Hkv, int S, int layer, int n_splits,
                             int round_pv, float scale) {
  constexpr bool QUANT = KIND != FD_BF16;
  constexpr int ROW = FdTile<KIND, D>::ROW;    // bytes of a K / V row
  constexpr int KV = FdTile<KIND, D>::KV;      // bytes of a K (or V) tile
  constexpr int STAGE = FdTile<KIND, D>::STAGE;

  extern __shared__ __align__(16) unsigned char fd_smem[];
  unsigned char* ring = fd_smem;

  const int bh = blockIdx.x, sp = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const size_t part = (size_t)bh * n_splits + sp;

  const int len = max(0, min(lengths[b], S));
  int t0, t1;
  fd_split(len, n_splits, sp, &t0, &t1);
  if (t0 >= t1) {                           // no key: the LSE identity
    for (int i = tid; i < G * D; i += FD_THREADS) o_part[part * G * D + i] = 0.f;
    if (tid < G) {
      m_part[part * G + tid] = -INFINITY;
      s_part[part * G + tid] = 0.f;
    }
    return;
  }
  const int hi = min(t1 * FD_TILE, len);      // the split's keys: [t0*64, hi)

  // the (layer, sequence, head) row of keys, in scale and element units
  const size_t key_off = (((size_t)layer * B + b) * Hkv + h) * (size_t)S;
  const unsigned char* kg = k + key_off * ROW;
  const unsigned char* vg = v + key_off * ROW;

  // tile `t` into stage `st`: K and V rows (keys >= hi zero-filled), scales
  auto issue = [&](int t, int st) {
    const unsigned dst = fd_smem_u32(ring + st * STAGE);
    const int key0 = t * FD_TILE;
#pragma unroll
    for (int i = 0; i < KV / 16 / FD_THREADS; ++i) {
      const int c = tid + i * FD_THREADS;
      const int key = key0 + c / (ROW / 16);
      const bool ok = key < hi;
      const size_t off = (size_t)key0 * ROW + (size_t)c * 16;
      fd_cp_async<16>(dst + c * 16, ok ? kg + off : kg, ok);
      fd_cp_async<16>(dst + KV + c * 16, ok ? vg + off : vg, ok);
    }
    if (QUANT && tid < 2 * FD_TILE) {
      const int j = tid & (FD_TILE - 1), key = key0 + j;
      const bool ok = key < hi;
      const float* src = (tid < FD_TILE ? k_scale : v_scale) + key_off +
                         (ok ? key : 0);
      fd_cp_async<4>(dst + 2 * KV + (tid < FD_TILE ? 0 : FD_TILE * 4) + j * 4,
                     src, ok);
    }
  };

  const bf16* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;
  fd_attend<KIND, GP, D>(
      fd_smem, qg, G, t0, t1 - t0, hi, round_pv, scale, issue,
      [&](int i, int g, float acc, float mx, float sum) {
        o_part[part * G * D + i] = acc;
        if (i % D == 0) {
          m_part[part * G + g] = mx;
          s_part[part * G + g] = sum;
        }
      });
}

// one warp a row (row = (b * Hkv + h) * G + g), a lane D / 32 columns: the
// lanes hold the m and s of 32 splits at a time, the sums run in split order
__global__ void __launch_bounds__(32)
lse_merge_kernel(const float* __restrict__ o, const float* __restrict__ m,
                 const float* __restrict__ s, bf16* __restrict__ out, int G,
                 int D, int n_splits) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const int bh = row / G, g = row % G, dpl = D / 32;
  const size_t base = (size_t)bh * n_splits;
  float mx = -INFINITY;
  for (int sp = lane; sp < n_splits; sp += 32)
    mx = fmaxf(mx, m[(base + sp) * G + g]);
  mx = warp_max(mx);
  float st = 0.f, ot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < n_splits; c0 += 32) {
    float w = 0.f, sv = 0.f;
    if (c0 + lane < n_splits) {
      const size_t pi = (base + c0 + lane) * G + g;
      const float mi = m[pi];
      w = mi == -INFINITY ? 0.f : expf(mi - mx);
      sv = s[pi];
    }
    const int cnt = min(32, n_splits - c0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      st += __shfl_sync(0xffffffffu, sv, j) * wj;
      const float* op = o + ((base + c0 + j) * G + g) * D + lane * dpl;
      if (dpl == 4) {
        const float4 t = *reinterpret_cast<const float4*>(op);
        ot[0] += t.x * wj; ot[1] += t.y * wj;
        ot[2] += t.z * wj; ot[3] += t.w * wj;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(op);
        ot[0] += t.x * wj; ot[1] += t.y * wj;
      }
    }
  }
  const float den = st == 0.f ? 1.f : st;
  bf16* dst = out + (size_t)row * D + lane * dpl;
  dst[0] = __float2bfloat16(ot[0] / den);
  dst[1] = __float2bfloat16(ot[1] / den);
  if (dpl == 4) {
    dst[2] = __float2bfloat16(ot[2] / den);
    dst[3] = __float2bfloat16(ot[3] / den);
  }
}

template <int KIND, int GP, int D>
static int launch_gp(const bf16* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* lengths,
                     float* o, float* m, float* s, int B, int Hq, int Hkv,
                     int S, int layer, int n_splits, int round_pv,
                     float scale, void* stream) {
  constexpr int SMEM = fd_smem_bytes<KIND, GP, D>();
  static int granted = 0;
  auto kernel = flash_decode_partials_kernel<KIND, GP, D>;
  cudaError_t e = allow_smem(kernel, SMEM, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hkv, n_splits);
  kernel<<<grid, FD_THREADS, SMEM, (cudaStream_t)stream>>>(
      q, static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v), ks, vs, lengths, o, m, s, B, Hq,
      Hkv, S, layer, n_splits, round_pv, scale);
  return (int)cudaGetLastError();
}

template <int KIND, int D>
static int launch_d(int G, const bf16* q, const void* k, const void* v,
                    const float* ks, const float* vs, const int* lengths,
                    float* o, float* m, float* s, int B, int Hq, int Hkv,
                    int S, int layer, int n_splits, int round_pv, float scale,
                    void* stream) {
#define FD_GP(GPV)                                                          \
  launch_gp<KIND, GPV, D>(q, k, v, ks, vs, lengths, o, m, s, B, Hq, Hkv, S, \
                          layer, n_splits, round_pv, scale, stream)
  if (G == 1) return FD_GP(1);
  if (G == 2) return FD_GP(2);
  if (G <= 4) return FD_GP(4);
  if (G <= 8) return FD_GP(8);
  return FD_GP(16);
#undef FD_GP
}

template <int KIND>
static int launch_partials(const bf16* q, const void* k, const void* v,
                           const float* ks, const float* vs,
                           const int* lengths, float* o, float* m, float* s,
                           int B, int Hq, int Hkv, int S, int D, int layer,
                           int n_splits, int round_pv, float scale,
                           void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv ||
      Hq / Hkv > FD_MAXG || n_splits < 1 || n_splits > 65535 ||
      (KIND != FD_BF16 && (!ks || !vs)) ||
      (((uintptr_t)k | (uintptr_t)v) & 15))  // 16-byte cp.async of K / V rows
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (D == 128)
    return launch_d<KIND, 128>(G, q, k, v, ks, vs, lengths, o, m, s, B, Hq,
                               Hkv, S, layer, n_splits, round_pv, scale,
                               stream);
  return launch_d<KIND, 64>(G, q, k, v, ks, vs, lengths, o, m, s, B, Hq, Hkv,
                            S, layer, n_splits, round_pv, scale, stream);
}

GCT_EXPORT int flash_decode_partials(const bf16* q, const bf16* k,
                                     const bf16* v, const int* lengths,
                                     float* o, float* m, float* s, int B,
                                     int Hq, int Hkv, int S, int D, int layer,
                                     int n_splits, float scale, void* stream) {
  return launch_partials<FD_BF16>(q, k, v, nullptr, nullptr, lengths, o, m, s,
                                  B, Hq, Hkv, S, D, layer, n_splits, 0, scale,
                                  stream);
}

// kv_kind: 1 int8, 2 fp8 e4m3; round_pv: round p * v_scale to bf16
GCT_EXPORT int flash_decode_partials_q(const bf16* q, const void* k,
                                       const void* v, const float* k_scale,
                                       const float* v_scale,
                                       const int* lengths, float* o, float* m,
                                       float* s, int B, int Hq, int Hkv, int S,
                                       int D, int layer, int n_splits,
                                       int kv_kind, int round_pv, float scale,
                                       void* stream) {
  if (kv_kind == FD_INT8)
    return launch_partials<FD_INT8>(q, k, v, k_scale, v_scale, lengths, o, m,
                                    s, B, Hq, Hkv, S, D, layer, n_splits,
                                    round_pv, scale, stream);
  if (kv_kind == FD_FP8)
    return launch_partials<FD_FP8>(q, k, v, k_scale, v_scale, lengths, o, m,
                                   s, B, Hq, Hkv, S, D, layer, n_splits,
                                   round_pv, scale, stream);
  return (int)cudaErrorInvalidValue;
}

GCT_EXPORT int lse_merge(const float* o, const float* m, const float* s,
                         bf16* out, int B, int Hq, int Hkv, int D,
                         int n_splits, void* stream) {
  if ((D != 64 && D != 128) || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  lse_merge_kernel<<<B * Hq, 32, 0, (cudaStream_t)stream>>>(
      o, m, s, out, Hq / Hkv, D, n_splits);
  return (int)cudaGetLastError();
}
