// Paged-KV decode for Hopper (sm_90a): single-token attention over a
// page-major pool [(L,) n_pages, Hkv, page_size, D] through a page table,
// with bf16, int8 or fp8 (e4m3) pages.
//
// Replaces ops/paged_attention.py::_paged_kernel of the JAX package.
//   q [B, Hq, D] bf16; lengths [B] int32 (>= 1); page_indices [B, pps]
//   int32 (each entry clamped to n_pages - 1); the layer is a pointer
//   offset into the 5-D pool, never a copy. Quantized pages carry f32
//   per-token scales [(L,) n_pages, Hkv, page_size]: the k scale multiplies
//   the score row, the v scale the probability row (the row sum l stays
//   unscaled, and p * v_scale stays in f32), as the reference does.
//   Bound on the H100: bytes: the pages of the valid keys, q, the table and
//   the output. At the engine's 7B shapes (B = 8, MHA, up to 1024 keys) a
//   call reads at most 67 MB of bf16 pages (34 MB int8 / fp8).
//
// Design: contiguous flash decode's (flash_decode.cu), through kv_tiles.cuh.
//   Grid (n_splits, B * Hkv), 256 threads; a CTA takes the G query heads of
//   one KV head. It reads its sequence's length on the card (a captured
//   graph replays with new lengths), cuts [0, len) into 64-key tiles and
//   takes its split of them (fd_split; the host picks n_splits with
//   ops/flash_decode.py::pick_splits from B, Hkv, pps * page_size and the SM
//   count). A split past its sequence's keys returns at once: it would only
//   add the LSE identity, which weighs 0 in the merge.
//   The split's entries of the page table (the sequence's whole row, up to
//   PD_WHOLE_ROW entries, read beside the length) are read once, clamped,
//   into shared memory: one lookup a page, not a vector. A tile's K / V rows are
//   then copied by 16-byte cp.async into the 4-stage ring in their storage
//   type (a tile is one block of one page at page size 64, whole pages below
//   it, part of one above), keys past the split zero-filled, and widened in
//   registers by the warps that own the keys; the warps fold in warp order.
//   One launch: where one split holds all of a sequence's keys, its CTA
//   writes its rows of the output. Otherwise each live split's CTA writes
//   its (o, m, s) partial into the wrapper's scratch and takes a ticket of
//   its (sequence, KV head); the CTA that draws the last ticket folds the
//   partials in split order with the guarded combine of ops/lse.py (a split
//   with m = -inf weighs 0, never NaN), writes the output and puts the
//   ticket back to 0 (tickets: ops/paged_attention.py, int32 [65535], the
//   grid's limit on B * Hkv, made once a device outside any graph capture).
#include "kv_tiles.cuh"

constexpr int PD_SMEM_MAX = 232448;   // dynamic shared memory a block may use

// the (o, m, s) partial of (bh, split) in the scratch: o [bhs][G][D], then
// m [bhs][G], then s [bhs][G] (bhs = B * Hkv * n_splits)
struct PdPart {
  float* o;
  float* m;
  float* s;
};

template <int KIND, int GP, int D>
__global__ void __launch_bounds__(FD_THREADS, 1)
paged_decode_kernel(const bf16* __restrict__ q,
                    const unsigned char* __restrict__ kp,
                    const unsigned char* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices,
                    bf16* __restrict__ out, PdPart part,
                    unsigned* __restrict__ tickets, int Hq, int Hkv,
                    int n_pages, int ps, int pps, int layer, int n_splits,
                    int whole_row, float scale) {
  constexpr bool QUANT = KIND != FD_BF16;
  constexpr int ROW = FdTile<KIND, D>::ROW;    // bytes of a K / V row
  constexpr int KV = FdTile<KIND, D>::KV;      // bytes of a K (or V) tile
  constexpr int STAGE = FdTile<KIND, D>::STAGE;

  extern __shared__ __align__(16) unsigned char fd_smem[];
  unsigned char* ring = fd_smem;
  int* pl = reinterpret_cast<int*>(fd_smem + fd_smem_bytes<KIND, GP, D>());
  __shared__ bool last;

  // the splits of one (sequence, KV head) are neighbours in launch order
  const int sp = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const size_t pi = (size_t)bh * n_splits + sp;     // my partial
  bf16* og = out + ((size_t)b * Hq + (size_t)h * G) * D;
  const int* prow = page_indices + (size_t)b * pps;

  // the length, and (whole_row) the sequence's whole row of the page table,
  // clamped, in flight together
  const int len_b = lengths[b];
  if (whole_row)
    for (int i = tid; i < pps; i += FD_THREADS)
      pl[i] = min(prow[i], n_pages - 1);
  const int len = max(0, min(len_b, pps * ps));
  int t0, t1;
  fd_split(len, n_splits, sp, &t0, &t1);
  // the splits that hold keys; one of them writes the output itself
  const int tiles = (len + FD_TILE - 1) / FD_TILE;
  const int per = (tiles + n_splits - 1) / n_splits;
  const int live = per ? (tiles + per - 1) / per : 0;
  if (sp >= max(live, 1)) return;           // no key, nothing to merge
  const bool direct = live <= 1;
  if (t0 < t1) {
    const int hi = min(t1 * FD_TILE, len);    // the split's keys: [t0*64, hi)
    // the table entries in shared memory start at page `first`: the whole
    // row, or the split's own pages
    const int first = whole_row ? 0 : t0 * FD_TILE / ps;
    if (!whole_row)
      for (int i = tid, np = (hi - 1) / ps - first + 1; i < np;
           i += FD_THREADS)
        pl[i] = min(prow[first + i], n_pages - 1);
    __syncthreads();
    const size_t layer_pages = (size_t)layer * n_pages;
    // the pool row (in rows of D elements, and in scales) of offset o of
    // table slot `slot`
    auto row_at = [&](int slot, int o) -> size_t {
      return ((layer_pages + pl[slot - first]) * Hkv + h) * (size_t)ps + o;
    };
    // tile `t` into stage `st`: K and V rows (keys >= hi zero-filled),
    // scales; one division a tile, more only where the tile crosses pages
    auto issue = [&](int t, int st) {
      const unsigned dst = fd_smem_u32(ring + st * STAGE);
      const int key0 = t * FD_TILE, s0 = key0 / ps, o0 = key0 - s0 * ps;
      auto row_of = [&](int kk) -> size_t {
        int slot = s0, o = o0 + kk;
        if (o >= ps) {
          const int d = o / ps;
          slot += d;
          o -= d * ps;
        }
        return row_at(slot, o);
      };
#pragma unroll
      for (int i = 0; i < KV / 16 / FD_THREADS; ++i) {
        const int c = tid + i * FD_THREADS, kk = c / (ROW / 16);
        const bool ok = key0 + kk < hi;
        const size_t off = ok ? row_of(kk) * ROW + (c % (ROW / 16)) * 16 : 0;
        fd_cp_async<16>(dst + c * 16, kp + off, ok);
        fd_cp_async<16>(dst + KV + c * 16, vp + off, ok);
      }
      if (QUANT && tid < 2 * FD_TILE) {
        const int j = tid & (FD_TILE - 1);
        const bool ok = key0 + j < hi;
        const float* src =
            (tid < FD_TILE ? k_scale : v_scale) + (ok ? row_of(j) : 0);
        fd_cp_async<4>(
            dst + 2 * KV + (tid < FD_TILE ? 0 : FD_TILE * 4) + j * 4, src,
            ok);
      }
    };
    const bf16* qg = q + ((size_t)b * Hq + (size_t)h * G) * D;
    fd_attend<KIND, GP, D>(
        fd_smem, qg, G, t0, t1 - t0, hi, 0, scale, issue,
        [&](int i, int g, float acc, float mx, float sum) {
          if (direct) {
            og[i] = __float2bfloat16(acc / (sum == 0.f ? 1.f : sum));
            return;
          }
          part.o[pi * G * D + i] = acc;
          if (i % D == 0) {
            part.m[pi * G + g] = mx;
            part.s[pi * G + g] = sum;
          }
        });
  } else {                                  // no key at all: zeros
    for (int i = tid; i < G * D; i += FD_THREADS)
      og[i] = __float2bfloat16(0.f);
  }
  if (direct) return;

  // the partial before the ticket; the last of the live splits merges
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1u) == (unsigned)live - 1;
  __syncthreads();
  if (!last) return;                        // uniform: the CTA returns together
  __threadfence();
  const size_t p0 = (size_t)bh * n_splits;
  for (int i = tid; i < G * D; i += FD_THREADS) {
    const int g = i / D;
    float mx = -INFINITY;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, __ldcg(part.m + (p0 + s) * G + g));
    float acc = 0.f, sum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float ms = __ldcg(part.m + (p0 + s) * G + g);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      sum += __ldcg(part.s + (p0 + s) * G + g) * w;
      acc += __ldcg(part.o + (p0 + s) * G * D + i) * w;
    }
    og[i] = __float2bfloat16(acc / (sum == 0.f ? 1.f : sum));
  }
  if (tid == 0) tickets[bh] = 0u;
}

// the page-list entries a split may need: a split spans at most
// ceil(ceil(pps * ps / 64) / n_splits) tiles, which touch at most
// (span - 1) / ps + 2 pages (and never more than pps)
static int pd_pages_cap(int ps, int pps, int n_splits) {
  const long long tiles = ((long long)pps * ps + FD_TILE - 1) / FD_TILE;
  const long long span = (tiles + n_splits - 1) / n_splits * FD_TILE;
  const long long cap = (span - 1) / ps + 2;
  return (int)(cap < pps ? cap : pps);
}

// rows of the page table up to this many entries are read whole, beside the
// length (one round trip less a CTA)
constexpr int PD_WHOLE_ROW = 1024;

template <int KIND, int GP, int D>
static int launch_paged(const bf16* q, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* lengths,
                        const int* page_indices, bf16* out, float* part,
                        unsigned* tickets, int B, int Hq, int Hkv,
                        int n_pages, int ps, int pps, int layer, int n_splits,
                        float scale, cudaStream_t stream) {
  static int granted = 0;
  const int whole_row = pps <= PD_WHOLE_ROW;
  const int smem = fd_smem_bytes<KIND, GP, D>() +
                   4 * (whole_row ? pps : pd_pages_cap(ps, pps, n_splits));
  if (smem > PD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<KIND, GP, D>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const size_t bhs = (size_t)B * Hkv * n_splits, G = Hq / Hkv;
  const PdPart pp = part ? PdPart{part, part + bhs * G * D,
                                   part + bhs * G * (D + 1)}
                          : PdPart{nullptr, nullptr, nullptr};
  kernel<<<dim3(n_splits, B * Hkv), FD_THREADS, smem, stream>>>(
      q, static_cast<const unsigned char*>(kp),
      static_cast<const unsigned char*>(vp), ks, vs, lengths, page_indices,
      out, pp, tickets, Hq, Hkv, n_pages, ps, pps, layer, n_splits,
      whole_row, scale);
  return (int)cudaGetLastError();
}

template <int KIND, int D>
static int launch_paged_g(const bf16* q, const void* kp, const void* vp,
                          const float* ks, const float* vs,
                          const int* lengths, const int* page_indices,
                          bf16* out, float* part, unsigned* tickets, int B,
                          int Hq, int Hkv, int n_pages, int ps, int pps,
                          int layer, int n_splits, float scale,
                          cudaStream_t st) {
#define PD_GP(GPV)                                                            \
  launch_paged<KIND, GPV, D>(q, kp, vp, ks, vs, lengths, page_indices, out,   \
                             part, tickets, B, Hq, Hkv, n_pages, ps, pps,     \
                             layer, n_splits, scale, st)
  const int G = Hq / Hkv;
  if (G == 1) return PD_GP(1);
  if (G == 2) return PD_GP(2);
  if (G <= 4) return PD_GP(4);
  if (G <= 8) return PD_GP(8);
  return PD_GP(16);
#undef PD_GP
}

template <int KIND>
static int launch_paged_d(const bf16* q, const void* kp, const void* vp,
                          const float* ks, const float* vs,
                          const int* lengths, const int* page_indices,
                          bf16* out, float* part, unsigned* tickets, int B,
                          int Hq, int Hkv, int n_pages, int ps, int D,
                          int pps, int layer, int n_splits, float scale,
                          cudaStream_t st) {
  if (D == 128)
    return launch_paged_g<KIND, 128>(q, kp, vp, ks, vs, lengths, page_indices,
                                     out, part, tickets, B, Hq, Hkv, n_pages,
                                     ps, pps, layer, n_splits, scale, st);
  return launch_paged_g<KIND, 64>(q, kp, vp, ks, vs, lengths, page_indices,
                                  out, part, tickets, B, Hq, Hkv, n_pages, ps,
                                  pps, layer, n_splits, scale, st);
}

// kv_kind: 0 bf16 pages, 1 int8, 2 fp8 e4m3 (1 and 2 need the scales).
// part: f32 scratch of B * Hkv * n_splits * (Hq / Hkv) * (D + 2) and
// tickets: at least B * Hkv zeroed uint32, both needed only when
// n_splits > 1.
GCT_EXPORT int paged_decode(const bf16* q, const void* k_pages,
                            const void* v_pages, const float* k_scale,
                            const float* v_scale, const int* lengths,
                            const int* page_indices, bf16* out, float* part,
                            unsigned* tickets, int B, int Hq, int Hkv,
                            int n_pages, int page_size, int D,
                            int pages_per_seq, int layer, int n_splits,
                            int kv_kind, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > FD_MAXG ||
      (D != 64 && D != 128) || page_size < 1 || n_pages < 1 ||
      pages_per_seq < 1 || n_splits < 1 || B * Hkv > 65535 ||
      (n_splits > 1 && (!part || !tickets)) ||
      (kv_kind != FD_BF16 && (!k_scale || !v_scale)) ||
      (((uintptr_t)k_pages | (uintptr_t)v_pages) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PD_KIND(K)                                                            \
  launch_paged_d<K>(q, k_pages, v_pages, k_scale, v_scale, lengths,           \
                    page_indices, out, part, tickets, B, Hq, Hkv, n_pages,    \
                    page_size, D, pages_per_seq, layer, n_splits, scale, st)
  switch (kv_kind) {
    case FD_BF16: return PD_KIND(FD_BF16);
    case FD_INT8: return PD_KIND(FD_INT8);
    case FD_FP8: return PD_KIND(FD_FP8);
  }
#undef PD_KIND
  return (int)cudaErrorInvalidValue;
}

// registers, shared memory and occupancy of the engine's instance (MHA,
// D 128) of kv_kind with `pages` page-list entries (kernel_info)
GCT_EXPORT int paged_decode_info(int kv_kind, int pages, int* out) {
#define PD_INFO(K)                                                           \
  kernel_info(paged_decode_kernel<K, 1, 128>, FD_THREADS,                    \
              fd_smem_bytes<K, 1, 128>() + 4 * pages, out)
  if (kv_kind == FD_INT8) return PD_INFO(FD_INT8);
  if (kv_kind == FD_FP8) return PD_INFO(FD_FP8);
  return PD_INFO(FD_BF16);
#undef PD_INFO
}
