// The fused batch-1 decode kernels for Hopper (sm_90a): one cooperative
// launch per call, its phases separated by grid-wide barriers.
//
//   fused_mlp        replaces ops/quant_matmul.py::_fused_mlp_kernel
//                    (mlp_fused): w_gu int8 matvec | silu(g)*u, int8
//                    quantization of the mid, w_down int8 matvec.
//   layer_kernel     replaces ops/layer_kernel.py::_layer_kernel
//                    (layer_step, model_step): per layer, attn RMSNorm and
//                    the attention phases, residual, MLP RMSNorm and the
//                    MLP phases, residual; nL layers in one launch, h in f32
//                    from layer to layer. Weights come through a device
//                    table of per-layer pointers, so nothing is copied.
//   fused_attention  replaces ops/fused_attention.py::_fused_attn_kernel
//                    (attention_fused): the layer kernel's attention block
//                    alone (its BLOCK instance): wqkv int8 matvec | RoPE,
//                    the new k / v spliced in, split-KV decode, the last
//                    split's merge and int8 quantization of o | W_o int8
//                    matvec, from the given x, with no norm and no
//                    residual; its weights come as six pointers.
//
// Bound on the H100: bytes. At llama2-7b a layer streams 136.3 MB of q4_k
// weights (wqkv 31.5, W_o 10.5, w_gu 62.9, w_down 31.5 MB) plus, at cache
// length 513, 8.4 MB of bf16 K/V: 43.2 us per layer at 3.35 TB/s, 1.38 ms
// for the 32 layers. The attention block alone at length 1024: 42.0 MB of
// weights and 16.8 MB of K/V, 17.5 us (GQA 32/8: 30.4 MB, 9.1 us).
//
// fused_mlp: every phase spreads its work over all warps of the grid (a
// row per warp at a time, q8_common.cuh), and the grid is exactly what is
// resident, as a cooperative launch requires. Work that every CTA needs
// whole (the quantized activations, silu(g)*u of the mid) is recomputed by
// each CTA from L2 instead of paying one more barrier (cg grid.sync()).
//
// layer_kernel (its own section below) takes the weight stream off the
// barriers' path: a producer warp a CTA streams the CTA's fixed share of
// every layer's weights and K / V rows through a TMA ring in shared
// memory, in the order the consumer warps use them, and never waits at a
// grid barrier; the consumers wait there only for activations.
//
// The Q4_K "s6" weights (quant_formats.cuh: Q4KS6) take their own
// instances: fused_mlp_s6 (fused_mlp_s6_kernel, q8_rows through the s6
// trait) and fused_attention_s6 (layer_decode_kernel<true, true>: the
// attention block with an s6 slot layout, below); the Q4_K-E instances are
// built from the same code unchanged. The layer kernel takes no s6 weight, as in
// the JAX package.
//
// Numerics are the JAX kernels' (see q8_common.cuh and the Python
// modules): q roped in f32 with 1/sqrt(D) folded in, k roped in f32 then
// rounded to the cache type, v rounded, the new token at position
// lengths[0]; o, the MLP mid and h stay f32. Sums are taken in a fixed
// order (no atomics on values), so a launch is deterministic, and the
// layers of model_step equal layer_step's launch by launch.
#include <cooperative_groups.h>

#include "q8_common.cuh"

namespace cg = cooperative_groups;

constexpr int HD = 128;            // head_dim the fused kernels take
constexpr int PART = HD + 2;       // floats per split partial: m, l, acc[HD]
constexpr int MAX_SPLITS = 64;     // as ops/fused_attention.py::MAX_SPLITS
constexpr int RED_BYTES = 256;     // block-reduction scratch

struct FusedArgs {
  const float* x;             // MLP / attention input; the layers' h_in
  const long long* ptrs;      // layers: [nL][12] weight pointers
  const float* norms;         // layers: [nL][2][dim]
  const void* w[12];          // MLP / attention weights (same 12 slots)
  const void* kc;
  const void* vc;
  const int* lengths;
  int layer0, nL, Hq, Hkv, S, dim, Kd, Nd, cache_f32, phase;
  unsigned* bar;              // the grid barrier's two counters, a merge
                              // ticket a layer and KV head
  float theta, scale, eps;
  float* yqkv;                // [(Hq + 2 Hkv) * HD]
  float* part;                // [Hq][n_splits][PART]
  float* ygu;                 // MLP: [2 Kd]; layers, attention block:
                              // the operand images
  float* h2;                  // [dim]
  float* out;                 // MLP y [Nd]; attention o [dim]; layers h
  void* kn;                   // [nL][Hkv][HD] in the cache type
  void* vn;
};

// weight slot w of the 12: (qs, es, em) x (wqkv, wo, w_gu, w_down)
struct Weights {
  const uint8_t* qs[4];
  const bf16* es[4];
  const bf16* em[4];
};

__device__ __forceinline__ Weights weights_of(const void* const* p) {
  Weights w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w.qs[i] = static_cast<const uint8_t*>(p[3 * i]);
    w.es[i] = static_cast<const bf16*>(p[3 * i + 1]);
    w.em[i] = static_cast<const bf16*>(p[3 * i + 2]);
  }
  return w;
}

// the s6 scale trait of weight i (its slots w[3 i + 1], w[3 i + 2]: sm,
// dd)
__device__ __forceinline__ Q4KS6 s6_of(const void* const* w, int i) {
  return Q4KS6{static_cast<const int8_t*>(w[3 * i + 1]),
               static_cast<const bf16*>(w[3 * i + 2])};
}

// ------------------------------------------------------------ sources

// h * rsqrt(mean(h^2) + eps) * w, the JAX layer kernel's f32 RMSNorm (h
// and w staged in shared memory by the layer kernel)
struct NormVec {
  const float* h;
  const float* w;
  float r;
  __device__ float2 load(int i) const { return make_float2(h[i], w[i]); }
  __device__ float value(float2 v) const {
    return __fmul_rn(__fmul_rn(v.x, r), v.y);
  }
};

// silu(g) * u of the MLP's gate / up outputs, in f32
struct MidVec {
  const float* y;
  int kd;
  __device__ float value(float2 gu) const {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gu.x)));
    return __fmul_rn(__fmul_rn(gu.x, sig), gu.y);
  }
  __device__ float operator()(int i) const {
    return value(make_float2(__ldcg(y + i), __ldcg(y + kd + i)));
  }
};

// the attention block's input x, staged in shared memory, as lk_quant
// takes it
struct XVec {
  const float* x;
  __device__ float2 load(int i) const { return make_float2(x[i], 0.f); }
  __device__ float value(float2 v) const { return v.x; }
};

// ----------------------------------------------------------- attention

template <typename T> struct CacheIO;

template <> struct CacheIO<bf16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <> struct CacheIO<float> {
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};

// ---------------------------------------------------------------- fused_mlp

// One cooperative launch: every CTA quantizes x, the grid's warps take the
// w_gu rows; a grid barrier; every CTA quantizes the whole mid from L2, the
// warps take the w_down rows. (Shared memory keeps the layout it had beside
// the attention block: a block reduction's scratch and a dim-wide f32
// vector ahead of the operands, so the grid is the same size.)
__global__ void __launch_bounds__(Q8_THREADS, 1)
fused_mlp_kernel(FusedArgs p) {
  extern __shared__ __align__(16) unsigned char fd_smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned char* act_base = fd_smem + RED_BYTES + 4 * p.dim;
  const Weights w = weights_of(p.w);
  const Q8Act ax = q8_act_at(act_base, p.dim / 32);
  q8_quant(GlobalVec{p.x}, ax);
  float* ygu = p.ygu;
  q8_rows(w.qs[2], w.es[2], w.em[2], 2 * p.Kd, ax,
          [&](int n, float v) { ygu[n] = v; });
  grid.sync();
  const Q8Act am = q8_act_at(act_base, p.Kd / 32);
  q8_quant(MidVec{p.ygu, p.Kd}, am);
  float* out = p.out;
  q8_rows(w.qs[3], w.es[3], w.em[3], p.Nd, am,
          [&](int n, float v) { out[n] = v; });
}

// fused_mlp's s6 instance: the same phases, the rows through the s6 trait
__global__ void __launch_bounds__(Q8_THREADS, 1)
fused_mlp_s6_kernel(FusedArgs p) {
  extern __shared__ __align__(16) unsigned char fd_smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned char* act_base = fd_smem + RED_BYTES + 4 * p.dim;
  const Q8Act ax = q8_act_at(act_base, p.dim / 32);
  q8_quant(GlobalVec{p.x}, ax);
  float* ygu = p.ygu;
  q8_rows(static_cast<const uint8_t*>(p.w[6]), s6_of(p.w, 2), 2 * p.Kd, ax,
          [&](int n, float v) { ygu[n] = v; });
  grid.sync();
  const Q8Act am = q8_act_at(act_base, p.Kd / 32);
  q8_quant(MidVec{p.ygu, p.Kd}, am);
  float* out = p.out;
  q8_rows(static_cast<const uint8_t*>(p.w[9]), s6_of(p.w, 3), p.Nd, am,
          [&](int n, float v) { out[n] = v; });
}

// ------------------------------------------------------------ layer kernel
//
// layer_kernel: one CTA an SM (cooperative), 8 consumer warps and one
// producer warp (9 warps: 168 registers a thread fit, no spill; a local
// memory access would wait behind the weight stream in L2). The weights
// never depend on the activations, so the producer streams each CTA's share
// of every layer, in the order the consumers use it, through a ring of 9
// shared-memory slots of 20 KB fed by TMA bulk copies on full / empty
// mbarriers, at most 2 chunks in flight (more only lengthen every L2 round
// trip the consumers wait on); it never waits at a grid barrier, so the HBM
// stream goes on while the consumers wait there or run a prologue.
//
// The stream of one CTA, per layer:
//   the attn norm's weights (16 KB);
//   wqkv, W_o, w_down: the CTA's rows [c N / G, (c + 1) N / G) of each (the
//     same slice in every layer and at any nL), in units of 8 rows x one
//     4096-wide segment of K: 8 x (2048 B of qs + 256 B of es + 256 B of
//     em) a slot, one row a consumer warp. A row wider than 4096 (w_down)
//     comes as consecutive segments; its warp keeps the per-lane sum across
//     them, so a row's sum runs in q8_row_dot's order;
//   between wqkv and W_o: the K / V tiles of the CTA's attention items, 8
//     KB of K and 8 KB of V a slot (32 bf16 or 16 f32 keys), only the valid
//     rows copied. Item (KV head g, split s) = CTA g n + s (and every G-th
//     after it), n splits of the ceil(len / tk) tiles, balanced in whole
//     tiles, from lengths[0]: one up to LK_ONE_SPLIT tiles, else
//     min(G / Hkv, tiles);
//   the MLP norm's weights; w_gu: the gate and up rows of the CTA's whole
//     32-blocks of the mid [b0, b1) = [c Kd/32 / G, (c + 1) Kd/32 / G).
// The consumers, per layer: RMSNorm (h staged in shared memory) and the
// int8 quantization of the 4096-vector, every CTA the whole vector; wqkv |
// the attention as #13's flash decode: each warp owns keys of every tile
// for one query head (8 / R warps a head), its keys' warp sums taken side
// by side, an online softmax a warp, the warps of a head folded in warp
// order; a single split's CTA quantizes its heads' o itself, else the last
// CTA to finish a split of a KV head (a ticket) merges that head's splits
// and quantizes its o, each into an image in device memory | every CTA
// copies o's image; W_o | RMSNorm,
// quantization; w_gu, and each CTA quantizes the mid blocks it owns into
// the mid's image | every CTA copies that image; w_down. ("|": a grid
// barrier.) A grid barrier is a counter of arrivals (release) and a spin
// on it (acquire) by one thread a CTA; the last CTA out of the launch sets
// the counter back to 0, as the last of a ticket does the ticket, so every
// launch and graph replay starts from 0.
constexpr int LK_CWARPS = 8;                    // consumer warps
constexpr int LK_CTHREADS = 32 * LK_CWARPS;
constexpr int LK_THREADS = LK_CTHREADS + 32;    // + the producer warp
constexpr int LK_ROWS = LK_CWARPS;              // rows of a unit
constexpr int LK_SEG = 4096;                    // K of a unit
constexpr int LK_QS = LK_SEG / 2;               // qs bytes a row a unit
constexpr int LK_SC = LK_SEG / 32 * 2;          // es (em) bytes a row a unit
constexpr int LK_SLOT = LK_ROWS * (LK_QS + 2 * LK_SC);   // 20 KB
// s6 (fused_attention_s6, K = LK_SEG: one unit a row group): a row's unit
// is its qs, its 128 sc and 128 mn bytes and its 16 superblocks' bf16 d
// and dmin (32 bytes each), the rows of a group back to back in each
// array; a slot [8][qs] | [8][sc | mn] | [8][d | dmin], 18.5 KB of the 20,
// copied by three bulk copies
constexpr int LK_S6_SC = LK_SEG / 32;           // sc (mn) bytes a row a unit
constexpr int LK_S6_D = LK_SEG / 256 * 2;       // d (dmin) bytes a row a unit
constexpr int LK_S6_ROW = LK_QS + 2 * LK_S6_SC + 2 * LK_S6_D;
static_assert(LK_ROWS * LK_S6_ROW <= LK_SLOT, "an s6 unit fits a slot");
constexpr int LK_KV = 8192;                     // K (and V) bytes a tile
constexpr int LK_STAGES = 9;
// a cache of at most this many tiles keeps one split: its CTA then merges
// nothing and writes no partial, cheaper than a merge's round trips
constexpr int LK_ONE_SPLIT = 8;
constexpr int LK_INFLIGHT = 2;                  // chunks issued, not landed
constexpr int LK_MAX_HKV = 64, LK_MAX_LAYERS = 256;   // the merge tickets
constexpr int LK_DIM = 4096;                    // Hq * HD, the gate's dim
// shared floats of the attention's fold [warp][PART] and a single split's
// o behind it; reused by the merge for the o of a KV head's query heads and
// their (m, l) (8 x HD each at most)
constexpr int LK_FOLD = LK_CWARPS * PART + 16 * HD;

enum { PH_ALL = 0, PH_NO_BOUND, PH_NO_ATTN, PH_STREAM, PH_ONLY_PACK,
       PH_ONLY_DOWN, PH_NO_SYNC };

// ops/layer_kernel.py::PHASES: which parts run (the producer streams every
// byte in every variant). Every variant but PH_ALL gives wrong outputs and
// is timed only.
struct PhaseFlags {
  bool pack, attn, down;        // the wqkv / W_o / w_gu, attention, w_down math
  bool entry, merge, mid;       // the prologues: RMSNorm + quantization,
                                // merge + o's quantization, the mid's
  bool sync;                    // grid barriers
};

__device__ __forceinline__ PhaseFlags phase_flags(int ph) {
  PhaseFlags f;
  f.pack = ph == PH_ALL || ph == PH_NO_BOUND || ph == PH_NO_ATTN ||
           ph == PH_ONLY_PACK || ph == PH_NO_SYNC;
  f.attn = ph == PH_ALL || ph == PH_NO_BOUND || ph == PH_NO_SYNC;
  f.down = ph == PH_ALL || ph == PH_NO_BOUND || ph == PH_NO_ATTN ||
           ph == PH_ONLY_DOWN || ph == PH_NO_SYNC;
  f.entry = ph == PH_ALL || ph == PH_NO_ATTN || ph == PH_ONLY_PACK ||
            ph == PH_NO_SYNC;
  f.merge = ph == PH_ALL || ph == PH_NO_SYNC;
  f.mid = ph == PH_ALL || ph == PH_NO_ATTN || ph == PH_ONLY_DOWN ||
          ph == PH_NO_SYNC;
  f.sync = ph != PH_NO_SYNC;
  return f;
}

// ---- mbarriers, TMA bulk copies, the consumers' barrier, grid barriers

__device__ __forceinline__ unsigned lk_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// A wait that sees no progress for LK_WATCHDOG cycles (~10 s) traps: a
// launch error rather than a card that never finishes.
constexpr long long LK_WATCHDOG = 20000000000LL;

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > LK_WATCHDOG) __trap();
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const void* src,
                                         unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps only (the producer warp never joins)
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, %0;" ::"n"(LK_CTHREADS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned atom_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Every consumer thread of every CTA: the CTA's stores so far are visible
// to every CTA after `target` arrivals in all (the n-th barrier of the
// launch: n * gridDim.x). The CTA barrier orders its threads' stores
// before thread 0's release; its acquire, and the CTA barrier after it,
// order the other CTAs' stores before every thread's later loads.
__device__ __forceinline__ void grid_barrier(unsigned* bar,
                                             unsigned target) {
  cbar();
  if (threadIdx.x == 0) {
    red_release(bar, 1u);
    if (ld_acquire(bar) < target) {
      const long long t0 = clock64();
      while (ld_acquire(bar) < target)
        if (clock64() - t0 > LK_WATCHDOG) __trap();
    }
  }
  cbar();
}

// ---- the ring: slot and phase of chunk `ch`

struct Ring {
  unsigned char* slots;         // LK_STAGES x LK_SLOT
  unsigned full, empty;         // shared addresses of the mbarrier arrays
  __device__ unsigned char* slot(unsigned ch) const {
    return slots + (ch % LK_STAGES) * LK_SLOT;
  }
  __device__ unsigned full_bar(unsigned ch) const {
    return full + 8 * (ch % LK_STAGES);
  }
  __device__ unsigned empty_bar(unsigned ch) const {
    return empty + 8 * (ch % LK_STAGES);
  }
  __device__ static unsigned parity(unsigned ch) {
    return (ch / LK_STAGES) & 1u;
  }
};

// this CTA's share [r0, r1) of n things split over the grid, in whole ones
struct Range {
  int r0, r1;
};

__device__ __forceinline__ Range lk_slice(int n) {
  return {(int)((long long)n * blockIdx.x / gridDim.x),
          (int)((long long)n * (blockIdx.x + 1) / gridDim.x)};
}

// the attention's split count and a split's tiles [t0, t1), from the length
struct AttnPlan {
  int length, tiles, n_splits, items;
  __device__ AttnPlan(int lb, int S, int Hkv, int tk) {
    // the new token included, at most the cache: a token past it attends
    // over the cache alone, as the reference's clamped block count does
    length = min(lb + 1, S);
    tiles = (length + tk - 1) / tk;
    n_splits = tiles <= LK_ONE_SPLIT
                   ? 1
                   : max(1, min(min((int)gridDim.x / Hkv, tiles), MAX_SPLITS));
    items = Hkv * n_splits;
  }
  __device__ void split(int s, int* t0, int* t1) const {
    *t0 = (int)((long long)tiles * s / n_splits);
    *t1 = (int)((long long)tiles * (s + 1) / n_splits);
  }
};

// ---- the producer warp

struct Producer {
  Ring ring;
  unsigned ch;
  int lane;

  // wait for the slot of chunk ch to be free (and for chunk ch -
  // LK_INFLIGHT to land), announce `bytes` on its full barrier; returns the
  // slot's shared address
  __device__ __forceinline__ unsigned begin(unsigned bytes) {
    mbar_wait(ring.empty_bar(ch), Ring::parity(ch) ^ 1u);
    if (ch >= LK_INFLIGHT)
      mbar_wait(ring.full_bar(ch - LK_INFLIGHT),
                Ring::parity(ch - LK_INFLIGHT));
    if (lane == 0) mbar_expect(ring.full_bar(ch), bytes);
    __syncwarp();
    return lk_smem(ring.slot(ch));
  }

  __device__ __forceinline__ void copy(unsigned dst, const void* src,
                                       unsigned bytes) {
    tma_load(dst, src, bytes, ring.full_bar(ch));
  }

  __device__ __forceinline__ void end() {
    __syncwarp();
    ++ch;
  }

  // rows rg of one q4_k matrix [., K], in units of LK_ROWS rows x 4096
  // (S6, K = LK_SEG only: w[1] the sc | mn bytes [., K / 16], w[2] the
  // d | dmin bf16 [., K / 128])
  template <bool S6 = false>
  __device__ __forceinline__ void matrix(const void* const* w, Range rg,
                                         int K) {
    const uint8_t* qs = static_cast<const uint8_t*>(w[0]);
    const uint8_t* es = static_cast<const uint8_t*>(w[1]);
    const uint8_t* em = static_cast<const uint8_t*>(w[2]);
    if constexpr (S6) {
      for (int r = rg.r0; r < rg.r1; r += LK_ROWS) {
        const int nr = min(LK_ROWS, rg.r1 - r);
        const unsigned dst = begin(nr * LK_S6_ROW);
        if (lane == 0) {
          copy(dst, qs + (size_t)r * LK_QS, nr * LK_QS);
          copy(dst + LK_ROWS * LK_QS, es + (size_t)r * 2 * LK_S6_SC,
               nr * 2 * LK_S6_SC);
          copy(dst + LK_ROWS * (LK_QS + 2 * LK_S6_SC),
               em + (size_t)r * 2 * LK_S6_D, nr * 2 * LK_S6_D);
        }
        end();
      }
    } else {
      const int segs = K / LK_SEG;
      for (int r = rg.r0; r < rg.r1; r += LK_ROWS) {
        const int nr = min(LK_ROWS, rg.r1 - r);
        for (int sg = 0; sg < segs; ++sg) {
          const unsigned dst = begin(nr * (LK_QS + 2 * LK_SC));
          if (lane < nr) {
            const size_t row = (size_t)(r + lane);
            copy(dst + lane * LK_QS, qs + row * (K / 2) + sg * LK_QS, LK_QS);
            copy(dst + LK_ROWS * LK_QS + lane * LK_SC,
                 es + row * (K / 16) + sg * LK_SC, LK_SC);
            copy(dst + LK_ROWS * (LK_QS + LK_SC) + lane * LK_SC,
                 em + row * (K / 16) + sg * LK_SC, LK_SC);
          }
          end();
        }
      }
    }
  }

  // one f32 vector of LK_DIM (a layer's norm weights)
  __device__ __forceinline__ void vec(const float* v) {
    const unsigned dst = begin(4 * LK_DIM);
    if (lane == 0) copy(dst, v, 4 * LK_DIM);
    end();
  }

  // the valid K / V rows of this CTA's attention items of cache layer li
  __device__ __forceinline__ void attention(const FusedArgs& p, int li,
                                            const AttnPlan& ap, int tk,
                                            int rowb) {
    const unsigned char* kc = static_cast<const unsigned char*>(p.kc);
    const unsigned char* vc = static_cast<const unsigned char*>(p.vc);
    for (int it = blockIdx.x; it < ap.items; it += gridDim.x) {
      const int g = it / ap.n_splits, s = it % ap.n_splits;
      int t0, t1;
      ap.split(s, &t0, &t1);
      const size_t row0 = ((size_t)li * p.Hkv + g) * p.S;
      for (int t = t0; t < t1; ++t) {
        const int k0 = t * tk, nk = min(tk, ap.length - k0);
        const unsigned dst = begin(2 * nk * rowb);
        if (lane == 0) {
          const size_t off = (row0 + k0) * rowb;
          copy(dst, kc + off, nk * rowb);
          copy(dst + LK_KV, vc + off, nk * rowb);
        }
        end();
      }
    }
  }
};

// ---- the consumers

// rsqrt(sum(h^2) / dim + eps), the same value in every CTA (fixed order;
// a thread's loads issue together); h staged into hs on the way
__device__ __forceinline__ float lk_rms(const float* h, float* hs,
                                        float eps, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[LK_DIM / LK_CTHREADS];
#pragma unroll
  for (int k = 0; k < LK_DIM / LK_CTHREADS; ++k)
    v[k] = __ldcg(h + threadIdx.x + k * LK_CTHREADS);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LK_DIM / LK_CTHREADS; ++k) {
    s = __fmaf_rn(v[k], v[k], s);
    hs[threadIdx.x + k * LK_CTHREADS] = v[k];
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  cbar();
  if (warp == 0) {
    float t = lane < LK_CWARPS ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  cbar();
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(red[32], (float)LK_DIM), eps));
  cbar();
  return r;
}

// q8_quant over the consumer threads, LK_QB blocks a half-warp a batch
constexpr int LK_QB = 4;

template <class Src>
__device__ __forceinline__ void lk_quant(const Src& src, const Q8Act& a) {
  constexpr int HW = LK_CTHREADS / 16;            // half-warps
  const int t = threadIdx.x & 15;
  for (int b0 = threadIdx.x >> 4; b0 < a.kb; b0 += HW * LK_QB) {
    float2 lo[LK_QB], hi[LK_QB];
#pragma unroll
    for (int j = 0; j < LK_QB; ++j) {
      const int b = b0 + HW * j;               // b < kb alike in a warp
      if (b < a.kb) {
        lo[j] = src.load(32 * b + t);
        hi[j] = src.load(32 * b + 16 + t);
      }
    }
#pragma unroll
    for (int j = 0; j < LK_QB; ++j) {
      const int b = b0 + HW * j;
      if (b < a.kb) q8_quant_vals(src.value(lo[j]), src.value(hi[j]), a, b, t);
    }
  }
  cbar();
}

// one unit's row dot of warp `w` over segment sg: q8_row_dot's per-lane
// sum of blocks sg * 128 + lane + 32 u, from the slot (S6: its s6 layout,
// f32(d) * sc and f32(dmin) * mn as Q4KS6 decodes them)
template <bool S6 = false>
__device__ __forceinline__ float unit_dot(const unsigned char* slot, int w,
                                          const Q8Act& a, int sg, int lane,
                                          float acc) {
  const uint4* q = reinterpret_cast<const uint4*>(slot + w * LK_QS);
  uint4 wq[4];
  float s[4], mn[4];
  if constexpr (S6) {
    const int8_t* sc = reinterpret_cast<const int8_t*>(
        slot + LK_ROWS * LK_QS + w * 2 * LK_S6_SC);
    const int8_t* mv = sc + LK_S6_SC;
    const uint16_t* d = reinterpret_cast<const uint16_t*>(
        slot + LK_ROWS * (LK_QS + 2 * LK_S6_SC) + w * 2 * LK_S6_D);
    const uint16_t* dm = d + LK_S6_D / 2;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int bl = lane + 32 * u;
      wq[u] = q[bl];
      Q4KS6::from(sc[bl], mv[bl], d[bl >> 3], dm[bl >> 3], s[u], mn[u]);
    }
  } else {
    const bf16* es =
        reinterpret_cast<const bf16*>(slot + LK_ROWS * LK_QS + w * LK_SC);
    const bf16* em = reinterpret_cast<const bf16*>(
        slot + LK_ROWS * (LK_QS + LK_SC) + w * LK_SC);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wq[u] = q[lane + 32 * u];
      s[u] = __bfloat162float(es[lane + 32 * u]);
      mn[u] = __bfloat162float(em[lane + 32 * u]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int b = sg * (LK_SEG / 32) + lane + 32 * u;
    const int4 av = *reinterpret_cast<const int4*>(a.aq + 16 * b);
    const int4 bv = *reinterpret_cast<const int4*>(a.bq + 16 * b);
    int zl = __dp4a((int)(wq[u].x & 0x0F0F0F0Fu), av.x, 0);
    zl = __dp4a((int)(wq[u].y & 0x0F0F0F0Fu), av.y, zl);
    zl = __dp4a((int)(wq[u].z & 0x0F0F0F0Fu), av.z, zl);
    zl = __dp4a((int)(wq[u].w & 0x0F0F0F0Fu), av.w, zl);
    int zp = __dp4a((int)(wq[u].x ^ 0x80808080u), bv.x, 0);
    zp = __dp4a((int)(wq[u].y ^ 0x80808080u), bv.y, zp);
    zp = __dp4a((int)(wq[u].z ^ 0x80808080u), bv.z, zp);
    zp = __dp4a((int)(wq[u].w ^ 0x80808080u), bv.w, zp);
    const float z = a.sa[b] * (float)zl + a.sb[b] * (float)zp + a.c[b];
    acc += s[u] * z - mn[u] * a.xs[b];
  }
  return acc;
}

struct Consumer {
  Ring ring;
  unsigned ch;
  int warp, lane;

  __device__ __forceinline__ const unsigned char* wait() const {
    mbar_wait(ring.full_bar(ch), Ring::parity(ch));
    return ring.slot(ch);
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty_bar(ch));
    ++ch;
  }

  // RMSNorm of h (from L2, staged in hs) times the norm weights of the next
  // chunk, quantized into a
  __device__ __forceinline__ void entry(const float* h, float eps,
                                        float* hs, float* red,
                                        const Q8Act& a, bool compute) {
    const float* w = reinterpret_cast<const float*>(wait());
    if (compute) lk_quant(NormVec{hs, w, lk_rms(h, hs, eps, red)}, a);
    release();
  }

  // rows rg of a matrix [., K] against the operands a; store(n, y) by
  // lane 0 of the row's warp (S6: the producer's s6 units)
  template <bool S6 = false, class Store>
  __device__ __forceinline__ void matrix(Range rg, int K, const Q8Act& a,
                                         bool compute, const Store& store) {
    const int segs = K / LK_SEG;
    for (int r = rg.r0; r < rg.r1; r += LK_ROWS) {
      const bool mine = compute && warp < rg.r1 - r;
      float acc = 0.f;
      for (int sg = 0; sg < segs; ++sg) {
        const unsigned char* slot = wait();
        if (mine) acc = unit_dot<S6>(slot, warp, a, sg, lane, acc);
        release();
      }
      if (mine) {
        const float y = warp_sum(acc);
        if (lane == 0) store(r + warp, y);
      }
    }
  }
};

// K / V elements [4 lane, 4 lane + 4) of a row in shared memory
template <typename T> __device__ void row4(const unsigned char* r, int lane,
                                           float (&f)[4]);
template <> __device__ __forceinline__ void row4<bf16>(
    const unsigned char* r, int lane, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(r + 8 * lane);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
template <> __device__ __forceinline__ void row4<float>(
    const unsigned char* r, int lane, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(r + 16 * lane);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// the 4 R blocks of o [R HD] of KV head g's query heads into the image go
// (an even count: both halves of a warp take one)
template <int R>
__device__ __forceinline__ void lk_quant_head(const float* o, int g,
                                              const Q8Act& go) {
  const int t = threadIdx.x & 15;
  for (int j = threadIdx.x >> 4; j < 4 * R; j += LK_CTHREADS / 16)
    q8_quant_vals(o[32 * j + t], o[32 * j + 16 + t], go, g * 4 * R + j, t);
  cbar();
}

// The last CTA to finish a split of KV head g (a ticket a layer and head,
// set back to 0 by that CTA) merges the splits of its R query heads in
// split order (M = max m_s, e_s = exp(m_s - M), L = sum l_s e_s, o = sum
// A_s e_s / L) and quantizes their 4 R blocks of o into the image go,
// which every CTA copies after the next grid barrier.
template <int R>
__device__ __forceinline__ void lk_merge_head(const FusedArgs& p, int lyr,
                                              int g, int n, float* o,
                                              float* red, const Q8Act& go) {
  int* flag = reinterpret_cast<int*>(red + 40);
  if (threadIdx.x == 0) {
    unsigned* tick = p.bar + 2 + LK_MAX_HKV * lyr + g;
    const bool last = atom_acq_rel(tick, 1u) == (unsigned)n - 1;
    if (last) atomicExch(tick, 0u);
    *flag = last;
  }
  cbar();
  if (!*flag) return;
  // the (m, l) of every (head, split) into shared memory behind o (at most
  // 8 x 64 pairs), and with them the first 8 splits' A of a thread's first
  // output; then the rest 8 splits a batch
  float* ml = o + 8 * HD;
  const float* pg = p.part + (size_t)g * R * n * PART;
  auto load8 = [&](int i, int s0, float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = s0 + j < n ? __ldcg(pg + ((size_t)(i / HD) * n + s0 + j) * PART +
                                 2 + i % HD)
                        : 0.f;
  };
  for (int i = threadIdx.x; i < R * n; i += LK_CTHREADS) {
    ml[2 * i] = __ldcg(pg + (size_t)i * PART);
    ml[2 * i + 1] = __ldcg(pg + (size_t)i * PART + 1);
  }
  float first[8];
  if (threadIdx.x < R * HD) load8(threadIdx.x, 0, first);
  cbar();
  for (int i = threadIdx.x; i < R * HD; i += LK_CTHREADS) {
    const float* mh = ml + 2 * (i / HD) * n;
    float M = -INFINITY;
    for (int s = 0; s < n; ++s) M = fmaxf(M, mh[2 * s]);
    float L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < n; s0 += 8) {
      float v[8];
      if (i == threadIdx.x && s0 == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = first[j];
      } else {
        load8(i, s0, v);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s0 + j < n) {
          const float ms = mh[2 * (s0 + j)];
          const float e = ms == -INFINITY ? 0.f : expf(ms - M);
          L += mh[2 * (s0 + j) + 1] * e;
          A += v[j] * e;
        }
      }
    }
    o[i] = __fdiv_rn(A, L);
  }
  cbar();
  lk_quant_head<R>(o, g, go);
}

// `bytes` (a multiple of 16) from an image in device memory (other CTAs'
// stores) into shared memory
__device__ __forceinline__ void lk_copy(const void* src, void* dst, int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += LK_CTHREADS)
    d[i] = __ldcg(s + i);
  cbar();
}

// The CTA's blocks mb of the mid, silu(g) * u from gu = [gate | up] values
// of those blocks in shared memory, into the image a (a half-warp a block;
// where a warp's second half has no block it redoes the first's, storing
// the same values).
__device__ __forceinline__ void lk_mid_quant(const float* gu, Range mb,
                                             const Q8Act& a) {
  const int nb = mb.r1 - mb.r0, n = 32 * nb, t = threadIdx.x & 15;
  const MidVec mid{nullptr, 0};
  for (int j0 = 2 * (threadIdx.x >> 5); j0 < nb; j0 += 2 * LK_CWARPS) {
    const int j = min(j0 + ((threadIdx.x >> 4) & 1), nb - 1);
    const float xl = mid.value(make_float2(gu[32 * j + t], gu[n + 32 * j + t]));
    const float xh = mid.value(
        make_float2(gu[32 * j + 16 + t], gu[n + 32 * j + 16 + t]));
    q8_quant_vals(xl, xh, a, mb.r0 + j, t);
  }
}

// The attention items of this CTA (KV head g, split s): every warp owns
// keys ks, ks + WPH, ... of each tile for query head hh (warp = hh WPH +
// ks), an online softmax over them, the WPH warps of a head folded in warp
// order into the item's partial. Lane l holds dims 4l .. 4l+3; the
// rotate-half partner of dim d (d ^ 64) sits in lane l ^ 16.
template <int R, typename T>
__device__ __forceinline__ void lk_attention(Consumer& cs,
                                             const FusedArgs& p, int lyr,
                                             int lb, const AttnPlan& ap,
                                             bool compute, bool merge,
                                             float* fold, const float* rope,
                                             float* red, const Q8Act& go) {
  constexpr int TK = LK_KV / (HD * (int)sizeof(T));     // keys a tile
  constexpr int ROWB = HD * (int)sizeof(T);
  constexpr int WPH = LK_CWARPS / R;                    // warps a head
  constexpr int NKW = TK / WPH;                         // keys a warp a tile
  const int lane = cs.lane, warp = cs.warp;
  const int hh = warp / WPH, ks = warp % WPH, d0 = 4 * lane;
  T* kn_out = static_cast<T*>(p.kn) + (size_t)lyr * p.Hkv * HD;
  T* vn_out = static_cast<T*>(p.vn) + (size_t)lyr * p.Hkv * HD;
  for (int it = blockIdx.x; it < ap.items; it += gridDim.x) {
    const int g = it / ap.n_splits, s = it % ap.n_splits;
    int t0, t1;
    ap.split(s, &t0, &t1);
    float q[4], kn[4], vn[4], m = -INFINITY, l = 0.f, acc[4] = {0, 0, 0, 0};
    if (compute) {
      float ck[4], sk[4], cq[4], sq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ck[j] = rope[d0 + j];
        sk[j] = rope[HD + d0 + j];
        cq[j] = rope[2 * HD + d0 + j];
        sq[j] = rope[3 * HD + d0 + j];
      }
      const float* qsrc = p.yqkv + (size_t)(g * R + hh) * HD + d0;
      const float* ksrc = p.yqkv + (size_t)(p.Hq + g) * HD + d0;
      const float* vsrc = p.yqkv + (size_t)(p.Hq + p.Hkv + g) * HD + d0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = __ldcg(qsrc + j);
        const float pq = __shfl_xor_sync(0xffffffffu, v, 16);
        q[j] = __fadd_rn(__fmul_rn(v, cq[j]), __fmul_rn(pq, sq[j]));
        const float k = __ldcg(ksrc + j);
        const float pk = __shfl_xor_sync(0xffffffffu, k, 16);
        kn[j] = CacheIO<T>::round(
            __fadd_rn(__fmul_rn(k, ck[j]), __fmul_rn(pk, sk[j])));
        vn[j] = CacheIO<T>::round(__ldcg(vsrc + j));
      }
      if (s == 0 && warp == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          CacheIO<T>::store(kn_out + (size_t)g * HD + d0 + j, kn[j]);
          CacheIO<T>::store(vn_out + (size_t)g * HD + d0 + j, vn[j]);
        }
      }
    }
    for (int t = t0; t < t1; ++t) {
      const unsigned char* slot = cs.wait();
      if (compute) {
        const int key0 = t * TK;
        // every key's partial dot first (rows past the length are stale
        // and masked below), then the NKW warp sums side by side, each in
        // warp_sum's butterfly order
        float sc[NKW], tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < NKW; ++i) {
          const int kk = ks + WPH * i;
          float kf[4];
          row4<T>(slot + kk * ROWB, lane, kf);
          if (key0 + kk == lb) {
#pragma unroll
            for (int j = 0; j < 4; ++j) kf[j] = kn[j];
          }
          sc[i] = q[0] * kf[0] + q[1] * kf[1] + q[2] * kf[2] + q[3] * kf[3];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int i = 0; i < NKW; ++i)
            sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], o);
        }
#pragma unroll
        for (int i = 0; i < NKW; ++i) {
          if (key0 + ks + WPH * i >= ap.length) sc[i] = -INFINITY;
          tmax = fmaxf(tmax, sc[i]);
        }
        const float mn = fmaxf(m, tmax);
        if (mn != -INFINITY) {
          const float alpha = expf(m - mn);
          l *= alpha;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] *= alpha;
#pragma unroll
          for (int i = 0; i < NKW; ++i) {
            if (sc[i] == -INFINITY) continue;
            const int kk = ks + WPH * i;
            const float pe = expf(sc[i] - mn);
            float vf[4];
            if (key0 + kk == lb) {
#pragma unroll
              for (int j = 0; j < 4; ++j) vf[j] = vn[j];
            } else {
              row4<T>(slot + LK_KV + kk * ROWB, lane, vf);
            }
            l += pe;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] += pe * vf[j];
          }
          m = mn;
        }
      }
      cs.release();
    }
    if (!compute) continue;
    // fold the WPH warps of each head in warp order: fold [warp][PART]; a
    // single split's fold is o (= A / L, as its merge would give), into o1
    const bool one = merge && ap.n_splits == 1;
    float* o1 = fold + LK_CWARPS * PART;
    float* dst = fold + warp * PART;
    if (lane == 0) {
      dst[0] = m;
      dst[1] = l;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[2 + d0 + j] = acc[j];
    cbar();
    for (int t = threadIdx.x; t < R * HD; t += LK_CTHREADS) {
      const int h = t / HD, d = t % HD;
      const float* src = fold + h * WPH * PART;
      float M = -INFINITY;
      for (int w = 0; w < WPH; ++w) M = fmaxf(M, src[w * PART]);
      float L = 0.f, A = 0.f;
      if (M != -INFINITY) {
        for (int w = 0; w < WPH; ++w) {
          const float* sw = src + w * PART;
          const float e = sw[0] == -INFINITY ? 0.f : expf(sw[0] - M);
          L += sw[1] * e;
          A += sw[2 + d] * e;
        }
      }
      if (one) {
        o1[t] = __fdiv_rn(A, L);
        continue;
      }
      float* out = p.part + ((size_t)(g * R + h) * ap.n_splits + s) * PART;
      if (d == 0) {
        out[0] = M;
        out[1] = L;
      }
      out[2 + d] = A;
    }
    cbar();
    if (one)
      lk_quant_head<R>(o1, g, go);
    else if (merge)
      lk_merge_head<R>(p, lyr, g, ap.n_splits, fold, red, go);
  }
}

template <typename T>
__device__ __forceinline__ void lk_attention_r(Consumer& cs,
                                               const FusedArgs& p, int lyr,
                                               int lb, const AttnPlan& ap,
                                               bool compute, bool merge,
                                               float* fold, const float* rope,
                                               float* red, const Q8Act& go) {
  switch (p.Hq / p.Hkv) {
#define LK_ATTN(R)                                                          \
  lk_attention<R, T>(cs, p, lyr, lb, ap, compute, merge, fold, rope, red, \
                     go);                                                   \
  break
    case 1: LK_ATTN(1);
    case 2: LK_ATTN(2);
    case 4: LK_ATTN(4);
    default: LK_ATTN(8);
#undef LK_ATTN
  }
}

// shared memory: the ring, the operands (48 B a block of the widest
// vector), LK_DIM floats used in turn by the RMSNorm's staged h, the
// attention's fold and the CTA's gate and up outputs (at most 64 mid blocks
// a CTA), the RoPE rows, the block reduction, the mbarriers
static_assert(LK_FOLD <= LK_DIM, "the fold fits the staging floats");

__host__ __device__ constexpr int lk_smem_bytes(int kd) {
  return LK_STAGES * LK_SLOT + q8_act_bytes((kd > LK_DIM ? kd : LK_DIM) / 32) +
         4 * LK_DIM + 4 * 4 * HD + RED_BYTES + 2 * LK_STAGES * 8;
}

// BLOCK = false: nL whole layers (layer_step, model_step). BLOCK = true:
// one attention block (fused_attention): x quantized as it is given (no
// norm), wqkv | the attention, its last split's merge | W_o into out (no
// residual); the producer streams x (the first chunk, ahead of the weight
// stream that would queue an L2 read of it), wqkv, the K / V tiles and
// W_o, from the six pointers of p.w, and o's image lies at the start of
// p.ygu. S6 (BLOCK only): wqkv and W_o are s6 weights (units of
// LK_S6_ROW bytes a row).

template <bool BLOCK, bool S6 = false>
__global__ void __launch_bounds__(LK_THREADS, 1)
layer_decode_kernel(FusedArgs p) {
  static_assert(BLOCK || !S6, "the layer kernel takes no s6 weight");
  extern __shared__ __align__(128) unsigned char lk_sm[];
  unsigned char* act_base = lk_sm + LK_STAGES * LK_SLOT;
  const int kb_max = (p.Kd > LK_DIM ? p.Kd : LK_DIM) / 32;
  float* gu = reinterpret_cast<float*>(act_base + q8_act_bytes(kb_max));
  float* fold = gu;
  float* rope = gu + LK_DIM;                      // [4][HD]: ck, sk, cq, sq
  float* red = rope + 4 * HD;
  unsigned char* bars = reinterpret_cast<unsigned char*>(red) + RED_BYTES;
  const Ring ring{lk_sm, lk_smem(bars), lk_smem(bars + 8 * LK_STAGES)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < LK_STAGES; ++i) {
      mbar_init(ring.full + 8 * i, 1);
      mbar_init(ring.empty + 8 * i, LK_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the length, read once at the start while the memory system is idle (a
  // load behind the weight stream waits microseconds); the producer uses it
  // only when it reaches the K / V tiles, so its first copies issue at once
  const int lb = p.lengths[0];
  const int rowb = p.cache_f32 ? HD * 4 : HD * 2;
  const int tk = LK_KV / rowb;
  const int nq = (p.Hq + 2 * p.Hkv) * HD;
  // w_gu = [gate; up]: this CTA's whole 32-blocks mb of the mid, their gate
  // and up rows, so that it quantizes them itself
  const Range mb = lk_slice(p.Kd / 32);
  const Range gate{32 * mb.r0, 32 * mb.r1};
  const Range up{p.Kd + 32 * mb.r0, p.Kd + 32 * mb.r1};

  if (warp == LK_CWARPS) {                       // the producer
    Producer pr{ring, 0u, lane};
    if constexpr (BLOCK) {
      const void* w[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) w[i] = p.w[i];
      pr.vec(p.x);
      pr.matrix<S6>(w, lk_slice(nq), LK_DIM);
      pr.attention(p, p.layer0, AttnPlan(lb, p.S, p.Hkv, tk), tk, rowb);
      pr.matrix<S6>(w + 3, lk_slice(LK_DIM), LK_DIM);
      return;
    }
    for (int l = 0; l < p.nL; ++l) {
      const void* w[12];
#pragma unroll
      for (int i = 0; i < 12; ++i)
        w[i] = reinterpret_cast<const void*>(p.ptrs[l * 12 + i]);
      const float* anorm = p.norms + (size_t)(2 * l) * LK_DIM;
      pr.vec(anorm);
      pr.matrix(w, lk_slice(nq), LK_DIM);
      pr.attention(p, p.layer0 + l, AttnPlan(lb, p.S, p.Hkv, tk), tk, rowb);
      pr.matrix(w + 3, lk_slice(LK_DIM), LK_DIM);
      pr.vec(anorm + LK_DIM);
      pr.matrix(w + 6, gate, LK_DIM);
      pr.matrix(w + 6, up, LK_DIM);
      pr.matrix(w + 9, lk_slice(LK_DIM), p.Kd);
    }
    return;
  }

  const AttnPlan ap(lb, p.S, p.Hkv, tk);
  // the RoPE rows at position lb, the same in every layer (rotate-half:
  // out = x * c + roll(x, HD / 2) * s; q's with 1/sqrt(D) folded in)
  if (threadIdx.x < HD) {
    const int d = threadIdx.x;
    const float freq = powf(p.theta, __fdiv_rn(-(float)(d & 63), 64.f));
    const float ang = __fmul_rn((float)lb, freq);
    const float c = cosf(ang), sn = sinf(ang), sk = d < 64 ? -sn : sn;
    rope[d] = c;
    rope[HD + d] = sk;
    rope[2 * HD + d] = __fmul_rn(c, p.scale);
    rope[3 * HD + d] = __fmul_rn(sk, p.scale);
  }
  cbar();
  const PhaseFlags f = phase_flags(p.phase);
  Consumer cs{ring, 0u, warp, lane};
  unsigned* gbar = p.bar;
  unsigned nbar = 0;
  auto sync = [&]() {
    if (f.sync) grid_barrier(gbar, ++nbar * gridDim.x);
  };
  const Q8Act ax = q8_act_at(act_base, LK_DIM / 32);
  const Q8Act am = q8_act_at(act_base, p.Kd / 32);
  // operand images in device memory (the ygu workspace): the mid's, each
  // block built by the CTA that owns its gate and up rows, and o's, by the
  // last split of each KV head; every CTA copies an image whole
  unsigned char* img = reinterpret_cast<unsigned char*>(p.ygu);
  const Q8Act gmid = q8_act_at(img, p.Kd / 32);
  unsigned char* oimg = BLOCK ? img : img + q8_act_bytes(p.Kd / 32);
  const Q8Act go = q8_act_at(oimg, LK_DIM / 32);
  const int ng = gate.r1 - gate.r0;
  float* yqkv = p.yqkv;
  float* h2 = p.h2;
  float* hout = p.out;
  if constexpr (BLOCK) {
    {
      const float* xs = reinterpret_cast<const float*>(cs.wait());
      lk_quant(XVec{xs}, ax);
      cs.release();
    }
    cs.matrix<S6>(lk_slice(nq), LK_DIM, ax, true,
                  [&](int n, float v) { yqkv[n] = v; });
    sync();
    // RoPE, the new k / v, the split partials; the last split of a KV
    // head merges it and quantizes its o into the image go
    if (p.cache_f32)
      lk_attention_r<float>(cs, p, 0, lb, ap, f.attn, f.attn && f.merge,
                            fold, rope, red, go);
    else
      lk_attention_r<bf16>(cs, p, 0, lb, ap, f.attn, f.attn && f.merge,
                           fold, rope, red, go);
    sync();
    lk_copy(oimg, act_base, q8_act_bytes(LK_DIM / 32));
    cs.matrix<S6>(lk_slice(LK_DIM), LK_DIM, ax, true,
                  [&](int n, float v) { hout[n] = v; });
  } else {
    for (int l = 0; l < p.nL; ++l) {
      const float* h = l == 0 ? p.x : p.out;

      // attn RMSNorm, wqkv
      cs.entry(h, p.eps, gu, red, ax, f.entry);
      cs.matrix(lk_slice(nq), LK_DIM, ax, f.pack,
                [&](int n, float v) { yqkv[n] = v; });
      sync();
      // RoPE, the new k / v, the split partials; the last split of a KV
      // head merges it and quantizes its o into the image go
      if (p.cache_f32)
        lk_attention_r<float>(cs, p, l, lb, ap, f.attn, f.attn && f.merge,
                              fold, rope, red, go);
      else
        lk_attention_r<bf16>(cs, p, l, lb, ap, f.attn, f.attn && f.merge,
                             fold, rope, red, go);
      sync();
      // W_o, attention residual
      if (f.merge) lk_copy(oimg, act_base, q8_act_bytes(LK_DIM / 32));
      cs.matrix(lk_slice(LK_DIM), LK_DIM, ax, f.pack, [&](int n, float v) {
        h2[n] = __fadd_rn(__ldcg(h + n), v);
      });
      sync();
      // MLP RMSNorm, w_gu (this CTA's gate and up rows of its mid blocks)
      cs.entry(h2, p.eps, gu, red, ax, f.entry);
      cs.matrix(gate, LK_DIM, ax, f.pack,                 // gu = [gate | up]
                [&](int n, float v) { gu[n - gate.r0] = v; });
      cs.matrix(up, LK_DIM, ax, f.pack,
                [&](int n, float v) { gu[ng + n - up.r0] = v; });
      cbar();
      if (f.mid) lk_mid_quant(gu, mb, gmid);
      sync();
      // w_down, MLP residual
      if (f.mid) lk_copy(img, act_base, q8_act_bytes(p.Kd / 32));
      cs.matrix(lk_slice(LK_DIM), p.Kd, am, f.down, [&](int n, float v) {
        hout[n] = __fadd_rn(v, __ldcg(h2 + n));
      });
      if (l + 1 < p.nL) sync();
    }
  }
  // the last CTA out sets the barrier counter back to 0 for the next launch
  cbar();
  if (threadIdx.x == 0 && atom_acq_rel(gbar + 1, 1u) == gridDim.x - 1) {
    atomicExch(gbar, 0u);
    atomicExch(gbar + 1, 0u);
  }
}

// ---------------------------------------------------------------- launch

// A cooperative launch of `kernel` with `threads` threads and `smem` bytes,
// the grid every SM's resident CTAs (cached per kernel and size in the
// caller's statics); check(grid) may refuse the launch.
template <typename Kernel, typename Check>
static int launch_coop(Kernel kernel, FusedArgs& a, int threads, int smem,
                       int* granted, int* cached_smem, int* per_sm, int* sms,
                       const Check& check, void* stream) {
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  if (*cached_smem != smem) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             per_sm, kernel, threads, smem)) != cudaSuccess)
      return (int)e;
    if (*per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    *cached_smem = smem;
  }
  const int grid = *per_sm * *sms;
  if (!check(grid)) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(threads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool S6>
static int launch_mlp(FusedArgs& a, void* stream) {
  static int granted = 0, sms = 0, cached_smem = -1, per_sm = 0;
  const int kb_max = (a.Kd > a.dim ? a.Kd : a.dim) / 32;
  const int smem = RED_BYTES + 4 * a.dim + q8_act_bytes(kb_max);
  return launch_coop(S6 ? fused_mlp_s6_kernel : fused_mlp_kernel, a,
                     Q8_THREADS, smem, &granted,
                     &cached_smem, &per_sm, &sms, [](int) { return true; },
                     stream);
}

template <bool BLOCK, bool S6 = false>
static int launch_layers(FusedArgs& a, void* stream) {
  static int granted = 0, sms = 0, cached_smem = -1, per_sm = 0;
  return launch_coop(
      layer_decode_kernel<BLOCK, S6>, a,
      LK_THREADS, lk_smem_bytes(a.Kd),
      &granted, &cached_smem, &per_sm, &sms,
      [&](int grid) {
        return (a.Kd / 32 + grid - 1) / grid <= LK_DIM / 64 &&
               a.Hkv <= LK_MAX_HKV && a.nL <= LK_MAX_LAYERS;
      },
      stream);
}

// the shapes and addresses both layer-kernel entries need: whole 4096-wide
// units of K and of rows, a GQA ratio of at most 8, and 16-byte aligned
// TMA sources (the wrappers check the weights' and the caches' pointers)
static bool lk_shape_ok(int Hq, int Hkv, int Kd, const void* kc,
                        const void* vc) {
  return Hq * HD == LK_DIM && Kd % LK_SEG == 0 && Hkv >= 1 && Hq % Hkv == 0 &&
         Hq / Hkv <= 8 && (((uintptr_t)kc | (uintptr_t)vc) & 15) == 0;
}

template <bool S6>
static int fused_mlp_run(const float* x, const void* gu_qs,
                         const void* gu_es, const void* gu_em,
                         const void* d_qs, const void* d_es,
                         const void* d_em, float* ygu, float* y, int Kg,
                         int Kd, int Nd, void* stream) {
  FusedArgs a = {};
  a.x = x;
  a.w[6] = gu_qs; a.w[7] = gu_es; a.w[8] = gu_em;
  a.w[9] = d_qs; a.w[10] = d_es; a.w[11] = d_em;
  a.dim = Kg;
  a.Kd = Kd;
  a.Nd = Nd;
  a.ygu = ygu;
  a.out = y;
  return launch_mlp<S6>(a, stream);
}

GCT_EXPORT int fused_mlp(const float* x, const void* gu_qs, const void* gu_es,
                         const void* gu_em, const void* d_qs,
                         const void* d_es, const void* d_em, float* ygu,
                         float* y, int Kg, int Kd, int Nd, void* stream) {
  return fused_mlp_run<false>(x, gu_qs, gu_es, gu_em, d_qs, d_es, d_em, ygu,
                              y, Kg, Kd, Nd, stream);
}

// the s6 instance: each weight's (qs, sm, dd)
GCT_EXPORT int fused_mlp_s6(const float* x, const void* gu_qs,
                            const void* gu_sm, const void* gu_dd,
                            const void* d_qs, const void* d_sm,
                            const void* d_dd, float* ygu, float* y, int Kg,
                            int Kd, int Nd, void* stream) {
  return fused_mlp_run<true>(x, gu_qs, gu_sm, gu_dd, d_qs, d_sm, d_dd, ygu,
                             y, Kg, Kd, Nd, stream);
}

template <bool S6>
static int fused_attention_run(
    const float* x, const void* q_qs, const void* q_es, const void* q_em,
    const void* o_qs, const void* o_es, const void* o_em, const void* kc,
    const void* vc, const int* lengths, int layer, int Hq, int Hkv,
    int S, int cache_f32, float theta, float scale, float* yqkv, float* part,
    float* oimg, float* o, void* kn, void* vn, unsigned* bar, void* stream) {
  const void* w[6] = {q_qs, q_es, q_em, o_qs, o_es, o_em};
  uintptr_t align = (uintptr_t)x;
  for (const void* p : w) align |= (uintptr_t)p;
  if (!lk_shape_ok(Hq, Hkv, LK_DIM, kc, vc) || (align & 15))
    return (int)cudaErrorInvalidValue;
  FusedArgs a = {};
  a.x = x;
  for (int i = 0; i < 6; ++i) a.w[i] = w[i];
  a.kc = kc;
  a.vc = vc;
  a.lengths = lengths;
  a.layer0 = layer;
  a.nL = 1;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.dim = Hq * HD;
  a.Kd = LK_DIM;
  a.cache_f32 = cache_f32;
  a.theta = theta;
  a.scale = scale;
  a.yqkv = yqkv;
  a.part = part;
  a.ygu = oimg;
  a.out = o;
  a.kn = kn;
  a.vn = vn;
  a.phase = PH_ALL;
  a.bar = bar;
  return launch_layers<true, S6>(a, stream);
}

GCT_EXPORT int fused_attention(
    const float* x, const void* q_qs, const void* q_es, const void* q_em,
    const void* o_qs, const void* o_es, const void* o_em, const void* kc,
    const void* vc, const int* lengths, int layer, int Hq, int Hkv,
    int S, int cache_f32, float theta, float scale, float* yqkv, float* part,
    float* oimg, float* o, void* kn, void* vn, unsigned* bar, void* stream) {
  return fused_attention_run<false>(
      x, q_qs, q_es, q_em, o_qs, o_es, o_em, kc, vc, lengths, layer, Hq, Hkv,
      S, cache_f32, theta, scale, yqkv, part, oimg, o, kn, vn, bar, stream);
}

// the s6 instance: wqkv's and W_o's (qs, sm, dd), every one on 16 bytes
GCT_EXPORT int fused_attention_s6(
    const float* x, const void* q_qs, const void* q_sm, const void* q_dd,
    const void* o_qs, const void* o_sm, const void* o_dd, const void* kc,
    const void* vc, const int* lengths, int layer, int Hq, int Hkv,
    int S, int cache_f32, float theta, float scale, float* yqkv, float* part,
    float* oimg, float* o, void* kn, void* vn, unsigned* bar, void* stream) {
  return fused_attention_run<true>(
      x, q_qs, q_sm, q_dd, o_qs, o_sm, o_dd, kc, vc, lengths, layer, Hq, Hkv,
      S, cache_f32, theta, scale, yqkv, part, oimg, o, kn, vn, bar, stream);
}

GCT_EXPORT int layer_kernel(
    const float* h, const long long* ptrs, const float* norms, const void* kc,
    const void* vc, const int* lengths, int layer0, int nL, int Hq,
    int Hkv, int S, int Kd, int cache_f32, float theta, float scale,
    float eps, float* yqkv, float* part, float* ygu, float* h2, float* hout,
    void* kn, void* vn, unsigned* bar, int phase, void* stream) {
  if (phase < PH_ALL || phase > PH_NO_SYNC || nL < 1 ||
      !lk_shape_ok(Hq, Hkv, Kd, kc, vc))
    return (int)cudaErrorInvalidValue;
  FusedArgs a = {};
  a.x = h;
  a.ptrs = ptrs;
  a.norms = norms;
  a.kc = kc;
  a.vc = vc;
  a.lengths = lengths;
  a.layer0 = layer0;
  a.nL = nL;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.dim = Hq * HD;
  a.Kd = Kd;
  a.cache_f32 = cache_f32;
  a.theta = theta;
  a.scale = scale;
  a.eps = eps;
  a.yqkv = yqkv;
  a.part = part;
  a.ygu = ygu;
  a.h2 = h2;
  a.out = hout;
  a.kn = kn;
  a.vn = vn;
  a.phase = phase;
  a.bar = bar;
  return launch_layers<false>(a, stream);
}

// registers, shared memory and occupancy of the layer kernel's instances
// (kernel_info in common.cuh): block 0 the whole layers at the padded
// intermediate Kd, 1 the attention block (its Kd is LK_DIM)
GCT_EXPORT int layer_kernel_info(int block, int Kd, int* out) {
  if (Kd < LK_DIM || Kd % LK_SEG) return (int)cudaErrorInvalidValue;
  return block ? kernel_info(layer_decode_kernel<true>, LK_THREADS,
                             lk_smem_bytes(LK_DIM), out)
               : kernel_info(layer_decode_kernel<false>, LK_THREADS,
                             lk_smem_bytes(Kd), out);
}

GCT_EXPORT int kernels_clear_error() { return (int)cudaGetLastError(); }
