// The fused batch-1 decode kernels for Hopper (sm_90a): one cooperative
// launch per call, its phases separated by grid-wide barriers.
//
//   fused_mlp        replaces ops/quant_matmul.py::_fused_mlp_kernel
//                    (mlp_fused): w_gu int8 matvec | silu(g)*u, int8
//                    quantization of the mid, w_down int8 matvec.
//   fused_attention  replaces ops/fused_attention.py::_fused_attn_kernel
//                    (attention_fused): wqkv int8 matvec | RoPE, the new
//                    k / v spliced in, split-KV decode partials | merge,
//                    int8 quantization of o, W_o int8 matvec.
//   layer_kernel     replaces ops/layer_kernel.py::_layer_kernel
//                    (layer_step, model_step): per layer, attn RMSNorm and
//                    the attention phases, residual, MLP RMSNorm and the
//                    MLP phases, residual; nL layers in one launch, h in f32
//                    from layer to layer. Weights come through a device
//                    table of per-layer pointers, so nothing is copied.
//
// Bound on the H100: bytes. At llama2-7b a layer streams 136.3 MB of q4_k
// weights (wqkv 31.5, W_o 10.5, w_gu 62.9, w_down 31.5 MB) plus, at cache
// length 1024, 16.8 MB of bf16 K/V: 45.7 us per layer at 3.35 TB/s, 1.46 ms
// for the 32 layers. Design: every phase spreads its work over all warps
// of the grid (a row per warp at a time, q8_common.cuh; one (KV head, key
// split) per CTA in the attention), and the grid is exactly what is
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs), as a
// cooperative launch requires. Work that every CTA needs whole (an RMSNorm
// of the 4096-vector, the quantized activations, silu(g)*u of the mid, the
// merge of the attention splits) is recomputed by each CTA from L2 instead
// of paying one more barrier. A barrier costs a few microseconds: 5 per
// layer, the price of keeping the whole step in one launch.
//
// Numerics are the JAX kernels' (see q8_common.cuh and the Python
// modules): q roped in f32 with 1/sqrt(D) folded in, k roped in f32 then
// rounded to the cache type, v rounded, the new token at position
// lengths[0]; o, the MLP mid and h stay f32. Sums are taken in a fixed
// order (no atomics), so a launch is deterministic, and the layers of
// model_step equal layer_step's launch by launch.
#include <cooperative_groups.h>

#include "q8_common.cuh"

namespace cg = cooperative_groups;

constexpr int HD = 128;            // head_dim the fused kernels take
constexpr int PART = HD + 2;       // floats per split partial: m, l, acc[HD]
constexpr int MAX_SPLITS = 64;     // as ops/fused_attention.py::MAX_SPLITS
constexpr int RED_BYTES = 256;     // block-reduction scratch

enum { MODE_MLP = 0, MODE_ATTN = 1, MODE_LAYERS = 2 };

struct FusedArgs {
  const float* x;             // MLP / attention input; the layers' h_in
  const long long* ptrs;      // layers: [nL][12] weight pointers
  const float* norms;         // layers: [nL][2][dim]
  const void* w[12];          // MLP / attention weights (same 12 slots)
  const void* kc;
  const void* vc;
  const int* lengths;
  int layer0, nL, Hq, Hkv, S, dim, Kd, Nd, n_splits, cache_f32;
  float theta, scale, eps;
  float* yqkv;                // [(Hq + 2 Hkv) * HD]
  float* part;                // [Hq][n_splits][PART]
  float* ygu;                 // [2 Kd]
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

// ------------------------------------------------------------ sources

// h * rsqrt(mean(h^2) + eps) * w, the JAX layer kernel's f32 RMSNorm
struct NormVec {
  const float* h;
  const float* w;
  float r;
  __device__ float operator()(int i) const {
    return __fmul_rn(__fmul_rn(__ldcg(h + i), r), __ldg(w + i));
  }
};

// silu(g) * u of the MLP's gate / up outputs, in f32
struct MidVec {
  const float* y;
  int kd;
  __device__ float operator()(int i) const {
    const float g = __ldcg(y + i), u = __ldcg(y + kd + i);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    return __fmul_rn(__fmul_rn(g, sig), u);
  }
};

struct SmemVec {
  const float* x;
  __device__ float operator()(int i) const { return x[i]; }
};

// rsqrt(sum(h^2) / dim + eps), the same value in every CTA (fixed order)
__device__ float rms_factor(const float* h, int dim, float eps, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    const float v = __ldcg(h + i);
    s = __fmaf_rn(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(red[32], (float)dim), eps));
  __syncthreads();
  return r;
}

// ----------------------------------------------------------- attention

template <typename T> struct CacheIO;

template <> struct CacheIO<bf16> {
  __device__ static float4 load(const bf16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b),
                       __high2float(b));
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <> struct CacheIO<float> {
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};

// One work item: KV head g, key split s. Its R query heads share every
// K / V row; each warp takes every Q8_WARPS-th key of the split with an
// online softmax per head, then the warps' (m, l, acc) fold in a fixed
// order into the item's partial. Lane l holds dims 4l .. 4l+3; the
// rotate-half partner of dim d (d ^ 64) sits in lane l ^ 16.
template <int R, typename T>
__device__ void attn_item(const FusedArgs& p, int li, int g, int s, int lb,
                          T* kn_out, T* vn_out, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = 4 * lane;
  const float pos = (float)lb;
  float cq[4], sq[4], ck[4], sk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = d0 + j;
    const float freq =
        powf(p.theta, __fdiv_rn(-(float)(d & 63), 64.f));
    const float ang = __fmul_rn(pos, freq);
    const float c = cosf(ang), sn = sinf(ang);
    ck[j] = c;
    sk[j] = d < 64 ? -sn : sn;
    cq[j] = __fmul_rn(ck[j], p.scale);
    sq[j] = __fmul_rn(sk[j], p.scale);
  }
  float q[R][4];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const float* src = p.yqkv + (size_t)(g * R + h) * HD + d0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __ldcg(src + j);
      const float partner = __shfl_xor_sync(0xffffffffu, v, 16);
      q[h][j] = __fadd_rn(__fmul_rn(v, cq[j]), __fmul_rn(partner, sq[j]));
    }
  }
  float kn[4], vn[4];
  {
    const float* ksrc = p.yqkv + (size_t)(p.Hq + g) * HD + d0;
    const float* vsrc = p.yqkv + (size_t)(p.Hq + p.Hkv + g) * HD + d0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __ldcg(ksrc + j);
      const float partner = __shfl_xor_sync(0xffffffffu, v, 16);
      kn[j] = CacheIO<T>::round(
          __fadd_rn(__fmul_rn(v, ck[j]), __fmul_rn(partner, sk[j])));
      vn[j] = CacheIO<T>::round(__ldcg(vsrc + j));
    }
  }
  if (s == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      CacheIO<T>::store(kn_out + (size_t)g * HD + d0 + j, kn[j]);
      CacheIO<T>::store(vn_out + (size_t)g * HD + d0 + j, vn[j]);
    }
  }

  // the new token included, at most the cache: a token past it attends
  // over the cache alone, as the reference's clamped block count does
  const int length = min(lb + 1, p.S);
  const int chunk = (length + p.n_splits - 1) / p.n_splits;
  const int k0 = s * chunk;
  const int k1 = min(k0 + chunk, length);
  const size_t row0 = ((size_t)li * p.Hkv + g) * p.S;
  const T* kc = static_cast<const T*>(p.kc) + row0 * HD + d0;
  const T* vc = static_cast<const T*>(p.vc) + row0 * HD + d0;

  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[h][j] = 0.f;
  }
  for (int key = k0 + warp; key < k1; key += Q8_WARPS) {
    float kf[4], vf[4];
    if (key == lb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = kn[j];
        vf[j] = vn[j];
      }
    } else {
      const float4 k4 = CacheIO<T>::load(kc + (size_t)key * HD);
      const float4 v4 = CacheIO<T>::load(vc + (size_t)key * HD);
      kf[0] = k4.x; kf[1] = k4.y; kf[2] = k4.z; kf[3] = k4.w;
      vf[0] = v4.x; vf[1] = v4.y; vf[2] = v4.z; vf[3] = v4.w;
    }
#pragma unroll
    for (int h = 0; h < R; ++h) {
      float sc = q[h][0] * kf[0] + q[h][1] * kf[1] + q[h][2] * kf[2] +
                 q[h][3] * kf[3];
      sc = warp_sum(sc);
      const float mn = fmaxf(m[h], sc);
      const float alpha = expf(m[h] - mn);
      const float pe = expf(sc - mn);
      l[h] = l[h] * alpha + pe;
      m[h] = mn;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][j] = acc[h][j] * alpha + pe * vf[j];
    }
  }
  // fold the warps: smem [warp][R][PART]
#pragma unroll
  for (int h = 0; h < R; ++h) {
    float* dst = smem + (size_t)(warp * R + h) * PART;
    if (lane == 0) {
      dst[0] = m[h];
      dst[1] = l[h];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[2 + d0 + j] = acc[h][j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * HD; t += blockDim.x) {
    const int h = t / HD, d = t % HD;
    float M = -INFINITY;
    for (int w = 0; w < Q8_WARPS; ++w)
      M = fmaxf(M, smem[(size_t)(w * R + h) * PART]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < Q8_WARPS; ++w) {
        const float* src = smem + (size_t)(w * R + h) * PART;
        const float e = src[0] == -INFINITY ? 0.f : expf(src[0] - M);
        L += src[1] * e;
        A += src[2 + d] * e;
      }
    }
    float* dst = p.part + ((size_t)(g * R + h) * p.n_splits + s) * PART;
    if (d == 0) {
      dst[0] = M;
      dst[1] = L;
    }
    dst[2 + d] = A;
  }
  __syncthreads();
}

template <int R>
__device__ void attention_r(const FusedArgs& p, int li, int lb, int lyr,
                            float* smem) {
  const int items = p.Hkv * p.n_splits;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int g = it / p.n_splits, s = it % p.n_splits;
    if (p.cache_f32)
      attn_item<R, float>(p, li, g, s, lb,
                          static_cast<float*>(p.kn) + (size_t)lyr * p.Hkv * HD,
                          static_cast<float*>(p.vn) + (size_t)lyr * p.Hkv * HD,
                          smem);
    else
      attn_item<R, bf16>(p, li, g, s, lb,
                         static_cast<bf16*>(p.kn) + (size_t)lyr * p.Hkv * HD,
                         static_cast<bf16*>(p.vn) + (size_t)lyr * p.Hkv * HD,
                         smem);
  }
}

// split-KV partials of cache layer li; the new k / v go to row lyr of
// kn / vn
__device__ void attention_phase(const FusedArgs& p, int li, int lyr,
                                float* smem) {
  const int lb = p.lengths[0];
  switch (p.Hq / p.Hkv) {
    case 1: attention_r<1>(p, li, lb, lyr, smem); break;
    case 2: attention_r<2>(p, li, lb, lyr, smem); break;
    case 4: attention_r<4>(p, li, lb, lyr, smem); break;
    default: attention_r<8>(p, li, lb, lyr, smem); break;
  }
}

// o [Hq * HD] = the merged, normalized splits, into shared memory
__device__ void merge_phase(const FusedArgs& p, float* o) {
  for (int i = threadIdx.x; i < p.Hq * HD; i += blockDim.x) {
    const int hq = i / HD, d = i % HD;
    const float* pp = p.part + (size_t)hq * p.n_splits * PART;
    float M = -INFINITY;
    for (int s = 0; s < p.n_splits; ++s) M = fmaxf(M, __ldcg(pp + s * PART));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < p.n_splits; ++s) {
      const float ms = __ldcg(pp + s * PART);
      const float e = ms == -INFINITY ? 0.f : expf(ms - M);
      L += __ldcg(pp + s * PART + 1) * e;
      A += __ldcg(pp + s * PART + 2 + d) * e;
    }
    o[i] = __fdiv_rn(A, L);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernel

template <int MODE>
__global__ void __launch_bounds__(Q8_THREADS, 1)
fused_decode_kernel(FusedArgs p) {
  extern __shared__ __align__(16) unsigned char fd_smem[];
  cg::grid_group grid = cg::this_grid();
  float* red = reinterpret_cast<float*>(fd_smem);
  float* o_s = reinterpret_cast<float*>(fd_smem + RED_BYTES);
  unsigned char* act_base = fd_smem + RED_BYTES + 4 * p.dim;
  float* attn_s = reinterpret_cast<float*>(fd_smem);
  const int nq = (p.Hq + 2 * p.Hkv) * HD;

  if constexpr (MODE == MODE_MLP) {
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
    return;
  }

  if constexpr (MODE == MODE_ATTN) {
    const Weights w = weights_of(p.w);
    const Q8Act ax = q8_act_at(act_base, p.dim / 32);
    q8_quant(GlobalVec{p.x}, ax);
    float* yqkv = p.yqkv;
    q8_rows(w.qs[0], w.es[0], w.em[0], nq, ax,
            [&](int n, float v) { yqkv[n] = v; });
    grid.sync();
    attention_phase(p, p.layer0, 0, attn_s);
    grid.sync();
    merge_phase(p, o_s);
    q8_quant(SmemVec{o_s}, ax);
    float* out = p.out;
    q8_rows(w.qs[1], w.es[1], w.em[1], p.dim, ax,
            [&](int n, float v) { out[n] = v; });
    return;
  }

  if constexpr (MODE == MODE_LAYERS) {
    for (int l = 0; l < p.nL; ++l) {
      const void* ptr[12];
#pragma unroll
      for (int i = 0; i < 12; ++i)
        ptr[i] = reinterpret_cast<const void*>(p.ptrs[l * 12 + i]);
      const Weights w = weights_of(ptr);
      const float* anorm = p.norms + (size_t)(2 * l) * p.dim;
      const float* mnorm = anorm + p.dim;
      const float* h = l == 0 ? p.x : p.out;
      float* yqkv = p.yqkv;
      float* h2 = p.h2;
      float* hout = p.out;
      float* ygu = p.ygu;
      const Q8Act ax = q8_act_at(act_base, p.dim / 32);

      // attn RMSNorm, wqkv
      q8_quant(NormVec{h, anorm, rms_factor(h, p.dim, p.eps, red)}, ax);
      q8_rows(w.qs[0], w.es[0], w.em[0], nq, ax,
              [&](int n, float v) { yqkv[n] = v; });
      grid.sync();
      attention_phase(p, p.layer0 + l, l, attn_s);
      grid.sync();
      // merge, W_o, attention residual
      merge_phase(p, o_s);
      q8_quant(SmemVec{o_s}, ax);
      q8_rows(w.qs[1], w.es[1], w.em[1], p.dim, ax, [&](int n, float v) {
        h2[n] = __fadd_rn(__ldcg(h + n), v);
      });
      grid.sync();
      // MLP RMSNorm, w_gu
      q8_quant(NormVec{h2, mnorm, rms_factor(h2, p.dim, p.eps, red)}, ax);
      q8_rows(w.qs[2], w.es[2], w.em[2], 2 * p.Kd, ax,
              [&](int n, float v) { ygu[n] = v; });
      grid.sync();
      // silu(g) * u, w_down, MLP residual
      const Q8Act am = q8_act_at(act_base, p.Kd / 32);
      q8_quant(MidVec{p.ygu, p.Kd}, am);
      q8_rows(w.qs[3], w.es[3], w.em[3], p.dim, am, [&](int n, float v) {
        hout[n] = __fadd_rn(v, __ldcg(h2 + n));
      });
      if (l + 1 < p.nL) grid.sync();
    }
  }
}

// ---------------------------------------------------------------- launch

template <int MODE>
static int launch(FusedArgs& a, int r, void* stream) {
  static int granted = 0, sms = 0;
  static int cached_smem = -1, per_sm = 0;
  const int kb_max = (a.Kd > a.dim ? a.Kd : a.dim) / 32;
  int smem = RED_BYTES + 4 * a.dim + q8_act_bytes(kb_max);
  const int attn = Q8_WARPS * r * PART * (int)sizeof(float);
  if (MODE != MODE_MLP && attn > smem) smem = attn;
  auto kernel = fused_decode_kernel<MODE>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  if (cached_smem != smem) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, Q8_THREADS, smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_smem = smem;
  }
  const int grid = per_sm * sms;
  if (MODE != MODE_MLP) {
    int n = grid / a.Hkv;
    a.n_splits = n < 1 ? 1 : (n > MAX_SPLITS ? MAX_SPLITS : n);
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                  dim3(Q8_THREADS), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

GCT_EXPORT int fused_mlp(const float* x, const void* gu_qs, const void* gu_es,
                         const void* gu_em, const void* d_qs,
                         const void* d_es, const void* d_em, float* ygu,
                         float* y, int Kg, int Kd, int Nd, void* stream) {
  FusedArgs a = {};
  a.x = x;
  a.w[6] = gu_qs; a.w[7] = gu_es; a.w[8] = gu_em;
  a.w[9] = d_qs; a.w[10] = d_es; a.w[11] = d_em;
  a.dim = Kg;
  a.Kd = Kd;
  a.Nd = Nd;
  a.ygu = ygu;
  a.out = y;
  return launch<MODE_MLP>(a, 1, stream);
}

GCT_EXPORT int fused_attention(
    const float* x, const void* q_qs, const void* q_es, const void* q_em,
    const void* o_qs, const void* o_es, const void* o_em, const void* kc,
    const void* vc, const int* lengths, int layer, int Hq, int Hkv,
    int S, int cache_f32, float theta, float scale, float* yqkv, float* part,
    float* o, void* kn, void* vn, void* stream) {
  FusedArgs a = {};
  a.x = x;
  a.w[0] = q_qs; a.w[1] = q_es; a.w[2] = q_em;
  a.w[3] = o_qs; a.w[4] = o_es; a.w[5] = o_em;
  a.kc = kc;
  a.vc = vc;
  a.lengths = lengths;
  a.layer0 = layer;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.dim = Hq * HD;
  a.cache_f32 = cache_f32;
  a.theta = theta;
  a.scale = scale;
  a.yqkv = yqkv;
  a.part = part;
  a.out = o;
  a.kn = kn;
  a.vn = vn;
  return launch<MODE_ATTN>(a, Hq / Hkv, stream);
}

GCT_EXPORT int layer_kernel(
    const float* h, const long long* ptrs, const float* norms, const void* kc,
    const void* vc, const int* lengths, int layer0, int nL, int Hq,
    int Hkv, int S, int Kd, int cache_f32, float theta, float scale,
    float eps, float* yqkv, float* part, float* ygu, float* h2, float* hout,
    void* kn, void* vn, void* stream) {
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
  return launch<MODE_LAYERS>(a, Hq / Hkv, stream);
}

GCT_EXPORT int kernels_clear_error() { return (int)cudaGetLastError(); }
