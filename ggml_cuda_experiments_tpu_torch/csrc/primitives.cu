// Staging and reduction primitives on Hopper (sm_90a).
//
// Replace the JAX package's test-held Pallas kernels tests/test_dma.py::
// _stage_kernel and tests/test_reductions.py::_gridsum_kernel /
// _lane_reduce_kernel (the reference's memcpy_async staging,
// flash-matrix.cu:18-65; its cooperative-groups block partials,
// simpleCooperativeGroups.cu:37-137; and warp_reduce_max / sum,
// cuda_info.h:46-85). All three are bound by bytes on the H100: each input
// byte is read once and each output byte written once.
//
// stage_pad: x [R, D] -> out [R, dpad], zeros in [D, dpad). A CTA copies up
//   to 64 rows into shared memory with 16-byte cp.async (one contiguous span
//   of rows), then writes them out padded with 16-byte stores; rows whose
//   byte widths are not multiples of 16 go byte by byte.
// grid_sum: x [n, d] -> one total, in one launch. x is contiguous, so it is
//   streamed flat: a scalar head up to the first 16-byte boundary, 16-byte
//   vectors, a scalar tail. A persistent grid (a few CTAs an SM) walks the
//   vectors grid-stride, each thread keeping GS_UNROLL loads in flight
//   (read-only, no L1 allocation) and folding them in a fixed order; the
//   CTA folds in a fixed shuffle tree into part[blockIdx.x]. Then each CTA
//   fences and draws a ticket; the CTA that draws the last folds part[0, nb)
//   in index order, writes the total and puts the ticket back to 0 (so the
//   calls of a captured graph and its replays find it at 0). No atomic
//   touches the total: int32 is exact (wrapping, as the plain version), and
//   f32 gives the same bits on every run for a given card and shape. One
//   ticket a device, so two streams must not run grid_sum at once.
// lane_reduce: x [n, d] -> (max [n], sum [n]) in x's dtype, one warp per
//   row: each lane walks its 16-byte vectors (f32 sums in four lanes of
//   its own), then xor-shuffle trees. The max is exact.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int SP_THREADS = 256, SP_MAX_ROWS = 64, SP_SMEM = 20480;
constexpr int GS_THREADS = 256, GS_UNROLL = 4, GS_CTAS_PER_SM = 4;
constexpr int GS_MAX_BLOCKS = 4 * GS_THREADS;   // the merge's reach
constexpr int LR_THREADS = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(SP_THREADS)
stage_pad_kernel(const unsigned char* __restrict__ x,
                 unsigned char* __restrict__ out, int R, int in_bytes,
                 int out_bytes, int rows_cta, int vec) {
  extern __shared__ __align__(16) unsigned char buf[];
  const int r0 = blockIdx.x * rows_cta;
  const int rows = min(rows_cta, R - r0);
  const unsigned char* src = x + (size_t)r0 * in_bytes;
  unsigned char* dst = out + (size_t)r0 * out_bytes;
  if (vec) {
    const int n16 = rows * in_bytes / 16;
    for (int c = threadIdx.x; c < n16; c += SP_THREADS)
      cp_async16(buf + c * 16, src + (size_t)c * 16);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
  } else {
    for (int b = threadIdx.x; b < rows * in_bytes; b += SP_THREADS)
      buf[b] = src[b];
  }
  __syncthreads();
  if (vec) {
    const int cin = in_bytes / 16, cout = out_bytes / 16;
    for (int c = threadIdx.x; c < rows * cout; c += SP_THREADS) {
      const int r = c / cout, j = c % cout;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < cin) v = *reinterpret_cast<const uint4*>(buf + r * in_bytes +
                                                       j * 16);
      *reinterpret_cast<uint4*>(dst + (size_t)r * out_bytes + j * 16) = v;
    }
  } else {
    for (int b = threadIdx.x; b < rows * out_bytes; b += SP_THREADS) {
      const int r = b / out_bytes, j = b % out_bytes;
      dst[(size_t)r * out_bytes + j] = j < in_bytes ? buf[r * in_bytes + j]
                                                    : (unsigned char)0;
    }
  }
}

template <typename T>
__device__ __forceinline__ T shfl_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A 16-byte streaming load: read-only path, no L1 allocation, L2 fetches of
// 256 bytes.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The sum's arithmetic type: int32 adds in unsigned (two's complement
// wrap-around, defined), f32 in f32.
template <typename T> struct GsAcc { using type = float; };
template <> struct GsAcc<int> { using type = unsigned; };
__device__ __forceinline__ float gs_lane(unsigned u, float) {
  return __uint_as_float(u);
}
__device__ __forceinline__ unsigned gs_lane(unsigned u, unsigned) { return u; }

// The CTA's total of v in a fixed tree, on thread 0.
template <typename A>
__device__ __forceinline__ A gs_block_sum(A v, A* red) {
  v = shfl_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  A s = A(0);
  if (threadIdx.x < 32) {
    s = threadIdx.x < GS_THREADS / 32 ? red[threadIdx.x] : A(0);
    s = shfl_sum(s);
  }
  return s;
}

// x + head is 16-byte aligned; head < 4 and head <= count.
template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
grid_sum_kernel(const T* __restrict__ x, T* __restrict__ part,
                unsigned* __restrict__ ticket, T* __restrict__ total,
                long long count, int head) {
  using A = typename GsAcc<T>::type;
  __shared__ A red[GS_THREADS / 32];
  __shared__ bool last;
  const long long nvec = (count - head) / 4;
  const int tail = (int)((count - head) % 4);
  const long long g = (long long)blockIdx.x * GS_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * GS_THREADS;
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  const unsigned* xs = reinterpret_cast<const unsigned*>(x);
  A s[4] = {A(0), A(0), A(0), A(0)};
  if (g < head) s[0] = gs_lane(xs[g], A(0));
  if (g < tail) s[1] = gs_lane(xs[head + 4 * nvec + g], A(0));
  for (long long i = g; i < nvec; i += GS_UNROLL * stride) {
    uint4 r[GS_UNROLL];
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      const long long j = i + u * stride;
      r[u] = j < nvec ? ld_stream(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < GS_UNROLL; ++u) {
      s[0] += gs_lane(r[u].x, A(0));
      s[1] += gs_lane(r[u].y, A(0));
      s[2] += gs_lane(r[u].z, A(0));
      s[3] += gs_lane(r[u].w, A(0));
    }
  }
  const A b = gs_block_sum((s[0] + s[1]) + (s[2] + s[3]), red);
  if (threadIdx.x == 0) {
    reinterpret_cast<A*>(part)[blockIdx.x] = b;
    __threadfence();                      // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;           // uniform: the CTA returns together
  // The last CTA: part[j] for j = t, t + 256, ... (gridDim.x <=
  // GS_MAX_BLOCKS), all loads issued at once, then the same tree.
  const A* p = reinterpret_cast<const A*>(part);
  A m = A(0);
#pragma unroll
  for (int k = 0; k < GS_MAX_BLOCKS / GS_THREADS; ++k) {
    const int j = threadIdx.x + k * GS_THREADS;
    if (j < (int)gridDim.x) m += __ldcg(p + j);
  }
  m = gs_block_sum(m, red);
  if (threadIdx.x == 0) {
    *reinterpret_cast<A*>(total) = m;
    *ticket = 0u;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(LR_THREADS)
lane_reduce_kernel(const T* __restrict__ x, T* __restrict__ mx,
                   T* __restrict__ sm, int n, int d, int vec) {
  const int row = blockIdx.x * (LR_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* xr = x + (size_t)row * d;
  constexpr int V = 16 / sizeof(T);
  float m = -INFINITY, s[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = to_f(e[i]);
        m = fmaxf(m, v);
        s[i & 3] += v;
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float v = to_f(xr[c]);
      m = fmaxf(m, v);
      s[0] += v;
    }
  }
  m = warp_max(m);
  const float total = warp_sum((s[0] + s[1]) + (s[2] + s[3]));
  if (lane == 0) {
    from_f(mx + row, m);
    from_f(sm + row, total);
  }
}

}  // namespace

// x [R, in_bytes / es] -> out [R, out_bytes / es] (bytes of each row).
GCT_EXPORT int stage_pad(const void* x, void* out, int R, int in_bytes,
                         int out_bytes, void* stream) {
  if (R < 1 || in_bytes < 1 || in_bytes > out_bytes)
    return (int)cudaErrorInvalidValue;
  const int vec = in_bytes % 16 == 0 && out_bytes % 16 == 0 &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int rows_cta = max(1, min(SP_MAX_ROWS, SP_SMEM / in_bytes));
  const int smem = rows_cta * in_bytes;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  stage_pad_kernel<<<(R + rows_cta - 1) / rows_cta, SP_THREADS, smem,
                     (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      R, in_bytes, out_bytes, rows_cta, vec);
  return (int)cudaGetLastError();
}

// The number of CTAs (and partials) grid_sum uses for `count` elements:
// enough for GS_UNROLL vectors a thread, at most GS_CTAS_PER_SM an SM.
GCT_EXPORT int grid_sum_blocks(long long count) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_cta = 4LL * GS_UNROLL * GS_THREADS;
  const long long want = (count + per_cta - 1) / per_cta;
  return (int)std::max(1LL, std::min(want, (long long)std::min(
                                               GS_CTAS_PER_SM * sms,
                                               GS_MAX_BLOCKS)));
}

// x: `count` contiguous elements (kind 0 int32, 1 f32), 4-byte aligned;
// part: grid_sum_blocks(count) elements of scratch; ticket: one uint32, 0
// between calls; total: one element of x's dtype.
GCT_EXPORT int grid_sum(const void* x, void* part, void* ticket, void* total,
                        long long count, int kind, void* stream) {
  if (count < 1 || kind < 0 || kind > 1 || (uintptr_t)x % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int nb = grid_sum_blocks(count);
  const int head =
      (int)std::min<long long>((16 - (uintptr_t)x % 16) % 16 / 4, count);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* t = static_cast<unsigned*>(ticket);
  if (kind == 0)
    grid_sum_kernel<int><<<nb, GS_THREADS, 0, s>>>(
        static_cast<const int*>(x), static_cast<int*>(part), t,
        static_cast<int*>(total), count, head);
  else
    grid_sum_kernel<float><<<nb, GS_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(part), t,
        static_cast<float*>(total), count, head);
  return (int)cudaGetLastError();
}

// x [n, d] (kind 0 f32, 1 bf16) -> mx [n], sm [n] in x's dtype.
GCT_EXPORT int lane_reduce(const void* x, void* mx, void* sm, int n, int d,
                           int kind, void* stream) {
  if (n < 1 || d < 1 || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  const int es = kind == 0 ? 4 : 2;
  const int vec = (d * es) % 16 == 0 && (uintptr_t)x % 16 == 0;
  const int grid = (n + LR_THREADS / 32 - 1) / (LR_THREADS / 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    lane_reduce_kernel<float><<<grid, LR_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(mx),
        static_cast<float*>(sm), n, d, vec);
  else
    lane_reduce_kernel<bf16><<<grid, LR_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(mx),
        static_cast<bf16*>(sm), n, d, vec);
  return (int)cudaGetLastError();
}
