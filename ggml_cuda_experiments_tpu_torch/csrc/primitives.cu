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
// grid_sum: x [n, d] -> one total. Pass 1: CTA b sums the columns of its
//   row block (32 columns x 8 row lanes, the 8 lanes folded in order) into
//   part[b, :]; pass 2: one CTA of 1024 threads folds part in a fixed
//   order and a fixed shuffle tree. int32 is exact (two's complement, as
//   the plain version); f32 is the same bits on every run.
// lane_reduce: x [n, d] -> (max [n], sum [n]) in x's dtype, one warp per
//   row: each lane walks its 16-byte vectors (f32 sums in four lanes of
//   its own), then xor-shuffle trees. The max is exact.
#include "common.cuh"

namespace {

constexpr int SP_THREADS = 256, SP_MAX_ROWS = 64, SP_SMEM = 20480;
constexpr int GS_THREADS = 256, GS_MERGE = 1024;
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

template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
colsum_partials_kernel(const T* __restrict__ x, T* __restrict__ part, int n,
                       int d, int rpc) {
  __shared__ T red[GS_THREADS / 32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rpc, r1 = min(n, r0 + rpc);
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + tx;
    T s = T(0);
    if (c < d) {
#pragma unroll 8
      for (int r = r0 + ty; r < r1; r += GS_THREADS / 32)
        s += x[(size_t)r * d + c];
    }
    red[ty][tx] = s;
    __syncthreads();
    if (ty == 0 && c < d) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < GS_THREADS / 32; ++i) acc += red[i][tx];
      part[(size_t)blockIdx.x * d + c] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(GS_MERGE)
grid_sum_merge_kernel(const T* __restrict__ part, T* __restrict__ total,
                      long long count) {
  __shared__ T red[GS_MERGE / 32];
  T s = T(0);
#pragma unroll 8
  for (long long i = threadIdx.x; i < count; i += GS_MERGE) s += part[i];
  s = shfl_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    T v = red[threadIdx.x];
    v = shfl_sum(v);
    if (threadIdx.x == 0) *total = v;
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

// The number of row blocks (partial rows) grid_sum uses for n rows.
GCT_EXPORT int grid_sum_blocks(int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(1, min((n + 63) / 64, 2 * sms));
}

// x [n, d] (kind 0 int32, 1 f32), part [grid_sum_blocks(n), d] scratch,
// total: one element of x's dtype.
GCT_EXPORT int grid_sum(const void* x, void* part, void* total, int n, int d,
                        int kind, void* stream) {
  if (n < 1 || d < 1 || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  const int nb = grid_sum_blocks(n), rpc = (n + nb - 1) / nb;
  cudaStream_t s = (cudaStream_t)stream;
  const long long count = (long long)nb * d;
  if (kind == 0) {
    colsum_partials_kernel<int><<<nb, GS_THREADS, 0, s>>>(
        static_cast<const int*>(x), static_cast<int*>(part), n, d, rpc);
    grid_sum_merge_kernel<int><<<1, GS_MERGE, 0, s>>>(
        static_cast<const int*>(part), static_cast<int*>(total), count);
  } else {
    colsum_partials_kernel<float><<<nb, GS_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(part), n, d, rpc);
    grid_sum_merge_kernel<float><<<1, GS_MERGE, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(total), count);
  }
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
