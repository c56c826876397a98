// The JAX package's Mosaic probes (tools/probe_mosaic_r3.py) as small
// Hopper (sm_90a) kernels, each computing its probe's function exactly:
//
//   0 transpose_dot  out [C, R2] = x^T e for x [R, C], e [R, R2] (the
//                    probe's dot_general contracting dim 0 with an eye: a
//                    transpose); f32 FMAs in k order, exact for an eye;
//   1 lane_concat    out [32, 128]: out[r, 32c + j] = x[32c + r, j], j < 32,
//                    for x [128, 128];
//   2 roll64         out [R, 128] = roll(x, 64) along the lanes;
//   3 dyn_sublane    out = 2 x, block i writing the 8-row slice at 8 i that
//                    its index selects (the probe's grid of 4 steps): one
//                    float4 a thread (8 C / 4 threads, 256 at C = 128), or
//                    one float where C % 4 != 0 or a pointer is not 16-byte
//                    aligned; a slice of more than 1,024 items spreads over
//                    blockIdx.y. One load and one store a thread, no loop;
//   4 lane_extract   out [32, 128]: row h = x[0, 128h : 128h + 128];
//   5 read_output    out = 3 x + 1 through a value kept across two steps of
//                    one block: step 0 writes s = 3x to device memory, step
//                    1 reads it back and writes s + 1 (a grid's steps run in
//                    order on the TPU; here they are a loop in one block);
//   6 tiny_call      out = x * 1.0001f: the kernel whose launch cost the
//                    call_overhead probe measures (eager against a replayed
//                    CUDA graph, tools/probe_mosaic_r3.py).
// Each was a Mosaic compiler limit on the TPU; Hopper has none of them.
// Bound: a few KB of bytes; launch cost is all they measure.
#include <algorithm>

#include "common.cuh"

__global__ void mp_transpose_dot(const float* x, const float* e, float* out,
                                 int R, int C, int R2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * R2) return;
  const int c = i / R2, j = i % R2;
  float acc = 0.f;
  for (int k = 0; k < R; ++k)
    acc = fmaf(x[k * C + c], e[k * R2 + j], acc);
  out[i] = acc;
}

__global__ void mp_lane_concat(const float* x, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // 32 x 128
  if (i >= 32 * 128) return;
  const int r = i / 128, l = i % 128, c = l / 32, j = l % 32;
  out[i] = x[(32 * c + r) * 128 + j];
}

__global__ void mp_roll64(const float* x, float* out, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * 128) return;
  const int r = i / 128, l = i % 128;
  out[i] = x[r * 128 + ((l + 64) & 127)];
}

// V: float4 items (else floats); `items` of them in each 8-row slice.
template <bool V>
__global__ void mp_dyn_sublane(const float* __restrict__ x,
                               float* __restrict__ out, int C, int items) {
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= items) return;
  const size_t r0 = 8 * (size_t)blockIdx.x * C;           // pl.ds(8 i, 8)
  if (V) {
    float4 v = reinterpret_cast<const float4*>(x + r0)[t];
    v.x *= 2.f, v.y *= 2.f, v.z *= 2.f, v.w *= 2.f;
    reinterpret_cast<float4*>(out + r0)[t] = v;
  } else {
    out[r0 + t] = x[r0 + t] * 2.f;
  }
}

__global__ void mp_lane_extract(const float* x, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // 32 x 128
  if (i < 32 * 128) out[i] = x[i];
}

__global__ void mp_read_output(const float* x, float* out, float* s, int n) {
  for (int step = 0; step < 2; ++step) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      if (step == 0)
        s[t] = x[t] * 3.f;
      else
        out[t] = __ldcg(s + t) + 1.f;
    }
    __threadfence_block();
    __syncthreads();
  }
}

__global__ void mp_tiny(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 1.0001f;
}

// Probe `which` (above) on x [R, C] (transpose_dot: e [R, C2]); out, and
// out2 for read_output's kept value.
GCT_EXPORT int mosaic_probe(int which, const float* x, const float* e,
                            float* out, float* out2, int R, int C, int C2,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      mp_transpose_dot<<<(C * C2 + 127) / 128, 128, 0, s>>>(x, e, out, R, C,
                                                           C2);
      break;
    case 1:
      if (R != 128 || C != 128) return (int)cudaErrorInvalidValue;
      mp_lane_concat<<<32, 128, 0, s>>>(x, out);
      break;
    case 2:
      if (C != 128) return (int)cudaErrorInvalidValue;
      mp_roll64<<<(R * 128 + 127) / 128, 128, 0, s>>>(x, out, R);
      break;
    case 3: {
      if (R % 8) return (int)cudaErrorInvalidValue;
      const bool vec = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)out % 16 == 0;
      const int items = vec ? 2 * C : 8 * C;
      const int threads = std::min(1024, (items + 31) / 32 * 32);
      const dim3 grid(R / 8, (items + threads - 1) / threads);
      if (grid.y > 65535) return (int)cudaErrorInvalidValue;
      if (vec)
        mp_dyn_sublane<true><<<grid, threads, 0, s>>>(x, out, C, items);
      else
        mp_dyn_sublane<false><<<grid, threads, 0, s>>>(x, out, C, items);
      break;
    }
    case 4:
      if (R * C != 4096) return (int)cudaErrorInvalidValue;
      mp_lane_extract<<<32, 128, 0, s>>>(x, out);
      break;
    case 5:
      mp_read_output<<<1, 256, 0, s>>>(x, out, out2, R * C);
      break;
    case 6:
      mp_tiny<<<(R * C + 127) / 128, 128, 0, s>>>(x, out, R * C);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
