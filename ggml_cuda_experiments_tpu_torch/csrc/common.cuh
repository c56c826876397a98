// Shared helpers of the port's CUDA kernels (sm_90a, plain C entry points).
//
// Every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so that a refused launch (too many threads,
// too much shared memory) surfaces in the Python wrapper at once.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define GCT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory (once per
// size it grows to); returns the CUDA status.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

// What the runtime says of a kernel launched with `threads` threads and
// `smem` bytes of dynamic shared memory: out = {registers per thread,
// static shared bytes, dynamic shared bytes, threads, resident CTAs per SM,
// SMs, local (spill) bytes per thread}. Returns the CUDA status.
template <typename Kernel>
static int kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int granted = 0, dev = 0, per_sm = 0, sms = 0;
  if (e == cudaSuccess) e = allow_smem(kernel, smem, &granted);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {a.numRegs, (int)a.sharedSizeBytes, smem, threads, per_sm,
                    sms, (int)a.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
