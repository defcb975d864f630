// Shared helpers for the MoE dispatch kernels (plain C interface, loaded
// with ctypes by repro_torch/kernels/_build.py).
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MOE_API extern "C" __attribute__((visibility("default")))

// dtype and weight-format codes shared with the Python wrappers
enum MoeDtype : int { kF32 = 0, kBF16 = 1 };
enum WFormat : int { kDense = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

static inline int moe_last_error() { return (int)cudaGetLastError(); }

// SMs of the current device (cached per device)
inline int moe_num_sms() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}
