// Shared declarations of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/cuda/_build.py): pointers and the stream arrive as void*, sizes as
// int, and each entry returns cudaGetLastError() right after its launch so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSL_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float ssl_to_float(float v) { return v; }
__device__ __forceinline__ float ssl_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T ssl_from_float(float v);
template <>
__device__ __forceinline__ float ssl_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 ssl_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
