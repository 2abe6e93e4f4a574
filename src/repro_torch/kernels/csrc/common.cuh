// Shared helpers of the port's CUDA kernels: dtype codes and conversions.
//
// Every kernel file exports plain C entry points (no PyTorch headers), so
// each builds with nvcc in seconds and binds through ctypes.  An entry point
// returns the cudaError_t of its launch (0 when the launch was accepted).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes shared with repro_torch/kernels/build.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The reference's fully-masked score: -0.7 * float32 max.
#define NEG_INF_F (-0.7f * 3.4028234663852886e38f)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

// Round-to-nearest-even, as XLA and PyTorch round on a cast.
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
