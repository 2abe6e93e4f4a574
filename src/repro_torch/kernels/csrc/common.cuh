// Shared helpers of the port's CUDA kernels: dtype codes, conversions and
// kernel attributes.
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

// log2(e): the attention kernels scale their fp32 scores by it once and run
// the softmax in base 2 (exp(x - m) = 2^(x log2 e - m log2 e)), since exp2f
// is one hardware instruction and expf is several.
#define LOG2E_F 1.4426950408889634f
// ln(2): a base-2 log-sum-exp times it is the base-e one.
#define LN2_F 0.6931471805599453f
// -inf: the log-sum-exp of a row that sees no key.
#define NEG_INFINITY_F (-__int_as_float(0x7f800000))

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

// Registers a thread (out[0]) and local-memory bytes a thread, i.e. spills
// (out[1]), of a compiled kernel, as cudaFuncGetAttributes reports them.
static inline int kernel_attrs(const void* kern, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
