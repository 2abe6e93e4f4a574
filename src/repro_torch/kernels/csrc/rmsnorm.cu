// RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, `_rmsnorm_kernel` /
// `rmsnorm_pallas` (one fused VMEM pass per (block_rows, D) tile).
//
// Arithmetic, as the reference: sum of squares in fp32, y = x * 1/sqrt(mean
// + eps) in fp32, y rounded to x's dtype, then multiplied by w (already in
// x's dtype) and rounded again.
//
// Bound: device-memory bytes.  The function reads x once and writes y once
// (2 * rows * D * sizeof(x)); it does 4 operations per element, far below
// the card's ~295 operations per byte.  The design therefore only has to
// keep the reads coalesced and touch each row's bytes in one block: the
// second pass over a row re-reads it from L1/L2, not from device memory.
//   * D > 512 (the model width, 4096): one CTA of 256 threads per row,
//     block-wide reduction through warp shuffles and shared memory.
//   * D <= 512 (the qk-norm rows, D = head_dim = 128): one warp per row,
//     8 rows per CTA, reduction by shuffles only.
// Any row count works: the row index is checked, nothing is padded.
#include "common.cuh"

template <typename T>
__global__ void rmsnorm_warp_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    T* __restrict__ y, long long rows, int d,
                                    float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32) {
    const T yv = from_f<T>(to_f(xr[i]) * inv);
    yr[i] = from_f<T>(to_f(yv) * to_f(w[i]));
  }
}

template <typename T>
__global__ void rmsnorm_block_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     T* __restrict__ y, int d, float eps) {
  __shared__ float partial[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(partial[0] / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const T yv = from_f<T>(to_f(xr[i]) * inv);
    yr[i] = from_f<T>(to_f(yv) * to_f(w[i]));
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* y, long long rows,
                  int d, float eps, cudaStream_t stream) {
  if (d <= 512) {
    const int rows_per_cta = 8;
    const long long grid = (rows + rows_per_cta - 1) / rows_per_cta;
    rmsnorm_warp_kernel<T><<<(unsigned)grid, 32 * rows_per_cta, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, rows, d, eps);
  } else {
    rmsnorm_block_kernel<T><<<(unsigned)rows, 256, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, d, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long rows, int d, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<float>(x, w, y, rows, d, eps, s);
    case kBF16: return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
    case kF16: return launch<__half>(x, w, y, rows, d, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
