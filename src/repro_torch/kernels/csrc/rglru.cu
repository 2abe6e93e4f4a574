// RG-LRU linear recurrence, forward only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru/kernel.py, `_rglru_kernel` /
// `rglru_pallas` (a (B, D/128) Pallas grid whose cells each walk the whole
// sequence with a fori_loop, h carried in vector registers, S chunked by
// the wrapper so three (S, 128) fp32 tiles fit VMEM).
//
// Semantics, as the reference: x, log_a (B,S,D) fp32, h0 (B,D) fp32 or
// null (zeros); h_t = exp(log_a_t) * h_{t-1} + x_t over t, out (B,S,D) fp32.
// The compiler may contract the multiply-add into one FMA: the only
// difference from the plain version's rounding.
//
// Bound: device-memory bytes.  The kernel reads x and log_a once and writes
// h once, 3 * B * S * D * 4 bytes (31.5 MB at (8, 128, 2560), ~9.4 us at
// 3.35 TB/s), for ~3 operations per element.  What the design does about
// that:
//   * one pass: one thread per (b, d) channel keeps h in a register and
//     walks t, so nothing but x, log_a and h touches device memory; no
//     sequence chunking is needed, since nothing has to fit a VMEM tile;
//   * coalesced rows: neighbouring threads take neighbouring d, so every
//     step's loads and store are contiguous 128-byte lines per warp;
//   * the loads of later steps do not depend on h, so each thread loads
//     UNROLL steps of x and log_a into registers before it runs their
//     recurrence, keeping UNROLL loads in flight instead of one.
// At the prefill shape that is B*D = 20480 threads, 80 blocks of 256 on 132
// SMs: the sequential walk over S, not the bandwidth, bounds this first
// version; splitting S into chunks combined by a second pass is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
             const float* __restrict__ h0, float* __restrict__ out, int s,
             int d) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  const size_t base = (size_t)b * s * d + c;
  float h = h0 ? h0[(size_t)b * d + c] : 0.f;
  int t = 0;
  for (; t + UNROLL <= s; t += UNROLL) {
    float xv[UNROLL], av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t off = base + (size_t)(t + u) * d;
      xv[u] = x[off];
      av[u] = log_a[off];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = expf(av[u]) * h + xv[u];
      out[base + (size_t)(t + u) * d] = h;
    }
  }
  for (; t < s; ++t) {
    const size_t off = base + (size_t)t * d;
    h = expf(log_a[off]) * h + x[off];
    out[off] = h;
  }
}

}  // namespace

extern "C" int repro_rglru(const void* x, const void* log_a, const void* h0,
                           void* out, int b, int s, int d, void* stream) {
  if (b <= 0 || s <= 0 || d <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((d + THREADS - 1) / THREADS, b);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)log_a, (const float*)h0, (float*)out, s,
      d);
  return (int)cudaGetLastError();
}
