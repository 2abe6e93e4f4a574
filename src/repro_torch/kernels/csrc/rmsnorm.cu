// RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, `_rmsnorm_kernel` /
// `rmsnorm_pallas` (one fused VMEM pass per (block_rows, D) tile).
//
// Arithmetic, as the reference: sum of squares in fp32, y = x * 1/sqrt(mean
// + eps) in fp32, y rounded to x's dtype, then multiplied by w (already in
// x's dtype) and rounded again.  Only the order of the fp32 sum differs.
//
// Bound: device-memory bytes in principle (x read once, y written once, w
// once; 4 operations an element, far below the card's ~295 a byte).  At the
// serve paths' row counts (8 decode rows, 1024 prefill rows) the time is
// set by latency instead: one CTA's dependent chain of loads, reduction and
// stores, and how many loads are in flight.  So:
//   * a row is read once, into registers, with 16-byte loads (8 bf16/f16 or
//     4 fp32 a vector), all issued before any arithmetic, w likewise once a
//     thread; one reduction (warp shuffles, then at most one shared-memory
//     exchange and one barrier); y is computed from the registers and
//     written with 16-byte stores;
//   * the host chooses the launch plan by row count (ops.rmsnorm_plan):
//       lanes  rows of at most 32 vectors (the qk-norm rows, D = 128): a
//              power of two of lanes a row, several rows a warp, shuffles
//              only;
//       block  one CTA of `threads` a row, VPT vectors a thread; few rows
//              (decode's 8) take VPT 1 and one row a CTA: one memory
//              latency a CTA; many rows (prefill's 1024) take VPT 2 and
//              rows_per_cta rows a CTA in turn, the next row's loads issued
//              before this row's reduction and w kept in registers, with
//              rows_per_cta as small as keeps every CTA resident at once;
//       scalar element loads, for rows whose bytes are not a multiple of 16
//              or pointers not 16-byte aligned, or rows too wide for the
//              registers: two passes over the row, the second from L1/L2;
//   * the model widths (128, 2560, 4096) are compile-time constants, so the
//     loops unroll and the bounds checks vanish; other widths run the same
//     kernels with the width at run time.
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

enum Variant : int { kScalar = 0, kLanes = 1, kBlock = 2 };

// Elements of T in one 16-byte vector.
template <typename T> constexpr int kVec = 16 / (int)sizeof(T);

// Launch bound of the block kernel for VPT vectors a thread (the kernel's
// __launch_bounds__): at 512 threads a thread may hold 128 registers, which
// x, the next row's x and w (3 * 4 * VPT registers) fit up to VPT 4.
constexpr int max_threads(int vpt) { return vpt == 1 ? 1024 : 512; }

// The kVec<T> elements of a 16-byte vector as fp32 (exact).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
}

template <typename T> __device__ __forceinline__ unsigned bits16(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat16_as_ushort(from_f<__nv_bfloat16>(v));
  } else {
    return __half_as_ushort(from_f<__half>(v));
  }
}

// kVec<T> fp32 values rounded to T (nearest even), packed into 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = bits16<T>(f[2 * i]) | (bits16<T>(f[2 * i + 1]) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  float f[kVec<T>];
  unpack<T>(v, f);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) s += f[e] * f[e];
  return s;
}

// round(round(x * inv) * w), element by element: the reference's order.
template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& xv, const uint4& wv,
                                          float inv) {
  float xf[kVec<T>], wf[kVec<T>];
  unpack<T>(xv, xf);
  unpack<T>(wv, wf);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) xf[e] = to_f(from_f<T>(xf[e] * inv)) * wf[e];
  return pack<T>(xf);
}

// Sum of every thread's v over the CTA's nwarps warps, the same bits in
// every thread: warp butterflies, one exchange through part[0..nwarps), one
// barrier.  No thread may still be reading part when this is entered.
__device__ __forceinline__ float block_sum(float v, float* part, int nwarps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = lane < nwarps ? part[lane] : 0.f;
  for (int o = 1; o < nwarps; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return __shfl_sync(0xffffffffu, s, 0);   // lanes past nwarps summed zeros
}

// lanes: `lanes` threads a row (the power of two at or above the row's
// vector count, at most 32), one vector each; blockDim.x / lanes rows a CTA.
// D > 0: the width as a constant (its vector count a power of two).
template <typename T, int D>
__global__ void __launch_bounds__(256)
    rmsnorm_lanes_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ y, long long rows, int d, float eps,
                         int /*rows_per_cta: blockDim.x / lanes*/) {
  static_assert(D == 0 || ((D / kVec<T>) & (D / kVec<T> - 1)) == 0, "");
  static_assert(D / kVec<T> <= 32, "");
  const int width = D > 0 ? D : d;
  const int nvec = width / kVec<T>;
  const int lanes = D > 0 ? D / kVec<T> : 1 << (32 - __clz(nvec - 1));
  const int lane = threadIdx.x & (lanes - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  // a dead lane still shuffles: every lane of the warp takes part
  const bool live = row < rows && (D > 0 || lane < nvec);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 xv =
      live ? reinterpret_cast<const uint4*>(x + row * width)[lane] : zero;
  const uint4 wv = live ? reinterpret_cast<const uint4*>(w)[lane] : zero;
  float ss = sum_squares<T>(xv);
  for (int o = lanes >> 1; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = 1.0f / sqrtf(ss / (float)width + eps);
  if (live)
    reinterpret_cast<uint4*>(y + row * width)[lane] = normalise<T>(xv, wv, inv);
}

// block: one CTA a row, VPT vectors a thread (thread t holds vectors t,
// t + blockDim.x, ...: each load instruction of a warp reads 512 contiguous
// bytes), rows_per_cta rows a CTA in turn.  D > 0: the width as a constant
// and blockDim.x == D / kVec<T> / VPT exactly (the host checks), so no
// bounds checks.
template <typename T, int D, int VPT>
__global__ void __launch_bounds__(VPT == 1 ? 1024 : 512)
    rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ y, long long rows, int d, float eps,
                         int rows_per_cta) {
  __shared__ float part[2][32];   // by row parity: one barrier a row
  const int width = D > 0 ? D : d;
  const int nvec = width / kVec<T>;
  const int stride = D > 0 ? D / kVec<T> / VPT : blockDim.x;
  const int t = threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  long long row = (long long)blockIdx.x * rows_per_cta;
  const long long end = min(rows, row + rows_per_cta);

  uint4 cur[VPT], wv[VPT];
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * width);
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    cur[i] = (D > 0 || i * stride + t < nvec) ? xr[i * stride + t] : zero;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    wv[i] = (D > 0 || i * stride + t < nvec)
                ? reinterpret_cast<const uint4*>(w)[i * stride + t]
                : zero;

  for (int parity = 0; row < end; ++row, parity ^= 1) {
    const bool more = row + 1 < end;
    uint4 nxt[VPT];
    if (more) {   // the next row's loads go out before this row's reduction
      const uint4* xn = reinterpret_cast<const uint4*>(x + (row + 1) * width);
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        nxt[i] = (D > 0 || i * stride + t < nvec) ? xn[i * stride + t] : zero;
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) ss += sum_squares<T>(cur[i]);
    ss = block_sum(ss, part[parity], stride >> 5);
    const float inv = 1.0f / sqrtf(ss / (float)width + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * width);
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      if (D > 0 || i * stride + t < nvec)
        yr[i * stride + t] = normalise<T>(cur[i], wv[i], inv);
    if (more) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
    }
  }
}

// scalar: one CTA a row, element loads (any width, any alignment); the
// sum of squares, then a second pass over the row for y.
template <typename T>
__global__ void __launch_bounds__(1024)
    rmsnorm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ y, long long rows, int d, float eps,
                          int /*rows_per_cta: 1*/) {
  __shared__ float part[32];
  const T* xr = x + (long long)blockIdx.x * d;
  T* yr = y + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss, part, blockDim.x >> 5);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f<T>(to_f(from_f<T>(to_f(xr[i]) * inv)) * to_f(w[i]));
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, long long, int, float, int);

// Whether width D splits into exactly VPT vectors for each of a whole
// number of warps within the launch bound: the compiled-width instances.
template <typename T, int D, int VPT>
constexpr bool kExact = (D / kVec<T>) % VPT == 0 &&
                        (D / kVec<T> / VPT) % 32 == 0 &&
                        D / kVec<T> / VPT <= max_threads(VPT);

template <typename T, int VPT>
Kernel<T> block_kernel(int d, int threads) {
  if (threads * VPT == d / kVec<T>) {
    if constexpr (kExact<T, 4096, VPT>)
      if (d == 4096) return rmsnorm_block_kernel<T, 4096, VPT>;
    if constexpr (kExact<T, 2560, VPT>)
      if (d == 2560) return rmsnorm_block_kernel<T, 2560, VPT>;
  }
  return rmsnorm_block_kernel<T, 0, VPT>;
}

int lanes_of(int nvec) { return nvec <= 1 ? 1 : 1 << (32 - __builtin_clz(nvec - 1)); }

// The kernel of a plan, or nullptr for a plan the kernels do not take.
template <typename T>
Kernel<T> select(int variant, int d, int threads, int vpt) {
  if (d < 1 || threads < 32 || threads > 1024 || threads % 32) return nullptr;
  const int nvec = d / kVec<T>;
  const bool whole = d % kVec<T> == 0;
  switch (variant) {
    case kScalar:
      return rmsnorm_scalar_kernel<T>;
    case kLanes:
      if (!whole || nvec > 32 || vpt != 1 || threads > 256) return nullptr;
      if (d == 128) return rmsnorm_lanes_kernel<T, 128>;
      return rmsnorm_lanes_kernel<T, 0>;
    case kBlock:
      if (!whole || nvec <= 32 || threads > max_threads(vpt) ||
          (long long)threads * vpt < nvec)
        return nullptr;
      switch (vpt) {
        case 1: return block_kernel<T, 1>(d, threads);
        case 2: return block_kernel<T, 2>(d, threads);
        case 4: return block_kernel<T, 4>(d, threads);
      }
  }
  return nullptr;
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           float eps, int variant, int threads, int vpt, int rows_per_cta,
           cudaStream_t stream) {
  const Kernel<T> kern = select<T>(variant, d, threads, vpt);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (variant != kScalar &&
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) & 15))
    return (int)cudaErrorMisalignedAddress;
  // rows a CTA: the plan's, which must be what the kernel itself assumes
  const int per_cta = variant == kScalar  ? 1
                      : variant == kLanes ? threads / lanes_of(d / kVec<T>)
                                          : rows_per_cta;
  if (rows_per_cta != per_cta || per_cta < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (rows + per_cta - 1) / per_cta;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, rows, d, eps, rows_per_cta);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int variant, int d, int threads, int vpt, int* out) {
  const Kernel<T> kern = select<T>(variant, d, threads, vpt);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return kernel_attrs((const void*)kern, out);
}

}  // namespace

// variant, threads (a CTA), vpt (vectors a thread) and rows_per_cta are the
// plan of ops.rmsnorm_plan; a plan the kernels do not take, or a vector
// plan on pointers not 16-byte aligned, is refused before any launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             long long rows, int d, float eps, int dtype,
                             int variant, int threads, int vpt,
                             int rows_per_cta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(x, w, y, rows, d, eps, variant, threads, vpt,
                           rows_per_cta, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, w, y, rows, d, eps, variant, threads,
                                   vpt, rows_per_cta, s);
    case kF16:
      return launch<__half>(x, w, y, rows, d, eps, variant, threads, vpt,
                            rows_per_cta, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Registers a thread (out[0]) and local-memory bytes a thread (out[1]) of
// the kernel instance that repro_rmsnorm launches for this plan.
extern "C" int repro_rmsnorm_attrs(int dtype, int variant, int d, int threads,
                                   int vpt, int* out) {
  switch (dtype) {
    case kF32: return attrs<float>(variant, d, threads, vpt, out);
    case kBF16: return attrs<__nv_bfloat16>(variant, d, threads, vpt, out);
    case kF16: return attrs<__half>(variant, d, threads, vpt, out);
  }
  return (int)cudaErrorInvalidValue;
}
