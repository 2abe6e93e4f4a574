// Flash decode: one new query token against a KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode/kernel.py, `_decode_kernel` /
// `flash_decode` (a (B, H, L/block_k) Pallas grid with cache_len as a
// scalar-prefetch operand and one query head per grid cell).
//
// Semantics, as the reference: q (B,H,dh), k/v (B,L,KVH,dh), cache_len an
// int32 scalar in device memory; keys at or past cache_len are masked, and
// with a window so are keys before cache_len - window; fp32 online softmax
// with NEG_INF = -0.7 * f32max; output acc / max(l, 1e-30) in q's dtype.
// The reference model's ring cache (src/repro/models/attention.py
// `decode_attention(..., ring=True)`) is decoded with window 0: the model
// keeps a ring only when its window is at least L, and then the ring's age
// mask keeps exactly the slots below min(cache_len, L).
//
// Bound: device-memory bytes.  Decode reads every live K and V row once and
// does ~2 operations per byte read per query head of the group, so the
// least time is 2 * B * live_len * KVH * dh * sizeof(cache) / (3.35 TB/s).
// What the design does about that:
//   * one CTA per (b, kv head) covers the G = H/KVH query heads that share
//     the kv head, so each K/V row is read from device memory once per
//     group, not G times as one-head-per-program would.  G * dh outputs
//     are spread over 256 threads, NACC each: up to 2560 (MQA with 10
//     heads of 256, as RecurrentGemma);
//   * cache_len is read inside the kernel from device memory -- the host
//     never synchronises to learn it -- and tiles at or past it (and, with
//     a window, wholly before it) are never loaded.
// Parallelism is B*KVH CTAs: 64 for Qwen3-8B at batch 8, and only 8 on 132
// SMs for RecurrentGemma's single kv head.  Splitting the cache over more
// CTAs (split-K flash decoding) is later work.
#include "common.cuh"

namespace {

constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 10;      // output elements per thread: G*dh <= 2560

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const int* __restrict__ cache_len, TQ* __restrict__ o,
                    int lmax, int nh, int nkvh, int dh, float scale,
                    int window) {
  extern __shared__ float smem[];
  const int g_heads = nh / nkvh;
  float* qs = smem;                         // [G][dh], pre-scaled
  float* ks = qs + g_heads * dh;            // [BK][dh+1]
  float* vs = ks + BK * (dh + 1);           // [BK][dh]
  float* ps = vs + BK * dh;                 // [G][BK]
  float* alpha = ps + g_heads * BK;         // [G] this tile's rescale
  float* m_run = alpha + g_heads;           // [G] running max
  float* l_run = m_run + g_heads;           // [G] running sum

  const int b = blockIdx.x / nkvh;
  const int kvh = blockIdx.x - b * nkvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_out = g_heads * dh;

  for (int idx = tid; idx < n_out; idx += THREADS)
    qs[idx] = to_f(q[((size_t)b * nh + kvh * g_heads) * dh + idx]) * scale;

  for (int g = tid; g < g_heads; g += THREADS) {
    m_run[g] = NEG_INF_F;
    l_run[g] = 0.f;
  }

  const int raw_len = *cache_len;
  const int clen = min(raw_len, lmax);
  const int k_lo = window > 0 ? max(0, raw_len - window) : 0;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int k0 = k_lo; k0 < clen; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * dh; idx += THREADS) {
      const int j = idx / dh, c = idx - j * dh;
      const int kr = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kr < clen) {
        const size_t off = (((size_t)b * lmax + kr) * nkvh + kvh) * dh + c;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j * (dh + 1) + c] = kv;
      vs[j * dh + c] = vv;
    }
    __syncthreads();
    // scores: pair (g, j) for idx = tid + THREADS * i
    for (int idx = tid; idx < g_heads * BK; idx += THREADS) {
      const int g = idx / BK, j = idx - g * BK;
      const int kpos = k0 + j;
      const bool ok = kpos < clen && kpos >= k_lo;
      float s = 0.f;
      const float* qg = qs + g * dh;
      const float* kj = ks + j * (dh + 1);
      for (int c = 0; c < dh; ++c) s += qg[c] * kj[c];
      ps[idx] = ok ? s : NEG_INF_F;
    }
    __syncthreads();
    // online softmax: warp w handles heads w, w + WARPS, ...; each head's
    // running max and sum live in shared memory, written by its one warp
    for (int g = warp; g < g_heads; g += WARPS) {
      float* row = ps + g * BK;
      float mcur = NEG_INF_F;
      for (int j = lane; j < BK; j += 32) mcur = fmaxf(mcur, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
      const float mold = m_run[g];
      const float mnew = fmaxf(mold, mcur);
      float psum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const int kpos = k0 + j;
        const bool ok = kpos < clen && kpos >= k_lo;
        const float p = ok ? expf(row[j] - mnew) : 0.f;
        row[j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(mold - mnew);
        alpha[g] = a;
        l_run[g] = l_run[g] * a + psum;
        m_run[g] = mnew;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = tid + THREADS * i;
      if (idx < n_out) {
        const int g = idx / dh, c = idx - g * dh;
        const float* prow = ps + g * BK;
        float a = acc[i] * alpha[g];
        for (int j = 0; j < BK; ++j) a += prow[j] * vs[j * dh + c];
        acc[i] = a;
      }
    }
  }

  // normalise by each head's running sum
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = tid + THREADS * i;
    if (idx < n_out) {
      const int g = idx / dh;
      o[((size_t)b * nh + kvh * g_heads) * dh + idx] =
          from_f<TQ>(acc[i] / fmaxf(l_run[g], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* clen,
           void* o, int b, int lmax, int nh, int nkvh, int dh, float scale,
           int window, cudaStream_t stream) {
  const int g = nh / nkvh;
  const size_t smem =
      ((size_t)g * dh + (size_t)BK * (dh + 1) + (size_t)BK * dh +
       (size_t)g * BK + 3 * (size_t)g) * sizeof(float);
  auto kern = flash_decode_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<b * nkvh, THREADS, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, clen, (TQ*)o, lmax, nh,
      nkvh, dh, scale, window);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_kv(const void* q, const void* k, const void* v, const int* clen,
                void* o, int b, int lmax, int nh, int nkvh, int dh,
                float scale, int window, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, clen, o, b, lmax, nh, nkvh, dh, scale,
                               window, s);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, clen, o, b, lmax, nh, nkvh,
                                       dh, scale, window, s);
    case kF16:
      return launch<TQ, __half>(q, k, v, clen, o, b, lmax, nh, nkvh, dh,
                                scale, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* cache_len, void* o, int b,
                                  int lmax, int nh, int nkvh, int dh,
                                  float scale, int window, int q_dtype,
                                  int kv_dtype, void* stream) {
  if ((nh / nkvh) * dh > NACC * THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* clen = (const int*)cache_len;
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<float>(q, k, v, clen, o, b, lmax, nh, nkvh, dh,
                                scale, window, kv_dtype, s);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(q, k, v, clen, o, b, lmax, nh, nkvh,
                                        dh, scale, window, kv_dtype, s);
    case kF16:
      return dispatch_kv<__half>(q, k, v, clen, o, b, lmax, nh, nkvh, dh,
                                 scale, window, kv_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}
