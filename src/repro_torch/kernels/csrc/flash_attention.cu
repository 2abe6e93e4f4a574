// Flash attention, forward only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_flash_kernel` /
// `flash_attention` (a sequential (B, H, nq, nk) Pallas grid whose kv axis
// carries the online-softmax scratch from one step to the next).
//
// Semantics, as the reference: q (B,Sq,H,dh), k/v (B,Skv,KVH,dh), all one
// dtype; query head h reads kv head h / (H/KVH); scores in fp32 with q
// pre-scaled by dh^-0.5; causal and sliding-window masks taken against
// q_offset + row; masked scores are NEG_INF = -0.7 * f32max and their
// probabilities exactly 0; output acc / max(l, 1e-30) rounded to q's dtype.
// Ragged Sq and Skv are masked at the edge, and dh may be anything up to 256.
//
// Bound: operations.  The work is 4*B*H*Sq*Skv*dh FLOPs (half of it under a
// causal mask) against O((Sq + Skv) * dh) bytes, so at the main path's
// shapes the kernel is limited by arithmetic.  This first version keeps
// every tile in shared memory as fp32 and does the two products on the CUDA
// cores (fp32 FMA, ~67 TFLOP/s peak), not on the tensor cores: it is right
// and simple, and a wgmma/TMA version is later work.  What the design does
// about the bound: the grid's kv axis becomes a loop inside the CTA, so each
// (b, h, 64-row q tile) keeps its accumulator in registers across all k/v
// tiles and never writes scores to device memory; tiles wholly above the
// causal diagonal or wholly older than the window are never loaded.
//
// Layout of one CTA (256 threads): thread t owns query row t/4 of the tile
// and every 4th output column starting at t%4; the 4 threads of a row are
// adjacent lanes, so row max and row sum are two xor-shuffles.
#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row

template <int DHMAX>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DHMAX + 1) + (size_t)BK * (DHMAX + 1) +
         (size_t)BK * DHMAX + (size_t)BQ * (BK + 1);
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int nh, int nkvh, int dh, float scale,
                       int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][DHMAX+1], pre-scaled
  float* ks = qs + BQ * (DHMAX + 1);         // [BK][DHMAX+1]
  float* vs = ks + BK * (DHMAX + 1);         // [BK][DHMAX]
  float* ps = vs + BK * DHMAX;               // [BQ][BK+1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nh / nkvh);
  const int tid = threadIdx.x;
  const int r = tid >> 2;       // query row within the tile
  const int quad = tid & 3;     // column / key phase within the row
  constexpr int NCOL = DHMAX / 4;
  constexpr int NKEY = BK / 4;

  // stage the q tile (fp32, scaled as the reference scales it)
  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int rr = idx / dh, c = idx - rr * dh;
    const int qrow = q0 + rr;
    float val = 0.f;
    if (qrow < sq) val = to_f(q[(((size_t)b * sq + qrow) * nh + h) * dh + c]) * scale;
    qs[rr * (DHMAX + 1) + c] = val;
  }

  float acc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) acc[j] = 0.f;
  float m = NEG_INF_F, l = 0.f;

  const int qrow = q0 + r;
  const int qpos = q_offset + qrow;
  // key range any row of this tile can see: skip tiles wholly masked
  const int last_row = min(q0 + BQ, sq) - 1;
  int k_hi = skv;
  if (causal) k_hi = min(skv, q_offset + last_row + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // previous tile's readers are done with ks/vs/ps
    for (int idx = tid; idx < BK * dh; idx += THREADS) {
      const int j = idx / dh, c = idx - j * dh;
      const int kr = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kr < skv) {
        const size_t off = (((size_t)b * skv + kr) * nkvh + kvh) * dh + c;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j * (DHMAX + 1) + c] = kv;
      vs[j * DHMAX + c] = vv;
    }
    __syncthreads();

    // scores for row r, keys quad + 4*i
    float s[NKEY];
#pragma unroll
    for (int i = 0; i < NKEY; ++i) s[i] = 0.f;
    const float* qrow_s = qs + r * (DHMAX + 1);
    for (int c = 0; c < dh; ++c) {
      const float qv = qrow_s[c];
#pragma unroll
      for (int i = 0; i < NKEY; ++i) s[i] += qv * ks[(quad + 4 * i) * (DHMAX + 1) + c];
    }
    float mcur = NEG_INF_F;
    bool valid[NKEY];
#pragma unroll
    for (int i = 0; i < NKEY; ++i) {
      const int kpos = k0 + quad + 4 * i;
      bool ok = kpos < skv && qrow < sq;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      valid[i] = ok;
      if (!ok) s[i] = NEG_INF_F;
      mcur = fmaxf(mcur, s[i]);
    }
    mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, 1));
    mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, 2));
    const float mnew = fmaxf(m, mcur);
    const float alpha = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NKEY; ++i) {
      const float p = valid[i] ? expf(s[i] - mnew) : 0.f;
      psum += p;
      ps[r * (BK + 1) + quad + 4 * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = mnew;
    __syncthreads();  // the whole row of p is in shared memory

    const float* prow = ps + r * (BK + 1);
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * DHMAX + quad;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[j] += p * vrow[4 * j];
    }
  }

  if (qrow < sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * sq + qrow) * nh + h) * dh;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = quad + 4 * j;
      if (c < dh) orow[c] = from_f<T>(acc[j] * inv);
    }
  }
}

template <typename T, int DHMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int nh, int nkvh, int dh, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<DHMAX>() * sizeof(float);
  auto kern = flash_attention_kernel<T, DHMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, nh, b);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k,
                                        (const T*)v, (T*)o, sq, skv, nh, nkvh,
                                        dh, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int nh, int nkvh, int dh, float scale,
                int causal, int window, int q_offset, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale, causal,
                         window, q_offset, stream);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                          causal, window, q_offset, stream);
  if (dh <= 256)
    return launch<T, 256>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                          causal, window, q_offset, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int nh, int nkvh, int dh,
                                     float scale, int causal, int window,
                                     int q_offset, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return dispatch_dh<float>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                                causal, window, q_offset, s);
    case kBF16:
      return dispatch_dh<__nv_bfloat16>(q, k, v, o, b, sq, skv, nh, nkvh, dh,
                                        scale, causal, window, q_offset, s);
    case kF16:
      return dispatch_dh<__half>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                                 causal, window, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}
