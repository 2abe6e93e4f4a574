// Flash decode: one new query token against a KV cache, for Hopper (sm_90a),
// as split-K flash decoding.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py, `_decode_kernel` /
// `flash_decode` (a (B, H, L/block_k) Pallas grid with cache_len as a
// scalar-prefetch operand and one query head per grid cell).
//
// Semantics, as the reference: q (B,H,dh), k/v (B,L,KVH,dh), cache_len an
// int32 scalar in device memory; keys at or past cache_len are masked, and
// with a window so are keys before cache_len - window; fp32 softmax with
// NEG_INF = -0.7 * f32max; output acc / max(l, 1e-30) in q's dtype.  The
// reference model's ring cache (src/repro/models/attention.py
// `decode_attention(..., ring=True)`) is decoded with window 0: the model
// keeps a ring only when its window is at least L, and then the ring's age
// mask keeps exactly the slots below min(cache_len, L).
//
// Bound: device-memory bytes.  Decode reads every live K and V row once and
// does ~2 operations per byte read per query head of the group, so the
// least time is 2 * B * live_len * KVH * dh * sizeof(cache) / (3.35 TB/s).
// What the design does about that:
//   * the live range is split over `nsplit` CTAs per (b, kv head), so
//     B * KVH * nsplit CTAs stream the cache at once (the host picks
//     nsplit from B, KVH, L and the SM count -- about two CTAs an SM -- and
//     never reads cache_len).  Each CTA reads cache_len from device memory
//     and takes the s-th of nsplit equal chunks of the live range
//     [max(0, cache_len - window) if window, min(cache_len, L)), each
//     rounded up to 16 keys, so the work follows the live slots, not L;
//   * one CTA covers the G = H/KVH query heads that share its kv head, so
//     each K/V row is read once per group; a group wider than a CTA's 2560
//     outputs (Granite-20B's MQA: 48 heads of 128) is cut into `hblocks`
//     equal blocks of heads, one CTA each (the host picks the fewest that
//     fit), each reading the kv head's rows.  K/V tiles of 32 keys stay in the
//     cache's dtype in shared memory, loaded with 16-byte cp.async into a
//     double-buffered ring: the next tile loads while this one is used;
//   * scores: each warp holds 4 keys of the tile in registers, lanes across
//     dh with one 16-byte vector each, and walks the query heads, so the
//     dot products of a head and their shuffle reductions are independent
//     chains (the kernel is latency-bound: a CTA does little work between
//     its barriers).  Softmax online in fp32, in base 2 (q is scaled by
//     dh^-0.5 * log2 e once);
//   * P V: with dh dividing the 256 threads, thread t owns column t % dh of
//     every (256 / dh)-th head, so a V element is read once for all heads
//     of a thread; the keys are the outer loop, so its sums advance side by
//     side.  Up to 2560 outputs a CTA (G / hblocks * dh), 10 a thread;
//   * each CTA writes its fp32 (m, l, acc) to a scratch buffer (an empty
//     chunk writes m = NEG_INF, l = 0, acc = 0), and a second small kernel
//     combines them per (b, query head): M = max m_s, out = sum 2^(m_s-M)
//     acc_s / max(sum 2^(m_s-M) l_s, 1e-30), rounded once to q's dtype.  It
//     is launched as a programmatic dependent of the split kernel, so its
//     launch overlaps the split kernel's run.
// Both kernels launch from `repro_flash_decode`, one call from Python.
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;        // keys per tile: one per lane in the softmax
constexpr int NACC = 10;      // output elements per thread: a CTA's <= 2560
constexpr int COMBINE_X = 64;  // combine: outputs a CTA
constexpr int COMBINE_Y = 4;   // combine: thread rows sharing the splits

template <typename TKV>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(TKV); }

// The VEC values of one 16-byte chunk in shared memory, as fp32 (one
// 16-byte load).
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its fp32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const __half* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    out[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

// Dynamic shared memory of the split kernel.
template <typename TKV>
size_t split_smem_bytes(int g_heads, int dh) {
  constexpr int VEC = vec_of<TKV>();
  const int dhp = (dh + VEC - 1) / VEC * VEC;
  return 4 * (size_t)BK * dhp * sizeof(TKV) +
         ((size_t)g_heads * dhp + (size_t)g_heads * BK + 3 * (size_t)g_heads) *
             sizeof(float);
}

// The keys [lo, hi) of split s: the s-th of nsplit equal chunks of the live
// range, each rounded up to a multiple of 16 keys (empty when lo >= hi).
__device__ __forceinline__ void split_range(int raw_len, int lmax, int window,
                                            int nsplit, int s, int* lo,
                                            int* hi) {
  const int live_hi = min(raw_len, lmax);
  const int live_lo = window > 0 ? max(0, raw_len - window) : 0;
  const int n = max(0, live_hi - live_lo);
  const int chunk = ((n + nsplit - 1) / nsplit + 15) / 16 * 16;
  *lo = live_lo + s * chunk;
  *hi = min(*lo + chunk, live_hi);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const int* __restrict__ cache_len,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int lmax, int nh,
                          int nkvh, int dh, float scale, int window,
                          int nsplit, int hblocks) {
  constexpr int VEC = vec_of<TKV>();
  const int g_heads = nh / (nkvh * hblocks);  // this CTA's query heads
  const int dhp = (dh + VEC - 1) / VEC * VEC;
  const int nvec = dhp / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* ks = reinterpret_cast<TKV*>(smem_raw);            // [2][BK][dhp]
  TKV* vs = ks + 2 * BK * dhp;                           // [2][BK][dhp]
  float* qs = reinterpret_cast<float*>(vs + 2 * BK * dhp);  // [G][dhp]
  float* ps = qs + g_heads * dhp;                        // [G][BK]
  float* alpha = ps + g_heads * BK;                      // [G]
  float* m_run = alpha + g_heads;                        // [G]
  float* l_run = m_run + g_heads;                        // [G]

  // (b, kv head, head block): the combine sees kv head x head block as
  // one group of g_heads query heads, numbered bk
  const int bk = blockIdx.x;  // (b * nkvh + kv head) * hblocks + block
  const int b = bk / (nkvh * hblocks);
  const int hg = bk - b * nkvh * hblocks;  // its heads: hg * g_heads + [0, g)
  const int kvh = hg / hblocks;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_out = g_heads * dh;
  const size_t part = (size_t)bk * nsplit + s;
  float* acc_out = part_acc + part * n_out;
  grid_launch_dependents();  // the combine may be scheduled meanwhile

  int lo, hi;
  split_range(*cache_len, lmax, window, nsplit, s, &lo, &hi);
  if (lo >= hi) {
    for (int idx = tid; idx < n_out; idx += THREADS) acc_out[idx] = 0.f;
    for (int g = tid; g < g_heads; g += THREADS) {
      part_m[part * g_heads + g] = NEG_INF_F;
      part_l[part * g_heads + g] = 0.f;
    }
    return;
  }

  const bool vec = dh % VEC == 0 && aligned16(k) && aligned16(v);
  const size_t row_stride = (size_t)nkvh * dh;
  const TKV* kbase = k + ((size_t)b * lmax * nkvh + kvh) * dh;
  const TKV* vbase = v + ((size_t)b * lmax * nkvh + kvh) * dh;

  // keys [k0, k0 + BK) of the chunk into stage st; rows at or past hi are
  // zeros, so a masked key's p (0) never meets garbage
  auto load_tile = [&](int st, int k0) {
    TKV* kd = ks + st * BK * dhp;
    TKV* vd = vs + st * BK * dhp;
    const int rows = min(BK, hi - k0);
    if (vec) {
      for (int idx = tid; idx < BK * nvec; idx += THREADS) {
        const int r = idx / nvec, c = (idx - r * nvec) * VEC;
        const bool ok = r < rows;
        const size_t off = (size_t)(ok ? k0 + r : k0) * row_stride + c;
        cp_async_16(kd + r * dhp + c, kbase + off, ok ? 16 : 0);
        cp_async_16(vd + r * dhp + c, vbase + off, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BK * dhp; idx += THREADS) {
        const int r = idx / dhp, c = idx - r * dhp;
        const bool ok = r < rows && c < dh;
        const size_t off = (size_t)(k0 + r) * row_stride + c;
        kd[idx] = ok ? kbase[off] : from_f<TKV>(0.f);
        vd[idx] = ok ? vbase[off] : from_f<TKV>(0.f);
      }
    }
  };

  load_tile(0, lo);
  cp_async_commit();

  // q scaled as the reference scales it, and by log2 e: scores, m and the
  // partials' m are in base-2 units (the combine works in them too)
  const float qscale = scale * LOG2E_F;
  for (int idx = tid; idx < g_heads * dhp; idx += THREADS) {
    const int g = idx / dhp, c = idx - g * dhp;
    qs[idx] = c < dh
        ? to_f(q[((size_t)b * nh + hg * g_heads + g) * dh + c]) * qscale
        : 0.f;
  }
  for (int g = tid; g < g_heads; g += THREADS) {
    m_run[g] = NEG_INF_F;
    l_run[g] = 0.f;
  }

  // this thread's outputs, n_mine of them.  When dh divides THREADS (every
  // head dim of the served models), thread t owns column t % dh of heads
  // t / dh + k * (THREADS / dh): it reads each V element of a tile once for
  // all of its heads.  Otherwise it owns elements t + THREADS * k of the
  // flat [G][dh] group.
  const bool by_column = THREADS % dh == 0;
  const int hstep = by_column ? THREADS / dh : 0;
  const int g0 = by_column ? tid / dh : 0, c0 = tid - g0 * dh;
  const int n_mine = min(
      NACC, by_column ? (g0 < g_heads ? (g_heads - g0 + hstep - 1) / hstep : 0)
                      : max(0, (n_out - tid + THREADS - 1) / THREADS));
  // head and column of this thread's k-th output
  auto owner = [&](int k, int& g, int& c) {
    if (by_column) {
      g = g0 + k * hstep;
      c = c0;
    } else {
      const int idx = tid + THREADS * k;
      g = idx / dh;
      c = idx - g * dh;
    }
  };
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  // score lanes: groups of `sub` lanes (a power of two covering the nvec
  // 16-byte vectors of a row, at most 32).  Warp w owns keys [w * KPW,
  // (w + 1) * KPW) of a tile, its lane groups a share of them each, held in
  // registers while the warp walks the heads: the dot products of one head
  // are independent chains, and so are their shuffle reductions.  Rows
  // wider than 32 vectors take the pairs loop below instead.
  constexpr int KPW = BK / WARPS;
  int sub = 1;
  while (sub < nvec && sub < 32) sub <<= 1;
  const int groups = 32 / sub;
  const int grp = lane / sub, ls = lane & (sub - 1);
  const bool in_regs = nvec <= 32;

  const int ntiles = (hi - lo + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = lo + t * BK;
    const int st = t & 1;
    const int rows = min(BK, hi - k0);
    cp_async_wait<0>();
    __syncthreads();  // tile t and (at t = 0) q are in shared memory, and
                      // every thread is done with stage st ^ 1
    if (t + 1 < ntiles) {
      load_tile(st ^ 1, k0 + BK);
      cp_async_commit();
    }
    const TKV* kt = ks + st * BK * dhp;
    const TKV* vt = vs + st * BK * dhp;

    // scores of the tile into ps[g][j]
    if (in_regs) {
      float kf[KPW][VEC];
      int key[KPW];
      bool mine[KPW];
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        mine[u] = grp + u * groups < KPW;
        key[u] = warp * KPW + grp + u * groups;
        if (mine[u] && ls < nvec) {
          load16(kt + key[u] * dhp + ls * VEC, kf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[u][e] = 0.f;
        }
      }
      for (int g = 0; g < g_heads; ++g) {
        float qv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          float q4[4] = {0.f, 0.f, 0.f, 0.f};
          if (ls < nvec) load16(qs + g * dhp + ls * VEC + e, q4);
#pragma unroll
          for (int w = 0; w < 4; ++w) qv[e + w] = q4[w];
        }
        float dot[KPW];
#pragma unroll
        for (int u = 0; u < KPW; ++u) {
          dot[u] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot[u] += qv[e] * kf[u][e];
        }
        for (int off = sub >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < KPW; ++u)
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
        }
        if (ls == 0) {
#pragma unroll
          for (int u = 0; u < KPW; ++u)
            if (mine[u])
              ps[g * BK + key[u]] = key[u] < rows ? dot[u] : NEG_INF_F;
        }
      }
    } else {
      // one (head, key) pair a warp at a time, lanes across the row
      for (int p = warp; p < g_heads * BK; p += WARPS) {
        const int g = p / BK, j = p - g * BK;
        float dot = 0.f;
        if (j < rows) {
          for (int cv = lane; cv < nvec; cv += 32) {
            float kv[VEC];
            load16(kt + j * dhp + cv * VEC, kv);
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              float q4[4];
              load16(qs + g * dhp + cv * VEC + e, q4);
#pragma unroll
              for (int w = 0; w < 4; ++w) dot += q4[w] * kv[e + w];
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) ps[p] = j < rows ? dot : NEG_INF_F;
      }
    }
    __syncthreads();

  // online softmax: warp w takes heads w, w + WARPS, ...; lane j key j
    for (int g = warp; g < g_heads; g += WARPS) {
      float* row = ps + g * BK;
      const float x = row[lane];
      float mcur = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
      const float mold = m_run[g];
      const float mnew = fmaxf(mold, mcur);
      const float p = lane < rows ? exp2f(x - mnew) : 0.f;
      row[lane] = p;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float a = exp2f(mold - mnew);
        alpha[g] = a;
        l_run[g] = l_run[g] * a + psum;
        m_run[g] = mnew;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v over the tile's live keys; the keys are
    // the outer loop, so a thread's sums advance side by side
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      if (k < n_mine) {
        int g, c;
        owner(k, g, c);
        acc[k] *= alpha[g];
      }
    }
    const int j4_end = (rows + 3) / 4;
    if (by_column) {
      const TKV* vcol = vt + c0;
      for (int j4 = 0; j4 < j4_end; ++j4) {
        const TKV* vr = vcol + 4 * j4 * dhp;
        const float v0 = to_f(vr[0]), v1 = to_f(vr[dhp]);
        const float v2 = to_f(vr[2 * dhp]), v3 = to_f(vr[3 * dhp]);
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
          if (k < n_mine) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                ps + (g0 + k * hstep) * BK + 4 * j4);
            float a = acc[k];
            a += p4.x * v0;
            a += p4.y * v1;
            a += p4.z * v2;
            a += p4.w * v3;
            acc[k] = a;
          }
        }
      }
    } else {
      for (int j4 = 0; j4 < j4_end; ++j4) {
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
          if (k < n_mine) {
            int g, c;
            owner(k, g, c);
            const float4 p4 =
                *reinterpret_cast<const float4*>(ps + g * BK + 4 * j4);
            const TKV* vr = vt + 4 * j4 * dhp + c;
            float a = acc[k];
            a += p4.x * to_f(vr[0]);
            a += p4.y * to_f(vr[dhp]);
            a += p4.z * to_f(vr[2 * dhp]);
            a += p4.w * to_f(vr[3 * dhp]);
            acc[k] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    if (k < n_mine) {
      int g, c;
      owner(k, g, c);
      acc_out[g * dh + c] = acc[k];
    }
  }
  for (int g = tid; g < g_heads; g += THREADS) {
    part_m[part * g_heads + g] = m_run[g];
    part_l[part * g_heads + g] = l_run[g];
  }
}

// The splits' log-sum-exp combine for a (b, kv head, head block) group: a
// CTA takes COMBINE_X outputs, and its COMBINE_Y rows of threads take every
// COMBINE_Y-th split each, so a thread's loads are few and the CTAs many;
// the rows' partial sums meet in shared memory, added in row order.
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_X * COMBINE_Y)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            TQ* __restrict__ o, int g_heads, int dh,
                            int nsplit) {
  __shared__ float red_l[COMBINE_Y][COMBINE_X], red_a[COMBINE_Y][COMBINE_X];
  const int n_out = g_heads * dh;
  const int bk = blockIdx.x;
  const int x = threadIdx.x, y = threadIdx.y;
  const int idx = blockIdx.y * COMBINE_X + x;
  const bool live = idx < n_out;
  const int g = live ? idx / dh : 0;
  const size_t part0 = (size_t)bk * nsplit;
  grid_dependency_wait();  // the split kernel has finished
  float l = 0.f, a = 0.f;
  if (live) {
    const float* pm = part_m + part0 * g_heads + g;
    const float* pl = part_l + part0 * g_heads + g;
    const float* pa = part_acc + part0 * n_out + idx;
    float mx = NEG_INF_F;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[(size_t)s * g_heads]);
#pragma unroll 4
    for (int s = y; s < nsplit; s += COMBINE_Y) {
      const float w = exp2f(pm[(size_t)s * g_heads] - mx);
      l += w * pl[(size_t)s * g_heads];
      a += w * pa[(size_t)s * n_out];
    }
  }
  red_l[y][x] = l;
  red_a[y][x] = a;
  __syncthreads();
  if (y == 0 && live) {
#pragma unroll
    for (int r = 1; r < COMBINE_Y; ++r) {
      l += red_l[r][x];
      a += red_a[r][x];
    }
    o[(size_t)bk * n_out + idx] = from_f<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* clen,
           void* o, float* scratch, int b, int lmax, int nh, int nkvh,
           int dh, float scale, int window, int nsplit, int hblocks,
           cudaStream_t stream) {
  const int g = nh / (nkvh * hblocks);   // query heads a CTA
  const int groups = b * nkvh * hblocks;
  const size_t n_out = (size_t)g * dh;
  const size_t parts = (size_t)groups * nsplit;
  float* part_acc = scratch;
  float* part_m = part_acc + parts * n_out;
  float* part_l = part_m + parts * g;
  const size_t smem = split_smem_bytes<TKV>(g, dh);
  auto kern = flash_decode_split_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(groups, nsplit), THREADS, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, clen, part_acc, part_m,
      part_l, lmax, nh, nkvh, dh, scale, window, nsplit, hblocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the combine is launched as a programmatic dependent of the split
  // kernel: its launch overlaps the split kernel's run
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups,
                     (unsigned)((n_out + COMBINE_X - 1) / COMBINE_X));
  cfg.blockDim = dim3(COMBINE_X, COMBINE_Y);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<TQ>,
                                 (const float*)part_acc,
                                 (const float*)part_m,
                                 (const float*)part_l, (TQ*)o, g, dh,
                                 nsplit);
}

template <typename TQ>
int dispatch_kv(const void* q, const void* k, const void* v, const int* clen,
                void* o, float* scratch, int b, int lmax, int nh, int nkvh,
                int dh, float scale, int window, int nsplit, int hblocks,
                int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, k, v, clen, o, scratch, b, lmax, nh, nkvh,
                               dh, scale, window, nsplit, hblocks, s);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k, v, clen, o, scratch, b, lmax, nh,
                                       nkvh, dh, scale, window, nsplit,
                                       hblocks, s);
    case kF16:
      return launch<TQ, __half>(q, k, v, clen, o, scratch, b, lmax, nh, nkvh,
                                dh, scale, window, nsplit, hblocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int split_attrs(int kv_dtype, int* out) {
  switch (kv_dtype) {
    case kF32:
      return kernel_attrs((const void*)flash_decode_split_kernel<TQ, float>,
                          out);
    case kBF16:
      return kernel_attrs(
          (const void*)flash_decode_split_kernel<TQ, __nv_bfloat16>, out);
    case kF16:
      return kernel_attrs((const void*)flash_decode_split_kernel<TQ, __half>,
                          out);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int both_attrs(int kv_dtype, int* out) {
  const int err = split_attrs<TQ>(kv_dtype, out);
  if (err != 0) return err;
  return kernel_attrs((const void*)flash_decode_combine_kernel<TQ>, out + 2);
}

}  // namespace

// scratch: fp32, b * nkvh * nsplit * (G * dh + 2 * G) elements (the splits'
// acc, then m, then l).  hblocks: the blocks of heads a kv head's group of
// G = nh / nkvh query heads is cut into, a divisor of G with
// G / hblocks * dh <= 2560.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* cache_len, void* o,
                                  void* scratch, int b, int lmax, int nh,
                                  int nkvh, int dh, float scale, int window,
                                  int nsplit, int hblocks, int q_dtype,
                                  int kv_dtype, void* stream) {
  const int g = nh / nkvh;
  if (nsplit < 1 || hblocks < 1 || g % hblocks != 0 ||
      g / hblocks * dh > NACC * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* clen = (const int*)cache_len;
  float* part = (float*)scratch;
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<float>(q, k, v, clen, o, part, b, lmax, nh, nkvh, dh,
                                scale, window, nsplit, hblocks, kv_dtype, s);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(q, k, v, clen, o, part, b, lmax, nh,
                                        nkvh, dh, scale, window, nsplit,
                                        hblocks, kv_dtype, s);
    case kF16:
      return dispatch_kv<__half>(q, k, v, clen, o, part, b, lmax, nh, nkvh,
                                 dh, scale, window, nsplit, hblocks, kv_dtype,
                                 s);
  }
  return (int)cudaErrorInvalidValue;
}

// Registers a thread and local-memory bytes a thread of the split kernel
// (out[0], out[1]) and the combine kernel (out[2], out[3]) for these dtypes.
extern "C" int repro_flash_decode_attrs(int q_dtype, int kv_dtype, int* out) {
  switch (q_dtype) {
    case kF32: return both_attrs<float>(kv_dtype, out);
    case kBF16: return both_attrs<__nv_bfloat16>(kv_dtype, out);
    case kF16: return both_attrs<__half>(kv_dtype, out);
  }
  return (int)cudaErrorInvalidValue;
}
