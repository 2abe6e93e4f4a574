// Flash attention, forward only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_flash_kernel` /
// `flash_attention` (a sequential (B, H, nq, nk) Pallas grid whose kv axis
// carries the online-softmax scratch from one step to the next).
//
// Semantics, as the reference: q (B,Sq,H,dh), k/v (B,Skv,KVH,dh), all one
// dtype; query head h reads kv head h / (H/KVH); scores in fp32 scaled by
// dh^-0.5; causal and sliding-window masks taken against q_offset + row;
// masked scores are NEG_INF = -0.7 * f32max and their probabilities exactly
// 0 (a row with no visible key comes out 0, as from the Pallas kernel);
// output acc / max(l, 1e-30) rounded once to q's dtype.  Ragged Sq and Skv
// are masked at the edge, and dh may be anything up to 256.
//
// Bound: device-memory bytes at the main path's shapes (Qwen3-8B's causal
// prefill attention is ~1.1 GFLOP against ~21 MB), so the products have to
// run on the tensor cores and the loads have to overlap them.  Two kernels,
// chosen by dtype in `repro_flash_attention`:
//
// * bf16/f16 (`flash_attention_tc_kernel`): one CTA of 4 warps per (64-row
//   q tile, head, batch); each warp owns 16 query rows.  Q, K and V tiles
//   stay in q's dtype in shared memory, loaded with 16-byte cp.async; K/V
//   are double-buffered, so the next kv tile loads while this one is
//   multiplied.  Rows are padded by 16 bytes, so the 8 row addresses of an
//   ldmatrix fall in 8 different bank groups.  S = Q K^T and O += P V run on
//   mma.sync.m16n8k16 with fp32 accumulators in registers; Q fragments are
//   reloaded from shared memory per 16-wide k-step (at dh 256 the output
//   accumulators alone take 128 registers a thread, and the kv tile is 32
//   keys, not 64, for the same reason); a k-step's fragments are all loaded
//   before its products start.  The scale (times log2 e: the softmax runs
//   in base 2) is applied to the fp32 scores; masks and the online softmax
//   run in registers (row max and sum over the 4 lanes that share a row),
//   and the output is staged through shared memory for 16-byte row stores.
//   P is rounded to q's dtype to become the A fragment of P V -- the one
//   numeric departure from the reference, which multiplies fp32 p by fp32
//   v (error <= 2^-9 max|v| in bf16).  V's B fragments come through
//   ldmatrix.trans.  dh is rounded up to a
//   multiple of 16 with zero columns.  Tiles wholly above the causal
//   diagonal or wholly older than the window are never loaded, and masks
//   are evaluated only on tiles that cross an edge.
// * fp32 (`flash_attention_f32_kernel`, the first version's kernel): the
//   tensor cores cannot hold the fp32 tolerance, so both products stay on
//   the CUDA cores in fp32 FMA, tiles staged as fp32: thread t owns query
//   row t/4 of a 64-row tile and every 4th output column from t%4.
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16/f16: tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_BQ = 64;        // query rows per CTA, 16 per warp
constexpr int TC_THREADS = 128;  // 4 warps

template <int DH>
struct TcShape {
  static constexpr int BK = DH >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int LD = DH + 8;               // smem row stride, elements
  static constexpr int ROWS = TC_BQ + 4 * BK;     // Q + 2 stages of K and V
};

template <typename T, int DH>
constexpr size_t tc_smem_bytes() {
  return (size_t)TcShape<DH>::ROWS * TcShape<DH>::LD * sizeof(T);
}

// Load `ROWS` rows of `dh` elements into a [ROWS][LD] shared tile; row r of
// the source is at src + r * stride, rows at or past `nvalid` are zeros.
// With `vec` (dh a multiple of 8, 16-byte aligned tensors) as cp.async
// 16-byte chunks, which write columns [0, dh) only; otherwise element by
// element, zeros included up to DH.
template <typename T, int ROWS, int DH>
__device__ __forceinline__ void tc_load_tile(T* dst, const T* src,
                                             size_t stride, int nvalid,
                                             int dh, bool vec, int tid) {
  constexpr int LD = TcShape<DH>::LD;
  if (vec) {
    constexpr int CPR = DH / 8;  // 16-byte chunks a row
    for (int idx = tid; idx < ROWS * CPR; idx += TC_THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      if (c < dh) {
        const bool ok = r < nvalid;
        cp_async_16(dst + r * LD + c, ok ? src + r * stride + c : src,
                    ok ? 16 : 0);
      }
    }
  } else {
    for (int idx = tid; idx < ROWS * DH; idx += TC_THREADS) {
      const int r = idx / DH, c = idx % DH;
      dst[r * LD + c] = (r < nvalid && c < dh) ? src[r * stride + c]
                                               : from_f<T>(0.f);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int sq,
                          int skv, int nh, int nkvh, int dh, float scale,
                          int causal, int window, int q_offset) {
  constexpr int BK = TcShape<DH>::BK, LD = TcShape<DH>::LD;
  constexpr int NT = BK / 8;   // key n-tiles of S
  constexpr int OT = DH / 8;   // column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + TC_BQ * LD;                 // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]

  const int q0 = blockIdx.x * TC_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nh / nkvh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int dh16 = (dh + 15) & ~15;
  const float scale_log2 = scale * LOG2E_F;  // scores in base-2 units
  const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);

  // key range any row of this tile can see: tiles outside it never load
  const int p_first = q_offset + q0;
  const int p_last = q_offset + min(q0 + TC_BQ, sq) - 1;
  const int k_hi = causal ? min(skv, p_last + 1) : skv;
  const int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_row[2] = {NEG_INF_F, NEG_INF_F};
  float l_row[2] = {0.f, 0.f};  // this thread's share of the row sums

  const size_t kv_stride = (size_t)nkvh * dh;
  const T* kbase = k + ((size_t)b * skv * nkvh + kvh) * dh;
  const T* vbase = v + ((size_t)b * skv * nkvh + kvh) * dh;

  if (ntiles > 0) {
    // cp.async writes columns [0, dh); the k-steps read up to dh16
    if (vec && dh < dh16) {
      for (int idx = tid; idx < TcShape<DH>::ROWS * 8; idx += TC_THREADS)
        qs[(idx >> 3) * LD + dh + (idx & 7)] = from_f<T>(0.f);
    }
    tc_load_tile<T, TC_BQ, DH>(
        qs, q + (((size_t)b * sq + q0) * nh + h) * dh, (size_t)nh * dh,
        sq - q0, dh, vec, tid);
    tc_load_tile<T, BK, DH>(ks, kbase + (size_t)k_lo * kv_stride, kv_stride,
                            skv - k_lo, dh, vec, tid);
    tc_load_tile<T, BK, DH>(vs, vbase + (size_t)k_lo * kv_stride, kv_stride,
                            skv - k_lo, dh, vec, tid);
    cp_async_commit();
  }

  const int row0 = q_offset + q0 + warp * 16 + gid;  // position of row gid
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * BK;
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = k0 + BK;
      tc_load_tile<T, BK, DH>(ks + (st ^ 1) * BK * LD,
                              kbase + (size_t)k1 * kv_stride, kv_stride,
                              skv - k1, dh, vec, tid);
      tc_load_tile<T, BK, DH>(vs + (st ^ 1) * BK * LD,
                              vbase + (size_t)k1 * kv_stride, kv_stride,
                              skv - k1, dh, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every warp
    const T* kt = ks + st * BK * LD;
    const T* vt = vs + st * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    // a k-step's fragments are all loaded before its products start, so
    // the loads' latency overlaps the previous step's products
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if (kk * 16 < dh16) {
        uint32_t a[4], bf[NT / 2][4];
        ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldmatrix_x4(bf[np],
                      kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_16816<T>(s[2 * np], a, bf[np][0], bf[np][1]);
          mma_16816<T>(s[2 * np + 1], a, bf[np][2], bf[np][3]);
        }
      }
    }

    // scale, mask (edge tiles only), online softmax over the quad's lanes
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > p_first) ||
                      (window > 0 && k0 <= p_last - window);
    uint32_t okbits = 0xffffffffu;  // bit 4*nt+e: score (nt, e) is visible
    float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + nt * 8 + tig * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) {
            x = NEG_INF_F;
            okbits &= ~(1u << (nt * 4 + e));
          }
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m_row[r], mx[r]);
      alpha[r] = exp2f(m_row[r] - mnew);
      m_row[r] = mnew;
      l_row[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (okbits >> (nt * 4 + e)) & 1u
                            ? exp2f(s[nt][e] - m_row[e >> 1])
                            : 0.f;
        s[nt][e] = p;
        l_row[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: P's C fragments are the A fragments of this product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // V fragments four 16-column blocks at a time, loaded before use
#pragma unroll
      for (int np0 = 0; np0 < OT / 2; np0 += 4) {
        uint32_t bf[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if ((np0 + u) * 16 < dh16)
            ldmatrix_x4_trans(
                bf[u], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LD + (np0 + u) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if ((np0 + u) * 16 < dh16) {
            mma_16816<T>(acc[2 * (np0 + u)], a, bf[u][0], bf[u][1]);
            mma_16816<T>(acc[2 * (np0 + u) + 1], a, bf[u][2], bf[u][3]);
          }
      }
    }
    __syncthreads();  // stage st is free for tile t + 2
  }

  // normalise rows gid and gid + 8 of this warp into the q tile's place
  // (every warp is past its last read of it), then store whole rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int row = warp * 16 + gid + r * 8;
#pragma unroll
    for (int i = 0; i < OT; ++i)
      *reinterpret_cast<uint32_t*>(qs + row * LD + i * 8 + tig * 2) =
          pack2<T>(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
  __syncthreads();
  const int nrows = min(TC_BQ, sq - q0);
  T* obase = o + (((size_t)b * sq + q0) * nh + h) * dh;
  const size_t ostride = (size_t)nh * dh;
  if (vec) {
    constexpr int CPR = DH / 8;
    for (int idx = tid; idx < TC_BQ * CPR; idx += TC_THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      if (r < nrows && c < dh)
        *reinterpret_cast<uint4*>(obase + r * ostride + c) =
            *reinterpret_cast<const uint4*>(qs + r * LD + c);
    }
  } else {
    for (int idx = tid; idx < TC_BQ * dh; idx += TC_THREADS) {
      const int r = idx / dh, c = idx - r * dh;
      if (r < nrows) obase[r * ostride + c] = qs[r * LD + c];
    }
  }
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int sq, int skv, int nh, int nkvh, int dh, float scale,
              int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<T, DH>();
  auto kern = flash_attention_tc_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + TC_BQ - 1) / TC_BQ, nh, b);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, nh, nkvh, dh,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row

template <int DHMAX>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DHMAX + 1) + (size_t)BK * (DHMAX + 1) +
         (size_t)BK * DHMAX + (size_t)BQ * (BK + 1);
}

template <int DHMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int sq, int skv, int nh, int nkvh, int dh,
                           float scale, int causal, int window, int q_offset) {
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

  // stage the q tile (scaled as the reference scales it)
  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int rr = idx / dh, c = idx - rr * dh;
    const int qrow = q0 + rr;
    float val = 0.f;
    if (qrow < sq) val = q[(((size_t)b * sq + qrow) * nh + h) * dh + c] * scale;
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
        kv = k[off];
        vv = v[off];
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
    float* orow = o + (((size_t)b * sq + qrow) * nh + h) * dh;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int c = quad + 4 * j;
      if (c < dh) orow[c] = acc[j] * inv;
    }
  }
}

template <int DHMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int skv, int nh, int nkvh, int dh, float scale,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<DHMAX>() * sizeof(float);
  auto kern = flash_attention_f32_kernel<DHMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, nh, b);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv,
      nh, nkvh, dh, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// The padded head dim a dtype's kernel is instantiated for (0: too wide).
int dh_bound(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 0; }

template <typename T>
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int nh, int nkvh, int dh, float scale,
                int causal, int window, int q_offset, cudaStream_t s) {
  switch (dh_bound(dh)) {
    case 64:
      return launch_tc<T, 64>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                              causal, window, q_offset, s);
    case 128:
      return launch_tc<T, 128>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                               causal, window, q_offset, s);
    case 256:
      return launch_tc<T, 256>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                               causal, window, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int b,
                 int sq, int skv, int nh, int nkvh, int dh, float scale,
                 int causal, int window, int q_offset, cudaStream_t s) {
  switch (dh_bound(dh)) {
    case 64:
      return launch_f32<64>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                            causal, window, q_offset, s);
    case 128:
      return launch_f32<128>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                             causal, window, q_offset, s);
    case 256:
      return launch_f32<256>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                             causal, window, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int tc_attrs(int dh, int* out) {
  switch (dh_bound(dh)) {
    case 64:
      return kernel_attrs((const void*)flash_attention_tc_kernel<T, 64>, out);
    case 128:
      return kernel_attrs((const void*)flash_attention_tc_kernel<T, 128>, out);
    case 256:
      return kernel_attrs((const void*)flash_attention_tc_kernel<T, 256>, out);
  }
  return (int)cudaErrorInvalidValue;
}

int f32_attrs(int dh, int* out) {
  switch (dh_bound(dh)) {
    case 64:
      return kernel_attrs((const void*)flash_attention_f32_kernel<64>, out);
    case 128:
      return kernel_attrs((const void*)flash_attention_f32_kernel<128>, out);
    case 256:
      return kernel_attrs((const void*)flash_attention_f32_kernel<256>, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 and f16 take the tensor-core kernel, fp32 the CUDA-core kernel; a
// refused launch of either returns its error (no fallback between them).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int nh, int nkvh, int dh,
                                     float scale, int causal, int window,
                                     int q_offset, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return dispatch_f32(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale, causal,
                          window, q_offset, s);
    case kBF16:
      return dispatch_tc<__nv_bfloat16>(q, k, v, o, b, sq, skv, nh, nkvh, dh,
                                        scale, causal, window, q_offset, s);
    case kF16:
      return dispatch_tc<__half>(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale,
                                 causal, window, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Of the kernel that `repro_flash_attention` launches for this dtype and
// head dim: registers a thread (out[0]) and local-memory bytes a thread,
// i.e. spills (out[1]).
extern "C" int repro_flash_attention_attrs(int dtype, int dh, int* out) {
  switch (dtype) {
    case kF32: return f32_attrs(dh, out);
    case kBF16: return tc_attrs<__nv_bfloat16>(dh, out);
    case kF16: return tc_attrs<__half>(dh, out);
  }
  return (int)cudaErrorInvalidValue;
}
