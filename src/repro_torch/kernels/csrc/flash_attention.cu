// Flash attention for Hopper (sm_90a): the forward, and for bf16/f16 its
// backward.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_flash_kernel` /
// `flash_attention` (a sequential (B, H, nq, nk) Pallas grid whose kv axis
// carries the online-softmax scratch from one step to the next).  The
// backward replaces no Pallas kernel: the reference differentiates its XLA
// path (src/repro/kernels/flash_attention/ops.py, `attend`); it replaces
// the port's autograd through the plain fp32 version, which built the full
// (B, KVH, G, Sq, Skv) fp32 score matrix and ran at ~0.7% of its roofline.
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
//
// The tensor-core forward optionally writes each row's log-sum-exp (`lse`,
// fp32 (B, H, Sq), base e, of the dh^-0.5-scaled scores; -inf for a row
// that sees no key): an instance of its own, so serving, which passes
// none, runs the instructions it ran before.  The backward (FA2's design)
// takes q, k, v, o, dO and lse, from `repro_flash_attention_bwd`:
//
// Bound: operations.  Granite-3-2B's training call (B 4, 1024 rows, 32/8
// heads of 64, causal) is 5 products over 524,800 visible pairs a head,
// 4.30e10 FLOPs (0.0435 ms at 989 TFLOP/s), against ~84 MB of q, k, v, o,
// dO read and dq, dk, dv written (0.025 ms at 3.35 TB/s).  So the products
// run on the tensor cores (the forward's mma.sync.m16n8k16 building
// blocks, fp32 accumulators), P is recomputed from lse instead of stored,
// and every tile is loaded with cp.async double-buffered behind the
// previous tile's products.  Three kernels:
// * `flash_attention_bwd_prep_kernel`: D = rowsum(dO o O) in fp32.
// * `flash_attention_bwd_dkdv_kernel`: one CTA per (kv tile of 64 keys, kv
//   head, batch; first tiles first, as they see the most q tiles under a
//   causal mask) keeps dK and dV of its tile in registers while the q
//   tiles of every query head of its group that see a key of it stream
//   past: S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse), dS^T = P^T
//   (dP^T - D), dV += P^T dO, dK += dS^T Q.  The group's sum is free and
//   takes no atomics.  Where that grid would not fill the card (MQA at
//   batch 1), CTAs share a tile's query heads and write fp32 partial sums,
//   which `flash_attention_bwd_dkv_sum_kernel` adds in order.
// * `flash_attention_bwd_dq_kernel`: one CTA per (64 q rows, head, batch;
//   last tiles first) over the kv tiles it sees: S, dP, dS again, dQ += dS
//   K.  Seven products in all, not five, so that nothing is summed with
//   atomics: the result repeats bit for bit.
// Tiles wholly above the diagonal or outside the window are skipped, masks
// evaluated only on tiles that cross an edge, as in the forward.  The one
// departure from the plain fp32 backward is the forward's: P and dS are
// rounded to the input dtype as mma operands; every sum is fp32, lse and D
// are fp32, and dq, dk, dv are rounded once.  A row that sees no key gets
// zero gradients and adds nothing.  The backward's device names hold none
// of the forward kernels' names.
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
template <typename T, int ROWS, int DH, int THREADS = TC_THREADS>
__device__ __forceinline__ void tc_load_tile(T* dst, const T* src,
                                             size_t stride, int nvalid,
                                             int dh, bool vec, int tid) {
  constexpr int LD = TcShape<DH>::LD;
  if (vec) {
    constexpr int CPR = DH / 8;  // 16-byte chunks a row
    for (int idx = tid; idx < ROWS * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      if (c < dh) {
        const bool ok = r < nvalid;
        cp_async_16(dst + r * LD + c, ok ? src + r * stride + c : src,
                    ok ? 16 : 0);
      }
    }
  } else {
    for (int idx = tid; idx < ROWS * DH; idx += THREADS) {
      const int r = idx / DH, c = idx % DH;
      dst[r * LD + c] = (r < nvalid && c < dh) ? src[r * stride + c]
                                               : from_f<T>(0.f);
    }
  }
}

template <typename T, int DH, bool LSE>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int sq, int skv, int nh,
                          int nkvh, int dh, float scale, int causal,
                          int window, int q_offset) {
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
    if (LSE && tig == 0 && q0 + row < sq)
      lse[((size_t)b * nh + h) * sq + q0 + row] =
          l > 0.f ? (m_row[r] + log2f(l)) * LN2_F : NEG_INFINITY_F;
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
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int sq, int skv, int nh, int nkvh, int dh,
              float scale, int causal, int window, int q_offset,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<T, DH>();
  // serving passes no lse and runs the instance without its store
  auto kern = lse ? flash_attention_tc_kernel<T, DH, true>
                  : flash_attention_tc_kernel<T, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + TC_BQ - 1) / TC_BQ, nh, b);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, skv, nh, nkvh,
      dh, scale, causal, window, q_offset);
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
int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int sq, int skv, int nh, int nkvh, int dh,
                float scale, int causal, int window, int q_offset,
                cudaStream_t s) {
  switch (dh_bound(dh)) {
    case 64:
      return launch_tc<T, 64>(q, k, v, o, lse, b, sq, skv, nh, nkvh, dh,
                              scale, causal, window, q_offset, s);
    case 128:
      return launch_tc<T, 128>(q, k, v, o, lse, b, sq, skv, nh, nkvh, dh,
                               scale, causal, window, q_offset, s);
    case 256:
      return launch_tc<T, 256>(q, k, v, o, lse, b, sq, skv, nh, nkvh, dh,
                               scale, causal, window, q_offset, s);
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

// out[0..1] of the serving instance, out[2..3] of the one that writes lse
template <typename T, int DH>
int tc_attrs_of(int* out) {
  const int err = kernel_attrs(
      (const void*)flash_attention_tc_kernel<T, DH, false>, out);
  if (err) return err;
  return kernel_attrs((const void*)flash_attention_tc_kernel<T, DH, true>,
                      out + 2);
}

template <typename T>
int tc_attrs(int dh, int* out) {
  switch (dh_bound(dh)) {
    case 64: return tc_attrs_of<T, 64>(out);
    case 128: return tc_attrs_of<T, 128>(out);
    case 256: return tc_attrs_of<T, 256>(out);
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

// ---------------------------------------------------------------------------
// backward, bf16/f16: tensor cores
// ---------------------------------------------------------------------------
// Tiles of the backward by head dim.  The dK/dV kernel keeps a tile of BK
// keys (16 a warp row group) and both of its gradients in registers while
// the BQ-row q tiles of its query heads stream past; at dh 256 two warps
// share a row group, each accumulating half of dh (both compute the
// group's scores: 256 accumulators a thread would not fit).  The dQ kernel
// has the forward's shape: TC_BQ q rows a CTA (16 a warp), DQ_BK keys a
// tile.  The tiles were chosen by timing variants on the H100 (PERF.md).
template <int DH>
struct BwdShape {
  static constexpr int BK = 64;
  static constexpr int BQ = DH <= 64 ? 64 : 32;
  static constexpr int SPLIT = DH >= 256 ? 2 : 1;
  static constexpr int DQ_BK = DH == 128 ? 64 : 32;
  static constexpr int THREADS = 2 * BK * SPLIT;  // a warp a 16 rows a part
  static constexpr int LD = TcShape<DH>::LD;
};

constexpr int PREP_THREADS = 256;  // the prep and sum kernels

template <typename T, int DH>
constexpr size_t dkdv_smem_bytes() {
  using S = BwdShape<DH>;
  // K and V; two stages of Q and dO; two stages of lse and D
  return (size_t)(2 * S::BK + 4 * S::BQ) * S::LD * sizeof(T) +
         (size_t)4 * S::BQ * sizeof(float);
}

template <typename T, int DH>
constexpr size_t dq_smem_bytes() {
  using S = BwdShape<DH>;
  // Q and dO; two stages of K and V
  return (size_t)(2 * TC_BQ + 4 * S::DQ_BK) * S::LD * sizeof(T);
}

// c[16 x 8*NT] += A B^T over one 16-wide k-step: A's 16 rows at `a` and
// B^T's 8*NT rows at `bt`, both row-major in shared memory with stride LD
// (the forward's S = Q K^T step).
template <typename T, int NT, int LD>
__device__ __forceinline__ void mma_abt_step(float (&c)[NT][4], const T* a,
                                             const T* bt, int kk, int lane) {
  uint32_t af[4], bf[NT / 2][4];
  ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    ldmatrix_x4(bf[np], bt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 LD + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    mma_16816<T>(c[2 * np], af, bf[np][0], bf[np][1]);
    mma_16816<T>(c[2 * np + 1], af, bf[np][2], bf[np][3]);
  }
}

// c[16 x 16*NB] += A B over one 16-wide k-step: A in registers, B's 16 rows
// at `b`, row-major [k][n] in shared memory with stride LD, as B fragments
// through ldmatrix.trans (the forward's O += P V step), four 16-column
// blocks loaded before their products (two where the accumulators take
// 128 registers: dQ at dh 256); blocks at or past column n_end are skipped.
template <typename T, int NB, int LD>
__device__ __forceinline__ void mma_ab_step(float (&c)[2 * NB][4],
                                            const uint32_t (&a)[4],
                                            const T* b, int n_end,
                                            int lane) {
  constexpr int G = NB > 8 ? 2 : 4;
  static_assert(NB % G == 0, "column blocks go G at a time");
#pragma unroll
  for (int np0 = 0; np0 < NB; np0 += G) {
    uint32_t bf[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if ((np0 + u) * 16 < n_end)
        ldmatrix_x4_trans(bf[u], b + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                         LD + (np0 + u) * 16 +
                                     (lane >> 4) * 8);
#pragma unroll
    for (int u = 0; u < G; ++u)
      if ((np0 + u) * 16 < n_end) {
        mma_16816<T>(c[2 * (np0 + u)], a, bf[u][0], bf[u][1]);
        mma_16816<T>(c[2 * (np0 + u) + 1], a, bf[u][2], bf[u][3]);
      }
  }
}

// k-step kk's A fragments from the C fragments of a 16-row product whose
// columns are that step's k (as the forward turns P into P V's operand),
// rounded to T.
template <typename T, int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int kk) {
  a[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Store the first `nrows` rows of a [ROWS][LD] shared tile to rows of
// `stride` elements: 16-byte stores with `vec`, else element by element.
template <typename T, int ROWS, int DH, int THREADS>
__device__ __forceinline__ void tc_store_tile(T* dst, size_t stride,
                                              const T* src, int nrows,
                                              int dh, bool vec, int tid) {
  constexpr int LD = TcShape<DH>::LD;
  if (vec) {
    constexpr int CPR = DH / 8;
    for (int idx = tid; idx < ROWS * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx % CPR) * 8;
      if (r < nrows && c < dh)
        *reinterpret_cast<uint4*>(dst + r * stride + c) =
            *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
  } else {
    for (int idx = tid; idx < ROWS * dh; idx += THREADS) {
      const int r = idx / dh, c = idx - r * dh;
      if (r < nrows) dst[r * stride + c] = src[r * LD + c];
    }
  }
}

// D = rowsum(dO o O) in fp32, `lpr` lanes (a power of two up to 32) a
// (batch, row, head), written in lse's (B, H, Sq) layout.  With `vec`
// each lane reads 16-byte chunks of the row, else single elements.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
flash_attention_bwd_prep_kernel(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                float* __restrict__ delta, int rows, int sq,
                                int nh, int dh, int lpr, int vec) {
  const int idx = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int row = idx / lpr, sub = idx % lpr;
  float acc = 0.f;
  if (row < rows) {
    const T* orow = o + (size_t)row * dh;
    const T* drow = dout + (size_t)row * dh;
    if (vec) {
      for (int c = sub * 8; c < dh; c += lpr * 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 g = *reinterpret_cast<const uint4*>(drow + c);
        const T* av = reinterpret_cast<const T*>(&a);
        const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f(av[e]) * to_f(gv[e]);
      }
    } else {
      for (int c = sub; c < dh; c += lpr)
        acc += to_f(orow[c]) * to_f(drow[c]);
    }
  }
  for (int off = lpr / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const int h = row % nh, bs = row / nh;  // row = (b * sq + r) * nh + h
    delta[((size_t)(bs / sq) * nh + h) * sq + bs % sq] = acc;
  }
}

// dK and dV from the dK/dV kernel's fp32 partial sums of `hsplit` head
// shares ([dK: hsplit][dV: hsplit] blocks of n values each), summed in
// share order.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
flash_attention_bwd_dkv_sum_kernel(const float* __restrict__ part,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   size_t n, int hsplit) {
  for (size_t i = (size_t)blockIdx.x * PREP_THREADS + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * PREP_THREADS) {
    const size_t which = i / n, j = i - which * n;
    float acc = 0.f;
    for (int p = 0; p < hsplit; ++p)
      acc += part[(which * hsplit + p) * n + j];
    (which ? dv : dk)[j] = from_f<T>(acc);
  }
}

// dK and dV of one tile of BK keys of one kv head: the query heads of its
// share of the group (all of it when `hsplit` is 1), every q tile that
// sees a key of the tile.  Per (head, q tile):
// S^T = K Q^T and dP^T = V dO^T; P^T = exp(S^T - lse) (masked on tiles
// that cross an edge), dS^T = P^T (dP^T - D); dV += P^T dO, dK += dS^T Q,
// P^T and dS^T rounded to T as operands.  Q, dO, lse and D tiles are
// double-buffered through cp.async.  With `part` the gradients go out as
// fp32 partial sums of this head share, for the sum kernel; without, as T.
template <typename T, int DH>
__global__ void __launch_bounds__(BwdShape<DH>::THREADS)
flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
    int hsplit, int sq, int skv, int nh, int nkvh, int dh, float scale,
    int causal, int window, int q_offset) {
  using S = BwdShape<DH>;
  constexpr int BK = S::BK, BQ = S::BQ, LD = S::LD, THREADS = S::THREADS;
  constexpr int ROWG = BK / 16;      // warp row groups
  constexpr int NT = BQ / 8;         // q n-tiles of S^T and dP^T
  constexpr int DW = DH / S::SPLIT;  // dK / dV columns a warp
  constexpr int OT = DW / 8;         // their n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* vs = ks + BK * LD;                    // [BK][LD]
  T* qs = vs + BK * LD;                    // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;               // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* ds = ls + 2 * BQ;                                   // [2][BQ]

  // the kv tile on the grid's slowest axis: the first tiles, which the
  // most q tiles see under a causal mask, start first
  const int k0 = blockIdx.z * BK;
  const int kvh = blockIdx.x / hsplit, hs = blockIdx.x % hsplit;
  const int b = blockIdx.y;
  const int group = nh / nkvh;
  const int g_lo = hs * group / hsplit;  // this share's query heads
  const int g_n = (hs + 1) * group / hsplit - g_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % ROWG, wc = warp / ROWG;  // row group, column part
  const int gid = lane >> 2, tig = lane & 3;
  const int dh16 = (dh + 15) & ~15;
  const float scale_log2 = scale * LOG2E_F;
  const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout) && aligned16(dk) &&
                   aligned16(dv);

  // the q rows that see a key of this tile: q tiles outside never load
  const int k_last = min(k0 + BK, skv) - 1;
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  const int r_hi = window > 0 ? min(sq, k_last + window - q_offset) : sq;
  const int t_lo = r_lo / BQ;
  const int nqt = r_hi > r_lo ? (r_hi + BQ - 1) / BQ - t_lo : 0;
  const int nsteps = g_n * nqt;  // (query head, q tile) pairs

  const size_t q_stride = (size_t)nh * dh, kv_stride = (size_t)nkvh * dh;
  // step t's Q and dO tiles, lse and D into stage st
  auto load_step = [&](int t, int st) {
    const int h = kvh * group + g_lo + t / nqt;
    const int q0 = (t_lo + t % nqt) * BQ;
    const size_t off = (((size_t)b * sq + q0) * nh + h) * dh;
    tc_load_tile<T, BQ, DH, THREADS>(qs + st * BQ * LD, q + off, q_stride,
                                     sq - q0, dh, vec, tid);
    tc_load_tile<T, BQ, DH, THREADS>(dos + st * BQ * LD, dout + off,
                                     q_stride, sq - q0, dh, vec, tid);
    const size_t roff = ((size_t)b * nh + h) * sq + q0;
    for (int i = tid; i < 2 * BQ; i += THREADS) {
      const int r = i % BQ;
      const float* src = (i < BQ ? lse : delta) + roff;
      const bool ok = q0 + r < sq;
      cp_async_4((i < BQ ? ls : ds) + st * BQ + r, ok ? src + r : src,
                 ok ? 4 : 0);
    }
  };

  if (nsteps > 0) {
    // cp.async writes columns [0, dh); the k-steps read up to dh16
    if (vec && dh < dh16) {
      for (int idx = tid; idx < (2 * BK + 4 * BQ) * 8; idx += THREADS)
        ks[(idx >> 3) * LD + dh + (idx & 7)] = from_f<T>(0.f);
    }
    const size_t off = ((size_t)b * skv + k0) * kv_stride + (size_t)kvh * dh;
    tc_load_tile<T, BK, DH, THREADS>(ks, k + off, kv_stride, skv - k0, dh,
                                     vec, tid);
    tc_load_tile<T, BK, DH, THREADS>(vs, v + off, kv_stride, skv - k0, dh,
                                     vec, tid);
    load_step(0, 0);
    cp_async_commit();
  }

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int krow = k0 + wr * 16 + gid;  // key of this thread's row gid
  for (int t = 0; t < nsteps; ++t) {
    const int st = t & 1;
    if (t + 1 < nsteps) {
      load_step(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step t is in shared memory for every warp
    const T* qt = qs + st * BQ * LD;
    const T* dot = dos + st * BQ * LD;
    const float* lt = ls + st * BQ;
    const float* dt = ds + st * BQ;
    const int q0 = (t_lo + t % nqt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if (kk * 16 < dh16) {
        mma_abt_step<T, NT, LD>(s, ks + wr * 16 * LD, qt, kk, lane);
        mma_abt_step<T, NT, LD>(dp, vs + wr * 16 * LD, dot, kk, lane);
      }
    }

    // P^T and dS^T; masks only on tiles that cross an edge
    const int p_first = q_offset + q0;
    const int p_last = q_offset + min(q0 + BQ, sq) - 1;
    const bool edge = q0 + BQ > sq || k0 + BK > skv ||
                      (causal && k0 + BK - 1 > p_first) ||
                      (window > 0 && k0 <= p_last - window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c0 = nt * 8 + tig * 2;  // q row in the tile of e = 0
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kpos = krow + (e >> 1) * 8;
          const int qrow = q0 + c0 + (e & 1);
          const int qpos = q_offset + qrow;
          ok = kpos < skv && qrow < sq;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dv_ = (e & 1) ? d2.y : d2.x;
        const float p =
            ok ? exp2f(s[nt][e] * scale_log2 - lv * LOG2E_F) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dv_);
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warp's columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a<T, NT>(a, s, kk);
      mma_ab_step<T, OT / 2, LD>(dva, a, dot + kk * 16 * LD + wc * DW,
                                 dh16 - wc * DW, lane);
      c_to_a<T, NT>(a, dp, kk);
      mma_ab_step<T, OT / 2, LD>(dka, a, qt + kk * 16 * LD + wc * DW,
                                 dh16 - wc * DW, lane);
    }
    __syncthreads();  // stage st is free for step t + 2
  }

  const size_t off = ((size_t)b * skv + k0) * kv_stride + (size_t)kvh * dh;
  if (part != nullptr) {
    // this share's sums, dK times the score scale, in fp32
    const size_t n = (size_t)gridDim.y * skv * kv_stride;
    float* pk = part + (size_t)hs * n + off;
    float* pv = pk + (size_t)hsplit * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr * 16 + gid + r * 8;
      if (k0 + row < skv) {
#pragma unroll
        for (int i = 0; i < OT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = wc * DW + i * 8 + tig * 2 + j;
            if (col < dh) {
              pk[row * kv_stride + col] = dka[i][2 * r + j] * scale;
              pv[row * kv_stride + col] = dva[i][2 * r + j];
            }
          }
      }
    }
    return;
  }

  // dK (times the score scale) into K's place and dV into V's (every warp
  // is past its last read of them), then whole rows out; a tile no query
  // sees writes zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr * 16 + gid + r * 8;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      const int col = wc * DW + i * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(ks + row * LD + col) =
          pack2<T>(dka[i][2 * r] * scale, dka[i][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vs + row * LD + col) =
          pack2<T>(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
  __syncthreads();
  const int nrows = min(BK, skv - k0);
  tc_store_tile<T, BK, DH, THREADS>(dk + off, kv_stride, ks, nrows, dh, vec,
                                    tid);
  tc_store_tile<T, BK, DH, THREADS>(dv + off, kv_stride, vs, nrows, dh, vec,
                                    tid);
}

// dQ of one 64-row q tile of one head: every kv tile it sees.  Per kv
// tile: S = Q K^T and dP = dO V^T; P = exp(S - lse) (masked on tiles that
// cross an edge), dS = P (dP - D); dQ += dS K, dS rounded to T.  K and V
// tiles are double-buffered through cp.async, as in the forward.
template <typename T, int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int sq, int skv, int nh, int nkvh, int dh,
    float scale, int causal, int window, int q_offset) {
  using S = BwdShape<DH>;
  constexpr int BQ = TC_BQ, BK = S::DQ_BK, LD = S::LD;
  constexpr int THREADS = TC_THREADS;
  constexpr int NT = BK / 8;  // key n-tiles of S and dP
  constexpr int OT = DH / 8;  // column n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dos = qs + BQ * LD;                   // [BQ][LD]
  T* ks = dos + BQ * LD;                   // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]

  // the q tile on the grid's slowest axis, from the last: the last q tiles
  // see the most keys under a causal mask, so they start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (nh / nkvh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int dh16 = (dh + 15) & ~15;
  const float scale_log2 = scale * LOG2E_F;
  const bool vec = dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout) && aligned16(dq);

  // key range any row of this tile sees, as in the forward
  const int p_first = q_offset + q0;
  const int p_last = q_offset + min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(skv, p_last + 1) : skv;
  const int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // rows gid and gid + 8 of this warp: lse in base 2, and D
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gid + r * 8;
    const size_t i = ((size_t)b * nh + h) * sq + row;
    lrow[r] = row < sq ? lse[i] * LOG2E_F : 0.f;
    drow[r] = row < sq ? delta[i] : 0.f;
  }

  const size_t q_stride = (size_t)nh * dh, kv_stride = (size_t)nkvh * dh;
  const size_t qoff = (((size_t)b * sq + q0) * nh + h) * dh;
  const T* kbase = k + ((size_t)b * skv * nkvh + kvh) * dh;
  const T* vbase = v + ((size_t)b * skv * nkvh + kvh) * dh;
  if (ntiles > 0) {
    if (vec && dh < dh16) {
      for (int idx = tid; idx < (2 * BQ + 4 * BK) * 8; idx += THREADS)
        qs[(idx >> 3) * LD + dh + (idx & 7)] = from_f<T>(0.f);
    }
    tc_load_tile<T, BQ, DH, THREADS>(qs, q + qoff, q_stride, sq - q0, dh, vec,
                                     tid);
    tc_load_tile<T, BQ, DH, THREADS>(dos, dout + qoff, q_stride, sq - q0, dh,
                                     vec, tid);
    tc_load_tile<T, BK, DH, THREADS>(ks, kbase + (size_t)k_lo * kv_stride,
                                     kv_stride, skv - k_lo, dh, vec, tid);
    tc_load_tile<T, BK, DH, THREADS>(vs, vbase + (size_t)k_lo * kv_stride,
                                     kv_stride, skv - k_lo, dh, vec, tid);
    cp_async_commit();
  }

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int row0 = q_offset + q0 + warp * 16 + gid;  // position of row gid
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * BK;
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = k0 + BK;
      tc_load_tile<T, BK, DH, THREADS>(ks + (st ^ 1) * BK * LD,
                                       kbase + (size_t)k1 * kv_stride,
                                       kv_stride, skv - k1, dh, vec, tid);
      tc_load_tile<T, BK, DH, THREADS>(vs + (st ^ 1) * BK * LD,
                                       vbase + (size_t)k1 * kv_stride,
                                       kv_stride, skv - k1, dh, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every warp
    const T* kt = ks + st * BK * LD;
    const T* vt = vs + st * BK * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      if (kk * 16 < dh16) {
        mma_abt_step<T, NT, LD>(s, qs + warp * 16 * LD, kt, kk, lane);
        mma_abt_step<T, NT, LD>(dp, dos + warp * 16 * LD, vt, kk, lane);
      }
    }

    // P and dS; masks only on tiles that cross an edge
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > p_first) ||
                      (window > 0 && k0 <= p_last - window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kpos = k0 + nt * 8 + tig * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          ok = kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        const float p =
            ok ? exp2f(s[nt][e] * scale_log2 - lrow[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - drow[e >> 1]);
      }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a<T, NT>(a, dp, kk);
      mma_ab_step<T, DH / 16, LD>(acc, a, kt + kk * 16 * LD, dh16, lane);
    }
    __syncthreads();  // stage st is free for tile t + 2
  }

  // dQ (times the score scale) into Q's place, then whole rows out; rows
  // that see no key write zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gid + r * 8;
#pragma unroll
    for (int i = 0; i < OT; ++i)
      *reinterpret_cast<uint32_t*>(qs + row * LD + i * 8 + tig * 2) =
          pack2<T>(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
  __syncthreads();
  tc_store_tile<T, BQ, DH, THREADS>(dq + qoff, q_stride, qs,
                                    min(BQ, sq - q0), dh, vec, tid);
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, float* part,
               void* dq, void* dk, void* dv, int b, int sq, int skv, int nh,
               int nkvh, int dh, float scale, int causal, int window,
               int q_offset, int hsplit, cudaStream_t stream) {
  using S = BwdShape<DH>;
  const int rows = b * sq * nh;
  const int vec = dh % 8 == 0 && aligned16_host(o) && aligned16_host(dout);
  int lpr = 1;  // lanes a row: one a 16-byte chunk (or element), at most 32
  while (lpr < 32 && lpr * (vec ? 8 : 1) < dh) lpr *= 2;
  const int rows_per_block = PREP_THREADS / lpr;
  flash_attention_bwd_prep_kernel<T>
      <<<(rows + rows_per_block - 1) / rows_per_block, PREP_THREADS, 0,
         stream>>>((const T*)o, (const T*)dout, delta, rows, sq, nh, dh,
                   lpr, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t kv_smem = dkdv_smem_bytes<T, DH>();
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, DH>;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(nkvh * hsplit, b, (skv + S::BK - 1) / S::BK), S::THREADS,
         kv_smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                            (const T*)dout, lse, delta, (T*)dk, (T*)dv,
                            hsplit > 1 ? part : nullptr, hsplit, sq, skv, nh,
                            nkvh, dh, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (hsplit > 1) {
    const size_t n = (size_t)b * skv * nkvh * dh;
    const size_t blocks = min((2 * n + PREP_THREADS - 1) / PREP_THREADS,
                              (size_t)65536);
    flash_attention_bwd_dkv_sum_kernel<T>
        <<<(unsigned)blocks, PREP_THREADS, 0, stream>>>(part, (T*)dk,
                                                        (T*)dv, n, hsplit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const size_t q_smem = dq_smem_bytes<T, DH>();
  auto dqk = flash_attention_bwd_dq_kernel<T, DH>;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(nh, b, (sq + TC_BQ - 1) / TC_BQ), TC_THREADS, q_smem,
        stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
                  delta, (T*)dq, sq, skv, nh, nkvh, dh, scale, causal,
                  window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta,
                 float* part, void* dq, void* dk, void* dv, int b, int sq,
                 int skv, int nh, int nkvh, int dh, float scale, int causal,
                 int window, int q_offset, int hsplit, cudaStream_t s) {
  switch (dh_bound(dh)) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, part, dq, dk,
                               dv, b, sq, skv, nh, nkvh, dh, scale, causal,
                               window, q_offset, hsplit, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, part, dq, dk,
                                dv, b, sq, skv, nh, nkvh, dh, scale, causal,
                                window, q_offset, hsplit, s);
    case 256:
      return launch_bwd<T, 256>(q, k, v, o, dout, lse, delta, part, dq, dk,
                                dv, b, sq, skv, nh, nkvh, dh, scale, causal,
                                window, q_offset, hsplit, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out[0..1] of the prep kernel, out[2..3] of dK/dV, out[4..5] of dQ,
// out[6..7] of the partial sums' kernel
template <typename T, int DH>
int bwd_attrs_of(int* out) {
  int err = kernel_attrs((const void*)flash_attention_bwd_prep_kernel<T>,
                         out);
  if (err) return err;
  err = kernel_attrs((const void*)flash_attention_bwd_dkv_sum_kernel<T>,
                     out + 6);
  if (err) return err;
  err = kernel_attrs((const void*)flash_attention_bwd_dkdv_kernel<T, DH>,
                     out + 2);
  if (err) return err;
  return kernel_attrs((const void*)flash_attention_bwd_dq_kernel<T, DH>,
                      out + 4);
}

template <typename T>
int bwd_attrs(int dh, int* out) {
  switch (dh_bound(dh)) {
    case 64: return bwd_attrs_of<T, 64>(out);
    case 128: return bwd_attrs_of<T, 128>(out);
    case 256: return bwd_attrs_of<T, 256>(out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 and f16 take the tensor-core kernel, fp32 the CUDA-core kernel; a
// refused launch of either returns its error (no fallback between them).
// `lse` (fp32 (B, H, Sq), or null) receives each row's log-sum-exp of its
// scaled scores, -inf for a row that sees no key: the backward's input.
// Only the tensor-core kernel writes it.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int b, int sq, int skv, int nh,
                                     int nkvh, int dh, float scale,
                                     int causal, int window, int q_offset,
                                     int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      if (lse) return (int)cudaErrorInvalidValue;
      return dispatch_f32(q, k, v, o, b, sq, skv, nh, nkvh, dh, scale, causal,
                          window, q_offset, s);
    case kBF16:
      return dispatch_tc<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, nh, nkvh,
                                        dh, scale, causal, window, q_offset,
                                        s);
    case kF16:
      return dispatch_tc<__half>(q, k, v, o, lse, b, sq, skv, nh, nkvh, dh,
                                 scale, causal, window, q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of a bf16/f16 call of `repro_flash_attention` from its
// inputs, its output `o`, the output's cotangent `dout` (contiguous, as o)
// and its `lse`: dq, dk, dv in the inputs' layouts and dtype.  `delta` is
// fp32 (B, H, Sq) scratch.  `hsplit` CTAs share each kv tile's query heads
// (1: one CTA takes the whole group); above 1 `part` is fp32 scratch of
// 2 x hsplit x the size of dk.  In order on `stream`, each launch checked:
// the prep kernel, dK/dV, (above 1) the partial sums' kernel, dQ.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* part, void* dq,
    void* dk, void* dv, int b, int sq, int skv, int nh, int nkvh, int dh,
    float scale, int causal, int window, int q_offset, int hsplit, int dtype,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hsplit < 1 || hsplit > nh / nkvh || (hsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kBF16:
      return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, part,
                                         dq, dk, dv, b, sq, skv, nh, nkvh, dh,
                                         scale, causal, window, q_offset,
                                         hsplit, s);
    case kF16:
      return dispatch_bwd<__half>(q, k, v, o, dout, lse, delta, part, dq, dk,
                                  dv, b, sq, skv, nh, nkvh, dh, scale, causal,
                                  window, q_offset, hsplit, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Of the kernel that `repro_flash_attention` launches for this dtype and
// head dim: registers a thread (out[0]) and local-memory bytes a thread,
// i.e. spills (out[1]); for bf16/f16 also of its instance that writes lse
// (out[2], out[3]).
extern "C" int repro_flash_attention_attrs(int dtype, int dh, int* out) {
  switch (dtype) {
    case kF32: return f32_attrs(dh, out);
    case kBF16: return tc_attrs<__nv_bfloat16>(dh, out);
    case kF16: return tc_attrs<__half>(dh, out);
  }
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory a thread of the backward's kernels for this
// dtype and head dim: prep (out[0], out[1]), dK/dV (out[2], out[3]), dQ
// (out[4], out[5]), the partial sums' (out[6], out[7]).
extern "C" int repro_flash_attention_bwd_attrs(int dtype, int dh, int* out) {
  switch (dtype) {
    case kBF16: return bwd_attrs<__nv_bfloat16>(dh, out);
    case kF16: return bwd_attrs<__half>(dh, out);
  }
  return (int)cudaErrorInvalidValue;
}
