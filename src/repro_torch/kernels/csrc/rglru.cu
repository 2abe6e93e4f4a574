// RG-LRU linear recurrence for Hopper (sm_90a): the forward scan and, run
// from the end of the sequence, its backward; both are sequence-split scans.
//
// Replaces: src/repro/kernels/rglru/kernel.py, `_rglru_kernel` /
// `rglru_pallas` (a (B, D/128) Pallas grid whose cells each walk the whole
// sequence with a fori_loop, h carried in vector registers, S chunked by
// the wrapper so three (S, 128) fp32 tiles fit VMEM).  No Pallas kernel has
// a backward: the reference differentiates its associative scan
// (src/repro/kernels/rglru/ops.py:47) with XLA on the device, and the
// backward kernel here is that gradient on the card.
//
// Semantics, as the plain versions (kernels/rglru/ref.py), all fp32:
//   forward   h_t = a_t * h_{t-1} + x_t, a_t = exp(log_a_t), h_{-1} = h0
//             (zeros when null); x, log_a, h: (B, S, D); h0: (B, D);
//   backward  g_t = dy_t + a_{t+1} * g_{t+1} from g_{S-1} = dy_{S-1};
//             dx_t = g_t, dlog_a_t = g_t * a_t * h_{t-1}, dh0 = a_0 * g_0.
//
// Bound: device-memory bytes.  The forward reads x and log_a and writes h,
// 12 B an element; the backward reads dy, log_a and h and writes dx and
// dlog_a, 20 B; a few operations an element.  At (1, 1024, 2560) that is
// 31.5 MB, 9.4 us, and 52.4 MB, 15.7 us, at 3.35 TB/s.
//
// The first version gave one thread to each (b, d) channel and walked all S
// steps in it: at B=1, D=2560 that was 10 CTAs on 132 SMs, each thread 1024
// dependent steps, at 0.08-0.09 of the bound.  This design:
//   * splits S inside a CTA: a CTA takes 32 channels (one a lane, so every
//     row it reads or writes is one 128-byte line) and a tile of
//     warps * steps rows, staged in shared memory with cp.async (a row
//     outside the sequence is zero-filled: x = 0, log_a = 0 make a step
//     the identity).  Warp w takes `steps` consecutive rows of the tile (a
//     sub-chunk).  Pass 1 scans each sub-chunk from a zero state, keeping
//     its end state H and the product P of its a; warp 0 composes the
//     (P, H) pairs into each sub-chunk's carry; pass 2 scans each
//     sub-chunk again from its true carry, out of shared memory, and
//     writes the outputs.  Device memory is read once and written once;
//   * splits S across the CTAs of a thread-block cluster (at most 8): each
//     CTA takes its own tile of the same channels, and the CTAs exchange
//     their tile aggregates (P, H) through distributed shared memory after
//     a cluster barrier.  At (1, 1024, 2560): 80 channel tiles x a cluster
//     of 8 = 640 CTAs, where the first version launched 10;
//   * walks a sequence longer than the cluster's tiles in rounds: every CTA
//     composes all of the cluster's aggregates, so each holds the state
//     carried into the next round itself, and the next round's tile loads
//     into a second buffer while this round's is scanned;
//   * runs the backward as the same scan from the end of the sequence:
//     tile q in scan order holds rows [S - (q+1)T, S - qT), its sub-chunks
//     are walked last to first, a_{t+1} is read one row ahead, and the
//     epilogue writes dx, dlog_a (and dh0) from pass 2's registers.
//   * keeps the first version's walk for a forward whose split would take
//     a cluster of 1: one thread a channel walks S from device memory,
//     UNROLL steps of loads in flight.  Below 32 rows (the serve decode
//     step) the split's staging and barriers only add latency: a decode
//     step took 0.0055 ms split against the walk's 0.0022-0.0026 ms.
//     Where the channel tiles alone fill the grid (serve prefill, B=8)
//     the split gained nothing: 0.0128-0.0129 ms against the walk's
//     0.0112-0.0128 (H100 80GB HBM3, 700 W; tools/rglru_bench.py).  The
//     backward has no walk: only training runs it, and a short sequence
//     splits into one sub-chunk.
// ops.rglru_plan picks the variant, cluster, warps and steps from (B, S, D)
// and the SM count.  Each call is one C function and one launch.
//
// Numerics.  Inside a sub-chunk both passes multiply and add as the plain
// versions do, in their order and with their rounding (a = expf(log_a);
// __fmul_rn and __fadd_rn, so nothing is contracted into an FMA): with the
// same carry in, a sub-chunk's outputs are the plain version's bit for bit,
// and the first sub-chunk in scan order has the plain version's carry (the
// walk is the plain version's arithmetic throughout).
// Carries are composed from the same a: P = the product of a sub-chunk's a
// in scan order, then carry' = P * carry + H over the sub-chunks in scan
// order, then over the cluster's CTAs in rank order, from the state the
// previous round carried.  Only those composed carries round differently
// from the plain sequential walk.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CH = 32;           // channels a CTA: one a lane
constexpr int MAX_WARPS = 8;     // sub-chunks a CTA
constexpr int MAX_STEPS = 16;    // rows a sub-chunk
constexpr int MAX_CLUSTER = 8;   // CTAs a cluster (the portable limit)
constexpr int WALK_THREADS = 256;  // the walk: threads (channels) a CTA
constexpr int UNROLL = 8;          // the walk: steps of loads in flight
enum Variant : int { kWalk = 0, kSplit = 1 };   // ops.VARIANTS

// Shared memory of a CTA, in floats: the staged tiles (two buffers when
// the sequence takes more than one round), then each warp's (P, H) and
// carry, then the CTA's (P, H) a round parity, which the cluster reads.
struct Layout {
  int tile;   // floats of one staged tile
  int nbuf;
  __host__ __device__ constexpr Layout(int chunk, int rounds, bool bwd)
      : tile((bwd ? 3 * chunk + 1 : 2 * chunk) * CH),
        nbuf(rounds > 1 ? 2 : 1) {}
  __host__ __device__ constexpr size_t floats(int warps) const {
    return (size_t)nbuf * tile + 3 * (size_t)warps * CH + 4 * CH;
  }
};
// The largest plan (the backward's, two buffers) fits an H100 CTA's 227 KiB.
static_assert(Layout(MAX_WARPS * MAX_STEPS, 2, true).floats(MAX_WARPS) *
                      sizeof(float) <= 227 * 1024,
              "shared memory of the largest plan");

// Stage rows r0 .. r0 + rows - 1 of 32 channels from c0 of one batch's
// (S, D) rows into dst ([rows][32]).  A row outside [0, s), or a channel at
// or past d, is zero-filled, except row -1, which comes from row_m1 when
// that is not null (h0, as the backward's h_{-1}).  vec: 16-byte copies (d a
// multiple of 4, every pointer 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const float* row_m1, int r0,
                                           int rows, int s, int d, int c0,
                                           bool vec) {
  const int width = vec ? 4 : 1, per_row = CH / width;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, q = (i - r * per_row) * width;
    const int row = r0 + r, c = c0 + q;
    const float* g = src;   // not read when nothing is copied
    int n = 0;
    if (c < d) {
      if (row >= 0 && row < s) {
        g = src + (size_t)row * d + c;
        n = 4 * width;
      } else if (row == -1 && row_m1 != nullptr) {
        g = row_m1 + c;
        n = 4 * width;
      }
    }
    if (vec)
      cp_async_16(dst + r * CH + q, g, n);
    else
      cp_async_4(dst + r * CH + q, g, n);
  }
}

// Warp 0 composes this CTA's sub-chunk aggregates (aggP, aggH) in scan
// order (rev: last warp first) into the CTA's aggregate and publishes it in
// `cta`'s slot for this round's parity.  After a cluster barrier it
// composes every CTA's aggregate in rank order from `carry` (the state
// carried into the round, held by warp 0's lanes): the state reaching this
// CTA's rank is its carry in, and the state after the last rank is carried
// into the next round (left in `carry`).  Each warp's carry in goes to
// carry_w.  Every thread of the CTA calls this (it holds the barriers).
__device__ __forceinline__ void exchange(cg::cluster_group& cluster,
                                         const float* aggP,
                                         const float* aggH, float* cta,
                                         float* carry_w, int warps, bool rev,
                                         int parity, float& carry) {
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x < 32;
  float* mine = cta + parity * 2 * CH;   // [P of 32 lanes][H of 32 lanes]
  if (lead) {
    float p = 1.f, h = 0.f;
    for (int i = 0; i < warps; ++i) {
      const int j = rev ? warps - 1 - i : i;
      const float pj = aggP[j * CH + lane];
      h = __fadd_rn(__fmul_rn(pj, h), aggH[j * CH + lane]);
      p = __fmul_rn(p, pj);
    }
    mine[lane] = p;
    mine[CH + lane] = h;
  }
  cluster.sync();
  if (lead) {
    const int rank = (int)cluster.block_rank();
    const int n = (int)cluster.num_blocks();
    float c = carry, cin = carry;
    for (int k = 0; k < n; ++k) {
      if (k == rank) cin = c;
      const float* other = cluster.map_shared_rank(mine, k);
      c = __fadd_rn(__fmul_rn(other[lane], c), other[CH + lane]);
    }
    carry = c;
    for (int i = 0; i < warps; ++i) {
      const int j = rev ? warps - 1 - i : i;
      carry_w[j * CH + lane] = cin;
      cin = __fadd_rn(__fmul_rn(aggP[j * CH + lane], cin),
                      aggH[j * CH + lane]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
rglru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                 const float* __restrict__ h0, float* __restrict__ out, int s,
                 int d, int steps, int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = warps * steps, span = ncl * chunk;
  const int rounds = (s + span - 1) / span;
  const Layout lay(chunk, rounds, false);
  float* aggP = smem + lay.nbuf * lay.tile;
  float* aggH = aggP + warps * CH;
  float* carry_w = aggH + warps * CH;
  float* cta = carry_w + warps * CH;
  const int b = blockIdx.z, c0 = blockIdx.y * CH, c = c0 + lane;
  const size_t base = (size_t)b * s * d;
  const float* xb = x + base;
  const float* ab = log_a + base;
  float* ob = out + base;
  float carry = (h0 != nullptr && c < d) ? h0[(size_t)b * d + c] : 0.f;

  auto stage = [&](int round) {
    float* t = smem + (round % lay.nbuf) * lay.tile;
    const int r0 = (round * ncl + rank) * chunk;
    stage_rows(t, xb, nullptr, r0, chunk, s, d, c0, vec);
    stage_rows(t + chunk * CH, ab, nullptr, r0, chunk, s, d, c0, vec);
    cp_async_commit();
  };
  stage(0);
  for (int round = 0; round < rounds; ++round) {
    if (round + 1 < rounds) {
      stage(round + 1);   // into the buffer the last round read
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tx = smem + (round % lay.nbuf) * lay.tile;
    float* ta = smem + (round % lay.nbuf) * lay.tile + chunk * CH;
    const int k0 = w * steps;
    // pass 1: this sub-chunk from a zero state; a replaces log_a in place
    float p = 1.f, hl = 0.f;
#pragma unroll 4
    for (int k = k0; k < k0 + steps; ++k) {
      const float a = expf(ta[k * CH + lane]);
      ta[k * CH + lane] = a;
      hl = __fadd_rn(__fmul_rn(a, hl), tx[k * CH + lane]);
      p = __fmul_rn(p, a);
    }
    aggP[w * CH + lane] = p;
    aggH[w * CH + lane] = hl;
    __syncthreads();
    exchange(cluster, aggP, aggH, cta, carry_w, warps, false, round & 1,
             carry);
    // pass 2: again from the true carry, writing h
    float h = carry_w[w * CH + lane];
    const int row0 = (round * ncl + rank) * chunk;
#pragma unroll 4
    for (int k = k0; k < k0 + steps; ++k) {
      h = __fadd_rn(__fmul_rn(ta[k * CH + lane], h), tx[k * CH + lane]);
      const int row = row0 + k;
      if (row < s && c < d) ob[(size_t)row * d + c] = h;
    }
    __syncthreads();   // the next round's load refills this buffer
  }
  cluster.sync();   // no CTA leaves while another may read its aggregates
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
rglru_bwd_kernel(const float* __restrict__ dy,
                 const float* __restrict__ log_a,
                 const float* __restrict__ h, const float* __restrict__ h0,
                 float* __restrict__ dx, float* __restrict__ dlog_a,
                 float* __restrict__ dh0, int s, int d, int steps, int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = warps * steps, span = ncl * chunk;
  const int rounds = (s + span - 1) / span;
  const Layout lay(chunk, rounds, true);
  float* aggP = smem + lay.nbuf * lay.tile;
  float* aggH = aggP + warps * CH;
  float* carry_w = aggH + warps * CH;
  float* cta = carry_w + warps * CH;
  const int b = blockIdx.z, c0 = blockIdx.y * CH, c = c0 + lane;
  const size_t base = (size_t)b * s * d;
  const float* dyb = dy + base;
  const float* ab = log_a + base;
  const float* hb = h + base;
  const float* h0b = h0 != nullptr ? h0 + (size_t)b * d : nullptr;
  float* dxb = dx + base;
  float* dab = dlog_a + base;
  float carry = 0.f;   // g past the end of the sequence

  // the tile's rows, first to last: dy_t, then log_a_t one row further
  // (a_{t+1} of its last row), then h_{t-1}
  auto first_row = [&](int round) {
    return s - (round * ncl + rank + 1) * chunk;
  };
  auto stage = [&](int round) {
    float* t = smem + (round % lay.nbuf) * lay.tile;
    const int t0 = first_row(round);
    stage_rows(t, dyb, nullptr, t0, chunk, s, d, c0, vec);
    stage_rows(t + chunk * CH, ab, nullptr, t0, chunk + 1, s, d, c0, vec);
    stage_rows(t + (2 * chunk + 1) * CH, hb, h0b, t0 - 1, chunk, s, d, c0,
               vec);
    cp_async_commit();
  };
  stage(0);
  for (int round = 0; round < rounds; ++round) {
    if (round + 1 < rounds) {
      stage(round + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tdy = smem + (round % lay.nbuf) * lay.tile;
    float* ta = smem + (round % lay.nbuf) * lay.tile + chunk * CH;
    const float* thp = ta + (chunk + 1) * CH;
    // a replaces log_a in place: a sub-chunk reads one row of the next
    for (int i = threadIdx.x; i < (chunk + 1) * CH; i += blockDim.x)
      ta[i] = expf(ta[i]);
    __syncthreads();
    const int k0 = w * steps;
    // pass 1: this sub-chunk, last row first, from a zero state
    float p = 1.f, gl = 0.f;
#pragma unroll 4
    for (int k = k0 + steps - 1; k >= k0; --k) {
      const float an = ta[(k + 1) * CH + lane];
      gl = __fadd_rn(tdy[k * CH + lane], __fmul_rn(an, gl));
      p = __fmul_rn(p, an);
    }
    aggP[w * CH + lane] = p;
    aggH[w * CH + lane] = gl;
    __syncthreads();
    exchange(cluster, aggP, aggH, cta, carry_w, warps, true, round & 1,
             carry);
    // pass 2: again from the true carry, writing dx, dlog_a and dh0
    float g = carry_w[w * CH + lane];
    const int t0 = first_row(round);
#pragma unroll 4
    for (int k = k0 + steps - 1; k >= k0; --k) {
      const float a = ta[k * CH + lane];
      g = __fadd_rn(tdy[k * CH + lane], __fmul_rn(ta[(k + 1) * CH + lane], g));
      const int row = t0 + k;
      if (row >= 0 && c < d) {
        const size_t off = (size_t)row * d + c;
        dxb[off] = g;
        dab[off] = __fmul_rn(__fmul_rn(g, a), thp[k * CH + lane]);
        if (row == 0 && dh0 != nullptr) dh0[(size_t)b * d + c] = __fmul_rn(a, g);
      }
    }
    __syncthreads();
  }
  cluster.sync();
}

// The walk: one thread a (b, d) channel, t from 0 to S-1, UNROLL steps of
// x and log_a loaded before their recurrence runs, then the rest one by one.
__global__ void __launch_bounds__(WALK_THREADS)
rglru_fwd_walk_kernel(const float* __restrict__ x,
                      const float* __restrict__ log_a,
                      const float* __restrict__ h0, float* __restrict__ out,
                      int s, int d) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (c >= d) return;
  const size_t base = (size_t)b * s * d + c;
  float h = h0 != nullptr ? h0[(size_t)b * d + c] : 0.f;
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
      h = __fadd_rn(__fmul_rn(expf(av[u]), h), xv[u]);
      out[base + (size_t)(t + u) * d] = h;
    }
  }
  for (; t < s; ++t) {
    const size_t off = base + (size_t)t * d;
    h = __fadd_rn(__fmul_rn(expf(log_a[off]), h), x[off]);
    out[off] = h;
  }
}

// Dynamic shared memory of a split launch, in bytes.
size_t smem_bytes(int s, bool bwd, int cluster, int warps, int steps) {
  const int chunk = warps * steps;
  const int rounds = (s + cluster * chunk - 1) / (cluster * chunk);
  return Layout(chunk, rounds, bwd).floats(warps) * sizeof(float);
}

bool bad_plan(int b, int s, int d, int cluster, int warps, int steps) {
  return b <= 0 || s <= 0 || d <= 0 || b > 65535 ||
         (d + CH - 1) / CH > 65535 || cluster < 1 || cluster > MAX_CLUSTER ||
         warps < 1 || warps > MAX_WARPS || steps < 1 || steps > MAX_STEPS;
}

// Checks a plan and fills the launch of `kern` (grid: cluster x channel
// tiles x batch, clusters along x); returns 0 or a cudaError_t.
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
              const void* kern, bool bwd, int b, int s, int d, int cluster,
              int warps, int steps, cudaStream_t stream) {
  if (bad_plan(b, s, d, cluster, warps, steps))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, bwd, cluster, warps, steps);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cfg = {};
  cfg.gridDim = dim3(cluster, (d + CH - 1) / CH, b);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

// Checks the walk's launch: grid (channel blocks, batch).
int walk_grid(dim3& grid, int b, int s, int d) {
  if (b <= 0 || s <= 0 || d <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  grid = dim3((d + WALK_THREADS - 1) / WALK_THREADS, b);
  return 0;
}

}  // namespace

extern "C" int repro_rglru(const void* x, const void* log_a, const void* h0,
                           void* out, int b, int s, int d, int variant,
                           int cluster, int warps, int steps, void* stream) {
  if (variant == kWalk) {
    dim3 grid;
    const int err = walk_grid(grid, b, s, d);
    if (err != 0) return err;
    rglru_fwd_walk_kernel<<<grid, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)log_a, (const float*)h0, (float*)out,
        s, d);
    return (int)cudaGetLastError();
  }
  if (variant != kSplit) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err =
      configure(cfg, attr, (const void*)rglru_fwd_kernel, false, b, s, d,
                cluster, warps, steps, (cudaStream_t)stream);
  if (err != 0) return err;
  const int vec = d % 4 == 0 && aligned16_host(x) && aligned16_host(log_a) &&
                  aligned16_host(h0) && aligned16_host(out);
  return (int)cudaLaunchKernelEx(&cfg, rglru_fwd_kernel, (const float*)x,
                                 (const float*)log_a, (const float*)h0,
                                 (float*)out, s, d, steps, vec);
}

extern "C" int repro_rglru_bwd(const void* dy, const void* log_a,
                               const void* h, const void* h0, void* dx,
                               void* dlog_a, void* dh0, int b, int s, int d,
                               int cluster, int warps, int steps,
                               void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err =
      configure(cfg, attr, (const void*)rglru_bwd_kernel, true, b, s, d,
                cluster, warps, steps, (cudaStream_t)stream);
  if (err != 0) return err;
  const int vec = d % 4 == 0 && aligned16_host(dy) &&
                  aligned16_host(log_a) && aligned16_host(h) &&
                  aligned16_host(h0) && aligned16_host(dx) &&
                  aligned16_host(dlog_a);
  return (int)cudaLaunchKernelEx(
      &cfg, rglru_bwd_kernel, (const float*)dy, (const float*)log_a,
      (const float*)h, (const float*)h0, (float*)dx, (float*)dlog_a,
      (float*)dh0, s, d, steps, vec);
}

// Dynamic shared memory (bytes) of a split plan's forward (out[0]) and
// backward (out[1]) over a sequence of s rows: what configure sets.
extern "C" int repro_rglru_smem(int s, int cluster, int warps, int steps,
                                int* out) {
  if (bad_plan(1, s, 1, cluster, warps, steps))
    return (int)cudaErrorInvalidValue;
  out[0] = (int)smem_bytes(s, false, cluster, warps, steps);
  out[1] = (int)smem_bytes(s, true, cluster, warps, steps);
  return 0;
}

// Registers and local-memory bytes a thread of the forward walk (out[0],
// out[1]), the forward split (out[2], out[3]) and the backward (out[4],
// out[5]).
extern "C" int repro_rglru_attrs(int* out) {
  int err = kernel_attrs((const void*)rglru_fwd_walk_kernel, out);
  if (err == 0) err = kernel_attrs((const void*)rglru_fwd_kernel, out + 2);
  if (err == 0) err = kernel_attrs((const void*)rglru_bwd_kernel, out + 4);
  return err;
}
