// Inline-PTX helpers of the port's Hopper kernels: 16-byte asynchronous
// copies (cp.async), tensor-core fragment loads (ldmatrix) and the warp-level
// bf16/f16 product mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig):
//   A (16x16, row-major), 4 regs of two 16-bit values each:
//     a0 (row gid,   cols 2*tig, 2*tig+1)   a1 (row gid+8, same cols)
//     a2 (row gid,   cols 2*tig+8, +9)       a3 (row gid+8, cols 2*tig+8, +9)
//   B (16x8, k x n), 2 regs: b0 (k 2*tig, 2*tig+1; n gid), b1 (k +8, +9)
//   C (16x8 fp32), 4 floats: c0, c1 (row gid, cols 2*tig, 2*tig+1),
//     c2, c3 (row gid+8, same cols)
// The lower-indexed value of a pair sits in the lower 16 bits.
#pragma once

#include <cstdint>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The same on the host, where a launch picks its loads.
inline bool aligned16_host(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Copy 16 bytes from global to shared memory, bypassing L1.  The first
// src_bytes (0 or 16) are read; the rest of the 16 are zero-filled, so a
// row past the end of a tensor is written as zeros without being read.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

// The same for one 4-byte word (src_bytes 0 or 4), through L1: an fp32
// value with no 16-byte alignment to rely on.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (Hopper): a kernel launched after this one
// with cudaLaunchAttributeProgrammaticStreamSerialization may be scheduled
// once every CTA of this grid has called grid_launch_dependents(); it must
// call grid_dependency_wait() before it reads what this grid writes (the
// wait returns when this grid has completed and its writes are visible).
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Four 8x8 matrices of 16-bit values; lanes 8i..8i+7 give the row addresses
// of matrix i, and register i receives matrix i in the A/B/C layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

// The same, each matrix transposed on the way (a row-major k x n tile in
// shared memory becomes B fragments).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

// c += a * b on the tensor cores, fp32 accumulators.  Registers only, so not
// volatile: the compiler may move it past the fragment loads that follow.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded (to nearest even) into one register of T pairs,
// lo in the lower 16 bits (cvt packs its first source into the upper half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
