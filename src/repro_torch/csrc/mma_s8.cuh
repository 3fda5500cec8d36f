// Shared device helpers for the int8 tensor-core kernels (sm_90a): the
// mma.sync fragment layout (two_stage_attention.cu, fused_rows.cuh), a 4x4
// byte transpose, and the cp.async copies that feed shared memory
// (fused_rows.cuh, quant_matmul.cu).
//
// mma.sync m16n8k32 s8 x s8 -> s32 fragment layout (PTX ISA, "Matrix
// fragments for mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   A (16x32, row-major, 4 regs of 4 s8):
//     a0: row g,   k 4t..4t+3     a1: row g+8, k 4t..4t+3
//     a2: row g,   k 16+4t..      a3: row g+8, k 16+4t..
//   B (32x8, "col": k contiguous for one n, 2 regs of 4 s8):
//     b0: n g, k 4t..4t+3         b1: n g, k 16+4t..16+4t+3
//   C/D (16x8 s32, 4 regs):
//     c0,c1: row g, n 2t, 2t+1    c2,c3: row g+8, n 2t, 2t+1
// Byte 0 of a register holds the lowest k index.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vq {

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: w[r] holds bytes (r, c=0..3); on return w[c] holds
// bytes (r=0..3, c).  Used to turn a row-major [k][n] int8 tile into the
// k-contiguous [n][k] layout the B fragment wants.
__device__ __forceinline__ void transpose4x4_bytes(uint32_t (&w)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the first `bytes` read and the rest zero
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace vq
