// Shared device helpers for the int8 tensor-core kernels (sm_90a): the
// mma.sync fragment layout, and the staging of int8 / packed-int4 tiles
// into shared memory that quant_matmul.cu and fused_rows.cuh share.
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

// ---------------------------------------------------------------------------
// Staging one K step of an int8 matmul tile: BM rows of A (int8, row stride
// K) and 128 columns of W into shared memory, by 256 threads, as
// As[m][k] and Bs[n][k] with a row stride of TILE_LDS bytes (conflict-free
// fragment reads).  One step covers 64 original K indices.
//
// W is int8 [K, N], or packed uint8 [K/2, N] whose packed row p holds
// K-row p in its low nibble and K-row K/2 + p in its high nibble (the
// reference's interleave-free layout): a step takes 32 packed rows and
// pairs them with the two contiguous activation column ranges [p0, p0+32)
// and [K/2 + p0, K/2 + p0 + 32).  Nibbles are sign-extended per byte
// (__vsub4, no cross-byte borrow) while staging: Hopper's tensor cores have
// no s4 type.  W arrives N-contiguous and the B fragment wants K-contiguous,
// so 4x4-byte blocks are loaded coalesced along N and transposed in
// registers.  Rows >= `rows`, K past its end and columns >= N load as zero.
// Requires K % 16 == 0 (W8) or K % 32 == 0 (W4) and N % 4 == 0.
// ---------------------------------------------------------------------------

constexpr int TILE_THREADS = 256;
constexpr int TILE_BN = 128;
constexpr int TILE_BK = 64;
constexpr int TILE_LDS = TILE_BK + 16;

template <bool PACKED, int BM>
struct TileStage {
  int4 a[BM / 64];             // 16-byte activation chunks
  uint32_t b[PACKED ? 4 : 8];  // weight words (4 per 4x4 unit)
};

// A is read with plain loads, never the read-only path: the fused kernels
// stage block-private scratch written earlier in the same launch.
template <bool PACKED, int BM>
__device__ __forceinline__ void load_tile(TileStage<PACKED, BM>& st, const int8_t* A, int rows,
                                          int K, const uint8_t* __restrict__ w, int N, int n0,
                                          int step, int tid) {
#pragma unroll
  for (int i = 0; i < BM / 64; ++i) {
    const int c = tid + i * TILE_THREADS;
    const int row = c >> 2, kc = c & 3;
    int col;
    bool ok = row < rows;
    if (PACKED) {
      const int p = step * 32 + (kc & 1) * 16;
      col = (kc < 2 ? 0 : K / 2) + p;
      ok = ok && p < K / 2;
    } else {
      col = step * TILE_BK + kc * 16;
      ok = ok && col < K;
    }
    st.a[i] = ok ? *reinterpret_cast<const int4*>(A + (size_t)row * K + col) : make_int4(0, 0, 0, 0);
  }
  const int units = PACKED ? 1 : 2;  // (32 or 64 rows / 4) x (128 / 4) units / 256 threads
#pragma unroll
  for (int un = 0; un < units; ++un) {
    const int id = tid + un * TILE_THREADS;
    const int nq = id & 31, kq = id >> 5;
    const int n = n0 + 4 * nq;
    const int kmax = PACKED ? K / 2 : K;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = (PACKED ? step * 32 : step * TILE_BK) + 4 * kq + r;
      st.b[un * 4 + r] = (k < kmax && n < N)
                             ? *reinterpret_cast<const uint32_t*>(w + (size_t)k * N + n)
                             : 0u;
    }
  }
}

template <bool PACKED, int BM>
__device__ __forceinline__ void store_tile(const TileStage<PACKED, BM>& st, int8_t* As,
                                           int8_t* Bs, int tid) {
#pragma unroll
  for (int i = 0; i < BM / 64; ++i) {
    const int c = tid + i * TILE_THREADS;
    const int row = c >> 2, kc = c & 3;
    *reinterpret_cast<int4*>(As + row * TILE_LDS + kc * 16) = st.a[i];
  }
  const int units = PACKED ? 1 : 2;
#pragma unroll
  for (int un = 0; un < units; ++un) {
    const int id = tid + un * TILE_THREADS;
    const int nq = id & 31, kq = id >> 5;
    uint32_t w[4] = {st.b[un * 4], st.b[un * 4 + 1], st.b[un * 4 + 2], st.b[un * 4 + 3]};
    transpose4x4_bytes(w);  // w[j] = 4 consecutive K rows of column 4nq+j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int8_t* dst = Bs + (4 * nq + j) * TILE_LDS;
      if (PACKED) {
        // low nibble -> local k 4kq..4kq+3, high nibble -> 32 + 4kq..;
        // per-byte sign extension: ((v ^ 8) - 8) without cross-byte borrow
        const uint32_t lo = __vsub4((w[j] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
        const uint32_t hi = __vsub4(((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
        *reinterpret_cast<uint32_t*>(dst + 4 * kq) = lo;
        *reinterpret_cast<uint32_t*>(dst + 32 + 4 * kq) = hi;
      } else {
        *reinterpret_cast<uint32_t*>(dst + 4 * kq) = w[j];
      }
    }
  }
}

}  // namespace vq
