// Warpgroup int8 MMA on Hopper (sm_90a): the wgmma wrapper, its shared-memory
// matrix descriptor and the K-major operand layout it reads.
//
// wgmma.mma_async m64nNk32 .s32.s8.s8 (PTX ISA, "Asynchronous Warpgroup
// Level Matrix Multiply-Accumulate"): the four warps of a warpgroup (128
// consecutive threads, the first warp's index a multiple of 4) multiply a
// 64x32 A tile by a 32xN B tile, both read from shared memory through
// descriptors, into s32 accumulators in registers.  For 8-bit types both
// operands must be K-major (no transpose flag exists).
//
// K-major layout without swizzle (descriptor layout type 0): the operand is
// built from core matrices of 8 rows x 16 bytes of K, each 128 contiguous
// bytes (row r at byte 16 r).  The descriptor's leading byte offset (LBO)
// is the distance between core matrices adjacent in K, its stride byte
// offset (SBO) the distance between core matrices adjacent in M (or N).
// KMajor<ROWS> orders a tile of ROWS rows as [k / 16][row / 8][row % 8][16]:
// LBO = 16 ROWS, SBO = 128.  One k32 slice is two 16-byte K chunks, so
// slice i of a tile starts 2 i LBO bytes in.
//
// Accumulator fragment of m64nNk32 (the same per-warp shape as mma.sync's
// C fragment), with w the warp within the warpgroup, g = lane / 4 and
// t = lane % 4: d[4 i + 2 h + e] holds row 16 w + g + 8 h, column
// 8 i + 2 t + e.
//
// Ordering rules: wgmma_fence() before the first wgmma of a batch (and
// whenever the accumulators were touched by other instructions); every
// generic-proxy write to an operand tile (st.shared, or cp.async once it
// has completed) must be followed by fence_proxy_async() before a barrier
// after which a wgmma reads it; wgmma_wait<N>() before the accumulators or
// the operand tiles of a group are reused.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vq {

template <int ROWS>
struct KMajor {
  static constexpr uint32_t LBO = ROWS * 16;  // next 16 bytes of K
  static constexpr uint32_t SBO = 128;        // next 8 rows

  // byte offset of (row, k) in the tile
  __device__ __forceinline__ static int offset(int row, int k) {
    return (k >> 4) * LBO + (row >> 3) * SBO + ((row & 7) << 4) + (k & 15);
  }
};

// Descriptor of a K-major, unswizzled operand at `smem` (16-byte aligned):
// start address >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45,
// base offset 0, layout type 0 (bits 62-63).  A byte offset `o` (a
// multiple of 16) is added to a descriptor as o >> 4.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared-memory writes -> visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins the accumulators: the compiler may not move their reads or writes
// across this point (around a wait, before the first issue).
template <int R>
__device__ __forceinline__ void wgmma_fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[128] += A (64x32 s8, descriptor da) . B (32x256 s8, descriptor db)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      " %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125,"
      " %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace vq
