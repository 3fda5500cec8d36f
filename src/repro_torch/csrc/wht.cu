// Blocked Walsh-Hadamard transform along the last axis of f32 [R, d] on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wht.py::wht (_wht_kernel):
// an add/sub butterfly across the 128-wide groups of each block, then the
// H_128 factor (one MXU dot on the TPU), then 1/sqrt(g).  It is
// fused_ffn's hidden rotation (fused_rows.cuh::wht_row) as a kernel of its
// own.  The H_128 factor is a butterfly here too, scaled by
// fl(1/sqrt(128)): a 128x128 f32 dot per 128 elements would cost 128 FMAs
// per element where the butterfly needs 7 adds, and TF32 tensor cores
// would round to ~3 digits.
//
// Design.  One warp per row, rows striped over a grid of 256-thread
// blocks; the row sits in a shared-memory buffer and the log2(block)
// stages run as passes of up to 3 radix-2 stages each (8 elements per lane
// in registers), so a 4096-wide block takes 4 passes through shared memory.
//
// What bounds it.  4 bytes in and 4 out per element, against log2(block)
// adds: at [16464, 4096] that is 540 MB, 0.16 ms at 3.35 TB/s, against
// 0.8 GFLOP (12 us at 67 TFLOP/s).  The bytes bound it.
#include "fused_rows.cuh"

namespace {

using namespace vq;

__global__ void __launch_bounds__(FT_THREADS)
    wht_kernel(const float* __restrict__ x, float* __restrict__ y, int R, int d, int block,
               int row_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= row_warps) return;
  float* buf = reinterpret_cast<float*>(smem) + warp * d;
  for (int r = blockIdx.x * row_warps + warp; r < R; r += gridDim.x * row_warps) {
    __syncwarp();
    load_row(buf, x + (size_t)r * d, d, lane);
    wht_row(buf, d, block, lane);
    store_row(y + (size_t)r * d, buf, d, lane);
  }
}

}  // namespace

// C entry point (ctypes).  block is a power of two dividing d, d % 4 == 0,
// rows 16-byte aligned.  Returns cudaGetLastError().
extern "C" int vq_wht(const void* x, void* y, int R, int d, int block, int grid, void* stream) {
  int row_warps;
  const int bytes = ft_smem_bytes(d, &row_warps);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(wht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wht_kernel<<<grid, FT_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, d, block, row_warps);
  return static_cast<int>(cudaGetLastError());
}
