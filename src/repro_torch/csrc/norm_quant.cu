// Fused prologue on Hopper (sm_90a): folded norm -> blocked WHT ->
// per-token quantization of f32 [M,D] rows, int8 [M,D] + f32 [M] out.
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::norm_quant
// (_norm_quant_kernel).  It is fused_matmul's prologue as a kernel of its
// own (fused_rows.cuh::prologue_row), so a quantized input can be shared by
// several projections (Q/K/V) through fused_matmul's pre-quantized path.
//
// Design.  One warp per row, rows striped over a grid of 256-thread
// blocks; each warp keeps its row in a shared-memory buffer (D floats),
// runs the statistics as warp reductions, the WHT as butterfly passes of
// up to 3 stages each, and writes 4 int8 per lane per store.
//
// What bounds it.  It reads 4 bytes and writes 1 per element, with
// ~log2(block) adds per element for the WHT: at [16464, 1024] that is
// 84 MB, 25 us at 3.35 TB/s, against ~0.2 GFLOP (3 us at 67 TFLOP/s): the
// bytes bound it.  The butterfly passes through shared memory cost
// log2(block)/3 round trips per element.
#include "fused_rows.cuh"

namespace {

using namespace vq;

__global__ void __launch_bounds__(FT_THREADS)
    norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ u, float eps,
                      int norm, int wht, int bits, int8_t* __restrict__ q,
                      float* __restrict__ s, int M, int D, int row_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= row_warps) return;
  float* buf = reinterpret_cast<float*>(smem) + warp * D;
  for (int r = blockIdx.x * row_warps + warp; r < M; r += gridDim.x * row_warps)
    prologue_row(x + (size_t)r * D, D, buf, norm, u, eps, wht, bits, q + (size_t)r * D, s + r,
                 lane);
}

}  // namespace

// C entry point (ctypes).  u is null unless norm == ln.  Requires D % 4 == 0
// and 16-byte aligned rows.  Returns cudaGetLastError().
extern "C" int vq_norm_quant(const void* x, const void* u, float eps, int norm, int wht, int bits,
                             void* q, void* s, int M, int D, int grid, void* stream) {
  int row_warps;
  const int bytes = ft_smem_bytes(D, &row_warps);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(norm_quant_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  norm_quant_kernel<<<grid, FT_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), eps, norm, wht, bits,
      static_cast<int8_t*>(q), static_cast<float*>(s), M, D, row_warps);
  return static_cast<int>(cudaGetLastError());
}
