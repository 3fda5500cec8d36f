// Fused prologue on Hopper (sm_90a): folded norm -> blocked WHT ->
// per-token quantization of f32 [M,D] rows, int8 [M,D] + f32 [M] out.
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::norm_quant
// (_norm_quant_kernel).  It computes what fused_matmul's prologue
// (fused_rows.cuh::prologue_row) computes, bit for bit, so a quantized
// input can be shared by several projections (Q/K/V) through
// fused_matmul's pre-quantized path and give what each would have made of
// the f32 input itself.
//
// What bounds it.  It reads 4 bytes and writes 1 per element, with
// ~log2(block) + 10 f32 operations per element (statistics, WHT, scaling,
// quantization): at [16464, 1024] that is 84 MB, 25 us at 3.35 TB/s,
// against ~0.4 GFLOP (6 us at 67 TFLOP/s).  The bytes bound it; the
// instructions around each element (shuffles, division, conversion) come
// second.
//
// Design (rows_async.cuh).  A persistent grid of 4-warp blocks; each warp
// walks its own rows through a ring of row slots in shared memory fed by
// bulk copies, one 4 KB slot a warp at D = 1024, so the next row's bytes
// are in flight while the warp works; LayerNorm's u is copied into shared
// memory once a block.  The row moves into registers (32 floats a lane at
// D = 1024) and stays there: the norm statistics as warp reductions over
// the lane's chunks in norm_row's order, the WHT's stages within the lane
// and through shuffles, the amax as a warp reduction, and 4 int8 a lane
// stored per chunk, 128 contiguous bytes a warp instruction.  The
// per-element IEEE division becomes a reciprocal a row and two
// Markstein corrections an element (rows_async.cuh::div_by), rounding
// and clamping one conversion.  The work per row is then ~1,000 warp
// instructions, so warps, not bytes in flight, decide the time: the
// instance for D <= 1024 is capped at 80 registers for six blocks (24
// warps) an SM.  0.044 ms, 1.76x the byte bound (PERF.md, PR 20).  Rows
// of D % 128 != 0 or D > 4096 run the parent's kernel, fused_rows.cuh's
// prologue_row on a row buffer in shared memory, one warp a row in
// 8-warp blocks.
#include "rows_async.cuh"

namespace {

using namespace vq;

// the register instance: rows of D = 128 K floats, K <= KM
template <int KM>
__global__ void __launch_bounds__(RA_THREADS, KM >= 32 ? 2 : KM >= 16 ? 1 : 6)
    norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ u, float eps,
                      int norm, int wht, int bits, int8_t* __restrict__ q,
                      float* __restrict__ s, int M, int D, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, K = D >> 7;
  if (norm == NORM_LN) {  // u into shared memory once a block, after the slots
    float* us = reinterpret_cast<float*>(smem + ra_smem_bytes(4 * D, ns));
    for (int i = threadIdx.x; i < D; i += RA_THREADS) us[i] = u[i];
    __syncthreads();
    u = us;
  }
  RowRing ring(smem, x, M, D * 4, ns);
  const WhtScale scale(wht > 0 ? wht : 1);
  const float* slot;
  for (int r; (r = ring.next(&slot)) >= 0;) {
    float4 v[KM];
    rr_load<KM>(v, slot, K, lane);
    ring.release();
    if (norm != NORM_NONE) rr_norm<KM>(v, K, norm, u, eps, lane);
    if (wht > 0) rr_wht<KM>(v, wht, scale, lane);
    rr_quant<KM>(v, K, bits, q + (size_t)r * D, s + r, lane);
  }
}

// every other width: a row buffer in shared memory a warp
__global__ void __launch_bounds__(FT_THREADS)
    norm_quant_rows_kernel(const float* __restrict__ x, const float* __restrict__ u, float eps,
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

using Kernel = void (*)(const float*, const float*, float, int, int, int, int8_t*, float*, int,
                        int, int);

// the register instance keeps u (D floats) after its ring
RowLaunch<Kernel> pick(int D) {
  return ra_pick(D, 4 * D,
                 [](int km) -> Kernel {
                   return km == 1 ? norm_quant_kernel<1> : km == 2 ? norm_quant_kernel<2>
                        : km == 4 ? norm_quant_kernel<4> : km == 8 ? norm_quant_kernel<8>
                        : km == 16 ? norm_quant_kernel<16> : norm_quant_kernel<32>;
                 },
                 norm_quant_rows_kernel);
}

}  // namespace

// Blocks of the launch for rows of D floats that one SM holds at once
// (the wrapper sizes the persistent grid by it).  Returns a cudaError_t.
extern "C" int vq_norm_quant_blocks_per_sm(int D, int* blocks) {
  return ra_resident_blocks(pick(D), blocks);
}

// The resources of that launch's kernel: out[0] registers per thread,
// out[1] shared memory per block in bytes, out[2] resident blocks per SM,
// out[3] spilled bytes per thread.  Returns a cudaError_t.
extern "C" int vq_norm_quant_attrs(int D, int* out) { return ra_attrs(pick(D), out); }

// C entry point (ctypes).  u is null unless norm == ln.  Requires D % 4 == 0
// and 16-byte aligned rows.  Returns cudaGetLastError().
extern "C" int vq_norm_quant(const void* x, const void* u, float eps, int norm, int wht, int bits,
                             void* q, void* s, int M, int D, int grid, void* stream) {
  const RowLaunch<Kernel> l = pick(D);
  const int e = ra_opt_in(l);
  if (e != 0) return e;
  l.kernel<<<grid, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), eps, norm, wht, bits,
      static_cast<int8_t*>(q), static_cast<float*>(s), M, D, l.arg);
  return static_cast<int>(cudaGetLastError());
}
