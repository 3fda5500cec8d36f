// Blocked Walsh-Hadamard transform along the last axis of f32 [R, d] on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wht.py::wht (_wht_kernel):
// an add/sub butterfly across the 128-wide groups of each block, then the
// H_128 factor (one MXU dot on the TPU), then 1/sqrt(g).  The H_128 factor
// is a butterfly here too, scaled by fl(1/sqrt(128)): a 128x128 f32 dot
// per 128 elements would cost 128 FMAs per element where the butterfly
// needs 7 adds, and TF32 tensor cores would round to ~3 digits.  The
// output is bit-identical to fused_rows.cuh::wht_row, fused_ffn's hidden
// rotation.
//
// What bounds it.  4 bytes in and 4 out per element, against log2(block)
// adds: at [16464, 4096] that is 540 MB, 0.161 ms at 3.35 TB/s, against
// 0.9 GFLOP (14 us at 67 TFLOP/s).  The bytes bound it, so the design is
// about keeping enough bytes in flight and touching each byte once.
//
// Design (rows_async.cuh).  A persistent grid of 4-warp blocks; each warp
// walks its own rows.  A row arrives by one bulk copy into the warp's
// slot of a shared-memory ring, moves into registers (128 floats a lane
// at d = 4096, as the float4 chunks 4 lane + 128 k) and its slot is at
// once refilled with the warp's next row; the stages across the groups
// and on bits 0-1 run within a lane's registers, the five on bits 2-6
// through warp shuffles, then the two scaling multiplies, and the row is
// stored from registers, 512 contiguous bytes a warp instruction.  At
// d = 4096 a warp has one 16 KB slot and two blocks fit an SM (254
// registers a thread, no spills; capped at 168 for three blocks it
// spilled and ran 13% slower): 128 KB in flight per SM.  It moves 2.7
// TB/s, 1.24x the byte bound (PERF.md, PR 20).  Rows of d % 128 != 0 or
// d > 4096 run the parent's kernel, fused_rows.cuh's load_row, wht_row
// and store_row, one warp a row in 8-warp blocks.
#include "rows_async.cuh"

namespace {

using namespace vq;

// the register instance: rows of d = 128 K floats, K <= KM
template <int KM>
__global__ void __launch_bounds__(RA_THREADS, KM >= 32 ? 2 : 1)
    wht_kernel(const float* __restrict__ x, float* __restrict__ y, int R, int d, int block,
               int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, K = d >> 7;
  RowRing ring(smem, x, R, d * 4, ns);
  const WhtScale scale(block);
  const float* slot;
  for (int r; (r = ring.next(&slot)) >= 0;) {
    float4 v[KM];
    rr_load<KM>(v, slot, K, lane);
    ring.release();
    rr_wht<KM>(v, block, scale, lane);
    rr_store<KM>(y + (size_t)r * d, v, K, lane);
  }
}

// every other width: a row buffer in shared memory a warp
__global__ void __launch_bounds__(FT_THREADS)
    wht_rows_kernel(const float* __restrict__ x, float* __restrict__ y, int R, int d, int block,
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

using Kernel = void (*)(const float*, float*, int, int, int, int);

RowLaunch<Kernel> pick(int d) {
  return ra_pick(d, 0,
                 [](int km) -> Kernel {
                   return km == 1 ? wht_kernel<1> : km == 2 ? wht_kernel<2>
                        : km == 4 ? wht_kernel<4> : km == 8 ? wht_kernel<8>
                        : km == 16 ? wht_kernel<16> : wht_kernel<32>;
                 },
                 wht_rows_kernel);
}

}  // namespace

// Blocks of the launch for rows of d floats that one SM holds at once
// (the wrapper sizes the persistent grid by it).  Returns a cudaError_t.
extern "C" int vq_wht_blocks_per_sm(int d, int* blocks) {
  return ra_resident_blocks(pick(d), blocks);
}

// The resources of that launch's kernel: out[0] registers per thread,
// out[1] shared memory per block in bytes, out[2] resident blocks per SM,
// out[3] spilled bytes per thread.  Returns a cudaError_t.
extern "C" int vq_wht_attrs(int d, int* out) { return ra_attrs(pick(d), out); }

// C entry point (ctypes).  block is a power of two dividing d, d % 4 == 0,
// rows 16-byte aligned.  Returns cudaGetLastError().
extern "C" int vq_wht(const void* x, void* y, int R, int d, int block, int grid, void* stream) {
  const RowLaunch<Kernel> l = pick(d);
  const int e = ra_opt_in(l);
  if (e != 0) return e;
  l.kernel<<<grid, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, d, block, l.arg);
  return static_cast<int>(cudaGetLastError());
}
