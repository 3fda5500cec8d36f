// Unified-datapath linear on Hopper (sm_90a): prologue -> integer matmul ->
// epilogue, one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::fused_matmul
// (_fused_matmul_kernel).  Every option of the reference:
//   input   f32 [M,K] (prologue: folded norm rms|ln -> blocked WHT ->
//           per-token A8/A4 quantization), or int8 [M,K] + xs [M]
//   weight  int8 [K,N] or packed uint8 [K/2,N]; ws [N]
//   epilogue dequant -> 64-block IDCT -> bias -> none|gelu|silu ->
//           blocked WHT -> per-token requantization to 8 or 4 bits
//   output  f32 [M,N], or int8 [M,N] + scales [M]
//
// Design.  The TPU kernel kept whole K and N panels resident in VMEM and
// gridded over 256-row token tiles.  Here each 256-thread block walks over
// 64-row M tiles (a persistent grid: one block per tile, at most as many
// as the SMs hold at once, vq_fused_matmul_blocks_per_sm x SMs):
//   1. prologue: one warp per row normalizes, rotates and quantizes the
//      row in a shared-memory row buffer and writes int8 + scale to the
//      block's own scratch slice in device memory, which the same block
//      re-reads at once;
//   2. for each 128-column N tile: int8 mma.sync.m16n8k32 over K (packed
//      nibbles sign-extended while staging, as in quant_matmul.cu), then
//      the dequant scale into an f32 tile in shared memory, the 64x64 IDCT
//      as f32 FMAs on the CUDA cores (TF32 would keep ~3 digits), bias and
//      activation;
//   3. epilogues that need the whole output row (WHT, requantization)
//      park the f32 row tile in the block's scratch slice and finish it in
//      a second row pass; the rest store straight to the output.
// The scratch is sized by the grid, which is bounded by the SM count, not
// by M: at wqkv (258 tiles) it is 258 x 64 x 1024 B = 17 MB of int8, within
// the 50 MB L2 (whether it stays there is not measured).  Ragged M and N
// are masked.
//
// What bounds it.  At vggt-1b's wqkv (M = 16464, K = 1024, N = 3072, W4,
// ln prologue, IDCT, bias) the bytes bound it: the f32 input (67 MB) and
// output (202 MB) take 0.081 ms at 3.35 TB/s, above the int8 matmul
// (104 GOP, 0.052 ms at 1,979 TOP/s).  The IDCT is counted at a fast
// 64-point DCT's cost (Chen/Loeffler: 192 multiplies and 576 adds per
// block, 12 operations per output), 0.6 GFLOP; the dense 64x64 product this
// version runs (128 per output, 6.5 GFLOP, 0.097 ms at 67 TFLOP/s) is its
// own cost, not the function's.  At wo (N = 1024) the bytes bound it too,
// 0.040 ms.  This first version runs the dense IDCT from shared memory
// with D in registers and the matmul without a TMA/wgmma pipeline; a fast
// IDCT and the pipeline are later work.
#include "fused_rows.cuh"

namespace {

using namespace vq;

struct Params {
  const float* x;      // f32 input [M,K], or null when pre-quantized
  const int8_t* xq;    // pre-quantized input [M,K]
  const float* xs;     // its per-row scales [M]
  const float* u;      // LayerNorm mean-recovery vector [K]
  float eps;
  int norm, pro_wht, a_bits;
  const uint8_t* w;
  const float* ws;
  int packed;
  const float* bias;
  const float* dct;  // [64,64] when idct
  int idct, act, epi_wht, requant;
  float* out;         // f32 output [M,N]
  int8_t* out_q;      // requantized output [M,N]
  float* out_s;       // and its scales [M]
  int8_t* sq;         // scratch: grid x 64 x K int8
  float* ss;          // scratch: grid x 64 f32
  float* sh;          // scratch: grid x 64 x N f32 (full-row epilogues)
  int M, N, K, row_warps;
};

__global__ void __launch_bounds__(FT_THREADS) fused_matmul_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Dsm = reinterpret_cast<float*>(smem);
  unsigned char* un = smem + (p.idct ? FT_DCT_SMEM : 0);
  int8_t* As = reinterpret_cast<int8_t*>(un);
  int8_t* Bs = As + FT_BM * FT_LDS;
  float* Y = reinterpret_cast<float*>(Bs + FT_BN * FT_LDS);
  float* rowbuf = reinterpret_cast<float*>(un);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (p.idct)
    for (int i = tid; i < DCT_B * DCT_B; i += FT_THREADS) Dsm[i] = p.dct[i];
  const bool prequant = p.x == nullptr;
  const bool fullrow = p.epi_wht > 0 || p.requant > 0;
  const int M = p.M, N = p.N, K = p.K;
  int8_t* sq = p.sq + (size_t)blockIdx.x * FT_BM * K;
  float* ss = p.ss + (size_t)blockIdx.x * FT_BM;
  float* sh = fullrow ? p.sh + (size_t)blockIdx.x * FT_BM * N : nullptr;
  float* buf = rowbuf + warp * (fullrow && N > K ? N : K);  // row_w, as the entry point sizes it
  const int tiles = (M + FT_BM - 1) / FT_BM;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * FT_BM;
    const int rows = min(FT_BM, M - m0);
    const int8_t* A;
    const float* xs;
    if (prequant) {
      A = p.xq + (size_t)m0 * K;
      xs = p.xs + m0;
    } else {
      __syncthreads();  // the row buffers alias the previous tile's matmul tiles
      if (warp < p.row_warps)
        for (int r = warp; r < rows; r += p.row_warps)
          prologue_row(p.x + (size_t)(m0 + r) * K, K, buf, p.norm, p.u, p.eps, p.pro_wht,
                       p.a_bits, sq + (size_t)r * K, ss + r, lane);
      A = sq;
      xs = ss;
    }
    __syncthreads();

    for (int n0 = 0; n0 < N; n0 += FT_BN) {
      float v[32];
      ft_project(v, p.packed, A, xs, rows, K, p.w, p.ws, p.bias, N, n0, p.idct, Dsm, As, Bs, Y);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = ft_row(i), n = n0 + ft_col(i);
        if (r >= rows || n >= N) continue;
        const float y = act_fn(v[i], p.act);
        if (fullrow) sh[(size_t)r * N + n] = y;
        else p.out[(size_t)(m0 + r) * N + n] = y;
      }
    }

    if (fullrow) {
      __syncthreads();  // sh complete; the row buffers alias the matmul tiles
      if (warp < p.row_warps) {
        for (int r = warp; r < rows; r += p.row_warps) {
          __syncwarp();
          load_row(buf, sh + (size_t)r * N, N, lane);
          if (p.epi_wht > 0) wht_row(buf, N, p.epi_wht, lane);
          if (p.requant > 0) {
            quant_row(buf, N, p.requant, p.out_q + (size_t)(m0 + r) * N, p.out_s + m0 + r, lane);
          } else {
            __syncwarp();
            store_row(p.out + (size_t)(m0 + r) * N, buf, N, lane);
          }
        }
      }
      __syncthreads();
    }
  }
}

// Dynamic shared memory of one block: the row buffers are K floats wide,
// or N for a full-row epilogue over a wider output.
int smem_bytes(int N, int K, bool fullrow, bool idct, int* row_warps) {
  return ft_smem_bytes((fullrow && N > K) ? N : K, idct, row_warps);
}

}  // namespace

// Blocks of fused_matmul_kernel one SM holds at these widths.  Returns a
// cudaError_t.
extern "C" int vq_fused_matmul_blocks_per_sm(int N, int K, int fullrow, int idct, int* blocks) {
  int row_warps;
  return ft_resident_blocks(fused_matmul_kernel,
                            smem_bytes(N, K, fullrow != 0, idct != 0, &row_warps), blocks);
}

// C entry point (ctypes).  x is null for a pre-quantized input (xq, xs);
// u, bias, dct, out / out_q+out_s and sh are null where unused.  Requires
// K % 16 == 0 (W8) or K % 32 == 0 (W4), N % 4 == 0, N % 64 == 0 with idct,
// and 16-byte aligned rows; the Python wrapper checks these and sizes the
// scratch for `grid` blocks, at most the resident ones.  Returns
// cudaGetLastError().
extern "C" int vq_fused_matmul(const void* x, const void* xq, const void* xs, const void* u,
                               float eps, int norm, int pro_wht, int a_bits, const void* w,
                               const void* ws, int packed, const void* bias, const void* dct,
                               int idct, int act, int epi_wht, int requant, void* out,
                               void* out_q, void* out_s, void* sq, void* ss, void* sh, int M,
                               int N, int K, int grid, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.xq = static_cast<const int8_t*>(xq);
  p.xs = static_cast<const float*>(xs);
  p.u = static_cast<const float*>(u);
  p.eps = eps;
  p.norm = norm;
  p.pro_wht = pro_wht;
  p.a_bits = a_bits;
  p.w = static_cast<const uint8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.packed = packed;
  p.bias = static_cast<const float*>(bias);
  p.dct = static_cast<const float*>(dct);
  p.idct = idct;
  p.act = act;
  p.epi_wht = epi_wht;
  p.requant = requant;
  p.out = static_cast<float*>(out);
  p.out_q = static_cast<int8_t*>(out_q);
  p.out_s = static_cast<float*>(out_s);
  p.sq = static_cast<int8_t*>(sq);
  p.ss = static_cast<float*>(ss);
  p.sh = static_cast<float*>(sh);
  p.M = M;
  p.N = N;
  p.K = K;
  const int smem = smem_bytes(N, K, epi_wht > 0 || requant > 0, idct != 0, &p.row_warps);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(fused_matmul_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_matmul_kernel<<<grid, FT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
