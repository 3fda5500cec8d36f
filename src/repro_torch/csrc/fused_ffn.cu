// The whole (optionally gated) FFN layer in one launch on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::fused_ffn
// (_fused_ffn_kernel):
//   x f32 [M,D] -> folded norm (rms|ln|none) -> input WHT (unrotated-stream
//   flows) -> one per-token quantization shared by gate and up -> gate/up
//   int matmuls (+IDCT +bias) -> act(g)*u or act(u) -> hidden blocked WHT
//   -> requantization at a_bits_mid -> down int matmul (+IDCT +bias)
//   -> f32 [M, d_out].
//
// Design.  The hidden row is what makes this hard: the hidden WHT
// (block_size_for(4096) = 4096, i.e. 32 groups x 128) and the per-token
// requantization need the whole d_ff-wide row, and 64 rows of it in f32
// (1 MiB) are far beyond a block's 227 KB of shared memory.  The TPU
// kernel held them in VMEM.  Here each 256-thread block walks over 64-row
// M tiles (a persistent grid: at most as many blocks as the SMs hold at
// once, vq_fused_ffn_blocks_per_sm x SMs; the 144 KB of shared memory at
// d_ff = 4096 leave one per SM) and owns a scratch slice of device memory
// sized by that grid, not by M:
//   1. prologue rows (fused_rows.cuh::prologue_row) -> int8 input + scale;
//   2. for each 128-column tile of d_ff: gate and up projections
//      (fused_rows.cuh::ft_project: int8 mma.sync, dequant, IDCT, bias),
//      act(g)*u into the f32 hidden slice;
//   3. one warp per hidden row: WHT + requantization -> int8 hidden (over
//      the now dead int8 input) + scale;
//   4. the down projection of the int8 hidden, IDCT, bias -> output.
// One launch per FFN layer; the hidden stage is the same code as
// fused_matmul's full-row epilogue, the down stage the same as its
// pre-quantized input path.  The scratch does not fit in L2: at vggt-1b
// 132 blocks x 64 rows x 4096 f32 are 138 MB (+ 35 MB of int8) against the
// 50 MB L2, so the f32 hidden goes through HBM once each way, an
// [M, d_ff] round trip in all but layout.  16-row tiles, or a 2-CTA
// cluster splitting the row over distributed shared memory, would keep it
// on chip; that is later work.
//
// What bounds it.  At vggt-1b (M = 16464, D = 1024, d_ff = 4096, W4, ln,
// plain GELU) the two int8 matmuls, 2*2*M*1024*4096 = 276 GOP, take
// 0.140 ms at 1,979 TOP/s and bound it.  The three IDCTs (up over 4096
// columns, down over 1024) are counted at a fast 64-point DCT's 12
// operations per output, 1.0 GFLOP; with the activation, hidden WHT,
// requantization and norm the f32 work is ~3 GFLOP, 0.045 ms at 67 TFLOP/s,
// and the bytes (x and out in f32, 4 MiB of weights) 0.042 ms.  The dense
// 64x64 IDCT this version runs (128 per output, 10.8 GFLOP, 0.16 ms) and
// the hidden's HBM round trip (~540 MB, 0.16 ms) are its own costs, not
// the function's.
#include "fused_rows.cuh"

namespace {

using namespace vq;

struct Params {
  const float* x;
  const float* u;
  float eps;
  int norm, pro_wht, a_in;
  const uint8_t* wg;  // null for a plain FFN
  const float* wgs;
  const float* bg;
  const uint8_t* wu;
  const float* wus;
  const float* bu;
  const uint8_t* wd;
  const float* wds;
  const float* bd;
  int packed_g, packed_u, packed_d;
  const float* dct;
  int idct_h, idct_out, act, mid_wht, a_mid;
  float* out;
  int8_t* sq;  // scratch: grid x 64 x max(D, F) int8
  float* ss;   // scratch: grid x 128 f32 (input scales, then hidden scales)
  float* sh;   // scratch: grid x 64 x F f32 hidden
  int M, D, F, NO, row_w, row_warps;
};

__global__ void __launch_bounds__(FT_THREADS) fused_ffn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Dsm = reinterpret_cast<float*>(smem);
  const bool any_idct = p.idct_h || p.idct_out;
  unsigned char* un = smem + (any_idct ? FT_DCT_SMEM : 0);
  int8_t* As = reinterpret_cast<int8_t*>(un);
  int8_t* Bs = As + FT_BM * FT_LDS;
  float* Y = reinterpret_cast<float*>(Bs + FT_BN * FT_LDS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (any_idct)
    for (int i = tid; i < DCT_B * DCT_B; i += FT_THREADS) Dsm[i] = p.dct[i];
  const int M = p.M, D = p.D, F = p.F, NO = p.NO;
  const int wq = D > F ? D : F;
  int8_t* sq = p.sq + (size_t)blockIdx.x * FT_BM * wq;
  float* xs = p.ss + (size_t)blockIdx.x * 2 * FT_BM;
  float* hs = xs + FT_BM;
  float* sh = p.sh + (size_t)blockIdx.x * FT_BM * F;
  float* buf = reinterpret_cast<float*>(un) + warp * p.row_w;
  const bool rows_warp = warp < p.row_warps;
  const int tiles = (M + FT_BM - 1) / FT_BM;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * FT_BM;
    const int rows = min(FT_BM, M - m0);

    __syncthreads();  // the row buffers alias the previous tile's matmul tiles
    if (rows_warp)
      for (int r = warp; r < rows; r += p.row_warps)
        prologue_row(p.x + (size_t)(m0 + r) * D, D, buf, p.norm, p.u, p.eps, p.pro_wht, p.a_in,
                     sq + (size_t)r * D, xs + r, lane);
    __syncthreads();

    for (int n0 = 0; n0 < F; n0 += FT_BN) {
      float v[32];
      if (p.wg != nullptr) {  // sh = act(gate), then sh *= up below
        ft_project(v, p.packed_g, sq, xs, rows, D, p.wg, p.wgs, p.bg, F, n0, p.idct_h, Dsm, As,
                   Bs, Y);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = ft_row(i), n = n0 + ft_col(i);
          if (r < rows && n < F) sh[(size_t)r * F + n] = act_fn(v[i], p.act);
        }
      }
      ft_project(v, p.packed_u, sq, xs, rows, D, p.wu, p.wus, p.bu, F, n0, p.idct_h, Dsm, As, Bs,
                 Y);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = ft_row(i), n = n0 + ft_col(i);
        if (r >= rows || n >= F) continue;
        float* h = sh + (size_t)r * F + n;  // written by this same thread above
        *h = p.wg != nullptr ? *h * v[i] : act_fn(v[i], p.act);
      }
    }

    __syncthreads();  // hidden tile complete; int8 input dead
    if (rows_warp) {
      for (int r = warp; r < rows; r += p.row_warps) {
        __syncwarp();
        load_row(buf, sh + (size_t)r * F, F, lane);
        if (p.mid_wht > 0) wht_row(buf, F, p.mid_wht, lane);
        quant_row(buf, F, p.a_mid, sq + (size_t)r * F, hs + r, lane);
      }
    }
    __syncthreads();

    for (int n0 = 0; n0 < NO; n0 += FT_BN) {
      float v[32];
      ft_project(v, p.packed_d, sq, hs, rows, F, p.wd, p.wds, p.bd, NO, n0, p.idct_out, Dsm, As,
                 Bs, Y);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = ft_row(i), n = n0 + ft_col(i);
        if (r < rows && n < NO) p.out[(size_t)(m0 + r) * NO + n] = v[i];
      }
    }
  }
}

}  // namespace

// Blocks of fused_ffn_kernel one SM holds at these widths (the row
// buffers are max(D, F) floats wide).  Returns a cudaError_t.
extern "C" int vq_fused_ffn_blocks_per_sm(int D, int F, int idct, int* blocks) {
  int row_warps;
  return ft_resident_blocks(fused_ffn_kernel, ft_smem_bytes(D > F ? D : F, idct != 0, &row_warps),
                            blocks);
}

// C entry point (ctypes).  wg/wgs/bg are null for a plain FFN; u, biases
// and dct null where unused.  Requires D, F % 16 == 0 (% 32 for packed
// weights on that input), F, NO % 4 == 0 (% 64 with the IDCT) and 16-byte
// aligned rows; the Python wrapper checks these and sizes the scratch for
// `grid` blocks, at most the resident ones.  Returns cudaGetLastError().
extern "C" int vq_fused_ffn(const void* x, const void* u, float eps, int norm, int pro_wht,
                            int a_in, const void* wg, const void* wgs, const void* bg,
                            const void* wu, const void* wus, const void* bu, const void* wd,
                            const void* wds, const void* bd, int packed_g, int packed_u,
                            int packed_d, const void* dct, int idct_h, int idct_out, int act,
                            int mid_wht, int a_mid, void* out, void* sq, void* ss, void* sh, int M,
                            int D, int F, int NO, int grid, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.u = static_cast<const float*>(u);
  p.eps = eps;
  p.norm = norm;
  p.pro_wht = pro_wht;
  p.a_in = a_in;
  p.wg = static_cast<const uint8_t*>(wg);
  p.wgs = static_cast<const float*>(wgs);
  p.bg = static_cast<const float*>(bg);
  p.wu = static_cast<const uint8_t*>(wu);
  p.wus = static_cast<const float*>(wus);
  p.bu = static_cast<const float*>(bu);
  p.wd = static_cast<const uint8_t*>(wd);
  p.wds = static_cast<const float*>(wds);
  p.bd = static_cast<const float*>(bd);
  p.packed_g = packed_g;
  p.packed_u = packed_u;
  p.packed_d = packed_d;
  p.dct = static_cast<const float*>(dct);
  p.idct_h = idct_h;
  p.idct_out = idct_out;
  p.act = act;
  p.mid_wht = mid_wht;
  p.a_mid = a_mid;
  p.out = static_cast<float*>(out);
  p.sq = static_cast<int8_t*>(sq);
  p.ss = static_cast<float*>(ss);
  p.sh = static_cast<float*>(sh);
  p.M = M;
  p.D = D;
  p.F = F;
  p.NO = NO;
  p.row_w = D > F ? D : F;
  const int smem = ft_smem_bytes(p.row_w, idct_h || idct_out, &p.row_warps);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaFuncSetAttribute(fused_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_ffn_kernel<<<grid, FT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
