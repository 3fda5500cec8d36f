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
// What bounds it.  At vggt-1b's wqkv (M = 16464, K = 1024, N = 3072, W4,
// ln prologue, IDCT, bias) the bytes bound it: the f32 input (67 MB) and
// output (202 MB) take 0.081 ms at 3.35 TB/s, above the int8 matmul
// (104 GOP, 0.052 ms at 1,979 TOP/s) and the f32 work (the IDCT at a fast
// 64-point DCT's 12 operations an output, 0.6 GFLOP).  At wo (N = 1024, no
// norm) the bytes bound it too, 0.040 ms.
//
// Measured split of the previous kernel (commit bb9b1b2; an H100 at 700 W,
// tools/time_kernel_sources.py --kernel fused_matmul --split, PERF.md's
// findings on this redesign): of wqkv's 1.33 ms the matmul with its
// scaling and store took 74%, the dense 64x64 IDCT 23%, the prologue rows
// 3%; wo (0.51 ms) split the same way.  Its core staged each 64-deep step
// through registers behind two barriers, re-read the int8 input tile from
// scratch for every N tile, and restarted its loads at every N tile.
//
// Design.  A 256-thread block owns a 64-row M tile at a time (a persistent
// grid of at most the blocks the SMs hold at once: two per SM at vggt-1b's
// widths, so 258 tiles take one wave of 264 slots) and runs, on
// fused_rows.cuh's pieces, which fused_ffn.cu shares:
//   1. prologue rows, one warp a row (prologue_tile) -> the int8 input tile
//      and its scales, straight into shared memory, where the tile stays
//      for all N/128 N tiles up to K = 2,848; a wider input goes to the
//      block's scratch slice and streams through the ring beside the
//      weights.  A pre-quantized input is copied into the resident tile
//      with cp.async, or, when wider, streamed from the input itself;
//   2. one stream of 32-row weight steps over all N/128 N tiles through the
//      pipelined core (pc_stream: a 4-slot cp.async ring of raw weight
//      bytes, each step unpacked and transposed one step ahead of its use,
//      ldmatrix fragments, mma.sync m16n8k32, one __syncthreads a step), so
//      the next N tile's loads overlap this tile's epilogue;
//   3. each N tile's epilogue (pc_epilogue) on two 64x64 f32 half tiles in
//      shared memory: dequantize, the IDCT as a fast 64-point DCT-III
//      (idct64.cuh, ~10 operations an output against the dense product's
//      128; no DCT matrix in shared memory), bias, activation, store;
//   4. epilogues that need the whole output row (WHT, requantization) park
//      the f32 row tile in the block's scratch slice and finish it in a
//      row pass, one warp a row (wht_row, quant_row); off the served path.
// Shared memory at K = 1024: the 64 KB input tile, the ring (16 KB), the
// unpacked weights (2 x 8 KB), the half tile (16 KB) and the row scales,
// 114,944 B, which leaves room for two blocks per SM, so one block's
// prologue rows and epilogues run beside the other's tensor-core work.
// Ragged M and N are masked.
#include "fused_rows.cuh"

namespace {

using namespace vq;

constexpr int BM = FT_BM;  // rows per M tile
constexpr int THREADS = FT_THREADS;
constexpr int WARPS = FT_WARPS;
constexpr int FIXED = PC_SPARE + BM * 4;  // the ring, unpacked weights, half tile + row scales

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
  int idct, act, epi_wht, requant;
  float* out;         // f32 output [M,N]
  int8_t* out_q;      // requantized output [M,N]
  float* out_s;       // and its scales [M]
  int8_t* sq;         // scratch: grid x 64 x K int8 (a wide f32 input's int8 tile)
  float* sh;          // scratch: grid x 64 x N f32 (full-row epilogues)
  int M, N, K;
};

// Shared memory at widths K, N: the union region (the int8 input tile when
// it is resident, else the A slots; the row buffers of a full-row
// epilogue), then PC_SPARE and the row scales.  A prologue row buffer lies
// in PC_SPARE when the input tile is resident, else over the union and
// PC_SPARE; an output row buffer over both, which are free after the stream.
struct Plan {
  int ares;    // the int8 input tile stays in shared memory (else it is streamed)
  int u;       // union bytes
  int pwarps;  // warps with a prologue row buffer
  int rwarps;  // warps with an output row buffer (full-row epilogues)
  int bytes;   // dynamic shared memory
};

__host__ __device__ inline Plan plan_for(int K, int N, bool fullrow, bool prequant) {
  Plan pl;
  int u = PC_NST * PC_ASLOT;  // the A slots
  if (fullrow && u < N * 4 - PC_SPARE) u = N * 4 - PC_SPARE;  // one output row buffer
  pl.ares = round128(u > BM * K ? u : BM * K) + FIXED <= FT_SMEM_CAP;
  if (pl.ares) {
    if (u < BM * K) u = BM * K;
  } else if (!prequant && u < K * 4 - PC_SPARE) {
    u = K * 4 - PC_SPARE;  // one prologue row buffer
  }
  pl.u = round128(u);
  pl.pwarps = (pl.ares ? PC_SPARE : pl.u + PC_SPARE) / (K * 4);
  if (pl.pwarps > WARPS) pl.pwarps = WARPS;
  pl.rwarps = (pl.u + PC_SPARE) / (N * 4);
  if (pl.rwarps > WARPS) pl.rwarps = WARPS;
  pl.bytes = pl.u + FIXED;
  return pl;
}

// A pre-quantized 64-row tile (`rows` rows of K bytes at src) -> the
// resident tile, chunks swizzled as prologue_tile writes them, rows past
// `rows` zero.
__device__ void load_resident(int8_t* As, const int8_t* src, int rows, int K) {
  const int cpr = K >> 4;
  for (int i = threadIdx.x; i < BM * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r < rows;
    cp16(As + r * K + (a_swz(c, r, cpr) << 4), ok ? src + (size_t)r * K + 16 * c : src,
         ok ? 16 : 0);
  }
  cp_commit();
  cp_wait<0>();
}

template <bool PACKED, bool ASTREAM>
__device__ __forceinline__ void project(const Params& p, unsigned char* ring, int8_t* As,
                                        const int8_t* a_src, const float* xs, float* Y,
                                        float* dst, int rows) {
  pc_stream<PACKED, ASTREAM>(p.w, p.K, p.N, ring, As, a_src, rows,
                             [&](const int (&acc)[2][4][4], int n0) {
                               pc_epilogue(acc, xs, p.ws, p.bias, p.N, n0, p.idct != 0, KIND_UP,
                                           p.act, false, dst, p.N, rows, Y);
                             });
}

// The full-row epilogue of a tile: rows of sh -> WHT -> requantization or
// the f32 output, one warp a row.
__device__ void output_rows(const Params& p, const Plan& pl, float* bufs, const float* sh,
                            int m0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = p.N;
  if (warp >= pl.rwarps) return;
  float* buf = bufs + warp * N;
  for (int r = warp; r < rows; r += pl.rwarps) {
    __syncwarp();  // the buffer's previous row is consumed
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

__global__ void __launch_bounds__(THREADS, 2) fused_matmul_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool prequant = p.x == nullptr;
  const bool fullrow = p.epi_wht > 0 || p.requant > 0;
  const Plan pl = plan_for(p.K, p.N, fullrow, prequant);
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + pl.u;
  float* Y = reinterpret_cast<float*>(ring + PC_NST * PC_RAW + 2 * PC_BU);
  float* xs = Y + BM * PC_YH;
  const int M = p.M, N = p.N, K = p.K;
  int8_t* sq = prequant ? nullptr : p.sq + (size_t)blockIdx.x * BM * K;
  float* sh = fullrow ? p.sh + (size_t)blockIdx.x * BM * N : nullptr;
  const int tiles = (M + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * BM;
    const int rows = min(BM, M - m0);
    __syncthreads();  // the previous tile is done with every region
    const int8_t* a_src = sq;
    if (prequant) {
      for (int r = threadIdx.x; r < BM; r += THREADS) xs[r] = r < rows ? p.xs[m0 + r] : 0.f;
      a_src = p.xq + (size_t)m0 * K;
      if (pl.ares) load_resident(As, a_src, rows, K);
    } else {
      prologue_tile(p.x + (size_t)m0 * K, K, rows, p.norm, p.u, p.eps, p.pro_wht, p.a_bits,
                    pl.pwarps, pl.ares, As, reinterpret_cast<float*>(smem + (pl.ares ? pl.u : 0)),
                    sq, xs);
    }
    __syncthreads();
    float* dst = fullrow ? sh : p.out + (size_t)m0 * N;
    if (pl.ares) {
      if (p.packed) project<true, false>(p, ring, As, a_src, xs, Y, dst, rows);
      else project<false, false>(p, ring, As, a_src, xs, Y, dst, rows);
    } else {
      if (p.packed) project<true, true>(p, ring, As, a_src, xs, Y, dst, rows);
      else project<false, true>(p, ring, As, a_src, xs, Y, dst, rows);
    }
    if (fullrow) {
      __syncthreads();  // sh is complete; the union and PC_SPARE are free
      output_rows(p, pl, reinterpret_cast<float*>(smem), sh, m0, rows);
    }
  }
}

int check_plan(int N, int K, bool fullrow, bool prequant, Plan* pl) {
  *pl = plan_for(K, N, fullrow, prequant);
  return pl->bytes > FT_SMEM_CAP || (!prequant && pl->pwarps < 1) || (fullrow && pl->rwarps < 1)
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// Blocks of fused_matmul_kernel one SM holds at once at these widths.
// Returns a cudaError_t.
extern "C" int vq_fused_matmul_blocks_per_sm(int N, int K, int fullrow, int prequant,
                                             int* blocks) {
  Plan pl;
  const int e = check_plan(N, K, fullrow != 0, prequant != 0, &pl);
  return e != 0 ? e : ft_resident_blocks(fused_matmul_kernel, pl.bytes, blocks);
}

// The kernel's resources at these widths: out[0] registers per thread,
// out[1] shared memory per block in bytes, out[2] resident blocks per SM,
// out[3] spilled bytes per thread.  Returns a cudaError_t.
extern "C" int vq_fused_matmul_attrs(int N, int K, int fullrow, int prequant, int* out) {
  Plan pl;
  int e = check_plan(N, K, fullrow != 0, prequant != 0, &pl);
  if (e == 0) e = ft_resident_blocks(fused_matmul_kernel, pl.bytes, &out[2]);
  cudaFuncAttributes a;
  if (e == 0) e = static_cast<int>(cudaFuncGetAttributes(&a, fused_matmul_kernel));
  if (e != 0) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes) + pl.bytes;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// C entry point (ctypes).  x is null for a pre-quantized input (xq, xs);
// u, bias, out / out_q+out_s, sq (pre-quantized) and sh (no full-row
// epilogue) are null where unused.  Requires K % 16 == 0 (W8) or K % 32 ==
// 0 (W4), N % 4 == 0, N % 64 == 0 with idct, and 16-byte aligned rows; the
// Python wrapper checks these and sizes the scratch for `grid` blocks, at
// most the resident ones.  Widths whose row buffer exceeds a block's
// shared memory return cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int vq_fused_matmul(const void* x, const void* xq, const void* xs, const void* u,
                               float eps, int norm, int pro_wht, int a_bits, const void* w,
                               const void* ws, int packed, const void* bias, int idct, int act,
                               int epi_wht, int requant, void* out, void* out_q, void* out_s,
                               void* sq, void* sh, int M, int N, int K, int grid, void* stream) {
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
  p.idct = idct;
  p.act = act;
  p.epi_wht = epi_wht;
  p.requant = requant;
  p.out = static_cast<float*>(out);
  p.out_q = static_cast<int8_t*>(out_q);
  p.out_s = static_cast<float*>(out_s);
  p.sq = static_cast<int8_t*>(sq);
  p.sh = static_cast<float*>(sh);
  p.M = M;
  p.N = N;
  p.K = K;
  Plan pl;
  const int e0 = check_plan(N, K, epi_wht > 0 || requant > 0, x == nullptr, &pl);
  if (e0 != 0) return e0;
  cudaError_t e = cudaFuncSetAttribute(fused_matmul_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_matmul_kernel<<<grid, THREADS, pl.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
