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
// What bounds it.  At vggt-1b (M = 16464, D = 1024, d_ff = 4096, W4, ln,
// plain GELU) the two int8 matmuls, 2*2*M*1024*4096 = 276 GOP, take
// 0.140 ms at 1,979 TOP/s and bound it.  The three IDCTs (up over 4096
// columns, down over 1024) are counted at a fast 64-point DCT's 12
// operations per output, 1.0 GFLOP; with the activation, hidden WHT,
// requantization and norm the f32 work is ~3 GFLOP, 0.045 ms at 67 TFLOP/s,
// and the bytes (x and out in f32, 4 MiB of weights) 0.042 ms.
//
// Design.  A 256-thread block owns a 64-row M tile at a time (a persistent
// grid of at most the blocks the SMs hold at once, which at vggt-1b is two
// per SM: 258 tiles over 264 slots, one wave) and runs four phases on it:
//   1. prologue rows, one warp a row (fused_rows.cuh: norm_row, wht_row,
//      quant_row_by) -> the int8 input tile, which stays in shared memory
//      for all d_ff/128 up-projection N tiles (up to D = 2,848; wider
//      inputs go to the block's scratch slice and are streamed through
//      the ring as the down projection's A is), and its scales;
//   2. the up projection (after the gate's, when gated): one stream of
//      32-row weight steps over all d_ff/128 N tiles through the pipelined
//      core of fused_rows.cuh (pc_*): a 4-slot cp.async ring of raw weight
//      bytes, each step unpacked and transposed into a double-buffered
//      k-contiguous tile one step ahead of its use, ldmatrix A and B
//      fragments, mma.sync m16n8k32, one __syncthreads per step, each
//      thread's offsets worked out once per stream; the stream runs across
//      N tiles, so the next tile's loads overlap this tile's epilogue.  The
//      epilogue (dequantize, IDCT, bias, act(g)*u or act(u)) runs on a
//      64x64 f32 half tile in shared memory, the IDCT a fast 64-point
//      DCT-III (idct64.cuh: the even and odd halves of a row, two threads,
//      ~10 operations an output against the dense product's 128), and
//      writes the f32 hidden to the block's scratch slice in device memory;
//   3. the hidden row pass, two rows at a time in registers, 128 threads a
//      row (the group butterfly in the reference's stage order, then H_128;
//      IEEE division, rintf, the 1e-8 floor, NaN kept), into the int8
//      hidden in scratch;
//   4. the down projection: the same stream, with the int8 hidden's A tile
//      streamed through the ring beside the weights.
// The prologue rows, the stream and the epilogue are fused_rows.cuh's
// (prologue_tile, pc_stream, pc_epilogue, finish_half), shared with
// fused_matmul.cu; moving them there kept this kernel's time (PERF.md,
// the findings on fused_matmul's redesign).
// Shared memory: the union region (64 x D int8 input, hidden row buffers,
// A slots), the ring (16 KB), the unpacked weights (2 x 8 KB), the half
// tile (16 KB) and the row scales: 115,200 B at vggt-1b, which leaves room
// for two blocks per SM, so one block's row passes and epilogues can run
// beside the other's tensor-core work.  A row buffer spans the union and
// the rest, so rows up to 57,984 floats (D and d_ff) fit.
//
// The hidden stays in device memory: 64 rows x 4096 f32 are 1 MiB per
// tile, and even 16 rows (256 KB) exceed the 227 KB a block may use; the
// scratch (grid x 64 x 4096 f32 + int8) misses the 50 MB L2, so the f32
// hidden makes an HBM round trip, ~540 MB a launch.  Keeping it on chip
// needs an 8-CTA cluster holding 128 KB of it per CTA in distributed
// shared memory: later work.
//
// Measured (an H100 at 700 W; PERF.md, the findings on this redesign,
// through tools/time_kernel_sources.py): about half of the time of the
// previous kernel (commit 5aeb387) at the served shape, at ~13x the bound.
// Of that kernel's time the two matmul loops took 80%, the dense IDCT 11%,
// the row pass 4%.  Here the two
// streams take most of it: ~200 instructions a warp issue per 64-deep step
// for 16 mma.sync (the SASS), so the steps are bound by instruction issue,
// not by loads (not waiting on cp.async changes nothing) nor by the tensor
// cores.  wgmma, fed by TMA, is the step that removes that issue work.
#include "fused_rows.cuh"

namespace {

using namespace vq;

constexpr int BM = FT_BM;  // rows per M tile
constexpr int THREADS = FT_THREADS;
constexpr int WARPS = FT_WARPS;
constexpr int FIXED = PC_SPARE + 2 * BM * 4;  // + input and hidden row scales

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
  int idct_h, idct_out, act, mid_wht, a_mid;
  float* out;
  int8_t* sq;  // scratch: grid x 64 x max(D, F) int8 (the streamed input, the int8 hidden)
  float* sh;   // scratch: grid x 64 x F f32 hidden
  int M, D, F, NO;
};

// Shared memory at widths D, F: the union region (the int8 input tile when
// it is resident, then the hidden row buffers, then the A slots) and the
// warps that get row buffers.  A row buffer may span the union and PC_SPARE,
// which are both free during the row passes, except that a resident input
// tile leaves the prologue only PC_SPARE.
struct Plan {
  int ares;    // the int8 input tile stays in shared memory (else it is streamed)
  int u;       // union bytes
  int hwarps;  // warps with a hidden row buffer (over the union and PC_SPARE)
  int pwarps;  // warps with a prologue row buffer
  int bytes;   // dynamic shared memory
};

__host__ __device__ inline Plan plan_for(int D, int F) {
  Plan pl;
  int u = PC_NST * PC_ASLOT;                 // the A slots
  if (u < F * 4 - PC_SPARE) u = F * 4 - PC_SPARE;  // one hidden row buffer
  pl.ares = round128(u > BM * D ? u : BM * D) + FIXED <= FT_SMEM_CAP;
  if (pl.ares) {
    if (u < BM * D) u = BM * D;
  } else if (u < D * 4 - PC_SPARE) {
    u = D * 4 - PC_SPARE;  // one prologue row buffer
  }
  pl.u = round128(u);
  pl.hwarps = (pl.u + PC_SPARE) / (F * 4);
  if (pl.hwarps > WARPS) pl.hwarps = WARPS;
  pl.pwarps = (pl.ares ? PC_SPARE : pl.u + PC_SPARE) / (D * 4);
  if (pl.pwarps > WARPS) pl.pwarps = WARPS;
  pl.bytes = pl.u + FIXED;
  return pl;
}

struct Tile {
  int m0, rows;
  int8_t* sq;  // this block's scratch slices
  float* sh;
};

// The matrix of a stream.
struct Job {
  const uint8_t* w;
  const float* ws;
  const float* bias;
  int packed, kind;
};

// ---------------------------------------------------------------------------
// phases 2 and 4: one stream of weight steps over all N tiles of a matrix
// ---------------------------------------------------------------------------
//
// The stream (fused_rows.cuh: pc_stream) of one matrix, each N tile's
// epilogue to the hidden (gate, up) or the output (down).  ASTREAM streams
// the A tile (the int8 hidden, or a wide int8 input) from the block's
// scratch slice beside the weights; otherwise A is the resident input
// tile.  A gated FFN runs the gate's stream (which stores act(g)), then
// the up stream (which scales it by u), each with one packing throughout.
template <bool PACKED, bool ASTREAM>
__device__ void stream(const Params& p, const Plan& pl, unsigned char* smem, float* Y,
                       const float* sx, const Tile& t, const Job& job) {
  const bool down = job.kind == KIND_DOWN;
  const int K = down ? p.F : p.D, N = down ? p.NO : p.F;
  const bool idct = down ? p.idct_out : p.idct_h;
  float* dst = down ? p.out + (size_t)t.m0 * p.NO : t.sh;
  const int ld = down ? p.NO : p.F;
  const bool gated = p.wg != nullptr;
  pc_stream<PACKED, ASTREAM>(job.w, K, N, smem + pl.u, reinterpret_cast<int8_t*>(smem), t.sq,
                             t.rows, [&](const int (&acc)[2][4][4], int n0) {
                               pc_epilogue(acc, sx, job.ws, job.bias, N, n0, idct, job.kind,
                                           p.act, gated, dst, ld, t.rows, Y);
                             });
}

__device__ __forceinline__ void run_stream(const Params& p, const Plan& pl, unsigned char* smem,
                                           float* Y, const float* sx, const Tile& t,
                                           const Job& job) {
  if (job.kind == KIND_DOWN || !pl.ares) {
    if (job.packed) stream<true, true>(p, pl, smem, Y, sx, t, job);
    else stream<false, true>(p, pl, smem, Y, sx, t, job);
  } else {
    if (job.packed) stream<true, false>(p, pl, smem, Y, sx, t, job);
    else stream<false, false>(p, pl, smem, Y, sx, t, job);
  }
}

// The streams of one projection: gate (when gated) then up, or down.
template <bool DOWN>
__device__ void project(const Params& p, const Plan& pl, unsigned char* smem, float* Y,
                        const float* sx, const Tile& t) {
  if (DOWN) {
    const Job down = {p.wd, p.wds, p.bd, p.packed_d, KIND_DOWN};
    run_stream(p, pl, smem, Y, sx, t, down);
    return;
  }
  if (p.wg != nullptr) {
    const Job gate = {p.wg, p.wgs, p.bg, p.packed_g, KIND_GATE};
    run_stream(p, pl, smem, Y, sx, t, gate);
    __syncthreads();  // the gate stream's slots and tiles are consumed
  }
  const Job up = {p.wu, p.wus, p.bu, p.packed_u, KIND_UP};
  run_stream(p, pl, smem, Y, sx, t, up);
}

// ---------------------------------------------------------------------------
// phase 3: the hidden row pass (blocked WHT + requantization)
// ---------------------------------------------------------------------------
//
// Rows of F = G * 128 floats, G <= 32 (every width the model serves): two
// rows at a time, 128 threads a row, the row in registers.  Thread c holds
// element g*128 + c of every group g and runs the butterfly across groups
// there, stage by stage in the reference's order (group strides 1, 2, 4,
// ...); one pass through shared memory regroups the row so that each
// thread holds 32 consecutive elements of one group, which take the H_128
// butterfly in registers (strides 1-16) and across the thread's three
// neighbours (strides 32 and 64, by shuffles); then wht_row's scaling, the
// row's amax over its four warps, and the requantization (IEEE division,
// rintf, the 1e-8 floor, NaN kept) straight to the int8 hidden.  Other
// widths take one warp a row (load_row, wht_row, quant_row), each of the
// first hwarps warps with a row buffer over the union region and PC_SPARE.

// float i of a regrouped row: 16-byte chunk k = i / 4 at k ^ (k / 8 % 8), so
// that the column writes and the 16-byte group reads are conflict-free
__device__ __forceinline__ int g_sw(int i) { return i ^ ((i >> 3) & 0x1c); }

__device__ void hidden_rows_reg(const Params& p, float* smem_f, float* hs, const Tile& t) {
  const int tid = threadIdx.x, lane = tid & 31, half = tid >> 7, c = tid & 127;
  const int F = p.F, G = F >> 7, block = p.mid_wht;
  const int bc = block == 0 ? 1 : (block < 128 ? block : 128);  // H_bc inside a group
  const int gb = block > 128 ? block >> 7 : 1;                  // groups a WHT block spans
  const float hc = (float)(1.0 / sqrt((double)bc));
  const float gs = block >= 128 ? (float)(1.0 / sqrt((double)(block / 128))) : 1.f;
  const float qmax = (float)((1 << (p.a_mid - 1)) - 1);
  float* rb = smem_f + half * F;
  float* red = smem_f + 2 * F;  // [2 rows][4 warps]: amax, then 1 for a NaN
  const int g2 = c >> 2, sub = c & 3;  // regrouped: group g2, elements sub*32..
  for (int r0 = 0; r0 < t.rows; r0 += 2) {
    const int r = r0 + half;
    const bool live = r < t.rows;
    float v[32];
    if (live) {
      const float* src = t.sh + (size_t)r * F + c;
#pragma unroll
      for (int g = 0; g < 32; ++g)
        if (g < G) v[g] = src[g * 128];
#pragma unroll
      for (int hh = 0; hh < 5; ++hh) {  // across groups, in the reference's order
        const int h = 1 << hh;
        if (h < gb) {
#pragma unroll
          for (int g = 0; g < 32; ++g) {
            if (!(g & h) && g + h < 32 && g + h < G) {
              const float a = v[g], b = v[g + h];
              v[g] = a + b;
              v[g + h] = a - b;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 32; ++g)
        if (g < G) rb[g_sw(g * 128 + c)] = v[g];
    }
    __syncthreads();
    const bool mine = live && g2 < G;  // a thread of the regrouped row
    float amax = 0.f;
    bool bad = false;
    if (live) {  // uniform in a warp: the shuffles below need every lane
      const int base = g2 * 128 + sub * 32;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = mine ? *reinterpret_cast<const float4*>(rb + g_sw(base + 4 * i))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int hh = 0; hh < 5; ++hh) {  // H_bc: strides 1-16 in registers
        const int h = 1 << hh;
        if (h < bc) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (!(e & h)) {
              const float a = v[e], b = v[e + h];
              v[e] = a + b;
              v[e + h] = a - b;
            }
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // strides 32, 64: the neighbours sub ^ 1, sub ^ 2
        const int h = 1 << hh;
        if (32 * h < bc) {
          const bool hi = sub & h;
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float o = __shfl_xor_sync(0xffffffffu, v[e], h);
            v[e] = hi ? o - v[e] : v[e] + o;
          }
        }
      }
      if (block > 0) {  // wht_row's scaling: H_bc's, then the groups'
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          v[e] *= hc;
          if (block >= 128) v[e] *= gs;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        amax = fmaxf(amax, fabsf(v[e]));
        bad |= v[e] != v[e];
      }
    }
    amax = warp_max(amax);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      red[half * 4 + ((tid >> 5) & 3)] = amax;
      red[8 + half * 4 + ((tid >> 5) & 3)] = bad ? 1.f : 0.f;
    }
    __syncthreads();
    if (mine) {
      float m = 0.f, nan = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        m = fmaxf(m, red[half * 4 + w]);
        nan = fmaxf(nan, red[8 + half * 4 + w]);
      }
      if (nan > 0.f) m = __int_as_float(0x7fc00000);
      const float scale = fmaxf(m, 1e-8f) / qmax;
      const float sc = m != m ? m : scale;  // fmaxf would drop the NaN
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = q8(v[4 * i], sc, qmax) | (q8(v[4 * i + 1], sc, qmax) << 8) |
               (q8(v[4 * i + 2], sc, qmax) << 16) | (q8(v[4 * i + 3], sc, qmax) << 24);
      uint4* dst = reinterpret_cast<uint4*>(t.sq + (size_t)r * F + g2 * 128 + sub * 32);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      if (c == 0) hs[r] = sc;
    }
    __syncthreads();  // the row buffers and the reduction are read
  }
}

__device__ void hidden_rows(const Params& p, const Plan& pl, float* smem_f, float* hs,
                            const Tile& t) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int F = p.F;
  for (int r = t.rows + tid; r < BM; r += THREADS) hs[r] = 0.f;
  if (F % 128 == 0 && F <= 32 * 128) {
    hidden_rows_reg(p, smem_f, hs, t);
    return;
  }
  if (warp < pl.hwarps) {
    float* buf = smem_f + warp * F;
    for (int r = warp; r < t.rows; r += pl.hwarps) {
      __syncwarp();  // the buffer's previous row is consumed
      load_row(buf, t.sh + (size_t)r * F, F, lane);
      if (p.mid_wht > 0) wht_row(buf, F, p.mid_wht, lane);
      quant_row(buf, F, p.a_mid, t.sq + (size_t)r * F, hs + r, lane);
    }
  }
  __syncthreads();  // the int8 hidden and its scales are written
}

__global__ void __launch_bounds__(THREADS, 2) fused_ffn_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan pl = plan_for(p.D, p.F);
  float* Y = reinterpret_cast<float*>(smem + pl.u + PC_NST * PC_RAW + 2 * PC_BU);
  float* xs = Y + BM * PC_YH;
  float* hs = xs + BM;
  const int tiles = (p.M + BM - 1) / BM;
  const size_t wq = p.D > p.F ? p.D : p.F;
  Tile t;
  t.sq = p.sq + (size_t)blockIdx.x * BM * wq;
  t.sh = p.sh + (size_t)blockIdx.x * BM * p.F;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    t.m0 = tile * BM;
    t.rows = min(BM, p.M - t.m0);
    __syncthreads();  // the previous tile is done with every region
    prologue_tile(p.x + (size_t)t.m0 * p.D, p.D, t.rows, p.norm, p.u, p.eps, p.pro_wht, p.a_in,
                  pl.pwarps, pl.ares, reinterpret_cast<int8_t*>(smem),
                  reinterpret_cast<float*>(smem + (pl.ares ? pl.u : 0)), t.sq, xs);  // phase 1
    __syncthreads();
    project<false>(p, pl, smem, Y, xs, t);
    __syncthreads();  // the hidden tile is written; the int8 input is dead
    hidden_rows(p, pl, reinterpret_cast<float*>(smem), hs, t);
    project<true>(p, pl, smem, Y, hs, t);
  }
}

int check_plan(int D, int F, Plan* pl) {
  *pl = plan_for(D, F);
  return pl->pwarps < 1 || pl->hwarps < 1 || pl->bytes > FT_SMEM_CAP
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// Blocks of fused_ffn_kernel one SM holds at once at these widths (`idct`
// does not change them).  Returns a cudaError_t.
extern "C" int vq_fused_ffn_blocks_per_sm(int D, int F, int idct, int* blocks) {
  (void)idct;
  Plan pl;
  const int e = check_plan(D, F, &pl);
  return e != 0 ? e : ft_resident_blocks(fused_ffn_kernel, pl.bytes, blocks);
}

// The kernel's resources at these widths: out[0] registers per thread,
// out[1] shared memory per block in bytes, out[2] resident blocks per SM,
// out[3] spilled bytes per thread.  Returns a cudaError_t.
extern "C" int vq_fused_ffn_attrs(int D, int F, int idct, int* out) {
  (void)idct;
  Plan pl;
  int e = check_plan(D, F, &pl);
  if (e == 0) e = ft_resident_blocks(fused_ffn_kernel, pl.bytes, &out[2]);
  cudaFuncAttributes a;
  if (e == 0) e = static_cast<int>(cudaFuncGetAttributes(&a, fused_ffn_kernel));
  if (e != 0) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes) + pl.bytes;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// C entry point (ctypes).  wg/wgs/bg are null for a plain FFN; u and biases
// null where unused.  Requires D, F % 16 == 0 (% 32 for packed weights on
// that input), F, NO % 4 == 0 (% 64 with the IDCT) and 16-byte aligned
// rows; the Python wrapper checks these and sizes the scratch for `grid`
// blocks, at most the resident ones.  Widths whose row buffer exceeds a
// block's shared memory (D or F above 57,984) return cudaErrorInvalidValue.
// Returns cudaGetLastError().
extern "C" int vq_fused_ffn(const void* x, const void* u, float eps, int norm, int pro_wht,
                            int a_in, const void* wg, const void* wgs, const void* bg,
                            const void* wu, const void* wus, const void* bu, const void* wd,
                            const void* wds, const void* bd, int packed_g, int packed_u,
                            int packed_d, int idct_h, int idct_out, int act, int mid_wht,
                            int a_mid, void* out, void* sq, void* sh, int M, int D, int F, int NO,
                            int grid, void* stream) {
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
  p.idct_h = idct_h;
  p.idct_out = idct_out;
  p.act = act;
  p.mid_wht = mid_wht;
  p.a_mid = a_mid;
  p.out = static_cast<float*>(out);
  p.sq = static_cast<int8_t*>(sq);
  p.sh = static_cast<float*>(sh);
  p.M = M;
  p.D = D;
  p.F = F;
  p.NO = NO;
  Plan pl;
  const int e0 = check_plan(D, F, &pl);
  if (e0 != 0) return e0;
  cudaError_t e =
      cudaFuncSetAttribute(fused_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_ffn_kernel<<<grid, THREADS, pl.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
