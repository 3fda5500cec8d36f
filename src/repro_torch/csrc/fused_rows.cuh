// Device building blocks of the unified-datapath kernels (sm_90a), each
// written once and shared by fused_matmul.cu, fused_ffn.cu, norm_quant.cu
// and wht.cu.  They are the counterparts of the in-kernel helpers of
// repro/kernels/fused.py:
//
//   norm_row   <- _norm_rows   folded-norm statistics (rms | ln via u)
//   wht_row    <- _wht_rows    blocked WHT: butterfly across the 128-wide
//                              groups, then H_128 (here as a butterfly too)
//   quant_row  <- _quant_rows  per-token symmetric quantization
//   ft_outputs <- _idct_rows   block IDCT (64x64 D) + bias on an output tile
//   ft_gemm    <- _int_dot     int8 x (int8 | packed int4) -> int32
//   pc_*       <- _int_dot     the same product as a pipelined core: a
//                              cp.async ring, weights unpacked in shared
//                              memory, ldmatrix fragments (fused_ffn.cu)
//   idct64_*   <- _idct_rows   the block IDCT as a fast 64-point DCT-III in
//                              two halves of a row (idct64.cuh, generated;
//                              fused_ffn.cu)
//
// Row routines work on one row at a time, one warp per row, on a float row
// buffer in shared memory (width W, W % 4 == 0): a lane owns the 4-float
// chunks at 4*lane + 128*j for the element-wise and reduction steps; the
// butterfly passes use their own pairing, with __syncwarp between passes.
//
// Numerics kept from the reference (they decide int8 outputs):
//   * quantization: scale = max(amax, 1e-8) / qmax, q = clamp(rint(x/scale))
//     with IEEE division (the build has no fast math) and half-to-even
//     rounding (rintf); a NaN in the row makes the scale NaN, as in
//     jnp.max, so non-finite inputs stay non-finite downstream;
//   * LayerNorm: mu = sum(x*u), var = mean(x*x) - mu*mu,
//     y = (x - mu*u*W) * (1/sqrt(var + eps)); rms: x * (1/sqrt(mean(x*x)+eps))
//     (1/sqrtf, correctly rounded, rather than the approximate rsqrtf);
//   * WHT: the group butterfly runs first, stage by stage in the
//     reference's order, so it is bit-identical to the plain version; the
//     H_128 factor is a butterfly scaled by fl(1/sqrt(128)) where the
//     reference takes a dot with the +-fl(1/sqrt(128)) matrix (same value,
//     rounded differently in the last bits), then fl(1/sqrt(g)).
//   Sums (norm statistics, IDCT dot products, the H_128 factor) run in
//   another order than the plain version's, so a requantized value can
//   differ by one step where x/scale lies within an ulp of a half.
#pragma once

#include <math.h>

#include "idct64.cuh"
#include "mma_s8.cuh"

namespace vq {

constexpr int FT_BM = 64;        // rows per M tile
constexpr int FT_BN = TILE_BN;            // output columns per N tile
constexpr int FT_BK = TILE_BK;            // K columns (original K index) per matmul step
constexpr int FT_THREADS = TILE_THREADS;  // 8 warps: 2 (M) x 4 (N), 32x32 outputs each
constexpr int FT_WARPS = FT_THREADS / 32;
constexpr int FT_LDS = TILE_LDS;          // int8 tile row stride in bytes
constexpr int FT_LDY = FT_BN + 4;   // f32 output tile row stride in floats
constexpr int DCT_B = 64;           // IDCT block

// shared-memory bytes of the matmul phase: staged A and B tiles + f32 tile
constexpr int FT_GEMM_SMEM = FT_BM * FT_LDS + FT_BN * FT_LDS + FT_BM * FT_LDY * 4;
constexpr int FT_DCT_SMEM = DCT_B * DCT_B * 4;
constexpr int FT_SMEM_CAP = 227 * 1024;

enum { NORM_NONE = 0, NORM_RMS = 1, NORM_LN = 2 };
enum { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2 };

// ---------------------------------------------------------------------------
// warp reductions and element-wise helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh GELU in PyTorch's order (F.gelu(approximate="tanh")), and SiLU
__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == ACT_GELU) {
    const float k_beta = (float)(1.4142135623730951 * 1.1283791670955126 * 0.5);
    const float k_kappa = 0.044715f;
    const float inner = k_beta * (x + k_kappa * (x * x * x));
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  if (act == ACT_SILU) return x / (1.0f + expf(-x));
  return x;
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// ---------------------------------------------------------------------------
// row routines (one warp, row buffer in shared memory)
// ---------------------------------------------------------------------------

// global f32 row -> row buffer (16-byte aligned, W % 4 == 0)
__device__ __forceinline__ void load_row(float* buf, const float* src, int W, int lane) {
  for (int i = 4 * lane; i < W; i += 128)
    *reinterpret_cast<float4*>(buf + i) = *reinterpret_cast<const float4*>(src + i);
}

__device__ __forceinline__ void store_row(float* dst, const float* buf, int W, int lane) {
  for (int i = 4 * lane; i < W; i += 128)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(buf + i);
}

// FoldedNorm statistics in place (gamma/beta live in the weights).  Touches
// only the lane's own chunks, like load_row.
__device__ void norm_row(float* buf, int W, int kind, const float* __restrict__ u, float eps,
                         int lane) {
  float s2 = 0.f, su = 0.f;
  for (int i = 4 * lane; i < W; i += 128) {
    const float4 v = *reinterpret_cast<const float4*>(buf + i);
    s2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    if (kind == NORM_LN) {
      const float4 w = *reinterpret_cast<const float4*>(u + i);
      su += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
    }
  }
  const float ms = warp_sum(s2) / (float)W;
  if (kind == NORM_RMS) {
    const float inv = 1.0f / sqrtf(ms + eps);
    for (int i = 4 * lane; i < W; i += 128) {
      float4 v = *reinterpret_cast<float4*>(buf + i);
      v.x *= inv; v.y *= inv; v.z *= inv; v.w *= inv;
      *reinterpret_cast<float4*>(buf + i) = v;
    }
    return;
  }
  const float mu = warp_sum(su);
  const float inv = 1.0f / sqrtf((ms - mu * mu) + eps);
  const float wf = (float)W;
  for (int i = 4 * lane; i < W; i += 128) {
    float4 v = *reinterpret_cast<float4*>(buf + i);
    const float4 w = *reinterpret_cast<const float4*>(u + i);
    v.x = (v.x - mu * w.x * wf) * inv;
    v.y = (v.y - mu * w.y * wf) * inv;
    v.z = (v.z - mu * w.z * wf) * inv;
    v.w = (v.w - mu * w.w * wf) * inv;
    *reinterpret_cast<float4*>(buf + i) = v;
  }
}

// R-point butterfly pass: log2(R) consecutive stages of strides s, 2s, ...
// (in that order, as separate radix-2 stages would run them) on the
// elements base + r*s of every R-group of the row.
template <int R>
__device__ __forceinline__ void bfly_pass(float* buf, int W, int ls, int lane) {
  const int s = 1 << ls;
  const int lr = ilog2(R);
  const int n = W / R;
  for (int q = lane; q < n; q += 32) {
    const int base = ((q >> ls) << (ls + lr)) | (q & (s - 1));
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = buf[base + r * s];
#pragma unroll
    for (int h = 1; h < R; h *= 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!(r & h)) {
          const float a = v[r], b = v[r + h];
          v[r] = a + b;
          v[r + h] = a - b;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) buf[base + r * s] = v[r];
  }
}

// `stages` radix-2 stages of strides 2^ls, 2^(ls+1), ... in increasing order
__device__ void bfly_stages(float* buf, int W, int ls, int stages, int lane) {
  while (stages >= 3) {
    __syncwarp();
    bfly_pass<8>(buf, W, ls, lane);
    ls += 3;
    stages -= 3;
  }
  __syncwarp();
  if (stages == 2) bfly_pass<4>(buf, W, ls, lane);
  else if (stages == 1) bfly_pass<2>(buf, W, ls, lane);
  __syncwarp();
}

// Blocked WHT along the row (block a power of two dividing W).
__device__ void wht_row(float* buf, int W, int block, int lane) {
  const int c = block < 128 ? block : 128;
  const int lc = ilog2(c);
  if (block > c) bfly_stages(buf, W, lc, ilog2(block) - lc, lane);  // across groups
  bfly_stages(buf, W, 0, lc, lane);                                  // inside H_c
  const float hc = (float)(1.0 / sqrt((double)c));
  const float gs = block >= 128 ? (float)(1.0 / sqrt((double)(block / 128))) : 1.0f;
  const bool grouped = block >= 128;
  for (int i = 4 * lane; i < W; i += 128) {
    float4 v = *reinterpret_cast<float4*>(buf + i);
    v.x *= hc; v.y *= hc; v.z *= hc; v.w *= hc;
    if (grouped) { v.x *= gs; v.y *= gs; v.z *= gs; v.w *= gs; }
    *reinterpret_cast<float4*>(buf + i) = v;
  }
  __syncwarp();
}

__device__ __forceinline__ uint32_t q8(float v, float scale, float qmax) {
  const float q = fminf(fmaxf(rintf(v / scale), -qmax), qmax);
  return (uint32_t)((int)q & 0xff);
}

// Per-token quantization of a row the warp reads as load4(i), the float4
// at columns i..i+3 (i % 4 == 0): the four int8 values of each float4 go
// to store4(i, word), the scale to *s.
template <typename Load, typename Store>
__device__ __forceinline__ void quant_row_by(Load load4, int W, int bits, Store store4, float* s,
                                             int lane) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  float amax = 0.f;
  bool bad = false;
  for (int i = 4 * lane; i < W; i += 128) {
    const float4 v = load4(i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    bad |= (v.x != v.x) | (v.y != v.y) | (v.z != v.z) | (v.w != v.w);
  }
  amax = warp_max(amax);
  if (__any_sync(0xffffffffu, bad)) amax = __int_as_float(0x7fc00000);
  const float scale = fmaxf(amax, 1e-8f) / qmax;
  const float sc = amax != amax ? amax : scale;  // fmaxf would drop the NaN
  for (int i = 4 * lane; i < W; i += 128) {
    const float4 v = load4(i);
    store4(i, q8(v.x, sc, qmax) | (q8(v.y, sc, qmax) << 8) | (q8(v.z, sc, qmax) << 16) |
                  (q8(v.w, sc, qmax) << 24));
  }
  if (lane == 0) *s = sc;
}

// per-token quantization of the row -> q (int8, 4-byte aligned) and *s
__device__ void quant_row(const float* buf, int W, int bits, int8_t* q, float* s, int lane) {
  quant_row_by([&](int i) { return *reinterpret_cast<const float4*>(buf + i); }, W, bits,
               [&](int i, uint32_t v) { *reinterpret_cast<uint32_t*>(q + i) = v; }, s, lane);
}

// The prologue of one row: f32 input -> folded norm -> WHT -> quantize.
__device__ void prologue_row(const float* src, int W, float* buf, int norm,
                             const float* __restrict__ u, float eps, int wht_block, int bits,
                             int8_t* q, float* s, int lane) {
  __syncwarp();  // the buffer's previous row is consumed
  load_row(buf, src, W, lane);
  if (norm != NORM_NONE) norm_row(buf, W, norm, u, eps, lane);
  if (wht_block > 0) wht_row(buf, W, wht_block, lane);
  quant_row(buf, W, bits, q, s, lane);
}

// ---------------------------------------------------------------------------
// integer matmul tile: 64 rows of A (int8, row stride K) x 128 columns of W
// ---------------------------------------------------------------------------
//
// The staging (packed nibbles sign-extended, 4x4 bytes transposed) is
// mma_s8.cuh's load_tile/store_tile, shared with quant_matmul.cu.

// acc = A[0:64, :] . W[:, n0:n0+128] (rows >= `rows` and columns >= N read
// as zero).  Warp w owns rows 32*(w&1).. and columns 32*(w>>1)..
template <bool PACKED>
__device__ void ft_gemm(int (&acc)[2][4][4], const int8_t* A, int rows, int K,
                        const uint8_t* __restrict__ w, int N, int n0, int8_t* As, int8_t* Bs) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int steps = PACKED ? (K / 2 + 31) / 32 : (K + FT_BK - 1) / FT_BK;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  TileStage<PACKED, FT_BM> st;
  load_tile<PACKED, FT_BM>(st, A, rows, K, w, N, n0, 0, tid);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // the previous step's tiles (or an earlier phase) are consumed
    store_tile<PACKED, FT_BM>(st, As, Bs, tid);
    __syncthreads();
    if (step + 1 < steps) load_tile<PACKED, FT_BM>(st, A, rows, K, w, N, n0, step + 1, tid);
#pragma unroll
    for (int kk = 0; kk < FT_BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = As + (wm + mi * 16 + g) * FT_LDS + kk + 4 * t;
        const int8_t* r1 = r0 + 8 * FT_LDS;
        a[mi][0] = lds32(r0);
        a[mi][1] = lds32(r1);
        a[mi][2] = lds32(r0 + 16);
        a[mi][3] = lds32(r1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* br = Bs + (wn + ni * 8 + g) * FT_LDS + kk + 4 * t;
        const uint32_t b0 = lds32(br), b1 = lds32(br + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_s8_16832(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
  }
}

// Y[r][c] = float(acc) * xs[r] * ws[n0 + c] (zero outside rows / N), in the
// reference's order.  xs is read with plain loads (it may be scratch).
__device__ void ft_scale(const int (&acc)[2][4][4], const float* xs, int rows,
                         const float* __restrict__ ws, int N, int n0, float* Y) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mi * 16 + g + 8 * h;
      const float sx = r < rows ? xs[r] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + 2 * t;
        const int n = n0 + c;
        float2 v = make_float2(0.f, 0.f);
        if (r < rows && n < N) {  // N % 4 == 0, so n + 1 < N too
          v.x = (float)acc[mi][ni][2 * h] * sx * ws[n];
          v.y = (float)acc[mi][ni][2 * h + 1] * sx * ws[n + 1];
        }
        *reinterpret_cast<float2*>(Y + r * FT_LDY + c) = v;
      }
    }
  }
}

// The 32 outputs a thread finalizes from the f32 tile: column c = tid % 64
// of both 64-column blocks, rows tid/64 + 4*j.  Output i sits at row
// ft_row(i), column n0 + ft_col(i).  With `idct`, out = sum_b Y[r][blk*64+b]
// * D[b][c] (D from shared memory); then + bias[n].
__device__ __forceinline__ int ft_row(int i) { return (threadIdx.x >> 6) + 4 * (i & 15); }
__device__ __forceinline__ int ft_col(int i) { return (i >> 4) * DCT_B + (threadIdx.x & 63); }

__device__ void ft_outputs(float (&v)[32], const float* Y, const float* Dsm, bool idct,
                           const float* __restrict__ bias, int N, int n0) {
  const int c = threadIdx.x & 63;
  if (idct) {
    float dc[DCT_B];
#pragma unroll
    for (int b = 0; b < DCT_B; ++b) dc[b] = Dsm[b * DCT_B + c];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float4* yr = reinterpret_cast<const float4*>(Y + ft_row(i) * FT_LDY + (i >> 4) * DCT_B);
      float s = 0.f;
#pragma unroll
      for (int b4 = 0; b4 < DCT_B / 4; ++b4) {
        const float4 y = yr[b4];
        s = fmaf(y.x, dc[4 * b4], s);
        s = fmaf(y.y, dc[4 * b4 + 1], s);
        s = fmaf(y.z, dc[4 * b4 + 2], s);
        s = fmaf(y.w, dc[4 * b4 + 3], s);
      }
      v[i] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = Y[ft_row(i) * FT_LDY + ft_col(i)];
  }
  if (bias != nullptr) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = n0 + ft_col(i);
      if (n < N) v[i] += bias[n];
    }
  }
}

// One projection tile: v = idct?(dequant(A . W[:, n0:n0+128])) + bias.
// Ends with the f32 tile consumed, so the caller may start the next tile.
__device__ void ft_project(float (&v)[32], bool packed, const int8_t* A, const float* xs,
                           int rows, int K, const uint8_t* __restrict__ w,
                           const float* __restrict__ ws, const float* __restrict__ bias, int N,
                           int n0, bool idct, const float* Dsm, int8_t* As, int8_t* Bs,
                           float* Y) {
  int acc[2][4][4];
  if (packed) ft_gemm<true>(acc, A, rows, K, w, N, n0, As, Bs);
  else ft_gemm<false>(acc, A, rows, K, w, N, n0, As, Bs);
  ft_scale(acc, xs, rows, ws, N, n0, Y);
  __syncthreads();
  ft_outputs(v, Y, Dsm, idct, bias, N, n0);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// pipelined int8 core (fused_ffn.cu): cp.async ring, weights unpacked and
// transposed in shared memory, ldmatrix fragments
// ---------------------------------------------------------------------------
//
// A step covers 32 rows of W (packed rows, i.e. 64 original K indices, or
// 32 K rows of int8 W) and 128 columns: 4 KB of raw weight bytes, one
// 16-byte cp.async per thread, zero-filled past K and N.  The raw slot is
// row-major, with the 16-byte chunk c of W row q at chunk c ^ (q/4 % 8),
// so that pc_convert reads it without bank conflicts.  pc_convert turns a
// raw slot into Bu[n][k] (k contiguous, KS bytes a row, nibbles
// sign-extended), and every [rows][KS] tile of the core (Bu, and an A
// tile streamed from device memory) keeps its 16-byte chunk c of row n at
// c ^ pc_swz(n): the eight rows one ldmatrix reads hit eight distinct bank
// groups.  The packed layout is the reference's: packed row p holds K row
// p (low nibble) and K/2 + p (high nibble), so a packed step's local k
// 0..31 are K indices p0.. and its local 32..63 are K/2 + p0..

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the first `bytes` read and the rest zero
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane i addresses row i % 8 of matrix i / 8 and
// receives bytes 4(i%4).. of row i/4 of each (an s8 fragment register)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

constexpr int PC_ROWS = 32;                // W rows per step
constexpr int PC_RAW = PC_ROWS * FT_BN;    // raw weight bytes per step
constexpr int PC_BU = FT_BN * 64;          // Bu bytes (the packed step's)
constexpr int PC_ASLOT = FT_BM * 64;       // a streamed A tile's bytes

template <bool PACKED>
struct PcStep {
  static constexpr int KS = PACKED ? 64 : 32;  // K indices per step (tile row bytes)
  static constexpr int CPR = KS / 16;          // 16-byte chunks per tile row
};

template <bool PACKED>
__device__ __forceinline__ int pc_swz(int n) {
  return PACKED ? (((n >> 1) ^ (n >> 3)) & 3) : ((n >> 2) & 1);
}

// byte offset of (row n, local k) in a swizzled [rows][KS] tile
template <bool PACKED>
__device__ __forceinline__ int pc_off(int n, int k) {
  return n * PcStep<PACKED>::KS + ((((k >> 4) ^ pc_swz<PACKED>(n)) << 4) | (k & 15));
}

// This thread's fixed part of every step, worked out once per stream:
//   loading: its 16-byte chunk of a raw slot (W row q = tid / 8 of the step,
//     columns 16 (tid % 8).. of the N tile) and, for a streamed A tile, its
//     chunk c of row r;
//   pc_convert (kq = tid % 8, nq = tid / 8): its first raw word (W rows
//     4kq.. of columns 4nq..) and where column 4nq + j's four K bytes go in
//     Bu (the high nibbles of a packed step go to that offset ^ 32: chunk
//     c + 2 under the same swizzle);
//   pc_mma: the ldmatrix rows of B, and of A in a streamed A tile.
template <bool PACKED>
struct PcLane {
  static constexpr int KS = PcStep<PACKED>::KS;
  static constexpr int CPR = PcStep<PACKED>::CPR;
  int raw_dst, raw_row, raw_col;
  int a_dst, a_row, a_c;  // a_row >= FT_BM: this thread copies no A chunk
  int cv_rd, cv_wr[4];
  int b_rd[2][KS / 32];
  int a_rd[2][KS / 32];

  __device__ PcLane(int tid, int wm, int wn) {
    const int lane = tid & 31, q = tid >> 3, c = tid & 7;
    raw_dst = q * FT_BN + ((c ^ ((q >> 2) & 7)) << 4);
    raw_row = q;
    raw_col = 16 * c;
    a_row = tid / CPR;
    a_c = tid % CPR;
    a_dst = pc_off<PACKED>(a_row, 16 * a_c);
    const int kq = tid & 7, nq = tid >> 3;
    cv_rd = 4 * kq * FT_BN + (((nq >> 2) ^ kq) << 4) + 4 * (nq & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) cv_wr[j] = pc_off<PACKED>(4 * nq + j, 4 * kq);
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
        b_rd[pp][kk] = pc_off<PACKED>(64 * pp + wn + 8 * (lane >> 4) + (lane & 7),
                                      32 * kk + 16 * ((lane >> 3) & 1));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        a_rd[mi][kk] = pc_off<PACKED>(wm + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1),
                                      32 * kk + 16 * (lane >> 4));
    }
  }
};

// Queue this thread's 16 bytes of raw step `ks` of W (row length N bytes,
// kmax rows: K/2 packed or K) for columns n0.. into a raw slot.  Rows of
// 16-byte multiples copy whole chunks; others (N % 16 != 0) 4-byte words.
template <bool PACKED>
__device__ __forceinline__ void pc_load_raw(uint8_t* slot, const uint8_t* __restrict__ w, int ks,
                                            int kmax, int N, int n0, const PcLane<PACKED>& ln) {
  uint8_t* dst = slot + ln.raw_dst;
  const int row = ks * PC_ROWS + ln.raw_row, col = n0 + ln.raw_col;
  const uint8_t* src = w + (size_t)row * N + col;
  if ((N & 15) == 0) {
    const bool ok = row < kmax && col < N;
    cp16(dst, ok ? src : w, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = row < kmax && col + 4 * i < N;
      cp4(dst + 4 * i, ok ? src + 4 * i : w, ok ? 4 : 0);
    }
  }
}

// Queue step `ks` of a streamed A tile (int8 [rows][K], 64 rows; rows >=
// `rows` and K past its end read as zero) into an A slot.
template <bool PACKED>
__device__ __forceinline__ void pc_load_a(int8_t* slot, const int8_t* A, int rows, int K, int ks,
                                          const PcLane<PACKED>& ln) {
  if (ln.a_row >= FT_BM) return;
  int col;
  bool ok = ln.a_row < rows;
  if (PACKED) {
    const int p = ks * PC_ROWS + 16 * (ln.a_c & 1);
    col = (ln.a_c < 2 ? 0 : K / 2) + p;
    ok = ok && p < K / 2;
  } else {
    col = ks * PC_ROWS + 16 * ln.a_c;
    ok = ok && col < K;
  }
  cp16(slot + ln.a_dst, ok ? A + (size_t)ln.a_row * K + col : A, ok ? 16 : 0);
}

// Raw slot -> Bu: four conflict-free 4-byte reads, a 4x4 byte transpose,
// then per column its four K bytes (and, packed, the four high nibbles),
// sign-extended per byte.
template <bool PACKED>
__device__ __forceinline__ void pc_convert(const uint8_t* slot, int8_t* Bu,
                                           const PcLane<PACKED>& ln) {
  uint32_t w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = *reinterpret_cast<const uint32_t*>(slot + ln.cv_rd + r * FT_BN);
  transpose4x4_bytes(w);  // w[j] = 4 consecutive W rows of column 4nq + j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (PACKED) {
      const uint32_t lo = __vsub4((w[j] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
      const uint32_t hi = __vsub4(((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
      *reinterpret_cast<uint32_t*>(Bu + ln.cv_wr[j]) = lo;
      *reinterpret_cast<uint32_t*>(Bu + (ln.cv_wr[j] ^ 32)) = hi;
    } else {
      *reinterpret_cast<uint32_t*>(Bu + ln.cv_wr[j]) = w[j];
    }
  }
}

// acc += A . Bu over one step.  Warp w owns rows wm = 32 (w % 2).. and
// the 16 columns wn = 16 (w / 2).. of each 64-column half of the tile:
// acc[mi][ni] holds column 64 (ni / 2) + wn + 8 (ni % 2) + 2 (lane % 4),
// so every warp has outputs in both halves.  a_addr(mi, kk) is the
// address of this lane's ldmatrix row of A for rows wm + 16 mi.. and
// local k 32 kk..
template <bool PACKED, typename AAddr>
__device__ __forceinline__ void pc_mma(int (&acc)[2][4][4], AAddr a_addr, const int8_t* Bu,
                                       const PcLane<PACKED>& ln) {
#pragma unroll
  for (int kk = 0; kk < PcStep<PACKED>::KS / 32; ++kk) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) ldsm4(a[mi], a_addr(mi, kk));
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) ldsm4(b[pp], Bu + ln.b_rd[pp][kk]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8_16832(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[ni >> 1][2 * (ni & 1)],
                     b[ni >> 1][2 * (ni & 1) + 1]);
  }
}

// Dynamic shared memory of a fused kernel whose row passes are `row_w`
// floats wide: [D (if idct)] + union(matmul tiles, row buffers).  Sets
// *row_warps to the warps that run row passes (all 8, or fewer for very
// wide rows); returns -1 when not even one row buffer fits.
inline int ft_smem_bytes(int row_w, bool idct, int* row_warps) {
  const int fixed = idct ? FT_DCT_SMEM : 0;
  int rw = FT_WARPS;
  while (rw > 0 && fixed + rw * row_w * 4 > FT_SMEM_CAP) --rw;
  *row_warps = rw;
  if (rw == 0) return -1;
  const int rows = rw * row_w * 4;
  return fixed + (rows > FT_GEMM_SMEM ? rows : FT_GEMM_SMEM);
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory and write how
// many of its blocks one SM holds at once to *blocks.  The wrappers size
// the persistent grid, and with it the scratch, by this number times the
// SM count.  Returns a cudaError_t.
template <typename Kernel>
inline int ft_resident_blocks(Kernel kernel, int smem, int* blocks) {
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, FT_THREADS, smem));
}

}  // namespace vq
