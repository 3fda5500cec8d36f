// Device building blocks of the unified-datapath kernels (sm_90a), each
// written once and shared by fused_matmul.cu, fused_ffn.cu, norm_quant.cu
// and wht.cu.  They are the counterparts of the in-kernel helpers of
// repro/kernels/fused.py:
//
//   norm_row   <- _norm_rows   folded-norm statistics (rms | ln via u)
//   wht_row    <- _wht_rows    blocked WHT: butterfly across the 128-wide
//                              groups, then H_128 (here as a butterfly too)
//   quant_row  <- _quant_rows  per-token symmetric quantization
//   prologue_tile              the three above over a 64-row tile, into a
//                              resident int8 tile or a scratch slice
//   pc_*       <- _int_dot     int8 x (int8 | packed int4) -> int32 as a
//                              pipelined core: a cp.async ring, weights
//                              unpacked in shared memory, ldmatrix
//                              fragments, one stream over all N tiles
//                              (pc_stream)
//   finish_half <- _idct_rows  dequantized 64x64 half tile -> block IDCT as
//                              a fast 64-point DCT-III (idct64.cuh,
//                              generated) -> bias -> activation / gate
//
// fused_matmul.cu and fused_ffn.cu both run their projections through
// pc_stream and pc_epilogue.
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

constexpr int FT_BM = 64;                 // rows per M tile
constexpr int FT_BN = 128;                // output columns per N tile
constexpr int FT_THREADS = 256;           // 8 warps: 2 (M) x 4 (N)
constexpr int FT_WARPS = FT_THREADS / 32;
constexpr int DCT_B = 64;                 // IDCT block
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
// pipelined int8 core: cp.async ring, weights unpacked and transposed in
// shared memory, ldmatrix fragments
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

// ---------------------------------------------------------------------------
// a 64-row tile through the core: resident input tile, one stream of weight
// steps over all N tiles, the epilogue of each N tile
// ---------------------------------------------------------------------------
//
// Shared memory of a kernel that runs the core (fused_matmul.cu,
// fused_ffn.cu): a union region at offset 0 (the int8 input tile when it is
// resident, else the A slots, and the row buffers of row passes), then
// PC_SPARE: the ring, the unpacked weights and the f32 half tile, which
// prologue row buffers may use before a stream starts.

constexpr int PC_NST = 4;         // ring slots
constexpr int PC_YH = DCT_B;      // columns of the f32 half tile: one IDCT block
constexpr int PC_SPARE = PC_NST * PC_RAW + 2 * PC_BU + FT_BM * PC_YH * 4;

// what finish_half does with an output value v (after the bias):
//   KIND_GATE, or KIND_UP without a gate: store act(v) (fused_matmul's output)
//   KIND_UP with a gate: scale the stored act(g) by v
//   KIND_DOWN: store v
enum Kind { KIND_GATE = 0, KIND_UP = 1, KIND_DOWN = 2 };

__host__ __device__ inline int round128(int b) { return (b + 127) & ~127; }

// 16-byte chunk c of row r of a resident input tile (cpr chunks a row),
// XOR-swizzled within each whole group of 8 chunks
__device__ __forceinline__ int a_swz(int c, int r, int cpr) {
  return (c | 7) < cpr ? c ^ (r & 7) : c;
}

// float (r, c) of the f32 half tile, its float4 groups swizzled by row
__device__ __forceinline__ int y_off(int r, int c) {
  return r * PC_YH + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// Prologue rows of the 64-row tile at x (rows of W floats), one warp a row,
// warps < pwarps, each with the row buffer bufs + warp * W: f32 row ->
// folded norm -> WHT -> per-token quantization into the resident tile As
// (`ares`) or the scratch slice sq; the scales to xs, 0 past `rows`.
__device__ void prologue_tile(const float* __restrict__ x, int W, int rows, int norm,
                              const float* __restrict__ u, float eps, int wht, int bits,
                              int pwarps, bool ares, int8_t* As, float* bufs, int8_t* sq,
                              float* xs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cpr = W >> 4;
  for (int r = rows + tid; r < FT_BM; r += FT_THREADS) xs[r] = 0.f;
  if (warp >= pwarps) return;
  float* buf = bufs + warp * W;
  for (int r = warp; r < rows; r += pwarps) {
    __syncwarp();  // the buffer's previous row is consumed
    load_row(buf, x + (size_t)r * W, W, lane);
    if (norm != NORM_NONE) norm_row(buf, W, norm, u, eps, lane);
    if (wht > 0) wht_row(buf, W, wht, lane);
    if (!ares) {
      quant_row(buf, W, bits, sq + (size_t)r * W, xs + r, lane);
      continue;
    }
    int8_t* q = As + r * W;
    quant_row_by([&](int i) { return *reinterpret_cast<const float4*>(buf + i); }, W, bits,
                 [&](int i, uint32_t w) {
                   *reinterpret_cast<uint32_t*>(q + (a_swz(i >> 4, r, cpr) << 4) + (i & 15)) = w;
                 },
                 xs + r, lane);
  }
}

// Epilogue of one N tile: dequantize -> IDCT -> bias -> act / gate / store.
//
// Two 64-column halves in turn: every warp writes its dequantized
// accumulators of the half to the half tile; then finish_half.  With the
// IDCT, threads 0-63 turn the even inputs of row t into E (idct64_even)
// and threads 64-127 the odd ones into O (idct64_odd), in place; then
// thread t finalizes the columns nn, 31-nn, 32+nn, 63-nn (nn = t % 16) of
// rows t/16 + 16i, i < 4: y[n] = E[n] + O[n], y[63-n] = E[n] - O[n].  The
// same thread writes a gate value and later scales it by the up value.
// finish_half is one out-of-line copy with rolled loops: its straight-line
// code runs once per N tile, and unrolled and inlined into every stream it
// overflowed the instruction cache.

// outputs of one half tile to dst rows of ld floats, columns c0.. (kind:
// what is stored, see Kind)
__device__ __noinline__ void finish_half(float* Y, bool idct, const float* __restrict__ bias,
                                         int kind, int act, bool gated, float* dst, int ld,
                                         int rows, int c0, int N) {
  const int tid = threadIdx.x, nn = tid & 15, rs = tid >> 4;
  if (idct) {
    const int r = tid & 63, odd = (tid >> 6) & 1;
    float* yr = Y + r * PC_YH;
    const int sw = r & 7;
    float v[32];
    if (tid < 2 * PC_YH) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {  // x[4q..4q+3]: the even or the odd two
        const float4 x = *reinterpret_cast<const float4*>(yr + ((q ^ sw) << 2));
        v[2 * q] = odd ? x.y : x.x;
        v[2 * q + 1] = odd ? x.w : x.z;
      }
    }
    __syncthreads();  // the row is read before either half overwrites it
    if (tid < 2 * PC_YH) {
      if (odd) idct64_odd(v);
      else idct64_even(v);
#pragma unroll
      for (int q = 0; q < 8; ++q)  // E to columns 0-31, O to 32-63
        *reinterpret_cast<float4*>(yr + (((8 * odd + q) ^ sw) << 2)) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int r = rs + 16 * i;
    if (r >= rows) break;
    float vals[4];  // columns nn, 31-nn, 32+nn, 63-nn
    const float a = Y[y_off(r, nn)], b = Y[y_off(r, 31 - nn)];
    const float c = Y[y_off(r, 32 + nn)], d = Y[y_off(r, 63 - nn)];
    if (idct) {  // a = E[nn], b = E[31-nn], c = O[nn], d = O[31-nn]
      vals[0] = a + c;
      vals[1] = b + d;
      vals[2] = b - d;
      vals[3] = a - c;
    } else {
      vals[0] = a;
      vals[1] = b;
      vals[2] = c;
      vals[3] = d;
    }
    const int cols[4] = {nn, 31 - nn, 32 + nn, 63 - nn};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = c0 + cols[e];
      if (n >= N) continue;
      float v = vals[e];
      if (bias != nullptr) v += bias[n];
      float* o = dst + (size_t)r * ld + n;
      if (kind == KIND_DOWN) *o = v;
      else if (kind == KIND_GATE) *o = act_fn(v, act);
      else *o = gated ? *o * v : act_fn(v, act);
    }
  }
}

// The epilogue of the N tile at column n0: sx the tile's row scales, ws
// the weight scales, dst row 0 of the tile's output (row stride ld).
__device__ __forceinline__ void pc_epilogue(const int (&acc)[2][4][4], const float* sx,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ bias, int N, int n0,
                                            bool idct, int kind, int act, bool gated, float* dst,
                                            int ld, int rows, float* Y) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = n0 + PC_YH * h;  // first output column of this half
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm + 16 * mi + g + 8 * hh;
        const float s = sx[r];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int ni = 2 * h + nj;
          const int c = wn + 8 * nj + 2 * tq, n = c0 + c;
          float2 v = make_float2(0.f, 0.f);
          if (n < N) {  // N % 4 == 0, so n + 1 < N too
            v.x = (float)acc[mi][ni][2 * hh] * s * ws[n];
            v.y = (float)acc[mi][ni][2 * hh + 1] * s * ws[n + 1];
          }
          *reinterpret_cast<float2*>(Y + y_off(r, c)) = v;
        }
      }
    __syncthreads();
    if (c0 < N) finish_half(Y, idct, bias, kind, act, gated, dst, ld, rows, c0, N);
    if (h == 0) __syncthreads();  // the half tile is read; the other half may be written
  }
}

// One stream of weight steps over all N tiles of a [K, N] weight w (packed
// [K/2, N] or int8 [K, N]) for the 64-row A tile: `ring` is the ring and
// the unpacked weights (PC_NST raw slots, then two Bu buffers), As the
// resident input tile (row stride K, chunks swizzled by a_swz) or, with
// ASTREAM, the A slots that the tile at a_src (int8, row stride K, `rows`
// rows) streams through beside the weights.  After an N tile's last step,
// epi(acc, n0).
//
// Step s: wait until step s+1 has landed, one __syncthreads (step s+1's
// bytes and step s's unpacked weights are visible; everyone is done with
// step s-1), queue step s+3 into the slot step s-1 held, unpack step s+1
// into the other weight buffer, multiply step s.  The stream runs across
// N tiles, so the next tile's loads overlap this tile's epilogue.  Ends
// with every cp.async landed; the caller syncs before reusing the regions.
template <bool PACKED, bool ASTREAM, typename Epi>
__device__ void pc_stream(const uint8_t* __restrict__ w, int K, int N, unsigned char* ring,
                          int8_t* As, const int8_t* a_src, int rows, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
  const int kmax = PACKED ? K / 2 : K;  // W rows
  const int spj = (kmax + PC_ROWS - 1) / PC_ROWS;  // steps per N tile
  const int S = spj * ((N + FT_BN - 1) / FT_BN);
  uint8_t* raw = ring;
  int8_t* Bu = reinterpret_cast<int8_t*>(raw + PC_NST * PC_RAW);
  const PcLane<PACKED> ln(tid, wm, wn);

  int lk = 0, ln0 = 0, ls = 0;  // loader: step in its N tile, that tile's n0, steps queued
  auto enqueue = [&]() {
    if (ls < S) {
      pc_load_raw<PACKED>(raw + (ls & (PC_NST - 1)) * PC_RAW, w, lk, kmax, N, ln0, ln);
      if (ASTREAM) pc_load_a<PACKED>(As + (ls & (PC_NST - 1)) * PC_ASLOT, a_src, rows, K, lk, ln);
      if (++lk == spj) {
        lk = 0;
        ln0 += FT_BN;
      }
    }
    cp_commit();
    ++ls;
  };
  auto convert = [&](int s) {
    pc_convert<PACKED>(raw + (s & (PC_NST - 1)) * PC_RAW, Bu + (s & 1) * PC_BU, ln);
  };

  // the resident tile's A rows of this lane: row offset and swizzle
  const int cpr = K >> 4;
  int arow[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) arow[mi] = wm + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1);

  for (int i = 0; i < PC_NST - 1; ++i) enqueue();
  cp_wait<PC_NST - 2>();
  __syncthreads();
  convert(0);
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  int mk = 0, mn0 = 0;  // consumer: step in its N tile, that tile's n0
  for (int s = 0; s < S; ++s) {
    cp_wait<PC_NST - 3>();
    __syncthreads();
    enqueue();
    if (s + 1 < S) convert(s + 1);
    const int8_t* bu = Bu + (s & 1) * PC_BU;
    if (ASTREAM) {
      const int8_t* a = As + (s & (PC_NST - 1)) * PC_ASLOT;
      pc_mma<PACKED>(acc, [&](int mi, int kk) { return a + ln.a_rd[mi][kk]; }, bu, ln);
    } else {
      // chunk of local k 32 kk + 16 (lane / 16): packed kk 0 -> K p0.., kk 1 -> K/2 + p0..
      // (p0 = 32 mk); int8 -> K 32 mk..
      const int c0 = 2 * mk + (lane >> 4), c1 = (K >> 5) + c0;
      pc_mma<PACKED>(acc,
                     [&](int mi, int kk) {
                       const int r = arow[mi];
                       return As + r * K + (a_swz(kk == 0 ? c0 : c1, r, cpr) << 4);
                     },
                     bu, ln);
    }
    if (++mk == spj) {
      epi(acc, mn0);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
      mk = 0;
      mn0 += FT_BN;
    }
  }
  cp_wait<0>();
}

// Dynamic shared memory of a row kernel (norm_quant, wht) whose rows are
// `row_w` floats wide: one row buffer per warp.  Sets *row_warps to the
// warps that get one (all 8, or fewer for very wide rows); returns -1 when
// not even one row buffer fits.
inline int ft_smem_bytes(int row_w, int* row_warps) {
  int rw = FT_WARPS;
  while (rw > 0 && rw * row_w * 4 > FT_SMEM_CAP) --rw;
  *row_warps = rw;
  return rw == 0 ? -1 : rw * row_w * 4;
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
