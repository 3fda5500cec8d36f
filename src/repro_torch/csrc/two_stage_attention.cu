// Two-stage recomputation INT8 attention (paper Alg. 1) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/two_stage_attention.py::two_stage_attention, both of its
// pallas_calls (_stage1_kernel, _stage2_kernel).
//
// Inputs: qv [BH,Lq,dh] s8, qs [BH,Lq] f32, kv/vv [BHkv,Lk,dh] s8,
// ks [BHkv,Lk] f32, v_scale [BH] f32.  Output [BH,Lq,dh] f32.
//
// The function.  s = float(s_int) * qs * ks * scale in that order, keys
// masked with NEG_INF = -1e30 (top-left causal rows >= cols, and keys >= Lk);
// m = max_j s; p = exp(s - m); l = sum_j p; pq = round_half_even(127 p) in
// int8; the int8 P.V summed exactly in int32 inside each 2048-key span (T_V)
// and carried in f32 across spans; out = acc * (1/127) / max(l, 1e-30) *
// v_scale.  GQA reads the shared K/V head kv_row(b) = (b / Hq) * Hkv +
// (b % Hq) / g without copying it.
//
// What bounds it.  The function needs one exponential per score,
// BH * Lq * Lk in all (the row max takes none, and p feeds both l and pq):
// for the global attention of one vggt-1b scene ~0.56 ms at the ~3.9 T/s
// of the special-function units, against ~0.28 ms of int8 tensor-core work
// (QK^T and P.V once each at 1,979 TOP/s).  This kernel is bound instead by
// instruction issue: its SASS holds ~21 instructions per score in stage 2
// (8 of them the accurate expf, then dequantize, s - m, l, round, pack,
// and the mma.sync/ldmatrix share) and ~7 in stage 1 (dequantize, max),
// at 16 warps per SM (128 registers, 2 blocks); on an H100 that is ~2 ms
// of issue at the global shape, and the kernel takes ~3 ms there.
//
// Design.  One 256-thread block owns one (query head, 128-row Q tile); each
// of its 8 warps owns 16 query rows, whose int8 Q fragments stay in
// registers.  Both stages run in the same launch, so m and l never leave the
// registers:
//   stage 1 streams 64-key K tiles and keeps only the row max m: no
//     exponential, no l;
//   stage 2 recomputes each score, forms p = exp(s - m) once, adds it to l
//     and rounds 127 p into pq, runs the int8 P.V into int32 and adds that
//     to an f32 accumulator at every 2048-key boundary; that accumulator is
//     touched so rarely that it waits in shared memory, which leaves its 32
//     registers to the score work.
// K, V and the key scales arrive through a 4-slot ring in dynamic shared
// memory (83 KB per block with the accumulator at dh 64; 160,768 B at dh
// 128, which leaves room for one block per SM) filled by cp.async
// (zero-filled past Lk), so the next tiles load while the current one is
// multiplied; a 128-row Q tile reads each K/V tile from L2 once for 128
// rows, half the traffic of a 64-row tile.  Each thread's cp.async offsets
// are fixed once per launch.  V is copied in its natural [key][dh] layout
// and transposed in shared memory into a double-buffered [dh][key] tile one
// tile ahead of its use, so stage 2 needs one __syncthreads per tile.  The
// B fragments of both products come from ldmatrix (four 8x8 matrices per
// instruction).
//
// Scalar work per score.  round_half_even(127 p) is an add of 1.5 * 2^23,
// whose low byte then is pq, and byte permutes pack four of them into an
// A-fragment register: no conversion instruction, which would run on the
// quarter-rate unit the exponential uses.  Only the ragged last key tile,
// and when causal the tiles crossing the diagonal, evaluate masks (a
// block-uniform branch between two instantiations); each thread's key
// offsets are compile-time constants plus 4 * (lane % 4).  When scale is a
// power of two (dh = 64: 1/8), float(s_int) * (qs * scale) * ks equals the
// reference's order bit for bit, which saves one multiply per score and ~5%
// of the kernel's time on an H100 at the served shapes (PERF.md, the
// two-stage attention findings); otherwise the three multiplies run in the
// reference's order (dh 96 and 128).  No multiply is contracted into an add
// (__fmul_rn/__fadd_rn), since m feeds every pq.
//
// The exponential is expf(s - m), the accurate one, as in the plain
// version, so the kernel's pq equal the plain version's (0 of 6.8e7 differ
// on a global head).  ex2.approx of (s log2 e - m log2 e) saves ~0.5 ms at
// the global shape, but it differs from expf by an ulp or two and flips pq
// by one step on ~6e-7 of the scores; where l is small (the frame shape,
// l ~ 70) one flip moved an output by 1.2e-3 on an H100 (PERF.md, the
// two-stage attention findings), beyond the 3e-4 the card checks hold the
// kernel to.

// Head dims.  Instances exist at dh 32, 64, 96, 128 and 256.  The score
// product runs over dh in k32 slices, two per ldmatrix.x4 and an odd last
// one (dh 32, 96) from an ldmatrix.x2.  dh 96 and 128 take one block per
// SM (122,880 and 160,768 B of shared memory).  dh 256 does not fit one
// block at this tiling (312,320 B; 128 int32 P.V accumulators a thread), so
// its output columns split in two halves across grid.z: each block computes
// the full 256-wide scores, m and l, and runs P.V for its own 128 output
// columns, loading only that half of V (226,304 B, the accumulators of dh
// 128).  The cost is QK^T and the exponentials twice per score.
//
// The P fragment is built from the score accumulators without going
// through shared memory.  The s32 accumulator layout does not match the s8
// A-fragment layout, so the K tile is staged with its rows permuted
// (key_of below): score column n then holds the key that P.V's k position
// n needs, and the transposed V tile keeps the natural key order.
#include <cmath>

#include "mma_s8.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BQ = 16 * WARPS;  // query rows per block (16 per warp)
constexpr int THREADS = 32 * WARPS;
constexpr int BKT = 64;       // keys per tile
constexpr int NSTAGE = 4;     // K/V ring slots
constexpr int TV_TILES = 2048 / BKT;  // int32 -> f32 flush period (T_V keys)
constexpr float NEG_INF = -1e30f;
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23

// Key offset (within a 32-key chunk) that score column x must hold so the
// s32 accumulators of m16n8k32 can be repacked in registers as the s8 A
// fragment of P.V: the A fragment's k position 16h + 4t + i is filled from
// score column 16h + 8(i>>1) + 2t + (i&1).
__host__ __device__ constexpr int key_of(int x) {
  return (x & 16) + 4 * ((x & 7) >> 1) + 2 * ((x >> 3) & 1) + (x & 1);
}

// Key (within a tile) that score column ni*8 + 2t holds, less 4t; column
// ni*8 + 2t + 1 holds the next key.
__host__ __device__ constexpr int key_off(int ni) {
  return (ni & ~3) * 8 + key_of((ni * 8) & 31);
}

// Shared-memory layout of one ring slot and of the transposed V tiles.  A
// block produces DV of the DH output columns (all of them up to dh 128).
// Both row strides are an odd multiple of 16 bytes (LDK / 16 = DH / 16 + 1
// with DH a multiple of 32; LDV = 80), so the 8 rows of 16 bytes an
// ldmatrix phase reads start in 8 different 4-bank groups: no bank
// conflicts at any instance (dh 96: LDK 112, rows at words 0, 28, 24, ...).
template <int DH>
struct Layout {
  static constexpr int DV = DH > 128 ? 128 : DH;
  static constexpr int SPLIT = DH / DV;  // blocks (grid.z) sharing a query tile
  static constexpr int LDK = DH + 16;   // K / natural V row stride (bytes)
  static constexpr int LDV = BKT + 16;  // V^T row stride (bytes)
  static constexpr int K_BYTES = BKT * LDK;
  static constexpr int SLOT = 2 * K_BYTES + 4 * BKT;  // K, V, key scales
  static constexpr int VT_BYTES = DV * LDV;
  static constexpr int O_FLOATS = DV / 2;  // per thread: 4 per 8-wide dh block
  static constexpr int BYTES = NSTAGE * SLOT + 2 * VT_BYTES + 4 * O_FLOATS * THREADS;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices (rows of 16 bytes) from shared memory; lane i gives
// the address of row i % 8 of matrix i / 8 and receives bytes 4(i%4)..+3 of
// row i/4 of each: with g = i/4, t = i%4 that is an s8 B fragment register.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// This thread's part of staging a tile, fixed for the launch: its 16-byte
// K/V chunks and its 4x4-byte blocks of the V transpose (unit i is
// tid + i * THREADS).
template <int DH>
struct Plan {
  static constexpr int CHUNKS = BKT * DH / 16, BLOCKS = (BKT / 4) * (Layout<DH>::DV / 4);
  static constexpr int NC = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr int NB = (BLOCKS + THREADS - 1) / THREADS;
  int key_k[NC];  // key (within the tile) of its K row; rows are permuted by key_of
  int src_k[NC];  // byte offset of that K chunk within the tile's rows
  int dst[NC];    // byte offset of the chunk's row within a slot (K and V alike)
  int rd[NB], wr[NB];  // transpose: natural-V and V^T byte offsets

  __device__ __forceinline__ explicit Plan(int tid) {
    using L = Layout<DH>;
    constexpr int CH = DH / 16, DQ = L::DV / 4;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tid + i * THREADS, n = c / CH, ch = c % CH;
      key_k[i] = (n & ~31) + key_of(n & 31);
      src_k[i] = key_k[i] * DH + ch * 16;
      dst[i] = n * L::LDK + ch * 16;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = tid + i * THREADS, dq = u % DQ, kq = u / DQ;
      rd[i] = L::K_BYTES + 4 * kq * L::LDK + 4 * dq;
      wr[i] = 4 * dq * L::LDV + 4 * kq;
    }
  }
};

// Queue one tile into a ring slot: K rows permuted by key_of, the key
// scales in natural order and (stage 2) V in natural order, only its
// columns vcol..vcol + DV - 1 when the block owns part of the output.
// Keys past Lk are zero-filled (their address is clamped to a valid one
// and not read).
template <int DH, bool WITH_V>
__device__ __forceinline__ void load_tile(uint8_t* slot, const Plan<DH>& pl,
                                          const int8_t* __restrict__ kp,
                                          const int8_t* __restrict__ vp,
                                          const float* __restrict__ ksp, int k0, int Lk,
                                          int tid, int vcol) {
  using L = Layout<DH>;
  const int left = Lk - k0;  // keys of this tile that exist
  const size_t base = (size_t)k0 * DH;
#pragma unroll
  for (int i = 0; i < Plan<DH>::NC; ++i) {
    const int c = tid + i * THREADS;
    if (Plan<DH>::CHUNKS % THREADS != 0 && c >= Plan<DH>::CHUNKS) break;
    const bool ok = pl.key_k[i] < left;
    cp_async16(slot + pl.dst[i], kp + (ok ? base + pl.src_k[i] : 0), ok);
    if (WITH_V) {  // natural order: chunk c holds key c / (DH / 16)
      if (L::SPLIT > 1 && static_cast<unsigned>(16 * (c % (DH / 16)) - vcol) >= L::DV) continue;
      const bool okv = c / (DH / 16) < left;
      cp_async16(slot + L::K_BYTES + pl.dst[i], vp + (okv ? base + 16 * c : 0), okv);
    }
  }
  if (tid < BKT) {
    const bool ok = tid < left;
    cp_async4(slot + 2 * L::K_BYTES + 4 * tid, ksp + (ok ? k0 + tid : 0), ok);
  }
}

// Natural V tile of a slot -> [dh][key] tile (4x4-byte blocks); `slot`
// points at the block's first V column.
template <int DH>
__device__ __forceinline__ void transpose_v(int8_t* vt, const uint8_t* slot, const Plan<DH>& pl,
                                            int tid) {
  using L = Layout<DH>;
#pragma unroll
  for (int i = 0; i < Plan<DH>::NB; ++i) {
    if (Plan<DH>::BLOCKS % THREADS != 0 && tid + i * THREADS >= Plan<DH>::BLOCKS) break;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(slot + pl.rd[i] + r * L::LDK);
    vq::transpose4x4_bytes(w);
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(vt + pl.wr[i] + j * L::LDV) = w[j];
  }
}

// Per-thread constants of the score computation.
struct Rows {
  float qf[2];   // qs (times scale when it is a power of two) of rows g, g+8
  float scale;   // applied last when it is not a power of two
  int row[2];    // query rows g, g+8
};

// Dequantized scores of this warp's 16 rows against the 32-key chunk c of
// a staged K tile: s[j][e] for score column (4c+j)*8 + 2t + (e&1), row
// g + 8*(e>>1).  MASK: columns whose key offset exceeds lim[e>>1] take
// NEG_INF.  `frag` is this lane's ldmatrix row address in the slot.
template <int DH, bool POW2, bool MASK>
__device__ __forceinline__ void chunk_scores(float (&s)[4][4], const uint8_t* slot,
                                             const uint8_t* frag,
                                             const uint32_t (&qa)[DH / 32][4], const Rows& r,
                                             const int (&lim)[2], int c, int t) {
  using L = Layout<DH>;
  const float* ks = reinterpret_cast<const float*>(slot + 2 * L::K_BYTES);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ni = 4 * c + j;
    int acc[4] = {0, 0, 0, 0};
    const uint8_t* fr = frag + ni * 8 * L::LDK;
#pragma unroll
    for (int h = 0; h < DH / 64; ++h) {  // k32 slices 2h and 2h + 1 from one ldmatrix.x4
      uint32_t b[4];
      ldsm_x4(b, fr + 64 * h);
      vq::mma_s8_16832(acc, qa[2 * h][0], qa[2 * h][1], qa[2 * h][2], qa[2 * h][3], b[0], b[1]);
      vq::mma_s8_16832(acc, qa[2 * h + 1][0], qa[2 * h + 1][1], qa[2 * h + 1][2],
                       qa[2 * h + 1][3], b[2], b[3]);
    }
    if constexpr (DH % 64 != 0) {  // the odd last k32 slice (dh 32, 96)
      constexpr int kk = DH / 32 - 1;
      uint32_t b[2];
      ldsm_x2(b, fr + 32 * kk);
      vq::mma_s8_16832(acc, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[0], b[1]);
    }
    const float2 kv = *reinterpret_cast<const float2*>(ks + key_off(ni) + 4 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = __fmul_rn(__fmul_rn((float)acc[e], r.qf[e >> 1]), (e & 1) ? kv.y : kv.x);
      if (!POW2) v = __fmul_rn(v, r.scale);
      if (MASK && key_off(ni) + (e & 1) > lim[e >> 1]) v = NEG_INF;
      s[j][e] = v;
    }
  }
}

// Largest key offset (less 4t) this thread may see in the tile at k0.
__device__ __forceinline__ void mask_limits(int (&lim)[2], const Rows& r, int k0, int Lk,
                                            bool causal, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lim[h] = Lk - 1 - k0 - 4 * t;
    if (causal) lim[h] = min(lim[h], r.row[h] - k0 - 4 * t);
  }
}

template <int DH, bool POW2, bool MASK>
__device__ __forceinline__ void stage1_tile(float (&mx)[2], const uint8_t* slot,
                                            const uint8_t* frag,
                                            const uint32_t (&qa)[DH / 32][4], const Rows& r,
                                            int k0, int Lk, bool causal, int t) {
  int lim[2] = {0, 0};
  if (MASK) mask_limits(lim, r, k0, Lk, causal, t);
#pragma unroll
  for (int c = 0; c < BKT / 32; ++c) {
    float s[4][4];
    chunk_scores<DH, POW2, MASK>(s, slot, frag, qa, r, lim, c, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
}

// Low bytes of four registers, in order, as one register.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// `vfrag` is this lane's ldmatrix row address in the V^T tile.
template <int DH, bool POW2, bool MASK>
__device__ __forceinline__ void stage2_tile(int (&oi)[Layout<DH>::DV / 8][4], float (&lsum)[2],
                                            const uint8_t* slot, const uint8_t* frag,
                                            const int8_t* vfrag,
                                            const uint32_t (&qa)[DH / 32][4], const Rows& r,
                                            const float (&m)[2], int k0, int Lk, bool causal,
                                            int t) {
  using L = Layout<DH>;
  int lim[2] = {0, 0};
  if (MASK) mask_limits(lim, r, k0, Lk, causal, t);
#pragma unroll
  for (int c = 0; c < BKT / 32; ++c) {
    float s[4][4];
    chunk_scores<DH, POW2, MASK>(s, slot, frag, qa, r, lim, c, t);
    uint32_t x[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[j][e], m[e >> 1]));  // Alg. 1 line 11
        lsum[e >> 1] += p;
        // round_half_even(127 p): the low byte of 127 p + 1.5 * 2^23
        x[j][e] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), MAGIC));
      }
    const uint32_t a0 = pack_low_bytes(x[0][0], x[0][1], x[1][0], x[1][1]);
    const uint32_t a1 = pack_low_bytes(x[0][2], x[0][3], x[1][2], x[1][3]);
    const uint32_t a2 = pack_low_bytes(x[2][0], x[2][1], x[3][0], x[3][1]);
    const uint32_t a3 = pack_low_bytes(x[2][2], x[2][3], x[3][2], x[3][3]);
#pragma unroll
    for (int nd = 0; nd < L::DV / 8; nd += 2) {  // B fragments of dh rows nd*8.. and (nd+1)*8..
      uint32_t b[4];
      ldsm_x4(b, vfrag + nd * 8 * L::LDV + c * 32);
      vq::mma_s8_16832(oi[nd], a0, a1, a2, a3, b[0], b[1]);
      vq::mma_s8_16832(oi[nd + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Blocks per SM the launch bounds ask for: two at dh 32 and 64 (128
// registers a thread); one from dh 96 on, whose 122,880 B (dh 96), 160,768 B
// (128) and 226,304 B (256) of shared memory allow no second block anyway,
// so their int32 P.V accumulators (48 or 64) and Q fragments (12, 16 or 32
// registers) a thread may use up to 255 registers without spilling.
template <int DH>
constexpr int min_blocks() { return DH >= 96 ? 1 : 2; }

template <int DH, bool POW2>
__global__ void __launch_bounds__(THREADS, min_blocks<DH>())
    two_stage_attention_kernel(const int8_t* __restrict__ qv, const float* __restrict__ qs,
                               const int8_t* __restrict__ kv, const float* __restrict__ ks,
                               const int8_t* __restrict__ vv, const float* __restrict__ vscale,
                               float* __restrict__ out, int Lq, int Lk, int q_heads,
                               int kv_heads, int causal, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* vts = reinterpret_cast<int8_t*>(smem + NSTAGE * L::SLOT);
  // this thread's f32 P.V accumulator, element i at os[i * THREADS]: it is
  // touched once per 2048 keys, so it waits in shared memory, not registers
  float* os = reinterpret_cast<float*>(smem + NSTAGE * L::SLOT + 2 * L::VT_BYTES) + threadIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int vcol = L::SPLIT > 1 ? blockIdx.z * L::DV : 0;  // this block's first output column
  const int kvb = (b / q_heads) * kv_heads + (b % q_heads) / (q_heads / kv_heads);
  const int8_t* kp = kv + (size_t)kvb * Lk * DH;
  const int8_t* vp = vv + (size_t)kvb * Lk * DH;
  const float* ksp = ks + (size_t)kvb * Lk;

  // this thread's two query rows and their int8 A fragments
  Rows r;
  r.scale = scale;
  uint32_t qa[DH / 32][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.row[h] = q0 + warp * 16 + g + 8 * h;
    const bool ok = r.row[h] < Lq;
    const int8_t* qr = qv + ((size_t)b * Lq + (ok ? r.row[h] : 0)) * DH + 4 * t;
    const float q = ok ? qs[(size_t)b * Lq + r.row[h]] : 0.f;
    r.qf[h] = POW2 ? q * scale : q;  // exact: scale is a power of two
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
      qa[kk][h] = ok ? vq::lds32(qr + kk * 32) : 0u;
      qa[kk][h + 2] = ok ? vq::lds32(qr + kk * 32 + 16) : 0u;
    }
  }

  int n_tiles = (Lk + BKT - 1) / BKT;
  if (causal) {  // tiles whose first key lies past the block's last row add nothing
    const int last = min(q0 + BQ - 1, Lq - 1);
    n_tiles = min(n_tiles, last / BKT + 1);
  }
  // only the ragged last tile and, when causal, tiles crossing the diagonal mask
  auto masked = [&](int k0) { return k0 + BKT > Lk || (causal && k0 + BKT - 1 > q0); };
  auto slot = [&](int kt) { return smem + (kt % NSTAGE) * L::SLOT; };
  const Plan<DH> pl(tid);
  // ldmatrix row addresses: K rows lane%8 at byte (lane/8)*16 of the tile's
  // first 8 score columns; V^T rows lane%8 (+8 for lanes 16..31) at byte
  // ((lane/8)%2)*16 of the tile's first 32 keys
  const int kfrag = (lane & 7) * L::LDK + (lane >> 3) * 16;
  const int vfrag = ((lane & 7) + (lane >> 4) * 8) * L::LDV + ((lane >> 3) & 1) * 16;

  // ---- stage 1: row max m only ----
  float m[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) load_tile<DH, false>(slot(s), pl, kp, vp, ksp, s * BKT, Lk, tid, vcol);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile kt visible; every warp is done with tile kt - 1
    const int nt = kt + NSTAGE - 1;
    if (nt < n_tiles) load_tile<DH, false>(slot(nt), pl, kp, vp, ksp, nt * BKT, Lk, tid, vcol);
    cp_async_commit();
    const int k0 = kt * BKT;
    if (masked(k0))
      stage1_tile<DH, POW2, true>(m, slot(kt), slot(kt) + kfrag, qa, r, k0, Lk, causal, t);
    else
      stage1_tile<DH, POW2, false>(m, slot(kt), slot(kt) + kfrag, qa, r, k0, Lk, causal, t);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for stage 2

  // ---- stage 2: p = exp(s - m) once per score, l, int8 P.V (Eq. 10) ----
  constexpr int ND = L::DV / 8;
  int oi[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) os[(nd * 4 + e) * THREADS] = 0.f, oi[nd][e] = 0;
  float lsum[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) load_tile<DH, true>(slot(s), pl, kp, vp, ksp, s * BKT, Lk, tid, vcol);
    cp_async_commit();
  }
  cp_async_wait<NSTAGE - 2>();
  __syncthreads();
  transpose_v<DH>(vts, slot(0) + vcol, pl, tid);
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<NSTAGE - 3>();
    __syncthreads();  // tile kt + 1 and V^T of tile kt visible; tile kt - 1 done
    const int nt = kt + NSTAGE - 1;
    if (nt < n_tiles) load_tile<DH, true>(slot(nt), pl, kp, vp, ksp, nt * BKT, Lk, tid, vcol);
    cp_async_commit();
    const int k0 = kt * BKT;
    const int8_t* vt = vts + (kt & 1) * L::VT_BYTES;
    if (masked(k0))
      stage2_tile<DH, POW2, true>(oi, lsum, slot(kt), slot(kt) + kfrag, vt + vfrag, qa, r, m, k0,
                                  Lk, causal, t);
    else
      stage2_tile<DH, POW2, false>(oi, lsum, slot(kt), slot(kt) + kfrag, vt + vfrag, qa, r, m,
                                   k0, Lk, causal, t);
    if (kt + 1 < n_tiles)
      transpose_v<DH>(vts + ((kt + 1) & 1) * L::VT_BYTES, slot(kt + 1) + vcol, pl, tid);
    if ((kt + 1) % TV_TILES == 0 || kt + 1 == n_tiles) {  // f32 carry across T_V tiles
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) os[(nd * 4 + e) * THREADS] += (float)oi[nd][e], oi[nd][e] = 0;
    }
  }
  cp_async_wait<0>();

  const float vs = vscale[b];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = fmaxf(quad_sum(lsum[h]), 1e-30f);
    if (r.row[h] >= Lq) continue;
    float* orow = out + ((size_t)b * Lq + r.row[h]) * DH + vcol;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float2 v;
      v.x = os[(nd * 4 + 2 * h) * THREADS] * (1.0f / 127.0f) / l * vs;
      v.y = os[(nd * 4 + 2 * h + 1) * THREADS] * (1.0f / 127.0f) / l * vs;
      *reinterpret_cast<float2*>(orow + nd * 8 + 2 * t) = v;
    }
  }
}

bool is_pow2(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

template <int DH, bool POW2>
int launch(const void* qv, const void* qs, const void* kv, const void* ks, const void* vv,
           const void* vscale, void* out, int BH, int Lq, int Lk, int q_heads, int kv_heads,
           int causal, float scale, cudaStream_t s) {
  constexpr int smem = Layout<DH>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      two_stage_attention_kernel<DH, POW2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Lq + BQ - 1) / BQ, BH, Layout<DH>::SPLIT);
  two_stage_attention_kernel<DH, POW2><<<grid, THREADS, smem, s>>>(
      static_cast<const int8_t*>(qv), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kv), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vv), static_cast<const float*>(vscale),
      static_cast<float*>(out), Lq, Lk, q_heads, kv_heads, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool POW2>
int attrs(int* out) {
  auto* k = two_stage_attention_kernel<DH, POW2>;
  constexpr int smem = Layout<DH>::BYTES;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes) + smem;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace

// C entry point (ctypes).  dh must be 64 (vggt-1b), 32 (its smoke width),
// 96 (phi3-mini-3.8b), 128 (qwen3-14b, deepseek-moe-16b) or 256
// (paligemma-3b); q_heads % kv_heads == 0 and BH % q_heads == 0 — the
// Python wrapper checks these.  Returns a cudaError_t
// (cudaErrorInvalidValue for an unsupported dh).  dh 96 and 128 have only
// the instance that multiplies in the reference's order (POW2 false): their
// scales 1/sqrt(dh) are no powers of two, and that instance is exact for
// any scale.  dh 256 has only the POW2 instance: its scale is 1/16.
extern "C" int vq_two_stage_attention(const void* qv, const void* qs, const void* kv,
                                      const void* ks, const void* vv, const void* vscale,
                                      void* out, int BH, int Lq, int Lk, int dh, int q_heads,
                                      int kv_heads, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p2 = is_pow2(scale);
#define VQ_LAUNCH(D, P) \
  launch<D, P>(qv, qs, kv, ks, vv, vscale, out, BH, Lq, Lk, q_heads, kv_heads, causal, scale, s)
  switch (dh) {
    case 32:
      return p2 ? VQ_LAUNCH(32, true) : VQ_LAUNCH(32, false);
    case 64:
      return p2 ? VQ_LAUNCH(64, true) : VQ_LAUNCH(64, false);
    case 96:
      return VQ_LAUNCH(96, false);
    case 128:
      return VQ_LAUNCH(128, false);
    case 256:
      return p2 ? VQ_LAUNCH(256, true) : static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VQ_LAUNCH
}

// The kernel's resources at head dim dh and this scale: out[0] registers
// per thread, out[1] shared-memory bytes per block, out[2] resident blocks
// per SM, out[3] local-memory (spill) bytes per thread.  Returns a
// cudaError_t.
extern "C" int vq_two_stage_attention_attrs(int dh, float scale, int* out) {
  const bool p2 = is_pow2(scale);
  switch (dh) {
    case 32:
      return p2 ? attrs<32, true>(out) : attrs<32, false>(out);
    case 64:
      return p2 ? attrs<64, true>(out) : attrs<64, false>(out);
    case 96:
      return attrs<96, false>(out);
    case 128:
      return attrs<128, false>(out);
    case 256:
      return p2 ? attrs<256, true>(out) : static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
