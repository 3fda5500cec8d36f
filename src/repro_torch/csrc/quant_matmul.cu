// Integer matmul for VersaQ quantized linears on Hopper (sm_90a):
//   y[M,N] = float(xv[M,K] . wv[K,N]) * xs[M] * ws[N]
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py:151
// quant_matmul (_w8_kernel, _w4_kernel).
//
// * W8: wv is int8 [K, N].
// * W4: wv is packed uint8 [K/2, N]; packed row p holds original K-row p in
//   its low nibble and K-row K/2 + p in its high nibble (the reference's
//   interleave-free layout).  A step takes 32 packed rows and pairs their
//   low nibbles with activation columns [p0, p0+32) and their high nibbles
//   with [K/2 + p0, K/2 + p0 + 32): the same trick as _w4_kernel's two
//   index maps.  Hopper's tensor cores have no s4 type, so each nibble is
//   placed in the high half of an s8 (16 w, exact) and the epilogue divides
//   the int32 sum by 16; this needs K < 2^17.
//
// What bounds it.  At the served shapes (vggt-1b, M = 16464 tokens, W4A8)
// the card's bound is 0.025 ms at K x N = 1024 x 1024 (wq, wk, wv, wo)
// and 0.086 ms at 1024 x 4096 (w_up), both by the bytes of the f32
// output, and 0.070 ms at 4096 x 1024 (w_down) by the int8 operations at
// 1,979 TOP/s.  An mma.sync core ran all three at ~200-220 TOP/s, 7-9x
// those bounds, bound by instruction issue (tiles staged through
// registers, 16 mma.sync and 24 lds32 per warp and 64-deep step); only
// warpgroup MMA reaches the tensor cores' full rate.  This design runs at
// ~430-630 TOP/s (0.081, 0.277 and 0.219 ms; an H100 80GB HBM3 at 700 W,
// tools/time_kernel_sources.py --kernel quant_matmul), 3.1-3.2x the bound.
// All 256 threads load, convert and issue in lockstep between barriers,
// and a step moves ~80 KB through shared memory (the wgmma's operand
// reads, the cp.async writes, the conversion's reads and writes): without
// the main loop's loads it runs 1.2-1.45x faster, without the conversion
// 1.14-1.21x.
//
// Design.  One 256-thread block computes one 128x256 output tile (no
// persistence; the TPU's cross-grid-step accumulator becomes the block's K
// loop).  Two warpgroups, each owning 64 rows, issue
// wgmma.m64n256k32.s32.s8.s8 (wgmma_s8.cuh) on K-major operands in shared
// memory, two per 64-deep step.  256 columns (not 128) halve the A bytes
// each MAC reads from L2; they take 128 accumulators a thread, so one
// block fits on an SM.
// * A (xv, row-major, so already K-major) goes from device memory straight
//   into the operand layout by 16-byte cp.async.
// * W arrives N-contiguous.  Each step's raw weight bytes go by cp.async
//   into a raw slot; the block's threads then turn the slot into the
//   K-major B operand (4x4 byte transposes, nibble placement), one step
//   ahead of the wgmma that reads it, into one of two B buffers.
// * A ring of STAGES cp.async slots (A and raw W) keeps STAGES - 2 steps
//   of loads in flight beyond the one being converted.  At step s the
//   block issues the wgmma of s, waits until only it is in flight (so step
//   s-1's slot and B buffer are free), loads step s + STAGES - 1, converts
//   step s + 1, and fences the generic-proxy writes (cp.async data and the
//   converted B) for the async proxy before the barrier.
// The int32 sum is exact; the scales are applied once, in the order
// float(acc) * xs * ws, as in the reference.  Ragged M, N and K edges are
// zero-filled at the loads (cp.async with src-size 0) and masked at the
// stores.
#include "mma_s8.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int BM = 128;      // output rows per block: two warpgroups of 64
constexpr int BN = 256;      // output columns per block: one m64n256k32 wide
constexpr int THREADS = 256;
using ALayout = vq::KMajor<BM>;
using BLayout = vq::KMajor<BN>;

template <bool PACKED>
struct Geo {
  static constexpr int BK = 64;                       // K bytes of A per step
  static constexpr int STAGES = 4;                    // cp.async ring slots
  static constexpr int SLICES = BK / 32;              // k32 wgmma per step
  static constexpr int RAW_ROWS = PACKED ? BK / 2 : BK;  // W rows per step
  static constexpr int A_BYTES = BM * BK;
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + RAW_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * B_BYTES;
  static constexpr int A_CHUNKS = BM * BK / 16 / THREADS;      // per thread and step
  static constexpr int UNITS = RAW_ROWS / 4 * (BN / 4) / THREADS;  // 4x4 conversion units
};

// The raw slot is row-major [W row q][BN bytes], with the 16-byte chunk c
// of row q at chunk c ^ raw_swz(q): the conversion's reads (rows 4kq..,
// 8 columns of 4 bytes per kq, four kq per warp) then hit 32 banks.
__device__ __forceinline__ int raw_swz(int q) { return 2 * ((q >> 2) & 3); }

// A thread's fixed part of every step, worked out once: where its cp.async
// copies come from (at step 0) and go, and where its conversion units read
// and write.  Its copies of one step are ROW_STEP A rows (and Q_STEP W
// rows) apart.
template <bool PACKED, bool VEC16>
struct Lane {
  using G = Geo<PACKED>;
  static constexpr int CPR = G::BK / 16;                // A chunks per row
  static constexpr int ROW_STEP = THREADS / (8 * CPR) * 8;
  static constexpr int W_PER_ROW = VEC16 ? BN / 16 : BN / 4;  // copies per W row
  static constexpr int W_COPIES = G::RAW_ROWS * W_PER_ROW / THREADS;
  static constexpr int Q_STEP = THREADS / W_PER_ROW;
  const int8_t* a_src;  // A: copy 0's source at step 0
  const uint8_t* w_src;  // W: copy 0's source at step 0
  int a_dst, a_k, a_rows;  // A: copy 0's slot offset, K offset at step 0, copies inside M
  int w_q, w_wd, w_ok;     // W: copy 0's row, its 4-byte word of the row, column inside N
  int rd, st, rot, sel_x, sel_y;  // conversion: raw read, B store, column rotation

  __device__ __forceinline__ Lane(const int8_t* xv, const uint8_t* wv, int M, int N, int K,
                                  int m0, int n0, int tid) {
    // A: a warp covers 8 rows x 4 chunks; W4 pairs chunks [0, CPR/2) with
    // the low nibbles (K p0..) and the rest with the high ones (K/2 + p0..)
    const int row = tid / (8 * CPR) * 8 + (tid & 7), j = (tid >> 3) % CPR;
    const int half = CPR / 2;
    const int col = PACKED ? (j < half ? 0 : K / 2) + 16 * (j % half) : 16 * j;
    a_dst = ALayout::offset(row, 16 * j);
    a_k = PACKED ? 16 * (j % half) : col;
    a_rows = max(0, (M - m0 - row + ROW_STEP - 1) / ROW_STEP);
    a_src = xv + (size_t)(m0 + row) * K + col;  // read only for rows inside M
    w_q = tid / W_PER_ROW;
    w_wd = (VEC16 ? 4 : 1) * (tid % W_PER_ROW);
    w_ok = n0 + 4 * w_wd < N;
    w_src = wv + (size_t)w_q * N + n0 + 4 * w_wd;
    const int lane = tid & 31, w = tid >> 5;
    const int nq = (lane & 7) + 8 * (w % (BN / 32)), kq = (lane >> 3) + 4 * (w / (BN / 32));
    rot = (nq >> 1) & 3;
    rd = 4 * kq * BN + 4 * (nq ^ (raw_swz(4 * kq) << 2));
    st = BLayout::offset(4 * nq, 4 * kq);
    // the transpose's first-level byte selectors, rotated: rows 0-1 (or
    // 2-3) of columns rot, rot ^ 1 (sel_x) and rot ^ 2, rot ^ 3 (sel_y)
    sel_x = rot | (4 + rot) << 4 | (rot ^ 1) << 8 | (4 + (rot ^ 1)) << 12;
    sel_y = (rot ^ 2) | (4 + (rot ^ 2)) << 4 | (rot ^ 3) << 8 | (4 + (rot ^ 3)) << 12;
  }

  // One step's loads into a ring slot, zero past M, K and N.
  __device__ __forceinline__ void load(uint8_t* slot, const int8_t* xv, const uint8_t* wv, int N,
                                       int K, int step) const {
    const int ka = step * (PACKED ? G::BK / 2 : G::BK), alim = PACKED ? K / 2 : K;
    const bool a_in = a_k + ka < alim;
#pragma unroll
    for (int i = 0; i < G::A_CHUNKS; ++i) {
      const bool ok = a_in && i < a_rows;
      vq::cp16(slot + a_dst + i * (ROW_STEP / 8) * ALayout::SBO,
               ok ? a_src + (size_t)i * ROW_STEP * K + ka : xv, ok ? 16 : 0);
    }
    uint8_t* raw = slot + G::A_BYTES;
    const int kw = step * G::RAW_ROWS, wlim = PACKED ? K / 2 : K;
#pragma unroll
    for (int i = 0; i < W_COPIES; ++i) {
      const int q = w_q + i * Q_STEP;
      const bool ok = w_ok && q + kw < wlim;
      const uint8_t* src = ok ? w_src + (size_t)(i * Q_STEP + kw) * N : wv;
      uint8_t* dst = raw + q * BN + 4 * (w_wd ^ (raw_swz(q) << 2));
      if (VEC16)
        vq::cp16(dst, src, ok ? 16 : 0);
      else
        vq::cp4(dst, src, ok ? 4 : 0);
    }
  }

  // Raw slot -> K-major B operand.  A unit is 4 W rows (4kq..) x 4 columns
  // (4nq..): four words read, transposed to one word of 4 K bytes per
  // column, stored at (n, k).  A warp holds nq % 8 (lane % 8) and kq % 4
  // (lane / 8); each lane permutes its columns, c -> c ^ rot with rot =
  // (nq >> 1) & 3 (in the transpose's first-level selectors), so the c-th
  // store of the 32 lanes covers all 8 rows and 4 K words of a core
  // matrix: 32 distinct banks.  W4 stores 16 w: a nibble moved to the high
  // half of its byte is its s8 value times 16, one or two instructions a
  // word; the epilogue divides the exact sum by 16.  Further units of a
  // thread sit U_ROWS W rows (and K bytes) further down.
  static constexpr int U_ROWS = 16 * THREADS / BN;
  __device__ __forceinline__ void convert(int8_t* bop, const uint8_t* raw) const {
#pragma unroll
    for (int u = 0; u < G::UNITS; ++u) {
      const uint8_t* r = raw + rd + u * U_ROWS * BN;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = *reinterpret_cast<const uint32_t*>(r + i * BN);
      const uint32_t x01 = __byte_perm(v[0], v[1], sel_x), y01 = __byte_perm(v[0], v[1], sel_y);
      const uint32_t x23 = __byte_perm(v[2], v[3], sel_x), y23 = __byte_perm(v[2], v[3], sel_y);
      // col[c]: W rows 4kq..4kq+3 of column 4nq + (c ^ rot)
      const uint32_t col[4] = {__byte_perm(x01, x23, 0x5410), __byte_perm(x01, x23, 0x7632),
                               __byte_perm(y01, y23, 0x5410), __byte_perm(y01, y23, 0x7632)};
      int8_t* dst = bop + st + u * (U_ROWS / 16) * BLayout::LBO;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int8_t* d = dst + 16 * (c ^ rot);
        if (PACKED) {  // low nibbles: K p0.., high nibbles: K/2 + p0..
          *reinterpret_cast<uint32_t*>(d) = (col[c] << 4) & 0xF0F0F0F0u;
          *reinterpret_cast<uint32_t*>(d + G::BK / 2 / 16 * BLayout::LBO) = col[c] & 0xF0F0F0F0u;
        } else {
          *reinterpret_cast<uint32_t*>(d) = col[c];
        }
      }
    }
  }
};

template <bool PACKED, bool VEC16>
__global__ void __launch_bounds__(THREADS, 1)
    quant_matmul_kernel(const int8_t* __restrict__ xv, const float* __restrict__ xs,
                        const uint8_t* __restrict__ wv, const float* __restrict__ ws,
                        float* __restrict__ out, int M, int N, int K) {
  using G = Geo<PACKED>;
  constexpr int S = G::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  int8_t* bops = reinterpret_cast<int8_t*>(smem + S * G::STAGE_BYTES);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = PACKED ? (K / 2 + G::BK / 2 - 1) / (G::BK / 2) : (K + G::BK - 1) / G::BK;
  const Lane<PACKED, VEC16> ln(xv, wv, M, N, K, m0, n0, tid);

  // descriptors of this warpgroup's slice 0 in ring slot 0 and B buffer 0
  const uint64_t da0 = vq::wgmma_desc(ring + wg * (64 / 8) * ALayout::SBO, ALayout::LBO,
                                      ALayout::SBO);
  const uint64_t db0 = vq::wgmma_desc(bops, BLayout::LBO, BLayout::SBO);
  constexpr uint64_t SLICE_A = 2 * ALayout::LBO >> 4, SLICE_B = 2 * BLayout::LBO >> 4;

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) ln.load(ring + s * G::STAGE_BYTES, xv, wv, N, K, s);
    vq::cp_commit();
  }
  vq::cp_wait<S - 2>();  // step 0 has landed
  __syncthreads();
  ln.convert(bops, ring + G::A_BYTES);
  vq::fence_proxy_async();
  __syncthreads();
  vq::wgmma_fence_operand(acc);

  for (int s = 0; s < steps; ++s) {
    const uint64_t da = da0 + ((uint64_t)((s % S) * G::STAGE_BYTES) >> 4);
    const uint64_t db = db0 + ((uint64_t)((s & 1) * G::B_BYTES) >> 4);
    vq::wgmma_fence();
#pragma unroll
    for (int i = 0; i < G::SLICES; ++i)
      vq::wgmma_m64n256k32_s8(acc, da + i * SLICE_A, db + i * SLICE_B);
    vq::wgmma_commit();
    vq::wgmma_wait<1>();        // this warpgroup's step s-1 is done
    vq::cp_wait<S - 3>();       // this thread's copies of step s+1 have landed
    __syncthreads();            // both warpgroups past s-1; step s+1 visible
    const int next = s + S - 1;  // into step s-1's slot
    if (next < steps) ln.load(ring + (next % S) * G::STAGE_BYTES, xv, wv, N, K, next);
    vq::cp_commit();
    if (s + 1 < steps)
      ln.convert(bops + ((s + 1) & 1) * G::B_BYTES,
                 ring + ((s + 1) % S) * G::STAGE_BYTES + G::A_BYTES);
    vq::fence_proxy_async();    // step s+1's A and B, for the async proxy
    __syncthreads();
  }
  vq::wgmma_wait<0>();
  vq::wgmma_fence_operand(acc);

  // epilogue: float(acc) * xs[m] * ws[n], masked at the ragged edges (W4:
  // the sum of 16 w, exact, divided back)
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = m0 + 64 * wg + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wrow + 8 * h;
    if (m >= M) continue;
    const float sx = xs[m];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      if (n >= N) continue;  // N % 4 == 0, so n + 1 < N too
      const int a0 = acc[4 * i + 2 * h] >> (PACKED ? 4 : 0);
      const int a1 = acc[4 * i + 2 * h + 1] >> (PACKED ? 4 : 0);
      float2 v;
      v.x = (float)a0 * sx * ws[n];
      v.y = (float)a1 * sx * ws[n + 1];
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) = v;
    }
  }
}

using Kernel = void (*)(const int8_t*, const float*, const uint8_t*, const float*, float*, int,
                        int, int);

// The instance for these operands, and its dynamic shared memory.
Kernel pick(int N, const void* wv, int packed, int* smem) {
  const bool vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(wv) % 16 == 0;
  *smem = packed ? Geo<true>::SMEM : Geo<false>::SMEM;
  if (packed) return vec16 ? quant_matmul_kernel<true, true> : quant_matmul_kernel<true, false>;
  return vec16 ? quant_matmul_kernel<false, true> : quant_matmul_kernel<false, false>;
}

}  // namespace

// The resources of the instance a launch at these widths takes (with a
// 16-byte aligned wv): out[0] registers per thread, out[1] shared memory per
// block in bytes, out[2] resident blocks per SM, out[3] spilled bytes per
// thread.  K is not needed by the kernel's resources; it is taken for the
// same signature as the launch.  Returns a cudaError_t.
extern "C" int vq_quant_matmul_attrs(int N, int K, int packed, int* out) {
  (void)K;
  int smem = 0;
  const Kernel k = pick(N, nullptr, packed, &smem);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, THREADS, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes) + smem;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// C entry point (ctypes).  Shapes: xv [M,K] s8, xs [M] f32, ws [N] f32,
// out [M,N] f32; wv [K,N] s8, or [K/2,N] u8 when packed.  Requires
// K % 16 == 0 (W8) or K % 32 == 0 (W4), N % 4 == 0, xv 16-byte and wv
// 4-byte aligned — the Python wrapper checks these — and K < 2^17 at W4
// (cudaErrorInvalidValue otherwise).  Returns cudaGetLastError().
extern "C" int vq_quant_matmul(const void* xv, const void* xs, const void* wv, const void* ws,
                               void* out, int M, int N, int K, int packed, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (packed && K >= (1 << 17)) return static_cast<int>(cudaErrorInvalidValue);  // 16 sum < 2^31
  int smem = 0;
  const Kernel k = pick(N, wv, packed, &smem);
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xv), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(wv), static_cast<const float*>(ws), static_cast<float*>(out),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}
