// Integer matmul for VersaQ quantized linears on Hopper (sm_90a):
//   y[M,N] = float(xv[M,K] . wv[K,N]) * xs[M] * ws[N]
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (_w8_kernel, _w4_kernel).
//
// * W8: wv is int8 [K, N].
// * W4: wv is packed uint8 [K/2, N]; packed row p holds original K-row p in
//   its low nibble and K-row K/2 + p in its high nibble (the reference's
//   interleave-free layout).  One K step takes 32 packed rows and pairs them
//   with the two contiguous activation column ranges [p0, p0+32) and
//   [K/2 + p0, K/2 + p0 + 32) — the same trick as _w4_kernel's two index
//   maps.  Nibbles are sign-extended to s8 while the tile is staged into
//   shared memory: Hopper's tensor cores have no s4 type.
//
// Design.  One 256-thread block computes one 128x128 output tile and loops
// over K in steps of 64 (the TPU's cross-grid-step VMEM accumulator becomes
// this in-block loop; blocks run in any order).  The tile staging, with the
// nibble unpacking, is mma_s8.cuh's load_tile/store_tile.  Eight warps, 4 along M by 2
// along N, each own a 32x64 sub-tile held as int32 accumulators in
// registers and issue mma.sync.m16n8k32 s8.s8.s32.  The next K step's tiles
// are fetched into registers while the current one is multiplied (register
// double buffering).  The int32 sum is exact; the scales are applied once,
// in the order float(acc) * xs * ws, as in the reference.  Ragged M and N
// edges are masked in the kernel (zero-filled loads, guarded stores).
//
// What bounds it.  At the model's shapes (M = 8232 tokens, K = 1024,
// N = 4096) the operations take ~35 us at the 1,979 TOP/s int8 peak, while
// the f32 output alone is 135 MB, ~40 us at 3.35 TB/s: the kernel is
// bound by the bytes of its f32 output.  The design writes each output
// element once and reads x and w through shared-memory tiles; a faster
// version would use wgmma with TMA-fed multi-stage pipelines.
#include "mma_s8.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = vq::TILE_BN;
constexpr int BK = vq::TILE_BK;          // K columns (original K index) per step
constexpr int THREADS = vq::TILE_THREADS;  // 8 warps: 4 (M) x 2 (N), 32x64 each
constexpr int LDS = vq::TILE_LDS;        // smem row stride in bytes

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const int8_t* __restrict__ xv, const float* __restrict__ xs,
                        const uint8_t* __restrict__ wv, const float* __restrict__ ws,
                        float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // [n][k]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = PACKED ? (K / 2 + 31) / 32 : (K + BK - 1) / BK;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int8_t* A = xv + (size_t)m0 * K;
  vq::TileStage<PACKED, BM> st;
  vq::load_tile<PACKED, BM>(st, A, M - m0, K, wv, N, n0, 0, tid);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // previous step's fragments are consumed
    vq::store_tile<PACKED, BM>(st, As, Bs, tid);
    __syncthreads();
    if (step + 1 < steps) vq::load_tile<PACKED, BM>(st, A, M - m0, K, wv, N, n0, step + 1, tid);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = As + (wm + mi * 16 + g) * LDS + kk + 4 * t;
        const int8_t* r1 = r0 + 8 * LDS;
        a[mi][0] = vq::lds32(r0);
        a[mi][1] = vq::lds32(r1);
        a[mi][2] = vq::lds32(r0 + 16);
        a[mi][3] = vq::lds32(r1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* br = Bs + (wn + ni * 8 + g) * LDS + kk + 4 * t;
        const uint32_t b0 = vq::lds32(br), b1 = vq::lds32(br + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          vq::mma_s8_16832(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
  }

  // epilogue: float(acc) * xs[m] * ws[n], masked at the ragged edges
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        if (n >= N) continue;  // N % 4 == 0, so n + 1 < N too
        float2 v;
        v.x = (float)acc[mi][ni][2 * h] * sx * ws[n];
        v.y = (float)acc[mi][ni][2 * h + 1] * sx * ws[n + 1];
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) = v;
      }
    }
  }
}

}  // namespace

// C entry point (ctypes).  Shapes: xv [M,K] s8, xs [M] f32, ws [N] f32,
// out [M,N] f32; wv [K,N] s8, or [K/2,N] u8 when packed.  Requires
// K % 16 == 0 (W8) or K % 32 == 0 (W4), N % 4 == 0 and 16-byte aligned
// rows — the Python wrapper checks these.  Returns cudaGetLastError().
extern "C" int vq_quant_matmul(const void* xv, const void* xs, const void* wv, const void* ws,
                               void* out, int M, int N, int K, int packed, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    quant_matmul_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(xv), static_cast<const float*>(xs),
        static_cast<const uint8_t*>(wv), static_cast<const float*>(ws),
        static_cast<float*>(out), M, N, K);
  } else {
    quant_matmul_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(xv), static_cast<const float*>(xs),
        static_cast<const uint8_t*>(wv), static_cast<const float*>(ws),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
