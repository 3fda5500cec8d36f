// Two-stage recomputation INT8 attention (paper Alg. 1) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/two_stage_attention.py::two_stage_attention, both of its
// pallas_calls (_stage1_kernel, _stage2_kernel).
//
// Inputs: qv [BH,Lq,dh] s8, qs [BH,Lq] f32, kv/vv [BHkv,Lk,dh] s8,
// ks [BHkv,Lk] f32, v_scale [BH] f32.  Output [BH,Lq,dh] f32.
//
// Design.  One 128-thread block owns one (query head, 64-row Q tile); each
// of its 4 warps owns 16 query rows, whose int8 Q fragments stay in
// registers.  Both stages run in the same launch, so the row statistics
// m and l never leave the registers (one launch per call, not two):
//   stage 1 streams 64-key K tiles through shared memory, computes the
//     int32 scores with mma.sync.m16n8k32 s8, dequantizes them in the
//     reference's order s = float(s_int) * qs * ks * scale, masks
//     (top-left causal rows >= cols, and keys >= Lk) with NEG_INF = -1e30,
//     and updates m and l online (Eq. 8-9);
//   stage 2 recomputes the same scores tile by tile, forms
//     pq = rintf(127 * expf(s - m)) (half-to-even, like jnp.round), runs
//     the int8 P.V product into int32 and adds it to an f32 accumulator at
//     every 2048-key boundary (T_V), and ends with
//     acc * (1/127) / l * v_scale.
// GQA reads the shared K/V head kv_row(b) = (b / Hq) * Hkv + (b % Hq) / g
// without copying it.  Causal tiles wholly above the diagonal are skipped;
// they would add exactly zero.
//
// The P fragment is built from the score accumulators without going
// through shared memory.  The s32 accumulator layout does not match the s8
// A-fragment layout, so the K tile is staged with its rows permuted
// (key_of below): score column n then holds the key that P.V's k position
// n needs, and V is staged as a plain transpose.
//
// What bounds it.  The function needs one exponential per score,
// BH * Lq * Lk in all: the row max m takes none, and p = exp(s - m) can
// feed both l and pq.  For the global attention of one vggt-1b scene that
// is ~0.28 ms at the ~3.9 T/s of the special-function units, against
// 2 * 2 * BH * Lq * Lk * dh int8 operations (QK^T and P.V, 0.14 ms at
// 1,979 TOP/s).  The exponentials bound it, not the tensor cores.  This
// kernel computes l online in stage 1, so it evaluates expf twice per
// score (plus the rescaling) and the int8 QK^T twice; a stage 1 that keeps
// only m would halve the exponentials.  expf stays accurate (no fast math)
// because a rounding difference flips pq.
#include "mma_s8.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BKT = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int TV_TILES = 2048 / BKT;  // int32 -> f32 flush period (T_V keys)
constexpr float NEG_INF = -1e30f;

// Key offset (within a 32-key chunk) that score column x must hold so the
// s32 accumulators of m16n8k32 can be repacked in registers as the s8 A
// fragment of P.V: the A fragment's k position 16h + 4t + i is filled from
// score column 16h + 8(i>>1) + 2t + (i&1).
__device__ __forceinline__ int key_of(int x) {
  return (x & 16) + 4 * ((x & 7) >> 1) + 2 * ((x >> 3) & 1) + (x & 1);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

template <int DH>
struct Smem {
  static constexpr int LDK = DH + 16;   // K tile row stride (bytes)
  static constexpr int LDV = BKT + 16;  // V^T tile row stride (bytes)
  __align__(16) int8_t k[BKT * LDK];    // [score column][dh], rows permuted
  __align__(16) int8_t vt[DH * LDV];    // [dh][key]
  float ks[BKT];                        // key scales, in score-column order
};

// Stage one K tile (rows permuted by key_of) and its scales.
template <int DH>
__device__ __forceinline__ void load_k(Smem<DH>& sm, const int8_t* __restrict__ kp,
                                       const float* __restrict__ ksp, int k0, int Lk, int tid) {
  constexpr int CH = DH / 16;  // 16-byte chunks per row
  for (int c = tid; c < BKT * CH; c += THREADS) {
    const int n = c / CH, ch = c % CH;
    const int key = k0 + (n & 32) + key_of(n & 31);
    const int4 v = key < Lk ? *reinterpret_cast<const int4*>(kp + (size_t)key * DH + ch * 16)
                            : make_int4(0, 0, 0, 0);
    *reinterpret_cast<int4*>(sm.k + n * Smem<DH>::LDK + ch * 16) = v;
  }
  if (tid < BKT) {
    const int key = k0 + (tid & 32) + key_of(tid & 31);
    sm.ks[tid] = key < Lk ? ksp[key] : 0.f;
  }
}

// Stage one V tile transposed to [dh][key] (natural key order).
template <int DH>
__device__ __forceinline__ void load_vt(Smem<DH>& sm, const int8_t* __restrict__ vp, int k0,
                                        int Lk, int tid) {
  constexpr int DQ = DH / 4;
  for (int u = tid; u < (BKT / 4) * DQ; u += THREADS) {
    const int dq = u % DQ, kq = u / DQ;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = k0 + 4 * kq + r;
      w[r] = key < Lk ? *reinterpret_cast<const uint32_t*>(vp + (size_t)key * DH + 4 * dq) : 0u;
    }
    vq::transpose4x4_bytes(w);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(sm.vt + (4 * dq + j) * Smem<DH>::LDV + 4 * kq) = w[j];
  }
}

// Dequantized, masked scores of this warp's 16 rows against the staged
// tile: s[ni][e] for score column ni*8 + 2t + (e&1), row g + 8*(e>>1).
template <int DH>
__device__ __forceinline__ void scores(float (&s)[8][4], const Smem<DH>& sm,
                                       const uint32_t (&qa)[DH / 32][4], const float (&qsr)[2],
                                       const int (&row)[2], int k0, int Lk, bool causal,
                                       float scale, int g, int t) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    int acc[4] = {0, 0, 0, 0};
    const int8_t* br = sm.k + (ni * 8 + g) * Smem<DH>::LDK + 4 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk)
      vq::mma_s8_16832(acc, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], vq::lds32(br + kk * 32),
                       vq::lds32(br + kk * 32 + 16));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = ni * 8 + 2 * t + (e & 1);
      const int key = k0 + (n & 32) + key_of(n & 31);
      float v = (float)acc[e] * qsr[e >> 1] * sm.ks[n] * scale;  // dequant (Alg. 1 line 4)
      if (causal && row[e >> 1] < key) v = NEG_INF;
      if (key >= Lk) v = NEG_INF;
      s[ni][e] = v;
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

template <int DH>
__global__ void __launch_bounds__(THREADS)
    two_stage_attention_kernel(const int8_t* __restrict__ qv, const float* __restrict__ qs,
                               const int8_t* __restrict__ kv, const float* __restrict__ ks,
                               const int8_t* __restrict__ vv, const float* __restrict__ vscale,
                               float* __restrict__ out, int Lq, int Lk, int q_heads,
                               int kv_heads, int causal, float scale) {
  __shared__ Smem<DH> sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvb = (b / q_heads) * kv_heads + (b % q_heads) / (q_heads / kv_heads);
  const int8_t* kp = kv + (size_t)kvb * Lk * DH;
  const int8_t* vp = vv + (size_t)kvb * Lk * DH;
  const float* ksp = ks + (size_t)kvb * Lk;

  // this thread's two query rows and their int8 A fragments
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qa[DH / 32][4];
  float qsr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < Lq;
    const int8_t* qr = qv + ((size_t)b * Lq + (ok ? row[h] : 0)) * DH + 4 * t;
    qsr[h] = ok ? qs[(size_t)b * Lq + row[h]] : 0.f;
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

  // ---- stage 1: row max m and row sum l (Eq. 8-9) ----
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float s[8][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();
    load_k<DH>(sm, kp, ksp, k0, Lk, tid);
    __syncthreads();
    scores<DH>(s, sm, qa, qsr, row, k0, Lk, causal, scale, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = NEG_INF;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) tmax = fmaxf(tmax, fmaxf(s[ni][2 * h], s[ni][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        sum += expf(s[ni][2 * h] - m_new) + expf(s[ni][2 * h + 1] - m_new);
      l[h] = l[h] * expf(m[h] - m_new) + quad_sum(sum);
      m[h] = m_new;
    }
  }
  l[0] = fmaxf(l[0], 1e-30f);
  l[1] = fmaxf(l[1], 1e-30f);

  // ---- stage 2: recompute, int8 P.V, no rescaling (Eq. 10) ----
  constexpr int ND = DH / 8;
  float o[ND][4];
  int oi[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f, oi[nd][e] = 0;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();
    load_k<DH>(sm, kp, ksp, k0, Lk, tid);
    load_vt<DH>(sm, vp, k0, Lk, tid);
    __syncthreads();
    scores<DH>(s, sm, qa, qsr, row, k0, Lk, causal, scale, g, t);
    int pq[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pq[ni][e] = (int)rintf(127.f * expf(s[ni][e] - m[e >> 1]));  // Alg. 1 line 11
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 4 * c;
      const uint32_t a0 = pack4(pq[j][0], pq[j][1], pq[j + 1][0], pq[j + 1][1]);
      const uint32_t a1 = pack4(pq[j][2], pq[j][3], pq[j + 1][2], pq[j + 1][3]);
      const uint32_t a2 = pack4(pq[j + 2][0], pq[j + 2][1], pq[j + 3][0], pq[j + 3][1]);
      const uint32_t a3 = pack4(pq[j + 2][2], pq[j + 2][3], pq[j + 3][2], pq[j + 3][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int8_t* br = sm.vt + (nd * 8 + g) * Smem<DH>::LDV + c * 32 + 4 * t;
        vq::mma_s8_16832(oi[nd], a0, a1, a2, a3, vq::lds32(br), vq::lds32(br + 16));
      }
    }
    if ((kt + 1) % TV_TILES == 0 || kt + 1 == n_tiles) {  // f32 carry across T_V tiles
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] += (float)oi[nd][e], oi[nd][e] = 0;
    }
  }

  const float vs = vscale[b];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Lq) continue;
    float* orow = out + ((size_t)b * Lq + row[h]) * DH;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      float2 v;
      v.x = o[nd][2 * h] * (1.0f / 127.0f) / l[h] * vs;
      v.y = o[nd][2 * h + 1] * (1.0f / 127.0f) / l[h] * vs;
      *reinterpret_cast<float2*>(orow + nd * 8 + 2 * t) = v;
    }
  }
}

template <int DH>
void launch(const void* qv, const void* qs, const void* kv, const void* ks, const void* vv,
            const void* vscale, void* out, int BH, int Lq, int Lk, int q_heads, int kv_heads,
            int causal, float scale, cudaStream_t s) {
  const dim3 grid((Lq + BQ - 1) / BQ, BH);
  two_stage_attention_kernel<DH><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(qv), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kv), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vv), static_cast<const float*>(vscale),
      static_cast<float*>(out), Lq, Lk, q_heads, kv_heads, causal, scale);
}

}  // namespace

// C entry point (ctypes).  dh must be 64 (vggt-1b) or 32 (its smoke
// width); q_heads % kv_heads == 0 and BH % q_heads == 0 — the Python
// wrapper checks these.  Returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported dh).
extern "C" int vq_two_stage_attention(const void* qv, const void* qs, const void* kv,
                                      const void* ks, const void* vv, const void* vscale,
                                      void* out, int BH, int Lq, int Lk, int dh, int q_heads,
                                      int kv_heads, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      launch<32>(qv, qs, kv, ks, vv, vscale, out, BH, Lq, Lk, q_heads, kv_heads, causal, scale, s);
      break;
    case 64:
      launch<64>(qv, qs, kv, ks, vv, vscale, out, BH, Lq, Lk, q_heads, kv_heads, causal, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
