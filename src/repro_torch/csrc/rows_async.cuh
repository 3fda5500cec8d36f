// Row kernels on registers, fed by an asynchronous row ring (sm_90a): the
// device code of norm_quant.cu and wht.cu.
//
// A block is RA_WARPS warps, and each warp walks its own rows of a
// persistent grid: warp g of the grid's G takes rows g, g + G, g + 2G, ...
// No barrier spans warps.
//
// The row ring.  Each warp owns `ns` row slots in shared memory, each with
// an mbarrier.  Lane 0 queues a row into a slot with one 1-D bulk copy
// (cp.async.bulk, the TMA engine: the bytes of a row are a multiple of 16
// and rows are 16-byte aligned) that completes the slot's barrier with
// expect_tx bytes.  The warp waits on the barrier, copies the slot into
// registers and queues the row ns ahead into it at once, before it does
// any arithmetic; so the warp always has ns rows in flight while it works
// on one.  ra_slots gives a warp about RA_RING_BYTES of slots (at most
// RA_MAX_SLOTS, at least one row).  Little's law at 3.35 TB/s and ~1 us of
// latency under load asks for ~25 KB in flight per SM: at d = 4096 (16 KB
// rows, one slot) two blocks of 4 warps hold 128 KB in flight, at
// D = 1024 (4 KB rows, one slot) six blocks hold 96 KB.
//
// Register rows.  A row of W = 128 K floats sits in K float4 registers a
// lane: lane l holds the chunks 4 l + 128 k, k < K, the map of
// fused_rows.cuh's load_row and norm_row, so the statistics sum in the
// same order.  Element bit 0-1 is the float4 component, bits 2-6 the lane,
// bits 7 and up the chunk k.  A butterfly stage on bits 0-1 or 7 and up
// pairs registers of one lane; a stage on bits 2-6 pairs lane l with
// l ^ (1 << (bit - 2)) through __shfl_xor_sync, 32 lanes moving 128 bytes
// an instruction with no shared memory and no bank conflict.  Instances
// hold KM chunks (a power of two); chunks k >= K are zeros, which change
// no sum, maximum or stored value, so the loops run over all KM without a
// branch.
//
// The arithmetic is fused_rows.cuh's, expression for expression, so the
// outputs are bit-identical to prologue_row's and wht_row's: the same
// stages in the same order (across the 128-wide groups first, strides
// 128 up, then inside H_128, strides 1 to 64), a + b and a - b with a the
// lower index (the upper lane of a shuffle stage takes
// fmaf(b, -1, a) = a - b exactly), the two scaling multiplies, norm_row's
// sums in chunk order then the xor tree, and quant_row_by's amax floor,
// NaN rule and rounding (div_by divides as IEEE division rounds).
//
// Rows these instances do not take (W % 128 != 0, or W > 4096) run
// fused_rows.cuh's warp-per-row routines on a row buffer in shared memory
// (ra_pick).
#pragma once

#include "fused_rows.cuh"

namespace vq {

constexpr int RA_WARPS = 4;  // warps (rows at once) a block
constexpr int RA_THREADS = 32 * RA_WARPS;
constexpr int RA_MAX_K = 32;            // widest register row: 4096 floats, 128 a lane
constexpr int RA_MAX_SLOTS = 4;
constexpr int RA_RING_BYTES = 4096;     // slot bytes a warp aims for
constexpr int RA_BAR_BYTES = RA_WARPS * RA_MAX_SLOTS * 8;  // the mbarriers, before the slots

// ---------------------------------------------------------------------------
// mbarrier and 1-D bulk copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes `bytes` of the barrier's expected transactions
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// the row ring
// ---------------------------------------------------------------------------

// Slots a warp gets for rows of `row_bytes`, and a block's dynamic shared
// memory for them (the barriers first, then each warp's slots).
__host__ __device__ inline int ra_slots(int row_bytes) {
  const int n = RA_RING_BYTES / row_bytes;
  return n < 1 ? 1 : (n > RA_MAX_SLOTS ? RA_MAX_SLOTS : n);
}

__host__ __device__ inline int ra_smem_bytes(int row_bytes, int ns) {
  return RA_BAR_BYTES + RA_WARPS * ns * row_bytes;
}

// This warp's rows through its ring.  next() returns the next row (or -1
// when the warp has none left) once its bytes are in the slot it returns;
// release() says the slot has been read, and queues the row ns ahead into
// it.  Lane 0 issues the copies; every lane waits.
class RowRing {
 public:
  __device__ RowRing(unsigned char* smem, const void* src, int rows, int row_bytes, int ns)
      : src_(static_cast<const char*>(src)), rows_(rows), bytes_(row_bytes), ns_(ns) {
    const int warp = threadIdx.x >> 5;
    lane_ = threadIdx.x & 31;
    step_ = gridDim.x * RA_WARPS;
    row_ = blockIdx.x * RA_WARPS + warp - step_;
    bar0_ = smem_u32(smem) + warp * RA_MAX_SLOTS * 8;
    slot0_ = smem + RA_BAR_BYTES + (size_t)warp * ns * row_bytes;
    if (lane_ == 0) {
      for (int s = 0; s < ns_; ++s) mbar_init(bar0_ + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < ns_; ++s) {
        const int r = row_ + (s + 1) * step_;
        if (r < rows_) queue(s, r);
      }
    }
    __syncwarp();
  }

  __device__ int next(const float** slot) {
    row_ += step_;
    if (row_ >= rows_) return -1;
    while (!mbar_try_wait(bar0_ + 8 * cur_, phase_)) {
    }
    *slot = reinterpret_cast<const float*>(slot0_ + (size_t)cur_ * bytes_);
    return row_;
  }

  __device__ void release() {
    __syncwarp();  // every lane has read the slot
    const int r = row_ + ns_ * step_;
    if (lane_ == 0 && r < rows_) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // reads before the copy
      queue(cur_, r);
    }
    if (++cur_ == ns_) {
      cur_ = 0;
      phase_ ^= 1;
    }
  }

 private:
  __device__ void queue(int s, int r) {
    const uint32_t bar = bar0_ + 8 * s;
    mbar_expect_tx(bar, bytes_);
    bulk_load(smem_u32(slot0_ + (size_t)s * bytes_), src_ + (size_t)r * bytes_, bytes_, bar);
  }

  const char* src_;
  unsigned char* slot0_;
  uint32_t bar0_;
  int rows_, bytes_, ns_, lane_, step_, row_;
  int cur_ = 0;
  uint32_t phase_ = 0;
};

// ---------------------------------------------------------------------------
// register rows: KM float4 chunks a lane, K of them live (K <= KM)
// ---------------------------------------------------------------------------

template <int KM>
__device__ __forceinline__ void rr_load(float4 (&v)[KM], const float* slot, int K, int lane) {
#pragma unroll
  for (int k = 0; k < KM; ++k)
    v[k] = k < K ? *reinterpret_cast<const float4*>(slot + 4 * lane + 128 * k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int KM>
__device__ __forceinline__ void rr_store(float* dst, const float4 (&v)[KM], int K, int lane) {
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) *reinterpret_cast<float4*>(dst + 4 * lane + 128 * k) = v[k];
}

// chunk k of the LayerNorm vector u, zeros past the row
__device__ __forceinline__ float4 u_chunk(const float* __restrict__ u, int k, int K, int lane) {
  return k < K ? *reinterpret_cast<const float4*>(u + 4 * lane + 128 * k)
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// norm_row on registers: the FoldedNorm statistics (rms | ln through u).
// Loops run over all KM chunks, without a branch on K, so each stays one
// block of straight-line code.
template <int KM>
__device__ __forceinline__ void rr_norm(float4 (&v)[KM], int K, int kind,
                                        const float* __restrict__ u, float eps, int lane) {
  const int W = 128 * K;
  float s2 = 0.f, su = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k) {  // the zero chunks k >= K add +0 to either sum
    const float4 c = v[k];
    s2 += c.x * c.x + c.y * c.y + c.z * c.z + c.w * c.w;
    if (kind == NORM_LN) {
      const float4 w = u_chunk(u, k, K, lane);
      su += c.x * w.x + c.y * w.y + c.z * w.z + c.w * w.w;
    }
  }
  const float ms = warp_sum(s2) / (float)W;
  if (kind == NORM_RMS) {
    const float inv = 1.0f / sqrtf(ms + eps);
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      v[k].x *= inv; v[k].y *= inv; v[k].z *= inv; v[k].w *= inv;
    }
    return;
  }
  const float mu = warp_sum(su);
  const float inv = 1.0f / sqrtf((ms - mu * mu) + eps);
  const float wf = (float)W;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const float4 w = u_chunk(u, k, K, lane);
    v[k].x = (v[k].x - mu * w.x * wf) * inv;
    v[k].y = (v[k].y - mu * w.y * wf) * inv;
    v[k].z = (v[k].z - mu * w.z * wf) * inv;
    v[k].w = (v[k].w - mu * w.w * wf) * inv;
  }
}

__device__ __forceinline__ void bfly(float& a, float& b) {
  const float x = a, y = b;
  a = x + y;
  b = x - y;
}

// one radix-2 stage on a lane bit: partner lane l ^ m; the lower lane
// keeps a + b, the upper a - b (b its own value, a the partner's)
__device__ __forceinline__ void bfly_lanes(float& v, int m, float sgn) {
  const float p = __shfl_xor_sync(0xffffffffu, v, m);
  v = fmaf(v, sgn, p);
}

// wht_row's two scaling factors for a block, fl(1/sqrt(min(block, 128)))
// and fl(1/sqrt(block / 128)) (used from 128 up), worked out once a launch
struct WhtScale {
  float hc, gs;
  __device__ explicit WhtScale(int block)
      : hc((float)(1.0 / sqrt((double)(block < 128 ? block : 128)))),
        gs(block >= 128 ? (float)(1.0 / sqrt((double)(block / 128))) : 1.0f) {}
};

// wht_row on registers: blocked WHT (block a power of two dividing W)
template <int KM>
__device__ __forceinline__ void rr_wht(float4 (&v)[KM], int block, const WhtScale& f, int lane) {
  const int c = block < 128 ? block : 128;
  // across the 128-wide groups: strides 128, 256, ... below the block
#pragma unroll
  for (int h = 1; h < KM; h *= 2) {
    if (128 * h >= block) break;
#pragma unroll
    for (int k = 0; k < KM; ++k)
      if (!(k & h)) {
        bfly(v[k].x, v[k + h].x);
        bfly(v[k].y, v[k + h].y);
        bfly(v[k].z, v[k + h].z);
        bfly(v[k].w, v[k + h].w);
      }
  }
  // inside H_c: strides 1 and 2 in the float4, then 4 .. 64 across lanes
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    bfly(v[k].x, v[k].y);
    bfly(v[k].z, v[k].w);
  }
  if (c >= 4) {
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      bfly(v[k].x, v[k].z);
      bfly(v[k].y, v[k].w);
    }
  }
#pragma unroll
  for (int m = 1; m < 32; m *= 2) {
    if (4 * m >= c) break;
    const float sgn = (lane & m) ? -1.f : 1.f;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      bfly_lanes(v[k].x, m, sgn);
      bfly_lanes(v[k].y, m, sgn);
      bfly_lanes(v[k].z, m, sgn);
      bfly_lanes(v[k].w, m, sgn);
    }
  }
  const float hc = f.hc, gs = f.gs;
  const bool grouped = block >= 128;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    v[k].x *= hc; v[k].y *= hc; v[k].z *= hc; v[k].w *= hc;
    if (grouped) { v[k].x *= gs; v[k].y *= gs; v[k].z *= gs; v[k].w *= gs; }
  }
}

// max that returns NaN when either input is NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// x / sc as IEEE division rounds it, from y = 1/sc (IEEE, once a row): the
// quotient x y corrected twice by Markstein's step q + (x - sc q) y (with
// y within half an ulp of 1/sc and q within an ulp of x/sc, the step
// rounds correctly; the first correction brings q there).  It needs sc
// and y normal and x - sc q exact: quant_row's finite scales lie in
// [1e-8/127, FLT_MAX/127] and |x/sc| <= 127; below |x| = 2^-100, where
// x - sc q may underflow, |x/sc| < 2^-66 rounds to the int 0 either way.
__device__ __forceinline__ float div_by(float x, float sc, float y) {
  const float q0 = x * y;
  const float q1 = fmaf(fmaf(-sc, q0, x), y, q0);
  return fmaf(fmaf(-sc, q1, x), y, q1);
}

// quant_row on registers: per-token quantization -> q (the row's int8,
// 4-byte aligned) and *s.  The amax propagates a NaN (max.NaN), which is
// quant_row_by's `bad` flag; its scale for such a row is 0x7fc00000 as
// there.  Rows with a finite scale divide through div_by.
template <int KM>
__device__ __forceinline__ void rr_quant(const float4 (&v)[KM], int K, int bits, int8_t* q,
                                         float* s, int lane) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k) {  // the zero chunks k >= K leave it as it is
    const float4 c = v[k];
    amax = max_nan(amax, max_nan(max_nan(fabsf(c.x), fabsf(c.y)), max_nan(fabsf(c.z), fabsf(c.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = amax != amax ? __int_as_float(0x7fc00000) : fmaxf(amax, 1e-8f) / qmax;
  if (isfinite(sc)) {
    // q8's byte with one conversion: |x / sc| <= 127, so rounding to the
    // nearest even int and clamping it equals rintf, the clamp, then (int)
    const float y = 1.0f / sc;
    const int qm = (1 << (bits - 1)) - 1;
    auto q8y = [&](float t) { return min(max(__float2int_rn(div_by(t, sc, y)), -qm), qm); };
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const float4 c = v[k];
      const uint32_t w = __byte_perm(__byte_perm(q8y(c.x), q8y(c.y), 0x0040),
                                     __byte_perm(q8y(c.z), q8y(c.w), 0x0040), 0x5410);
      if (k < K) *reinterpret_cast<uint32_t*>(q + 4 * lane + 128 * k) = w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) break;
      const float4 c = v[k];
      *reinterpret_cast<uint32_t*>(q + 4 * lane + 128 * k) =
          q8(c.x, sc, qmax) | (q8(c.y, sc, qmax) << 8) | (q8(c.z, sc, qmax) << 16) |
          (q8(c.w, sc, qmax) << 24);
    }
  }
  if (lane == 0) *s = sc;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Chunks a lane of the register instance for rows of W floats: the
// smallest power of two >= W / 128, or 0 where no instance takes the row.
inline int ra_chunks(int W) {
  if (W % 128 != 0 || W / 128 > RA_MAX_K) return 0;
  int km = 1;
  while (km < W / 128) km *= 2;
  return km;
}

// One launch of a row kernel: the kernel (null when no block fits), its
// block size, its dynamic shared memory and its last argument (slots a
// warp, or row warps).
template <typename Kernel>
struct RowLaunch {
  Kernel kernel;
  int threads, smem, arg;
};

// The launch for rows of W floats: the register instance KM = ra_chunks(W)
// (regs(KM) names it) in blocks of RA_THREADS, with `extra` bytes of
// shared memory after the ring, else the shared-memory routine `rows` in
// fused_rows.cuh's blocks of FT_THREADS with a row buffer a warp
// (ft_smem_bytes).
template <typename Kernel, typename Regs>
inline RowLaunch<Kernel> ra_pick(int W, int extra, Regs regs, Kernel rows) {
  const int km = ra_chunks(W);
  if (km > 0) {
    const int ns = ra_slots(4 * W);
    return {regs(km), RA_THREADS, ra_smem_bytes(4 * W, ns) + extra, ns};
  }
  int row_warps = 0;
  const int smem = ft_smem_bytes(W, &row_warps);
  return {smem < 0 ? nullptr : rows, FT_THREADS, smem, row_warps};
}

// Opt the launch's kernel in to its dynamic shared memory.  Returns a
// cudaError_t.
template <typename Kernel>
inline int ra_opt_in(const RowLaunch<Kernel>& l) {
  if (l.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem));
}

// Write how many blocks of the launch one SM holds at once to *blocks.
// Returns a cudaError_t.
template <typename Kernel>
inline int ra_resident_blocks(const RowLaunch<Kernel>& l, int* blocks) {
  const int e = ra_opt_in(l);
  if (e != 0) return e;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, l.kernel, l.threads, l.smem));
}

// out[0] registers per thread, out[1] shared memory per block in bytes,
// out[2] resident blocks per SM, out[3] spilled bytes per thread of the
// launch's kernel.  Returns a cudaError_t.
template <typename Kernel>
inline int ra_attrs(const RowLaunch<Kernel>& l, int* out) {
  int blocks = 0;
  const int e = ra_resident_blocks(l, &blocks);
  if (e != 0) return e;
  cudaFuncAttributes a;
  const cudaError_t ea = cudaFuncGetAttributes(&a, l.kernel);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes) + l.smem;
  out[2] = blocks;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace vq
