// Fused stem: the dx-folded stride-1 conv, bias, optional ReLU and the 3x3
// stride-2 max pool with right-clipped windows, in one kernel:
//   conv[n, cy, ox, oc] = sum_{ky, j} x6[n, cy + ky, ox, j] * w2[ky * CP + j, oc]
//   out[n, py, px, oc]  = max over cy in {2py, 2py+1, 2py+2} (cy < NCV),
//                         ox in {2px, 2px+1, 2px+2} (ox < OW) of
//                         relu?(conv + bias[oc])
// with x6 (N, XS_H, OW, CP), w2 (KH*CP, OC), NCV = XS_H - KH + 1 conv rows and
// out (N, POH, POW, OC), f32 accumulation, the output in x6's dtype.
//
// Replaces K7, boda_tpu/ops/kernels/stem.py:121 pallas_stem_fused (_stem_kernel
// :77). The TPU kernel holds a whole image in VMEM and walks chunks of pooled
// rows; per chunk it lane-concatenates the KH row taps into one deep-K operand
// and pools the f32 accumulator with rolls and strided reshapes. The
// full-resolution conv output never reaches device memory here either.
//
// Pooling the raw sums and adding bias and ReLU after the max gives the same
// values as the other order: both are monotone, and so is the final rounding.
// The max and the ReLU keep NaN as jnp.maximum does (gemm.cuh's jmax and
// relu_j; the mma route's pool takes max_nan below): a NaN among a window's
// sums gives NaN, as in boda_tpu.
//
// What bounds it on an H100: bytes. At the ResNet-50 b32 stem, x6 is
// 32x115x112x48 bf16 (39.6 MB, the 7x7 s2 input after the host's s2d and dx
// folds) and the pooled output 12.8 MB: ~16 us at 3.35 TB/s, against ~10 us
// of bf16 tensor-core work (9.9 GFLOP). The 112x112x64 conv activation, 51 MB
// that an unfused conv writes and the pool reads back, never exists. Two
// routes, chosen with the plan in ops/kernels/stem.py:plan (band, ring depth);
// this side only checks that it can run it:
//
//   * mma (bf16; OW, CP and OC multiples of 16, OW <= 128, OC <= 128, 16-byte
//     aligned operands). A block takes one image and a band of pooled rows,
//     about one wave in all, two blocks per SM up to OC = 64 (one block's
//     pool and barrier overlap the other's products), and loads w2 into
//     shared memory once.
//     An x6 row x6[n, y] is one contiguous run of OW*CP bf16, so one thread
//     stages each of the band's input rows with one 1-D bulk copy
//     (cp.async.bulk, L2 evict-first) into a ring of `slots` rows, one
//     mbarrier per slot, issued as soon as the conv rows that read the slot's
//     last row are done. The band's conv rows are computed once each (the
//     band's top row is also the previous band's last): a step takes the next
//     two, 2p+1 and 2p+2, whose windows close pooled row p with the row 2p
//     kept from the step before. One warp per 16-pixel strip computes both
//     rows of its strip as conv^T = w2^T . x6^T on mma.sync m16n8k16, f32 in
//     registers: channels on M (w2's fragments by ldmatrix.trans), pixels on
//     N (x6's by ldmatrix from the staged rows; a pixel's 96-byte pitch costs
//     a 2-way bank conflict at CP = 48, cheaper than restaging each row at a
//     112-byte pitch by cp.async: scripts/torch_stem_parts.py). So each lane
//     holds two neighbouring pixels of its channels: a 3-wide stride-2 window
//     is its own pair and one pixel of the next lane (a shuffle); the one
//     pixel past a strip comes from the next strip's warp through shared
//     memory, the step's one barrier. The horizontal maxes of row 2p+2 stay
//     in shared memory (each thread's own) for the next step; pooled row p
//     gets bias, ReLU and one rounding in the lanes.
//   * fma (float32, and bf16 off that path): a block takes one image and
//     `band` (at most 2) pooled rows, computes the 2*band+1 conv rows their
//     windows read into shared memory in f32, w2 there as f32, each thread
//     one output channel and 4 neighbouring conv pixels at a time, then pools
//     them there.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"  // jmax, relu_j, the mbarriers and the bulk copy

namespace {

using bf16 = __nv_bfloat16;

enum Route { kFma = 0, kMma = 1 };

constexpr int kFmaThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt into
constexpr int kBarBytes = 128;      // mma: the ring's mbarriers, ahead of its slots
constexpr int kMaxSlots = 16;       // (kBarBytes / 8)
constexpr int kMaxWarps = 8;        // mma: one warp per 16-pixel strip

struct Args {
  const void* x6;
  const void* w2;
  const float* bias;
  void* out;
  int n, xs_h, ow, cp, kh, oc, poh, pow_, relu;
  int ncv, band, slots;  // band: pooled rows per block; slots: mma's ring depth
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- mma ----------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// max with NaN propagating (PTX max.NaN, one instruction where jmax takes
// six): the pool of raw sums, which bias and relu_j follow, so only a zero's
// sign with ReLU off and a zero bias could tell the two apart
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// d += a (16x16, row-major) . b (16x8): d[0..1] at (row g, cols 2q..2q+1),
// d[2..3] at (row g+8, the same cols), g = lane / 4, q = lane % 4
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the mma route (ops/kernels/stem.py:mma_smem mirrors it):
// the ring's mbarriers; `slots` input rows of OW*CP bf16; w2 as (KH*CP, OC+8)
// bf16 (+8: ldmatrix.trans without bank conflicts); the horizontal maxes of
// the step's last conv row, (OW/2, OC) f32, each thread's own; the strips'
// first pixels, (2 steps, 2 rows, OW/16 strips, OC) f32.
__host__ __device__ inline size_t mma_smem(const Args& a) {
  return kBarBytes + (size_t)a.slots * a.ow * a.cp * 2 + (size_t)a.kh * a.cp * (a.oc + 8) * 2 +
         (size_t)(a.ow / 2) * a.oc * 4 + (size_t)4 * (a.ow / 16) * a.oc * 4;
}

// One block: image blockIdx.y, pooled rows p0 .. p1-1 of band blockIdx.x; one
// warp per strip of 16 conv pixels; NF = OC / 16. Up to OC = 64, two blocks
// share an SM (at most 128 registers a thread), so that one block's pool and
// barrier overlap the other's products.
// KH_ and CPK_ (CP / 16), where not 0, fix the product loop's depth at compile
// time, so that it unrolls: the ResNet/GoogLeNet stem's KH = 4, CP = 48.
template <int NF, int KH_, int CPK_>
__global__ void __launch_bounds__(kMaxWarps * 32, NF <= 4 ? 2 : 1) stem_mma(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int strips = a.ow / 16, s = threadIdx.x >> 5, nthr = blockDim.x;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ldb = a.oc + 8, cpk = CPK_ ? CPK_ : a.cp / 16, ksteps = (KH_ ? KH_ : a.kh) * cpk;
  const uint32_t row_bytes = (uint32_t)a.ow * a.cp * 2;
  const uint32_t bars = boda::smem_u32(smem);
  const uint32_t ring = bars + kBarBytes;
  bf16* Bs = (bf16*)(smem + kBarBytes + (size_t)a.slots * row_bytes);
  float4* V = (float4*)(Bs + (size_t)a.kh * a.cp * ldb);  // [NF][threads]: this thread's
  float* edge = (float*)(V + (size_t)NF * nthr);          // [step & 1][row][strip][2NF][8]
  const int n = blockIdx.y, p0 = blockIdx.x * a.band, p1 = min(p0 + a.band, a.poh);
  const int c0 = 2 * p0;                                 // the band's first conv row
  const int nin = min(2 * p1, a.ncv - 1) - c0 + a.kh;    // its input rows, from c0
  const bf16* x6 = (const bf16*)a.x6 + (size_t)n * a.xs_h * a.ow * a.cp;

  // thread 0 stages input rows c0 .. c0 + issued - 1; row i sits in slot i % slots
  uint64_t policy = 0;
  int issued = 0;
  auto issue_to = [&](int upto) {
    for (; issued < min(upto, nin); ++issued) {
      const uint32_t slot = issued % a.slots, bar = bars + 8 * slot;
      boda::mbar_expect_tx(bar, row_bytes);
      boda::bulk_load_1d(ring + slot * row_bytes, x6 + (size_t)(c0 + issued) * a.ow * a.cp,
                         row_bytes, bar, policy);
    }
  };
  // w2 into shared memory once, every 16-byte piece in flight at once, ahead
  // of the first rows
  const bf16* w2 = (const bf16*)a.w2;
  for (int i = threadIdx.x; i < a.kh * a.cp * a.oc / 8; i += nthr) {
    const int k = i / (a.oc / 8), c8 = (i % (a.oc / 8)) * 8;
    boda::cp_async16(boda::smem_u32(Bs + k * ldb + c8), w2 + (size_t)k * a.oc + c8, true);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) boda::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    policy = boda::l2_evict_first();
    issue_to(a.slots);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ldmatrix rows. w2 (trans): k row lane % 8 + ((lane / 16) % 2) * 8 at
  // channel ((lane / 8) % 2) * 8; x6: pixel lane % 8 + ((lane / 16) % 2) * 8
  // of the strip at channel ((lane / 8) % 2) * 8
  const uint32_t w_lane = boda::smem_u32(Bs) +
      (uint32_t)((((lane & 7) + ((lane >> 4) & 1) * 8) * ldb + ((lane >> 3) & 1) * 8) * 2);
  const uint32_t x_lane =
      (uint32_t)(((16 * s + (lane & 7) + ((lane >> 4) & 1) * 8) * a.cp + ((lane >> 3) & 1) * 8) * 2);
  float bias[NF][2];  // channels 16 mt + 8 h + g
#pragma unroll
  for (int mt = 0; mt < NF; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bias[mt][h] = __ldg(a.bias + 16 * mt + 8 * h + g);
  bf16* out = (bf16*)a.out;
  const int src = (lane & ~3) | ((q + 1) & 3);  // the lane of pixel 2q + 2 (q < 3)

  // step 0: conv row c0 into V; step t >= 1: conv rows c0+2t-1 and c0+2t, and
  // pooled row p0+t-1. A row past the conv (or step 0's first) computes the
  // other row again, so the product loop has no branch.
  for (int t = 0; t <= p1 - p0; ++t) {
    const int ra = t == 0 ? c0 : c0 + 2 * t - 1, rb = c0 + 2 * t;
    const bool val[2] = {t > 0 && ra < a.ncv, rb < a.ncv};
    const int cr[2] = {val[0] ? ra : rb, val[1] ? rb : ra};
    // acc[r][mt][nt]: channels 16 mt + g (+8 in [2..3]), pixels 16 s + 8 nt + 2q, +1
    float acc[2][NF][2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int mt = 0; mt < NF; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc[r][mt][nt][0] = acc[r][mt][nt][1] = acc[r][mt][nt][2] = acc[r][mt][nt][3] = 0.f;
    if (val[0] || val[1]) {
      const int lo = min(cr[0], cr[1]) - c0, hi = max(cr[0], cr[1]) - c0 + a.kh - 1;
      for (int i = lo; i <= hi; ++i)
        boda::mbar_wait(bars + 8 * (i % a.slots), (uint32_t)((i / a.slots) & 1));
      int slot0[2];  // the ring slot of each row's tap 0
#pragma unroll
      for (int r = 0; r < 2; ++r) slot0[r] = (cr[r] - c0) % a.slots;
      // conv^T = w2^T . x6^T, channels on M (w2's fragments, A) and pixels
      // on N (x6's, B), one k16 step (16 channels of one tap row) at a time
#pragma unroll
      for (int k = 0, ky = 0, j = 0; k < ksteps; ++k) {
        uint32_t wf[NF][4], xf[2][4];
        const uint32_t k0 = (uint32_t)(ky * cpk + j) * 16;
#pragma unroll
        for (int mt = 0; mt < NF; ++mt) ldsm_x4_t(w_lane + (k0 * ldb + 16 * mt) * 2, wf[mt]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int sl = slot0[r] + ky < a.slots ? slot0[r] + ky : slot0[r] + ky - a.slots;
          ldsm_x4(ring + sl * row_bytes + x_lane + 32 * j, xf[r]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int mt = 0; mt < NF; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma16816(acc[r][mt][nt], wf[mt], xf[r][2 * nt], xf[r][2 * nt + 1]);
        if (++j == cpk) {
          j = 0;
          ++ky;
        }
      }
    }
    // the strip's first pixel (lanes with q = 0 hold it) for the window that
    // crosses into it from the strip before, indexed as its reader needs it
    float* eb = edge + (size_t)(t & 1) * 2 * strips * NF * 16;
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int mt = 0; mt < NF; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            eb[(((size_t)r * strips + s) * 2 * NF + 2 * mt + h) * 8 + g] = acc[r][mt][0][2 * h];
    }
    __syncthreads();  // every read of this step's input rows and edges is ordered before
    // the conv rows to come read input rows from 2t + 1 on: the earlier slots are free
    if (threadIdx.x == 0) issue_to(2 * t + 1 + a.slots);

    // each lane holds pixels 2q, 2q+1 of both n8 tiles: it owns the windows
    // starting there, pooled columns 8s + 4nt + q; pixel 2q+2 is the next
    // lane's (q < 3), the next tile's first (q = 3), or the next strip's
    const bool next = s + 1 < strips;
    float win[2][NF][2][2];  // [row][mt][nt][h]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int mt = 0; mt < NF; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[r][mt][0][2 * h], v1 = acc[r][mt][1][2 * h];
          const float t0 = __shfl_sync(~0u, q >= 1 ? v0 : v1, src);
          float t1 = __shfl_sync(~0u, v1, src);
          if (q == 3)
            t1 = next ? eb[(((size_t)r * strips + s + 1) * 2 * NF + 2 * mt + h) * 8 + g] : -INFINITY;
          win[r][mt][0][h] = max_nan(max_nan(v0, acc[r][mt][0][2 * h + 1]), t0);
          win[r][mt][1][h] = max_nan(max_nan(v1, acc[r][mt][1][2 * h + 1]), t1);
        }
#pragma unroll
    for (int mt = 0; mt < NF; ++mt) {
      float4* vp = V + (size_t)mt * nthr + threadIdx.x;  // [nt][h] of this mt
      if (t == 0) {
        *vp = make_float4(win[1][mt][0][0], win[1][mt][0][1], win[1][mt][1][0], win[1][mt][1][1]);
        continue;
      }
      const float4 pv = *vp;
      float m[2][2] = {{pv.x, pv.y}, {pv.z, pv.w}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (val[r]) m[nt][h] = max_nan(m[nt][h], win[r][mt][nt][h]);
          const int px = 8 * s + 4 * nt + q;
          if (px >= a.pow_) continue;
          float v = m[nt][h] + bias[mt][h];
          if (a.relu) v = boda::relu_j(v);
          out[(((size_t)n * a.poh + p0 + t - 1) * a.pow_ + px) * a.oc + 16 * mt + 8 * h + g] =
              __float2bfloat16_rn(v);
        }
      if (val[1])
        *vp = make_float4(win[1][mt][0][0], win[1][mt][0][1], win[1][mt][1][0], win[1][mt][1][1]);
    }
  }
}

// ---- fma ----------------------------------------------------------------------

// Pool the block's conv rows S (local row r, column ox, channel oc at
// S[(r * OW + ox) * OC + oc]) into its band of pooled rows.
template <typename T>
__device__ void pool_store(const Args& a, const float* S, int n, int p0, int rows, int nrows) {
  T* out = (T*)a.out;
  const int total = rows * a.pow_ * a.oc;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int oc = i % a.oc;
    const int t = i / a.oc;
    const int px = t % a.pow_;
    const int pr = t / a.pow_;
    float m = -INFINITY;
    for (int dy = 0; dy < 3; ++dy) {
      const int r = 2 * pr + dy;
      if (r >= nrows) break;
      for (int dx = 0; dx < 3; ++dx) {
        const int ox = 2 * px + dx;
        if (ox >= a.ow) break;
        m = boda::jmax(m, S[((long)r * a.ow + ox) * a.oc + oc]);
      }
    }
    float v = m + a.bias[oc];
    if (a.relu) v = boda::relu_j(v);
    out[(((long)n * a.poh + p0 + pr) * a.pow_ + px) * a.oc + oc] = from_f32<T>(v);
  }
}

// Shared memory of the fma route (ops/kernels/stem.py:fma_smem mirrors it):
// w2 in f32, then the band's 2*band+1 conv rows in f32.
__host__ __device__ inline size_t fma_smem(const Args& a) {
  return ((size_t)a.kh * a.cp * a.oc + 31) / 32 * 32 * 4 +
         (size_t)(2 * a.band + 1) * a.ow * a.oc * 4;
}

// Any dtype and shape on the FMA pipes: w2 in shared memory as f32; each
// thread takes one output channel and 4 neighbouring conv pixels at a time
// (the 4 input values a warp reads at one k are one broadcast each).
template <typename T>
__global__ void __launch_bounds__(kFmaThreads) stem_fma(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kdim = a.kh * a.cp;
  float* Bs = (float*)smem;
  float* S = Bs + (((size_t)kdim * a.oc + 31) / 32) * 32;
  const int n = blockIdx.y, p0 = blockIdx.x * a.band;
  const int rows = min(a.band, a.poh - p0), cy0 = 2 * p0;
  const int nrows = min(2 * rows + 1, a.ncv - cy0);
  const T* w2 = (const T*)a.w2;
  for (int i = threadIdx.x; i < kdim * a.oc; i += blockDim.x) Bs[i] = to_f32(w2[i]);
  __syncthreads();
  const T* x6 = (const T*)a.x6;
  const int quads = (a.ow + 3) / 4;
  const long work = (long)nrows * quads * a.oc;
  for (long i = threadIdx.x; i < work; i += blockDim.x) {
    const int oc = (int)(i % a.oc);
    const long t = i / a.oc;
    const int r = (int)(t / quads), ox0 = (int)(t % quads) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ky = 0; ky < a.kh; ++ky) {
      const T* arow = x6 + (((long)n * a.xs_h + cy0 + r + ky) * a.ow + ox0) * a.cp;
      const float* brow = Bs + (long)ky * a.cp * a.oc + oc;
      for (int j = 0; j < a.cp; ++j) {
        const float b = brow[(long)j * a.oc];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ox0 + q < a.ow) acc[q] = fmaf(to_f32(arow[(long)q * a.cp + j]), b, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ox0 + q < a.ow) S[((long)r * a.ow + ox0 + q) * a.oc + oc] = acc[q];
  }
  __syncthreads();
  pool_store<T>(a, S, n, p0, rows, nrows);
}

template <typename K>
int launch(K kernel, const Args& a, int bands, int threads, size_t smem, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(bands, a.n), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// bias is float32 (OC). dtype: 0 = float32, 1 = bfloat16. route (0 fma, 1
// mma), band (pooled rows per block), bands (blocks per image) and slots
// (mma's ring depth) are the plan of ops/kernels/stem.py:plan. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// geometry the pool cannot read (NCV < 2*POH - 1, POW > ceil(OW/2)) or a plan
// this side cannot run: a route the shape or dtype is off, bands that do not
// cover POH pooled rows once, a ring outside KH+1 .. 16 rows, or more shared
// memory than a block has.
extern "C" int boda_stem(const void* x6, const void* w2, const void* bias, void* out, int n,
                         int xs_h, int ow, int cp, int kh, int oc, int poh, int pow_,
                         int relu, int dtype, int route, int band, int bands, int slots,
                         void* stream) {
  const int ncv = xs_h - kh + 1;
  if (n <= 0 || ow <= 0 || cp <= 0 || kh <= 0 || oc <= 0 || poh <= 0 || pow_ <= 0 ||
      ncv < 2 * poh - 1 || 2 * pow_ > ow + 1 || (dtype != 0 && dtype != 1) || band < 1 ||
      bands != (poh + band - 1) / band)
    return (int)cudaErrorInvalidValue;
  Args a = {x6, w2, (const float*)bias, out, n, xs_h, ow, cp, kh, oc, poh, pow_, relu};
  a.ncv = ncv;
  a.band = band;
  a.slots = slots;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kFma) {
    const size_t smem = fma_smem(a);
    if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
    return dtype == 0 ? launch(stem_fma<float>, a, bands, kFmaThreads, smem, s)
                      : launch(stem_fma<bf16>, a, bands, kFmaThreads, smem, s);
  }
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const size_t smem = mma_smem(a);
  if (route != kMma || dtype != 1 || ow % 16 != 0 || ow / 16 > kMaxWarps || cp % 16 != 0 ||
      oc % 16 != 0 || oc > 128 || !al(x6) || !al(w2) || ((uintptr_t)out & 3) != 0 ||
      slots <= kh || slots > kMaxSlots || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * (ow / 16);
  if (kh == 4 && cp == 48 && oc == 64) return launch(stem_mma<4, 4, 3>, a, bands, threads, smem, s);
  switch (oc / 16) {
    case 1: return launch(stem_mma<1, 0, 0>, a, bands, threads, smem, s);
    case 2: return launch(stem_mma<2, 0, 0>, a, bands, threads, smem, s);
    case 3: return launch(stem_mma<3, 0, 0>, a, bands, threads, smem, s);
    case 4: return launch(stem_mma<4, 0, 0>, a, bands, threads, smem, s);
    case 5: return launch(stem_mma<5, 0, 0>, a, bands, threads, smem, s);
    case 6: return launch(stem_mma<6, 0, 0>, a, bands, threads, smem, s);
    case 7: return launch(stem_mma<7, 0, 0>, a, bands, threads, smem, s);
    default: return launch(stem_mma<8, 0, 0>, a, bands, threads, smem, s);
  }
}
