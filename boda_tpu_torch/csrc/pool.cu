// NHWC max/avg pooling with caffe ceil-mode windows:
// out(N,OY,OX,C) = max or avg over x(N,H,W,C) windows of KH x KW at stride
// (SY, SX), the window starting at (oy*SY - PY, ox*SX - PX).
//
// Replaces K8, boda_tpu/ops/kernels/pool.py:253 pallas_pool (_pool_kernel
// :55, _pool_kernel_yblk :87). The TPU kernel holds a whole image plane (or
// a block of rows plus a halo) in VMEM and accumulates shifted slices; its
// plan declines planes over the VMEM budget. Here every window is clipped to
// the image, so the padding is never read: max starts at -inf and never sees
// a pad, avg sums the clipped window in f32 and multiplies by 1/count of its
// pixels (caffe's avg_pool_sz, which counts only non-padding pixels). No
// shape is refused.
//
// What bounds it on an H100: bytes. ResNet-50's pool1 (b32, 112x112x64 ->
// 56x56, 3x3 s2 max) reads 51 MB and writes 13 MB of bf16, ~19 us at 3.35
// TB/s; pool5 (b32, 7x7x2048 -> 1x1 avg) reads 6.4 MB, ~2 us, as short as a
// launch's own ramp. Three routes, chosen by shape before the launch
// (ops/kernels/pool.py:route), with the plan worked out there:
//
//   * rows (bf16, C % 8 == 0, C <= 2048, 16-byte aligned; stride > 1, a
//     small window: pool1). A persistent grid; a block takes an equal share
//     of the output rows and walks the input rows their windows cover. An
//     NHWC row is contiguous, so one thread stages each with one 1-D bulk
//     copy (cp.async.bulk, L2 evict-first) into a ring of a few rows (3 at
//     pool1, 3 blocks per SM), the next rows' copies in flight while one is
//     reduced; each input byte leaves HBM once (a share's first row twice),
//     and no thread waits on a load of its own. The window is reduced
//     separably: each staged row's horizontal KW-max (or sum) at stride SX
//     into a second shared buffer of KH + 1 rows, then, for each output row
//     whose window that row ends, a vertical KH-max over it, written as
//     16-byte rows of 8 channels. One block barrier per input row.
//   * window (bf16, C % 8 == 0, 16-byte aligned; a large window over a few
//     outputs: pool5). A block takes one output pixel of one image and up to
//     32 lanes of 8 channels; its threads split the window's pixels into
//     slices (pixel p to slice p % slices), each summing or maxing its ~6
//     pixels in f32 with its loads independent, and the slices reduce through
//     shared memory. pool5 at b32: 65,536 threads with ~6 loads each, in
//     place of 8,192 threads walking 49 pixels one after another.
//   * thread (every other shape: f32, C % 8 != 0, misaligned pointers): one
//     thread per output pixel and 8 consecutive channels (one 16-byte load
//     per window pixel in bf16 when C % 8 == 0), walking its clipped window.
//
// Max is exact on every route; an avg's f32 sum is taken in another order on
// each route, rounded once to the output dtype.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Route { kThread = 0, kRows = 1, kWindow = 2 };

constexpr int kBarBytes = 128;  // the rows route's full[s] barriers
constexpr int kMaxSlots = 16;
constexpr int kMaxSmem = 232448;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 32;  // per-device state: the shared-memory opt-ins

struct PoolArgs {
  const void* x;
  void* out;
  int n, h, w, c, oy, ox, kh, kw, sy, sx, py, px, avg;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

union Pack8 {
  uint4 u;
  bf16 e[8];
};

__device__ __forceinline__ void fold8(float (&acc)[8], const uint4& u, bool avg) {
  Pack8 pk;
  pk.u = u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = __bfloat162float(pk.e[e]);
    acc[e] = avg ? acc[e] + v : boda::jmax(acc[e], v);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&acc)[8]) {
  Pack8 pk;
#pragma unroll
  for (int e = 0; e < 8; ++e) pk.e[e] = __float2bfloat16_rn(acc[e]);
  return pk.u;
}

// ---- thread: one thread per output pixel and CPT channels --------------------
// CPT channels per thread: 8 with 16-byte vectors (bf16, C % 8 == 0), else 1.
template <typename T, int CPT>
__global__ void __launch_bounds__(256) pool_kernel(PoolArgs a) {
  const int groups = a.c / CPT;
  const long total = (long)a.n * a.oy * a.ox * groups;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % groups);
  long t = i / groups;
  const int x_o = (int)(t % a.ox);
  t /= a.ox;
  const int y_o = (int)(t % a.oy);
  const int n = (int)(t / a.oy);
  const int y0 = y_o * a.sy - a.py, x0 = x_o * a.sx - a.px;
  const int ya = max(y0, 0), yb = min(y0 + a.kh, a.h);
  const int xa = max(x0, 0), xb = min(x0 + a.kw, a.w);
  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = a.avg ? 0.f : -INFINITY;
  const T* x = (const T*)a.x;
  for (int yy = ya; yy < yb; ++yy) {
    for (int xx = xa; xx < xb; ++xx) {
      const T* p = x + (((long)n * a.h + yy) * a.w + xx) * a.c + (long)g * CPT;
      float v[CPT];
      if constexpr (CPT == 8) {
        union {
          uint4 u;
          bf16 e[8];
        } pk;
        pk.u = *(const uint4*)p;
#pragma unroll
        for (int e = 0; e < CPT; ++e) v[e] = __bfloat162float(pk.e[e]);
      } else {
#pragma unroll
        for (int e = 0; e < CPT; ++e) v[e] = ld(p + e);
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[e] = a.avg ? acc[e] + v[e] : boda::jmax(acc[e], v[e]);
    }
  }
  if (a.avg) {
    // the clipped window's pixel count, as boda_tpu's _avg_divisor
    const float inv = 1.f / ((float)(yb - ya) * (float)(xb - xa));
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] *= inv;
  }
  T* o = (T*)a.out + (long)i * CPT;
#pragma unroll
  for (int e = 0; e < CPT; ++e) st(o + e, acc[e]);
}

// ---- rows: output rows from a ring of staged input rows --------------------
// Block b takes an equal share [t0, t1) of the output rows t = img * OY + oy
// (bands of rows dealt to the blocks in turn ran slower on the H100: more
// halo rows, and no block's rows follow on). The input rows it stages
// are, per image of that share, the rows from the first output row's window
// start to the last one's window end, clipped to the image: a sequence the
// ring walks in order, each row staged once.
__device__ __forceinline__ void seg_rows(const PoolArgs& a, int t0, int t1, int img, int& ya,
                                         int& yb) {
  const int oa = img == t0 / a.oy ? t0 % a.oy : 0;
  const int ob = img == (t1 - 1) / a.oy ? (t1 - 1) % a.oy : a.oy - 1;
  ya = max(oa * a.sy - a.py, 0);
  yb = min(ob * a.sy - a.py + a.kh, a.h);
}

struct RowCursor {  // an input row (img, y) of a block's sequence; its image's end yb
  int img, y, yb;
};

__device__ __forceinline__ RowCursor row_first(const PoolArgs& a, int t0, int t1) {
  RowCursor c;
  c.img = t0 / a.oy;
  seg_rows(a, t0, t1, c.img, c.y, c.yb);
  return c;
}

__device__ __forceinline__ void row_next(const PoolArgs& a, int t0, int t1, RowCursor& c) {
  if (++c.y == c.yb && ++c.img <= (t1 - 1) / a.oy) seg_rows(a, t0, t1, c.img, c.y, c.yb);
}

// 8 channels' running max in bf16 pairs (exact: a max is one of its inputs;
// NaN propagates, as jnp.maximum's does)
__device__ __forceinline__ void hmax8(uint4& acc, const uint4& v) {
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&acc);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hmax2_nan(a[k], b[k]);
}

__device__ __forceinline__ void sum8(float (&acc)[8], const float4& u, const float4& v) {
  acc[0] += u.x, acc[1] += u.y, acc[2] += u.z, acc[3] += u.w;
  acc[4] += v.x, acc[5] += v.y, acc[6] += v.z, acc[7] += v.w;
}

constexpr uint32_t kNegInfPair = 0xff80ff80u;  // two bf16 -inf

// `slots` input rows in the ring, each one 1-D bulk copy; KH + 1 rows of
// horizontal results (8 bf16, or 8 f32 for avg, per output column and 8
// channels). Input row j: wait for its copy, reduce it horizontally into
// hrow slot j % (KH + 1), one barrier (its ring slot is free: the copy of row
// j + slots goes in), then every output row whose window ends at row j is
// reduced vertically over the hrow slots of its rows and stored. The next
// row's horizontal pass writes a slot no such window reads, so one barrier per
// input row is all. Thread t takes channel group t % groups and output
// columns t / groups + k * (kThreads / groups): no division in the loops.
template <bool AVG>
__global__ void __launch_bounds__(kThreads) pool_rows(PoolArgs a, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int groups = a.c / 8;
  const int step = kThreads / groups;  // output columns in flight at once
  const int g = threadIdx.x % groups, xo = threadIdx.x / groups;
  const bool active = xo < step;
  const long row_bytes = (long)a.w * a.c * 2;
  const int hslots = a.kh + 1;
  const long hrow = (long)a.ox * groups;  // hbuf entries per row
  const uint32_t bars = boda::smem_u32(smem);
  unsigned char* ring = smem + kBarBytes;
  uint4* hmx = (uint4*)(ring + slots * row_bytes);    // max: [hslots][ox][groups]
  float4* hsum = (float4*)(ring + slots * row_bytes);  // avg: the same, x2
  const int total = a.n * a.oy;
  const int q = total / gridDim.x, r = total % gridDim.x;
  const int t0 = blockIdx.x * q + min((int)blockIdx.x, r);
  const int t1 = t0 + q + ((int)blockIdx.x < r ? 1 : 0);
  if (t0 >= t1) return;
  int nrows = 0;
  for (int img = t0 / a.oy; img <= (t1 - 1) / a.oy; ++img) {
    int ya, yb;
    seg_rows(a, t0, t1, img, ya, yb);
    nrows += yb - ya;
  }
  const bf16* x = (const bf16*)a.x;
  uint64_t policy = 0;
  RowCursor pc = row_first(a, t0, t1);  // the producer's next row (thread 0)
  auto issue = [&](int j) {             // row j into ring slot j % slots
    const uint32_t bar = bars + 8 * (j % slots);
    boda::mbar_expect_tx(bar, (uint32_t)row_bytes);
    boda::bulk_load_1d(boda::smem_u32(ring + (j % slots) * row_bytes),
                       x + ((long)pc.img * a.h + pc.y) * a.w * a.c, (uint32_t)row_bytes, bar,
                       policy);
    row_next(a, t0, t1, pc);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) boda::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    policy = boda::l2_evict_first();
    for (int j = 0; j < min(slots, nrows); ++j) issue(j);
  }
  __syncthreads();
  RowCursor cc = row_first(a, t0, t1);  // the row being reduced
  int t = t0;                           // the next output row to store
  for (int j = 0; j < nrows; ++j) {
    boda::mbar_wait(bars + 8 * (j % slots), (uint32_t)((j / slots) & 1));
    const uint4* in = (const uint4*)(ring + (j % slots) * row_bytes);  // [W][groups]
    const long hs = (long)(j % hslots) * hrow;
    for (int ox = active ? xo : a.ox; ox < a.ox; ox += step) {
      const int x0 = ox * a.sx - a.px;
      const int xa = max(x0, 0), xb = min(x0 + a.kw, a.w);
      const uint4* p = in + (long)xa * groups + g;
      const long he = hs + (long)ox * groups + g;
      if (AVG) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int xx = xa; xx < xb; ++xx, p += groups) fold8(acc, *p, true);
        hsum[2 * he] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        hsum[2 * he + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        uint4 acc = make_uint4(kNegInfPair, kNegInfPair, kNegInfPair, kNegInfPair);
        for (int xx = xa; xx < xb; ++xx, p += groups) hmax8(acc, *p);
        hmx[he] = acc;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && j + slots < nrows) issue(j + slots);
    // the output rows whose (clipped) window ends at this input row
    for (; t < t1; ++t) {
      const int oimg = t / a.oy, oy = t - oimg * a.oy;
      const int y0 = oy * a.sy - a.py;
      const int ya = max(y0, 0), yb = min(y0 + a.kh, a.h);
      if (oimg != cc.img || yb - 1 != cc.y) break;
      bf16* o = (bf16*)a.out + (long)t * a.ox * a.c + g * 8;
      for (int ox = active ? xo : a.ox; ox < a.ox; ox += step) {
        // input row yy sits at sequence index j - (cc.y - yy)
        const long he = (long)ox * groups + g;
        if (AVG) {
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int yy = ya; yy < yb; ++yy) {
            const long e = (long)((j - (cc.y - yy)) % hslots) * hrow + he;
            sum8(acc, hsum[2 * e], hsum[2 * e + 1]);
          }
          const int x0 = ox * a.sx - a.px;
          const int xa = max(x0, 0), xb = min(x0 + a.kw, a.w);
          const float inv = 1.f / ((float)(yb - ya) * (float)(xb - xa));
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] *= inv;
          *(uint4*)(o + (long)ox * a.c) = pack8(acc);
        } else {
          uint4 acc = make_uint4(kNegInfPair, kNegInfPair, kNegInfPair, kNegInfPair);
          for (int yy = ya; yy < yb; ++yy)
            hmax8(acc, hmx[(long)((j - (cc.y - yy)) % hslots) * hrow + he]);
          *(uint4*)(o + (long)ox * a.c) = acc;
        }
      }
    }
    row_next(a, t0, t1, cc);
  }
}

// ---- window: the window's pixels split across threads ----------------------
// threads = lanes x slices; lane l takes channel group cb * lanes + l, slice
// s the window pixels p with p % slices == s (row-major in the clipped
// window)
template <bool AVG>
__global__ void __launch_bounds__(kThreads) pool_window(PoolArgs a, int lanes, int slices) {
  __shared__ float4 part[kThreads * 2];  // [slice][lane] x 8 f32
  const int groups = a.c / 8;
  const int cgroups = (groups + lanes - 1) / lanes;
  const int cb = blockIdx.x % cgroups;
  const int t = blockIdx.x / cgroups;
  const int pix = t % (a.oy * a.ox), img = t / (a.oy * a.ox);
  const int oy = pix / a.ox, ox = pix % a.ox;
  const int lane = threadIdx.x % lanes, slice = threadIdx.x / lanes;
  const int g = cb * lanes + lane;
  const int y0 = oy * a.sy - a.py, x0 = ox * a.sx - a.px;
  const int ya = max(y0, 0), yb = min(y0 + a.kh, a.h);
  const int xa = max(x0, 0), xb = min(x0 + a.kw, a.w);
  const int wx = xb - xa, cnt = (yb - ya) * wx;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = AVG ? 0.f : -INFINITY;
  if (g < groups) {
    const uint4* x = (const uint4*)a.x + (long)img * a.h * a.w * groups + g;
    constexpr int kBatch = 8;  // loads in flight before any is folded
    for (int p0 = slice; p0 < cnt; p0 += kBatch * slices) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int p = p0 + j * slices;
        if (p < cnt) v[j] = x[((long)(ya + p / wx) * a.w + xa + p % wx) * groups];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (p0 + j * slices < cnt) fold8(acc, v[j], AVG);
    }
  }
  part[2 * threadIdx.x] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  part[2 * threadIdx.x + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  if (slice != 0 || g >= groups) return;
  for (int sl = 1; sl < slices; ++sl) {
    const float4 u = part[2 * (sl * lanes + lane)], v = part[2 * (sl * lanes + lane) + 1];
    const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = AVG ? acc[k] + w[k] : boda::jmax(acc[k], w[k]);
  }
  if (AVG) {
    const float inv = 1.f / (float)cnt;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] *= inv;
  }
  *(uint4*)((bf16*)a.out + (((long)img * a.oy + oy) * a.ox + ox) * a.c + g * 8) = pack8(acc);
}

template <typename T, int CPT>
int launch_thread(const PoolArgs& a, cudaStream_t s) {
  const long total = (long)a.n * a.oy * a.ox * (a.c / CPT);
  const long blocks = (total + 255) / 256;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  pool_kernel<T, CPT><<<(unsigned)blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool AVG>
int launch_rows(const PoolArgs& a, int blocks, int slots, cudaStream_t s) {
  if (slots < 1 || slots > kMaxSlots || a.c / 8 > kThreads) return (int)cudaErrorInvalidValue;
  const long hb = AVG ? 32 : 16;
  const long smem =
      kBarBytes + (long)slots * a.w * a.c * 2 + (long)(a.kh + 1) * a.ox * (a.c / 8) * hb;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB, allowed per function and per device (the attribute holds
  // for the current device only)
  static long allowed[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    cudaError_t e = cudaFuncSetAttribute(pool_rows<AVG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  pool_rows<AVG><<<blocks, kThreads, (int)smem, s>>>(a, slots);
  return (int)cudaGetLastError();
}

template <bool AVG>
int launch_window(const PoolArgs& a, int lanes, int slices, cudaStream_t s) {
  if (lanes < 1 || slices < 1 || lanes * slices > kThreads) return (int)cudaErrorInvalidValue;
  const long blocks = (long)a.n * a.oy * a.ox * ((a.c / 8 + lanes - 1) / lanes);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  pool_window<AVG><<<(unsigned)blocks, lanes * slices, 0, s>>>(a, lanes, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 thread, 1 rows (p0 blocks of
// the persistent grid, p1 input rows in the ring; C <= 2048), 2 window (p0
// lanes of 8 channels, p1 slices of the window). Rows and window take bf16
// with C % 8 == 0 and 16-byte aligned x and out. Returns cudaGetLastError()
// after the launch.
extern "C" int boda_pool2d(const void* x, void* out, int n, int h, int w, int c,
                           int oy, int ox, int kh, int kw, int sy, int sx, int py,
                           int px, int avg, int dtype, int route, int p0, int p1,
                           void* stream) {
  PoolArgs a = {x, out, n, h, w, c, oy, ox, kh, kw, sy, sx, py, px, avg};
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oy <= 0 || ox <= 0 || kh <= 0 ||
      kw <= 0 || sy <= 0 || sx <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool vec = dtype == 1 && c % 8 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  if (route == kRows || route == kWindow) {
    if (!vec) return (int)cudaErrorInvalidValue;
    if (route == kRows)
      return avg ? launch_rows<true>(a, p0, p1, s) : launch_rows<false>(a, p0, p1, s);
    return avg ? launch_window<true>(a, p0, p1, s) : launch_window<false>(a, p0, p1, s);
  }
  if (route != kThread) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_thread<float, 1>(a, s);
  return vec ? launch_thread<bf16, 8>(a, s) : launch_thread<bf16, 1>(a, s);
}
