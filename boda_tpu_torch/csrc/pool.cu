// NHWC max/avg pooling with caffe ceil-mode windows:
// out(N,OY,OX,C) = max or avg over x(N,H,W,C) windows of KH x KW at stride
// (SY, SX), the window starting at (oy*SY - PY, ox*SX - PX).
//
// Replaces K8, boda_tpu/ops/kernels/pool.py:253 pallas_pool (_pool_kernel
// :55, _pool_kernel_yblk :87). The TPU kernel holds a whole image plane (or
// a block of rows plus a halo) in VMEM and accumulates shifted slices; its
// plan declines planes over the VMEM budget. Here each thread owns one
// output pixel and 8 consecutive channels (one 16-byte load per window
// pixel in bf16) and walks its window clipped to the image, so the padding
// is never read: max starts at -inf and never sees a pad, avg sums the
// clipped window in f32 and multiplies by 1/count of its pixels (caffe's
// avg_pool_sz, which counts only non-padding pixels). No shape is refused.
//
// What bounds it on an H100: bytes. ResNet-50's pool1 (b32, 112x112x64 ->
// 56x56, 3x3 s2) reads 51 MB and writes 13 MB of bf16: ~19 us at 3.35 TB/s.
// Neighbouring threads take neighbouring channel groups, so a warp's loads
// of one window pixel are contiguous; the 3x3 s2 windows overlap, and the
// re-reads (2.25x) are served by L1/L2.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

struct PoolArgs {
  const void* x;
  void* out;
  int n, h, w, c, oy, ox, kh, kw, sy, sx, py, px, avg;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

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
      for (int e = 0; e < CPT; ++e) acc[e] = a.avg ? acc[e] + v[e] : fmaxf(acc[e], v[e]);
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

template <typename T, int CPT>
int launch(const PoolArgs& a, cudaStream_t s) {
  const long total = (long)a.n * a.oy * a.ox * (a.c / CPT);
  const long blocks = (total + 255) / 256;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  pool_kernel<T, CPT><<<(unsigned)blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int boda_pool2d(const void* x, void* out, int n, int h, int w, int c,
                           int oy, int ox, int kh, int kw, int sy, int sx, int py,
                           int px, int avg, int dtype, void* stream) {
  PoolArgs a = {x, out, n, h, w, c, oy, ox, kh, kw, sy, sx, py, px, avg};
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oy <= 0 || ox <= 0 || kh <= 0 ||
      kw <= 0 || sy <= 0 || sx <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 1>(a, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  bool vec = c % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  return vec ? launch<bf16, 8>(a, s) : launch<bf16, 1>(a, s);
}
