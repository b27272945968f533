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
// and pools the f32 accumulator with rolls and strided reshapes. Here one
// thread block takes one image and a chunk of R pooled rows (R = 2 at the
// ResNet-50 stem, chosen by the launcher as the largest R <= 2 whose conv rows
// fit shared memory): it computes the 2R+1 conv rows the chunk's windows read,
// a (rows*OW, KH*CP) x (KH*CP, OC) product, into shared memory, then pools
// them there. The full-resolution conv output never reaches device memory.
//
// The deep-K operand needs no gather: for a fixed tap row ky, the 16 conv
// pixels ox0..ox0+15 of conv row cy read x6[n, cy+ky, ox0.., :], a row-major
// 16 x CP matrix with leading dimension CP, so bf16 loads its A fragments
// straight from device memory (through L1/L2: each input row is read by KH
// conv rows) and w2 once per block into shared memory; WMMA (mma.sync)
// 16x16x16, f32 accumulators stored to shared memory. Pooling the raw sums and
// adding bias and ReLU after the max gives the same values as the other order:
// both are monotone, and so is the final rounding. float32, and bf16 shapes off
// that path (OW, CP or OC not multiples of 16, OC > 128, misaligned pointers),
// run the same plan on the FMA pipes.
//
// What bounds it on an H100: bytes. At the ResNet-50 b32 stem, x6 is
// 32x115x112x48 bf16 (39.6 MB, the 7x7 s2 input after the host's s2d and dx
// folds) and the pooled output 12.8 MB: ~16 us at 3.35 TB/s, against ~10 us
// of bf16 tensor-core work (9.9 GFLOP). The 112x112x64 conv activation, 51 MB
// that an unfused conv writes and the pool reads back, never exists.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt into
constexpr int kMaxChunk = 2;        // pooled rows per block

struct Args {
  const void* x6;
  const void* w2;
  const float* bias;
  void* out;
  int n, xs_h, ow, cp, kh, oc, poh, pow_, relu;
  int ncv, chunk, chunks, lds;  // lds: the conv tile's row pitch in floats
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Pool the block's conv rows S (local row r, column ox, channel oc at
// S[(r * OW + ox) * lds + oc]) into its chunk of pooled rows.
template <typename T>
__device__ void pool_store(const Args& a, const float* S, int n, int p0, int rows, int cy0,
                           int nrows) {
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
        m = fmaxf(m, S[((long)r * a.ow + ox) * a.lds + oc]);
      }
    }
    float v = m + a.bias[oc];
    if (a.relu) v = fmaxf(v, 0.f);
    out[(((long)n * a.poh + p0 + pr) * a.pow_ + px) * a.oc + oc] = from_f32<T>(v);
  }
}

// bf16 on the tensor cores: NF = OC / 16 accumulator fragments per warp, each
// warp taking 16-pixel strips of a conv row.
template <int NF>
__global__ void __launch_bounds__(kThreads) stem_wmma(Args a) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kdim = a.kh * a.cp, ldb = a.oc + 8;  // +8: skew the banks
  bf16* Bs = (bf16*)smem;
  float* S = (float*)(smem + (((size_t)kdim * ldb * 2 + 127) / 128) * 128);
  const int n = blockIdx.y, p0 = blockIdx.x * a.chunk;
  const int rows = min(a.chunk, a.poh - p0), cy0 = 2 * p0;
  const int nrows = min(2 * rows + 1, a.ncv - cy0);
  const bf16* w2 = (const bf16*)a.w2;
  for (int i = threadIdx.x; i < kdim * a.oc / 8; i += blockDim.x) {
    const int k = i / (a.oc / 8), c8 = (i % (a.oc / 8)) * 8;
    *(uint4*)&Bs[k * ldb + c8] = *(const uint4*)&w2[(long)k * a.oc + c8];
  }
  __syncthreads();
  const bf16* x6 = (const bf16*)a.x6;
  const int warp = threadIdx.x >> 5, strips_per_row = a.ow / 16;
  for (int s = warp; s < nrows * strips_per_row; s += kThreads / 32) {
    const int r = s / strips_per_row, ox0 = (s % strips_per_row) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int ky = 0; ky < a.kh; ++ky) {
      const bf16* arow = x6 + (((long)n * a.xs_h + cy0 + r + ky) * a.ow + ox0) * a.cp;
      for (int j0 = 0; j0 < a.cp; j0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, arow + j0, a.cp);
        const bf16* brow = Bs + (ky * a.cp + j0) * ldb;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, brow + f * 16, ldb);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wmma::store_matrix_sync(S + ((long)r * a.ow + ox0) * a.lds + f * 16, acc[f], a.lds,
                              wmma::mem_row_major);
  }
  __syncthreads();
  pool_store<bf16>(a, S, n, p0, rows, cy0, nrows);
}

// Any dtype and shape on the FMA pipes: w2 in shared memory as f32; each
// thread takes one output channel and 4 neighbouring conv pixels at a time
// (the 4 input values a warp reads at one k are one broadcast each).
template <typename T>
__global__ void __launch_bounds__(kThreads) stem_fma(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kdim = a.kh * a.cp;
  float* Bs = (float*)smem;
  float* S = Bs + (((size_t)kdim * a.oc + 31) / 32) * 32;
  const int n = blockIdx.y, p0 = blockIdx.x * a.chunk;
  const int rows = min(a.chunk, a.poh - p0), cy0 = 2 * p0;
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
      if (ox0 + q < a.ow) S[((long)r * a.ow + ox0 + q) * a.lds + oc] = acc[q];
  }
  __syncthreads();
  pool_store<T>(a, S, n, p0, rows, cy0, nrows);
}

template <typename K>
int launch(K kernel, const Args& a, size_t smem, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.chunks, a.n), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// bias is float32 (OC). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// geometry the pool cannot read (NCV < 2*POH - 1, POW > ceil(OW/2)) or whose
// conv rows do not fit shared memory.
extern "C" int boda_stem(const void* x6, const void* w2, const void* bias, void* out, int n,
                         int xs_h, int ow, int cp, int kh, int oc, int poh, int pow_,
                         int relu, int dtype, void* stream) {
  const int ncv = xs_h - kh + 1;
  if (n <= 0 || ow <= 0 || cp <= 0 || kh <= 0 || oc <= 0 || poh <= 0 || pow_ <= 0 ||
      ncv < 2 * poh - 1 || 2 * pow_ > ow + 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p & 31) == 0; };
  const bool tc = dtype == 1 && ow % 16 == 0 && cp % 16 == 0 && oc % 16 == 0 && oc <= 128 &&
                  al(x6) && al(w2);
  Args a = {x6, w2, (const float*)bias, out, n, xs_h, ow, cp, kh, oc, poh, pow_, relu};
  a.ncv = ncv;
  a.lds = tc ? oc + 4 : oc;
  const size_t kdim = (size_t)kh * cp;
  const size_t wbytes = tc ? ((kdim * (oc + 8) * 2 + 127) / 128) * 128
                           : ((kdim * oc + 31) / 32) * 32 * 4;
  int chunk = kMaxChunk;
  size_t smem = 0;
  for (; chunk >= 1; --chunk) {
    smem = wbytes + (size_t)(2 * chunk + 1) * ow * a.lds * 4;
    if (smem <= (size_t)kSmemLimit) break;
  }
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  a.chunk = chunk;
  a.chunks = (poh + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  if (!tc) return dtype == 0 ? launch(stem_fma<float>, a, smem, s) : launch(stem_fma<bf16>, a, smem, s);
  switch (oc / 16) {
    case 1: return launch(stem_wmma<1>, a, smem, s);
    case 2: return launch(stem_wmma<2>, a, smem, s);
    case 3: return launch(stem_wmma<3>, a, smem, s);
    case 4: return launch(stem_wmma<4>, a, smem, s);
    case 5: return launch(stem_wmma<5>, a, smem, s);
    case 6: return launch(stem_wmma<6>, a, smem, s);
    case 7: return launch(stem_wmma<7>, a, smem, s);
    default: return launch(stem_wmma<8>, a, smem, s);
  }
}
