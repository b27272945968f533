// Shared tiled GEMM core for sgemm.cu (plain GEMM) and conv.cu (implicit-GEMM
// NHWC conv). Both compute C[M,N] = A[M,K] . B[K,N] (+bias[N]) (+res[M,N])
// (+ReLU) with an f32 accumulator and the output in A's dtype; they differ
// only in how a tile of A is fetched:
//   * GEMM: A is a dense row-major [M,K] matrix.
//   * CONV: A[m,k] is gathered on the fly from the NHWC input, with
//     m = (n, oy, ox) an output pixel and k = (ky, kx, c) a filter tap, and
//     zero padding done by bounds masks (no im2col, no host-side pad).
// B is always the row-major [K,N] weight (HWIO flattened for the conv).
//
// bf16 runs on the tensor cores through WMMA (mma.sync) 16x16x16 fragments:
// a 256-thread block owns a 128x128 output tile, each of its 8 warps a 64x32
// sub-tile, and the K loop stages 128x32 A and 32x128 B tiles in shared
// memory. f32 runs on the FMA pipes (full f32, no TF32): 64x64 tiles, 4x4
// outputs per thread. Ragged M/N/K edges are masked in the kernel: loads
// outside the problem read 0, stores outside it are skipped.
//
// The output-tile index with the most tiles (M) is on gridDim.x, whose limit
// is 2^31-1; gridDim.y (N tiles) stays far below its 65,535 limit.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace boda {

using bf16 = __nv_bfloat16;

struct Prob {
  const void* a;
  const void* b;
  const void* bias;  // may be null
  const void* res;   // may be null
  void* c;
  int M, N, K, relu;
  // conv geometry; unused by the plain GEMM. KH is implied by K = KH*KW*C.
  int H, W, C, OH, OW, KW, sy, sx, py, px;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Per output row of a conv tile: the input image's first row index (n*H) and
// the top-left input coordinate of the row's receptive field.
struct RowInfo {
  int nh, iy, ix;
};

template <int ROWS>
__device__ __forceinline__ void fill_rows(RowInfo* ri, const Prob& p, long m0) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    long m = m0 + r;
    RowInfo v;
    if (m < p.M) {
      int ox = (int)(m % p.OW);
      long t = m / p.OW;
      int oy = (int)(t % p.OH);
      int n = (int)(t / p.OH);
      v.nh = n * p.H;
      v.iy = oy * p.sy - p.py;
      v.ix = ox * p.sx - p.px;
    } else {  // rows past M: an input row that is never in bounds
      v.nh = 0;
      v.iy = INT_MIN / 2;
      v.ix = 0;
    }
    ri[r] = v;
  }
}

// Flat input offset of A[m, k] for the conv, or -1 where it falls in the
// zero padding.
__device__ __forceinline__ long conv_off(const Prob& p, const RowInfo& r, int k) {
  int tap = k / p.C;
  int c = k - tap * p.C;
  int ky = tap / p.KW;
  int kx = tap - ky * p.KW;
  int iy = r.iy + ky, ix = r.ix + kx;
  if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return -1;
  return ((long)(r.nh + iy) * p.W + ix) * p.C + c;
}

template <typename T, bool CONV>
__device__ __forceinline__ T a_elem(const Prob& p, const RowInfo* ri, int r, long m,
                                    int k) {
  const T* A = (const T*)p.a;
  if (k >= p.K) return from_f32<T>(0.f);
  if (!CONV) return m < p.M ? A[m * p.K + k] : from_f32<T>(0.f);
  long off = conv_off(p, ri[r], k);
  return off < 0 ? from_f32<T>(0.f) : A[off];
}

// 8 consecutive bf16 of A's row m starting at k (k % 8 == 0). Needs K % 8 == 0
// (GEMM) or C % 8 == 0 (CONV, so the 8 stay inside one tap) and a 16-byte
// aligned base.
template <bool CONV>
__device__ __forceinline__ uint4 a_vec8(const Prob& p, const RowInfo* ri, int r, long m,
                                        int k) {
  const bf16* A = (const bf16*)p.a;
  uint4 z = make_uint4(0, 0, 0, 0);
  if (k >= p.K) return z;
  if (!CONV) return m < p.M ? *(const uint4*)(A + m * p.K + k) : z;
  long off = conv_off(p, ri[r], k);
  return off < 0 ? z : *(const uint4*)(A + off);
}

template <typename T>
__device__ __forceinline__ void store_out(const Prob& p, long m, int n, float v) {
  if (p.bias) v += to_f32(((const T*)p.bias)[n]);
  if (p.res) v += to_f32(((const T*)p.res)[m * p.N + n]);
  if (p.relu) v = fmaxf(v, 0.f);
  ((T*)p.c)[m * p.N + n] = from_f32<T>(v);
}

union Pack8 {
  uint4 u;
  unsigned short h[8];
};

constexpr int kThreads = 256;

// -- bf16: tensor cores through WMMA ------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kALd = kBK + 8, kBLd = kBN + 8;  // +8: skew smem banks

template <bool CONV, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads) gemm_bf16(Prob p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[kBM * kALd];
  __shared__ __align__(128) bf16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[(kThreads / 32) * 256];
  __shared__ RowInfo ri[CONV ? kBM : 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bf16* B = (const bf16*)p.b;
  if (CONV) {
    fill_rows<kBM>(ri, p, m0);
    __syncthreads();
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / 8 / kThreads; ++it) {
      int ch = tid + it * kThreads;
      int r = ch / (kBK / 8), kc = (ch % (kBK / 8)) * 8;
      Pack8 v;
      if (VA) {
        v.u = a_vec8<CONV>(p, ri, r, m0 + r, k0 + kc);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = __bfloat16_as_ushort(a_elem<bf16, CONV>(p, ri, r, m0 + r, k0 + kc + e));
      }
      *(uint4*)&As[r * kALd + kc] = v.u;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / 8 / kThreads; ++it) {
      int ch = tid + it * kThreads;
      int r = ch / (kBN / 8), nc = (ch % (kBN / 8)) * 8;
      int k = k0 + r, n = n0 + nc;
      Pack8 v;
      if (VB) {
        v.u = (k < p.K && n < p.N) ? *(const uint4*)(B + (long)k * p.N + n)
                                   : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = (k < p.K && n + e < p.N)
                       ? __bfloat16_as_ushort(B[(long)k * p.N + n + e])
                       : (unsigned short)0;
      }
      *(uint4*)&Bs[r * kBLd + nc] = v.u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 64 + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: each warp stages one 16x16 fragment at a time in shared memory
  // and applies bias(+residual)(+ReLU) on the way out
  float* cs = Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        long m = m0 + wm * 64 + i * 16 + (e >> 4);
        int n = n0 + wn * 32 + j * 16 + (e & 15);
        if (m < p.M && n < p.N) store_out<bf16>(p, m, n, cs[e]);
      }
      __syncwarp();
    }
  }
}

// -- f32: FMA, full precision ---------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <bool CONV>
__global__ void __launch_bounds__(kThreads) gemm_f32(Prob p) {
  __shared__ float As[kFK][kFM + 4];  // transposed: As[k][m]
  __shared__ float Bs[kFK][kFN + 4];
  __shared__ RowInfo ri[CONV ? kFM : 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long m0 = (long)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const float* B = (const float*)p.b;
  if (CONV) {
    fill_rows<kFM>(ri, p, m0);
    __syncthreads();
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    for (int e = tid; e < kFM * kFK; e += kThreads) {
      int r = e / kFK, kc = e % kFK;
      As[kc][r] = a_elem<float, CONV>(p, ri, r, m0 + r, k0 + kc);
    }
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      int r = e / kFN, nc = e % kFN;
      int k = k0 + r, n = n0 + nc;
      Bs[r][nc] = (k < p.K && n < p.N) ? B[(long)k * p.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long m = m0 + ty + 16 * i;
      int n = n0 + tx + 16 * j;
      if (m < p.M && n < p.N) store_out<float>(p, m, n, acc[i][j]);
    }
}

static inline bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (a refused launch never runs, and a later synchronize would not say so).
template <bool CONV>
static int launch_gemm(const Prob& p, int dtype, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    dim3 grid((p.M + kFM - 1) / kFM, (p.N + kFN - 1) / kFN);
    gemm_f32<CONV><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1) {
    dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
    bool va = (CONV ? p.C % 8 == 0 : p.K % 8 == 0) && aligned16(p.a);
    bool vb = p.N % 8 == 0 && aligned16(p.b);
    if (va && vb)
      gemm_bf16<CONV, true, true><<<grid, kThreads, 0, s>>>(p);
    else if (va)
      gemm_bf16<CONV, true, false><<<grid, kThreads, 0, s>>>(p);
    else if (vb)
      gemm_bf16<CONV, false, true><<<grid, kThreads, 0, s>>>(p);
    else
      gemm_bf16<CONV, false, false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace boda
