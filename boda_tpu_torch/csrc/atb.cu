// Leading-axis-contraction GEMM, out[M,N] = sum_k a[k,m] . b[k,n], f32
// accumulate and f32 output, without materialising a^T: the port of K5.
//
// Replaces the TPU kernel K5, boda_tpu/ops/kernels/bconv.py:53
// pallas_matmul_atb (_atb_kernel :38), and the per-tap loop around it in
// pallas_conv2d_bck_filts (:115-142), the weight gradient of a stride-1 conv:
//   dW[ky,kx,c,oc] = sum_{n,oy,ox} xpad[n,oy+ky,ox+kx,c] . dY[n,oy,ox,oc].
// Two forms of A:
//   * dense: A is a row-major [K,M] matrix (matmul_atb);
//   * gather: A's row k is the input pixel that output pixel k = (n,oy,ox)
//     reads through filter tap (ky,kx), fetched straight from the NHWC input
//     with bounds masks for the zero padding. One launch writes the whole
//     (KH,KW,C,OC) gradient: no per-tap copies of x, no padded x in HBM.
//
// On the TPU the k grid axis runs in order and carries a VMEM accumulator.
// Here the difficulty is the shape: the output is tiny next to the
// contraction (ResNet-50 at batch 32: a 64x64 output over K = 100,352), so a
// grid over output tiles alone would leave almost every SM idle. The K range
// is therefore split: each split writes its f32 partial tile to a workspace
// (ws[split][tap][M][N]), and a second kernel sums the splits in a fixed
// order. No float atomics: the result has the same bits on every run. The
// wrapper (ops/kernels/bconv.py) picks the path, the tile and the splits and
// allocates the workspace.
//
// What bounds it on an H100: in bf16 the product does M*N/(M+N) FLOP per
// byte of A and B it must read, from 32 (64x64, res2) to 410 (512x2048,
// res5) at the ResNet-50 wgrad shapes, against the card's ~295 FLOP/B ridge:
// res2-res4 are bound by bytes, res5 by the tensor cores.
//
// Four paths, chosen by shape before the launch (bconv.py:plan_atb):
//   * wgmma (bf16, M % 8 == 0, N % 8 == 0, 16-byte aligned operands): the
//     GEMM core's wgmma path (gemm.cuh, modes kModeAtb and kModeWgrad). A's
//     stage is stored MN-major (64 K rows by 64 M columns per 128-byte
//     swizzled box, as B's) and read through wgmma's transpose-A bit; the
//     dense A comes by TMA, the gathered A by 16-byte zero-fill cp.async
//     with the output pixel carried from chunk to chunk; dY comes by TMA. A
//     persistent grid walks output tile x tap x split with the ring running
//     on across items, so loads overlap the MMAs and every SM streams x and
//     dY at its share of HBM; tiles of 64 or 128 rows and 64-256 columns,
//     so res2's 64-wide outputs do not pay for 128x128.
//   * wgmma_edge (the dense form in bf16 with M % 8 == 0, N % 8 != 0 and N
//     even, such as fc1000's (tp=2) wgrad at N = 500): the same path with
//     B's rows padded to 16 bytes in memory (ldb, a multiple of 8 >= N; the
//     training step's fc writes dY so), TMA reading the columns past N as
//     zeros, the f32 output stored in 8-byte pairs masked at the N edge;
//     tiles of 64 or 128 rows and columns.
//   * mma (bf16, every other shape): WMMA (mma.sync) on one shared-memory
//     buffer, 128x128 tiles, A staged [k][m] as it lies and loaded as a
//     col_major matrix_a fragment; splits over gridDim.z.
//   * fma (f32): full-precision FMA, 64x64 tiles (no TF32).
// Ragged M/N/K edges are masked in the loads and stores.
#include <cstdint>

#include "gemm.cuh"

namespace {

using boda::bf16;
using boda::kThreads;
using boda::Pack8;

struct AtbProb {
  const void* a;  // dense: [K,M] row-major; gather: x (N,H,W,C=M) NHWC
  const void* b;  // [K,N] row-major, rows ldb apart (dY as (N*OH*OW, OC) for the wgrad)
  float* out;     // [taps, M, N]
  float* ws;      // [splits, taps, M, N] partial sums; used when splits > 1
  int M, N, K, ldb;
  int splits, chunk;  // split s covers k in [s*chunk, min(K, (s+1)*chunk))
  // gather geometry: k = (n, oy, ox) an output pixel; tap = (ky, kx)
  int H, W, OH, OW, KW, py, px;
};

// Element offset of A's row k (a[k, 0]) for filter tap (ky, kx), or -1 where
// the row is zero padding.
template <bool GATHER>
__device__ __forceinline__ long a_row(const AtbProb& p, int k, int ky, int kx) {
  if (!GATHER) return (long)k * p.M;
  int ox = k % p.OW;
  int t = k / p.OW;
  int oy = t % p.OH;
  int n = t / p.OH;
  int iy = oy + ky - p.py, ix = ox + kx - p.px;
  if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return -1;
  return (((long)n * p.H + iy) * p.W + ix) * p.M;
}

// This block's filter tap, K range and destination (the output slice when
// there is one split, else its partial-sum slice of the workspace).
struct Range {
  int ky, kx, k_begin, k_end;
  float* dst;
};

__device__ __forceinline__ Range block_range(const AtbProb& p) {
  Range r;
  int tap = blockIdx.z / p.splits;
  int s = blockIdx.z - tap * p.splits;
  r.ky = tap / p.KW;
  r.kx = tap - r.ky * p.KW;
  r.k_begin = s * p.chunk;
  r.k_end = min(p.K, r.k_begin + p.chunk);
  long mn = (long)p.M * p.N;
  int taps = gridDim.z / p.splits;
  r.dst = p.splits == 1 ? p.out + tap * mn : p.ws + ((long)s * taps + tap) * mn;
  return r;
}

// -- bf16: tensor cores through WMMA ------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kALd = kBM + 8, kBLd = kBN + 8;  // +8: skew smem banks

template <bool GATHER, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads) atb_bf16(AtbProb p) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[kBK * kALd];  // [k][m], as A lies
  __shared__ __align__(128) bf16 Bs[kBK * kBLd];  // [k][n]
  __shared__ __align__(128) float Cs[(kThreads / 32) * 256];
  __shared__ long rows[kBK];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const Range rg = block_range(p);
  const bf16* A = (const bf16*)p.a;
  const bf16* B = (const bf16*)p.b;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = rg.k_begin; k0 < rg.k_end; k0 += kBK) {
    if (tid < kBK) {
      int k = k0 + tid;
      rows[tid] = k < rg.k_end ? a_row<GATHER>(p, k, rg.ky, rg.kx) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kBK * kBM / 8 / kThreads; ++it) {
      int ch = tid + it * kThreads;
      int r = ch / (kBM / 8), mc = (ch % (kBM / 8)) * 8;
      long off = rows[r];
      int m = m0 + mc;
      Pack8 v;
      if (VA) {
        v.u = (off >= 0 && m < p.M) ? *(const uint4*)(A + off + m) : zero;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = (off >= 0 && m + e < p.M) ? __bfloat16_as_ushort(A[off + m + e])
                                             : (unsigned short)0;
      }
      *(uint4*)&As[r * kALd + mc] = v.u;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / 8 / kThreads; ++it) {
      int ch = tid + it * kThreads;
      int r = ch / (kBN / 8), nc = (ch % (kBN / 8)) * 8;
      int k = k0 + r, n = n0 + nc;
      Pack8 v;
      if (VB) {
        v.u = (k < rg.k_end && n < p.N) ? *(const uint4*)(B + (long)k * p.ldb + n) : zero;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = (k < rg.k_end && n + e < p.N)
                       ? __bfloat16_as_ushort(B[(long)k * p.ldb + n + e])
                       : (unsigned short)0;
      }
      *(uint4*)&Bs[r * kBLd + nc] = v.u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // (m, k) of a col_major 16x16 fragment is ptr[m + k * ld]: As[k][m]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], As + kk * kALd + wm * 64 + i * 16, kALd);
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
  // each warp stages one 16x16 fragment at a time and stores it masked
  float* cs = Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int m = m0 + wm * 64 + i * 16 + (e >> 4);
        int n = n0 + wn * 32 + j * 16 + (e & 15);
        if (m < p.M && n < p.N) rg.dst[(long)m * p.N + n] = cs[e];
      }
      __syncwarp();
    }
  }
}

// -- f32: FMA, full precision ---------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <bool GATHER>
__global__ void __launch_bounds__(kThreads) atb_f32(AtbProb p) {
  __shared__ float As[kFK][kFM + 4];  // [k][m], as A lies
  __shared__ float Bs[kFK][kFN + 4];
  __shared__ long rows[kFK];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const Range rg = block_range(p);
  const float* A = (const float*)p.a;
  const float* B = (const float*)p.b;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = rg.k_begin; k0 < rg.k_end; k0 += kFK) {
    if (tid < kFK) {
      int k = k0 + tid;
      rows[tid] = k < rg.k_end ? a_row<GATHER>(p, k, rg.ky, rg.kx) : -1;
    }
    __syncthreads();
    for (int e = tid; e < kFK * kFM; e += kThreads) {
      int r = e / kFM, mc = e % kFM;
      long off = rows[r];
      int m = m0 + mc;
      As[r][mc] = (off >= 0 && m < p.M) ? A[off + m] : 0.f;
    }
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      int r = e / kFN, nc = e % kFN;
      int k = k0 + r, n = n0 + nc;
      Bs[r][nc] = (k < rg.k_end && n < p.N) ? B[(long)k * p.ldb + n] : 0.f;
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
      int m = m0 + ty + 16 * i;
      int n = n0 + tx + 16 * j;
      if (m < p.M && n < p.N) rg.dst[(long)m * p.N + n] = acc[i][j];
    }
}

template <bool GATHER>
int launch(const AtbProb& p, int taps, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    dim3 grid((p.M + kFM - 1) / kFM, (p.N + kFN - 1) / kFN, taps * p.splits);
    atb_f32<GATHER><<<grid, kThreads, 0, s>>>(p);
  } else {
    dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN, taps * p.splits);
    bool va = p.M % 8 == 0 && boda::aligned16(p.a);
    bool vb = p.N % 8 == 0 && p.ldb % 8 == 0 && boda::aligned16(p.b);
    if (va && vb)
      atb_bf16<GATHER, true, true><<<grid, kThreads, 0, s>>>(p);
    else if (va)
      atb_bf16<GATHER, true, false><<<grid, kThreads, 0, s>>>(p);
    else if (vb)
      atb_bf16<GATHER, false, true><<<grid, kThreads, 0, s>>>(p);
    else
      atb_bf16<GATHER, false, false><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b alike; out is always float32).
// gather = 0: a is [K,M] and there is one tap (KH = KW = 1). gather = 1: a is
// the NHWC input (N,H,W,C=M), b is dY as (N*OH*OW, OC=N) with K = N*OH*OW,
// stride 1, and out is (KH,KW,M,N). ldb: b's row stride in elements (>= N;
// N when dense, as the gather takes it; a multiple of 8 on wgmma_edge).
// path (gemm.cuh enum Path), bm, bn,
// splits, chunk: the plan (ops/kernels/bconv.py:plan_atb); split s covers k
// in [s*chunk, min(K, (s+1)*chunk)), chunk a multiple of the path's K step
// (64 wgmma and wgmma_edge, 32 mma, 16 fma), no split empty; ws: splits x taps x M x N f32
// when splits > 1. A plan this entry point cannot run is refused
// (cudaErrorInvalidValue), never rerouted. Returns cudaGetLastError() after
// the launches.
extern "C" int boda_atb(const void* a, const void* b, void* out, void* ws, int M, int N,
                        int K, int splits, int chunk, int gather, int H, int W, int OH,
                        int OW, int KH, int KW, int py, int px, int dtype, int path, int bm,
                        int bn, int ldb, void* stream) {
  const bool ring = path == boda::kPathWgmma || path == boda::kPathWgmmaEdge;
  const int bk = ring ? boda::kChunk : dtype == 0 ? kFK : kBK;
  if (M <= 0 || N <= 0 || K <= 0 || ldb < N || splits <= 0 || chunk <= 0 || chunk % bk != 0 ||
      (long)(splits - 1) * chunk >= K || (long)splits * chunk < K ||
      (splits > 1 && ws == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (gather && (KH <= 0 || KW <= 0 || OH <= 0 || OW <= 0 || K % (OH * OW) != 0 || ldb != N))
    return (int)cudaErrorInvalidValue;
  const int taps = gather ? KH * KW : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ring) {
    // the edge route is the dense form's: the gather's dY is dense
    if (dtype != 1 || (path == boda::kPathWgmmaEdge && gather)) return (int)cudaErrorInvalidValue;
    boda::Prob p = {};
    p.a = a;
    p.b = b;
    p.c = out;
    p.M = M;
    p.N = N;
    p.K = K;
    p.ldb = ldb;
    p.H = H;
    p.W = W;
    p.OH = OH;
    p.OW = OW;
    p.KW = gather ? KW : 1;
    p.py = py;
    p.px = px;
    p.taps = taps;
    p.nimg = gather ? K / (OH * OW) : 0;
    const int per = chunk / boda::kChunk;
    if (path == boda::kPathWgmmaEdge)
      return boda::launch_wgmma<boda::kModeAtb, false, true>(p, bm, bn, splits, per, ws, s);
    return gather ? boda::launch_wgmma<boda::kModeWgrad>(p, bm, bn, splits, per, ws, s)
                  : boda::launch_wgmma<boda::kModeAtb>(p, bm, bn, splits, per, ws, s);
  }
  if (path != (dtype == 0 ? boda::kPathFma : boda::kPathMma)) return (int)cudaErrorInvalidValue;
  AtbProb p = {};
  p.a = a;
  p.b = b;
  p.out = (float*)out;
  p.ws = (float*)ws;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldb = ldb;
  p.splits = splits;
  p.chunk = chunk;
  p.H = H;
  p.W = W;
  p.OH = OH;
  p.OW = OW;
  p.KW = gather ? KW : 1;
  p.py = py;
  p.px = px;
  if (taps * splits > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  int rc = gather ? launch<true>(p, taps, dtype, s) : launch<false>(p, taps, dtype, s);
  if (rc != 0 || splits == 1) return rc;
  return boda::reduce_f32(p.ws, p.out, (long)M * N * taps, splits, s);
}
