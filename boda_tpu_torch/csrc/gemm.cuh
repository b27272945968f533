// Shared GEMM core for sgemm.cu (plain GEMM), conv.cu (implicit-GEMM NHWC
// conv) and, on its wgmma path, atb.cu (the leading-axis GEMM and the conv's
// weight gradient); block.cu takes its TMA, mbarrier and wgmma pieces (with
// the register-A WgmmaRA) and its tensor maps. The first two compute C[M,N] = A[M,K] . B[K,N] (+bias[N])
// (+res[M,N]) (+ReLU) with an f32 accumulator and one rounding to the output
// dtype; they differ only in how a tile of A is fetched:
//   * GEMM: A is a dense row-major [M,K] matrix.
//   * CONV: A[m,k] is gathered on the fly from the NHWC input, with
//     m = (n, oy, ox) an output pixel and k = (ky, kx, c) a filter tap, and
//     zero padding done by bounds masks (no im2col, no host-side pad).
// B is always a row-major [K,N] matrix (HWIO flattened for the conv).
// atb.cu's two modes store A MN-major (its rows are K) and write f32 with no
// epilogue: see "Operand modes" at the wgmma path.
//
// Five paths, chosen by the caller's plan (ops/kernels/common.py:plan_gemm)
// from the shape before the launch, never after a failure:
//   * wgmma (bf16; A's rows 16-byte aligned in memory: the GEMM's lda % 8 ==
//     0, any K, or the conv's C % 8 == 0; N % 8 == 0, 16-byte aligned
//     operands): Hopper's warpgroup MMA fed by a ring of 3-8 stages of
//     64-deep K chunks in shared memory (gemm_wgmma below). A GEMM with K % 8
//     != 0 (fc1000's (tp=2) dgrad, K = 500) reads A from rows padded to a
//     multiple of 8 elements (lda); TMA reads the columns past K as zeros.
//   * wgmma_narrow (bf16 conv with C % 8 != 0, such as every C = 3 stem;
//     N % 8 == 0, B, the output, the bias and the residual 16-byte aligned,
//     x in any alignment): the same ring and consumers, with the conv's A
//     built element by element by the producer (NARROW below), 64-row tiles.
//   * wgmma_edge (bf16 with N % 8 != 0 and N even, such as ssd300's
//     mbox_conf heads at N = 84 and 126; otherwise as wgmma): the same ring,
//     B's rows padded to 16 bytes in memory (ldb, a multiple of 8 >= N;
//     TMA reads the columns past N as zeros), the output written straight
//     from the accumulators by 4-byte stores masked at the edge (EDGE
//     below), and a split-K reduce by column pairs. Tiles of 64 or 128
//     rows and columns.
//   * mma (bf16, every other shape: odd N, the GEMM's lda % 8 != 0, a narrow
//     conv with N % 8 != 0, a misaligned operand): WMMA (mma.sync) 16x16x16
//     fragments on a 128x128 tile, one buffer.
//   * fma (f32): FMA pipes, full f32 (no TF32), 64x64 tiles.
// Ragged M/N/K edges are masked in the kernels: loads outside the problem
// read 0, stores outside it are skipped. B is read at its row stride ldb, and
// the GEMM's A at its row stride lda, on every path (N and K when dense).
//
// The output-tile index with the most tiles (M) is on gridDim.x, whose limit
// is 2^31-1; gridDim.y (N tiles) stays far below its 65,535 limit.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
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
  int ldb;  // B's row stride in elements (>= N; a multiple of 8 on the wgmma paths)
  int lda;  // the GEMM's A row stride in elements (>= K; a multiple of 8 on the wgmma
            // paths); unused by the conv, whose A is gathered
  // conv geometry; unused by the plain GEMM. KH is implied by K = KH*KW*C.
  int H, W, C, OH, OW, KW, sy, sx, py, px;
  // the f32 modes: filter taps (KH*KW for kModeWgrad, 1 for kModeAtb) and
  // kModeWgrad's images, with K = nimg*OH*OW
  int taps, nimg;
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
  if (!CONV) return m < p.M ? A[m * p.lda + k] : from_f32<T>(0.f);
  long off = conv_off(p, ri[r], k);
  return off < 0 ? from_f32<T>(0.f) : A[off];
}

// 8 consecutive bf16 of A's row m starting at k (k % 8 == 0). Needs K % 8 == 0
// and lda % 8 == 0 (GEMM) or C % 8 == 0 (CONV, so the 8 stay inside one tap)
// and a 16-byte aligned base.
template <bool CONV>
__device__ __forceinline__ uint4 a_vec8(const Prob& p, const RowInfo* ri, int r, long m,
                                        int k) {
  const bf16* A = (const bf16*)p.a;
  uint4 z = make_uint4(0, 0, 0, 0);
  if (k >= p.K) return z;
  if (!CONV) return m < p.M ? *(const uint4*)(A + m * p.lda + k) : z;
  long off = conv_off(p, ri[r], k);
  return off < 0 ? z : *(const uint4*)(A + off);
}

// jnp.maximum: NaN propagates (as the quiet NaN torch.maximum returns), and a
// tie of -0 and +0 gives +0 (the AND of the two bit patterns; for any other tie
// both are the same value). Every max and ReLU on a value path of the port's
// kernels goes through jmax, relu_j or, for packed bf16 pairs, __hmax2_nan:
// fmaxf and __hmax2 return the side that is not NaN.
__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a || b != b) return __uint_as_float(0x7fc00000u);
  if (a == b) return __uint_as_float(__float_as_uint(a) & __float_as_uint(b));
  return a > b ? a : b;
}

// jmax(v, 0) without the branches: NaN stays NaN, -0 and +0 give +0
__device__ __forceinline__ float relu_j(float v) { return (v > 0.f || v != v) ? v : 0.f; }

template <typename T>
__device__ __forceinline__ void store_out(const Prob& p, long m, int n, float v) {
  if (p.bias) v += to_f32(((const T*)p.bias)[n]);
  if (p.res) v += to_f32(((const T*)p.res)[m * p.N + n]);
  if (p.relu) v = relu_j(v);
  ((T*)p.c)[m * p.N + n] = from_f32<T>(v);
}

union Pack8 {
  uint4 u;
  unsigned short h[8];
};

constexpr int kThreads = 256;

// -- bf16, the mma path: tensor cores through WMMA ------------------------------------------
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
        v.u = (k < p.K && n < p.N) ? *(const uint4*)(B + (long)k * p.ldb + n)
                                   : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v.h[e] = (k < p.K && n + e < p.N)
                       ? __bfloat16_as_ushort(B[(long)k * p.ldb + n + e])
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
      Bs[r][nc] = (k < p.K && n < p.N) ? B[(long)k * p.ldb + n] : 0.f;
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

// -- bf16, the wgmma path -------------------------------------------------------
//
// A persistent grid (one block per SM at most) walks the work items: output
// tiles of BM x BN (BM = 64 x NWG), times the K splits. A block runs NWG + 1
// warpgroups (NWG + 2 for the narrow conv). The last is the producer (the
// last two for the narrow conv): it only fills a ring of stages in
// shared memory, each one K chunk of 64 (128 bytes of bf16, one 128-byte
// swizzle row): B (and the GEMM's A) by TMA with the 128-byte swizzle, the
// conv's A by 16-byte cp.async copies with zero-fill for the padding and for
// rows past M, written at the swizzled address TMA would have used (the
// narrow conv, C % 8 != 0: each thread builds the same 16 bytes from 8 element
// loads, each with its own tap and bounds test, and stores them there). Each
// stage has a full and an empty mbarrier, and the ring runs on across work
// items, so the next tile's chunks load while this one's epilogue runs. The
// other NWG warpgroups only issue wgmma.mma_async m64nBNk16 on the 64 rows
// each owns, with A K-major and B N-major (the transpose bit), and keep one
// chunk's MMAs in flight while they wait for the next chunk. setmaxnreg
// moves registers from the producer to them.
//
// Epilogue, from the accumulator registers: + bias (read once per column
// pair), + residual (read once), ReLU, one rounding to bf16, written into a
// swizzled tile in shared memory and stored by TMA (out-of-bounds rows and
// columns clipped), so the output is written once in whole lines while the
// warpgroup goes on to its next tile.
//
// EDGE (N % 8 != 0, N even; kModeGemm, kModeConv or kModeAtb): C's rows are
// N * 2 bytes, which TMA cannot address (a row stride must be a multiple of
// 16 bytes), and B's rows are read at the caller's padded stride ldb instead.
// kModeAtb's f32 output is stored from the registers in any case (8-byte
// pairs masked at m < M and n < N, a pair never crossing a row as N is even)
// and its split-K reduce is splitk_reduce_f32's, so there EDGE changes only
// what the launch accepts, and the kernel is the non-EDGE one.
// The epilogue computes the same values and writes each column pair from
// the registers as one 4-byte bf16x2 store, masked at m < M and n < N; it
// keeps no output tile in shared memory, so the ring takes its room. A
// split's partial tile is stored as for any other split, and the reduce
// walks M * N in column pairs (a pair never crosses a row: N is even).
//
// Split-K: a work item covers kb_per_split chunks of one split (the last
// split may be shorter; the GEMM's and the conv's plans make every split
// equal) and writes its f32 partial tile to ws[split][tap][M][N];
// gemm_splitk_reduce (or splitk_reduce_f32 for the f32 modes) then sums the
// splits in order: deterministic, no atomics.
//
// Operand modes (MODE):
//   * kModeGemm, kModeConv: A K-major (each of the tile's M rows holds a
//     chunk's 64 K values; the GEMM's rows lda apart in memory), as above;
//     the bf16 epilogue.
//   * kModeAtb, kModeWgrad (atb.cu): out[tap][M][N] = sum_k A[k,m] B[k,n],
//     f32, with A stored [K][M]. Its stage is laid out as B's is: BM/64
//     boxes of 64 K rows by 64 M columns, 128-byte swizzle, and wgmma reads
//     it through its transpose-A bit. kModeAtb loads A [K,M] by TMA;
//     kModeWgrad gathers row k (output pixel (n,oy,ox)) from the NHWC input
//     at (oy+ky-py, ox+kx-px) for the item's filter tap (ky,kx), channels
//     m0.., by 16-byte zero-fill cp.async, (n,oy,ox) carried from chunk to
//     chunk. Work items are output tile x tap x split. The epilogue stores
//     the f32 accumulators as they are (no bias, residual, ReLU or rounding).
enum Mode { kModeGemm = 0, kModeConv = 1, kModeAtb = 2, kModeWgrad = 3 };

constexpr int kChunk = 64;  // K per stage
constexpr int kSmemMax = 232448;  // shared memory one block may use (227 KB)

template <int BM, int BN, bool REG_OUT>
struct RingLayout {
  static constexpr int kA = BM * kChunk * 2;  // bytes of A per stage
  static constexpr int kB = kChunk * BN * 2;  // bytes of B per stage (BN/64 TMA boxes)
  static constexpr int kStage = kA + kB;
  // the bf16 output tile (BN/64 boxes per 64 rows); the f32 modes and EDGE
  // store from registers (REG_OUT)
  static constexpr int kOut = REG_OUT ? 0 : BM * BN * 2;
  // as many stages (16 bytes of barriers each) as fit beside it, at most 8;
  // 1,024 bytes align the base and 1,536 stay spare (common.py:wgmma_stages
  // mirrors the bf16 layout)
  static constexpr int kFree = kSmemMax - 1024 - 1536 - kOut;
  static constexpr int kStages = kFree / (kStage + 16) < 8 ? kFree / (kStage + 16) : 8;
  static_assert(kStages >= 3, "at least three stages");
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBars = kRing + kOut;  // full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // +1024: align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of the given parity has completed. Bounded: a phase
// that never completes (a TMA the card refused) ends the launch with an
// error after ~2^26 polls instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (i == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory; its bytes
// complete the transaction count of the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D TMA store of one box from shared memory at (c0 innermost, c1);
// out-of-bounds elements are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
// An L2 policy that marks the lines a load brings in as the first to evict:
// for a stream read once, so that it does not push out what the next kernel
// reads (eltwise.cu, pool.cu).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 1-D bulk copy (TMA without a tensor map) of `bytes` contiguous bytes from
// global to shared memory under an L2 policy; both addresses 16-byte aligned,
// bytes a multiple of 16. Its bytes complete the barrier's transaction count.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared memory (READ)
// or have completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 16-byte cp.async; src-size 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Arrive on the barrier when this thread's earlier cp.asyncs have landed
// (.noinc: the arrival is counted in the barrier's init count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// 16 bytes into shared memory from registers (the narrow conv's A).
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t w0, uint32_t w1, uint32_t w2,
                                            uint32_t w3) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w0), "r"(w1),
               "r"(w2), "r"(w3)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Byte offsets:
// lbo = the leading-dimension byte offset, sbo = the stride byte offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the asynchronous
// MMAs that write them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x BN] += A[64 x 16] . B[16 x BN]; B N-major (trans-b = 1), A K-major
// (TA = 0) or M-major (TA = 1, trans-a).
template <int BN, int TA>
struct Wgmma;

template <int TA>
struct Wgmma<64, TA> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<128, TA> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};

template <int TA>
struct Wgmma<256, TA> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
  }
};


// D[64 x BN] += A[64 x 16] . B[16 x BN] with A from registers (block.cu):
// each warp's a[4] is its 16 rows of A as mma.sync m16n8k16's A fragment
// (what ldmatrix.x4 loads), B N-major in shared memory (trans-b = 1; A
// cannot be transposed in this form). wgmma reads a[] asynchronously: the
// caller keeps those registers unchanged until wgmma_wait says the group
// that reads them is done, and fences them (fence_regs_u) around it.
template <int BN>
struct WgmmaRA;

template <>
struct WgmmaRA<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRA<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Keeps the compiler from rewriting or moving A registers that an
// asynchronous wgmma still reads.
template <int R>
__device__ __forceinline__ void fence_regs_u(unsigned (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

union Bf16x8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

// v + bias[n..n+8] (+res) (+ReLU) -> 8 bf16 at c[m, n..n+8], one rounding:
// 16-byte accesses (N % 8 == 0 and 16-byte aligned operands on this path).
__device__ __forceinline__ void store8(const Prob& p, long m, int n, float (&v)[8]) {
  const long off = m * p.N + n;
  Bf16x8 t;
#pragma unroll
  for (int term = 0; term < 2; ++term) {
    const void* src = term == 0 ? p.bias : p.res;
    if (src == nullptr) continue;
    t.u = *(const uint4*)((const bf16*)src + (term == 0 ? n : off));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(t.h[q]);
      v[2 * q] += f.x;
      v[2 * q + 1] += f.y;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float x = v[2 * q], y = v[2 * q + 1];
    if (p.relu) {
      x = relu_j(x);
      y = relu_j(y);
    }
    t.h[q] = __floats2bfloat162_rn(x, y);
  }
  *(uint4*)((bf16*)p.c + off) = t.u;
}

// The same for the column pair n, n + 1 (EDGE: N even, so 4-byte accesses).
__device__ __forceinline__ void store2(const Prob& p, long m, int n, float (&v)[2]) {
  const long off = m * p.N + n;
  float x = v[0], y = v[1];
#pragma unroll
  for (int term = 0; term < 2; ++term) {
    const void* src = term == 0 ? p.bias : p.res;
    if (src == nullptr) continue;
    const float2 f = __bfloat1622float2(
        *(const __nv_bfloat162*)((const bf16*)src + (term == 0 ? n : off)));
    x += f.x;
    y += f.y;
  }
  if (p.relu) {
    x = relu_j(x);
    y = relu_j(y);
  }
  *(__nv_bfloat162*)((bf16*)p.c + off) = __floats2bfloat162_rn(x, y);
}

// One work item of the persistent grid: output tile (m0, n0), filter tap
// (kModeWgrad's; 0 in the other modes) and K split: chunks kb0 .. kb0+nk-1.
struct Item {
  long m0;
  int n0, tap, split, kb0, nk;
};

template <int BM, int BN>
__device__ __forceinline__ Item work_item(int w, int tiles_m, int tiles_n, int taps,
                                          int kb_per_split, int nkb) {
  Item it;
  const int mt = w % tiles_m;
  int rest = w / tiles_m;
  it.m0 = (long)mt * BM;
  it.n0 = (rest % tiles_n) * BN;
  rest /= tiles_n;
  it.tap = rest % taps;
  it.split = rest / taps;
  it.kb0 = it.split * kb_per_split;
  it.nk = min(kb_per_split, nkb - it.kb0);
  return it;
}

// NARROW (kModeConv with C % 8 != 0, NWG == 1): the producer builds each
// thread's 16 bytes of A from 8 element loads instead of one cp.async, in
// two warpgroups (kProducerWgs); see "the narrow fill" below.
template <bool NARROW>
constexpr int kProducerWgs = NARROW ? 2 : 1;

template <int MODE, int NWG, int BN, bool NARROW = false, bool EDGE = false>
__global__ void __launch_bounds__((NWG + kProducerWgs<NARROW>) * 128, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap tma_a,
               const __grid_constant__ CUtensorMap tma_b,
               const __grid_constant__ CUtensorMap tma_c, Prob p, float* ws, int splits,
               int kb_per_split) {
  static_assert(!NARROW || (MODE == kModeConv && NWG == 1 && BN <= 128),
                "narrow: the conv, 64-row tiles, at most 128 columns");
  static_assert(!EDGE || ((MODE == kModeGemm || MODE == kModeConv) && !NARROW && BN <= 128),
                "edge: the bf16 epilogue's modes, A by 16 bytes, at most 128 columns");
  constexpr int PT = kProducerWgs<NARROW> * 128;  // producer threads
  // A by the producer's threads (cp.async, or the narrow fill's stores)
  constexpr bool GATHER = MODE == kModeConv || MODE == kModeWgrad;
  constexpr bool TRANS_A = MODE == kModeAtb || MODE == kModeWgrad;  // A [K][M], f32 out
  constexpr int BM = NWG * 64;
  using L = RingLayout<BM, BN, TRANS_A || EDGE>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) uint8_t dsmem[];
  // the swizzle pattern repeats every 1024 bytes: align every tile to it
  uint8_t* smem = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + L::kBars, empty0 = full0 + kStages * 8;
  const int tiles_m = (p.M + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN;
  const int taps = TRANS_A ? p.taps : 1;
  const int nkb = (p.K + kChunk - 1) / kChunk;
  const int work = tiles_m * tiles_n * taps * splits;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // full: the TMA thread's expect_tx, plus one arrival per producer
      // thread for a gathered A (cp.async's, or the narrow fill's own);
      // empty: each consumer warp
      mbar_init(full0 + 8 * s, GATHER ? 1 + PT : 1);
      mbar_init(empty0 + 8 * s, NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // -- producer warpgroup: copies only --------------------------------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x - NWG * 128;
    if (!GATHER && pt != 0) return;
    // the gathers: this thread copies 16-byte vector j of rows rr + 16 q of
    // every A chunk (every 64-column box of it for kModeWgrad). Lane j of each
    // group of 8 holds what row rr + 16 j needs, shared by shuffles:
    //   * kModeConv: the row's RowInfo (rows are output pixels, fixed per
    //     tile); (ky, kx, c) of the thread's k is carried from chunk to chunk
    //     (64 on), so the chunk loop divides nothing;
    //   * kModeWgrad: rows are K, output pixels (n, oy, ox); lanes j < 4 carry
    //     their row's pixel from chunk to chunk (64 pixels on: step_y rows and
    //     step_x columns) and compute its input pixel's offset for the tap.
    //   * kModeConv NARROW (the narrow fill): the thread's 16 bytes are the 8
    //     elements k .. k + 7, which may span several taps (C % 8 != 0), so
    //     each element e carries its own tap: its filter row ky in ey and its
    //     place in that row's KW * C contiguous elements, kx * C + c, in el
    //     (so its input x is inside the image iff 0 <= ix * C + el < W * C),
    //     stepped 64 on per chunk by 64 = dky * KW * C + dl. Its two warpgroups
    //     (256 threads, so two producer warps on each scheduler to hide the
    //     loads' and the index arithmetic's latency) split the rows: the
    //     thread's are rr + 32 q, and it keeps their input pointers and
    //     top-left corners for the whole tile. It loads each element that
    //     lies inside the image and below K (0 elsewhere), packs the 8 into
    //     16 bytes, stores them with st.shared at the swizzled address,
    //     fences them for wgmma (the async proxy) and arrives on the full
    //     barrier itself.
    const int j = pt & 7, rr = pt >> 3, lane8 = threadIdx.x & 24;
    const int step_y = MODE == kModeWgrad ? kChunk / p.OW : 0;
    const int step_x = MODE == kModeWgrad ? kChunk - step_y * p.OW : 0;
    constexpr int RS = PT / 8;                 // rows rr + RS q: 16 apart, 32 narrow
    constexpr int NR = NARROW ? BM / RS : 1;   // the narrow fill's rows per thread
    int ey[8], el[8];                          // the narrow fill's taps, per element
    const unsigned short* xrow[NR];  // the rows' top-left input pixel (may lie outside x)
    int riy[NR], rix[NR];  // the rows' top-left corner: y, and x * C
    int dky = 0, dl = 0, kh = 0, kwc = 0, wc = 0;
    // the narrow fill's loads of the thread's NR x 8 elements at the
    // current taps (0 outside the image and past K)
    const auto fill_loads = [&](uint32_t (&v)[NR][8]) {
      int toff[8], eyk[8];  // offset from the row's top-left pixel; ky, or 2^20 past K
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        toff[e] = ey[e] * wc + el[e];
        eyk[e] = ey[e] < kh ? ey[e] : 1 << 20;
        asm("" : "+r"(toff[e]));  // once per chunk, not once per row
      }
#pragma unroll
      for (int q = 0; q < NR; ++q) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = (unsigned)(riy[q] + eyk[e]) < (unsigned)p.H &&
                          (unsigned)(rix[q] + el[e]) < (unsigned)wc;
          v[q][e] = ok ? __ldg(xrow[q] + toff[e]) : 0u;
        }
      }
    };
    uint32_t va[NR][8];  // the narrow fill's loads for the chunk being filled
    if constexpr (NARROW) {
      kwc = p.KW * p.C;
      wc = p.W * p.C;
      dky = kChunk / kwc;
      dl = kChunk - dky * kwc;
      kh = p.K / kwc;
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const Item it = work_item<BM, BN>(w, tiles_m, tiles_n, taps, kb_per_split, nkb);
      const long m0 = it.m0;
      long k = (long)it.kb0 * kChunk + j * 8;
      int c = 0, kx = 0, ky = 0;
      RowInfo mine = {0, 0, 0};
      if (MODE == kModeConv && !NARROW) {
        const long tap = k / p.C;
        c = (int)(k - tap * p.C);
        ky = (int)(tap / p.KW);
        kx = (int)(tap - (long)ky * p.KW);
        const long m = m0 + rr + 16 * j;
        if (j < BM / 16 && m < p.M) {
          const int ox = (int)(m % p.OW);
          const long t = m / p.OW;
          const int oy = (int)(t % p.OH);
          mine.nh = (int)(t / p.OH) * p.H;
          mine.iy = oy * p.sy - p.py;
          mine.ix = ox * p.sx - p.px;
        } else {  // rows past M: an input row that is never in bounds
          mine.iy = INT_MIN / 2;
        }
      }
      if constexpr (NARROW) {
        // as above in 32 bits (M and K are ints, so k and m fit unsigned)
        const unsigned ku = (unsigned)k, y0 = ku / kwc;
        const unsigned m = (unsigned)m0 + rr + RS * j;
        if (j < NR && m < (unsigned)p.M) {
          const unsigned t = m / p.OW, img = t / p.OH;
          mine.nh = (int)img * p.H;
          mine.iy = (int)(t - img * p.OH) * p.sy - p.py;
          mine.ix = (int)(m - t * p.OW) * p.sx - p.px;
        } else {
          mine.iy = INT_MIN / 2;
        }
        // element 0 at (y0, ku - y0 * KW * C), the others one step on each
        int y = (int)y0, l = (int)(ku - y0 * kwc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ey[e] = y;
          el[e] = l;
          if (++l == kwc) {
            l = 0;
            ++y;
          }
        }
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const int nh = __shfl_sync(0xffffffffu, mine.nh, lane8 + q);
          riy[q] = __shfl_sync(0xffffffffu, mine.iy, lane8 + q);
          const int ix = __shfl_sync(0xffffffffu, mine.ix, lane8 + q);
          rix[q] = ix * p.C;
          // kept in registers (opaque to the compiler), not recomputed per element
          unsigned long long a = (unsigned long long)((const unsigned short*)p.a +
                                                      ((long)(nh + riy[q]) * p.W + ix) * p.C);
          asm("" : "+l"(a));
          xrow[q] = (const unsigned short*)a;
        }
        fill_loads(va);  // the item's first chunk, before its stage is free
      }
      int n = 0, oy = 0, ox = 0;  // kModeWgrad: output pixel of row rr + 16 j
      if (MODE == kModeWgrad) {
        ky = it.tap / p.KW;
        kx = it.tap - ky * p.KW;
        const long kr = (long)it.kb0 * kChunk + rr + 16 * j;
        ox = (int)(kr % p.OW);
        const long t = kr / p.OW;
        oy = (int)(t % p.OH);
        n = (int)(t / p.OH);
      }
      for (int i = 0; i < it.nk; ++i) {
        const int kb = it.kb0 + i;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t sa = sbase + stage * L::kStage, sb = sa + L::kA;
        const uint32_t fb = full0 + 8 * stage;
        if (pt == 0) {
          mbar_expect_tx(fb, GATHER ? L::kB : L::kA + L::kB);
          if (MODE == kModeGemm) tma_load_2d(sa, &tma_a, fb, kb * kChunk, (int)m0);
          if (MODE == kModeAtb) {
#pragma unroll
            for (int q = 0; q < BM / 64; ++q)
              tma_load_2d(sa + q * 8192, &tma_a, fb, (int)m0 + q * 64, kb * kChunk);
          }
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load_2d(sb + q * 8192, &tma_b, fb, it.n0 + q * 64, kb * kChunk);
        }
        if (MODE == kModeConv && NARROW) {
          if (i > 0) fill_loads(va);
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            const int r = rr + RS * q;
            st_shared16(sa + r * 128 + ((j ^ (r & 7)) << 4), va[q][0] | va[q][1] << 16,
                        va[q][2] | va[q][3] << 16, va[q][4] | va[q][5] << 16,
                        va[q][6] | va[q][7] << 16);
          }
          fence_proxy_async();  // the stores, visible to wgmma's async proxy
          mbar_arrive(fb);
#pragma unroll
          for (int e = 0; e < 8; ++e) {  // the taps 64 on
            el[e] += dl;
            ey[e] += dky;
            if (el[e] >= kwc) {
              el[e] -= kwc;
              ++ey[e];
            }
          }
        }
        if (MODE == kModeConv && !NARROW) {
          const bf16* X = (const bf16*)p.a;
          const bool kin = k < p.K;
#pragma unroll
          for (int q = 0; q < BM / 16; ++q) {
            const int r = rr + 16 * q;
            const int nh = __shfl_sync(0xffffffffu, mine.nh, lane8 + q);
            const int iy = __shfl_sync(0xffffffffu, mine.iy, lane8 + q) + ky;
            const int ix = __shfl_sync(0xffffffffu, mine.ix, lane8 + q) + kx;
            const bool ok = kin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
            const bf16* src = ok ? X + ((long)(nh + iy) * p.W + ix) * p.C + c : X;
            cp_async16(sa + r * 128 + ((j ^ (r & 7)) << 4), src, ok);
          }
          cp_async_arrive(fb);
          k += kChunk;
          c += kChunk;
          while (c >= p.C) {  // once for C >= 64; C / 8 times at most below
            c -= p.C;
            if (++kx == p.KW) {
              kx = 0;
              ++ky;
            }
          }
        }
        if (MODE == kModeWgrad) {
          // this lane's row: the element offset of its input pixel, or -1
          // in the zero padding and past K (n == nimg)
          const bf16* X = (const bf16*)p.a;
          const int iy = oy + ky - p.py, ix = ox + kx - p.px;
          const long off = n < p.nimg && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W
                               ? (((long)n * p.H + iy) * p.W + ix) * p.M
                               : -1;
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // the chunk's 64 rows, 16 apart
            const int r = rr + 16 * q;
            const long o = __shfl_sync(0xffffffffu, off, lane8 + q);
#pragma unroll
            for (int b = 0; b < BM / 64; ++b) {  // box b: columns m0 + 64 b ..
              const long mc = m0 + b * 64 + j * 8;
              const bool ok = o >= 0 && mc < p.M;
              cp_async16(sa + b * 8192 + r * 128 + ((j ^ (r & 7)) << 4), ok ? X + o + mc : X, ok);
            }
          }
          cp_async_arrive(fb);
          ox += step_x;
          oy += step_y;
          if (ox >= p.OW) {
            ox -= p.OW;
            ++oy;
          }
          while (oy >= p.OH) {  // once per image passed: at most 2 at 7x7
            oy -= p.OH;
            ++n;
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // -- consumer warpgroups: MMAs, then the epilogue ---------------------------
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31;
    const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
    // this warpgroup's 64 output rows in shared memory: BN/64 swizzled boxes
    const uint32_t out_s = sbase + L::kRing + wg * 64 * BN * 2;
    uint8_t* out_p = smem + L::kRing + wg * 64 * BN * 2;
    const bf16* bias = (const bf16*)p.bias;
    const bf16* res = (const bf16*)p.res;
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const Item it = work_item<BM, BN>(w, tiles_m, tiles_n, taps, kb_per_split, nkb);
      const long mw = it.m0 + wg * 64;  // this warpgroup's first row
      const int n0 = it.n0;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int i = 0; i < it.nk; ++i) {
        mbar_wait(full0 + 8 * stage, phase);
        // cp.async (or the narrow fill's st.shared, fenced by its writers
        // too) wrote A through the generic proxy
        if (GATHER) fence_proxy_async();
        // this warpgroup's 64 rows of A: the K-major rows wg*64.., or the
        // M-major box wg; both 8,192 bytes on
        const uint32_t sa = sbase + stage * L::kStage + wg * 8192;
        const uint32_t sb = sbase + stage * L::kStage + L::kA;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          // B: 64-column boxes 8192 apart, 8-row (k) groups 1024 apart, k16 =
          // 16 rows = 2048 bytes on. A K-major: 64 rows of 128 bytes, 8-row
          // groups 1024 apart, k16 = 32 bytes on; A M-major: one box laid out
          // as B's
          const uint64_t db = sw128_desc(sb + kk * 2048, 8192, 1024);
          if (TRANS_A)
            Wgmma<BN, 1>::mma(acc, sw128_desc(sa + kk * 2048, 8192, 1024), db);
          else
            Wgmma<BN, 0>::mma(acc, sw128_desc(sa + kk * 32, 16, 1024), db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's MMAs are done: release its stage
        fence_regs(acc);
        if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((stage + kStages - 1) % kStages));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((stage + kStages - 1) % kStages));

      // accumulator layout of m64nNk16: d[4g..4g+1] at (r0, 8g+cq..+1),
      // d[4g+2..4g+3] at (r0+8, the same columns)
      if (TRANS_A || splits > 1) {  // f32 as it is, 32 bytes per 4 lanes: the
        // split's partial tile, or the f32 modes' output
        const long mn = (long)p.M * p.N;
        float* dst = splits > 1 ? ws + ((long)it.split * taps + it.tap) * mn
                                : (float*)p.c + (long)it.tap * mn;
#pragma unroll
        for (int g = 0; g < BN / 8; ++g) {
          const int n = n0 + g * 8 + cq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long m = mw + r0 + 8 * h;
            if (m < p.M && n < p.N)
              *(float2*)(dst + m * p.N + n) = make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
          }
        }
        continue;
      }
      if constexpr (!TRANS_A) {
        if constexpr (!EDGE) {
          if (tw == 0) bulk_wait<true>();  // the last tile's store has read the staging
          named_bar_sync(2 + wg, 128);
        }
#pragma unroll
        for (int g = 0; g < BN / 8; ++g) {
          const int col = g * 8 + cq, n = n0 + col;
          float2 b = make_float2(0.f, 0.f);
          if (bias != nullptr && n < p.N) b = __bfloat1622float2(*(const __nv_bfloat162*)(bias + n));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const long m = mw + r;
            float x = acc[4 * g + 2 * h] + b.x, y = acc[4 * g + 2 * h + 1] + b.y;
            if (res != nullptr && m < p.M && n < p.N) {
              union {
                unsigned u;
                __nv_bfloat162 h;
              } rv;
              rv.u = __ldg((const unsigned*)(res + m * p.N + n));
              const float2 f = __bfloat1622float2(rv.h);
              x += f.x;
              y += f.y;
            }
            if (p.relu) {
              x = relu_j(x);
              y = relu_j(y);
            }
            if constexpr (EDGE) {  // straight to C, masked at the edge
              if (m < p.M && n < p.N)
                *(__nv_bfloat162*)((bf16*)p.c + m * p.N + n) = __floats2bfloat162_rn(x, y);
            } else {
              // box col / 64, 128-byte swizzle: 16-byte chunk (col % 64) / 8 ^ r % 8
              *(__nv_bfloat162*)(out_p + (col >> 6) * 8192 + r * 128 +
                                 ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2) =
                  __floats2bfloat162_rn(x, y);
            }
          }
        }
        if constexpr (EDGE) continue;
        fence_proxy_async();  // the TMA store reads through the async proxy
        named_bar_sync(2 + wg, 128);
        if (tw == 0 && mw < p.M) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            if (n0 + q * 64 < p.N) tma_store_2d(&tma_c, out_s + q * 8192, n0 + q * 64, (int)mw);
          bulk_commit();
        }
      }
    }
    if (tw == 0) bulk_wait<false>();
  }
}

// out = epilogue(sum over s of ws[s], s in order): deterministic, 8 elements
// per step (N % 8 == 0), or 2 for EDGE (N even: a pair stays in its row).
// (static: sgemm.cu and conv.cu each get their own copy.)
template <bool EDGE>
static __global__ void __launch_bounds__(256)
    gemm_splitk_reduce(Prob p, const float* __restrict__ ws, int splits) {
  constexpr int V = EDGE ? 2 : 8;
  const long mn = (long)p.M * p.N, steps = mn / V;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < steps;
       i += (long)gridDim.x * blockDim.x) {
    const long e = i * V;
    float v[V];
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = 0.f;
    for (int s = 0; s < splits; ++s) {
      if constexpr (EDGE) {
        const float2 a = *(const float2*)(ws + s * mn + e);
        v[0] += a.x;
        v[1] += a.y;
      } else {
        const float4* src = (const float4*)(ws + s * mn + e);
        const float4 a = src[0], b = src[1];
        v[0] += a.x;
        v[1] += a.y;
        v[2] += a.z;
        v[3] += a.w;
        v[4] += b.x;
        v[5] += b.y;
        v[6] += b.z;
        v[7] += b.w;
      }
    }
    const long m = e / p.N;
    if constexpr (EDGE)
      store2(p, m, (int)(e - m * p.N), v);
    else
      store8(p, m, (int)(e - m * p.N), v);
  }
}

static inline bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; reached through the
// runtime's entry-point query, so the library needs no libcuda at link time.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}

// A row-major bf16 [rows, cols] matrix whose rows lie ld elements apart
// (ld * 2 a multiple of 16 bytes) as a TMA map of box_cols x box_rows boxes,
// 128-byte swizzle; out-of-bounds elements (columns past cols too) read as
// zero.
static int encode_map_ld(CUtensorMap* map, const void* base, int rows, int cols, long ld,
                         int box_cols, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The same for a dense matrix (ld = cols).
static int encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                      int box_rows) {
  return encode_map_ld(map, base, rows, cols, cols, box_cols, box_rows);
}

// out[i] = sum over s of ws[s * total + i], s in order, f32 as it is:
// deterministic. VEC: 4 elements per step (total % 4 == 0).
template <bool VEC>
static __global__ void __launch_bounds__(256)
    splitk_reduce_f32(const float* __restrict__ ws, float* __restrict__ out, long total,
                      int splits) {
  const long steps = VEC ? total / 4 : total;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < steps;
       i += (long)gridDim.x * blockDim.x) {
    if (VEC) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float4 a = ((const float4*)(ws + s * total))[i];
        v.x += a.x;
        v.y += a.y;
        v.z += a.z;
        v.w += a.w;
      }
      ((float4*)out)[i] = v;
    } else {
      float v = 0.f;
      for (int s = 0; s < splits; ++s) v += ws[s * total + i];
      out[i] = v;
    }
  }
}

// The f32 split-K reduction's launch: out (total f32) from splits x total.
static int reduce_f32(const float* ws, float* out, long total, int splits, cudaStream_t s) {
  const bool vec = total % 4 == 0 && aligned16(ws) && aligned16(out);
  long blocks = ((vec ? total / 4 : total) + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  if (vec)
    splitk_reduce_f32<true><<<(unsigned)blocks, 256, 0, s>>>(ws, out, total, splits);
  else
    splitk_reduce_f32<false><<<(unsigned)blocks, 256, 0, s>>>(ws, out, total, splits);
  return (int)cudaGetLastError();
}

template <int MODE, int NWG, int BN, bool NARROW = false, bool EDGE = false>
static int launch_wgmma_tile(const Prob& p, const CUtensorMap& ta, const CUtensorMap& tb,
                             const CUtensorMap& tc, float* ws, int splits, int kb_per_split,
                             cudaStream_t s) {
  constexpr bool F32OUT = MODE == kModeAtb || MODE == kModeWgrad;
  constexpr int BM = NWG * 64;
  constexpr int bytes = RingLayout<BM, BN, F32OUT || EDGE>::kBytes;
  static unsigned attr_set = 0;  // one bit per device
  static int sms[32] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(attr_set & (1u << dev))) {
    cudaError_t e = cudaFuncSetAttribute(gemm_wgmma<MODE, NWG, BN, NARROW, EDGE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    attr_set |= 1u << dev;
  }
  const long work = (long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN) *
                    (F32OUT ? p.taps : 1) * splits;
  if (work > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = work < sms[dev] ? (int)work : sms[dev];  // persistent: one block per SM
  gemm_wgmma<MODE, NWG, BN, NARROW, EDGE><<<grid, (NWG + kProducerWgs<NARROW>) * 128, bytes, s>>>(
      ta, tb, tc, p, ws, splits, kb_per_split);
  return (int)cudaGetLastError();
}

// The wgmma path of every mode: per = K chunks per split (the last split may
// hold fewer, none is empty); ws: splits x taps x M x N f32 when splits > 1.
// NARROW: the conv with its A built element by element, 64 x 64 or 64 x 128
// tiles. EDGE: N % 8 != 0 and N even (the GEMM or the conv with A by 16
// bytes, or kModeAtb), tiles of 64 or 128 rows and columns.
template <int MODE, bool NARROW = false, bool EDGE = false>
static int launch_wgmma(const Prob& p, int bm, int bn, int splits, int per, void* ws,
                        cudaStream_t s) {
  static_assert(!NARROW || MODE == kModeConv, "the narrow fill is the conv's");
  static_assert(!EDGE || ((MODE == kModeGemm || MODE == kModeConv || MODE == kModeAtb) &&
                          !NARROW),
                "the edge store: the bf16 epilogue's, or kModeAtb's f32 pairs");
  constexpr bool F32OUT = MODE == kModeAtb || MODE == kModeWgrad;
  // the kernel's EDGE: kModeAtb stores from the registers anyway
  constexpr bool KEDGE = EDGE && !F32OUT;
  // 16-byte rows for TMA and cp.async: A's (the GEMM's lda, the conv's C,
  // the f32 modes' M: A [K][M] and x's channels), B's in memory (ldb) and,
  // but for EDGE, B's and C's N; the narrow fill reads x element by element,
  // so x takes any C and any alignment
  const int arow = MODE == kModeConv ? p.C : MODE == kModeGemm ? p.lda : p.M;
  const bool n_ok = EDGE ? p.N % 8 != 0 && p.N % 2 == 0 : p.N % 8 == 0;
  const bool shape_ok = (NARROW || arow % 8 == 0) && n_ok && p.ldb % 8 == 0 &&
                        p.ldb >= p.N && (MODE != kModeGemm || p.lda >= p.K) &&
                        (!F32OUT || p.taps >= 1);
  const bool aligned = (NARROW || aligned16(p.a)) && aligned16(p.b) && aligned16(p.c) &&
                       (p.bias == nullptr || aligned16(p.bias)) &&
                       (p.res == nullptr || aligned16(p.res));
  const int nkb = (p.K + kChunk - 1) / kChunk;
  if (!shape_ok || !aligned || splits < 1 || per < 1 || (long)(splits - 1) * per >= nkb ||
      (long)splits * per < nkb || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta = {}, tb = {}, tc = {};
  int rc = encode_map_ld(&tb, p.b, p.K, p.N, p.ldb, 64, kChunk);
  if (rc == 0 && MODE == kModeGemm) rc = encode_map_ld(&ta, p.a, p.M, p.K, p.lda, kChunk, bm);
  if (rc == 0 && MODE == kModeAtb) rc = encode_map(&ta, p.a, p.K, p.M, 64, kChunk);
  if (rc == 0 && !F32OUT && !EDGE && splits == 1) rc = encode_map(&tc, p.c, p.M, p.N, 64, 64);
  if (rc != 0) return rc;
  float* part = splits > 1 ? (float*)ws : nullptr;
  if (NARROW) {
    if (bm == 64 && bn == 64)
      rc = launch_wgmma_tile<MODE, 1, 64, NARROW>(p, ta, tb, tc, part, splits, per, s);
    else if (bm == 64 && bn == 128)
      rc = launch_wgmma_tile<MODE, 1, 128, NARROW>(p, ta, tb, tc, part, splits, per, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (EDGE) {
    if (bm == 128 && bn == 64)
      rc = launch_wgmma_tile<MODE, 2, 64, false, KEDGE>(p, ta, tb, tc, part, splits, per, s);
    else if (bm == 128 && bn == 128)
      rc = launch_wgmma_tile<MODE, 2, 128, false, KEDGE>(p, ta, tb, tc, part, splits, per, s);
    else if (bm == 64 && bn == 64)
      rc = launch_wgmma_tile<MODE, 1, 64, false, KEDGE>(p, ta, tb, tc, part, splits, per, s);
    else if (bm == 64 && bn == 128)
      rc = launch_wgmma_tile<MODE, 1, 128, false, KEDGE>(p, ta, tb, tc, part, splits, per, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (bm == 128 && bn == 64)
    rc = launch_wgmma_tile<MODE, 2, 64>(p, ta, tb, tc, part, splits, per, s);
  else if (bm == 128 && bn == 128)
    rc = launch_wgmma_tile<MODE, 2, 128>(p, ta, tb, tc, part, splits, per, s);
  else if (bm == 128 && bn == 256)
    rc = launch_wgmma_tile<MODE, 2, 256>(p, ta, tb, tc, part, splits, per, s);
  else if (bm == 64 && bn == 64)
    rc = launch_wgmma_tile<MODE, 1, 64>(p, ta, tb, tc, part, splits, per, s);
  else if (bm == 64 && bn == 128)
    rc = launch_wgmma_tile<MODE, 1, 128>(p, ta, tb, tc, part, splits, per, s);
  else if (bm == 64 && bn == 256)
    rc = launch_wgmma_tile<MODE, 1, 256>(p, ta, tb, tc, part, splits, per, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0 || splits == 1) return rc;
  if (F32OUT) return reduce_f32(part, (float*)p.c, (long)p.taps * p.M * p.N, splits, s);
  const long steps = (long)p.M * p.N / (EDGE ? 2 : 8);
  long blocks = (steps + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gemm_splitk_reduce<EDGE><<<(unsigned)blocks, 256, 0, s>>>(p, part, splits);
  return (int)cudaGetLastError();
}

enum Path { kPathFma = 0, kPathMma = 1, kPathWgmma = 2, kPathWgmmaNarrow = 3, kPathWgmmaEdge = 4 };

// dtype: 0 = float32, 1 = bfloat16. path, bm, bn, splits: the caller's plan
// (ops/kernels/common.py:plan_gemm); ws: splits x M x N f32 of workspace when
// splits > 1. A plan this entry point cannot run is refused
// (cudaErrorInvalidValue), never rerouted. Returns cudaGetLastError() after
// the launches (a refused launch never runs, and a later synchronize would
// not say so).
template <bool CONV>
static int launch_gemm(const Prob& p, int dtype, int path, int bm, int bn, int splits,
                       void* ws, cudaStream_t s) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.ldb < p.N || (!CONV && p.lda < p.K))
    return (int)cudaErrorInvalidValue;
  if (path == kPathFma && dtype == 0) {
    dim3 grid((p.M + kFM - 1) / kFM, (p.N + kFN - 1) / kFN);
    gemm_f32<CONV><<<grid, kThreads, 0, s>>>(p);
  } else if (path == kPathMma && dtype == 1) {
    dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
    bool va = (CONV ? p.C % 8 == 0 : p.K % 8 == 0 && p.lda % 8 == 0) && aligned16(p.a);
    bool vb = p.N % 8 == 0 && p.ldb % 8 == 0 && aligned16(p.b);
    if (va && vb)
      gemm_bf16<CONV, true, true><<<grid, kThreads, 0, s>>>(p);
    else if (va)
      gemm_bf16<CONV, true, false><<<grid, kThreads, 0, s>>>(p);
    else if (vb)
      gemm_bf16<CONV, false, true><<<grid, kThreads, 0, s>>>(p);
    else
      gemm_bf16<CONV, false, false><<<grid, kThreads, 0, s>>>(p);
  } else if ((path == kPathWgmma || path == kPathWgmmaNarrow || path == kPathWgmmaEdge) &&
             dtype == 1) {
    const int nkb = (p.K + kChunk - 1) / kChunk;  // the plan makes every split equal
    if (splits < 1 || nkb % splits != 0) return (int)cudaErrorInvalidValue;
    constexpr int mode = CONV ? kModeConv : kModeGemm;
    if (path == kPathWgmmaEdge)
      return launch_wgmma<mode, false, true>(p, bm, bn, splits, nkb / splits, ws, s);
    if constexpr (CONV) {
      if (path == kPathWgmmaNarrow)
        return launch_wgmma<kModeConv, true>(p, bm, bn, splits, nkb / splits, ws, s);
    } else if (path == kPathWgmmaNarrow) {
      return (int)cudaErrorInvalidValue;  // the narrow fill is the conv's
    }
    return launch_wgmma<mode>(p, bm, bn, splits, nkb / splits, ws, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace boda
