// The fused residual bottleneck, NHWC:
//   h1 = relu(x . w1 + b1)               (rounded to x's dtype)
//   h2 = relu(conv3x3_pad1(h1) . w2 + b2) (rounded to x's dtype)
//   y  = relu(x + h2 . w3 + b3)           (residual added in f32)
// x (N,H,W,C); w1 (C,K); w2 (3,3,K,K) HWIO = [9K, K]; w3 (K,C).
//
// Replaces K6, boda_tpu/ops/kernels/block.py:111 pallas_bottleneck
// (_bneck_kernel :72). The TPU kernel runs one grid step per image and
// keeps the whole plane's h1 and h2 in VMEM (~14 MB at 56x56). An H100 SM
// has 227 KB of shared memory, so here each thread block owns one image and
// one T x T spatial tile and runs three GEMMs in turn, with 256 threads:
//   A: h1 over the tile plus a one-pixel halo, (T+2)^2 rows x K, from x in
//      global memory. Halo pixels outside the image are the 3x3's zero pad,
//      stored as 0 (not relu(b1)); halo pixels inside are recomputed by each
//      neighbouring tile, (T+2)^2/T^2 of phase A's work.
//   B: h2 for the tile, the 3x3 over h1 in shared memory. Its rows are the
//      tile's pixels on rows of T+2 (two wasted columns per row), so that
//      each tap's A operand is h1 itself at a fixed row offset: no gather.
//   C: y = relu(x + h2 . w3 + b3) for the tile, T^2 rows x C, with h2 as the
//      A operand in place, written to global memory with the residual read
//      from x.
// h1 and h2 stay in shared memory in x's dtype, as the reference rounds
// them; only x is read (twice: phase A and the residual) and y written.
//
// bf16 runs on the tensor cores: mma.sync m16n8k16 with an f32 accumulator,
// its fragments loaded from shared memory with ldmatrix (the WMMA API's
// loads compiled to generic loads from dynamic shared memory here). Each GEMM runs in output-column chunks of 128 (64
// when the output has 64 columns) over 32-deep K chunks; the weight's K chunk
// (and phase A's chunk of x) is copied to shared memory with cp.async, three
// chunks ahead of the products (a 4-stage ring): each chunk is too small to
// hide an L2 round trip alone.
// The 8 warps split a chunk's columns in 32-wide strips and its 16-row
// fragments round robin. Channel counts are padded to 32 in shared memory
// (zeros), so any C and K run; C % 8 or K % 8 != 0 take element copies.
// f32 inputs run on the FMA pipes (full f32) with element-wise staging.
//
// Where a plane has too few tiles to fill the card (res5: one 7x7 tile per
// image, 32 blocks at b32), a thread-block cluster of CL = 2 or 4 blocks
// shares each tile: each block computes a CL-th of h1's, h2's and y's
// columns, reading a CL-th of each weight, and copies its peers' slices of
// h1 and h2 from their shared memory (distributed shared memory) after
// phases A and B.
//
// The host picks T from 1..8 and CL by a cost model: the tile's per-warp
// work in each phase (16-row fragments, padded columns, depth) times the
// waves of thread blocks the card runs (132 SMs, blocks per SM by shared
// memory and registers), plus the weights every tile streams from L2 (all
// of them: smaller tiles read them more often). At b32 that is 8x8 at
// 56x56, 7x7 at 28x28 and 14x14, and 7x7 in clusters of 4 at 7x7 (128
// blocks). Blocks start on different output-column chunks, so that they do
// not all read the same weight rows at once.
//
// What bounds it on an H100: at b32 one block is ~14 GFLOP; res2's moves
// 103 MB (x read, y written), so res2 is bound by bytes (~31 us) and res3-5
// by the tensor cores (~14 us each at 989 TFLOP/s). This kernel is far from
// either: mma.sync instead of wgmma, no TMA, the halo recompute and the
// tiles' 16-row padding, one or two blocks per SM, and each block's
// re-reading of all the weights it needs through L2 for only 64 pixels.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;         // contraction chunk
constexpr int kStages = 3;      // cp.async ring of K chunks (two in flight)
constexpr int kNBMax = 128;     // output-column chunk (bf16: 64 or 128; f32: 64)
constexpr int kALd = kBK + 8;   // staged A row stride (+8: skew the banks)
constexpr int kBLd = kNBMax + 8;
constexpr int kMaxTile = 8;     // (T+2)^2 = 100 rows -> 112 <= kMaxRows
constexpr int kMaxRows = 128;
constexpr long kSmemLimit = 232448;   // 227 KB per block
constexpr long kSmemPerSM = 233472;   // 228 KB per SM
constexpr int kBlocksPerSMRegs = 2;   // __launch_bounds__(256, 2): 128 registers
// the tile picker's model of the card: a warp's mma.sync rate (an SM's ~1,024
// bf16 MACs per clock over 8 warps) and L2's rate to all SMs (~3 TB/s at
// ~1.8 GHz); it ranks tiles, and predicts no time
constexpr double kWarpMacsPerClk = 128, kL2BytesPerClk = 1600;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// four 8x8 bf16 tiles from shared memory (lane l gives the row address of
// tile l / 8), as mma.sync's A fragment; .trans: as its B fragments
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait() {  // all but the newest kStages - 2 groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

struct Args {
  const void *x, *w1, *b1, *w2, *b2, *w3, *b3;
  void* out;
  int n, h, w, c, k;
  int tile, tiles_x, tiles_per_img;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// One block's rows and shared memory: row offsets, h1 (halo tile), h2, the
// pipelined A and B chunks (bf16: A's in h2's space), and each warp's 16x16
// f32 epilogue tile.
struct Layout {
  int hp, hr, rb, h1rows, pp, pr, kp, ldk;
  size_t off_h1, off_h2, off_a, off_b, off_c, bytes;
  __host__ __device__ Layout(int t, int k, int es) {
    hp = (t + 2) * (t + 2);        // halo tile pixels (phase A rows)
    hr = round_up(hp, 16);
    rb = round_up(t * (t + 2), 16);  // phase B rows: the tile on rows of T+2
    // phase B reads h1 rows up to rb - 1 + 2(T+2) + 2
    h1rows = round_up(hp > rb + 2 * (t + 2) + 2 ? hp : rb + 2 * (t + 2) + 2, 16);
    h1rows = h1rows > hr ? h1rows : hr;
    pp = t * t;
    pr = round_up(pp, 16);
    kp = round_up(k, kBK);  // channels padded with zeros: a K chunk is one tap
    ldk = kp + 8;           // 16-byte rows that shift 4 banks: ldmatrix without conflicts
    off_h1 = align128((size_t)hr * sizeof(int));
    off_h2 = off_h1 + align128((size_t)h1rows * ldk * es);
    const size_t h2_bytes = align128((size_t)pr * ldk * es);
    const int stages = es == 2 ? kStages : 1;  // f32 stages synchronously
    const size_t a_bytes = align128((size_t)stages * hr * kALd * es);
    // bf16 stages A only in phase A, before h2 exists: the two share space
    off_a = es == 2 ? off_h2 : off_h2 + h2_bytes;
    off_b = es == 2 ? off_h2 + (h2_bytes > a_bytes ? h2_bytes : a_bytes)
                    : off_a + a_bytes;
    off_c = off_b + align128((size_t)stages * kBK * kBLd * es);
    bytes = off_c + (size_t)kWarps * 256 * sizeof(float);
  }
};

// -- bf16: tensor cores ----------------------------------------------------------
enum ASrc { kStaged, kH1Taps, kInPlace };

// Where a GEMM's A operand lives: phase A stages x's rows (rowoff: pixel
// index, -1 outside the image); phases B and C read h1 / h2 in place.
struct ASrcArgs {
  const bf16* base;
  const int* rowoff;
  int c, ldk, kp, t;
};

// The weight rows of a K chunk starting at k0: chunk row r is weight row
// base + r while r < lim, else zero (past K, or a tap's channel padding).
struct RowsUpTo {
  int n;
  __device__ void chunk(int k0, int& base, int& lim) const {
    base = k0;
    lim = n - k0;
  }
};

struct TapRows {  // w2, K index = tap * kp + channel (a chunk is in one tap)
  int k, kp;
  __device__ void chunk(int k0, int& base, int& lim) const {
    int tap = k0 / kp, ch = k0 - tap * kp;
    base = tap * k + ch;
    lim = k - ch;
  }
};

// out[r, col] = sum_k A[r, k] * B[brow(k), col] for r < rows (a multiple of
// 16), col_lo <= col < col_hi, k < kdim (a multiple of kBK), B's rows ldb
// apart; every thread of the block calls it, and emit gets the f32 sums. NB: the output-column chunk. Warp
// (wr, wc) owns the 32-column strip wc and the 16-row fragments wr, wr + WR,
// ...; every address that does not change along K is computed once.
template <int NB, int SRC, bool VEC, class BR, class EM>
__device__ void gemm_bf16(int rows, int kdim, int ldb, int col_lo, int col_hi, const bf16* B,
                          const BR& brow,
                          const ASrcArgs& as, const EM& emit, bf16* As, bf16* Bs, float* Cs) {
  constexpr int WC = NB / 32, WR = kWarps / WC, MRF = (kMaxRows / 16 + WR - 1) / WR;
  constexpr int BV = kBK * (NB / 8) / kThreads;  // 16-byte B copies per thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / WC, wc = warp % WC;
  const int nrf = rows / 16, nk = kdim / kBK;
  const int a_stage = rows * kALd;
  const int lda = SRC == kStaged ? kALd : as.ldk;
  const bf16 zero = from_f32<bf16>(0.f);
  // ldmatrix lane offsets: B rows kk + lane % 16, 8 columns on for lanes
  // 16-31; A rows of each fragment likewise
  const int b_off = (lane & 15) * kBLd + wc * 32 + (lane >> 4) * 8;
  int a_off[MRF];
#pragma unroll
  for (int i = 0; i < MRF; ++i) a_off[i] = ((wr + i * WR) * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  // blocks start on different column chunks, so they do not all stream the
  // same weight rows at the same time
  const int nchunks = (col_hi - col_lo + NB - 1) / NB;
  for (int nc_i = 0; nc_i < nchunks; ++nc_i) {
    const int n0 = col_lo + (int)((nc_i + blockIdx.x) % nchunks) * NB;
    auto load = [&](int stage, int k0) {
      bf16* bs = Bs + stage * (kBK * kBLd);
      int base, lim;
      brow.chunk(k0, base, lim);
#pragma unroll
      for (int j = 0; j < BV; ++j) {
        const int v = tid + j * kThreads;
        const int r = v / (NB / 8), nc = (v % (NB / 8)) * 8, ng = n0 + nc;
        bf16* dst = bs + r * kBLd + nc;
        const bf16* src = B + (long)(base + r) * ldb + ng;
        if (VEC) {
          bool ok = r < lim && ng < col_hi;
          cp_async16(dst, ok ? src : B, ok ? 16 : 0);
        } else {
          for (int e = 0; e < 8; ++e) dst[e] = (r < lim && ng + e < col_hi) ? src[e] : zero;
        }
      }
      if (SRC == kStaged) {
        bf16* a = As + stage * a_stage;
        for (int v = tid; v < rows * (kBK / 8); v += kThreads) {
          const int r = v / (kBK / 8), kc = (v % (kBK / 8)) * 8, p = as.rowoff[r];
          bf16* dst = a + r * kALd + kc;
          const bf16* src = as.base + (long)p * as.c + k0 + kc;
          if (VEC) {
            bool ok = p >= 0 && k0 + kc < as.c;
            cp_async16(dst, ok ? src : as.base, ok ? 16 : 0);
          } else {
            for (int e = 0; e < 8; ++e)
              dst[e] = (p >= 0 && k0 + kc + e < as.c) ? src[e] : zero;
          }
        }
      }
    };
    // the warp's 16-row fragments x its 32-column strip as four 16x8 tiles
    float acc[MRF][4][4];
#pragma unroll
    for (int i = 0; i < MRF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) load(st, st * kBK);
      cp_async_commit();
    }
    int stage = 0, next = kStages - 1;  // the ring slots of chunk kc and kc + S - 1
    int tap_row = 0, ch = 0;             // kH1Taps: the chunk's h1 row shift and channel
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait();  // this thread's copies of chunk kc have landed
      // every thread's copies of chunk kc are visible, and every warp is done
      // with chunk kc - 1, whose slot the next copy refills
      __syncthreads();
      if (kc + kStages - 1 < nk) load(next, (kc + kStages - 1) * kBK);
      cp_async_commit();
      const bf16* bs = Bs + stage * (kBK * kBLd) + b_off;
      const bf16* abase = SRC == kStaged  ? As + stage * a_stage
                          : SRC == kH1Taps ? as.base + tap_row * as.ldk + ch
                                           : as.base + kc * kBK;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        unsigned b[4][2];
        ldsm_x4_trans(bs + kk * kBLd, &b[0][0]);
        ldsm_x4_trans(bs + kk * kBLd + 16, &b[2][0]);
#pragma unroll
        for (int i = 0; i < MRF; ++i) {
          if (wr + i * WR < nrf) {
            unsigned a[4];
            ldsm_x4(abase + a_off[i] + kk, a);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a, b[j]);
          }
        }
      }
      stage = stage + 1 == kStages ? 0 : stage + 1;
      next = next + 1 == kStages ? 0 : next + 1;
      if (SRC == kH1Taps) {  // the next chunk: on along the channels, then the taps
        ch += kBK;
        if (ch == as.kp) {
          ch = 0;
          const int tap = (kc + 1) * kBK / as.kp, ky = tap / 3;
          tap_row = ky * (as.t + 2) + tap - ky * 3;
        }
      }
    }
    __syncthreads();  // the next column chunk's copies refill every slot
    float* cs = Cs + warp * 256;
#pragma unroll
    for (int i = 0; i < MRF; ++i) {
      int rf = wr + i * WR;
      if (rf >= nrf) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the 16x16 half j of the strip, row-major, from the mma layout (lane
        // holds rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1})
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const float* c = acc[i][2 * j + tt];
          float* d = cs + (lane >> 2) * 16 + tt * 8 + (lane & 3) * 2;
          d[0] = c[0];
          d[1] = c[1];
          d[128] = c[2];
          d[129] = c[3];
        }
        __syncwarp();
        // lane: one row of the fragment, 8 consecutive columns
        const int r = lane >> 1, c8 = (lane & 1) * 8;
        const int col = n0 + wc * 32 + j * 16 + c8;
        if (col < col_hi) emit.row8(rf * 16 + r, col, col_hi, cs + r * 16 + c8);
        __syncwarp();
      }
    }
  }
}

template <int SRC, bool VEC, class BR, class EM>
__device__ void gemm_bf16_nb(int rows, int kdim, int ldb, int col_lo, int col_hi,
                             const bf16* B, const BR& brow, const ASrcArgs& as, const EM& emit,
                             bf16* As, bf16* Bs, float* Cs) {
  if (col_hi - col_lo > 64)
    gemm_bf16<128, SRC, VEC>(rows, kdim, ldb, col_lo, col_hi, B, brow, as, emit, As, Bs, Cs);
  else
    gemm_bf16<64, SRC, VEC>(rows, kdim, ldb, col_lo, col_hi, B, brow, as, emit, As, Bs, Cs);
}

// A cluster of CL blocks shares one tile, each block computing a CL-th of
// h1's, h2's and y's columns (and so reading a CL-th of each weight); after
// phases A and B each block copies its peers' column slices of h1 / h2 from
// their shared memory (rows x ks columns from each peer).
template <int CL>
__device__ void gather_slices(bf16* buf, int rows, int ldk, int ks, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int vecs = ks / 8;
  for (int p = 1; p < CL; ++p) {
    const int peer = (rank + p) % CL;
    const bf16* src = cluster.map_shared_rank(buf, peer);
    for (int v = threadIdx.x; v < rows * vecs; v += kThreads) {
      const int r = v / vecs, c = peer * ks + (v % vecs) * 8;
      *(uint4*)(buf + r * ldk + c) = *(const uint4*)(src + r * ldk + c);
    }
  }
}

// -- f32: FMA, full precision, element-wise staging --------------------------------
template <typename T>
struct FetchX {  // phase A: x at the halo tile's pixels (rowoff -1: outside)
  const T* x;
  const int* rowoff;
  int c;
  __device__ T operator()(int r, int k) const {
    int p = rowoff[r];
    return (k < c && p >= 0) ? x[(long)p * c + k] : from_f32<T>(0.f);
  }
};

template <typename T>
struct FetchH1 {  // phase B: the 3x3 taps of h1, k = tap * K + channel
  const T* h1;
  int ldk, kk, t, pp;
  __device__ T operator()(int r, int k) const {
    if (r >= pp || k >= 9 * kk) return from_f32<T>(0.f);
    int tap = k / kk, ch = k - tap * kk;
    int ky = tap / 3, kx = tap - ky * 3;
    int py = r / t, px = r - py * t;
    return h1[((py + ky) * (t + 2) + px + kx) * ldk + ch];
  }
};

template <typename T>
struct FetchH2 {  // phase C: h2
  const T* h2;
  int ldk, kk, pp;
  __device__ T operator()(int r, int k) const {
    return (r < pp && k < kk) ? h2[r * ldk + k] : from_f32<T>(0.f);
  }
};

// out[r, col] = sum_k A[r, k] * B[k, col]: thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j of each 64-column chunk.
template <class FA, class EM>
__device__ void gemm_f32(int rows, int kdim, int ncols, const float* B, const FA& fa,
                         const EM& emit, float* As, float* Bs) {
  constexpr int NB = 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nrf = rows / 16;
  for (int n0 = 0; n0 < ncols; n0 += NB) {
    float acc[kMaxRows / 16][NB / 16];
#pragma unroll
    for (int i = 0; i < kMaxRows / 16; ++i)
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < kdim; k0 += kBK) {
      for (int v = tid; v < rows * kBK; v += kThreads) {
        int r = v / kBK, kc = v % kBK;
        As[r * kALd + kc] = fa(r, k0 + kc);
      }
      for (int v = tid; v < kBK * NB; v += kThreads) {
        int r = v / NB, nc = v % NB;
        int kg = k0 + r, ng = n0 + nc;
        Bs[r * kBLd + nc] = (kg < kdim && ng < ncols) ? B[(long)kg * ncols + ng] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float b[NB / 16];
#pragma unroll
        for (int j = 0; j < NB / 16; ++j) b[j] = Bs[kk * kBLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMaxRows / 16; ++i) {
          if (i < nrf) {
            float a = As[(ty + 16 * i) * kALd + kk];
#pragma unroll
            for (int j = 0; j < NB / 16; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMaxRows / 16; ++i) {
      if (i >= nrf) break;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        int col = n0 + tx + 16 * j;
        if (col < ncols) emit(ty + 16 * i, col, acc[i][j]);
      }
    }
  }
}

// -- what each phase does with output element (r, col) ---------------------------
// Each phase's store of its output: operator() takes one f32 sum (the f32
// path), row8 the sums of 8 consecutive columns of one row (the bf16 path:
// one 16-byte load of bias and residual, one 16-byte store, where vec).
union Pack8 {
  uint4 u;
  bf16 e[8];
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, bool vec, int n, float* v) {
  if constexpr (sizeof(T) == 2) {
    if (vec && n >= 8) {
      Pack8 pk;
      pk.u = __ldg((const uint4*)p);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(pk.e[e]);
      return;
    }
  }
  for (int e = 0; e < 8; ++e) v[e] = e < n ? to_f32(p[e]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, bool vec, int n, const float* v) {
  if constexpr (sizeof(T) == 2) {
    if (vec && n >= 8) {
      Pack8 pk;
#pragma unroll
      for (int e = 0; e < 8; ++e) pk.e[e] = __float2bfloat16_rn(v[e]);
      *(uint4*)p = pk.u;
      return;
    }
  }
  for (int e = 0; e < 8 && e < n; ++e) p[e] = from_f32<T>(v[e]);
}

template <typename T>
struct EmitH1 {  // relu(v + b1), rounded; 0 at halo pixels outside the image
  T* h1;
  const T* b1;
  int ldk, hp, t, ty0, tx0, h, w;
  bool vec;
  __device__ bool inside(int r) const {
    int hy = r / (t + 2), hx = r - hy * (t + 2);
    int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
    return iy >= 0 && iy < h && ix >= 0 && ix < w;
  }
  __device__ void operator()(int r, int col, float v) const {
    if (r < hp)
      h1[r * ldk + col] = from_f32<T>(inside(r) ? fmaxf(v + to_f32(b1[col]), 0.f) : 0.f);
  }
  __device__ void row8(int r, int col, int ncols, const float* v) const {
    if (r >= hp) return;
    float b[8], o[8];
    load8(b1 + col, vec, ncols - col, b);
    const bool in = inside(r);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = in ? fmaxf(v[e] + b[e], 0.f) : 0.f;
    store8(h1 + r * ldk + col, vec, ncols - col, o);
  }
};

template <typename T>
struct EmitH2 {  // relu(v + b2), rounded; rows on a pitch of T (f32) or T+2 (bf16)
  T* h2;
  const T* b2;
  int ldk, t, pitch;
  bool vec;
  __device__ void operator()(int r, int col, float v) const {
    int py = r / pitch, px = r - py * pitch;
    if (py < t && px < t)
      h2[(py * t + px) * ldk + col] = from_f32<T>(fmaxf(v + to_f32(b2[col]), 0.f));
  }
  __device__ void row8(int r, int col, int ncols, const float* v) const {
    int py = r / pitch, px = r - py * pitch;
    if (py >= t || px >= t) return;
    float b[8], o[8];
    load8(b2 + col, vec, ncols - col, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = fmaxf(v[e] + b[e], 0.f);
    store8(h2 + (py * t + px) * ldk + col, vec, ncols - col, o);
  }
};

template <typename T>
struct EmitY {  // relu((v + b3) + x), to global memory
  const T* x;
  const T* b3;
  T* out;
  int pp, t, ty0, tx0, img, h, w, c;
  bool vec;
  __device__ long offset(int r) const {  // -1 outside the tile's image part
    if (r >= pp) return -1;
    int py = r / t, px = r - py * t;
    int iy = ty0 + py, ix = tx0 + px;
    if (iy >= h || ix >= w) return -1;
    return (((long)img * h + iy) * w + ix) * c;
  }
  __device__ void operator()(int r, int col, float v) const {
    long o = offset(r);
    if (o < 0) return;
    v = v + to_f32(b3[col]);
    v = v + to_f32(x[o + col]);
    v = fmaxf(v, 0.f);
    out[o + col] = from_f32<T>(v);
  }
  __device__ void row8(int r, int col, int ncols, const float* v) const {
    long o = offset(r);
    if (o < 0) return;
    float b[8], xr[8], y[8];
    load8(b3 + col, vec, ncols - col, b);
    load8(x + o + col, vec, ncols - col, xr);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = (v[e] + b[e]) + xr[e];
      y[e] = fmaxf(y[e], 0.f);
    }
    store8(out + o + col, vec, ncols - col, y);
  }
};

template <typename T, bool VEC, int CL>
__global__ void __launch_bounds__(kThreads, kBlocksPerSMRegs) bottleneck_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.tile, a.k, (int)sizeof(T));
  int* rowoff = (int*)smem;
  T* h1 = (T*)(smem + L.off_h1);
  T* h2 = (T*)(smem + L.off_h2);
  T* As = (T*)(smem + L.off_a);
  T* Bs = (T*)(smem + L.off_b);
  float* Cs = (float*)(smem + L.off_c);
  const int t = a.tile;
  const int rank = CL > 1 ? (int)(blockIdx.x % CL) : 0;  // in the tile's cluster
  const int tile = blockIdx.x / CL;
  const int img = tile / a.tiles_per_img, tix = tile % a.tiles_per_img;
  const int ty0 = tix / a.tiles_x * t, tx0 = tix % a.tiles_x * t;
  const T* x = (const T*)a.x;
  for (int r = threadIdx.x; r < L.hr; r += kThreads) {
    int hy = r / (t + 2), hx = r - hy * (t + 2);
    int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
    bool in = r < L.hp && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
    rowoff[r] = in ? (img * a.h + iy) * a.w + ix : -1;
  }
  // the channel padding of h1 and h2 is read as A and must be 0 (h2's
  // after phase A, whose staging shares its space)
  const int padc = L.kp - a.k;
  auto zero_pad = [&](T* buf, int rows) {
    for (int v = threadIdx.x; v < rows * padc; v += kThreads)
      buf[v / padc * L.ldk + a.k + v % padc] = from_f32<T>(0.f);
  };
  zero_pad(h1, L.h1rows);
  __syncthreads();
  const EmitH1<T> e1{h1, (const T*)a.b1, L.ldk, L.hp, t, ty0, tx0, a.h, a.w, VEC};
  const EmitY<T> ey{x, (const T*)a.b3, (T*)a.out, L.pp, t, ty0, tx0, img, a.h, a.w, a.c,
                    VEC};
  if constexpr (sizeof(T) == 2) {
    const int ks = a.k / CL, cs = a.c / CL;  // this block's column slices
    gemm_bf16_nb<kStaged, VEC>(L.hr, round_up(a.c, kBK), a.k, rank * ks, rank * ks + ks,
                               (const bf16*)a.w1, RowsUpTo{a.c},
                               ASrcArgs{x, rowoff, a.c, 0, 0, 0}, e1, As, Bs, Cs);
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
      gather_slices<CL>(h1, L.hp, L.ldk, ks, rank);
    }
    __syncthreads();
    zero_pad(h2, L.pr);
    gemm_bf16_nb<kH1Taps, VEC>(L.rb, 9 * L.kp, a.k, rank * ks, rank * ks + ks,
                               (const bf16*)a.w2, TapRows{a.k, L.kp},
                               ASrcArgs{h1, nullptr, 0, L.ldk, L.kp, t},
                               EmitH2<T>{h2, (const T*)a.b2, L.ldk, t, t + 2, VEC}, As, Bs, Cs);
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
      gather_slices<CL>(h2, L.pp, L.ldk, ks, rank);
    }
    __syncthreads();
    gemm_bf16_nb<kInPlace, VEC>(L.pr, L.kp, a.c, rank * cs, rank * cs + cs, (const bf16*)a.w3,
                                RowsUpTo{a.k}, ASrcArgs{h2, nullptr, 0, L.ldk, L.kp, t}, ey,
                                As, Bs, Cs);
    if constexpr (CL > 1) cg::this_cluster().sync();  // peers' copies from here are done
  } else {
    gemm_f32(L.hr, a.c, a.k, (const float*)a.w1, FetchX<T>{x, rowoff, a.c}, e1, As, Bs);
    __syncthreads();
    zero_pad(h2, L.pr);
    gemm_f32(L.pr, 9 * a.k, a.k, (const float*)a.w2, FetchH1<T>{h1, L.ldk, a.k, t, L.pp},
             EmitH2<T>{h2, (const T*)a.b2, L.ldk, t, t, false}, As, Bs);
    __syncthreads();
    gemm_f32(L.pr, a.k, a.c, (const float*)a.w3, FetchH2<T>{h2, L.ldk, a.k, L.pp}, ey, As,
             Bs);
  }
}

template <typename T, bool VEC, int CL>
int launch(Args a, size_t smem, cudaStream_t s) {
  static size_t granted = 0;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(bottleneck_kernel<T, VEC, CL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  long blocks = (long)a.n * a.tiles_per_img * CL;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (CL == 1) {
    bottleneck_kernel<T, VEC, CL><<<(unsigned)blocks, kThreads, smem, s>>>(a);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, bottleneck_kernel<T, VEC, CL>, a);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// Per-warp serial work of one GEMM: the warp's 16-row fragments times the
// padded output columns times the depth (the bf16 warp split).
double warp_work(int rows, int ncols, long depth) {
  int nb = ncols > 64 ? 128 : 64, wr = kWarps / (nb / 32);
  return (double)((rows / 16 + wr - 1) / wr) * 16 * round_up(ncols, nb) * depth;
}

}  // namespace

// The plan for n images of h x w, c channels, k mid channels (dtype 0 =
// float32, 1 = bfloat16): the tile side T in 1..8 and the cluster size CL
// in {1, 2, 4} (at most max_cluster; CL > 1 needs c and k to split into
// slices of 64, and all blocks in one wave) whose block fits shared memory
// and whose modeled time is least, the larger T and then the smaller CL on
// a tie. Returns T (0 if none fits) and writes CL.
extern "C" int boda_bottleneck_plan(int n, int h, int w, int c, int k, int dtype,
                                    int max_cluster, int* cluster) {
  const int es = dtype == 0 ? 4 : 2;
  int best = 0, best_cl = 1;
  double best_cost = 0;
  for (int t = kMaxTile; t >= 1; --t) {
    const Layout L(t, k, es);
    if ((long)L.bytes > kSmemLimit) continue;
    long per_sm = kSmemPerSM / ((long)L.bytes + 1024);
    per_sm = per_sm < kBlocksPerSMRegs ? per_sm : kBlocksPerSMRegs;
    const long tiles = (long)n * ((h + t - 1) / t) * ((w + t - 1) / t);
    for (int cl = 1; cl <= max_cluster; cl *= 2) {
      // clusters only to fill the card: a second wave of blocks costs more
      // than the split saves (measured at res3 and res4)
      if (cl > 1 && (dtype == 0 || k % (cl * 64) || c % (cl * 64) ||
                     tiles * cl > sm_count() * per_sm))
        break;
      const long blocks = tiles * cl;
      const long waves = (blocks + sm_count() * per_sm - 1) / (sm_count() * per_sm);
      // each tile streams all three weights from L2 once, split over its cluster
      const double cost =
          waves * (warp_work(L.hr, k / cl, c) + warp_work(L.rb, k / cl, 9L * L.kp) +
                   warp_work(L.pr, c / cl, L.kp)) / kWarpMacsPerClk +
          (double)tiles * es * (2.0 * c * k + 9.0 * k * k) / kL2BytesPerClk;
      if (best == 0 || cost < best_cost) {
        best = t;
        best_cl = cl;
        best_cost = cost;
      }
    }
  }
  *cluster = best_cl;
  return best;
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int boda_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, int n, int h, int w, int c,
                               int k, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = dtype == 1 && c % 8 == 0 && k % 8 == 0 && al(x) && al(w1) && al(w2) &&
                   al(w3) && al(b1) && al(b2) && al(b3) && al(out);
  int cl = 1;
  const int t = boda_bottleneck_plan(n, h, w, c, k, dtype, vec ? 4 : 1, &cl);
  if (t == 0) return (int)cudaErrorInvalidValue;
  Args a = {x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, k};
  a.tile = t;
  a.tiles_x = (w + t - 1) / t;
  a.tiles_per_img = a.tiles_x * ((h + t - 1) / t);
  const size_t smem = Layout(t, k, dtype == 0 ? 4 : 2).bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float, false, 1>(a, smem, s);
  if (!vec) return launch<bf16, false, 1>(a, smem, s);
  if (cl == 4) return launch<bf16, true, 4>(a, smem, s);
  if (cl == 2) return launch<bf16, true, 2>(a, smem, s);
  return launch<bf16, true, 1>(a, smem, s);
}
