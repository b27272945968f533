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
// bf16 runs on the tensor cores by one of two product loops, chosen by the
// caller from the shape before the launch (ops/kernels/block.py:route):
//   * wgmma (C % 64 == 0, K % 64 == 0, 16-byte aligned operands: every
//     ResNet-50 bottleneck): wgmma.mma_async m64nNk16 with A from registers
//     (each warp's ldmatrix.x4 fragment, as below, is wgmma's register-A
//     layout, so a 3x3 tap's row shift never touches a swizzled layout) and
//     the weights by TMA, 128-byte swizzled, streamed through a ring of
//     3-8 stages with a full mbarrier each (WgStream below). Rows come in m64 blocks,
//     one per warpgroup; a phase with one block splits its output columns
//     between the two warpgroups. The epilogue runs from the accumulators.
//   * mma.sync m16n8k16 (every other bf16 shape), its fragments loaded from
//     shared memory with ldmatrix (the WMMA API's loads compiled to generic
//     loads from dynamic shared memory here). Each GEMM runs in output-column
//     chunks of 128 (64 when the output has 64 columns) over 64-deep K
//     chunks; the weight's K chunk (and phase A's chunk of x) is copied to
//     shared memory with cp.async, two chunks ahead of the products (a
//     3-stage ring). The 8 warps split a chunk's columns in 32-wide strips
//     and its 16-row fragments round robin. Channel counts are padded to 64
//     in shared memory (zeros), so any C and K run; C % 8 or K % 8 != 0 take
//     element copies.
// Both accumulate in f32. f32 inputs run on the FMA pipes (full f32) with
// element-wise staging.
//
// On the wgmma route, where a plane has too few tiles to fill the card
// (res5: one 7x7 tile per image, 32 blocks at b32), a thread-block cluster
// of CL = 2 or 4 blocks shares each tile: each block computes a CL-th of
// h1's, h2's and y's columns, reading a CL-th of each weight, and copies its
// peers' slices of h1 and h2 from their shared memory (distributed shared
// memory) after phases A and B. The other routes run one block per tile.
//
// The host picks T from 1..8 and CL by a cost model: the tile's per-warp
// work in each phase (16-row fragments, or m64 blocks on the wgmma route;
// padded columns; depth) times the waves of thread blocks the card runs
// (132 SMs, blocks per SM by shared memory and registers), plus the weights every tile streams from L2 (all
// of them: smaller tiles read them more often). At b32 that is 8x8 at
// 56x56, 7x7 at 28x28 and 14x14, and 7x7 in clusters of 4 at 7x7 (128
// blocks). Blocks start on different output-column chunks, so that they do
// not all read the same weight rows at once.
//
// What bounds it on an H100: at b32 one block is ~14 GFLOP; res2's moves
// 103 MB (x read, y written), so res2 is bound by bytes (~31 us) and res3-5
// by the tensor cores (~14 us each at 989 TFLOP/s). The wgmma route is far
// from either (PERF.md, K6): the epilogues, y's most; each block streaming
// all of its weights from L2 for only 49-64 pixels (~285 MB per res3-res5
// launch); one block per SM whose every 64-deep item waits for its wgmmas
// and then at a block barrier, so no MMAs overlap the next item's loads; and
// the halo recompute and the tiles' m64 padding.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"  // TMA, mbarriers, wgmma (WgmmaRA), the tensor maps

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using boda::cp_async16;
using boda::encode_map;
using boda::fence_regs;
using boda::fence_regs_u;
using boda::from_f32;
using boda::mbar_expect_tx;
using boda::mbar_init;
using boda::mbar_wait;
using boda::relu_j;
using boda::smem_u32;
using boda::sw128_desc;
using boda::tma_load_2d;
using boda::to_f32;
using boda::wgmma_commit;
using boda::wgmma_fence;
using boda::wgmma_wait;

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
constexpr int kMaxDevices = 32;       // per-device state: opt-ins, SM counts
// the wgmma route: up to 8 weight stages of 64 rows x 128 columns, as two
// 64 x 64 TMA boxes of 8 KB, and 3 slots of phase A's x rows; one block per
// SM (__launch_bounds__(256, 1))
constexpr int kWgStagesMax = 8;
constexpr int kASlots = 3;
constexpr int kBoxBytes = 64 * 64 * 2;
constexpr int kWgStage = 2 * kBoxBytes;  // 64 rows x 128 columns; wide: twice that
// the tile picker's model of the card: a warp's mma.sync rate (an SM's ~1,024
// bf16 MACs per clock over 8 warps) and L2's rate to all SMs (~3 TB/s at
// ~1.8 GHz); it ranks tiles, and predicts no time
constexpr double kWarpMacsPerClk = 128, kL2BytesPerClk = 1600;

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
__host__ __device__ inline size_t align1024(size_t b) { return (b + 1023) & ~size_t(1023); }

// One block's rows and shared memory: row offsets, h1 (halo tile), h2, the
// pipelined A and B chunks (bf16: A's in h2's space), and each warp's 16x16
// f32 epilogue tile. The wgmma route (wg) counts rows in m64 blocks, keeps
// no epilogue tile, stages phase A's x rows in kASlots slots, and holds the
// weights in a ring of `stages` 1,024-byte aligned stages of 64 rows x 128
// columns (two 128-byte-swizzled TMA boxes) with a full barrier each: as
// many stages (3..8) as fit in 227 KB.
struct Layout {
  int hp, hr, rb, h1rows, pp, pr, kp, ldk, stages;
  int stage_bytes;  // the wgmma route's weight stage: 64 rows x 128 or (wide) 256 columns
  size_t off_h1, off_h2, off_a, off_b, off_bar, off_c, bytes;
  __host__ __device__ Layout(int t, int k, int es, bool wg = false) {
    const int rm = wg ? 64 : 16;   // rows per A fragment block
    hp = (t + 2) * (t + 2);        // halo tile pixels (phase A rows)
    hr = round_up(hp, rm);
    rb = round_up(t * (t + 2), rm);  // phase B rows: the tile on rows of T+2
    // phase B reads h1 rows up to rb - 1 + 2(T+2) + 2
    h1rows = hp > rb + 2 * (t + 2) + 2 ? hp : rb + 2 * (t + 2) + 2;
    // mma.sync: h1 also holds phase A's fragment rows; wgmma stages them
    h1rows = wg ? round_up(h1rows, 8) : round_up(h1rows > hr ? h1rows : hr, 16);
    pp = t * t;
    pr = round_up(pp, rm);
    kp = round_up(k, kBK);  // channels padded with zeros: a K chunk is one tap
    ldk = kp + 8;           // 16-byte rows that shift 4 banks: ldmatrix without conflicts
    off_h1 = align128((size_t)hr * sizeof(int));
    // wgmma: h1 and h2 each end in a dump row for the epilogue's rows past them
    off_h2 = off_h1 + align128((size_t)(h1rows + wg) * ldk * es);
    const size_t h2_bytes = align128((size_t)(pr + wg) * ldk * es);
    if (wg) {
      // wide stages where three fit: a phase of one m64 block then gives
      // each warpgroup 128 columns of a 256-column chunk
      stage_bytes = 2 * kWgStage;
      if (wg_bytes(h2_bytes, 3) > (size_t)kSmemLimit) stage_bytes = kWgStage;
      for (stages = kWgStagesMax; stages > 3; --stages)
        if (wg_bytes(h2_bytes, stages) <= (size_t)kSmemLimit) break;
      bytes = wg_bytes(h2_bytes, stages);
      off_a = off_h2;
      off_b = bytes - 1024 - (size_t)stages * (stage_bytes + 8);
      off_bar = off_b + (size_t)stages * stage_bytes;
      off_c = bytes;  // no epilogue tile
      return;
    }
    stage_bytes = 0;
    stages = es == 2 ? kStages : 1;  // f32 stages synchronously
    const size_t a_bytes = align128((size_t)stages * hr * kALd * es);
    // bf16 stages A only in phase A, before h2 exists: the two share space
    off_a = es == 2 ? off_h2 : off_h2 + h2_bytes;
    off_b = es == 2 ? off_h2 + (h2_bytes > a_bytes ? h2_bytes : a_bytes)
                    : off_a + a_bytes;
    off_bar = off_b + align128((size_t)stages * kBK * kBLd * es);
    off_c = off_bar;
    bytes = off_c + (size_t)kWarps * 256 * sizeof(float);
  }
  // the wgmma route: h2 or phase A's x slots, whichever is larger; then the
  // ring of s stages, its barriers and 1,024 bytes to align the base
  __host__ __device__ size_t wg_bytes(size_t h2_bytes, int s) const {
    const size_t a = align128((size_t)kASlots * hr * kALd * 2);
    return align1024(off_h2 + (h2_bytes > a ? h2_bytes : a)) + (size_t)s * (stage_bytes + 8) + 1024;
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
          cp_async16(smem_u32(dst), ok ? src : B, ok);
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
            cp_async16(smem_u32(dst), ok ? src : as.base, ok);
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

// -- bf16 on wgmma: A from registers, the weights by TMA ---------------------------
// The route for C % 64 == 0, K % 64 == 0 and 16-byte aligned operands. The
// tiles, h1/h2 and their padded rows, phase B's rows of T+2 and the res5
// cluster are those above; only the product loop differs. Rows come in m64
// blocks (at most two: T <= 8). Warpgroup g takes row block g; where a phase
// has one block, the two warpgroups split the output-column chunk instead.
// Each warp's 16 rows of A are ldmatrix.x4 loads (mma.sync's A fragment is
// wgmma's register-A layout), from x's staged rows (phase A), from h1 at the
// tap's row offset (phase B) or from h2 in place (phase C): no tap shift
// touches a swizzled layout.
//
// The weights' 64-deep chunks (64 rows x 64 or 128 columns, 128-byte
// swizzled) come by TMA as one stream over the three products (items: phase,
// then output-column chunk, then K chunk) through a ring of Layout::stages
// stages with a full mbarrier each. Thread 0 keeps stages - 1 items in
// flight: a block streams all its weights from L2 for only 49-64 pixels, so
// the bytes in flight, not the MMAs, set its pace, and the next column
// chunk's and the next phase's first weights load during an epilogue. Each
// item's wgmmas are waited for before the block's one __syncthreads per item,
// which then frees the stage the item read for the item stages - 1 on; a
// warp's A registers are reloaded only after that wait. Phase A's x rows
// ride along by cp.async, two items ahead, in three slots.
// One product of the wgmma kernel, as its weights stream: output columns
// [col_lo, col_hi) in nchunks chunks of nb, each nk 64-deep K chunks of the
// weight behind map. Blocks start on different column chunks and on
// different K chunks (the sum over K rotated by rot), so that the blocks of
// a wave, which all stream the same weights, do not read the same lines of
// L2 at once.
struct WgPhase {
  const CUtensorMap* map;
  int col_lo, col_hi, nb, nchunks, nk, rot;
  __device__ void init(const CUtensorMap* m, int lo, int hi, int kdim, int rows, bool wide) {
    map = m;
    col_lo = lo;
    col_hi = hi;
    nb = rows == 64 && wide && hi - lo > 128 ? 256 : hi - lo > 64 ? 128 : 64;
    nchunks = (hi - lo + nb - 1) / nb;
    nk = kdim / kBK;
    rot = (int)(blockIdx.x % nk);
  }
  __device__ int n0(int i) const { return col_lo + (int)((i + blockIdx.x) % nchunks) * nb; }
  __device__ int kchunk(int kc) const { return kc + rot < nk ? kc + rot : kc + rot - nk; }
};

struct WgStream {
  uint32_t b, bars;  // shared addresses: stage 0, the full barriers
  int stages, stage_bytes;
  WgPhase ph[3];
  int start[4];      // the first item of each phase; start[3]: all items
  const bf16* x;     // phase A's rows: x at pixel rowoff[r] (-1: zero), c channels
  const int* rowoff;
  int c, rows_a;
  bf16* As;
  // item g's weights into stage g % stages (thread 0)
  __device__ void issue_w(int g) const {
    if (threadIdx.x != 0 || g >= start[3]) return;
    const int p = g >= start[2] ? 2 : g >= start[1] ? 1 : 0;
    const WgPhase& f = p == 2 ? ph[2] : p == 1 ? ph[1] : ph[0];
    const int local = g - (p == 2 ? start[2] : p == 1 ? start[1] : 0), s = g % stages;
    const uint32_t fb = bars + 8 * s, sb = b + s * stage_bytes;
    const int n0 = f.n0(local / f.nk), k0 = f.kchunk(local % f.nk) * kBK;
    mbar_expect_tx(fb, f.nb * kBK * 2);
    for (int q = 0; q < f.nb / 64; ++q) tma_load_2d(sb + q * kBoxBytes, f.map, fb, n0 + q * 64, k0);
  }
  // phase A's item j: x's rows for its K chunk into slot j % kASlots (every
  // thread), one cp.async group, empty past phase A
  __device__ void issue_a(int j) const {
    if (j < start[1]) {
      bf16* a = As + (j % kASlots) * rows_a * kALd;
      const int k0 = ph[0].kchunk(j % ph[0].nk) * kBK;
      for (int v = threadIdx.x; v < rows_a * (kBK / 8); v += kThreads) {
        const int r = v / (kBK / 8), k8 = (v % (kBK / 8)) * 8, px = rowoff[r];
        const bf16* src = x + (long)px * c + k0 + k8;  // C % 64 == 0
        cp_async16(smem_u32(a + r * kALd + k8), px >= 0 ? src : x, px >= 0);
      }
    }
    cp_async_commit();
  }
};

// The epilogue from the accumulators of one m64 x WN block: d[8G + 2s + e]
// is segment s = 2j + h of the column pair group G (columns 16G + 8j + 2q +
// e, q = lane % 4; row r0 + 8h). The four lanes of a quad swap their pairs
// by shuffle so that lane q holds segment q's 8 consecutive columns, and
// emit.row8p stores them 16 bytes wide, with the bias (and residual) that
// wg_pre loaded before the chunk's products.
template <int WN, class EM>
__device__ __forceinline__ void wg_emit(const float (&acc)[WN / 2], int row0, int col0,
                                        int col_hi, const EM& emit,
                                        const uint4 (&pre)[WN / 16][2]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r = row0 + (lane >> 2) + 8 * (q & 1);
#pragma unroll
  for (int G = 0; G < WN / 16; ++G) {
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // round i: lane q sends its pair of segment q ^ i and receives lane
      // (q ^ i)'s pair of segment q, its columns 2 (q ^ i) + {0, 1}
      const int s = q ^ i;
      const float* d = acc + 8 * G;
      float x = s == 0 ? d[0] : s == 1 ? d[2] : s == 2 ? d[4] : d[6];
      float y = s == 0 ? d[1] : s == 1 ? d[3] : s == 2 ? d[5] : d[7];
      x = __shfl_xor_sync(0xffffffffu, x, i);
      y = __shfl_xor_sync(0xffffffffu, y, i);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (s == m) {
          v[2 * m] = x;
          v[2 * m + 1] = y;
        }
    }
    const int col = col0 + 16 * G + 8 * (q >> 1);
    if (col < col_hi) emit.row8p(r, col, v, pre[G]);
  }
}

// four 8x8 bf16 tiles into shared memory (lane l gives the row address of
// tile l / 8), from mma's accumulator layout: the inverse of ldsm_x4
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_relu(float x, float y, float2 b, bool keep) {
  union {
    __nv_bfloat162 h;
    uint32_t u;
  } v;
  v.h = __floats2bfloat162_rn(keep ? relu_j(x + b.x) : 0.f, keep ? relu_j(y + b.y) : 0.f);
  return v.u;
}

__device__ __forceinline__ float2 bf2(uint32_t u) {
  union {
    uint32_t u;
    __nv_bfloat162 h;
  } v;
  v.u = u;
  return __bfloat1622float2(v.h);
}

// The epilogue into h1 or h2 (relu(v + bias), one rounding): each 16-column
// group of the warp's 16 rows is one stmatrix.x4 of the accumulators as they
// lie (d[4g + 2h + e] at row r0 + 8h, column 8g + 2q + e); lane l gives the
// address of row (l % 8) + 8 ((l / 8) % 2), columns + 8 (l / 16). The bias
// pairs were loaded before the chunk's products (pb).
template <int WN, class EM>
__device__ __forceinline__ void wg_emit_sm(const float (&acc)[WN / 2], int row0, int col0,
                                           int col_hi, const EM& emit,
                                           const uint32_t (&pb)[WN / 8]) {
  const int lane = threadIdx.x & 31;
  const bool k0 = emit.keep(row0 + (lane >> 2)), k1 = emit.keep(row0 + (lane >> 2) + 8);
  const uint32_t base = emit.smrow(row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) + 16 * (lane >> 4);
#pragma unroll
  for (int G = 0; G < WN / 16; ++G) {
    const int col = col0 + 16 * G;
    if (col >= col_hi) continue;
    const float2 blo = bf2(pb[2 * G]), bhi = bf2(pb[2 * G + 1]);
    const float* d = acc + 8 * G;
    stsm_x4(base + 2 * col, pack_relu(d[0], d[1], blo, k0), pack_relu(d[2], d[3], blo, k1),
            pack_relu(d[4], d[5], bhi, k0), pack_relu(d[6], d[7], bhi, k1));
  }
}

// What lane q's segments of a chunk add in the epilogue (bias, residual),
// loaded before the chunk's products
template <int WN, class EM>
__device__ __forceinline__ void wg_pre(int row0, int col0, int col_hi, const EM& emit,
                                       uint4 (&pre)[WN / 16][2]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r = row0 + (lane >> 2) + 8 * (q & 1);
#pragma unroll
  for (int G = 0; G < WN / 16; ++G) {
    const int col = col0 + 16 * G + 8 * (q >> 1);
    if (col < col_hi) emit.pre8(r, col, pre[G]);
  }
}

// Product p: out[r, col] = sum_k A[r, k] W[k, col] over rows = 64 nblk rows,
// every thread of the block, item by item of the stream; WN: the columns of
// one warpgroup's wgmma.
template <int WN, int SRC, class EM>
__device__ void wg_phase(const WgStream& st, int p, int rows, const ASrcArgs& as, const EM& emit) {
  const WgPhase& f = st.ph[p];
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int S = st.stages;
  const int nblk = rows / 64;
  const int blk = nblk == 2 ? wg : 0;
  // the warpgroup's columns in a chunk; a 64-column chunk of one row block
  // leaves warpgroup 1 nothing: it repeats warpgroup 0's products (no
  // branch around the wgmmas) and stores nothing
  const int cofs = nblk == 2 || f.nb == 64 ? 0 : wg * WN;
  const bool stores = nblk == 2 || wg * WN < f.nb;
  const int lda = SRC == kStaged ? kALd : as.ldk;
  const int a_off = (blk * 64 + warp * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  const int row0 = blk * 64 + warp * 16;
  for (int ci = 0; ci < f.nchunks; ++ci) {
    const int col0 = f.n0(ci) + cofs;
    // what the epilogue adds, loaded before the products: bias pairs at
    // columns 8g + 2q (h1, h2); 16-byte bias and residual vectors (y)
    uint32_t pb[WN / 8];
    uint4 pre[WN / 16][2];
    if constexpr (EM::kSmem) {
      const int cq = col0 + 2 * (lane & 3);
#pragma unroll
      for (int g = 0; g < WN / 8; ++g)
        if (stores && cq + 8 * g < f.col_hi) pb[g] = __ldg((const unsigned*)(emit.bias() + cq + 8 * g));
    } else if (stores) {
      wg_pre<WN>(row0, col0, f.col_hi, emit, pre);
    }
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < f.nk; ++kc) {
      const int g = st.start[p] + ci * f.nk + kc, s = g % S;
      if (SRC == kStaged)  // this thread's x rows of item g (item g + 1's may be pending)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      mbar_wait(st.bars + 8 * s, (uint32_t)(g / S) & 1);
      // every thread's x rows (and the previous phase's h1 / h2) are
      // visible, and every warpgroup is done with item g - 1: its stage and
      // its x slot take items g + S - 1 and g + 2
      __syncthreads();
      st.issue_w(g + S - 1);
      if (SRC == kStaged) st.issue_a(g + 2);
      const bf16* abase;
      if (SRC == kStaged) {
        abase = st.As + (g % kASlots) * rows * kALd;
      } else if (SRC == kH1Taps) {  // a chunk is in one tap (K % 64 == 0)
        const int kr = f.kchunk(kc), tap = kr * kBK / as.kp, ky = tap / 3;
        abase = as.base + (ky * (as.t + 2) + tap - ky * 3) * as.ldk + (kr * kBK - tap * as.kp);
      } else {
        abase = as.base + f.kchunk(kc) * kBK;
      }
      unsigned a[4][4];  // the item's four k16 fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_x4(abase + a_off + kk * 16, a[kk]);
      const uint32_t sb = st.b + s * st.stage_bytes + (cofs / 64) * kBoxBytes;
      fence_regs(acc);
      wgmma_fence();  // a[] and acc were written by ordinary instructions
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        boda::WgmmaRA<WN>::mma(acc, a[kk], sw128_desc(sb + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();  // wgmma read a[] and the stage asynchronously
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs_u(a[kk]);
    }
    // every warp, stores or not: the shuffles and stmatrix run converged
    if constexpr (EM::kSmem)
      wg_emit_sm<WN>(acc, row0, col0, stores ? f.col_hi : 0, emit, pb);
    else
      wg_emit<WN>(acc, row0, col0, stores ? f.col_hi : 0, emit, pre);
  }
}

template <int SRC, class EM>
__device__ void wg_gemm(const WgStream& st, int p, int rows, const ASrcArgs& as, const EM& emit) {
  const int nb = st.ph[p].nb;
  if ((rows == 128 && nb == 128) || nb == 256)
    wg_phase<128, SRC>(st, p, rows, as, emit);
  else  // two blocks of 64 columns, or one block split in two
    wg_phase<64, SRC>(st, p, rows, as, emit);
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

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  Pack8 pk;
  pk.u = u;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(pk.e[e]);
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
      h1[r * ldk + col] = from_f32<T>(inside(r) ? relu_j(v + to_f32(b1[col])) : 0.f);
  }
  __device__ void row8(int r, int col, int ncols, const float* v) const {
    if (r >= hp) return;
    float b[8], o[8];
    load8(b1 + col, vec, ncols - col, b);
    const bool in = inside(r);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = in ? relu_j(v[e] + b[e]) : 0.f;
    store8(h1 + r * ldk + col, vec, ncols - col, o);
  }
  // the wgmma route (wg_emit_sm): row r's shared address, or the dump row's
  // past the halo tile; the value rows outside the image store 0
  int dump = 0;
  static constexpr bool kSmem = true;
  __device__ const T* bias() const { return b1; }
  __device__ uint32_t smrow(int r) const { return smem_u32(h1 + (r < hp ? r : dump) * ldk); }
  __device__ bool keep(int r) const { return inside(r); }
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
      h2[(py * t + px) * ldk + col] = from_f32<T>(relu_j(v + to_f32(b2[col])));
  }
  __device__ void row8(int r, int col, int ncols, const float* v) const {
    int py = r / pitch, px = r - py * pitch;
    if (py >= t || px >= t) return;
    float b[8], o[8];
    load8(b2 + col, vec, ncols - col, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = relu_j(v[e] + b[e]);
    store8(h2 + (py * t + px) * ldk + col, vec, ncols - col, o);
  }
  // the wgmma route (wg_emit_sm): the shared address of row r's pixel, or
  // the dump row's for the rows of T+2 past the tile
  int dump = 0;
  static constexpr bool kSmem = true;
  __device__ const T* bias() const { return b2; }
  __device__ uint32_t smrow(int r) const {
    int py = r / pitch, px = r - py * pitch;
    return smem_u32(h2 + (py < t && px < t ? py * t + px : dump) * ldk);
  }
  __device__ bool keep(int r) const { return true; }
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
    v = relu_j(v);
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
      y[e] = relu_j(y[e]);
    }
    store8(out + o + col, vec, ncols - col, y);
  }
  static constexpr bool kSmem = false;
  // the wgmma route (wg_emit): pre8 loads b3 and the residual before the
  // chunk's products, row8p adds them
  __device__ void pre8(int r, int col, uint4* p) const {
    const long o = offset(r);
    p[0] = __ldg((const uint4*)(b3 + col));
    if (o >= 0) p[1] = __ldg((const uint4*)(x + o + col));
  }
  __device__ void row8p(int r, int col, const float* v, const uint4* p) const {
    const long o = offset(r);
    if (o < 0) return;
    float b[8], xr[8], y[8];
    unpack8(p[0], b);
    unpack8(p[1], xr);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = (v[e] + b[e]) + xr[e];
      y[e] = relu_j(y[e]);
    }
    store8(out + o + col, true, 8, y);
  }
};

// The block's tile: its rank in the tile's cluster, its image and its
// top-left pixel; fill_rowoff writes each halo-tile row's pixel index (-1
// past the halo tile or outside the image).
template <int CL>
struct TileOf {
  int rank, img, ty0, tx0;
  __device__ explicit TileOf(const Args& a) {
    rank = CL > 1 ? (int)(blockIdx.x % CL) : 0;
    const int tile = blockIdx.x / CL, tix = tile % a.tiles_per_img;
    img = tile / a.tiles_per_img;
    ty0 = tix / a.tiles_x * a.tile;
    tx0 = tix % a.tiles_x * a.tile;
  }
  __device__ void fill_rowoff(int* rowoff, const Layout& L, const Args& a) const {
    const int t = a.tile;
    for (int r = threadIdx.x; r < L.hr; r += kThreads) {
      int hy = r / (t + 2), hx = r - hy * (t + 2);
      int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
      bool in = r < L.hp && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      rowoff[r] = in ? (img * a.h + iy) * a.w + ix : -1;
    }
  }
};

template <typename T, bool VEC>
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
  const TileOf<1> tl(a);
  const int img = tl.img, ty0 = tl.ty0, tx0 = tl.tx0;
  const T* x = (const T*)a.x;
  tl.fill_rowoff(rowoff, L, a);
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
    gemm_bf16_nb<kStaged, VEC>(L.hr, round_up(a.c, kBK), a.k, 0, a.k, (const bf16*)a.w1,
                               RowsUpTo{a.c}, ASrcArgs{x, rowoff, a.c, 0, 0, 0}, e1, As, Bs,
                               Cs);
    __syncthreads();
    zero_pad(h2, L.pr);
    gemm_bf16_nb<kH1Taps, VEC>(L.rb, 9 * L.kp, a.k, 0, a.k, (const bf16*)a.w2,
                               TapRows{a.k, L.kp}, ASrcArgs{h1, nullptr, 0, L.ldk, L.kp, t},
                               EmitH2<T>{h2, (const T*)a.b2, L.ldk, t, t + 2, VEC}, As, Bs, Cs);
    __syncthreads();
    gemm_bf16_nb<kInPlace, VEC>(L.pr, L.kp, a.c, 0, a.c, (const bf16*)a.w3, RowsUpTo{a.k},
                                ASrcArgs{h2, nullptr, 0, L.ldk, L.kp, t}, ey, As, Bs, Cs);
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

// The wgmma route's kernel: the bf16 kernel above with its three products on
// wg_gemm, the weights read through the tensor maps m1 (w1 [C][K]), m2 (w2
// [9K][K]) and m3 (w3 [K][C]), 64 x 64 boxes.
template <int CL>
__global__ void __launch_bounds__(kThreads, 1)
    bottleneck_wg(const __grid_constant__ CUtensorMap m1, const __grid_constant__ CUtensorMap m2,
                  const __grid_constant__ CUtensorMap m3, Args a) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  unsigned char* smem = dsmem + ((1024 - (smem_u32(dsmem) & 1023)) & 1023);
  const Layout L(a.tile, a.k, 2, true);
  int* rowoff = (int*)smem;
  bf16* h1 = (bf16*)(smem + L.off_h1);
  bf16* h2 = (bf16*)(smem + L.off_h2);
  const int t = a.tile;
  const TileOf<CL> tl(a);
  const int rank = tl.rank, img = tl.img, ty0 = tl.ty0, tx0 = tl.tx0;
  const bf16* x = (const bf16*)a.x;
  const int ks = a.k / CL, cs = a.c / CL;  // this block's column slices
  WgStream st;
  st.b = smem_u32(smem + L.off_b);
  st.bars = smem_u32(smem + L.off_bar);
  st.stages = L.stages;
  st.stage_bytes = L.stage_bytes;
  const bool wide = L.stage_bytes > kWgStage;
  st.ph[0].init(&m1, rank * ks, rank * ks + ks, a.c, L.hr, wide);
  st.ph[1].init(&m2, rank * ks, rank * ks + ks, 9 * L.kp, L.rb, wide);
  st.ph[2].init(&m3, rank * cs, rank * cs + cs, L.kp, L.pr, wide);
  st.start[0] = 0;
  for (int p = 0; p < 3; ++p) st.start[p + 1] = st.start[p] + st.ph[p].nchunks * st.ph[p].nk;
  st.x = x;
  st.rowoff = rowoff;
  st.c = a.c;
  st.rows_a = L.hr;
  st.As = (bf16*)(smem + L.off_a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) mbar_init(st.bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tl.fill_rowoff(rowoff, L, a);
  __syncthreads();  // K % 64 == 0: no channel padding to zero
  for (int g = 0; g < L.stages - 1; ++g) st.issue_w(g);
  st.issue_a(0);
  st.issue_a(1);
  const EmitH1<bf16> e1{h1, (const bf16*)a.b1, L.ldk, L.hp, t, ty0, tx0, a.h, a.w, true, L.h1rows};
  const EmitY<bf16> ey{x, (const bf16*)a.b3, (bf16*)a.out, L.pp, t, ty0, tx0, img, a.h, a.w,
                       a.c, true};
  wg_gemm<kStaged>(st, 0, L.hr, ASrcArgs{x, rowoff, a.c, 0, 0, 0}, e1);
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
    gather_slices<CL>(h1, L.hp, L.ldk, ks, rank);
  }
  wg_gemm<kH1Taps>(st, 1, L.rb, ASrcArgs{h1, nullptr, 0, L.ldk, L.kp, t},
                   EmitH2<bf16>{h2, (const bf16*)a.b2, L.ldk, t, t + 2, true, L.pr});
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
    gather_slices<CL>(h2, L.pp, L.ldk, ks, rank);
  }
  wg_gemm<kInPlace>(st, 2, L.pr, ASrcArgs{h2, nullptr, 0, L.ldk, L.kp, t}, ey);
  if constexpr (CL > 1) cg::this_cluster().sync();  // peers' copies from here are done
}

// One launch of kernel k over the plan's blocks, in clusters of CL.
// granted: the dynamic shared memory k has opted into so far, per device
// (the attribute holds for the current device only).
template <int CL, class... P, class... A>
int launch_kernel(void (*k)(P...), const Args& a, size_t smem, size_t* granted, cudaStream_t s,
                  A... args) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  long blocks = (long)a.n * a.tiles_per_img * CL;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
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
  cfg.numAttrs = CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch(Args a, size_t smem, cudaStream_t s) {
  static size_t granted[kMaxDevices] = {};
  return launch_kernel<1>(bottleneck_kernel<T, VEC>, a, smem, granted, s, a);
}

// The wgmma route: the three weights' tensor maps, 64 x 64 boxes.
template <int CL>
int launch_wg(Args a, size_t smem, cudaStream_t s) {
  static size_t granted[kMaxDevices] = {};
  CUtensorMap m1 = {}, m2 = {}, m3 = {};
  int rc = encode_map(&m1, a.w1, a.c, a.k, 64, kBK);
  if (rc == 0) rc = encode_map(&m2, a.w2, 9 * a.k, a.k, 64, kBK);
  if (rc == 0) rc = encode_map(&m3, a.w3, a.k, a.c, 64, kBK);
  if (rc != 0) return rc;
  return launch_kernel<CL>(bottleneck_wg<CL>, a, smem, granted, s, m1, m2, m3, a);
}

// The current device's SM count, cached per device.
int sm_count() {
  static int n[kMaxDevices] = {};
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && n[dev] > 0) return n[dev];
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  v = v > 0 ? v : 1;
  if (dev < kMaxDevices) n[dev] = v;
  return v;
}

// Per-warp serial work of one GEMM: the warp's 16-row fragments times the
// padded output columns times the depth (the bf16 warp split). On the wgmma
// route (wg) rows come in m64 blocks, one per warpgroup, and a lone block's
// 128-column chunks split between the two warpgroups (a 64-column chunk
// leaves one idle); a warpgroup's work is spread over its 4 warps.
double warp_work(int rows, int ncols, long depth, bool wg = false) {
  int nb = ncols > 64 ? 128 : 64;
  if (wg) {
    const int nblk = rows / 64;
    const double cols = nblk >= 2 || nb == 64 ? round_up(ncols, nb) : round_up(ncols, nb) / 2;
    return (double)((nblk + 1) / 2) * 64 * cols * depth / 4;
  }
  int wr = kWarps / (nb / 32);
  return (double)((rows / 16 + wr - 1) / wr) * 16 * round_up(ncols, nb) * depth;
}

enum Path { kPathFma = 0, kPathMma = 1, kPathWgmma = 2 };  // ops/kernels/common.py PATH_CODES

// The shapes each path takes (ops/kernels/block.py:route): f32 the FMA loop,
// bf16 mma.sync, bf16 with C % 64 == 0, K % 64 == 0 and 16-byte aligned
// operands also wgmma.
bool path_ok(int path, int dtype, int c, int k, bool aligned) {
  if (path == kPathFma) return dtype == 0;
  if (path == kPathMma) return dtype == 1;
  return path == kPathWgmma && dtype == 1 && c % 64 == 0 && k % 64 == 0 && aligned;
}

}  // namespace

// The plan for n images of h x w, c channels, k mid channels (dtype 0 =
// float32, 1 = bfloat16) on the given path: the tile side T in 1..8 and the
// cluster size CL in {1, 2, 4} (CL > 1 only on the wgmma route, with c and k
// split into slices of 64 and all blocks in one wave) whose block fits
// shared memory and whose modeled time is least, the larger T and then the
// smaller CL on a tie, on a card of sms SMs (0: the current device's).
// Returns T (0 if none fits) and writes CL.
extern "C" int boda_bottleneck_plan(int n, int h, int w, int c, int k, int dtype, int path,
                                    int sms, int* cluster) {
  if (sms <= 0) sms = sm_count();
  const int es = dtype == 0 ? 4 : 2;
  const bool wg = path == kPathWgmma;
  const int max_cluster = wg ? 4 : 1;
  int best = 0, best_cl = 1;
  double best_cost = 0;
  for (int t = kMaxTile; t >= 1; --t) {
    const Layout L(t, k, es, wg);
    if ((long)L.bytes > kSmemLimit) continue;
    long per_sm = kSmemPerSM / ((long)L.bytes + 1024);
    const long regs = wg ? 1 : kBlocksPerSMRegs;  // wgmma: __launch_bounds__(256, 1)
    per_sm = per_sm < regs ? per_sm : regs;
    const long tiles = (long)n * ((h + t - 1) / t) * ((w + t - 1) / t);
    for (int cl = 1; cl <= max_cluster; cl *= 2) {
      // clusters only to fill the card: a second wave of blocks costs more
      // than the split saves (measured at res3 and res4)
      if (cl > 1 && (k % (cl * 64) || c % (cl * 64) ||
                     tiles * cl > sms * per_sm))
        break;
      const long blocks = tiles * cl;
      const long waves = (blocks + sms * per_sm - 1) / (sms * per_sm);
      // each tile streams all three weights from L2 once, split over its cluster
      const double cost =
          waves * (warp_work(L.hr, k / cl, c, wg) + warp_work(L.rb, k / cl, 9L * L.kp, wg) +
                   warp_work(L.pr, c / cl, L.kp, wg)) / kWarpMacsPerClk +
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

// dtype: 0 = float32, 1 = bfloat16; path: the caller's route by shape
// (ops/kernels/block.py:route), refused (cudaErrorInvalidValue) where it
// cannot take the shape, never rerouted. plan (if not null) gets the tile
// side and the cluster size launched. Returns cudaGetLastError() after the
// launch.
extern "C" int boda_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, int n, int h, int w, int c,
                               int k, int dtype, int path, int* plan, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool aligned = al(x) && al(w1) && al(w2) && al(w3) && al(b1) && al(b2) && al(b3) &&
                       al(out);
  if (!path_ok(path, dtype, c, k, aligned)) return (int)cudaErrorInvalidValue;
  const bool vec = dtype == 1 && c % 8 == 0 && k % 8 == 0 && aligned;
  const bool wg = path == kPathWgmma;
  int cl = 1;
  const int t = boda_bottleneck_plan(n, h, w, c, k, dtype, path, sm_count(), &cl);
  if (t == 0) return (int)cudaErrorInvalidValue;
  if (plan) {
    plan[0] = t;
    plan[1] = cl;
  }
  Args a = {x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, k};
  a.tile = t;
  a.tiles_x = (w + t - 1) / t;
  a.tiles_per_img = a.tiles_x * ((h + t - 1) / t);
  const size_t smem = Layout(t, k, dtype == 0 ? 4 : 2, wg).bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (wg) {
    if (cl == 4) return launch_wg<4>(a, smem, s);
    if (cl == 2) return launch_wg<2>(a, smem, s);
    return launch_wg<1>(a, smem, s);
  }
  if (dtype == 0) return launch<float, false>(a, smem, s);
  if (!vec) return launch<bf16, false>(a, smem, s);
  return launch<bf16, true>(a, smem, s);
}
