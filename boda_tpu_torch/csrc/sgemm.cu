// GEMM with a fused bias(+residual)(+ReLU) store: C[M,N] = A[M,K] . B[K,N].
//
// Replaces the TPU kernel K1, boda_tpu/ops/kernels/sgemm.py:80 pallas_matmul
// (_matmul_kernel :36, _matmul_bias_kernel :53). On the TPU the (m,n,k) grid
// runs in order and carries an f32 VMEM accumulator across k steps; here
// blocks run in parallel in no order, so each block loops over K itself and
// keeps its accumulator in registers (wgmma's or WMMA's for bf16, FMA
// registers for f32). Ragged M/N/K edges are masked in the kernel instead of padding
// the operands in HBM as pad2d does.
//
// What bounds it on an H100: the large-M 1x1 convs of ResNet-50 (M = 100,352
// down to 1,568 at batch 32, K = 64-256) do about 20-60 FLOP per byte of HBM
// traffic, below the card's ~295 FLOP/B bf16 ridge, so they are bound by
// bytes; the K >= 512 layers and fc1000 are bound by the tensor cores, or
// by too few output tiles to fill 132 SMs. The bf16 design (gemm.cuh's wgmma
// path) answers both: A and B stream in by TMA through a ring of 3-8 stages while
// wgmma runs on the previous stage, the epilogue adds bias, residual and ReLU
// to the accumulator registers and stores the tile by TMA (the output written
// once, the residual read once), and a per-shape plan (ops/kernels/common.py:plan_gemm)
// picks the tile (64 or 128 rows, 64/128/256 columns) and splits K where the
// tiles alone would leave SMs idle. An even N % 8 != 0 (fc1000's (tp=2) slice,
// N = 500) takes wgmma_edge: B read by TMA at a row stride padded to 16 bytes,
// the output stored from the accumulators, masked at the N edge. A K % 8 != 0
// (fc1000's (tp=2) dgrad, K = 500) takes wgmma when A's rows are padded the
// same way (lda, as the training step's fc writes dY): TMA reads the columns
// past K as zeros.
#include "gemm.cuh"

// path, bm, bn, splits: the plan (gemm.cuh launch_gemm); ws: splits x M x N
// f32 when splits > 1; lda, ldb: a's and b's row strides in elements (K and N
// when dense; multiples of 8 on the wgmma paths: padded rows where K % 8 != 0
// or N % 8 != 0).
extern "C" int boda_gemm(const void* a, const void* b, const void* bias, const void* res,
                         void* c, void* ws, int M, int N, int K, int relu, int dtype, int path,
                         int bm, int bn, int splits, int lda, int ldb, void* stream) {
  boda::Prob p = {};
  p.a = a;
  p.b = b;
  p.bias = bias;
  p.res = res;
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.relu = relu;
  p.lda = lda;
  p.ldb = ldb;
  return boda::launch_gemm<false>(p, dtype, path, bm, bn, splits, ws, (cudaStream_t)stream);
}
