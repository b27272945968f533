// GEMM with a fused bias(+residual)(+ReLU) store: C[M,N] = A[M,K] . B[K,N].
//
// Replaces the TPU kernel K1, boda_tpu/ops/kernels/sgemm.py:80 pallas_matmul
// (_matmul_kernel :36, _matmul_bias_kernel :53). On the TPU the (m,n,k) grid
// runs in order and carries an f32 VMEM accumulator across k steps; here
// blocks run in parallel in no order, so each block loops over K itself and
// keeps its accumulator in registers (WMMA fragments for bf16, FMA registers
// for f32). Ragged M/N/K edges are masked in the kernel instead of padding
// the operands in HBM as pad2d does.
//
// What bounds it on an H100: the large-M 1x1 convs of ResNet-50 (M = 100,352
// down to 1,568 at batch 32, K = 64-256) do about 20-60 FLOP per byte of HBM
// traffic, below the card's ~295 FLOP/B bf16 ridge, so they are bound by
// bytes. The design answers that only with the fused epilogue: bias, the
// residual add and the ReLU ride the store, so the output is written once and
// the residual read once. The K >= 1024 layers are above the ridge; there the
// simple mma.sync tile loop (no TMA, no wgmma, no multi-stage pipeline) is the
// limit, and those are for later work.
#include "gemm.cuh"

extern "C" int boda_gemm(const void* a, const void* b, const void* bias, const void* res,
                         void* c, int M, int N, int K, int relu, int dtype,
                         void* stream) {
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
  return boda::launch_gemm<false>(p, dtype, (cudaStream_t)stream);
}
