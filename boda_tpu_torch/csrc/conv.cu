// Direct implicit-GEMM NHWC conv with a fused bias(+residual)(+ReLU) store:
// out(N,OH,OW,OC) = x(N,H,W,C) * w(KH,KW,C,OC), any stride and padding.
//
// Replaces two TPU kernels with one: K2, boda_tpu/ops/kernels/conv.py:575
// pallas_conv2d_halo (_conv_halo_kernel :410), and K3, conv.py:103
// pallas_conv2d_nhwc (_conv_kernel :86). Their split is a Mosaic artifact:
// the halo kernel's DMA scratch needs C % 128 == 0 and no bf16 stride, so
// K3 takes the rest after gathering halo row blocks in HBM (conv.py:119-125).
// Here the output pixels are the GEMM rows and the (ky, kx, c) filter taps
// its K; each block gathers its A tile straight from the NHWC input with
// bounds masks for the zero padding, so there is no host-side pad, no row
// gather and no im2col in HBM, at any stride and any C (the stem's C=3
// included).
//
// What bounds it on an H100: the 3x3 layers of ResNet-50 do about 290-1,100
// FLOP per byte of compulsory HBM traffic, at or above the card's ~295 FLOP/B
// bf16 ridge, so they are bound by the tensor cores; at res4/res5 (M = 6,272
// and 1,568 at batch 32) too few output tiles fill 132 SMs. The bf16 design
// (gemm.cuh's wgmma path) runs wgmma on a ring of 3-8 stages: the weights stream in
// by TMA, the input by 16-byte cp.async gathers at the swizzled addresses
// wgmma reads, with (ky, kx, c) carried from chunk to chunk instead of divided
// out per vector; a per-shape plan splits K at res4/res5. Each input pixel is
// still read once per tap through L2.
//
// Which shapes take which route (ops/kernels/common.py:plan_gemm):
//   * C % 8 == 0, N % 8 == 0, aligned: wgmma with 16-byte cp.async gathers.
//   * C % 8 != 0 (every C = 3 stem: ResNet-50's and GoogLeNet's 7x7 s2,
//     VGG-16's and ssd300's conv1_1), N % 8 == 0: wgmma_narrow, the same ring
//     with 64-row tiles, whose producer builds each 16-byte row piece of A
//     from 8 element loads (8 consecutive k may span taps: each element has
//     its own (ky, kx, c), carried from chunk to chunk, and its own bounds
//     test). The stem's input (9.6 MB at b32) sits in L2, so these loads
//     wait on latency, not on HBM.
//   * C % 8 == 0, N % 8 != 0 and N even (ssd300's six mbox_conf heads, N =
//     84 and 126): wgmma_edge, the same ring as wgmma with the filters' rows
//     padded to 16 bytes in memory (the engine's HWIO prep stores them so)
//     and the output stored from the accumulators in 4-byte pairs, masked at
//     the N edge.
//   * odd N, C % 8 != 0 with N % 8 != 0, or a misaligned w, bias, residual
//     or output (or x where C % 8 == 0): the mma.sync loop.
#include "gemm.cuh"

// path, bm, bn, splits: the plan (gemm.cuh launch_gemm); ws: splits x M x OC
// f32 when splits > 1, with M = n * oh * ow; ldb: w's row stride in elements,
// w being (KH * KW * C) rows of OC (OC when dense; a multiple of 8 on the
// wgmma paths: the engine's padded HWIO filters where OC % 8 != 0).
extern "C" int boda_conv2d(const void* x, const void* w, const void* bias, const void* res,
                           void* out, void* ws, int n, int h, int wd, int c, int oh, int ow,
                           int oc, int kh, int kw, int sy, int sx, int py, int px, int relu,
                           int dtype, int path, int bm, int bn, int splits, int ldb,
                           void* stream) {
  boda::Prob p = {};
  p.a = x;
  p.b = w;
  p.bias = bias;
  p.res = res;
  p.c = out;
  p.M = n * oh * ow;
  p.N = oc;
  p.K = kh * kw * c;
  p.relu = relu;
  p.ldb = ldb;
  p.H = h;
  p.W = wd;
  p.C = c;
  p.OH = oh;
  p.OW = ow;
  p.KW = kw;
  p.sy = sy;
  p.sx = sx;
  p.py = py;
  p.px = px;
  return boda::launch_gemm<true>(p, dtype, path, bm, bn, splits, ws, (cudaStream_t)stream);
}
