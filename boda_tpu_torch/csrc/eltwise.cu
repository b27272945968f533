// Flat elementwise op: out[i] = f(a[i]) or f(a[i], b[i]) for f in relu, copy,
// neg (unary) and mul, add, sub, max (binary), over n elements of one dtype
// (float32, bfloat16 or float16).
//
// Replaces K9, boda_tpu/ops/kernels/elementwise.py:47 pallas_elementwise
// (_elt_kernel :42). The TPU kernel flattens its operands, pads them in HBM to
// (rows, 128) blocks of the vector unit's layout, runs a grid over row blocks
// and slices the padding off again. Nothing here is padded: a grid-stride loop
// walks the flat array, each thread moving 16 bytes of each operand per step
// (4 float32 or 8 16-bit values) where every pointer is 16-byte aligned, with
// a scalar tail for the last n % 8 or n % 4; a misaligned operand (a sliced
// view) takes the scalar loop throughout.
//
// Every value is computed in f32 and rounded once to the output dtype, as XLA
// computes jnp's bf16 ops; for one add, sub or mul that single rounding gives
// the correctly rounded result. max and relu follow jnp.maximum: NaN if either
// side is NaN, and +0 for max(-0, +0).
//
// What bounds it on an H100: bytes. ResNet-50's largest residual add at b32
// (32x256x56x56 bf16) moves 3 x 51.4 MB, ~46 us at 3.35 TB/s; one flop per
// element is nothing beside that. The design's answer is full 16-byte
// accesses, neighbouring threads on neighbouring addresses, and no padding
// copies.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

enum Func { kRelu = 0, kCopy, kNeg, kMul, kAdd, kSub, kMax };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// jnp.maximum: NaN propagates (as the quiet NaN torch.maximum returns), and a
// tie of -0 and +0 gives +0 (the AND of the two bit patterns; for any other tie
// both are the same value)
__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a || b != b) return __uint_as_float(0x7fc00000u);
  if (a == b) return __uint_as_float(__float_as_uint(a) & __float_as_uint(b));
  return a > b ? a : b;
}

template <int F>
__device__ __forceinline__ float apply(float a, float b) {
  if (F == kRelu) return jmax(a, 0.f);
  if (F == kCopy) return a;
  if (F == kNeg) return -a;
  if (F == kMul) return a * b;
  if (F == kAdd) return a + b;
  if (F == kSub) return a - b;
  return jmax(a, b);
}

template <typename T, int F>
__device__ __forceinline__ T elt(const T* a, const T* b, long long i) {
  constexpr bool kBinary = F >= kMul;
  return from_f32<T>(apply<F>(to_f32(a[i]), kBinary ? to_f32(b[i]) : 0.f));
}

template <typename T, int F, bool VEC>
__global__ void __launch_bounds__(256) eltwise_kernel(const T* a, const T* b, T* out,
                                                      long long n) {
  constexpr bool kBinary = F >= kMul;
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long nv = n / kVec;
    union Pack {
      uint4 u;
      T e[kVec];
    };
    for (long long v = i; v < nv; v += stride) {
      Pack pa, pb, po;
      pa.u = ((const uint4*)a)[v];
      if (kBinary) pb.u = ((const uint4*)b)[v];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        po.e[e] = from_f32<T>(apply<F>(to_f32(pa.e[e]), kBinary ? to_f32(pb.e[e]) : 0.f));
      ((uint4*)out)[v] = po.u;
    }
    done = nv * kVec;
  }
  for (long long j = done + i; j < n; j += stride) out[j] = elt<T, F>(a, b, j);
}

template <typename T, int F>
int launch(const void* a, const void* b, void* out, long long n, bool vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const long long work = vec ? n / kVec + kVec : n;
  long long blocks = (work + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM
  if (blocks < 1) blocks = 1;
  if (vec)
    eltwise_kernel<T, F, true><<<(unsigned)blocks, 256, 0, s>>>((const T*)a, (const T*)b,
                                                                (T*)out, n);
  else
    eltwise_kernel<T, F, false><<<(unsigned)blocks, 256, 0, s>>>((const T*)a, (const T*)b,
                                                                 (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* out, long long n, int func, bool vec,
             cudaStream_t s) {
  switch (func) {
    case kRelu: return launch<T, kRelu>(a, b, out, n, vec, s);
    case kCopy: return launch<T, kCopy>(a, b, out, n, vec, s);
    case kNeg: return launch<T, kNeg>(a, b, out, n, vec, s);
    case kMul: return launch<T, kMul>(a, b, out, n, vec, s);
    case kAdd: return launch<T, kAdd>(a, b, out, n, vec, s);
    case kSub: return launch<T, kSub>(a, b, out, n, vec, s);
    case kMax: return launch<T, kMax>(a, b, out, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// func: 0 relu, 1 copy, 2 neg, 3 mul, 4 add, 5 sub, 6 max (b is read only by
// the binary funcs and may be null for the others). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. Returns cudaGetLastError() after the launch.
extern "C" int boda_eltwise(const void* a, const void* b, void* out, long long n, int func,
                            int dtype, void* stream) {
  if (n <= 0 || func < 0 || func > kMax || (func >= kMul && b == nullptr))
    return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = al(a) && al(out) && (func < kMul || al(b));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, b, out, n, func, vec, s);
  if (dtype == 1) return dispatch<bf16>(a, b, out, n, func, vec, s);
  if (dtype == 2) return dispatch<__half>(a, b, out, n, func, vec, s);
  return (int)cudaErrorInvalidValue;
}
