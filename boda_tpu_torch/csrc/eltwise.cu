// Flat elementwise op: out[i] = f(a[i]) or f(a[i], b[i]) for f in relu, copy,
// neg (unary) and mul, add, sub, max (binary), over n elements of one dtype
// (float32, bfloat16 or float16).
//
// Replaces K9, boda_tpu/ops/kernels/elementwise.py:47 pallas_elementwise
// (_elt_kernel :42). The TPU kernel flattens its operands, pads them in HBM to
// (rows, 128) blocks of the vector unit's layout, runs a grid over row blocks
// and slices the padding off again. Nothing here is padded.
//
// What bounds it on an H100: bytes. ResNet-50's largest residual add at b32
// (32x256x56x56 bf16) moves 3 x 51.4 MB, ~46 us at 3.35 TB/s; one flop per
// element is nothing beside that. So the design keeps the most bytes in
// flight for the fewest instructions, and leaves no wave tail:
//
//   * ring (every operand 16-byte aligned): a persistent grid of a few blocks
//     per SM (ops/kernels/elementwise.py:plan). The array is cut into chunks
//     of one stage, dealt to the blocks in turn, so that at any time the
//     whole card streams one region of the array and the last round leaves
//     at most one chunk's imbalance (one contiguous span per block ran
//     5-15% slower on the H100: scripts/torch_stream_parts.py). One thread of a
//     producer warp streams the block's chunks through a ring of
//     shared-memory stages with 1-D bulk copies (cp.async.bulk, the TMA
//     without a tensor map), a and b into the same stage, the stage's full
//     mbarrier counting their bytes; the loads carry an L2 evict-first
//     policy, since the stream is read once. Eight
//     consumer warps compute each stage from shared memory in f32, round once
//     and write 16 bytes a thread with streaming stores (st.global.cs), then
//     free the stage through its empty mbarrier (one arrival per warp). The
//     last n % 8 (n % 4 for f32) elements are block 0's, one at a time.
//   * scalar (an operand off 16-byte alignment, a sliced view): a grid-stride
//     loop, one element per thread and step.
//
// The plan (path, blocks, stage bytes, stages) is worked out in Python and
// passed in; the C side only checks that it can run it.
//
// Every value is computed in f32 and rounded once to the output dtype, as XLA
// computes jnp's bf16 ops; for one add, sub or mul that single rounding gives
// the correctly rounded result. max and relu follow jnp.maximum: NaN if either
// side is NaN, and +0 for max(-0, +0). Both paths compute the same function
// of each element, so they agree bit for bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Func { kRelu = 0, kCopy, kNeg, kMul, kAdd, kSub, kMax };
enum Path { kRing = 0, kScalar = 1 };

constexpr int kConsumers = 256;               // 8 warps compute
constexpr int kRingThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 128;  // full[s] at 8s, empty[s] at 64 + 8s
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 32;  // per-device state: the shared-memory opt-ins

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

using boda::jmax;  // jnp.maximum, shared with the ReLU and max of K1-K8

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

// 16 bytes written past L1 and marked as streaming (evict-first) in L2
__device__ __forceinline__ void st_cs(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

template <typename T, int F>
__global__ void __launch_bounds__(kRingThreads)
    eltwise_ring(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                 long long n, int stage_bytes, int stages) {
  constexpr bool kBinary = F >= kMul;
  constexpr int kVec = 16 / sizeof(T);
  union Pack {
    uint4 u;
    T e[kVec];
  };
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = boda::smem_u32(smem);
  unsigned char* ring = smem + kBarBytes;
  const int slot = kBinary ? 2 * stage_bytes : stage_bytes;  // a's stage, then b's
  const int su = stage_bytes / 16;                           // 16-byte units per stage
  // the array's 16-byte units in chunks of one stage, dealt to the blocks in
  // turn: this block's stage `it` holds chunk it * grid + block, units
  // [first(it), first(it) + count(it)); only the last chunk is short
  const long long units = n / kVec;
  const long long chunks = (units + su - 1) / su;
  const long long nst =
      (long long)blockIdx.x < chunks ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto first = [&](long long it) { return (it * gridDim.x + blockIdx.x) * su; };
  auto count = [&](long long it) { return (int)min((long long)su, units - first(it)); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      boda::mbar_init(bars + 8 * s, 1);
      boda::mbar_init(bars + 64 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {
    if (tid == kConsumers) {  // the producer: one thread issues every copy
      const uint64_t policy = boda::l2_evict_first();
      for (long long it = 0; it < nst; ++it) {
        const int s = (int)(it % stages);
        const long long lap = it / stages;
        if (lap > 0) boda::mbar_wait(bars + 64 + 8 * s, (uint32_t)((lap - 1) & 1));
        const long long off = first(it);
        const uint32_t bytes = (uint32_t)count(it) * 16;
        const uint32_t dst = boda::smem_u32(ring + (size_t)s * slot);
        boda::mbar_expect_tx(bars + 8 * s, kBinary ? 2 * bytes : bytes);
        boda::bulk_load_1d(dst, (const uint4*)a + off, bytes, bars + 8 * s, policy);
        if (kBinary)
          boda::bulk_load_1d(dst + stage_bytes, (const uint4*)b + off, bytes, bars + 8 * s,
                             policy);
      }
    }
    return;
  }
  for (long long it = 0; it < nst; ++it) {
    const int s = (int)(it % stages);
    boda::mbar_wait(bars + 8 * s, (uint32_t)((it / stages) & 1));
    const int cnt = count(it);
    const uint4* sa = (const uint4*)(ring + (size_t)s * slot);
    const uint4* sb = (const uint4*)(ring + (size_t)s * slot + stage_bytes);
    uint4* o = (uint4*)out + first(it);
    for (int u = tid; u < cnt; u += kConsumers) {
      Pack pa, pb, po;
      pa.u = sa[u];
      if (kBinary) pb.u = sb[u];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        po.e[e] = from_f32<T>(apply<F>(to_f32(pa.e[e]), kBinary ? to_f32(pb.e[e]) : 0.f));
      st_cs(o + u, po.u);
    }
    __syncwarp();
    if ((tid & 31) == 0) boda::mbar_arrive(bars + 64 + 8 * s);
  }
  if (blockIdx.x == 0)
    for (long long j = units * kVec + tid; j < n; j += kConsumers) out[j] = elt<T, F>(a, b, j);
}

template <typename T, int F>
__global__ void __launch_bounds__(256)
    eltwise_scalar(const T* a, const T* b, T* out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride)
    out[j] = elt<T, F>(a, b, j);
}

template <typename T, int F>
int launch(const void* a, const void* b, void* out, long long n, int path, int blocks,
           int stage_bytes, int stages, cudaStream_t s) {
  if (path == kScalar) {
    eltwise_scalar<T, F><<<blocks, 256, 0, s>>>((const T*)a, (const T*)b, (T*)out, n);
    return (int)cudaGetLastError();
  }
  constexpr int nin = F >= kMul ? 2 : 1;
  const int smem = kBarBytes + stages * stage_bytes * nin;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB, allowed per function and per device (the attribute holds
  // for the current device only)
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    cudaError_t e = cudaFuncSetAttribute(eltwise_ring<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  eltwise_ring<T, F><<<blocks, kRingThreads, smem, s>>>((const T*)a, (const T*)b, (T*)out, n,
                                                         stage_bytes, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* out, long long n, int func, int path,
             int blocks, int stage_bytes, int stages, cudaStream_t s) {
  switch (func) {
    case kRelu: return launch<T, kRelu>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kCopy: return launch<T, kCopy>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kNeg: return launch<T, kNeg>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kMul: return launch<T, kMul>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kAdd: return launch<T, kAdd>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kSub: return launch<T, kSub>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    case kMax: return launch<T, kMax>(a, b, out, n, path, blocks, stage_bytes, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// func: 0 relu, 1 copy, 2 neg, 3 mul, 4 add, 5 sub, 6 max (b is read only by
// the binary funcs and may be null for the others). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. path: 0 ring (every operand 16-byte aligned;
// stage_bytes a multiple of 16, 1 <= stages <= 8), 1 scalar; blocks: the
// grid. Returns cudaGetLastError() after the launch.
extern "C" int boda_eltwise(const void* a, const void* b, void* out, long long n, int func,
                            int dtype, int path, int blocks, int stage_bytes, int stages,
                            void* stream) {
  if (n <= 0 || func < 0 || func > kMax || (func >= kMul && b == nullptr) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (path == kRing) {
    auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    if (!al(a) || !al(out) || (func >= kMul && !al(b)) || stage_bytes < 16 ||
        stage_bytes % 16 != 0 || stages < 1 || stages > kMaxStages)
      return (int)cudaErrorInvalidValue;
  } else if (path != kScalar) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, b, out, n, func, path, blocks, stage_bytes, stages, s);
  if (dtype == 1) return dispatch<bf16>(a, b, out, n, func, path, blocks, stage_bytes, stages, s);
  if (dtype == 2)
    return dispatch<__half>(a, b, out, n, func, path, blocks, stage_bytes, stages, s);
  return (int)cudaErrorInvalidValue;
}

