// Mish, y = x * tanh(softplus(x)), in one pass over device memory, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes Mish as three jnp ops
// (object_tracking_tpu/models/darknet_cfg.py::_activate), which XLA fuses
// into one loop. Run eagerly, the same expression is three PyTorch
// kernels (softplus, tanh, the product): two intermediates are written and
// read back and x is read twice, 28 B an element in float32. This kernel
// reads x once and writes y once, 8 B an element.
//
//   x   n elements, float32 or bfloat16: the storage of a dense tensor
//   y   n elements of the same type
//
// What bounds it on this card: bytes. YOLOv4's 72 Mish layers at B=8,
// 608x608 hold ~758 M elements a call, ~6.1 GB in float32 at 8 B an
// element: ~1.81 ms at 3.35 TB/s. The arithmetic (expf, log1pf, tanhf and
// a product, a few dozen float instructions an element) hides under the
// loads. The design:
//   - 16-byte loads and stores (4 floats or 8 bfloat16 a thread),
//     neighbouring threads on neighbouring addresses;
//   - blocks of 128 threads, each thread loading kUnroll vectors before it
//     computes any, so that several loads are in flight;
//   - one block for every kThreads * kUnroll vectors
//     (ops/cuda/mish.py::launch_plan). A grid capped at 4-8 blocks an SM
//     that strides over the rest measured 12 % slower over YOLOv4's 72
//     shapes on the H100 (its last wave runs part-empty); the stride loop
//     stays for a grid cut at the launch limit;
//   - the n % vec last elements on the first threads of block 0; a pointer
//     off 16 bytes takes the scalar instantiation (vec 1).
// Over those 72 shapes it runs at torch's own copy's rate (~81 % of the
// published 3.35 TB/s for a read and a write of every element).
//
// Exactness: the eager chain's own arithmetic. PyTorch's softplus at
// beta 1, threshold 20 is x > 20 ? x : log1p(exp(x)) in float (its x * 1
// and / 1 are exact), its tanh is tanhf of the stored softplus, its
// product one float multiply; each result is rounded to the tensor's
// type. This kernel calls the same libdevice functions in float and, in
// bfloat16, rounds the softplus and the tanh to bfloat16 where the eager
// chain stores them, so y equals the chain bit for bit in both types.
// Built with -fmad=false, never fast-math (which would swap in
// approximate exp, log and tanh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // a block
constexpr int kUnroll = 2;      // vectors in flight a thread

__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

union Vec16 {
  uint4 raw;
  float f[4];
  uint16_t h[8];
};

struct Float32 {
  using Elem = float;
  static constexpr int kVec = 4;
  __device__ static float apply(float x) { return x * tanhf(softplus(x)); }
  __device__ static uint4 apply(uint4 raw) {
    Vec16 v;
    v.raw = raw;
#pragma unroll
    for (int k = 0; k < kVec; ++k) v.f[k] = apply(v.f[k]);
    return v.raw;
  }
};

struct BFloat16 {
  using Elem = uint16_t;   // the bits of a __nv_bfloat16
  static constexpr int kVec = 8;
  __device__ static float rounded(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static uint16_t apply(uint16_t bits) {
    const float x = __bfloat162float(__ushort_as_bfloat16(bits));
    const float t = rounded(tanhf(rounded(softplus(x))));
    return __bfloat16_as_ushort(__float2bfloat16(x * t));
  }
  __device__ static uint4 apply(uint4 raw) {
    Vec16 v;
    v.raw = raw;
#pragma unroll
    for (int k = 0; k < kVec; ++k) v.h[k] = apply(v.h[k]);
    return v.raw;
  }
};

// `units` 16-byte vectors (kVector) or single elements, grid-stride, then
// the `tail` elements past the last vector on block 0.
template <typename Op, bool kVector>
__global__ void __launch_bounds__(kThreads)
    mish_kernel(const typename Op::Elem* __restrict__ x,
                typename Op::Elem* __restrict__ y, int64_t units, int tail) {
  using Unit = std::conditional_t<kVector, uint4, typename Op::Elem>;
  const Unit* xu = reinterpret_cast<const Unit*>(x);
  Unit* yu = reinterpret_cast<Unit*>(y);
  const int64_t step = (int64_t)gridDim.x * (kThreads * kUnroll);
  for (int64_t base = (int64_t)blockIdx.x * (kThreads * kUnroll) +
                      threadIdx.x;
       base < units; base += step) {
    Unit v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < units) v[u] = xu[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < units) yu[i] = Op::apply(v[u]);
    }
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const int64_t i = units * (sizeof(Unit) / sizeof(typename Op::Elem)) +
                      threadIdx.x;
    y[i] = Op::apply(x[i]);
  }
}

template <typename Op>
cudaError_t launch(const void* x, void* y, long long n, int vec, int blocks,
                   cudaStream_t stream) {
  const auto* in = static_cast<const typename Op::Elem*>(x);
  auto* out = static_cast<typename Op::Elem*>(y);
  if (vec == 1) {
    mish_kernel<Op, false><<<blocks, kThreads, 0, stream>>>(in, out, n, 0);
  } else if (vec == Op::kVec) {
    if (((uintptr_t)x | (uintptr_t)y) & 15) return cudaErrorInvalidValue;
    mish_kernel<Op, true><<<blocks, kThreads, 0, stream>>>(
        in, out, n / vec, (int)(n % vec));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. vec: 1 (scalar loads, any alignment) or
// 16 bytes' worth of elements (both pointers 16-byte aligned). Launches on
// `stream`, does not synchronise; returns the launch's cudaError_t.
extern "C" int mish_launch(const void* x, void* y, long long n, int dtype,
                           int vec, int blocks, void* stream) {
  if (n < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<Float32>(x, y, n, vec, blocks, s);
  if (dtype == 1) return (int)launch<BFloat16>(x, y, n, vec, blocks, s);
  return (int)cudaErrorInvalidValue;
}
