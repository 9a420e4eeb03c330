// BatchNorm with batch statistics (flax's) for Hopper (sm_90a): one pass
// over x for both per-channel sums, one to normalise; in the backward one
// pass over dy and x for the two gradient sums, one to write dx.
//
// Replaces no TPU kernel: the JAX package writes BatchNorm as flax's
// nn.BatchNorm (object_tracking_tpu/models/darknet19.py), which XLA fuses
// into a few loops. Run eagerly, the port's expression of the same
// statistics (the mean and E[x^2] - E[x]^2, clipped at 0) and autograd's
// backward through it are ~20 kernels a layer, each reading or writing
// whole feature maps.
//
//   x, y, dy, dx   (N, C, H, W), float32 or bfloat16, dense NCHW
//                  ("planes", layout 0) or channels_last ("rows",
//                  layout 1: N*H*W rows of C channels)
//   weight, bias   C float32
//   stats          (4, C) float32: mean, var, rstd = rsqrt(var + eps),
//                  keep (1 where E[x^2] - E[x]^2 >= 0, else 0: the clip's
//                  gradient)
//   partials       (splits, 2, C) float64: one block's two sums
//   sums           (2, C) float64: the two sums of every block
//   coef           (2, C) float32: sum(dy) / N, keep * rstd^2 *
//                  sum(dy * (x - mean)) / N
//
// What bounds it on this card: bytes. The least traffic is 12 B an
// element in float32 without a gradient (x read twice, y written) and 32 B
// with one (the backward reads dy and x twice and writes dx): Darknet-19 at
// B=32, 416x416 normalises 516 M elements a step, 16.5 GB, ~4.9 ms at
// 3.35 TB/s. The design:
//   - every pass walks the tensor the same way (ops/cuda/batch_norm.py::
//     launch_plan): for rows a block holds `tile` (up to 32) column units
//     of 4 channels (16 B in float32, 8 B in bfloat16) times `lanes` rows,
//     so a warp reads contiguous memory, a thread keeps its channels'
//     constants and sums in registers, and a block's partial sums stay a
//     few percent of what it reads; for planes a block holds one
//     channel and a chunk of its N*H*W elements, in vectors where a plane
//     of H*W holds a whole number of them, else one element a thread;
//   - about 4 blocks an SM in one wave, each over an equal chunk, with
//     several loads in flight a thread (kUnroll vectors of each stream);
//   - sums in float64 a thread, blocks' sums to `partials` in a fixed
//     tree, then a finishing kernel that adds the partials in a fixed
//     order: no atomics, so the same input gives the same bits;
//   - the finishing kernel turns the sums into the statistics (forward)
//     or the two coefficients of dx (backward), so the second pass is
//     elementwise with per-channel constants.
// A data group all-reduces the sums between the passes: `stage` 1 stops
// after the sums, `stage` 2 starts from summed sums.
//
// Accuracy: the float64 sums add no rounding that the float32 result can
// see below ~1e-9 relative; the statistics are then rounded once to
// float32. Built with -fmad=false, never fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ops/cuda/batch_norm.py::Plan, field for field (outside the anonymous
// namespace: the exported launchers take it)
struct Plan {
  int64_t outer;  // rows N*H*W (rows) or planes N (planes)
  int64_t inner;  // H*W (planes) or 1 (rows)
  int64_t chunk;  // rows (rows) or units of a channel (planes) a block
  int channels;
  int layout;       // 0 planes, 1 rows
  int vec;          // 1 or kVec
  int splits;       // blocks along the chunks
  int tile;         // rows: column units a block
  int lanes;        // rows: rows a pass of a block
  int col_tiles;    // rows: blocks across the columns
};

namespace {

constexpr int kThreads = 256;       // a block of the four passes
constexpr int kVec = 4;             // channels or elements a vector
constexpr int kMinBlocksPerSm = 4;  // the plan's blocks an SM
constexpr int kFinishChannels = 32; // a finishing block's channels
constexpr int kFinishLanes = 32;    // and its lanes along the partials
constexpr int kFinishThreads = kFinishChannels * kFinishLanes;

struct Args {
  Plan p;
  const void* x;
  const void* dy;
  void* out;
  const float* stats;
  const float* weight;
  const float* bias;
  const float* coef;
  double* partials;
};

// ---------------------------------------------------------------- loads
template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load(const void* p, int64_t i, float (&v)[1]) {
    v[0] = static_cast<const float*>(p)[i];
  }
  __device__ static void load(const void* p, int64_t i, float (&v)[kVec]) {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ static void store(void* p, int64_t i, const float (&v)[1]) {
    static_cast<float*>(p)[i] = v[0];
  }
  __device__ static void store(void* p, int64_t i, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float bf16(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));  // to nearest even
}

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load(const void* p, int64_t i, float (&v)[1]) {
    v[0] = bf16(static_cast<const uint16_t*>(p)[i]);
  }
  __device__ static void load(const void* p, int64_t i, float (&v)[kVec]) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const uint16_t*>(p) + i);
    v[0] = bf16(u.x & 0xffff); v[1] = bf16(u.x >> 16);
    v[2] = bf16(u.y & 0xffff); v[3] = bf16(u.y >> 16);
  }
  __device__ static void store(void* p, int64_t i, const float (&v)[1]) {
    static_cast<uint16_t*>(p)[i] = bf16_bits(v[0]);
  }
  __device__ static void store(void* p, int64_t i, const float (&v)[kVec]) {
    uint2 u;
    u.x = bf16_bits(v[0]) | ((uint32_t)bf16_bits(v[1]) << 16);
    u.y = bf16_bits(v[2]) | ((uint32_t)bf16_bits(v[3]) << 16);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) = u;
  }
};

// ----------------------------------------------------------------- ops
// Each op reads one or two streams (x; or dy and x), keeps per-channel
// constants, and either adds to two float64 sums (`add`, kReduce) or
// writes one stream (`apply`).

struct Sums {  // sum x, sum x^2
  static constexpr bool kGrad = false, kReduce = true;
  static constexpr int kUnroll = 4;
  __device__ void init(const Args&, int) {}
  __device__ void add(float x, float, double& s, double& q) const {
    const double d = x;
    s += d;
    q = fma(d, d, q);
  }
};

struct Normalize {  // y = (x - mean) * (rstd * weight) + bias
  static constexpr bool kGrad = false, kReduce = false;
  static constexpr int kUnroll = 4;
  float mean, mul, bias;
  __device__ void init(const Args& a, int c) {
    const int C = a.p.channels;
    mean = a.stats[c];
    mul = a.stats[2 * C + c] * a.weight[c];
    bias = a.bias[c];
  }
  __device__ float apply(float x, float) const {
    return (x - mean) * mul + bias;
  }
};

struct GradSums {  // sum dy, sum dy * (x - mean)
  static constexpr bool kGrad = true, kReduce = true;
  static constexpr int kUnroll = 2;
  double mean;
  __device__ void init(const Args& a, int c) { mean = a.stats[c]; }
  __device__ void add(float x, float dy, double& s, double& q) const {
    const double g = dy;
    s += g;
    q = fma(g, (double)x - mean, q);
  }
};

struct GradInput {  // dx = rstd * weight * (dy - b1 - (x - mean) * c1)
  static constexpr bool kGrad = true, kReduce = false;
  static constexpr int kUnroll = 2;
  float mean, mul, b1, c1;
  __device__ void init(const Args& a, int c) {
    const int C = a.p.channels;
    mean = a.stats[c];
    mul = a.stats[2 * C + c] * a.weight[c];
    b1 = a.coef[c];
    c1 = a.coef[C + c];
  }
  __device__ float apply(float x, float dy) const {
    return mul * (dy - b1 - (x - mean) * c1);
  }
};

// -------------------------------------------------------------- passes
// One unit of `Op` on V elements x (and dy) of channels c .. c + V - 1
// (op[e]), at element offset `at`: added to the sums, or written.
template <class Op, typename T, int V, int K>
__device__ __forceinline__ void visit(const Args& a, const Op (&op)[K],
                                      const float (&x)[V],
                                      const float (&g)[V], int64_t at,
                                      double (&s)[K], double (&q)[K]) {
  float out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int k = K == 1 ? 0 : e;
    if constexpr (Op::kReduce) {
      op[k].add(x[e], g[e], s[k], q[k]);
    } else {
      out[e] = op[k].apply(x[e], g[e]);
    }
  }
  if constexpr (!Op::kReduce) Io<T>::store(a.out, at, out);
}

template <typename T, int V>
__device__ __forceinline__ void load_unit(const Args& a, bool grad,
                                          int64_t at, float (&x)[V],
                                          float (&g)[V]) {
  Io<T>::load(a.x, at, x);
  if (grad) {
    Io<T>::load(a.dy, at, g);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) g[e] = 0.0f;
  }
}

// The rows' block reduction: lanes ty and ty + half added in a fixed tree,
// then lane 0 writes the block's row of `partials`.
template <int V>
__device__ void reduce_rows(const Args& a, bool live, int ty, int c0,
                            const double (&s)[V], const double (&q)[V]) {
  const Plan& p = a.p;
  __shared__ double red[2 * V][kThreads];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[e][threadIdx.x] = s[e];
    red[V + e][threadIdx.x] = q[e];
  }
  __syncthreads();
  int width = 1;
  while (width < p.lanes) width <<= 1;
  for (int half = width >> 1; half > 0; half >>= 1) {
    if (live && ty < half && ty + half < p.lanes) {
      const int other = threadIdx.x + half * p.tile;
#pragma unroll
      for (int e = 0; e < 2 * V; ++e) red[e][threadIdx.x] += red[e][other];
    }
    __syncthreads();
  }
  if (live && ty == 0) {
    const int C = p.channels;
    double* part = a.partials + (int64_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part[c0 + e] = red[e][threadIdx.x];
      part[C + c0 + e] = red[V + e][threadIdx.x];
    }
  }
}

// rows: thread (ty, tx) of block (k, j) holds column unit j * tile + tx
// (channels col * vec .. + vec) and rows chunk * k + ty, + lanes, ...
template <class Op, typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    rows_pass(Args a) {
  constexpr int U = Op::kUnroll;
  const Plan& p = a.p;
  const int C = p.channels;
  const int tx = threadIdx.x % p.tile, ty = threadIdx.x / p.tile;
  const int col = blockIdx.y * p.tile + tx;
  const bool live = ty < p.lanes && col * V < C;
  const int c0 = col * V;
  Op op[V];
  double s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    s[e] = 0.0;
    q[e] = 0.0;
    if (live) op[e].init(a, c0 + e);
  }
  const int64_t r0 = (int64_t)blockIdx.x * p.chunk;
  const int64_t r1 = min(p.outer, r0 + p.chunk);
  if (live) {
    for (int64_t r = r0 + ty; r < r1; r += (int64_t)p.lanes * U) {
      float x[U][V], g[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t row = r + (int64_t)u * p.lanes;
        if (row < r1)
          load_unit<T, V>(a, Op::kGrad, row * C + c0, x[u], g[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t row = r + (int64_t)u * p.lanes;
        if (row < r1)
          visit<Op, T, V, V>(a, op, x[u], g[u], row * C + c0, s, q);
      }
    }
  }
  if constexpr (Op::kReduce) reduce_rows<V>(a, live, ty, c0, s, q);
}

// planes: block (k, c) holds units chunk * k .. of channel c, a unit j
// being vector j % P of plane j / P (P = H*W / vec units a plane)
template <class Op, typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    planes_pass(Args a) {
  constexpr int U = Op::kUnroll;
  const Plan& p = a.p;
  const int C = p.channels;
  const int c = blockIdx.y;
  const uint32_t P = (uint32_t)(p.inner / V);
  const int64_t units = p.outer * (int64_t)P;
  Op op[1];
  op[0].init(a, c);
  double s[1] = {0.0}, q[1] = {0.0};
  const int64_t j0 = (int64_t)blockIdx.x * p.chunk;
  const int64_t j1 = min(units, j0 + p.chunk);
  for (int64_t j = j0 + threadIdx.x; j < j1; j += kThreads * U) {
    float x[U][V], g[U][V];
    int64_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t jj = j + u * kThreads;
      if (jj < j1) {
        const uint32_t n = (uint32_t)jj / P;
        const uint32_t i = (uint32_t)jj - n * P;
        at[u] = (((int64_t)n * C + c) * P + i) * V;
        load_unit<T, V>(a, Op::kGrad, at[u], x[u], g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u * kThreads < j1)
        visit<Op, T, V, 1>(a, op, x[u], g[u], at[u], s, q);
    }
  }
  if constexpr (Op::kReduce) {
    double sw = s[0], qw = q[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sw += __shfl_down_sync(0xffffffffu, sw, o);
      qw += __shfl_down_sync(0xffffffffu, qw, o);
    }
    __shared__ double red[2][kThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[0][warp] = sw;
      red[1][warp] = qw;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        sw += red[0][w];
        qw += red[1][w];
      }
      double* part = a.partials + (int64_t)blockIdx.x * 2 * C;
      part[c] = sw;
      part[C + c] = qw;
    }
  }
}

// ----------------------------------------------------------- finishing
// The two sums of channel c over `splits` rows of `src` ((splits, 2, C)),
// added in a fixed order: lane l takes rows l, l + kFinishLanes, ..., then
// lane 0 adds the lanes in turn. Valid in lane 0.
__device__ void finish_sums(const double* src, int splits, int C, int c,
                            double& s, double& q) {
  const int cl = threadIdx.x % kFinishChannels;
  const int lane = threadIdx.x / kFinishChannels;
  s = 0.0;
  q = 0.0;
  if (c < C) {
    for (int k = lane; k < splits; k += kFinishLanes) {
      s += src[(int64_t)k * 2 * C + c];
      q += src[(int64_t)k * 2 * C + C + c];
    }
  }
  __shared__ double red[2][kFinishLanes][kFinishChannels];
  red[0][lane][cl] = s;
  red[1][lane][cl] = q;
  __syncthreads();
  if (lane == 0) {
    for (int l = 1; l < kFinishLanes; ++l) {
      s += red[0][l][cl];
      q += red[1][l][cl];
    }
  }
}

// Forward: the sums (to `sums` where given) and, for count > 0, flax's
// statistics from them.
__global__ void __launch_bounds__(kFinishThreads)
    finish_forward(const double* src, int splits, int C, double count,
                   float eps, double* sums, float* stats) {
  const int c = blockIdx.x * kFinishChannels + threadIdx.x % kFinishChannels;
  double s, q;
  finish_sums(src, splits, C, c, s, q);
  if (threadIdx.x >= kFinishChannels || c >= C) return;
  if (sums != nullptr) {
    sums[c] = s;
    sums[C + c] = q;
  }
  if (count <= 0.0) return;
  const double mean = s / count;
  const double v = q / count - mean * mean;
  // max(v, 0) that keeps a NaN, as clamp_min does; its gradient passes
  // where v >= 0
  const float var = (float)(v < 0.0 ? 0.0 : v);
  const float biased = var + eps;  // float32, as the plain path adds it
  stats[c] = (float)mean;
  stats[C + c] = var;
  stats[2 * C + c] = (float)(1.0 / sqrt((double)biased));
  stats[3 * C + c] = v >= 0.0 ? 1.0f : 0.0f;
}

// Backward: the sums (to `sums` where given), the parameters' gradients
// from them, and for count > 0 the coefficients of dx.
__global__ void __launch_bounds__(kFinishThreads)
    finish_backward(const double* src, int splits, int C, double count,
                    const float* stats, double* sums, float* dweight,
                    float* dbias, float* coef) {
  const int c = blockIdx.x * kFinishChannels + threadIdx.x % kFinishChannels;
  double s, q;
  finish_sums(src, splits, C, c, s, q);
  if (threadIdx.x >= kFinishChannels || c >= C) return;
  if (sums != nullptr) {
    sums[c] = s;
    sums[C + c] = q;
  }
  const double rstd = stats[2 * C + c];
  dbias[c] = (float)s;
  dweight[c] = (float)(q * rstd);
  if (count <= 0.0) return;
  coef[c] = (float)(s / count);
  coef[C + c] = (float)(stats[3 * C + c] * rstd * rstd * q / count);
}

// --------------------------------------------------------------- launch
template <class Op, typename T, int V>
void pass(const Args& a, cudaStream_t stream) {
  const Plan& p = a.p;
  if (p.layout == 1) {
    rows_pass<Op, T, V><<<dim3(p.splits, p.col_tiles), kThreads, 0,
                          stream>>>(a);
  } else {
    planes_pass<Op, T, V><<<dim3(p.splits, p.channels), kThreads, 0,
                            stream>>>(a);
  }
}

template <class Op>
cudaError_t run(const Args& a, int dtype, cudaStream_t stream) {
  const bool vec = a.p.vec == kVec;
  if (dtype == 0) {
    vec ? pass<Op, float, kVec>(a, stream) : pass<Op, float, 1>(a, stream);
  } else {
    vec ? pass<Op, __nv_bfloat16, kVec>(a, stream)
        : pass<Op, __nv_bfloat16, 1>(a, stream);
  }
  return cudaGetLastError();
}

int checked(const Plan* p, int dtype, int stage) {
  if (p == nullptr || dtype < 0 || dtype > 1 || stage < 0 || stage > 2 ||
      p->channels <= 0 || p->splits <= 0 || p->chunk <= 0 ||
      (p->vec != 1 && p->vec != kVec) || (p->layout != 0 && p->layout != 1) ||
      p->tile <= 0 || p->lanes <= 0 || p->tile * p->lanes > kThreads ||
      p->col_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

int finish_blocks(int C) {
  return (C + kFinishChannels - 1) / kFinishChannels;
}

}  // namespace

// stage 0: sums, statistics, y; 1: sums only (to `sums`); 2: statistics
// from `sums` (already summed over a group, `count` elements a channel),
// then y. dtype 0 float32, 1 bfloat16. Launches on `stream`, does not
// synchronise; returns the first failed launch's cudaError_t.
extern "C" int bn_forward_launch(const Plan* plan, int dtype, int stage,
                                 const void* x, void* y, const float* weight,
                                 const float* bias, double* partials,
                                 double* sums, float* stats, double count,
                                 float eps, void* stream) {
  int err = checked(plan, dtype, stage);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = plan->channels;
  Args a{*plan, x, nullptr, y, stats, weight, bias, nullptr, partials};
  if (stage != 2) {
    if ((err = (int)run<Sums>(a, dtype, s))) return err;
    finish_forward<<<finish_blocks(C), kFinishThreads, 0, s>>>(
        partials, plan->splits, C, stage == 0 ? count : 0.0, eps,
        stage == 1 ? sums : nullptr, stats);
  } else {
    finish_forward<<<finish_blocks(C), kFinishThreads, 0, s>>>(
        sums, 1, C, count, eps, nullptr, stats);
  }
  if ((err = (int)cudaGetLastError())) return err;
  if (stage == 1) return (int)cudaSuccess;
  return (int)run<Normalize>(a, dtype, s);
}

// stage 0: gradient sums, dweight, dbias, coefficients, dx; 1: gradient
// sums only (to `sums`, with dweight and dbias from them); 2: dweight,
// dbias and the coefficients from `sums` (summed over a group), then dx.
extern "C" int bn_backward_launch(const Plan* plan, int dtype, int stage,
                                  const void* dy, const void* x, void* dx,
                                  const float* weight, const float* stats,
                                  double* partials, double* sums,
                                  float* dweight, float* dbias, float* coef,
                                  double count, void* stream) {
  int err = checked(plan, dtype, stage);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = plan->channels;
  Args a{*plan, x, dy, dx, stats, weight, nullptr, coef, partials};
  if (stage != 2) {
    if ((err = (int)run<GradSums>(a, dtype, s))) return err;
    finish_backward<<<finish_blocks(C), kFinishThreads, 0, s>>>(
        partials, plan->splits, C, stage == 0 ? count : 0.0, stats,
        stage == 1 ? sums : nullptr, dweight, dbias, coef);
  } else {
    finish_backward<<<finish_blocks(C), kFinishThreads, 0, s>>>(
        sums, 1, C, count, stats, nullptr, dweight, dbias, coef);
  }
  if ((err = (int)cudaGetLastError())) return err;
  if (stage == 1) return (int)cudaSuccess;
  return (int)run<GradInput>(a, dtype, s);
}
