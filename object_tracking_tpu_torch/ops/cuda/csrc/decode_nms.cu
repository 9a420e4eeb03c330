// Fused YOLOv2 region decode + per-class greedy NMS over the full candidate
// lattice, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_tracking_tpu/ops/pallas/decode_nms_pallas.py
// (`decode_nms_fused`, body `_kernel`): the same function, for F frames in
// one launch instead of one call per frame.
//
//   netout  (F, N, 5+C) float32, contiguous; N = GH*GW*A and candidate
//           k = (row*GW + col)*A + a, the (GH, GW, A, 5+C) head flattened
//   anchors (A, 2) float32, grid-cell units
//   boxes   (F, N, 4) float32 out: (x, y, w, h) of every candidate, dead
//           ones included
//   scores  (F, N, C) float32 out: thresholded class scores * alive
//
// Decode, in the Pallas kernel's order of operations:
//   conf = sigmoid(t4); e_j = exp(l_j - max_j l); p_j = conf * (e_j / sum);
//   the sum runs over classes in index order; score = p * (p > obj_thr);
//   x = (col + sigmoid(tx)) / GW, y = (row + sigmoid(ty)) / GH,
//   w = (aw * exp(tw)) / GW,      h = (ah * exp(th)) / GH.
// Then the walk of nms_scores.cu: every round, each class picks its best
// live, not-done candidate (argmax, first index on ties), marks it done and
// kills the not-done candidates whose IoU with it is >= nms_thr.
//
// What bounds it on this card: neither bytes nor operations. A frame at
// N=845, C=80 moves 0.57 MB (netout in, boxes and scores out) and does
// ~N^2 IoUs plus one O(N) round per kept box; the time is the latency of a
// walk whose rounds depend on each other, as for nms_scores.cu. The design
// keeps the whole frame on one SM and out of device memory between phases:
//   - one block per frame (16 warps); decode writes each candidate's box
//     corners and area, its conf, its max logit and its sum of exps to
//     shared memory (8 floats a candidate, 27 KB at N=845);
//   - the IoU >= threshold relation goes into an N x ceil(N/32)-word bitmask
//     in shared memory (91 KB at N=845), one warp ballot per 32 pairs; the
//     float IoU matrix (2.9 MB) is never stored;
//   - warps take classes round-robin; each lane rebuilds its candidates'
//     class scores from the netout row and the stored softmax statistics,
//     so the (N, C) score matrix is never staged either, then walks as
//     nms_scores.cu does: alive/done bits in registers, a round is a warp
//     argmax by shuffles and one bitmask row read.
//
// Exactness: every float operation is an explicitly rounded intrinsic or
// the CUDA math library's expf, built with -fmad=false and IEEE division,
// in the plain PyTorch twin's order (ops/cuda/decode_nms.py), so the two can
// agree bit for bit. min/max propagate NaN as torch.minimum/maximum and
// jnp.minimum/maximum do (fminf/fmaxf would drop it): a box whose exp(tw)
// overflows has w = inf, its IoU with itself is NaN, and NaN >= thr is false
// in the kernel as in the twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// torch.sigmoid's CUDA formula: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <int KW>  // 32-candidate words per frame: N <= 32 * KW
__global__ void __launch_bounds__(kWarps * 32)
decode_nms_kernel(const float* __restrict__ netout,
                  const float* __restrict__ anchors,
                  float* __restrict__ boxes, float* __restrict__ scores,
                  int GH, int GW, int A, int C, float obj_thr,
                  float nms_thr) {
  extern __shared__ float smem[];
  const int N = GH * GW * A;
  const int D = 5 + C;
  const int words = (N + 31) / 32;
  float* lox = smem;
  float* hix = lox + N;
  float* loy = hix + N;
  float* hiy = loy + N;
  float* area = hiy + N;
  float* conf = area + N;
  float* lmax = conf + N;
  float* lsum = lmax + N;
  uint32_t* mask = reinterpret_cast<uint32_t*>(lsum + N);  // (N, words)

  const size_t f = blockIdx.x;
  const float* fn = netout + f * N * D;
  float* fb = boxes + f * N * 4;
  float* fs = scores + f * N * C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // 1. Decode: one thread per candidate.
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float* r = fn + (size_t)k * D;
    const int a = k % A;
    const int cell = k / A;
    const float col = (float)(cell % GW), row = (float)(cell / GW);
    const float x = __fdiv_rn(__fadd_rn(col, sigmoid(r[0])), (float)GW);
    const float y = __fdiv_rn(__fadd_rn(row, sigmoid(r[1])), (float)GH);
    const float w = __fdiv_rn(__fmul_rn(anchors[2 * a], expf(r[2])),
                              (float)GW);
    const float h = __fdiv_rn(__fmul_rn(anchors[2 * a + 1], expf(r[3])),
                              (float)GH);
    fb[4 * k] = x;
    fb[4 * k + 1] = y;
    fb[4 * k + 2] = w;
    fb[4 * k + 3] = h;
    const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
    lox[k] = __fsub_rn(x, hw);
    hix[k] = __fadd_rn(x, hw);
    loy[k] = __fsub_rn(y, hh);
    hiy[k] = __fadd_rn(y, hh);
    area[k] = __fmul_rn(w, h);
    conf[k] = sigmoid(r[4]);
    float m = r[5];
    for (int j = 1; j < C; ++j) m = nan_max(m, r[5 + j]);
    float s = 0.0f;
    for (int j = 0; j < C; ++j) s = __fadd_rn(s, expf(__fsub_rn(r[5 + j], m)));
    lmax[k] = m;
    lsum[k] = s;
  }
  __syncthreads();

  // 2. Bit (i, j) = IoU(i, j) >= thr. Row i, word w holds columns
  //    32w..32w+31.
  for (int p = warp; p < N * words; p += nwarps) {
    const int i = p / words;
    const int j = (p - i * words) * 32 + lane;
    bool ge = false;
    if (j < N) {
      const float ox = nan_max(__fsub_rn(nan_min(hix[i], hix[j]),
                                         nan_max(lox[i], lox[j])), 0.0f);
      const float oy = nan_max(__fsub_rn(nan_min(hiy[i], hiy[j]),
                                         nan_max(loy[i], loy[j])), 0.0f);
      const float inter = __fmul_rn(ox, oy);
      const float uni = __fsub_rn(__fadd_rn(area[i], area[j]), inter);
      ge = __fdiv_rn(inter, nan_max(uni, 1e-12f)) >= nms_thr;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, ge);
    if (lane == 0) mask[p] = bits;
  }
  __syncthreads();

  // 3. One warp per class: build the class's scores, walk, write.
  for (int c = warp; c < C; c += nwarps) {
    float s[KW];
    uint32_t alive = 0, done = 0;  // bit w: candidate 32w + lane
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int k = w * 32 + lane;
      float v = 0.0f;
      if (k < N) {
        const float e = expf(__fsub_rn(fn[(size_t)k * D + 5 + c], lmax[k]));
        const float p = __fmul_rn(conf[k], __fdiv_rn(e, lsum[k]));
        v = __fmul_rn(p, p > obj_thr ? 1.0f : 0.0f);
      }
      s[w] = v;
      alive |= 1u << w;
    }
    while (true) {
      // Warp argmax over live, not-done candidates; first index on ties.
      float bv = 0.0f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const bool cand = ((alive & ~done) >> w) & 1u;
        if (cand && s[w] > bv) {
          bv = s[w];
          bi = w * 32 + lane;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (!(bv > 0.0f)) break;  // no live, not-done, positive candidate
      const uint32_t* row = mask + (size_t)bi * words;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        if (w >= words) break;
        const int k = w * 32 + lane;
        const bool hit = (row[w] >> lane) & 1u;
        if (hit && !((done >> w) & 1u) && k != bi) alive &= ~(1u << w);
      }
      if ((bi & 31) == lane) done |= 1u << (bi >> 5);
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int k = w * 32 + lane;
      if (k < N)
        fs[(size_t)k * C + c] =
            __fmul_rn(s[w], ((alive >> w) & 1u) ? 1.0f : 0.0f);
    }
  }
}

template <int KW>
cudaError_t launch(const float* netout, const float* anchors, float* boxes,
                   float* scores, int F, int GH, int GW, int A, int C,
                   float obj_thr, float nms_thr, cudaStream_t stream) {
  const size_t n = (size_t)GH * GW * A;
  const size_t smem = 8 * n * sizeof(float) +
                      n * ((n + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_nms_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_nms_kernel<KW><<<F, kWarps * 32, smem, stream>>>(
      netout, anchors, boxes, scores, GH, GW, A, C, obj_thr, nms_thr);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). N = GH*GW*A must be
// <= 1024 and C >= 1.
extern "C" int decode_nms_launch(const float* netout, const float* anchors,
                                 float* boxes, float* scores, int F, int GH,
                                 int GW, int A, int C, float obj_thr,
                                 float nms_thr, void* stream) {
  const int N = GH * GW * A;
  if (F <= 0 || N <= 0) return (int)cudaSuccess;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (N + 31) / 32;
#define DECODE_NMS_LAUNCH(KW)                                              \
  return launch<KW>(netout, anchors, boxes, scores, F, GH, GW, A, C,        \
                    obj_thr, nms_thr, s)
  if (words <= 1) DECODE_NMS_LAUNCH(1);
  if (words <= 2) DECODE_NMS_LAUNCH(2);
  if (words <= 4) DECODE_NMS_LAUNCH(4);
  if (words <= 8) DECODE_NMS_LAUNCH(8);
  if (words <= 16) DECODE_NMS_LAUNCH(16);
  if (words <= 32) DECODE_NMS_LAUNCH(32);
#undef DECODE_NMS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
