// Batched per-class greedy NMS over fixed candidate sets, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_tracking_tpu/ops/pallas/nms_pallas.py
// (`nms_scores_pallas`, body `_nms_kernel`): the same function, for F frames
// in one launch instead of one call per frame under vmap.
//
//   boxes  (F, K, 4) float32, center format (cx, cy, w, h), contiguous
//   scores (F, K, C) float32, thresholded class scores (0 = dead), contiguous
//   out    (F, K, C) float32 = scores * alive
//
// For each frame and class the walk is the Pallas one: every round picks the
// live, not-yet-done candidate with the highest score (argmax, first index
// on ties), marks it done, and kills every not-done candidate whose IoU with
// it is >= threshold. A class stops when it has no live, not-done, positive
// candidate left. Classes never interact, so each class walks on its own.
//
// What bounds it on this card: neither bytes nor operations. A frame moves
// K*(4+2C)*4 bytes (20 KB at K=128, C=12) and does ~K^2 IoUs plus one O(K)
// round per kept box, far below the card's rates; the time is the latency of
// a walk whose rounds depend on each other. The design keeps every round
// inside one warp and out of device memory:
//   - one block per frame; the frame's boxes live in shared memory;
//   - the IoU >= threshold relation is computed once per frame into a K x K
//     bitmask in shared memory (2 KB at K=128), one warp ballot per 32 pairs;
//     the walk only ever compares IoU with the threshold;
//   - one warp per class (warps take classes round-robin when C exceeds the
//     block's warps); lane l owns candidates l, l+32, ...; alive and done are
//     bits in the lane's registers; a round is one warp argmax by shuffles
//     and one bitmask row read, with no block-wide barrier.
//
// Exactness: the IoU is the Pallas formula, inter / max(union, 1e-12), with
// union = (area_i + area_j) - inter, in explicitly rounded operations
// (__fmul_rn and friends) and built with -fmad=false, so no product is
// contracted into an FMA and the division is IEEE-rounded. The kernel then
// equals the plain PyTorch version (ops/cuda/nms.py) bit for bit. Scores must
// be finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;

template <int KW>  // 32-candidate words per frame: K <= 32 * KW
__global__ void __launch_bounds__(kMaxWarps * 32)
nms_scores_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  float* __restrict__ out, int K, int C, float thr) {
  extern __shared__ float smem[];
  float* lox = smem;
  float* hix = lox + K;
  float* loy = hix + K;
  float* hiy = loy + K;
  float* area = hiy + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(area + K);  // (K, KW) words

  const size_t f = blockIdx.x;
  const float* fb = boxes + f * K * 4;
  const float* fs = scores + f * K * C;
  float* fo = out + f * K * C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float cx = fb[4 * k], cy = fb[4 * k + 1];
    const float w = fb[4 * k + 2], h = fb[4 * k + 3];
    const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
    lox[k] = __fsub_rn(cx, hw);
    hix[k] = __fadd_rn(cx, hw);
    loy[k] = __fsub_rn(cy, hh);
    hiy[k] = __fadd_rn(cy, hh);
    area[k] = __fmul_rn(w, h);
  }
  __syncthreads();

  // Bit (i, j) = IoU(i, j) >= thr. Row i, word w holds columns 32w..32w+31.
  for (int p = warp; p < K * KW; p += nwarps) {
    const int i = p / KW;
    const int j = (p % KW) * 32 + lane;
    bool ge = false;
    if (j < K) {
      const float ox = fmaxf(__fsub_rn(fminf(hix[i], hix[j]),
                                       fmaxf(lox[i], lox[j])), 0.0f);
      const float oy = fmaxf(__fsub_rn(fminf(hiy[i], hiy[j]),
                                       fmaxf(loy[i], loy[j])), 0.0f);
      const float inter = __fmul_rn(ox, oy);
      const float uni = __fsub_rn(__fadd_rn(area[i], area[j]), inter);
      ge = __fdiv_rn(inter, fmaxf(uni, 1e-12f)) >= thr;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, ge);
    if (lane == 0) mask[p] = bits;
  }
  __syncthreads();

  for (int c = warp; c < C; c += nwarps) {
    float s[KW];
    uint32_t alive = 0, done = 0;  // bit w: candidate 32w + lane
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int k = w * 32 + lane;
      s[w] = k < K ? fs[(size_t)k * C + c] : 0.0f;
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
      const uint32_t* row = mask + (size_t)bi * KW;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const int k = w * 32 + lane;
        const bool hit = (row[w] >> lane) & 1u;
        if (hit && !((done >> w) & 1u) && k != bi) alive &= ~(1u << w);
      }
      if ((bi & 31) == lane) done |= 1u << (bi >> 5);
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int k = w * 32 + lane;
      if (k < K)
        fo[(size_t)k * C + c] =
            __fmul_rn(s[w], ((alive >> w) & 1u) ? 1.0f : 0.0f);
    }
  }
}

template <int KW>
cudaError_t launch(const float* boxes, const float* scores, float* out,
                   int F, int K, int C, float thr, cudaStream_t stream) {
  const size_t smem = 5 * (size_t)K * sizeof(float) +
                      (size_t)K * KW * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_scores_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int warps = C < 4 ? 4 : C;
  if (warps > kMaxWarps) warps = kMaxWarps;
  nms_scores_kernel<KW><<<F, warps * 32, smem, stream>>>(boxes, scores, out,
                                                         K, C, thr);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). K must be <= 1024.
extern "C" int nms_scores_launch(const float* boxes, const float* scores,
                                 float* out, int F, int K, int C, float thr,
                                 void* stream) {
  if (F <= 0 || K <= 0 || C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + 31) / 32;
  if (words <= 1) return launch<1>(boxes, scores, out, F, K, C, thr, s);
  if (words <= 2) return launch<2>(boxes, scores, out, F, K, C, thr, s);
  if (words <= 4) return launch<4>(boxes, scores, out, F, K, C, thr, s);
  if (words <= 8) return launch<8>(boxes, scores, out, F, K, C, thr, s);
  if (words <= 16) return launch<16>(boxes, scores, out, F, K, C, thr, s);
  if (words <= 32) return launch<32>(boxes, scores, out, F, K, C, thr, s);
  return (int)cudaErrorInvalidValue;
}
