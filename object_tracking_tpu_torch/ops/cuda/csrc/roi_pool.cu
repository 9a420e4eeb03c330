// RoI max pooling (Caffe's ROIPoolingLayer forward) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no two-stage detector. The
// port's Faster R-CNN (models/faster_rcnn.py) pools each image's RoIs
// from its conv5_3 map into a fixed grid before the fc6/fc7 head; eager
// PyTorch has no such op, so it is written here.
//
//   map   (B, H, W, C) float32: the features in channels_last order
//   rois  (B, R, 4) float32 corners (x1, y1, x2, y2) in image pixels; RoI
//         r of image b pools from image b's map
//   out   (B, R, C, PH, PW) float32, the (C, PH, PW) order that fc6 reads
//
// Per RoI, as Caffe computes it in float: start = round(x1 * s) and end =
// round(x2 * s) with C's round (roundf: half away from zero); width =
// max(end - start + 1, 1); bin p spans [floor(p * bw), ceil((p + 1) * bw))
// with bw = (float)width / PW, offset by the start and clipped to the map;
// the max over the bin, 0 where the bin is empty. Coordinates are clamped
// to +-1e6 before the round (a NaN to -1e6), so no conversion overflows.
// The max propagates a NaN (the plain twin's amax does), and starts at
// -inf (Caffe's at -FLT_MAX).
//
// What bounds it on this card: bytes. At B=8, R=300, C=512, 7x7 the
// output is 240.8 MB, written once; the 37 MB map is read once from HBM
// and stays in the 50 MB L2, where each RoI reads its own window of it
// again. The design:
//   - a block per (RoI, 64 channels): 256 threads, four groups of 64, a
//     thread on one channel of every fourth bin, so that each warp's load
//     of one map cell is 32 neighbouring channels, 128 contiguous bytes;
//   - the block's 64 x 49 maxima staged in shared memory at an odd row
//     stride (49: no bank conflicts), then written out as one contiguous
//     run of 64 * 49 floats: every store coalesced, where writing the
//     (C, PH, PW) layout straight from the bins would scatter at a stride
//     of 49 floats.
// Built with -fmad=false (ops/cuda/_build.py); nothing here rounds twice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block
constexpr int kChannels = 64;   // channels a block
constexpr int kMaxBins = 64;    // PH * PW a launch may ask for
constexpr float kClamp = 1e6f;  // coordinates clamped to +-kClamp

__device__ __forceinline__ int c_round(float v) {
  return (int)roundf(fminf(fmaxf(v, -kClamp), kClamp));
}

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const float* __restrict__ map, const float* __restrict__ rois,
                float* __restrict__ out, int R, int H, int W, int C, int PH,
                int PW, float scale) {
  __shared__ float tile[kChannels * kMaxBins];
  const int roi = blockIdx.x;                  // b * R + r
  const int b = roi / R;
  const int c0 = blockIdx.y * kChannels;
  const int cn = min(kChannels, C - c0);
  const int bins = PH * PW;

  const float* box = rois + (size_t)roi * 4;
  const int x1 = c_round(__fmul_rn(box[0], scale));
  const int y1 = c_round(__fmul_rn(box[1], scale));
  const int x2 = c_round(__fmul_rn(box[2], scale));
  const int y2 = c_round(__fmul_rn(box[3], scale));
  const float bw = __fdiv_rn((float)max(x2 - x1 + 1, 1), (float)PW);
  const float bh = __fdiv_rn((float)max(y2 - y1 + 1, 1), (float)PH);

  const int lane = threadIdx.x % kChannels;
  const int group = threadIdx.x / kChannels;
  const float* plane = map + (size_t)b * H * W * C + c0 + lane;
  for (int bin = group; bin < bins; bin += kThreads / kChannels) {
    const int ph = bin / PW, pw = bin - (bin / PW) * PW;
    const int hs = min(max((int)floorf(__fmul_rn((float)ph, bh)) + y1, 0), H);
    const int he =
        min(max((int)ceilf(__fmul_rn((float)(ph + 1), bh)) + y1, 0), H);
    const int ws = min(max((int)floorf(__fmul_rn((float)pw, bw)) + x1, 0), W);
    const int we =
        min(max((int)ceilf(__fmul_rn((float)(pw + 1), bw)) + x1, 0), W);
    float m = (he <= hs || we <= ws) ? 0.0f : -INFINITY;
    if (lane < cn) {
      for (int h = hs; h < he; ++h) {
        const float* row = plane + (size_t)h * W * C;
#pragma unroll 4
        for (int w = ws; w < we; ++w) m = nan_max(m, row[(size_t)w * C]);
      }
    }
    tile[lane * bins + bin] = m;
  }
  __syncthreads();
  float* dst = out + ((size_t)roi * C + c0) * bins;
  for (int i = threadIdx.x; i < cn * bins; i += kThreads) dst[i] = tile[i];
}

}  // namespace

// rois (B, R, 4) over map (B, H, W, C) into out (B, R, C, PH, PW); PH * PW
// <= 64. Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t (0 = launched).
extern "C" int roi_pool_launch(const float* map, const float* rois,
                               float* out, int B, int R, int H, int W, int C,
                               int PH, int PW, float scale, void* stream) {
  if (B < 0 || R < 0 || H <= 0 || W <= 0 || C <= 0 || PH <= 0 || PW <= 0 ||
      PH * PW > kMaxBins)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  const dim3 grid(B * R, (C + kChannels - 1) / kChannels);
  roi_pool_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map, rois, out, R, H, W, C, PH, PW, scale);
  return (int)cudaGetLastError();
}
