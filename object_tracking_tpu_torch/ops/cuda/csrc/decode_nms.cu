// Fused YOLOv2 region decode + per-class greedy NMS over the full candidate
// lattice, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_tracking_tpu/ops/pallas/decode_nms_pallas.py
// (`decode_nms_fused`, body `_kernel`): the same function, for F frames in
// one call instead of one call per frame.
//
//   netout  (F, N, 5+C) float32, contiguous; N = GH*GW*A and candidate
//           k = (row*GW + col)*A + a, the (GH, GW, A, 5+C) head flattened
//   anchors (A, 2) float32, grid-cell units
//   mask    (F, N, ceil(N/32)) uint32 scratch, allocated by the wrapper
//   boxes   (F, N, 4) float32 out: (x, y, w, h) of every candidate, dead
//           ones included
//   scores  (F, N, C) float32 out: thresholded class scores * alive
//
// Decode, in the Pallas kernel's order of operations:
//   conf = sigmoid(t4); e_j = exp(l_j - max_j l); p_j = conf * (e_j / sum);
//   the sum runs over classes in index order; score = p * (p > obj_thr);
//   x = (col + sigmoid(tx)) / GW, y = (row + sigmoid(ty)) / GH,
//   w = (aw * exp(tw)) / GW,      h = (ah * exp(th)) / GH.
// Then the greedy walk of nms_scores.cu over all N candidates.
//
// What bounds it on this card: neither bytes nor operations. At F=8,
// N=845, C=80 a call moves 4.6 MB (1.4 us at the HBM rate) and does the
// 5.7 M pairs of the N^2 IoU relation; the earlier design ran a frame's
// decode, its 714 k IoUs and its 80 class walks on one SM, so 8 of 132 SMs
// worked at F=8 and one at F=1. Here each pass has a grid over the card:
//   1. decode, grid (tiles of 64 candidates, F), 256 threads: the tile's
//      netout rows are one contiguous run, read with coalesced 4-byte loads
//      into shared memory (a (N, 85) frame is 287,300 B, not a multiple of
//      16, so no bulk copy is assumed). A thread per candidate builds the
//      box and the max logit, all threads take the exps, a thread per
//      candidate sums them in class order, and all threads write the
//      thresholded scores p * (p > obj_thr) straight into `scores`, with
//      neighbouring threads on neighbouring addresses;
//   2. the mask pass of nms_common.cuh on the decoded boxes;
//   3. its walk pass, in place on `scores`. Scores here are >= 0 or NaN,
//      so s * (kept or not removed) changes only the killed positive
//      entries, to 0, and a NaN stays NaN as NaN * alive does in the twin.
// The three passes count as one launch of the op (ops/cuda/decode_nms.py).
//
// Exactness: every float operation is an explicitly rounded intrinsic or
// the CUDA math library's expf, built with -fmad=false and IEEE division,
// in the plain PyTorch twin's order (ops/cuda/decode_nms.py), so the two
// agree bit for bit. min/max propagate NaN as torch.minimum/maximum and
// jnp.minimum/maximum do (fminf/fmaxf would drop it): a box whose exp(tw)
// overflows has w = inf, its IoU with itself is NaN, and NaN >= thr is false
// in the kernel as in the twin.

#include "nms_common.cuh"

namespace {

constexpr int kDecodeThreads = 256;

// torch.sigmoid's CUDA formula: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Dynamic shared memory of the decode pass: the tile's netout rows, then
// conf, max logit and sum of exps per candidate. The launcher sizes the
// pass with this; ops/cuda/decode_nms.py::decode_smem keeps a copy only to
// choose the tile.
__host__ __device__ inline size_t decode_smem(int tile, int C) {
  return 4 * ((size_t)tile * (5 + C) + 3 * (size_t)tile);
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_nms_decode(const float* __restrict__ netout,
                  const float* __restrict__ anchors,
                  float* __restrict__ boxes, float* __restrict__ scores,
                  int N, int GH, int GW, int A, int C, int tile,
                  float obj_thr) {
  extern __shared__ float dec_sm[];
  const int D = 5 + C;
  float* net = dec_sm;                       // (tile, D)
  float* conf = net + (size_t)tile * D;
  float* lmax = conf + tile;
  float* lsum = lmax + tile;
  const size_t f = blockIdx.y;
  const int k0 = blockIdx.x * tile;
  const int kn = min(tile, N - k0);
  const int t = threadIdx.x;

  const float* src = netout + (f * N + k0) * D;
  nms::copy_block(src, net, kn * D);
  __syncthreads();

  // box, conf and max logit: a thread per candidate
  for (int kk = t; kk < kn; kk += blockDim.x) {
    const float* r = net + (size_t)kk * D;
    const int k = k0 + kk;
    const int a = k % A;
    const int cell = k / A;
    const float col = (float)(cell % GW), row = (float)(cell / GW);
    float* b = boxes + (f * N + k) * 4;
    b[0] = __fdiv_rn(__fadd_rn(col, sigmoid(r[0])), (float)GW);
    b[1] = __fdiv_rn(__fadd_rn(row, sigmoid(r[1])), (float)GH);
    b[2] = __fdiv_rn(__fmul_rn(anchors[2 * a], expf(r[2])), (float)GW);
    b[3] = __fdiv_rn(__fmul_rn(anchors[2 * a + 1], expf(r[3])), (float)GH);
    conf[kk] = sigmoid(r[4]);
    float m = r[5];
    for (int j = 1; j < C; ++j) m = nms::nan_max(m, r[5 + j]);
    lmax[kk] = m;
  }
  __syncthreads();

  // exps, in place of the logits: all threads
  for (int e = t; e < kn * C; e += blockDim.x) {
    const int kk = e / C;
    float* l = net + (size_t)kk * D + 5 + (e - kk * C);
    *l = expf(__fsub_rn(*l, lmax[kk]));
  }
  __syncthreads();

  // the sum in class order: a thread per candidate
  for (int kk = t; kk < kn; kk += blockDim.x) {
    const float* ex = net + (size_t)kk * D + 5;
    float s = 0.0f;
    for (int j = 0; j < C; ++j) s = __fadd_rn(s, ex[j]);
    lsum[kk] = s;
  }
  __syncthreads();

  float* dst = scores + (f * N + k0) * C;
  for (int e = t; e < kn * C; e += blockDim.x) {
    const int kk = e / C;
    const float ex = net[(size_t)kk * D + 5 + (e - kk * C)];
    const float p = __fmul_rn(conf[kk], __fdiv_rn(ex, lsum[kk]));
    dst[e] = __fmul_rn(p, p > obj_thr ? 1.0f : 0.0f);
  }
}

__global__ void __launch_bounds__(nms::kMaskThreads)
decode_nms_mask(const float* __restrict__ boxes, uint32_t* __restrict__ mask,
                int N, int rows, float thr) {
  nms::mask_pass(boxes, mask, N, rows, thr);
}

__global__ void __launch_bounds__(nms::kMaxWalkWarps * 32)
decode_nms_walk(const float* scores_in, float* scores,
                const uint32_t* __restrict__ mask, int N, int C, int G,
                int tile_rows, int frame_mask) {
  nms::walk_pass(scores_in, scores, mask, N, C, G, tile_rows, frame_mask);
}

}  // namespace

// Returns the cudaError_t of the launches (0 = launched). The plan
// arguments come from ops/cuda/decode_nms.py::launch_plan; N = GH*GW*A
// must be <= 8192 and C >= 1.
extern "C" int decode_nms_launch(const float* netout, const float* anchors,
                                 float* boxes, float* scores, uint32_t* mask,
                                 int F, int GH, int GW, int A, int C,
                                 float obj_thr, float nms_thr,
                                 int decode_tile, int mask_rows,
                                 int walk_classes, int tile_rows,
                                 int frame_mask, void* stream) {
  const int N = GH * GW * A;
  if (F <= 0 || N <= 0) return (int)cudaSuccess;
  if (C <= 0 || N > nms::kMaxN || decode_tile <= 0 ||
      decode_smem(decode_tile, C) > nms::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const size_t decode_bytes = decode_smem(decode_tile, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = nms::set_smem(decode_nms_decode, decode_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + decode_tile - 1) / decode_tile, F);
  decode_nms_decode<<<grid, kDecodeThreads, decode_bytes, s>>>(
      netout, anchors, boxes, scores, N, GH, GW, A, C, decode_tile, obj_thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)nms::launch_nms(decode_nms_mask, decode_nms_walk, boxes,
                              scores, scores, mask, F, N, C, nms_thr,
                              mask_rows, walk_classes, tile_rows, frame_mask,
                              s);
}
