// Batched per-class greedy NMS over fixed candidate sets, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_tracking_tpu/ops/pallas/nms_pallas.py
// (`nms_scores_pallas`, body `_nms_kernel`): the same function, for F frames
// in one call instead of one call per frame under vmap.
//
//   boxes  (F, K, 4) float32, center format (cx, cy, w, h), contiguous
//   scores (F, K, C) float32, thresholded class scores, contiguous
//   mask   (F, K, ceil(K/32)) uint32 scratch, allocated by the wrapper
//   out    (F, K, C) float32 = scores * alive
//
// What bounds it on this card: neither bytes nor operations. At F=32,
// K=128, C=12 a call moves 0.46 MB and does ~7 M float operations, well
// under a microsecond of the card's rates; the time is the latency of each
// (frame, class) walk, ~38 kept boxes one after another, plus the launches.
// The design of nms_common.cuh answers that:
//   - the IoU >= thr bitmask is built by its own pass over (row tile,
//     frame) blocks, so all SMs share the K^2 pairs instead of one block
//     per frame;
//   - each (frame, class) walk is one warp, F*C warps over F*ceil(C/G)
//     blocks, and the walk is a sorted scan: one warp sort of the class's
//     live candidates, then one bit test and one shared-memory row OR per
//     candidate, where the earlier design took a warp argmax (a loop over
//     the lane's candidates and five dependent shuffle pairs) per kept box;
//   - the scores are read and written through a shared-memory tile, with
//     neighbouring threads on neighbouring addresses, not with stride C.
// Both passes count as one launch of the op (ops/cuda/nms.py).
//
// Exactness: equal to the plain PyTorch version (ops/cuda/nms.py,
// `nms_scores_plain`) bit for bit; see nms_common.cuh.

#include "nms_common.cuh"

namespace {

__global__ void __launch_bounds__(nms::kMaskThreads)
nms_scores_mask(const float* __restrict__ boxes, uint32_t* __restrict__ mask,
                int K, int rows, float thr) {
  nms::mask_pass(boxes, mask, K, rows, thr);
}

__global__ void __launch_bounds__(nms::kMaxWalkWarps * 32)
nms_scores_walk(const float* scores, float* out,
                const uint32_t* __restrict__ mask, int K, int C, int G,
                int tile_rows, int frame_mask) {
  nms::walk_pass(scores, out, mask, K, C, G, tile_rows, frame_mask);
}

}  // namespace

// Returns the cudaError_t of the launches (0 = launched). The plan
// arguments come from ops/cuda/nms.py::launch_plan; K must be <= 8192.
extern "C" int nms_scores_launch(const float* boxes, const float* scores,
                                 float* out, uint32_t* mask, int F, int K,
                                 int C, float thr, int mask_rows,
                                 int walk_classes, int tile_rows,
                                 int frame_mask, void* stream) {
  if (F <= 0 || K <= 0 || C <= 0) return (int)cudaSuccess;
  return (int)nms::launch_nms(nms_scores_mask, nms_scores_walk, boxes,
                              scores, out, mask, F, K, C, thr, mask_rows,
                              walk_classes, tile_rows, frame_mask,
                              static_cast<cudaStream_t>(stream));
}
