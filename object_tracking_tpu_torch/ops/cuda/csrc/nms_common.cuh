// The shared design of the port's two greedy-NMS kernels, for Hopper
// (sm_90a): nms_scores.cu (per-class NMS over fixed candidate sets) and
// decode_nms.cu (YOLOv2 decode + the same NMS over the full lattice).
//
// Both compute, for each frame f and class c, the walk of the TPU kernels
// (object_tracking_tpu/ops/pallas/nms_pallas.py, decode_nms_pallas.py):
// every round picks the live, not-done candidate with the highest score
// (first index on ties), marks it done and kills the not-done candidates
// whose IoU with it is >= thr; out = s * alive. Here that walk runs in two
// passes, each over a grid that spreads the work over the card:
//
//   mask pass, grid (row tiles, F): bit (i, j) of an F x N x ceil(N/32)-word
//     bitmask in device memory is IoU(i, j) >= thr (730 KB at F=8, N=845;
//     it stays in the 50 MB L2). A block stages its frame's box corners in
//     shared memory; a warp decides 32 pairs at once and ballots them into
//     one word. The Pallas kernels gather one IoU row per pick with a
//     one-hot product on the MXU (jnp.dot(onehot.T, iou)); on Hopper that
//     is an indexed read of one bitmask row, and no tensor core is needed:
//     the work is comparisons and a bit scan, not products.
//
//   walk pass, grid F x ceil(C/G), one warp per (frame, class):
//     1. compact the class's positive scores (ballot and popc) into 64-bit
//        keys (score bits << 32 | ~index) in shared memory, staging the
//        block's (rows, G classes) score tile with coalesced loads;
//     2. sort the keys in the warp, score descending, index ascending: by
//        rank (each lane counts the keys above its own) up to 128 keys,
//        by a bitonic network above;
//     3. scan them in that order, 32 at a time: a ballot of the `removed`
//        bits gives the chunk's live candidates, one a lane; their mask
//        rows are staged in shared memory with independent loads; each
//        lane gathers which earlier live lanes' rows hold its candidate
//        (a 32-bit `killers` word in a register); then the lowest live
//        lane is kept and kills the lanes whose `killers` name it, one
//        ballot a kept candidate and no memory access. The kept rows are
//        then ORed into `removed`. A removed candidate costs no step;
//     4. out = s * (kept or not removed), written through the tile.
//
// Why the sorted scan is the Pallas walk: the argmax among live, not-done
// candidates is always the next unremoved one in sorted order; a pick
// kills the not-done candidates of its row, which are the removed-to-be
// ones, and `kept` protects the done ones; the IoU is symmetric. So the
// kept set and every output value match, zero and negative scores (never
// picked, killed as s * 0) and ties (first index) included. A class whose
// scores hold a NaN never picks (the walk's max is NaN, not > 0), so it
// keeps every score, as the plain twin does.
//
// Latency, not bandwidth, is what each block waits on, so every copy
// between device and shared memory issues up to 16 independent loads a
// thread before it stores any (kBatch).
//
// The cap: `removed`, `kept` and the keys live in shared memory, sized for
// N, so one warp takes any N up to kMaxN = 8192: Faster R-CNN's proposal
// NMS takes 6,000 candidates a frame (models/faster_rcnn.py). At 8192 the
// mask pass holds 160 KB of box corners and one class's walk 98 KB (keys
// 64 KB); the bitmask is 8 MB a frame, in device memory. Above 128 keys
// the sort is a bitonic network, ~91 rounds of the warp at 8192.
//
// Exactness: the IoU is the Pallas formula inter / max(union, 1e-12) in
// explicitly rounded operations, built with -fmad=false, with min/max that
// propagate NaN as torch.minimum/maximum do, so each bit is exactly the
// plain twin's `pallas_iou(boxes) >= thr`. The mask pass divides only
// where the answer is in doubt (iou_ge below).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

constexpr int kMaxN = 8192;          // candidates per frame
constexpr int kMaskThreads = 256;    // mask pass: 8 warps a block
constexpr int kMaxWalkWarps = 8;     // walk pass: at most 8 classes a block
constexpr size_t kMaxSmem = 232448;  // 227 KB, what a block may opt into
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 16;           // loads in flight per thread

__host__ __device__ inline int words(int n) { return (n + 31) / 32; }

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory of each pass, as the passes lay it out; launch_nms
// sizes every launch with these. ops/cuda/nms.py::walk_smem and mask_plan
// keep a copy only to choose the plan: a plan they misjudge is refused at
// launch, never run short (tests/test_torch_nms_scan.py checks that the
// constants above equal the Python ones).
__host__ __device__ inline size_t mask_smem(int n) {
  return 5 * (size_t)n * sizeof(float);
}

__host__ __device__ inline size_t walk_smem(int n, int g, int tile_rows,
                                            int frame_mask) {
  const size_t w = words(n);
  return 8 * (size_t)g * pow2_at_least(n)      // sort keys
         + 4 * (size_t)g * (34 * w + 32)       // 32 staged rows, removed,
                                               // kept, 32 row indices
         + 4 * (size_t)tile_rows * (g | 1)     // score tile, odd row stride
         + (frame_mask ? 4 * (size_t)n * w : 0);  // the frame's whole mask
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// fl(inter / d) >= thr, exactly, with d = max(union, 1e-12) > 0 or NaN and
// inter >= 0 or NaN. Away from the threshold the product t = fl(thr * d)
// decides: inter >= fl(t * (1 + 2^-21)) implies inter > thr * d, so the
// quotient is > thr; inter <= fl(t * (1 - 2^-21)) implies inter < thr * d *
// (1 - 2^-22), below the least real that rounds to thr. The products'
// roundings (2^-24 each while t is a normal float) fit inside the 2^-21
// margin. It divides only in between, or where t is below 1e-30 or not
// finite or inter is not finite (tests/test_torch_nms_scan.py checks the
// rule against float32 division).
__device__ __forceinline__ bool iou_ge(float inter, float uni, float thr) {
  const float d = nan_max(uni, 1e-12f);
  const float t = __fmul_rn(thr, d);
  if (t >= 1e-30f && t <= 3.0e38f && inter <= 3.0e38f) {
    if (inter >= __fmul_rn(t, 1.0f + 0x1p-21f)) return true;
    if (inter <= __fmul_rn(t, 1.0f - 0x1p-21f)) return false;
  }
  return __fdiv_rn(inter, d) >= thr;
}

// ------------------------------------------------------------- mask pass
// boxes (F, N, 4) center format; mask (F, N, words(N)): bit j % 32 of word
// j / 32 of row i is IoU(i, j) >= thr. Grid (ceil(N / rows), F), 256
// threads, mask_smem(N) bytes.
__device__ __forceinline__ void mask_pass(const float* __restrict__ boxes,
                                          uint32_t* __restrict__ mask, int N,
                                          int rows, float thr) {
  extern __shared__ float mask_sm[];
  float* lox = mask_sm;
  float* hix = lox + N;
  float* loy = hix + N;
  float* hiy = loy + N;
  float* area = hiy + N;
  const int W = words(N);
  const size_t f = blockIdx.y;
  const float* fb = boxes + f * N * 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  constexpr int kBoxes = kBatch / 4;
  for (int k0 = threadIdx.x; k0 < N; k0 += kBoxes * blockDim.x) {
    float b[kBoxes][4];
#pragma unroll
    for (int q = 0; q < kBoxes; ++q) {
      const int k = k0 + q * blockDim.x;
      if (k < N) {
#pragma unroll
        for (int c = 0; c < 4; ++c) b[q][c] = fb[4 * k + c];
      }
    }
#pragma unroll
    for (int q = 0; q < kBoxes; ++q) {
      const int k = k0 + q * blockDim.x;
      if (k < N) {
        const float hw = __fmul_rn(b[q][2], 0.5f);
        const float hh = __fmul_rn(b[q][3], 0.5f);
        lox[k] = __fsub_rn(b[q][0], hw);
        hix[k] = __fadd_rn(b[q][0], hw);
        loy[k] = __fsub_rn(b[q][1], hh);
        hiy[k] = __fadd_rn(b[q][1], hh);
        area[k] = __fmul_rn(b[q][2], b[q][3]);
      }
    }
  }
  __syncthreads();

  uint32_t* fm = mask + f * N * W;
  const int r1 = min((int)(blockIdx.x + 1) * rows, N);
  for (int i = blockIdx.x * rows + warp; i < r1; i += nwarps) {
    const float ilox = lox[i], ihix = hix[i], iloy = loy[i], ihiy = hiy[i];
    const float iarea = area[i];
    for (int w0 = 0; w0 < W; w0 += 32) {
      // lane u keeps word w0 + u; the 32 words go out in one store
      const int nw = min(32, W - w0);
      uint32_t mine = 0;
      for (int u = 0; u < nw; ++u) {
        const int j = (w0 + u) * 32 + lane;
        bool ge = false;
        if (j < N) {
          const float ox = nan_max(
              __fsub_rn(nan_min(ihix, hix[j]), nan_max(ilox, lox[j])), 0.0f);
          const float oy = nan_max(
              __fsub_rn(nan_min(ihiy, hiy[j]), nan_max(iloy, loy[j])), 0.0f);
          const float inter = __fmul_rn(ox, oy);
          ge = iou_ge(inter, __fsub_rn(__fadd_rn(iarea, area[j]), inter),
                      thr);
        }
        const uint32_t bits = __ballot_sync(kFull, ge);
        if (lane == u) mine = bits;
      }
      if (lane < nw) fm[(size_t)i * W + w0 + lane] = mine;
    }
  }
}

// ------------------------------------------------------------- walk pass
__device__ __forceinline__ unsigned long long make_key(float s, int k) {
  return ((unsigned long long)__float_as_uint(s) << 32) |
         (uint32_t)~(uint32_t)k;
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)~(uint32_t)key;
}

__device__ __forceinline__ bool bit(const uint32_t* words, int k) {
  return (words[k >> 5] >> (k & 31)) & 1u;
}

// Sort keys[0, n) descending, n a power of two, by one warp: a bitonic
// network, for more than 128 keys.
__device__ __forceinline__ void bitonic_desc(unsigned long long* keys, int n,
                                             int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        const unsigned long long hi = a > b ? a : b, lo = a > b ? b : a;
        const bool desc = (i & size) == 0;
        keys[i] = desc ? hi : lo;
        keys[j] = desc ? lo : hi;
      }
      __syncwarp();
    }
  }
}

// Sort keys[0, count) descending, count <= 32 * E, by one warp: each lane
// ranks its E keys against all of them (keys are distinct) and writes each
// to its rank. count * E steps a lane, no barrier between them.
template <int E>
__device__ __forceinline__ void rank_desc(unsigned long long* keys,
                                          int count, int lane) {
  unsigned long long mine[E];
  int rank[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mine[e] = lane + 32 * e < count ? keys[lane + 32 * e] : 0ull;
    rank[e] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const unsigned long long k = keys[j];
#pragma unroll
    for (int e = 0; e < E; ++e) rank[e] += k > mine[e];
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < count) keys[rank[e]] = mine[e];
  __syncwarp();
}

// Sort keys[0, count) descending (score descending, index ascending).
__device__ __forceinline__ void sort_desc(unsigned long long* keys,
                                          int count, int lane) {
  if (count <= 32) return rank_desc<1>(keys, count, lane);
  if (count <= 64) return rank_desc<2>(keys, count, lane);
  if (count <= 128) return rank_desc<4>(keys, count, lane);
  const int n2 = pow2_at_least(count);     // zero keys pad to the end
  for (int t = count + lane; t < n2; t += 32) keys[t] = 0;
  __syncwarp();
  bitonic_desc(keys, n2, lane);
}

// dst[0, n) = src[0, n) by the block, kBatch loads in flight a thread.
__device__ __forceinline__ void copy_block(const float* __restrict__ src,
                                           float* dst, int n) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (e0 + q * (int)blockDim.x < n) v[q] = src[e0 + q * blockDim.x];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (e0 + q * (int)blockDim.x < n) dst[e0 + q * blockDim.x] = v[q];
  }
}

// tile[kk * ts + g] = src[(r0 + kk) * C + g] for kk < rn, g < gn: the
// block's classes of rows r0..r0+rn, thread t on class t % gn of every
// (blockDim / gn)-th row, so neighbouring threads read neighbouring
// addresses, kBatch loads in flight a thread. With nm > 0 the block also
// copies mdst[0, nm) = msrc[0, nm), nm <= kBatch * blockDim, in the same
// round trip.
__device__ __forceinline__ void load_tile(const float* src, float* tile,
                                          int r0, int rn, int gn, int C,
                                          int ts, const uint32_t* msrc,
                                          uint32_t* mdst, int nm) {
  uint32_t mv[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q)
    if (threadIdx.x + q * blockDim.x < nm)
      mv[q] = msrc[threadIdx.x + q * blockDim.x];
  const int per = blockDim.x / gn;
  const int g = threadIdx.x % gn;
  const int k0 = threadIdx.x / gn < per ? threadIdx.x / gn : rn;
  for (int kb = k0; kb < rn; kb += kBatch * per) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (kb + q * per < rn) v[q] = src[(size_t)(r0 + kb + q * per) * C + g];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (kb + q * per < rn) tile[(kb + q * per) * ts + g] = v[q];
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q)
    if (threadIdx.x + q * blockDim.x < nm)
      mdst[threadIdx.x + q * blockDim.x] = mv[q];
}

__device__ __forceinline__ void store_tile(float* dst, const float* tile,
                                           int r0, int rn, int gn, int C,
                                           int ts) {
  const int per = blockDim.x / gn;
  const int g = threadIdx.x % gn;
  if (threadIdx.x / gn < per)
    for (int kk = threadIdx.x / gn; kk < rn; kk += per)
      dst[(size_t)(r0 + kk) * C + g] = tile[kk * ts + g];
}

// in, out (F, N, C) scores (out may be in: the walk then updates in
// place); mask from mask_pass. Grid F * ceil(C / G), G * 32 threads,
// walk_smem(N, G, tile_rows, frame_mask) bytes. With frame_mask, the
// block copies its frame's whole mask into shared memory with the first
// score tile, in the same round trip, and the scan reads rows there; else
// each chunk stages the rows it needs.
__device__ __forceinline__ void walk_pass(const float* in, float* out,
                                          const uint32_t* __restrict__ mask,
                                          int N, int C, int G, int tile_rows,
                                          int frame_mask) {
  extern __shared__ unsigned long long walk_sm[];
  const int W = words(N);
  const int cap = pow2_at_least(N);
  const int ts = G | 1;                 // odd stride: no bank conflicts
  const int groups = (C + G - 1) / G;
  const size_t f = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * G;
  const int gn = min(G, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = warp < gn;        // warp-uniform
  const uint32_t below = (1u << lane) - 1u;

  unsigned long long* keys = walk_sm + (size_t)warp * cap;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(walk_sm + (size_t)G * cap);
  uint32_t* rows = wsm + (size_t)warp * 32 * W;
  uint32_t* removed = wsm + (size_t)G * 32 * W + (size_t)warp * W;
  uint32_t* kept = wsm + (size_t)G * 33 * W + (size_t)warp * W;
  int* cand = reinterpret_cast<int*>(wsm + (size_t)G * 34 * W) + warp * 32;
  float* tile = reinterpret_cast<float*>(wsm + (size_t)G * (34 * W + 32));
  uint32_t* mask_sm = reinterpret_cast<uint32_t*>(tile + tile_rows * ts);
  const float* fin = in + f * N * C + c0;
  float* fout = out + f * N * C + c0;
  const uint32_t* fmask = mask + f * N * W;

  // 1. Compact the positive scores, in index order.
  int count = 0;
  bool has_nan = false;
  for (int r0 = 0; r0 < N; r0 += tile_rows) {
    const int rn = min(tile_rows, N - r0);
    __syncthreads();
    load_tile(fin, tile, r0, rn, gn, C, ts, fmask, mask_sm,
              r0 == 0 && frame_mask ? N * W : 0);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int kk0 = 0; kk0 < rn; kk0 += 32) {
        const int kk = kk0 + lane;
        const float v = kk < rn ? tile[kk * ts + warp] : 0.0f;
        has_nan |= v != v;
        const bool pos = v > 0.0f;
        const uint32_t bal = __ballot_sync(kFull, pos);
        if (pos) keys[count + __popc(bal & below)] = make_key(v, r0 + kk);
        count += __popc(bal);
      }
    }
  }

  if (active) {
    for (int w = lane; w < W; w += 32) {
      removed[w] = 0;
      kept[w] = 0;
    }
    // a NaN score makes the class's max NaN: the walk never picks
    if (!__any_sync(kFull, has_nan) && count > 0) {
      // 2. Sort: score descending, index ascending.
      sort_desc(keys, count, lane);
      // 3. Scan in that order, a chunk of 32 candidates at a time.
      for (int t0 = 0; t0 < count; t0 += 32) {
        int i = 0;
        bool mine = false;
        if (t0 + lane < count) {
          i = key_index(keys[t0 + lane]);
          mine = !bit(removed, i);
        }
        const uint32_t live0 = __ballot_sync(kFull, mine);
        if (live0 == 0) continue;
        if (mine) cand[__popc(live0 & below)] = i;
        __syncwarp();
        // from here lane s holds the s-th live candidate (its slot)
        const int nl = __popc(live0);
        i = lane < nl ? cand[lane] : 0;
        // stage the slots' mask rows: rows[s * W + w], lane l on the
        // words e = l + 32q, (s, w) stepped without a division
        const int total = frame_mask ? 0 : nl * W;
        const int ds = 32 / W, dw = 32 - ds * W;
        int s = lane / W, w = lane - s * W;
        for (int e0 = lane; e0 < total; e0 += kBatch * 32) {
          uint32_t v[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            if (e0 + q * 32 < total) v[q] = fmask[(size_t)cand[s] * W + w];
            s += ds;
            w += dw;
            if (w >= W) {
              w -= W;
              ++s;
            }
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q)
            if (e0 + q * 32 < total) rows[e0 + q * 32] = v[q];
        }
        __syncwarp();
        // killers: bit t = the row of an earlier slot t holds candidate i
        // (loads and selects, no branch: the loads overlap)
        const uint32_t* base = frame_mask ? mask_sm : rows;
        const uint32_t ibit = 1u << (i & 31);
        uint32_t killers = 0;
#pragma unroll 8
        for (int t = 0; t < nl; ++t) {
          const int row = frame_mask ? cand[t] : t;
          const uint32_t word = base[row * W + (i >> 5)];
          killers |= (uint32_t)((word & ibit) != 0 && t < lane) << t;
        }
        if (lane >= nl) killers = 0;
        // the lowest live slot is kept and kills the slots it covers
        uint32_t live = nl == 32 ? kFull : (1u << nl) - 1u, keep = 0;
        while (live) {
          const int s = __ffs(live) - 1;
          keep |= 1u << s;
          live &= ~(__ballot_sync(kFull, (killers >> s) & 1u) | (1u << s));
        }
        if ((keep >> lane) & 1u) atomicOr(&kept[i >> 5], ibit);
        for (int w = lane; w < W; w += 32) {
          uint32_t r = removed[w];
#pragma unroll 8
          for (int t = 0; t < nl; ++t) {
            const int row = frame_mask ? cand[t] : t;
            r |= base[row * W + w] & (0u - ((keep >> t) & 1u));
          }
          removed[w] = r;
        }
        __syncwarp();
      }
    }
  }

  // 4. out = s * (kept or not removed), through the tile; a frame that
  //    fits one tile still has its scores there from step 1.
  for (int r0 = 0; r0 < N; r0 += tile_rows) {
    const int rn = min(tile_rows, N - r0);
    __syncthreads();
    if (N > tile_rows) {
      load_tile(fin, tile, r0, rn, gn, C, ts, nullptr, nullptr, 0);
      __syncthreads();
    }
    if (active) {
#pragma unroll 4
      for (int kk = lane; kk < rn; kk += 32) {
        const int k = r0 + kk;
        const bool keep = ((kept[k >> 5] | ~removed[k >> 5]) >> (k & 31)) & 1u;
        tile[kk * ts + warp] = __fmul_rn(tile[kk * ts + warp],
                                         keep ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
    store_tile(fout, tile, r0, rn, gn, C, ts);
  }
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch both passes of the NMS on F frames. The plan's choices (mask rows,
// walk classes, tile rows, frame_mask) come from the wrapper's launch plan;
// each pass's shared memory is sized here, from the layout above, and a
// plan that does not fit is refused.
template <typename MaskKernel, typename WalkKernel>
cudaError_t launch_nms(MaskKernel mask_kernel, WalkKernel walk_kernel,
                       const float* boxes, const float* in, float* out,
                       uint32_t* mask, int F, int N, int C, float thr,
                       int mask_rows, int walk_classes, int tile_rows,
                       int frame_mask, cudaStream_t stream) {
  if (N > kMaxN || mask_rows <= 0 || walk_classes <= 0 ||
      walk_classes > kMaxWalkWarps || tile_rows <= 0 ||
      (frame_mask && N * words(N) > kBatch * 32 * walk_classes))
    return cudaErrorInvalidValue;
  const size_t mask_bytes = mask_smem(N);
  const size_t walk_bytes = walk_smem(N, walk_classes, tile_rows, frame_mask);
  if (mask_bytes > kMaxSmem || walk_bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(mask_kernel, mask_bytes);
  if (err != cudaSuccess) return err;
  err = set_smem(walk_kernel, walk_bytes);
  if (err != cudaSuccess) return err;
  const dim3 mask_grid((N + mask_rows - 1) / mask_rows, F);
  mask_kernel<<<mask_grid, kMaskThreads, mask_bytes, stream>>>(
      boxes, mask, N, mask_rows, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int groups = (C + walk_classes - 1) / walk_classes;
  walk_kernel<<<F * groups, walk_classes * 32, walk_bytes, stream>>>(
      in, out, mask, N, C, walk_classes, tile_rows, frame_mask);
  return cudaGetLastError();
}

}  // namespace nms
