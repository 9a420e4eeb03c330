// Class-aware, motion-aware greedy identity assignment for B clips over T
// frames in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves
// object_tracking_tpu/ops/matching.py::assign_tracks to XLA, which fuses
// it under jax.jit inside a lax.scan over the frames. Run eagerly, the
// same function is ~1,000 small PyTorch launches a frame (the greedy
// loop's argmax, gather and where steps, then the slot book-keeping), so a
// predict call at B=8, T=4 spent ~4,000 launches and ~85 ms of host time
// on a few microseconds of device work. This kernel does the whole window.
//
//   table in   boxes (B, S, 4) f32, vel (B, S, 2) f32, labels, ids, age
//              (B, S) i32, active (B, S) bool, next_id (B,) i32
//   detections boxes (B, T, M, 4) f32 centre format, labels (B, T, M) i32,
//              valid (B, T, M) bool
//   out        the table after frame T-1 (same shapes), det_ids (B, T, M)
//              i32 (-1: invalid, or no free slot), matches (B,) i32 (the
//              matched detections over the T frames)
//
// What bounds it on this card: latency. At B=8, T=4, S=64, M=128 a call
// reads and writes ~0.1 MB and does ~3 M float operations, well under a
// microsecond of the card's rates. The time is a dependent chain: T frames
// one after another, each a greedy match whose every pick depends on the
// picks before it. The design answers that:
//   - one block per clip keeps the clip's table in shared memory across
//     all T frames, so nothing goes back to device memory between frames;
//   - per frame, every thread of the block computes its share of the S x M
//     IoUs against the motion-predicted boxes, with the class and validity
//     mask; the pairs at or above the gate are compacted (a warp ballot, one
//     shared atomic a warp) and sorted block-wide;
//   - one warp scans the sorted pairs 32 at a time: each lane holds one
//     pair, __match_any_sync finds the earlier lanes sharing its row or
//     column, and one ballot per accepted pair settles the chunk;
//   - the slot book-keeping (ageing, retiring, coasting, free-slot
//     allocation in index order, fresh ids) is two block prefix sums and a
//     scatter, each element on its own thread.
//
// The greedy order: the plain loop takes the global argmax of the IoU
// matrix (first flat index i * M + j on ties) while it clears the gate,
// then retires its row and column. That equals one scan over the pairs
// with IoU >= gate, sorted by (IoU descending, flat index ascending), that
// accepts a pair when its row and column are both still free. For a gate
// in (0, 1] every such IoU is a positive float, whose bits order as
// integers, so the 64-bit key ((0x7fffffff - bits) << 32) | (i << 16) | j
// sorts the pairs in one ascending pass (i < 2^16 and j < 2^16 keep the
// flat order). A NaN IoU among the masked pairs is the plain loop's argmax
// at every step and never clears the gate: that frame matches nothing.
//
// Exactness: the IoU is ops/boxes.py::iou_center's float32 operations in
// its order (xy -/+ wh / 2, clamp-min overlap, inter / (union + 1e-10)),
// the velocity EMA is smooth * inst + (1 - smooth) * prev, all explicitly
// rounded and built with -fmad=false, so every output equals the plain
// twin (ops/matching.py::assign_tracks_plain) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 1024;      // S
constexpr int kMaxDets = 4096;       // M
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, what a block may opt into
constexpr int kRankKeys = 4;         // rank sort up to 4 keys a thread
constexpr int kMisc = 64;            // ints of scan and frame scalars
constexpr unsigned kFull = 0xffffffffu;

// misc[] slots beyond the 32 warp sums
constexpr int kCount = 32, kNan = 33, kMatched = 34, kNextId = 35,
              kTotal = 36;

struct Args {
  const float* boxes;
  const float* vel;
  const int* labels;
  const int* ids;
  const int* age;
  const bool* active;
  const int* next_id;
  const float* det_boxes;
  const int* det_labels;
  const bool* det_valid;
  float* out_boxes;
  float* out_vel;
  int* out_labels;
  int* out_ids;
  int* out_age;
  bool* out_active;
  int* out_next_id;
  int* det_ids;
  int* matches;
  unsigned long long* scratch;  // (B, key_cap) keys, unless in shared memory
  int S, M, T, max_age, key_cap, keys_in_smem;
  float gate, smooth, keep;     // keep = 1 - smooth, rounded to float32
};

constexpr int kPointers = 20;   // the pointer fields above, in order

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory of a block, as the kernel lays it out:
// keys (8 B each, when in shared memory), 11 floats and 7 ints a slot,
// 5 floats and 4 ints a detection, kMisc ints.
__host__ __device__ inline size_t smem_bytes(int S, int M,
                                             int keys_in_smem) {
  return (keys_in_smem ? 8 * (size_t)pow2_at_least(S * (M > 0 ? M : 1))
                       : 0) +
         4 * (18 * (size_t)S + 9 * (size_t)M + kMisc);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// In place, a[k] = the sum of a[0, k) for k < n (a holds 0/1 flags);
// returns the sum of all. Every thread of the block calls it; thread t
// walks one contiguous run of about n / blockDim elements.
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int per = (n + nt - 1) / nt;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int mine = 0;
  for (int k = lo; k < hi; ++k) mine += a[k];
  int x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_sums[warp - 1] : 0) + x - mine;
  const int total = warp_sums[nw - 1];
  for (int k = lo; k < hi; ++k) {
    const int f = a[k];
    a[k] = run;
    run += f;
  }
  __syncthreads();
  return total;
}

// Sort keys[0, n) ascending with the whole block (keys are distinct):
// up to kRankKeys a thread by rank (each key counts the keys below it, all
// threads reading the same key at once), beyond that a bitonic network
// over the next power of two, padded with ~0 (key_cap holds it).
__device__ void block_sort(unsigned long long* keys, int n) {
  const int nt = blockDim.x, tid = threadIdx.x;
  if (n <= 1) return;
  if (n <= kRankKeys * nt) {
    unsigned long long mine[kRankKeys];
    int rank[kRankKeys];
#pragma unroll
    for (int e = 0; e < kRankKeys; ++e) {
      const int k = tid + e * nt;
      mine[e] = k < n ? keys[k] : ~0ull;
      rank[e] = 0;
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const unsigned long long key = keys[j];
#pragma unroll
      for (int e = 0; e < kRankKeys; ++e) rank[e] += key < mine[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kRankKeys; ++e)
      if (tid + e * nt < n) keys[rank[e]] = mine[e];
    __syncthreads();
    return;
  }
  const int n2 = pow2_at_least(n);
  for (int k = n + tid; k < n2; k += nt) keys[k] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (n2 >> 1); t += nt) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
assign_tracks_kernel(const Args g) {
  extern __shared__ unsigned long long sm[];
  const int S = g.S, M = g.M, nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const size_t b = blockIdx.x;

  unsigned long long* keys =
      g.keys_in_smem ? sm : g.scratch + b * (size_t)g.key_cap;
  float* f = reinterpret_cast<float*>(
      g.keys_in_smem ? sm + g.key_cap : sm);
  float* tb = f;             // (S, 4) the table's boxes
  float* tv = tb + 4 * S;    // (S, 2) velocities
  float* plx = tv + 2 * S;   // predicted boxes' corners and areas
  float* phx = plx + S;
  float* ply = phx + S;
  float* phy = ply + S;
  float* par = phy + S;
  float* dlx = par + S;      // detections' corners and areas
  float* dhx = dlx + M;
  float* dly = dhx + M;
  float* dhy = dly + M;
  float* dar = dhy + M;
  int* tl = reinterpret_cast<int*>(dar + M);   // (S,) labels
  int* ti = tl + S;          // ids
  int* ta = ti + S;          // age
  int* tact = ta + S;        // active
  int* hit = tact + S;       // matched this frame
  int* slot_rank = hit + S;  // free flags, then the free slots' ranks
  int* free_at = slot_rank + S;  // the free slots in ascending order
  int* dl = free_at + S;     // (M,) labels
  int* dv = dl + M;          // valid
  int* match = dv + M;       // the matched slot, or -1
  int* drank = match + M;    // new-detection flags, then their ranks
  int* misc = drank + M;     // warp sums [0, 32), then the scalars

  for (int s = tid; s < S; s += nt) {
    const size_t o = b * S + s;
#pragma unroll
    for (int c = 0; c < 4; ++c) tb[4 * s + c] = g.boxes[4 * o + c];
    tv[2 * s] = g.vel[2 * o];
    tv[2 * s + 1] = g.vel[2 * o + 1];
    tl[s] = g.labels[o];
    ti[s] = g.ids[o];
    ta[s] = g.age[o];
    tact[s] = g.active[o];
  }
  if (tid == 0) {
    misc[kNextId] = g.next_id[b];
    misc[kTotal] = 0;
  }

  const float4* det_boxes = reinterpret_cast<const float4*>(g.det_boxes);
  const int pairs = S * M;
  const int di = M > 0 ? nt / M : 0, dj = nt - di * M;
  for (int t = 0; t < g.T; ++t) {
    const size_t frame = (b * g.T + t) * (size_t)M;
    __syncthreads();
    // 1. The frame's detections and the tracks' predicted boxes.
    for (int j = tid; j < M; j += nt) {
      const float4 d = det_boxes[frame + j];
      const float hw = __fdiv_rn(d.z, 2.0f), hh = __fdiv_rn(d.w, 2.0f);
      dlx[j] = __fsub_rn(d.x, hw);
      dhx[j] = __fadd_rn(d.x, hw);
      dly[j] = __fsub_rn(d.y, hh);
      dhy[j] = __fadd_rn(d.y, hh);
      dar[j] = __fmul_rn(d.z, d.w);
      dl[j] = g.det_labels[frame + j];
      dv[j] = g.det_valid[frame + j];
      match[j] = -1;
    }
    for (int s = tid; s < S; s += nt) {
      const float px = __fadd_rn(tb[4 * s], tv[2 * s]);
      const float py = __fadd_rn(tb[4 * s + 1], tv[2 * s + 1]);
      const float w = tb[4 * s + 2], h = tb[4 * s + 3];
      const float hw = __fdiv_rn(w, 2.0f), hh = __fdiv_rn(h, 2.0f);
      plx[s] = __fsub_rn(px, hw);
      phx[s] = __fadd_rn(px, hw);
      ply[s] = __fsub_rn(py, hh);
      phy[s] = __fadd_rn(py, hh);
      par[s] = __fmul_rn(w, h);
      hit[s] = 0;
    }
    if (tid == 0) {
      misc[kCount] = 0;
      misc[kNan] = 0;
    }
    __syncthreads();

    // 2. The masked IoU of every (slot i, detection j) pair; the pairs at
    //    or above the gate become keys. Every thread runs the same number
    //    of rounds, so the ballots see the whole warp.
    int i = M > 0 ? tid / M : 0, j = tid - i * M;
    for (int p0 = 0; p0 < pairs; p0 += nt) {
      bool cand = false;
      unsigned long long key = 0;
      if (p0 + tid < pairs && tact[i] && dv[j] && tl[i] == dl[j]) {
        const float ox = nan_max(
            __fsub_rn(nan_min(phx[i], dhx[j]), nan_max(plx[i], dlx[j])),
            0.0f);
        const float oy = nan_max(
            __fsub_rn(nan_min(phy[i], dhy[j]), nan_max(ply[i], dly[j])),
            0.0f);
        const float inter = __fmul_rn(ox, oy);
        const float uni = __fsub_rn(__fadd_rn(par[i], dar[j]), inter);
        const float iou = __fdiv_rn(inter, __fadd_rn(uni, 1e-10f));
        if (iou != iou) misc[kNan] = 1;
        cand = iou >= g.gate;
        key = ((unsigned long long)(0x7fffffffu - __float_as_uint(iou))
               << 32) | ((uint32_t)i << 16) | (uint32_t)j;
      }
      const uint32_t bal = __ballot_sync(kFull, cand);
      if (bal) {
        const int leader = __ffs(bal) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&misc[kCount], __popc(bal));
        base = __shfl_sync(kFull, base, leader);
        if (cand) keys[base + __popc(bal & below)] = key;
      }
      i += di;
      j += dj;
      if (j >= M) {
        j -= M;
        ++i;
      }
    }
    __syncthreads();

    // 3. Sort the keys: IoU descending, flat index ascending.
    const int n = misc[kNan] ? 0 : misc[kCount];
    block_sort(keys, n);

    // 4. One warp scans them, 32 at a time.
    if (warp == 0) {
      int matched = 0;
      for (int t0 = 0; t0 < n; t0 += 32) {
        int r = 0x10000 + lane, c = 0x20000 + lane;  // no pair: no conflict
        bool live = false;
        if (t0 + lane < n) {
          const unsigned long long k = keys[t0 + lane];
          r = (int)((k >> 16) & 0xffffu);
          c = (int)(k & 0xffffu);
          live = !hit[r] && match[c] < 0;
        }
        uint32_t rest = __ballot_sync(kFull, live);
        // the earlier lanes whose pair shares this lane's row or column
        const uint32_t conflicts =
            (__match_any_sync(kFull, r) | __match_any_sync(kFull, c)) & below;
        uint32_t accepted = 0;
        while (rest) {
          const int u = __ffs(rest) - 1;
          accepted |= 1u << u;
          rest &= ~(__ballot_sync(kFull, (conflicts >> u) & 1u) | (1u << u));
        }
        if ((accepted >> lane) & 1u) {
          hit[r] = 1;
          match[c] = r;
        }
        matched += __popc(accepted);
        __syncwarp();
      }
      if (lane == 0) misc[kMatched] = matched;
    }
    __syncthreads();

    // 5. Age every slot, retire the stale ones, coast the unmatched live
    //    ones along their velocity; flag the free slots and the new
    //    (valid, unmatched) detections.
    for (int s = tid; s < S; s += nt) {
      const bool h = hit[s];
      const int a = h ? 0 : ta[s] + 1;
      const bool was = tact[s];
      const bool act = was && a <= g.max_age;
      if (was && !h) {
        tb[4 * s] = __fadd_rn(tb[4 * s], tv[2 * s]);
        tb[4 * s + 1] = __fadd_rn(tb[4 * s + 1], tv[2 * s + 1]);
      }
      ta[s] = a;
      tact[s] = act;
      slot_rank[s] = !act;
    }
    for (int j2 = tid; j2 < M; j2 += nt) drank[j2] = dv[j2] && match[j2] < 0;
    __syncthreads();
    const int n_free = block_exclusive_scan(slot_rank, S, misc);
    for (int s = tid; s < S; s += nt)
      if (!tact[s]) free_at[slot_rank[s]] = s;
    const int n_new = block_exclusive_scan(drank, M, misc);

    // 6. Matched detections update their slot; new ones take the free
    //    slots in order with fresh ids while slots last.
    const int next_id = misc[kNextId];
    for (int j2 = tid; j2 < M; j2 += nt) {
      const int s = match[j2];
      int id = -1, slot = -1;
      float vx = 0.0f, vy = 0.0f;
      const float4 d = det_boxes[frame + j2];
      if (s >= 0) {
        slot = s;
        id = ti[s];
        const float ix = __fsub_rn(d.x, tb[4 * s]);
        const float iy = __fsub_rn(d.y, tb[4 * s + 1]);
        const float px = tv[2 * s], py = tv[2 * s + 1];
        if (px == 0.0f && py == 0.0f) {
          vx = ix;
          vy = iy;
        } else {
          vx = __fadd_rn(__fmul_rn(g.smooth, ix), __fmul_rn(g.keep, px));
          vy = __fadd_rn(__fmul_rn(g.smooth, iy), __fmul_rn(g.keep, py));
        }
      } else if (dv[j2] && drank[j2] < n_free) {
        slot = free_at[drank[j2]];
        id = next_id + drank[j2];
      }
      if (slot >= 0) {
        tb[4 * slot] = d.x;
        tb[4 * slot + 1] = d.y;
        tb[4 * slot + 2] = d.z;
        tb[4 * slot + 3] = d.w;
        tv[2 * slot] = vx;
        tv[2 * slot + 1] = vy;
        tl[slot] = dl[j2];
        ti[slot] = id;
        ta[slot] = 0;
        tact[slot] = 1;
      }
      g.det_ids[frame + j2] = id;
    }
    __syncthreads();
    if (tid == 0) {
      misc[kNextId] = next_id + min(n_new, n_free);
      misc[kTotal] += misc[kMatched];
    }
  }
  __syncthreads();

  for (int s = tid; s < S; s += nt) {
    const size_t o = b * S + s;
#pragma unroll
    for (int c = 0; c < 4; ++c) g.out_boxes[4 * o + c] = tb[4 * s + c];
    g.out_vel[2 * o] = tv[2 * s];
    g.out_vel[2 * o + 1] = tv[2 * s + 1];
    g.out_labels[o] = tl[s];
    g.out_ids[o] = ti[s];
    g.out_age[o] = ta[s];
    g.out_active[o] = tact[s] != 0;
  }
  if (tid == 0) {
    g.out_next_id[b] = misc[kNextId];
    g.matches[b] = misc[kTotal];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). `ptrs` holds the
// kPointers pointers of Args in order; `threads` and `keys_in_smem` come
// from ops/cuda/assign.py::launch_plan, which this refuses where they do
// not fit: S <= 1024, M <= 4096, threads a power of two in [128, 1024].
extern "C" int assign_tracks_launch(void* const* ptrs, int B, int S, int M,
                                    int T, int max_age, float gate,
                                    float smooth, float keep, int threads,
                                    int keys_in_smem, void* stream) {
  if (S <= 0 || S > kMaxSlots || M < 0 || M > kMaxDets || T < 0 ||
      threads < 128 || threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const size_t bytes = smem_bytes(S, M, keys_in_smem);
  if (bytes > kMaxSmem || (!keys_in_smem && ptrs[19] == nullptr))
    return (int)cudaErrorInvalidValue;
  Args g;
  const void** slots[kPointers] = {
      (const void**)&g.boxes, (const void**)&g.vel,
      (const void**)&g.labels, (const void**)&g.ids, (const void**)&g.age,
      (const void**)&g.active, (const void**)&g.next_id,
      (const void**)&g.det_boxes, (const void**)&g.det_labels,
      (const void**)&g.det_valid, (const void**)&g.out_boxes,
      (const void**)&g.out_vel, (const void**)&g.out_labels,
      (const void**)&g.out_ids, (const void**)&g.out_age,
      (const void**)&g.out_active, (const void**)&g.out_next_id,
      (const void**)&g.det_ids, (const void**)&g.matches,
      (const void**)&g.scratch};
  for (int k = 0; k < kPointers; ++k) *slots[k] = ptrs[k];
  g.S = S;
  g.M = M;
  g.T = T;
  g.max_age = max_age;
  g.key_cap = pow2_at_least(S * (M > 0 ? M : 1));
  g.keys_in_smem = keys_in_smem;
  g.gate = gate;
  g.smooth = smooth;
  g.keep = keep;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_tracks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  assign_tracks_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(
                                                 stream)>>>(g);
  return (int)cudaGetLastError();
}
