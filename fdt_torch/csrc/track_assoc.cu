// The IoU tracker's greedy association over a chunk of frames, in one
// launch (K3).
//
// Replaces fdt's _associate_chunk (fdt/track/device_tracker.py:93-194), a
// lax.scan over the frames of a chunk with a fori_loop over the live slots
// that XLA compiles (not a Pallas kernel).  Its plain PyTorch version is
// fdt_torch/geometry/track.py::associate_chunk_plain, the CPU path and the
// oracle this kernel is held to, bit for bit.
//
// Why a kernel.  The walk's trip count, the live slots of each frame, is
// data: fdt's fori_loop reads it on the device and the host reads the
// records once a chunk.  Eager PyTorch can bound that loop only by reading
// the live count and visit order on the host every frame, and each slot
// visit is then some 20 small launches.  Here one launch runs the chunk with
// no host read.
//
// What bounds it.  Not bytes (the chunk's inputs and records are tens of
// KB) nor operations (F x live slots x N affinities of ~20 flops), but the
// chain of dependent slot steps: each visit's match consumes a detection the
// next visit may not take.  The design rests on one fact: within a frame the
// only state one slot step hands the next is the set of consumed
// detections.  A slot's affinity row depends only on its last box from
// before the frame and on the frame's detections, and its update is read by
// no later step of the frame.  So, per frame:
//   A (all warps) compact the live slots by ballots, rank them by (order,
//     slot) (the stable argsort of fdt's where(alive, order, DEAD)), and
//     compute every affinity of the frame as a 32-bit key (below) into a
//     tile of shared memory, R rows at a time;
//   B (warp 0, the only serial part) walk the rows in visit order: a lane
//     owns detections j = lane*K .. lane*K + K-1 (K = 1 for N <= 32) and
//     keeps their consumed flags in one register; a step masks its row's
//     keys, takes the warp's maximum by redux.sync, the lowest lane holding
//     it by a ballot and that lane's lowest k, and writes (best j or -1/-2)
//     for the slot to shared memory.  Nothing on the chain touches device
//     memory, and the next row's keys are loaded before this step resolves.
//     With more than one tile, warps 1.. compute tile k+1 while warp 0
//     walks tile k;
//   C (all warps) apply the matches, finishes and drops slot by slot, take
//     the free slots lowest id first and the spawns in detection order by
//     block-wide ballot prefixes, and write the frame's records.
// The slot state (29 B a slot) and the lists (12 B a slot) stay in dynamic
// shared memory for the whole chunk; the next frame's boxes and scores
// arrive by cp.async while this frame runs (double buffer), and its valid
// flags by plain loads held in registers until it begins.  Shapes whose
// state does not fit, or N > 1024 (32 flags a lane), take the device-memory
// variant below, the one-warp kernel of the first port; fdt_track_associate
// picks the variant by size (plan_rows) and reports which it launched.
//
// The key.  A step needs argmax's (argmin's) order: NaN first, then the
// greater (lesser) value, then the lower index.  A float maps to an unsigned
// key that orders alike: -0.0 becomes +0.0 first (torch ties them), every
// NaN becomes 0xffffffff, a value's bits are flipped into unsigned order,
// and for argmin every non-NaN key is inverted.  Non-NaN keys lie in
// [0x007fffff, 0xff800000], so 0 marks a consumed or padded detection and
// "some detection left" is "the maximum is not 0".  A match is
// key > key(threshold) and not NaN, which is value > sigma_iou (value <
// sigma_dis) in float32.  The lowest j among equal keys is the lowest lane,
// then that lane's lowest k, since lanes own contiguous ranges.
//
// Arithmetic: the plain version's operations in its order, in float32, with
// IEEE division and powf (what torch's pow with exponent 0.25 computes on
// the card); min and max propagate NaN as torch.minimum/maximum do; built
// with -fmad=false, so nothing is contracted into an FMA.
//
// Records after a frame that overflowed (more new detections than free
// slots) are thrown away by the host, which grows T and runs the chunk again
// from the pre-chunk state, as fdt does; the kernel carries on.
//
// C interface (loaded with ctypes): fdt_track_associate launches one of the
// variants and returns a CUDA error code (that of the launch, or
// cudaGetLastError() after it); it launches on the given stream, does not
// synchronise and allocates nothing.  fdt_track_rows gives the rows a tile
// it takes at (t, n) on the current device (0: the device-memory variant),
// fdt_track_smem_bytes the shared memory of the shared-memory variant at
// (t, n, rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cmath>

#include "nms_overlap.cuh"

namespace {

constexpr int kDeadOrder = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNanKey = 0xffffffffu;
// The shared-memory variant: 8 warps (faster than 4 at every timed shape,
// PERF.md §6); a lane's consumed flags are one 32-bit register, so N <= 32 x
// 32; a tile of affinities holds at least kMinRows rows (or T); a thread
// stages kValidPerThread of a frame's valid bytes.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 32 * 32;
constexpr int kMinRows = 8;
constexpr int kValidPerThread = kMaxN / kThreads;
static_assert(kMaxN % kThreads == 0, "a thread stages a whole number of valid bytes");

// Intersection and union of box d and the slot's last box r (_iou_row).
struct Overlap {
  float inter, uni;
};

__device__ __forceinline__ Overlap overlap(const float4 d, const float4 r) {
  const float w = max_nan(__fsub_rn(min_nan(d.z, r.z), max_nan(d.x, r.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(d.w, r.w), max_nan(d.y, r.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float a = __fmul_rn(__fsub_rn(d.z, d.x), __fsub_rn(d.w, d.y));
  const float b = __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
  return {inter, __fsub_rn(__fadd_rn(a, b), inter)};
}

// IoU of box d against the slot's last box r.
__device__ __forceinline__ float iou(const float4 d, const float4 r) {
  const Overlap o = overlap(d, r);
  return __fdiv_rn(o.inter, o.uni);
}

// Center+size pseudo-distance of box d to the last box r (_distance_row);
// halving is exact, as torch's multiply by 0.5 for / 2.
__device__ __forceinline__ float distance(const float4 d, const float4 r) {
  const float dx = __fsub_rn(__fmul_rn(__fadd_rn(r.z, r.x), 0.5f),
                             __fmul_rn(__fadd_rn(d.z, d.x), 0.5f));
  const float dy = __fsub_rn(__fmul_rn(__fadd_rn(r.w, r.y), 0.5f),
                             __fmul_rn(__fadd_rn(d.w, d.y), 0.5f));
  const float sx = __fsub_rn(__fsub_rn(d.z, d.x), __fsub_rn(r.z, r.x));
  const float sy = __fsub_rn(__fsub_rn(d.w, d.y), __fsub_rn(r.w, r.y));
  const float dz = __fmul_rn(__fadd_rn(sx, sy), 0.5f);
  const float dis = __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dx, dx)), __fmul_rn(dy, dy));
  return powf(dis, 0.25f);
}

// argmax's key of v (see the top of the file); argmin's with descending false
__device__ __forceinline__ uint32_t order_key(float v, bool descending) {
  if (v != v) return kNanKey;
  const uint32_t u = v == 0.0f ? 0u : __float_as_uint(v);  // -0.0 ties +0.0
  const uint32_t k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return descending ? k : ~k;
}

// argmax's key of iou(d, r).  Where the intersection is 0 (most pairs) the
// quotient is +-0, or NaN over a union of 0 or NaN, and both zeros have one
// key, so the division runs only where boxes overlap.
__device__ __forceinline__ uint32_t iou_key(const float4 d, const float4 r) {
  const Overlap o = overlap(d, r);
  if (o.inter == 0.0f) return o.uni == 0.0f || o.uni != o.uni ? kNanKey : order_key(0.0f, true);
  return order_key(__fdiv_rn(o.inter, o.uni), true);
}

// ---------------------------------------------------------------------------
// The shared-memory variant.

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t{15}; }

// Detections a lane owns (a power of two, 32 K >= n).
__host__ __device__ inline int lane_dets(int n) {
  int k = 1;
  while (32 * k < n) k *= 2;
  return k;
}

struct Shared {
  float4* last_box;   // [T] slot state
  float* max_score;   // [T]
  int* length;        // [T]
  int* order;         // [T]
  int* live;          // [T] live slot ids in slot order, later the free ids
  int* visit;         // [T] live slot ids in visit order
  int* res;           // [T] by slot: the walk's result (first the ranking's keys)
  uint8_t* alive;     // [T]
  float4* boxes[2];   // [32 K] a frame's boxes, box j at position pos(j)
  float* scores[2];   // [N]
  uint8_t* valid;     // [N] the frame's valid flags, stored when it begins
  uint32_t* rem;      // [32] a lane's unconsumed valid detections after the walk
  int* tot;           // [2][32] per-warp counts of the block prefixes
  uint32_t* tile[2];  // [R][32 K] keys of R rows in visit order
};

// Hands out 16-byte aligned arrays from base (nullptr: only counts bytes).
struct Carver {
  unsigned char* base;
  size_t off;
  template <class T>
  __host__ __device__ T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += align16(count * sizeof(T));
    return p;
  }
};

// The T-sized part of the layout (slot state and lists) from base; returns
// its bytes.
__host__ __device__ inline size_t carve_state(unsigned char* base, int t, Shared* s) {
  Carver c{base, 0};
  s->last_box = c.take<float4>(t);
  s->max_score = c.take<float>(t);
  s->length = c.take<int>(t);
  s->order = c.take<int>(t);
  s->live = c.take<int>(t);
  s->visit = c.take<int>(t);
  s->res = c.take<int>(t);
  s->alive = c.take<uint8_t>(t);
  return c.off;
}

// The frame's part (detections, counts, tiles of `rows` rows) from base;
// returns its bytes.
__host__ __device__ inline size_t carve_frame(unsigned char* base, int n, int rows, Shared* s) {
  const size_t k = lane_dets(n);
  Carver c{base, 0};
  for (int b = 0; b < 2; ++b) {
    s->boxes[b] = c.take<float4>(32 * k);
    s->scores[b] = c.take<float>(n);
  }
  s->valid = c.take<uint8_t>(n);
  s->rem = c.take<uint32_t>(32);
  s->tot = c.take<int>(2 * 32);
  for (int b = 0; b < 2; ++b) s->tile[b] = c.take<uint32_t>(32 * k * rows);
  return c.off;
}

// The whole layout in one block of shared memory; returns its bytes.
__host__ __device__ inline size_t carve(unsigned char* base, int t, int n, int rows, Shared* s) {
  const size_t state = carve_state(base, t, s);
  return state + carve_frame(base ? base + state : nullptr, n, rows, s);
}

// Buffer b of a pair (a select, so that the Shared struct stays in
// registers; an index by a variable would put it on the stack)
template <class T>
__device__ __forceinline__ T* pick(T* const (&pair)[2], int b) {
  return b ? pair[1] : pair[0];
}

// Position of detection j in a row of keys and in the box buffer: lane
// j / K's k-th word, k = j % K, so that a warp reads a row's words at 32
// consecutive addresses.
template <int K>
__device__ __forceinline__ int pos(int j) {
  return (j % K) * 32 + j / K;
}

struct Args {
  const float4* in_last_box;
  const float* in_max_score;
  const int* in_length;
  const int* in_order;
  const uint8_t* in_alive;
  const int* in_next_key;
  const float4* boxes;
  const float* scores;
  const uint8_t* valid;
  float4* last_box;
  float* max_score;
  int* length;
  int* order;
  uint8_t* alive;
  int* next_key;
  int* assign;
  uint8_t* finish;
  int* spawn;
  int* overflow;
  int t, f, n, rows;
  float sigma_iou, sigma_dis, sigma_h;
  int t_min, use_iou;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue frame fr's copies into buffer b: boxes (16 B, permuted to pos(j))
// and scores (4 B) by cp.async.  Its valid bytes j = tid + kThreads q come
// back by plain loads, byte q of the result, for store_valid when the frame
// begins.
template <int K>
__device__ uint32_t stage(const Shared& s, int b, int fr, const Args& a, int tid) {
  const int n = a.n;
  const size_t base = static_cast<size_t>(fr) * n;
  float4* boxes = pick(s.boxes, b);
  float* scores = pick(s.scores, b);
  for (int j = tid; j < n; j += kThreads) {
    cp_async16(boxes + pos<K>(j), a.boxes + base + j);
    cp_async4(scores + j, a.scores + base + j);
  }
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < kValidPerThread; ++q) {
    const int j = tid + q * kThreads;
    if (j < n) v |= static_cast<uint32_t>(__ldg(a.valid + base + j)) << (8 * q);
  }
  return v;
}

// Stores the valid bytes that stage returned into shared memory.
__device__ __forceinline__ void store_valid(const Shared& s, uint32_t v, int n, int tid) {
#pragma unroll
  for (int q = 0; q < kValidPerThread; ++q) {
    const int j = tid + q * kThreads;
    if (j < n) s.valid[j] = static_cast<uint8_t>(v >> (8 * q));
  }
}

// Keys of rows [r0, r0 + nrows) in visit order into tile, by threads
// tid0, tid0 + nthr, ...  A thread loads kGroup keys' boxes before it
// computes any, so that their latency chains overlap.
template <int K>
__device__ void affinities(const Shared& s, int b, uint32_t* tile, int r0, int nrows, int n,
                           bool use_iou, int tid0, int nthr) {
  constexpr int kStride = 32 * K, kGroup = 4;
  const float4* boxes = pick(s.boxes, b);
  const int total = nrows * kStride;
  for (int e0 = tid0; e0 < total; e0 += kGroup * nthr) {
    float4 ref[kGroup], d[kGroup];
    bool ok[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int e = min(e0 + g * nthr, total - 1);  // in bounds; ok says if it counts
      const int p = e % kStride;
      ok[g] = e0 + g * nthr < total && (p & 31) * K + p / 32 < n;
      ref[g] = s.last_box[s.visit[r0 + e / kStride]];
      d[g] = boxes[p];
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const uint32_t key = use_iou ? iou_key(d[g], ref[g])
                                   : order_key(distance(d[g], ref[g]), false);
      if (e0 + g * nthr < total) tile[e0 + g * nthr] = ok[g] ? key : 0u;
    }
  }
}


template <int K>
__device__ __forceinline__ void load_row(const uint32_t* row, uint32_t (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = row[32 * k];
}

// Maximum of x[O .. O+W) and the bits k (of that range) where x[k] == top:
// balanced trees with indices known at compile time, so the arrays stay in
// registers (a loop nest over the levels leaves them on the stack at K >= 16).
template <int W, int O = 0, int K>
__device__ __forceinline__ uint32_t tree_max(const uint32_t (&x)[K]) {
  if constexpr (W == 1) {
    return x[O];
  } else {
    return max(tree_max<W / 2, O>(x), tree_max<W / 2, O + W / 2>(x));
  }
}

template <int W, int O = 0, int K>
__device__ __forceinline__ uint32_t tree_eq(const uint32_t (&x)[K], uint32_t top) {
  if constexpr (W == 1) {
    return x[O] == top ? 1u << O : 0u;
  } else {
    return tree_eq<W / 2, O>(x, top) | tree_eq<W / 2, O + W / 2>(x, top);
  }
}

// Phase B: walk rows [r0, r1) of tile (rows r0.. of the frame) in warp 0.
// rem: this lane's unconsumed valid detections (bit k = detection lane*K+k);
// returns it after the walk.  Writes res[slot] = the matched detection, or
// -1 (no match, detections were left) or -2 (none was left: the silent
// drop).  Reads and writes shared memory only, and every lane runs every
// instruction of a step (no branch on the chain).
template <int K>
__device__ uint32_t walk(const uint32_t* tile, const int* visit, int* res, int r0, int r1,
                         uint32_t rem, uint32_t thr, int lane) {
  if (r0 >= r1) return rem;
  uint32_t v[K];
  load_row<K>(tile + lane, v);
  int next = visit[r0];
  for (int i = r0; i < r1; ++i) {
    const int s = next;
    uint32_t x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = v[k] & (0u - ((rem >> k) & 1u));
    if (i + 1 < r1) {  // the next row does not depend on this step
      load_row<K>(tile + (i + 1 - r0) * 32 * K + lane, v);
      next = visit[i + 1];
    }
    const uint32_t best = tree_max<K>(x);
    const uint32_t top = __reduce_max_sync(kFull, best);
    const int wl = __ffs(__ballot_sync(kFull, best == top)) - 1;
    const int wk = __ffs(tree_eq<K>(x, top)) - 1;  // this lane's first k holding top
    // thr < top < the NaN key, as one unsigned compare
    const bool matched = top - thr - 1u < kNanKey - thr - 1u;
    const bool mine = lane == wl;
    rem &= ~(matched && mine ? 1u << wk : 0u);
    if (mine) res[s] = matched ? wl * K + wk : (top != 0u ? -1 : -2);
  }
  return rem;
}

// A lane's valid detections of the frame as its rem bits.
template <int K>
__device__ __forceinline__ uint32_t valid_bits(const Shared& s, int n, int lane) {
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane * K + k;
    if (j < n && s.valid[j]) bits |= 1u << k;
  }
  return bits;
}

template <int K>
__device__ __forceinline__ bool unconsumed(const Shared& s, int j) {
  return (s.rem[j / K] >> (j % K)) & 1u;
}

// This warp's run of 32-element groups of an extent of x elements.
__device__ __forceinline__ void warp_groups(int x, int warp, int* g0, int* g1) {
  const int groups = (x + 31) / 32;
  const int per = (groups + kWarps - 1) / kWarps;
  *g0 = min(groups, warp * per);
  *g1 = min(groups, *g0 + per);
}

// The warps' counts tot[0 .. kWarps): this warp's base and the total.
__device__ __forceinline__ int prefix(const int* tot, int warp, int* total) {
  int base = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = tot[w];
    base += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return base;
}

#ifdef FDT_K3_TRACE
// Cycles by phase, summed over the frames of every launch since the last
// read (profile_nms.py builds a copy with FDT_K3_TRACE to read them):
// 0 stage and wait, 1 live slots and rank, 2 the first tile, 3 the walk,
// 4 apply and counts, 5 free slots, 6 spawns.
__device__ unsigned long long k3_trace[8];
#define K3_MARK(p)                          \
  if (tid == 0) {                           \
    const long long now = clock64();        \
    trace[p] += now - mark;                 \
    mark = now;                             \
  }
#else
#define K3_MARK(p)
#endif

// The chunk, with the layout s (the kernel below carves it all from shared
// memory).
template <int K>
__device__ __forceinline__ void associate(const Args& a, const Shared& s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const int t = a.t, n = a.n, rows = a.rows;
  const bool use_iou = a.use_iou;
  // a match is thr < key < the NaN key: a NaN threshold matches nothing
  const uint32_t thr = min(use_iou ? order_key(a.sigma_iou, true)
                                   : order_key(a.sigma_dis, false), kNanKey - 1u);

  for (int x = tid; x < t; x += kThreads) {
    s.last_box[x] = a.in_last_box[x];
    s.max_score[x] = a.in_max_score[x];
    s.length[x] = a.in_length[x];
    s.order[x] = a.in_order[x];
    s.alive[x] = a.in_alive[x];
  }
  int key = a.in_next_key[0];
  uint32_t staged = a.f > 0 ? stage<K>(s, 0, 0, a, tid) : 0u;
#ifdef FDT_K3_TRACE
  unsigned long long trace[8] = {};
  long long mark = clock64();
#endif

  for (int fr = 0; fr < a.f; ++fr) {
    const int b = fr & 1;
    cp_async_wait_all();
    store_valid(s, staged, n, tid);
    __syncthreads();  // frame fr's detections and the last frame's state
    if (fr + 1 < a.f) staged = stage<K>(s, b ^ 1, fr + 1, a, tid);
    K3_MARK(0);
    const size_t row_t = static_cast<size_t>(fr) * t, row_n = static_cast<size_t>(fr) * n;
    int g0, g1, d0, d1;
    warp_groups(t, warp, &g0, &g1);
    warp_groups(n, warp, &d0, &d1);

    // A: the live slots in slot order, then ranked by (order, slot)
    int c = 0;
    for (int g = g0; g < g1; ++g) {
      const int x = g * 32 + lane;
      c += __popc(__ballot_sync(kFull, x < t && s.alive[x]));
    }
    if (lane == 0) s.tot[warp] = c;
    __syncthreads();
    int live_n;
    int base = prefix(s.tot, warp, &live_n);
    for (int g = g0; g < g1; ++g) {
      const int x = g * 32 + lane;
      const bool p = x < t && s.alive[x];
      const unsigned m = __ballot_sync(kFull, p);
      if (p) {
        const int q = base + __popc(m & below);
        s.live[q] = x;
        s.res[q] = s.order[x];
      }
      base += __popc(m);
    }
    __syncthreads();
    for (int i = tid; i < live_n; i += kThreads) {
      const int k = s.res[i];
      int r = 0;
#pragma unroll 8
      for (int j = 0; j < live_n; ++j) {  // unrolled: the loads do not wait on each other
        const int kj = s.res[j];
        r += kj < k || (kj == k && j < i);
      }
      s.visit[r] = s.live[i];
    }
    __syncthreads();
    K3_MARK(1);

    // A, then B: the first tile by every warp; then warp 0 walks tile k
    // while the others compute tile k + 1
    const int tiles = (live_n + rows - 1) / rows;
    uint32_t rem = warp == 0 ? valid_bits<K>(s, n, lane) : 0u;
    if (tiles) {
      affinities<K>(s, b, s.tile[0], 0, min(live_n, rows), n, use_iou, tid, kThreads);
    } else if (warp == 0) {
      s.rem[lane] = rem;
    }
    __syncthreads();
    K3_MARK(2);
    for (int k = 0; k < tiles; ++k) {
      const int r0 = k * rows, r1 = min(live_n, r0 + rows);
      if (warp == 0) {
        rem = walk<K>(pick(s.tile, k & 1), s.visit, s.res, r0, r1, rem, thr, lane);
        if (k + 1 == tiles) s.rem[lane] = rem;
      } else if (k + 1 < tiles) {
        affinities<K>(s, b, pick(s.tile, (k + 1) & 1), r1, min(live_n, r1 + rows) - r1, n,
                      use_iou, tid - 32, kThreads - 32);
      }
      __syncthreads();
    }
    K3_MARK(3);

    // C: matches, finishes and drops; the free slots' and the new
    // detections' counts
    const float4* boxes = pick(s.boxes, b);
    const float* scores = pick(s.scores, b);
    int free_c = 0, new_c = 0;
    for (int g = g0; g < g1; ++g) {
      const int x = g * 32 + lane;
      bool is_free = false;
      if (x < t) {
        int assigned = -1;
        uint8_t fin = 0;
        if (s.alive[x]) {
          const int r = s.res[x];
          if (r >= 0) {
            s.last_box[x] = boxes[pos<K>(r)];
            s.max_score[x] = max_nan(s.max_score[x], scores[r]);
            s.length[x] += 1;
            assigned = r;
          } else {
            fin = r == -1 && s.max_score[x] > a.sigma_h && s.length[x] > a.t_min;
            s.alive[x] = 0;
          }
        }
        is_free = !s.alive[x];
        if (is_free) s.order[x] = kDeadOrder;
        a.assign[row_t + x] = assigned;
        a.finish[row_t + x] = fin;
      }
      free_c += __popc(__ballot_sync(kFull, is_free));
    }
    for (int g = d0; g < d1; ++g) {
      const int j = g * 32 + lane;
      new_c += __popc(__ballot_sync(kFull, j < n && unconsumed<K>(s, j)));
    }
    if (lane == 0) {
      s.tot[warp] = free_c;
      s.tot[32 + warp] = new_c;
    }
    __syncthreads();
    K3_MARK(4);
    int free_n, new_n;
    base = prefix(s.tot, warp, &free_n);
    int new_base = prefix(s.tot + 32, warp, &new_n);
    for (int g = g0; g < g1; ++g) {  // free slots, lowest id first
      const int x = g * 32 + lane;
      const bool p = x < t && !s.alive[x];
      const unsigned m = __ballot_sync(kFull, p);
      if (p) s.live[base + __popc(m & below)] = x;
      base += __popc(m);
    }
    __syncthreads();
    K3_MARK(5);
    for (int g = d0; g < d1; ++g) {  // spawns, in detection order
      const int j = g * 32 + lane;
      const bool p = j < n && unconsumed<K>(s, j);
      const unsigned m = __ballot_sync(kFull, p);
      const int rank = new_base + __popc(m & below);
      int slot = -1;
      if (p && rank < free_n) {
        slot = s.live[rank];
        s.last_box[slot] = boxes[pos<K>(j)];
        s.max_score[slot] = scores[j];
        s.length[slot] = 1;
        s.order[slot] = static_cast<int>(static_cast<unsigned>(key) + static_cast<unsigned>(rank));
        s.alive[slot] = 1;
      }
      if (j < n) a.spawn[row_n + j] = slot;
      new_base += __popc(m);
    }
    const int spawned = min(new_n, free_n);
    if (tid == 0) a.overflow[fr] = new_n - spawned;
    key = static_cast<int>(static_cast<unsigned>(key) + static_cast<unsigned>(spawned));
    K3_MARK(6);
  }
  __syncthreads();
#ifdef FDT_K3_TRACE
  if (tid == 0) {
    for (int p = 0; p < 7; ++p) atomicAdd(&k3_trace[p], trace[p]);
  }
#endif
  for (int x = tid; x < t; x += kThreads) {
    a.last_box[x] = s.last_box[x];
    a.max_score[x] = s.max_score[x];
    a.length[x] = s.length[x];
    a.order[x] = s.order[x];
    a.alive[x] = s.alive[x];
  }
  if (tid == 0) a.next_key[0] = key;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1) track_assoc_smem_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared s;
  carve(smem, a.t, a.n, a.rows, &s);
  associate<K>(a, s);
}

template <int K>
cudaError_t launch_smem(const Args& a, cudaStream_t stream) {
  Shared s;
  const size_t bytes = carve(nullptr, a.t, a.n, a.rows, &s);
  cudaError_t err = cudaFuncSetAttribute(track_assoc_smem_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  track_assoc_smem_kernel<K><<<1, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The device-memory variant: one warp; the slot state lives in the output
// buffers and a scratch of 3 T + N ints, so that no T is refused; a slot
// step computes its row, reduces (value, index) over the lanes by xor
// shuffles and writes the slot back.

// (av, ai) comes before (bv, bi) in an argmax: NaN first (lower index among
// NaNs), then the greater value, then the lower index.  Descending = false
// gives argmin's order.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi, bool descending) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  if (av == bv) return ai < bi;
  return descending ? av > bv : av < bv;
}

struct State {
  float4* last_box;
  float* max_score;
  int* length;
  int* order;
  uint8_t* alive;
};

__global__ void __launch_bounds__(32) track_assoc_global_kernel(
    const float4* __restrict__ in_last_box, const float* __restrict__ in_max_score,
    const int* __restrict__ in_length, const int* __restrict__ in_order,
    const uint8_t* __restrict__ in_alive, const int* __restrict__ in_next_key,
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, State st, int* __restrict__ out_next_key,
    int* __restrict__ assign, uint8_t* __restrict__ finish, int* __restrict__ spawn,
    int* __restrict__ overflow, int* scratch, int t, int f, int n,
    float sigma_iou, float sigma_dis, float sigma_h, int t_min, int use_iou) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int* live = scratch;          // [T] live, then free, slot ids
  int* keys = scratch + t;      // [T] orders of the live slots
  int* visit = scratch + 2 * t; // [T] the live slots in visit order
  int* consumed = scratch + 3 * t;  // [N] (a lane owns j = lane + 32 k)

  for (int s = lane; s < t; s += 32) {
    st.last_box[s] = in_last_box[s];
    st.max_score[s] = in_max_score[s];
    st.length[s] = in_length[s];
    st.order[s] = in_order[s];
    st.alive[s] = in_alive[s];
  }
  int key = in_next_key[0];
  __syncwarp();

  for (int fr = 0; fr < f; ++fr) {
    const size_t row_t = static_cast<size_t>(fr) * t, row_n = static_cast<size_t>(fr) * n;
    for (int s = lane; s < t; s += 32) {
      assign[row_t + s] = -1;
      finish[row_t + s] = 0;
    }
    for (int j = lane; j < n; j += 32) consumed[j] = !__ldg(valid + row_n + j);

    // the live slots, compacted in slot order, then ranked by (order, slot)
    int live_n = 0;
    for (int base = 0; base < t; base += 32) {
      const int s = base + lane;
      const bool a = s < t && st.alive[s];
      const unsigned m = __ballot_sync(kFull, a);
      if (a) {
        const int p = live_n + __popc(m & below);
        live[p] = s;
        keys[p] = st.order[s];
      }
      live_n += __popc(m);
    }
    __syncwarp();
    for (int i = lane; i < live_n; i += 32) {
      const int k = keys[i];
      int r = 0;
      for (int j = 0; j < live_n; ++j) {
        const int kj = keys[j];
        r += kj < k || (kj == k && j < i);
      }
      visit[r] = live[i];
    }
    __syncwarp();

    // the walk: one dependent step a live slot
    for (int i = 0; i < live_n; ++i) {
      const int s = visit[i];
      const float4 ref = st.last_box[s];
      float best_v = use_iou ? -INFINITY : INFINITY;
      int best_i = INT_MAX;
      bool any = false;
      for (int j = lane; j < n; j += 32) {
        if (consumed[j]) continue;
        any = true;
        const float4 d = __ldg(boxes + row_n + j);
        const float v = use_iou ? iou(d, ref) : distance(d, ref);
        if (before(v, j, best_v, best_i, use_iou)) {
          best_v = v;
          best_i = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best_v, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        if (before(ov, oi, best_v, best_i, use_iou)) {
          best_v = ov;
          best_i = oi;
        }
      }
      const bool any_rem = __any_sync(kFull, any);
      const bool matched = any_rem && best_v == best_v &&
                           (use_iou ? best_v > sigma_iou : best_v < sigma_dis);
      if (lane == 0) {
        if (matched) {
          st.last_box[s] = __ldg(boxes + row_n + best_i);
          st.max_score[s] = max_nan(st.max_score[s], __ldg(scores + row_n + best_i));
          st.length[s] += 1;
          assign[row_t + s] = best_i;
        } else {
          finish[row_t + s] = any_rem && st.max_score[s] > sigma_h && st.length[s] > t_min;
        }
        st.alive[s] = matched;
      }
      if (matched && (best_i & 31) == lane) consumed[best_i] = 1;
      __syncwarp();
    }

    // free slots, lowest id first (their order becomes dead), then spawns
    // from the unconsumed detections in detection order
    int free_n = 0;
    for (int base = 0; base < t; base += 32) {
      const int s = base + lane;
      const bool fr_s = s < t && !st.alive[s];
      const unsigned m = __ballot_sync(kFull, fr_s);
      if (fr_s) {
        live[free_n + __popc(m & below)] = s;
        st.order[s] = kDeadOrder;
      }
      free_n += __popc(m);
    }
    __syncwarp();
    int new_n = 0;
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      const bool nw = j < n && !consumed[j];
      const unsigned m = __ballot_sync(kFull, nw);
      const int rank = new_n + __popc(m & below);
      int slot = -1;
      if (nw && rank < free_n) {
        slot = live[rank];
        st.last_box[slot] = __ldg(boxes + row_n + j);
        st.max_score[slot] = __ldg(scores + row_n + j);
        st.length[slot] = 1;
        st.order[slot] = key + rank;
        st.alive[slot] = 1;
      }
      if (j < n) spawn[row_n + j] = slot;
      new_n += __popc(m);
    }
    const int spawned = min(new_n, free_n);
    if (lane == 0) overflow[fr] = new_n - spawned;
    key += spawned;
    __syncwarp();
  }
  if (lane == 0) out_next_key[0] = key;
}

// Args of fdt_track_associate's 19 pointers, in its order.
Args make_args(const void* const (&p)[19], int t, int f, int n, int rows, float sigma_iou,
               float sigma_dis, float sigma_h, int t_min, int use_iou) {
  auto out = [&](int i) { return const_cast<void*>(p[i]); };
  return Args{static_cast<const float4*>(p[0]), static_cast<const float*>(p[1]),
              static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
              static_cast<const uint8_t*>(p[4]), static_cast<const int*>(p[5]),
              static_cast<const float4*>(p[6]), static_cast<const float*>(p[7]),
              static_cast<const uint8_t*>(p[8]), static_cast<float4*>(out(9)),
              static_cast<float*>(out(10)), static_cast<int*>(out(11)),
              static_cast<int*>(out(12)), static_cast<uint8_t*>(out(13)),
              static_cast<int*>(out(14)), static_cast<int*>(out(15)),
              static_cast<uint8_t*>(out(16)), static_cast<int*>(out(17)),
              static_cast<int*>(out(18)), t, f, n, rows, sigma_iou, sigma_dis, sigma_h,
              t_min, use_iou};
}

cudaError_t launch_global(const Args& a, int* scratch, cudaStream_t stream) {
  const State st{a.last_box, a.max_score, a.length, a.order, a.alive};
  track_assoc_global_kernel<<<1, 32, 0, stream>>>(
      a.in_last_box, a.in_max_score, a.in_length, a.in_order, a.in_alive, a.in_next_key,
      a.boxes, a.scores, a.valid, st, a.next_key, a.assign, a.finish, a.spawn, a.overflow,
      scratch, a.t, a.f, a.n, a.sigma_iou, a.sigma_dis, a.sigma_h, a.t_min, a.use_iou);
  return cudaGetLastError();
}

// Rows of a tile of affinities the shared-memory variant takes at (t, n) on
// the current device: as many as fit beside the state and a frame's buffers
// in a block's opt-in shared memory, at most T; 0 where it cannot take the
// shape (N > kMaxN, or fewer than min(T, kMinRows) rows fit) and the
// device-memory variant runs.
cudaError_t plan_rows(int t, int n, int* rows) {
  *rows = 0;
  if (n > kMaxN) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  Shared s;
  const long long fixed = static_cast<long long>(carve(nullptr, t, n, 0, &s));
  const long long row = static_cast<long long>(carve(nullptr, t, n, 1, &s)) - fixed;
  const long long fit = std::min<long long>(t, (optin - fixed) / row);
  *rows = fit >= std::min(t, kMinRows) ? static_cast<int>(fit) : 0;
  return cudaSuccess;
}

}  // namespace

#ifdef FDT_K3_TRACE
// Copies the cycles by phase into out[8] and clears them.
extern "C" int fdt_track_trace(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k3_trace, sizeof k3_trace);
  if (err == cudaSuccess) {
    const unsigned long long zero[8] = {};
    err = cudaMemcpyToSymbol(k3_trace, zero, sizeof zero);
  }
  return static_cast<int>(err);
}
#endif

extern "C" long long fdt_track_smem_bytes(int t, int n, int rows) {
  Shared s;
  return static_cast<long long>(carve(nullptr, t, n, rows, &s));
}

extern "C" int fdt_track_rows(int t, int n) {
  int rows = 0;
  const cudaError_t err = plan_rows(t, n, &rows);
  return err == cudaSuccess ? rows : -static_cast<int>(err);
}

// Launches the variant plan_rows picks and writes its rows a tile to
// *rows_out (0: the device-memory variant, which takes scratch: 3 T + N
// ints).
extern "C" int fdt_track_associate(
    const void* last_box, const void* max_score, const void* length, const void* order,
    const void* alive, const void* next_key, const void* boxes, const void* scores,
    const void* valid, void* out_last_box, void* out_max_score, void* out_length,
    void* out_order, void* out_alive, void* out_next_key, void* assign, void* finish,
    void* spawn, void* overflow, void* scratch, int t, int f, int n, float sigma_iou,
    float sigma_dis, float sigma_h, int t_min, int use_iou, void* stream, int* rows_out) {
  if (t < 1 || n < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0;
  const cudaError_t err = plan_rows(t, n, &rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  *rows_out = rows;
  const void* const ptrs[] = {last_box, max_score, length, order, alive, next_key, boxes,
                              scores, valid, out_last_box, out_max_score, out_length,
                              out_order, out_alive, out_next_key, assign, finish, spawn,
                              overflow};
  const Args a = make_args(ptrs, t, f, n, rows, sigma_iou, sigma_dis, sigma_h, t_min, use_iou);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return static_cast<int>(launch_global(a, static_cast<int*>(scratch), st));
  switch (lane_dets(n)) {
    case 1: return static_cast<int>(launch_smem<1>(a, st));
    case 2: return static_cast<int>(launch_smem<2>(a, st));
    case 4: return static_cast<int>(launch_smem<4>(a, st));
    case 8: return static_cast<int>(launch_smem<8>(a, st));
    case 16: return static_cast<int>(launch_smem<16>(a, st));
    default: return static_cast<int>(launch_smem<32>(a, st));
  }
}
