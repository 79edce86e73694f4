// Greedy-NMS keep mask by the literal one-box-at-a-time loop, batched over
// problems (K2).
//
// Replaces the TPU kernel fdt/ops/pallas_nms.py::_nms_kernel (launched
// through pallas_nms_keep, fdt/ops/pallas_nms.py:238-270), which nms_padded
// reaches with impl="pallas".  It computes the same function as K1 without
// segments or out_k: keep starts as valid; for i = 0 .. N-1 in score order,
// if keep[i] is still set, every later j with overlap(i, j) >= thresh is
// cleared.  A box that is not kept suppresses nothing, as in the Pallas
// kernel's `cur > 0.5` mask.
//
// What bounds it on this card: the serial walk, not bytes or operations.  A
// problem of N boxes reads 17 N bytes and needs about keeps x later boxes
// pair tests (78 M at 8 x 5000, some 15 us of the card's float32 rate), but
// a box's keep is known only once every kept box before it has been tested
// against it.  The first design gave a problem one block (8 or 16 of 132
// SMs busy) and paid one block barrier per kept box, with a pass over every
// later box after each: 1.1-2.1 us a kept box.  This one:
//   * gives a problem a thread-block cluster of kCluster = 8 blocks (the
//     portable size; 16 measured slower, PERF.md), one launch for every
//     problem of a call;
//   * cuts the boxes into words of 64 (one bit a box) and deals the words
//     round robin to the cluster's blocks (word w to block w mod kCluster),
//     so that every block holds later words, and so work, until the walk
//     ends; a block stages its words' boxes and `removed` bits in its own
//     shared memory, and before the walk computes its words' hit words, each
//     box's on the later boxes of its own word (1.5 KB a word; 28 KB a block
//     at N = 8192 with the lists below, under the 48 KB default).  The hit
//     words take 3% of the kernel's device time at the timed shapes and the
//     staging 1-2.5% (PERF.md), so they are not overlapped with the walk;
//   * walks word by word up to the problem's last valid word (found through
//     distributed shared memory).  For word v the owner pushes the kept boxes
//     of word v - 1 into v, resolves v's 64 keeps at once in one warp by the
//     plain version's fixpoint (resolve_word, nms_word.cuh, shared with K1)
//     and writes v's kept boxes, packed, into a list in every block's shared
//     memory; one cluster barrier (arrive.release, wait.acquire) publishes
//     them;
//   * between its arrival and its wait, every block pushes the kept boxes of
//     the word before into its own live words after v, so that the push
//     hides the barrier's latency.  A block writes only its own `removed`
//     bits: no atomics across blocks.  The push skips removed boxes and
//     those past the extent, tests four kept boxes at once with
//     may_overlap() (nms_overlap.cuh, four comparisons) and divides only for
//     those that pass;
//   * threads of a cluster are at most one barrier apart, so a block may
//     still push the list of word v - 1 while the owner of v + 1 writes its
//     list: three list slots a block.
// A word then costs a few microseconds of latency (the barrier, the owner's
// push into one word, two block barriers, the resolve, 64 C remote stores),
// which bounds the walk everywhere but early in a long one, where the bulk
// push does (PERF.md).  A last cluster barrier keeps every block alive until
// no block touches its shared memory.  The overlap test is suppresses()
// (nms_overlap.cuh), shared with K1, so the keep mask is bit-equal to K1's
// and to the plain version's.
//
// C interface (loaded with ctypes): fdt_nms_greedy returns a CUDA error code
// (that of the launch, or cudaGetLastError() after it).  It launches on the
// given stream, does not synchronise and allocates nothing.  For the
// profilers: fdt_nms_greedy_cluster gives kCluster, and
// fdt_nms_greedy_max_clusters(n) the clusters the card runs at once for a
// problem of n boxes (a negative CUDA error code on failure).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "nms_overlap.cuh"
#include "nms_word.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks a problem
constexpr int kTile = 64;     // boxes per word
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 4;      // kept boxes a thread tests at once
constexpr int kSlots = 3;     // kept-box lists a block holds: words v - 1, v, v + 1

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Dynamic shared memory of a block that owns at most m words.
struct Shared {
  float4* box;               // [m * 64] its words' boxes
  float4* list_box;          // [3][64] the kept boxes of word w, packed, in slot w % 3
  unsigned long long* diag;  // [m * 64] row i's hits on the later boxes of its word
  unsigned long long* kept;  // [m] its words' keep masks, once resolved
  unsigned* removed;         // [2 m] removed boxes, 32 bits a half word

  __host__ __device__ static size_t bytes(int m) {
    return static_cast<size_t>(m) * kTile * (sizeof(float4) + sizeof(unsigned long long)) +
           kSlots * kTile * sizeof(float4) +
           static_cast<size_t>(m) * (sizeof(unsigned long long) + 2 * sizeof(unsigned));
  }
  __device__ Shared(unsigned char* base, int m)
      : box(reinterpret_cast<float4*>(base)),
        list_box(box + m * kTile),
        diag(reinterpret_cast<unsigned long long*>(list_box + kSlots * kTile)),
        kept(diag + m * kTile),
        removed(reinterpret_cast<unsigned*>(kept + m)) {}

  __device__ unsigned long long removed64(int k) const {
    return removed[2 * k] | static_cast<unsigned long long>(removed[2 * k + 1]) << 32;
  }
};

__device__ __forceinline__ float area4(const float4 b) { return area_of(b.x, b.y, b.z, b.w); }

// Test the `count` kept boxes of the list against the live boxes of the
// block's words [k0, k1) and OR the boxes they suppress into `removed`.  A
// warp takes one half word (32 boxes, a lane each) and, where the block has
// fewer half words than warps, a share of the list (the `splits` shares
// take runs of kStep kept boxes in turn), so that a late, short push still
// keeps every warp busy.  A lane tests kStep kept boxes at once with
// may_overlap (independent, so they overlap in the pipeline) and divides
// only for those that pass; the others suppress nothing for thresh > 0.
__device__ void push(const Shared& s, const float4* list_box, int count, int k0, int k1,
                     float thresh, int minimum_mode, int warp, int lane) {
  const int halves = 2 * (k1 - k0);
  if (count == 0 || halves <= 0) return;
  int splits = kWarps / halves;
  const int runs = (count + kStep - 1) / kStep;
  splits = splits < 1 ? 1 : (splits < runs ? splits : runs);
  const bool skip_ok = thresh > 0.0f;
  for (int e = warp; e < halves * splits; e += kWarps) {
    const int h = 2 * k0 + e / splits;
    const unsigned live = ~s.removed[h];
    if (live == 0u) continue;
    bool found = false;
    if ((live >> lane) & 1u) {
      const float4 b = s.box[h * 32 + lane];
      const float area_b = area4(b);
      for (int q0 = (e % splits) * kStep; q0 < count; q0 += splits * kStep) {
        unsigned cand = 0u;
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int q = q0 + u < count ? q0 + u : q0;  // a valid index; masked below
          cand |= static_cast<unsigned>(q0 + u < count &&
                                        (!skip_ok || may_overlap(list_box[q], b))) << u;
        }
        for (int u = 0; cand && !found && u < kStep; ++u) {
          const float4 a = list_box[q0 + u];
          found = ((cand >> u) & 1u) && suppresses(a, area4(a), b, area_b, thresh, minimum_mode);
        }
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, found);
    if (lane == 0 && bits) atomicOr(s.removed + h, bits);
  }
}

// Stage this block's words (word k * kCluster + r as local word k): boxes,
// and removed = ~valid, boxes past n read as removed.  Returns the
// problem's last valid word (-1 if none), the largest of the cluster's
// blocks' through distributed shared memory; every block of the cluster
// calls it.
__device__ int stage(const Shared& s, const float4* __restrict__ boxes,
                     const uint8_t* __restrict__ valid, int n, int r, int mine, int warp,
                     int lane) {
  __shared__ int last_own, last_word;
  if (threadIdx.x == 0) {
    last_own = -1;
    last_word = -1;
  }
  __syncthreads();
  for (int h = warp; h < 2 * mine; h += kWarps) {
    const int w = (h >> 1) * kCluster + r;
    const int j = w * kTile + (h & 1) * 32 + lane;
    const bool v = j < n && valid[j];
    s.box[h * 32 + lane] = j < n ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) {
      s.removed[h] = ~bits;
      if (bits) atomicMax(&last_own, w);
    }
  }
  // every block of the cluster runs and has its last valid word: the
  // problem's last valid word is the largest
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < kCluster) {
    atomicMax(&last_word, *cg::this_cluster().map_shared_rank(&last_own, threadIdx.x));
  }
  __syncthreads();
  return last_word;
}

// The hit words of the block's first `walked` words, each box's on the
// later boxes of its own word: a warp takes 32 rows and 32 columns of a
// word, a lane a row.
__device__ void hit_words(const Shared& s, int walked, float thresh, int minimum_mode,
                          int warp, int lane) {
  const bool skip_ok = thresh > 0.0f;
  for (int e = warp; e < 4 * walked; e += kWarps) {
    const int k = e >> 2, row_half = (e >> 1) & 1, col_half = e & 1;
    const int i = row_half * 32 + lane;
    const unsigned long long live = ~s.removed64(k);
    unsigned bits = 0u;
    if (col_half >= row_half && ((live >> i) & 1ull)) {
      const float4 a = s.box[k * kTile + i];
      const float area_a = area4(a);
      const unsigned cols = static_cast<unsigned>(live >> (col_half * 32));
      for (int q = 0; q < 32; ++q) {
        const int j = col_half * 32 + q;
        if (j > i && ((cols >> q) & 1u)) {
          const float4 b = s.box[k * kTile + j];
          if ((!skip_ok || may_overlap(a, b)) &&
              suppresses(a, area_a, b, area4(b), thresh, minimum_mode)) {
            bits |= 1u << q;
          }
        }
      }
    }
    reinterpret_cast<unsigned*>(s.diag + k * kTile + i)[col_half] = bits;
  }
}

// The block's own words: those below `words` dealt to rank r, and how many
// of them lie at or before word `last`.
__device__ __forceinline__ int own_words(int words, int r) {
  return r < words ? (words - 1 - r) / kCluster + 1 : 0;
}
__device__ __forceinline__ int own_words_upto(int last, int r, int mine) {
  return last < r ? 0 : min(mine, (last - r) / kCluster + 1);
}

__global__ void __launch_bounds__(kThreads, 2)
nms_greedy_kernel(const float4* __restrict__ boxes,   // [P, N]
                  const uint8_t* __restrict__ valid,  // [P, N]
                  uint8_t* __restrict__ keep,         // [P, N]
                  int n, float thresh, int minimum_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list_count[kSlots];

  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.x % kCluster;  // this block's rank in the problem's cluster
  const size_t base = static_cast<size_t>(blockIdx.x / kCluster) * n;
  const int words = (n + kTile - 1) / kTile;
  const int mine = own_words(words, r);
  const Shared s(smem, (words + kCluster - 1) / kCluster);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  const int last = stage(s, boxes + base, valid + base, n, r, mine, warp, lane);
  const int walked = own_words_upto(last, r, mine);
  hit_words(s, walked, thresh, minimum_mode, warp, lane);
  __syncthreads();

  // The walk.  Iteration w pushes the kept boxes of word w (none for w = -1)
  // into the later words and resolves word v = w + 1.  Threads of a cluster
  // are at most one barrier apart, so a block may still push the list of
  // word v - 1 while the owner of v + 1 writes its list: three slots.
  for (int w = -1; w < last; ++w) {
    const int v = w + 1, owner = v % kCluster, kv = v / kCluster;
    const int slot = (w + kSlots) % kSlots;
    const int count = w < 0 ? 0 : list_count[slot];
    const float4* list_box = s.list_box + slot * kTile;
    if (r == owner) {
      push(s, list_box, count, kv, kv + 1, thresh, minimum_mode, warp, lane);
      __syncthreads();
      if (warp == 0) {
        const unsigned long long kw = resolve_word(~s.removed64(kv), s.diag[kv * kTile + lane],
                                                   s.diag[kv * kTile + lane + 32], lane);
        if (lane == 0) s.kept[kv] = kw;
      }
      __syncthreads();
      if (v < last) {  // publish word v's kept boxes, packed, into every block's slot
        const unsigned long long kw = s.kept[kv];
        const int to = v % kSlots;
        for (int e = t; e < kCluster * kTile; e += kThreads) {
          const int q = e / kTile, i = e % kTile;
          if ((kw >> i) & 1ull) {
            const int at = to * kTile + __popcll(kw & ((1ull << i) - 1ull));
            *cluster.map_shared_rank(s.list_box + at, q) = s.box[kv * kTile + i];
          }
          if (i == 0) *cluster.map_shared_rank(list_count + to, q) = __popcll(kw);
        }
      }
    }
    cluster_arrive();  // releases word v's kept boxes
    // this block's words after v, up to the last valid word
    const int k0 = r > v ? 0 : (v - r) / kCluster + 1;
    push(s, list_box, count, k0, walked, thresh, minimum_mode, warp, lane);
    cluster_wait();
  }
  __syncthreads();

  for (int h = warp; h < 2 * mine; h += kWarps) {
    const int k = h >> 1, w = k * kCluster + r;
    const int bit = (h & 1) * 32 + lane;
    if (w * kTile + bit < n) {
      keep[base + w * kTile + bit] = w <= last ? static_cast<uint8_t>((s.kept[k] >> bit) & 1ull) : 0;
    }
  }
  // no block exits while another may still read its shared memory
  cluster_arrive();
  cluster_wait();
}

// The launch over p problems of n boxes: p clusters of kCluster blocks,
// each with the shared memory of the block that owns the most words.
cudaLaunchConfig_t launch_config(int p, int n, void* stream, cudaLaunchAttribute* attr) {
  const int words = (n + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p) * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Shared::bytes((words + kCluster - 1) / kCluster);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int fdt_nms_greedy(const void* boxes, const void* valid, void* keep,
                              int p, int n, float thresh, int minimum_mode, void* stream) {
  if (p == 0 || n == 0) return 0;
  if (p < 0 || n < 0 || p > INT_MAX / kCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, n, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, nms_greedy_kernel, static_cast<const float4*>(boxes),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n, thresh, minimum_mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fdt_nms_greedy_cluster() { return kCluster; }

extern "C" int fdt_nms_greedy_max_clusters(int n) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, n, nullptr, &attr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, nms_greedy_kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
