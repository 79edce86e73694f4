// Greedy-NMS keep mask over score-sorted boxes, batched over problems (K1).
//
// Replaces the TPU kernel fdt/ops/pallas_nms.py::_nms_kernel_tiled (launched
// through pallas_nms_keep_tiled, fdt/ops/pallas_nms.py:69-235).  It computes
// the same function: keep[i] = valid[i] and no kept j < i with the same
// segment id overlaps box i by >= thresh (IoU, or inter / min-area), and,
// with out_k > 0, only the first out_k keeps are exact (the walk stops there;
// later entries read 0).  out_k and segment ids are exclusive, as in the
// Pallas contract.
//
// What bounds it on this card: latency, not bytes or operations.  A
// 5000-box problem reads 85 KB, and the walk to its 750th keep needs about
// 0.3 M pair tests, microseconds of the card's float32 rate; but the greedy
// walk is serial in score order.  The first design paid one dependent load a
// keep in its sweep, and its mask pass tested every pair of valid boxes,
// some 30 times the tests that a walk to the 750th keep reads.  This one:
//   * cuts the boxes into words of 64 (one bit a box) and the words into
//     chunks of 8, 8, then 16 words, and tests pairs chunk by chunk, so
//     that the tests stop where the walk stops (at most 16 words past it:
//     the flagship's own boxes end their walk near box 2,400, six words into
//     a chunk of 32);
//   * resolves a whole word at a time, from shared memory, with no load;
//   * issues every launch from one C call on one stream without a wait, and
//     makes a launch that finds its problem's walk ended (out_k keeps, or
//     past its last valid word) exit at its first instructions.
// The launches:
//   * init, one block per problem: `removed` = ~valid (one word per 64
//     boxes), `kept` = 0, keep = 0, and the last word holding a valid box.
//   * per chunk, a mask launch of 64-thread blocks, for each column word of
//     the chunk and problem:
//       - blocks over the row words of earlier chunks (an eighth of them,
//         at most 8, a block): only their kept rows, whose
//         keeps are final, are tested against the chunk's live columns, a
//         column stopping at its first suppressor; a block ORs its hits into
//         `removed` with one atomicOr a warp and stores nothing;
//       - one block per row word of the chunk, whose keeps are not known
//         yet: each live row stores its word of hits on each later column
//         word of the chunk, in a [chunk words][chunk rows] scratch that
//         every chunk reuses.
//     A thread tests kStep pairs at once with may_overlap() (independent,
//     so they overlap in the pipeline) and divides only for those that
//     pass.  Rows and columns already removed, and those past the valid
//     extent, are never tested.
//   * per chunk, a sweep launch, one 512-thread block per problem: one
//     round trip brings the state, the chunk's `removed` words and the
//     diagonal words of all its rows into shared memory.  Then, per word,
//     warp 0 resolves the word's keeps as the plain version does, on 64
//     bits: from the live boxes, clear every box that a box of the set
//     suppresses, and repeat until the set holds (each pass fixes at least
//     the next box in order; short suppression chains take two or three;
//     resolve_word in nms_word.cuh, shared with K2), then cuts the set at
//     the out_k-th keep.  One warp per later word of the chunk ORs the kept
//     rows' words into it; it loaded them while the word before was
//     resolved, so no load waits on the walk.  Two barriers a word.
// Scratch, per problem: 16 bytes of state, two words of 8 bytes per 64
// boxes (`removed`, `kept`), and the chunk's stored words, 64 W^2 words of
// 8 bytes for the largest chunk of W words: 32 KB up to N = 1024 (W = 8),
// and 128 KB (W = 16) for any larger N, where the first design took N^2 / 8
// bytes (0.5 MB at N = 2048, 3.2 MB at N = 5000, 8 MiB at N = 8192).
// After this design the launches themselves are a large part of a call, on
// the card (those that find every walk ended) and on the host (13 launches
// at N = 5000); PERF.md has the split.
//
// The overlap test (nms_overlap.cuh) and the word resolve (nms_word.cuh) are
// shared with K2.
//
// C interface (loaded with ctypes): fdt_nms_tiled returns cudaGetLastError()
// after its launches; it launches on the given stream, does not synchronise
// and allocates nothing.  fdt_nms_tiled_scratch_words(n) gives the int64
// words of scratch a problem of n boxes needs; fdt_nms_tiled_chunk_end and
// fdt_nms_tiled_cross_words give the schedule (the word at which the chunk
// starting at word c0 ends, and the row words a mask block of that chunk
// walks), so that a measurement can count the pair tests it computes.

#include <cstdint>
#include <cuda_runtime.h>

#include "nms_overlap.cuh"
#include "nms_word.cuh"

namespace {

constexpr int kTile = 64;        // boxes per word; threads of a mask block
constexpr int kFirstChunk = 8;   // words of each of the first two chunks
constexpr int kMaxChunk = 16;    // words of the largest chunk
constexpr int kMaxCrossWords = 8;  // row words a cross mask block walks, at most
constexpr int kStep = 4;           // pair tests a mask thread takes at once
constexpr int kInitThreads = 256;
constexpr int kSweepThreads = 32 * kMaxChunk;  // a warp per word of a chunk

struct State {      // per problem, at the head of its scratch
  int kept;         // keeps so far
  int done;         // the walk has ended: later launches exit at once
  int last_word;    // the last word holding a valid box; -1 if none
  int unused;
};
constexpr int kStateWords = sizeof(State) / sizeof(unsigned long long);

// The end of the chunk that starts at word c0: 8, 8, then 16 words.
__host__ __device__ inline int chunk_end(int c0, int words) {
  const int w = c0 < 2 * kFirstChunk ? kFirstChunk : (c0 < kMaxChunk ? c0 : kMaxChunk);
  return c0 + w < words ? c0 + w : words;
}

// Row words of earlier chunks that one mask block walks for the chunk that
// starts at word c0: an eighth of them (at least 1, at most 8), so that a
// column word has 8 such blocks up to c0 = 64.  Fewer blocks make a launch
// that finds every walk ended cheaper, and a column stops at its first
// suppressor among more rows; more make a long walk's launch shorter.
__host__ __device__ inline int cross_words(int c0) {
  const int g = c0 / 8;
  return g < 1 ? 1 : (g < kMaxCrossWords ? g : kMaxCrossWords);
}

int largest_chunk(int words) {
  int most = 0;
  for (int c0 = 0; c0 < words;) {
    const int c1 = chunk_end(c0, words);
    most = c1 - c0 > most ? c1 - c0 : most;
    c0 = c1;
  }
  return most;
}

// Which of the staged boxes j0 .. j0 + kStep - 1 (below `count`) could
// overlap `x` by a positive ratio: bit q for box j0 + q, same segment and
// passing may_overlap(); for the others and thresh > 0 suppresses() is false
// and its division is skipped.  The kStep tests are independent, so they
// overlap in the pipeline.
__device__ __forceinline__ unsigned candidates(const float4* box_s, const int32_t* seg_s,
                                               int j0, int count, const float4 x,
                                               int32_t seg_x, float thresh) {
  unsigned cand = 0u;
#pragma unroll
  for (int q = 0; q < kStep; ++q) {
    const int j = j0 + q < count ? j0 + q : j0;  // a valid index; masked below
    const bool same = seg_s[j] == seg_x && j0 + q < count;
    const bool meet = !(thresh > 0.0f) || may_overlap(box_s[j], x);
    cand |= static_cast<unsigned>(same && meet) << q;
  }
  return cand;
}

// Per-problem scratch: [State | removed[words] | kept[words] | chunk words]
struct Scratch {
  State* state;
  unsigned long long* removed;
  unsigned long long* kept;
  unsigned long long* chunk;  // [column word - c0][row - 64 c0] of a chunk
  __device__ Scratch(unsigned long long* base, int words)
      : state(reinterpret_cast<State*>(base)),
        removed(base + kStateWords),
        kept(removed + words),
        chunk(kept + words) {}
};

__global__ void __launch_bounds__(kInitThreads)
nms_init_kernel(const uint8_t* __restrict__ valid,  // [P, N]
                uint8_t* __restrict__ keep,         // [P, N]
                unsigned long long* __restrict__ scratch, size_t stride,
                int n, int words) {
  Scratch s(scratch + blockIdx.x * stride, words);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  __shared__ int last;
  if (threadIdx.x == 0) last = -1;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // a warp takes one word a step: two ballots of 32 boxes
  for (int w = threadIdx.x >> 5; w < words; w += kInitThreads / 32) {
    const int i = w * kTile + lane;
    const bool lo = i < n && valid[base + i];
    const bool hi = i + 32 < n && valid[base + i + 32];
    const unsigned long long live =
        __ballot_sync(0xffffffffu, lo) |
        (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, hi)) << 32);
    if (i < n) keep[base + i] = 0;
    if (i + 32 < n) keep[base + i + 32] = 0;
    if (lane == 0) {
      s.removed[w] = ~live;  // boxes past n read as removed
      s.kept[w] = 0ull;
      if (live) atomicMax(&last, w);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *s.state = State{0, last < 0, last, 0};
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,  // [P, N]
                const int32_t* __restrict__ seg,   // [P, N] or nullptr
                unsigned long long* __restrict__ scratch, size_t stride,
                int n, int words, int c0, int c1, float thresh, int minimum_mode) {
  const int v = c0 + blockIdx.x;  // column word
  const int group = cross_words(c0);
  const int cross_blocks = (c0 + group - 1) / group;
  const bool cross = static_cast<int>(blockIdx.y) < cross_blocks;
  // a cross block: the row words [u0, u1) of earlier chunks, whose keeps are
  // final; else one row word u0 of this chunk
  const int u0 = cross ? blockIdx.y * group : c0 + (blockIdx.y - cross_blocks);
  const int u1 = cross ? min(u0 + group, c0) : u0 + 1;
  if (u0 > v) return;  // below the diagonal: never read
  Scratch s(scratch + blockIdx.z * stride, words);
  if (s.state->done) return;
  const size_t base = static_cast<size_t>(blockIdx.z) * n;
  const int t = threadIdx.x;

  // one snapshot for the block: `removed` grows under this launch's atomics
  __shared__ unsigned long long snap_cols, snap_rows[kMaxCrossWords];
  if (t == 0) snap_cols = ~s.removed[v];
  if (t < u1 - u0) snap_rows[t] = cross ? s.kept[u0 + t] : ~s.removed[u0 + t];
  __syncthreads();
  const unsigned long long cols = snap_cols;

  __shared__ float4 box_s[kTile];
  __shared__ float area_s[kTile];
  __shared__ int32_t seg_s[kTile];
  if (cross) {
    if (cols == 0ull) return;
    // each live column of word v against the kept rows of [u0, u1), word by
    // word, until the first that suppresses it
    const bool live = (cols >> t) & 1ull;
    const int c = v * kTile + t;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    float area_b = 0.f;
    int32_t seg_b = 0;
    if (live) {
      b = boxes[base + c];
      area_b = area_of(b.x, b.y, b.z, b.w);
      seg_b = seg ? seg[base + c] : 0;
    }
    bool found = false;
    for (int u = u0; u < u1; ++u) {
      const unsigned long long rows = snap_rows[u - u0];
      if (rows == 0ull) continue;
      // the kept rows of word u, packed
      if ((rows >> t) & 1ull) {
        const int slot = __popcll(rows & ((1ull << t) - 1ull));
        const float4 a = boxes[base + u * kTile + t];
        box_s[slot] = a;
        area_s[slot] = area_of(a.x, a.y, a.z, a.w);
        seg_s[slot] = seg ? seg[base + u * kTile + t] : 0;
      }
      __syncthreads();
      const int count = __popcll(rows);
      for (int j0 = 0; live && j0 < count && !found; j0 += kStep) {
        const unsigned cand = candidates(box_s, seg_s, j0, count, b, seg_b, thresh);
        for (int q = 0; q < kStep && !found; ++q) {
          found = ((cand >> q) & 1u) &&
                  suppresses(box_s[j0 + q], area_s[j0 + q], b, area_b, thresh, minimum_mode);
        }
      }
      __syncthreads();
    }
    const unsigned long long bits = __ballot_sync(0xffffffffu, found);
    if ((t & 31) == 0 && bits) atomicOr(&s.removed[v], bits << (t & 32));
    return;
  }

  // a row word of this chunk: store each live row's hits on column word v
  const unsigned long long rows = snap_rows[0];
  if (rows == 0ull) return;
  if ((cols >> t) & 1ull) {
    const int c = v * kTile + t;
    const float4 b = boxes[base + c];
    box_s[t] = b;
    area_s[t] = area_of(b.x, b.y, b.z, b.w);
    seg_s[t] = seg ? seg[base + c] : 0;
  }
  __syncthreads();
  if (!((rows >> t) & 1ull)) return;
  const int r = u0 * kTile + t;
  const float4 a = boxes[base + r];
  const float area_a = area_of(a.x, a.y, a.z, a.w);
  const int32_t seg_a = seg ? seg[base + r] : 0;
  // on the diagonal only the columns after the row
  unsigned long long todo = u0 < v ? cols : (t == kTile - 1 ? 0ull : cols & (~0ull << (t + 1)));
  unsigned long long bits = 0ull;
  for (int j0 = 0; j0 < kTile; j0 += kStep) {
    const unsigned live = static_cast<unsigned>(todo >> j0) & ((1u << kStep) - 1u);
    if (!live) continue;
    const unsigned cand = live & candidates(box_s, seg_s, j0, kTile, a, seg_a, thresh);
    for (int q = 0; q < kStep; ++q) {
      if (((cand >> q) & 1u) &&
          suppresses(a, area_a, box_s[j0 + q], area_s[j0 + q], thresh, minimum_mode)) {
        bits |= 1ull << (j0 + q);
      }
    }
  }
  s.chunk[static_cast<size_t>(v - c0) * ((c1 - c0) * kTile) + (r - c0 * kTile)] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(uint8_t* __restrict__ keep,  // [P, N]
                 unsigned long long* __restrict__ scratch, size_t stride,
                 int n, int words, int c0, int c1, int out_k) {
  Scratch s(scratch + blockIdx.x * stride, words);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int width = c1 - c0;
  __shared__ int kept, done, last;
  __shared__ unsigned long long kept_word;
  __shared__ unsigned long long rem[kMaxChunk];          // removed, this chunk
  __shared__ unsigned long long diag[kMaxChunk][kTile];  // row i's hits in its own word
  // one round trip: the state, the chunk's removed words and its diagonal words
  if (t == 0) {
    kept = s.state->kept;
    done = s.state->done;
    last = s.state->last_word;
  }
  for (int k = t; k < width; k += kSweepThreads) rem[k] = s.removed[c0 + k];
  for (int k = t; k < width * kTile; k += kSweepThreads) {
    diag[k / kTile][k % kTile] = s.chunk[static_cast<size_t>(k / kTile) * (width * kTile) + k];
  }
  __syncthreads();
  if (done) return;
  const int end = c1 < last + 1 ? c1 : last + 1;  // later words hold no valid box

  // warp `warp` ORs into word w + 1 + warp the hits of word w's kept rows,
  // which it loads while word w - 1 is resolved, so no load waits on the walk
  auto rows_of = [&](int w) {
    return s.chunk + static_cast<size_t>(w - c0 + 1 + warp) * (width * kTile) + (w - c0) * kTile;
  };
  unsigned long long row_lo = 0ull, row_hi = 0ull;
  if (c0 + 1 + warp < c1) {
    row_lo = rows_of(c0)[lane];
    row_hi = rows_of(c0)[lane + 32];
  }
  for (int w = c0; w < end; ++w) {
    const int ww = w - c0;
    unsigned long long next_lo = 0ull, next_hi = 0ull;
    if (w + 1 < end && w + 2 + warp < c1) {
      next_lo = rows_of(w + 1)[lane];
      next_hi = rows_of(w + 1)[lane + 32];
    }
    if (warp == 0) {
      // resolve word w from shared memory, as the plain version does
      unsigned long long kw = resolve_word(~rem[ww], diag[ww][lane], diag[ww][lane + 32], lane);
      if (lane == 0) {
        int k = kept + __popcll(kw);
        if (out_k > 0 && k >= out_k) {  // the walk ends at the out_k-th keep
          for (; k > out_k; --k) kw &= ~(1ull << (63 - __clzll(static_cast<long long>(kw))));
          done = 1;
        }
        kept = k;
        kept_word = kw;
      }
    }
    __syncthreads();
    const unsigned long long kw = kept_word;
    if (t < kTile && w * kTile + t < n) keep[base + w * kTile + t] = (kw >> t) & 1ull;
    if (t == 0) s.kept[w] = kw;
    const int v = w + 1 + warp;
    if (kw && !done && v < c1) {
      unsigned long long acc = (((kw >> lane) & 1ull) ? row_lo : 0ull) |
                               (((kw >> (lane + 32)) & 1ull) ? row_hi : 0ull);
      for (int off = 16; off > 0; off >>= 1) acc |= __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) rem[v - c0] |= acc;
    }
    row_lo = next_lo;
    row_hi = next_hi;
    __syncthreads();
    if (done) break;
  }
  if (t == 0) {
    s.state->kept = kept;
    s.state->done = done || c1 > last;
  }
}

}  // namespace

extern "C" int fdt_nms_tiled_chunk_end(int c0, int words) { return chunk_end(c0, words); }

extern "C" int fdt_nms_tiled_cross_words(int c0) { return cross_words(c0); }

extern "C" int fdt_nms_tiled_scratch_words(int n) {
  const int words = (n + kTile - 1) / kTile;
  const int w = largest_chunk(words);
  return kStateWords + 2 * words + kTile * w * w;
}

extern "C" int fdt_nms_tiled(const void* boxes, const void* valid,
                             const void* seg, void* scratch, void* keep,
                             int p, int n, float thresh, int minimum_mode,
                             int out_k, void* stream) {
  if (p == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kTile - 1) / kTile;
  const size_t stride = fdt_nms_tiled_scratch_words(n);
  auto* sc = static_cast<unsigned long long*>(scratch);
  nms_init_kernel<<<p, kInitThreads, 0, s>>>(static_cast<const uint8_t*>(valid),
                                             static_cast<uint8_t*>(keep), sc, stride, n,
                                             words);
  cudaError_t err = cudaGetLastError();
  for (int c0 = 0, c1 = 0; c0 < words && err == cudaSuccess; c0 = c1) {
    c1 = chunk_end(c0, words);
    const int cross_blocks = (c0 + cross_words(c0) - 1) / cross_words(c0);
    nms_mask_kernel<<<dim3(c1 - c0, cross_blocks + c1 - c0, p), kTile, 0, s>>>(
        static_cast<const float4*>(boxes), static_cast<const int32_t*>(seg), sc, stride, n,
        words, c0, c1, thresh, minimum_mode);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    nms_sweep_kernel<<<p, kSweepThreads, 0, s>>>(static_cast<uint8_t*>(keep), sc, stride, n,
                                                 words, c0, c1, out_k);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
