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
// What bounds it on this card: not bytes or FLOPs (a 5000-box problem reads
// 100 KB and needs a few tens of MFLOP), but the latency of the greedy walk,
// which is serial in score order.  The design keeps that walk short:
//   * the mask pass computes every pair test in parallel, once: a grid over
//     (column block of 64, row block of 64, problem), each thread writing one
//     64-bit word whose bit c says "row box suppresses box col0 + c".  Blocks
//     wholly below the diagonal and row blocks without a valid box are
//     skipped.  Scratch: [P, N, ceil(N/64)] words, allocated by the caller.
//   * the sweep pass, one block per problem, holds a `removed` bitmask in
//     shared memory, initialised to ~valid, and walks it word by word with
//     find-first-set, so a removed or invalid box costs no memory access at
//     all.  Only a kept box costs work: its row of words is ORed into the
//     words after the current one by the block's threads (the current word
//     is updated in registers), and a barrier is paid once per word, not per
//     box.  The walk stops at the last word holding a valid box, and after
//     out_k keeps.
//
// The overlap test is fdt_torch/csrc/nms_overlap.cuh, shared with K2.
//
// C interface (loaded with ctypes): fdt_nms_tiled returns cudaGetLastError()
// after its launches.  It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "nms_overlap.cuh"

namespace {

constexpr int kTile = 64;           // boxes per mask block and bits per word
constexpr int kSweepThreads = 128;

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,      // [P, N]
                const uint8_t* __restrict__ valid,     // [P, N]
                const int32_t* __restrict__ seg,       // [P, N] or nullptr
                unsigned long long* __restrict__ mask, // [P, N, words]
                int n, int words, float thresh, int minimum_mode) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // wholly below the diagonal: never read
  const size_t base = static_cast<size_t>(blockIdx.z) * n;
  const int t = threadIdx.x;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  __shared__ int32_t col_seg[kTile];
  const int col0 = cb * kTile;
  const int c = col0 + t;
  if (c < n) {
    const float4 b = boxes[base + c];
    col_box[t] = b;
    col_area[t] = area_of(b.x, b.y, b.z, b.w);
    col_seg[t] = seg ? seg[base + c] : 0;
  }
  const int r = rb * kTile + t;
  const bool row_valid = r < n && valid[base + r];
  // a row that is not valid is never kept, so its words are never read
  if (!__syncthreads_or(row_valid) || !row_valid) return;

  const float4 a = boxes[base + r];
  const float area_a = area_of(a.x, a.y, a.z, a.w);
  const int32_t seg_a = seg ? seg[base + r] : 0;
  const int c_end = min(kTile, n - col0);
  unsigned long long bits = 0ull;
  for (int j = (cb == rb) ? t + 1 : 0; j < c_end; ++j) {
    if (col_seg[j] == seg_a &&
        suppresses(a, area_a, col_box[j], col_area[j], thresh, minimum_mode)) {
      bits |= 1ull << j;
    }
  }
  mask[(base + r) * words + cb] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,  // [P, N, words]
                 const uint8_t* __restrict__ valid,           // [P, N]
                 uint8_t* __restrict__ keep,                  // [P, N]
                 int n, int words, int out_k) {
  extern __shared__ unsigned long long removed[];  // [words]
  __shared__ int last_word;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int t = threadIdx.x;
  if (t == 0) last_word = -1;
  __syncthreads();
  for (int w = t; w < words; w += blockDim.x) {
    unsigned long long live = 0ull;
    const int i0 = w * kTile;
    const int m = min(kTile, n - i0);
    for (int b = 0; b < m; ++b) {
      if (valid[base + i0 + b]) live |= 1ull << b;
    }
    removed[w] = ~live;
    if (live) atomicMax(&last_word, w);
  }
  for (int i = t; i < n; i += blockDim.x) keep[base + i] = 0;
  __syncthreads();

  int kept = 0;
  for (int w = 0; w <= last_word; ++w) {
    // removed[w] is final here: rows ORed so far wrote it before the last
    // barrier, and rows kept inside this word update the register copy
    unsigned long long cur = removed[w];
    unsigned long long live = ~cur;
    while (live) {
      const int b = __ffsll(static_cast<long long>(live)) - 1;
      const size_t i = base + static_cast<size_t>(w) * kTile + b;
      if (t == 0) keep[i] = 1;
      if (++kept == out_k) return;
      const unsigned long long* row = mask + i * words;
      cur |= row[w];
      for (int v = w + 1 + t; v < words; v += blockDim.x) removed[v] |= row[v];
      live = (b == kTile - 1) ? 0ull : (~cur & (~0ull << (b + 1)));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fdt_nms_tiled(const void* boxes, const void* valid,
                             const void* seg, void* mask, void* keep,
                             int p, int n, float thresh, int minimum_mode,
                             int out_k, void* stream) {
  if (p == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kTile - 1) / kTile;
  const dim3 mask_grid(words, words, p);
  nms_mask_kernel<<<mask_grid, kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(seg), static_cast<unsigned long long*>(mask),
      n, words, thresh, minimum_mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<p, kSweepThreads, words * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
      words, out_k);
  return static_cast<int>(cudaGetLastError());
}
