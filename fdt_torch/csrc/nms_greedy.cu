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
// What bounds it on this card: the serial walk, not bytes or operations.
// A problem of N boxes reads 17 N bytes and needs (keeps x later boxes) pair
// tests, but each kept box must finish its pass before the next box's keep
// byte can be read.  The design is the simple one:
//   * one block per problem stages the boxes (SoA), their areas and a keep
//     byte per box in shared memory (21 bytes a box: 168 KB at N = 8192, the
//     wrapper's limit, above the 48 KB default, so the launch opts in; a
//     larger N than the card's shared memory holds fails that opt-in);
//   * the walk reads keep[i] from shared memory, which no thread writes
//     between barriers, so every thread takes the same branch; a box that is
//     not kept costs one shared-memory read and no barrier;
//   * for a kept box the block's threads test the later boxes in a strided
//     loop, skip those already cleared, and clear the ones it suppresses;
//     one __syncthreads() follows each kept box;
//   * the walk and the passes stop at the problem's extent (1 + the last
//     valid index): boxes past it are invalid and stay cleared.
// The overlap test is fdt_torch/csrc/nms_overlap.cuh, shared with K1, so the
// keep mask is bit-equal to K1's and to the plain version's.
//
// C interface (loaded with ctypes): fdt_nms_greedy returns a CUDA error code
// (cudaGetLastError() after the launch).  It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "nms_overlap.cuh"

namespace {

constexpr int kThreads = 512;

__host__ __device__ constexpr size_t shared_bytes(int n) {
  // x1, y1, x2, y2, area as float, then one keep byte per box
  return static_cast<size_t>(n) * (5 * sizeof(float) + 1);
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes,   // [P, N]
                  const uint8_t* __restrict__ valid,  // [P, N]
                  uint8_t* __restrict__ keep,         // [P, N]
                  int n, float thresh, int minimum_mode) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  uint8_t* k = reinterpret_cast<uint8_t*>(area + n);
  __shared__ int extent;

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int t = threadIdx.x;
  if (t == 0) extent = 0;
  __syncthreads();
  for (int j = t; j < n; j += blockDim.x) {
    const float4 b = boxes[base + j];
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = area_of(b.x, b.y, b.z, b.w);
    const uint8_t v = valid[base + j] ? 1 : 0;
    k[j] = v;
    if (v) atomicMax(&extent, j + 1);
  }
  __syncthreads();

  const int m = extent;
  for (int i = 0; i < m; ++i) {
    if (!k[i]) continue;
    const float4 a = make_float4(x1[i], y1[i], x2[i], y2[i]);
    const float area_a = area[i];
    for (int j = i + 1 + t; j < m; j += blockDim.x) {
      if (k[j] && suppresses(a, area_a, make_float4(x1[j], y1[j], x2[j], y2[j]),
                             area[j], thresh, minimum_mode)) {
        k[j] = 0;
      }
    }
    __syncthreads();
  }
  for (int j = t; j < n; j += blockDim.x) keep[base + j] = k[j];
}

}  // namespace

extern "C" int fdt_nms_greedy(const void* boxes, const void* valid, void* keep,
                              int p, int n, float thresh, int minimum_mode,
                              void* stream) {
  if (p == 0 || n == 0) return 0;
  const size_t smem = shared_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_greedy_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, thresh, minimum_mode);
  return static_cast<int>(cudaGetLastError());
}
