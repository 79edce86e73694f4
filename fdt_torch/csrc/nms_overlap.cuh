// The pairwise overlap test shared by the greedy-NMS kernels K1 and K2.
//
// It repeats the plain version's operations (fdt_torch/geometry/nms.py) in
// the same order with round-to-nearest intrinsics, which are never
// contracted into FMAs:
//   iw = max(min(x2a, x2b) - max(x1a, x1b), 0), likewise ih, inter = iw * ih,
//   union: inter / (area_a + area_b - inter), a = the earlier box,
//   minimum: inter / min(area_a, area_b);
// min and max propagate NaN as torch.minimum/maximum do, and a NaN ratio
// (0/0) suppresses nothing, so the test is never rewritten as
// inter >= thresh * denom.  Build with -fmad=false and without fast math.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// a = the earlier box, b = the later box; boxes are (x1, y1, x2, y2).
__device__ __forceinline__ bool suppresses(const float4 a, float area_a,
                                           const float4 b, float area_b,
                                           float thresh, int minimum_mode) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = minimum_mode ? min_nan(area_a, area_b)
                                   : __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, denom) >= thresh;
}

// A guard a caller may test before suppresses() to skip its division, by
// four comparisons (symmetric in a and b): false only where a and b share no
// area.  When it is false, a.z <= b.x, b.z <= a.x,
// a.w <= b.y or b.w <= a.y holds (or a coordinate is NaN), so
// min(a.z, b.z) <= max(a.x, b.x) or the same in y: the intersection in
// suppresses() is 0 (or NaN) and its ratio 0, -0 or NaN, which suppresses
// nothing for thresh > 0.  Inverted boxes (x2 < x1) may pass it; suppresses()
// then decides.
__device__ __forceinline__ bool may_overlap(const float4 a, const float4 b) {
  return a.z > b.x && b.z > a.x && a.w > b.y && b.w > a.y;
}

}  // namespace
