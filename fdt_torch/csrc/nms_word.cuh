// The word resolve shared by the greedy-NMS kernels K1 and K2: the keeps of
// one word of 64 score-sorted boxes, once every earlier word's kept boxes
// have been pushed into its `removed` bits.
#pragma once

#include <cuda_runtime.h>

namespace {

// The OR of x over the 32 lanes of a warp (all of them call it).
__device__ __forceinline__ unsigned long long or_across_warp(unsigned long long x) {
  return __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x)) |
         static_cast<unsigned long long>(
             __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32))) << 32;
}

// One warp, all 32 lanes: `live` = the word's boxes that no earlier word
// removed; lane l holds d_lo = the hits of box l on the later boxes of the
// word (bit j: box l suppresses box j) and d_hi those of box l + 32.
// Returns the word's keep mask, as the plain version finds it: start from
// the live boxes, drop every box that one of them suppresses, and repeat
// from the live boxes until the set holds.  Each pass fixes at least the
// next box in order, so short suppression chains take two or three.
__device__ __forceinline__ unsigned long long resolve_word(unsigned long long live,
                                                           unsigned long long d_lo,
                                                           unsigned long long d_hi, int lane) {
  unsigned long long kw = live;
  for (;;) {
    const unsigned long long cleared = or_across_warp((((kw >> lane) & 1ull) ? d_lo : 0ull) |
                                                      (((kw >> (lane + 32)) & 1ull) ? d_hi : 0ull));
    const unsigned long long next = live & ~cleared;
    if (next == kw) return kw;
    kw = next;
  }
}

}  // namespace
