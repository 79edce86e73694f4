// The IoU tracker's greedy association over a chunk of frames, in one
// launch (K3).
//
// Replaces fdt's _associate_chunk (fdt/track/device_tracker.py:93-194), a
// lax.scan over the frames of a chunk with a fori_loop over the live slots
// that XLA compiles (not a Pallas kernel).  Its plain PyTorch version is
// fdt_torch/track/device_tracker.py::associate_chunk_plain, the CPU path and
// the oracle this kernel is held to, bit for bit.
//
// Why a kernel.  The walk's trip count, the live slots of each frame, is
// data: fdt's fori_loop reads it on the device and the host reads the
// records once a chunk.  Eager PyTorch can bound that loop only by reading
// the live count and visit order on the host every frame, and each slot
// visit is then some 20 small launches (the affinity row, the masked argmax,
// the scatters of the update): milliseconds a frame, the detect's time or
// more.  Here one launch runs the chunk with no host read.
//
// What bounds it.  Not bytes (the chunk's inputs and records are tens of
// KB, nanoseconds at 3.35 TB/s) nor operations (F x live slots x N
// affinities of ~20 flops), but the chain of dependent slot steps: each
// visit's match consumes a detection the next visit may not take, and each
// frame starts from the state the last one left.  So the design keeps every
// step short instead of wide:
//   * one block of one warp a chunk, which loops over the F frames;
//   * the slot state lives in the output buffers (the input is copied once)
//     and in a scratch of 3 T + N ints, read through L1, so that no T is
//     refused; the detections are read-only (__ldg);
//   * a frame first compacts the live slots by ballots (T / 32 steps) and
//     ranks them by (order, slot), which is the stable argsort of fdt's
//     where(alive, order, DEAD) over the live prefix;
//   * a slot step: every lane computes the affinity of its detections
//     (j = lane + 32 k; one for N <= 32) against the slot's last box, keeps
//     its best, and five xor shuffles give every lane the warp's best
//     (first index on ties, NaN first, as torch.argmax/argmin); lane 0
//     writes the slot, the owner lane of the match marks it consumed, and a
//     __syncwarp orders the step before the next;
//   * spawns take the free slots lowest id first by a ballot prefix over
//     the free flags, and the new detections by one over their flags.
// A slot step is a few hundred cycles of latency, so a chunk of 16 frames
// with ~30 live tracks takes tens of microseconds (PERF.md).
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
// C interface (loaded with ctypes): fdt_track_associate returns a CUDA error
// code (that of the launch, or cudaGetLastError() after it).  It launches on
// the given stream, does not synchronise and allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "nms_overlap.cuh"

namespace {

constexpr int kDeadOrder = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// (av, ai) comes before (bv, bi) in an argmax: NaN first (lower index among
// NaNs), then the greater value, then the lower index.  Descending = false
// gives argmin's order.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi, bool descending) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  if (av == bv) return ai < bi;
  return descending ? av > bv : av < bv;
}

// IoU of box d against the slot's last box r (_iou_row).
__device__ __forceinline__ float iou(const float4 d, const float4 r) {
  const float w = max_nan(__fsub_rn(min_nan(d.z, r.z), max_nan(d.x, r.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(d.w, r.w), max_nan(d.y, r.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float a = __fmul_rn(__fsub_rn(d.z, d.x), __fsub_rn(d.w, d.y));
  const float b = __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(a, b), inter));
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

struct State {
  float4* last_box;
  float* max_score;
  int* length;
  int* order;
  uint8_t* alive;
};

__global__ void __launch_bounds__(32) track_assoc_kernel(
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

}  // namespace

extern "C" int fdt_track_associate(
    const void* last_box, const void* max_score, const void* length, const void* order,
    const void* alive, const void* next_key, const void* boxes, const void* scores,
    const void* valid, void* out_last_box, void* out_max_score, void* out_length,
    void* out_order, void* out_alive, void* out_next_key, void* assign, void* finish,
    void* spawn, void* overflow, void* scratch, int t, int f, int n, float sigma_iou,
    float sigma_dis, float sigma_h, int t_min, int use_iou, void* stream) {
  if (t < 1 || n < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const State st{static_cast<float4*>(out_last_box), static_cast<float*>(out_max_score),
                 static_cast<int*>(out_length), static_cast<int*>(out_order),
                 static_cast<uint8_t*>(out_alive)};
  track_assoc_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(last_box), static_cast<const float*>(max_score),
      static_cast<const int*>(length), static_cast<const int*>(order),
      static_cast<const uint8_t*>(alive), static_cast<const int*>(next_key),
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), st, static_cast<int*>(out_next_key),
      static_cast<int*>(assign), static_cast<uint8_t*>(finish), static_cast<int*>(spawn),
      static_cast<int*>(overflow), static_cast<int*>(scratch), t, f, n, sigma_iou, sigma_dis,
      sigma_h, t_min, use_iou);
  return static_cast<int>(cudaGetLastError());
}
