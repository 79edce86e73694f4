// K5: per-tensor symmetric int8 quantization of an activation.
//
// Replaces XLA's fused fdt/ops/quant.py::quantize_symmetric(x, axes=None)
// (fdt/ops/quant.py:69-79, called by Int8Conv at :121): amax = max |x| over
// the whole batch tensor, scale = amax * float32(1/127) (XLA's compiled form
// of fdt's amax / 127; 1 when amax is not > 0), and q = clip(rint(x /
// scale), -127, 127) as int8, a NaN giving 0 as XLA's float -> int8
// conversion does.  The plain version is
// fdt_torch/ops/quant.py::quantize_int8_plain; this kernel is bit-equal to it.
//
// Bound: bytes (x read once, q written once; a few operations an element).
// Design: one launch a call, every block resident (a cooperative launch of
// as many blocks as the card holds at once, or fewer for a small x), no host
// read.  Each block takes the max of |x|'s bit patterns over its share of
// the dense storage (NCHW or channels-last alike: the max ignores the order;
// a non-negative float orders as its bits, and a NaN's bits exceed +inf's,
// so a NaN propagates as jnp.max's does), kUnroll 16-byte loads in flight a
// thread, and writes it to its partial.  Then one grid-wide barrier: an
// arrival counter with a generation number in a small state buffer that the
// wrapper keeps per device and stream (with the partials), so no memset is
// needed; the last block in reduces the partials, publishes the amax and
// the scale (for K4) and bumps the generation, which releases the others.
// Then every block quantizes its share again in the reverse order of its
// first walk, so that the data read last in the first walk, still in the
// 50 MB L2, is read first.  A channels-last x (the bf16 models) is in q's
// NHWC order: 16 bytes read, their 4 or 8 q written at once; an NCHW x
// (float32), or one not 16-byte aligned (a view), is read through its
// strides in q's order.
//
// The quotient: rint(x / scale) needs the correctly rounded quotient only
// near a rounding boundary.  y = x * fl(1 / scale) differs from the exact
// x / scale by at most |x / scale| * 2^-23 <= 2^-16 (|x / scale| <= 127 *
// (1 + 2^-23)), and the rounded quotient from the exact one by at most half
// an ulp, 2^-18; so unless y lies within 2^-14 of a half-integer, rint(y)
// is rint of the rounded quotient, and only there does the kernel divide
// (__fdiv_rn).  A subnormal scale, whose reciprocal may overflow, divides
// every element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned warp_max[kThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) warp_max[0] = v;
  }
  __syncthreads();
  const unsigned out = warp_max[0];
  __syncthreads();
  return out;
}

// 16 bytes of x: kVec<T> elements
template <typename T> constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ unsigned abs_bits(T v) {
  return __float_as_uint(fabsf(widen(v)));
}

// the scale and its reciprocal; inv 0 when the scale is subnormal
struct Scale {
  float scale, inv;
};

__device__ __forceinline__ Scale make_scale(float scale) {
  return {scale, scale >= 1.17549435e-38f ? __frcp_rn(scale) : 0.0f};
}

__device__ __forceinline__ int8_t quantize(float v, Scale s) {
  float r = rintf(__fmul_rn(v, s.inv));
  const float near_half = fabsf(fabsf(__fsub_rn(__fmul_rn(v, s.inv), r)) - 0.5f);
  if (s.inv == 0.0f || near_half <= 0x1p-14f) r = rintf(__fdiv_rn(v, s.scale));
  return (int8_t)(isnan(r) ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f));
}

// The grid barrier's state, zero when first allocated: arrivals of the
// current call, the generation (calls so far), the amax's bits; after it
// in the same buffer, a partial maximum for each block
struct GridState {
  unsigned arrived, generation, amax, pad;
};
constexpr int kStateWords = sizeof(GridState) / 4;  // the words before the partials

// Every block's max of |x| in; the amax out to every block.  The last block
// to arrive reduces the partials and releases the rest.
__device__ __forceinline__ Scale grid_amax(unsigned m, GridState* state,
                                           float* __restrict__ scale_out) {
  __shared__ unsigned last, amax;
  unsigned* partials = reinterpret_cast<unsigned*>(state) + kStateWords;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    const unsigned gen = *reinterpret_cast<volatile unsigned*>(&state->generation);
    __threadfence();  // the partial and the generation read before the arrival
    last = atomicAdd(&state->arrived, 1u) == gridDim.x - 1;
    if (!last) {
      while (*reinterpret_cast<volatile unsigned*>(&state->generation) == gen) __nanosleep(32);
      __threadfence();
      amax = *reinterpret_cast<volatile unsigned*>(&state->amax);
    }
  }
  __syncthreads();
  if (last) {
    __threadfence();
    unsigned r = 0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) r = max(r, __ldcg(partials + i));
    r = block_max(r);
    if (threadIdx.x == 0) {
      amax = r;
      const float a = __uint_as_float(r);
      scale_out[0] = a > 0.0f ? __fmul_rn(a, kInv127) : 1.0f;
      state->amax = r;
      state->arrived = 0;
      __threadfence();
      atomicAdd(&state->generation, 1u);
    }
    __syncthreads();
  }
  const float a = __uint_as_float(amax);
  return make_scale(a > 0.0f ? __fmul_rn(a, kInv127) : 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, GridState* state, int n, int aligned,
                     int nhwc, int c, int h, int w, int sb, int sc, int sh, int sw) {
  const int stride = gridDim.x * kThreads;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int chunks = aligned ? n / kVec<T> : 0;  // 16-byte chunks, where x is aligned
  const int turns = (chunks + kUnroll * stride - 1) / (kUnroll * stride);
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  // the amax: chunk turn * kUnroll * stride + u * stride + gtid, turns ascending
  unsigned m = 0;
  for (int turn = 0; turn < turns; ++turn) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = (long long)turn * kUnroll * stride + u * stride + gtid;
      if (i < chunks) raw[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = (long long)turn * kUnroll * stride + u * stride + gtid;
      if (i >= chunks) continue;
      const T* v = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int j = 0; j < kVec<T>; ++j) m = max(m, abs_bits(v[j]));
    }
  }
  for (int i = chunks * kVec<T> + gtid; i < n; i += stride) m = max(m, abs_bits(x[i]));
  const Scale scale = grid_amax(block_max(m), state, scale_out);

  if (aligned && nhwc) {  // x's storage is q's order: the same walk, turns descending
    for (int i = chunks * kVec<T> + gtid; i < n; i += stride) q[i] = quantize(widen(x[i]), scale);
    for (int turn = turns - 1; turn >= 0; --turn) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = kUnroll - 1; u >= 0; --u) {
        const long long i = (long long)turn * kUnroll * stride + u * stride + gtid;
        if (i < chunks) raw[u] = xv[i];
      }
#pragma unroll
      for (int u = kUnroll - 1; u >= 0; --u) {
        const long long i = (long long)turn * kUnroll * stride + u * stride + gtid;
        if (i >= chunks) continue;
        const T* v = reinterpret_cast<const T*>(&raw[u]);
        union { int8_t b[kVec<T>]; uint32_t w[kVec<T> / 4]; } out;
#pragma unroll
        for (int j = 0; j < kVec<T>; ++j) out.b[j] = quantize(widen(v[j]), scale);
        if constexpr (kVec<T> == 8) {
          reinterpret_cast<uint2*>(q)[i] = make_uint2(out.w[0], out.w[1]);
        } else {
          reinterpret_cast<uint32_t*>(q)[i] = out.w[0];
        }
      }
    }
  } else {  // q[i] in NHWC order, x read through its strides, i descending
    for (int i = n - 1 - gtid; i >= 0; i -= stride) {
      int t = i;
      const int ci = t % c; t /= c;
      const int wi = t % w; t /= w;
      const int hi = t % h;
      const int bi = t / h;
      q[i] = quantize(widen(x[(long long)bi * sb + (long long)ci * sc + (long long)hi * sh +
                               (long long)wi * sw]), scale);
    }
  }
}

template <typename T>
int grid_for(int n) {
  static int resident[64];  // blocks the card holds at once, by device (0: not yet asked)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_int8_kernel<T>,
                                                        kThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    resident[dev] = per_sm * sms;
  }
  // no more blocks than a turn of kUnroll chunks a thread needs
  const long long chunks = ((long long)n + kVec<T> - 1) / kVec<T>;
  const long long wanted = (chunks + (long long)kUnroll * kThreads - 1) / (kUnroll * kThreads);
  return (int)(wanted < 1 ? 1 : wanted < resident[dev] ? wanted : resident[dev]);
}

template <typename T>
int launch(const void* x, void* q, void* scale, void* state, int state_words, int b, int c,
           int h, int w, int sb, int sc, int sh, int sw, cudaStream_t stream) {
  const int n = b * c * h * w;
  const int grid = grid_for<T>(n);
  if (grid < 0) return -grid;
  if (grid > state_words - kStateWords) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  GridState* gp = static_cast<GridState*>(state);
  int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int nhwc = sc == 1 && sw == c && sh == w * c && sb == h * w * c;
  void* args[] = {&xp, &qp, &sp, &gp, const_cast<int*>(&n), &aligned, &nhwc, &c, &h, &w,
                  &sb, &sc, &sh, &sw};
  return (int)cudaLaunchCooperativeKernel((const void*)quantize_int8_kernel<T>, dim3(grid),
                                          dim3(kThreads), args, 0, stream);
}

// One K5 call, as quantize_int8 packs it (64 bits a field)
struct QuantArgs {
  uint64_t x, q, scale, state, stream;
  long long device, state_words, is_bf16, b, c, h, w, sb, sc, sh, sw;
};

}  // namespace

// n elements of the given type -> blocks of a fdt_quantize_int8 call on the
// current device (the state buffer holds kStateWords + blocks words); < 0:
// a CUDA error, negated
extern "C" int fdt_quantize_int8_grid(int n, int is_bf16) {
  return is_bf16 ? grid_for<__nv_bfloat16>(n) : grid_for<float>(n);
}

// The packed QuantArgs: x [b, c, h, w] float32 (is_bf16 0) or bfloat16
// (1), dense (NCHW or channels-last), element strides sb, sc, sh, sw, fewer
// than 2^31 elements; q [b, h, w, c] int8, 16-byte aligned; scale one
// float32; state state_words 32-bit words, at least 4 +
// fdt_quantize_int8_grid(n, is_bf16), zero when first allocated, then left
// to this function (one buffer a device and stream); x's device.  Returns a
// CUDA error code (0: launched).
extern "C" int fdt_quantize_int8(const void* packed) {
  const QuantArgs a = read_args<QuantArgs>(packed);
  if (a.b < 1 || a.c < 1 || a.h < 1 || a.w < 1 || a.b * a.c * a.h * a.w >= (1LL << 31) ||
      a.q % 16)
    return (int)cudaErrorInvalidValue;
  const void* x = reinterpret_cast<const void*>(a.x);
  void* q = reinterpret_cast<void*>(a.q);
  void* scale = reinterpret_cast<void*>(a.scale);
  void* state = reinterpret_cast<void*>(a.state);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const int b = (int)a.b, c = (int)a.c, h = (int)a.h, w = (int)a.w;
  const int sb = (int)a.sb, sc = (int)a.sc, sh = (int)a.sh, sw = (int)a.sw;
  return on_device(a.device, [&] {
    return a.is_bf16 ? launch<__nv_bfloat16>(x, q, scale, state, (int)a.state_words, b, c, h, w,
                                             sb, sc, sh, sw, s)
                     : launch<float>(x, q, scale, state, (int)a.state_words, b, c, h, w, sb,
                                     sc, sh, sw, s);
  });
}
