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
// Bound: bytes.  Each element is read twice (once per pass; the second read
// mostly from L2 for the smaller maps) and one byte written; the arithmetic
// is a few operations an element.  Design: two launches on the caller's
// stream and no host read.  Pass 1 (amax_kernel) walks the dense storage in
// order (NCHW or channels-last alike: the max ignores the order), 16 bytes a
// load, a grid of at most kMaxPartials blocks, each writing the max of |x|'s
// bit patterns (a non-negative float orders as its bits, and a NaN's bits
// exceed +inf's, so a NaN propagates as jnp.max's does).  Pass 2: every
// block reduces those partials itself (no third launch, no atomics, no
// memset), block 0 writes the scale for K4, and the grid writes q in NHWC
// order.  A channels-last x (the bf16 models) is already in that order:
// quantize_dense_kernel reads 16 bytes and writes their 4 or 8 q at once; an
// NCHW x (float32), or one not 16-byte aligned (a view), goes through
// quantize_kernel, which reads x through its strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 528;   // 4 blocks on each of the H100's 132 SMs
constexpr int kMaxQuantBlocks = 2112;
constexpr int kPerThread = 16;      // elements a thread of pass 1 takes, at least
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
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, int n, bool aligned, unsigned* __restrict__ partials) {
  unsigned m = 0;
  const int step = gridDim.x * kThreads;
  const int chunks = aligned ? n / kVec<T> : 0;  // 16-byte loads where x is 16-byte aligned
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < chunks; i += step) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) m = max(m, __float_as_uint(fabsf(widen(v[j]))));
  }
  for (int i = chunks * kVec<T> + blockIdx.x * kThreads + threadIdx.x; i < n; i += step)
    m = max(m, __float_as_uint(fabsf(widen(x[i]))));
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// the scale from pass 1's partials; block 0 writes it for K4
__device__ __forceinline__ float reduce_scale(const unsigned* __restrict__ partials,
                                              int n_partials, float* __restrict__ scale_out) {
  unsigned m = 0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) m = max(m, partials[i]);
  const float amax = __uint_as_float(block_max(m));
  const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  return scale;
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int8_t)(isnan(r) ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f));
}

// q[i] = quantize(x[i]): x channels-last, so its storage order is q's NHWC
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_dense_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scale_out, const unsigned* __restrict__ partials,
                      int n_partials, int n) {
  const float scale = reduce_scale(partials, n_partials, scale_out);
  const int step = gridDim.x * kThreads;
  const int chunks = n / kVec<T>;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < chunks; i += step) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const T* v = reinterpret_cast<const T*>(&raw);
    union { int8_t b[kVec<T>]; uint32_t w[kVec<T> / 4]; } out;
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) out.b[j] = quantize(widen(v[j]), scale);
    if constexpr (kVec<T> == 8) {
      reinterpret_cast<uint2*>(q)[i] = make_uint2(out.w[0], out.w[1]);
    } else {
      reinterpret_cast<uint32_t*>(q)[i] = out.w[0];
    }
  }
  for (int i = chunks * kVec<T> + blockIdx.x * kThreads + threadIdx.x; i < n; i += step)
    q[i] = quantize(widen(x[i]), scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale_out,
                const unsigned* __restrict__ partials, int n_partials,
                int b, int c, int h, int w, int sb, int sc, int sh, int sw) {
  const float scale = reduce_scale(partials, n_partials, scale_out);
  const int n = b * c * h * w;
  const int step = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    int t = i;
    const int ci = t % c; t /= c;
    const int wi = t % w; t /= w;
    const int hi = t % h;
    const int bi = t / h;
    q[i] = quantize(widen(x[bi * sb + ci * sc + hi * sh + wi * sw]), scale);
  }
}

int partials_for(int n) {
  const int blocks = (n + kThreads * kPerThread - 1) / (kThreads * kPerThread);  // >= 1 chunk a thread
  return blocks < 1 ? 1 : (blocks > kMaxPartials ? kMaxPartials : blocks);
}

template <typename T>
int launch(const void* x, void* q, void* scale, void* partials, int b, int c, int h, int w,
           int sb, int sc, int sh, int sw, cudaStream_t stream) {
  const int n = b * c * h * w;
  const int np = partials_for(n);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  amax_kernel<T><<<np, kThreads, 0, stream>>>(static_cast<const T*>(x), n, aligned,
                                              static_cast<unsigned*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool dense_nhwc = aligned && sc == 1 && sw == c && sh == w * c && sb == h * w * c;
  int blocks = (dense_nhwc ? n / kVec<T> + 1 + kThreads - 1 : n + kThreads - 1) / kThreads;
  if (blocks > kMaxQuantBlocks) blocks = kMaxQuantBlocks;
  if (dense_nhwc)
    quantize_dense_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale),
        static_cast<const unsigned*>(partials), np, n);
  else
    quantize_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale),
        static_cast<const unsigned*>(partials), np, b, c, h, w, sb, sc, sh, sw);
  return (int)cudaGetLastError();
}

}  // namespace

// n elements -> 32-bit words of the partials buffer fdt_quantize_int8 takes
extern "C" int fdt_quantize_int8_partials(int n) { return partials_for(n); }

// x: [b, c, h, w] float32 (is_bf16 0) or bfloat16 (1), dense (NCHW or
// channels-last), element strides sb, sc, sh, sw, fewer than 2^31 elements;
// q: [b, h, w, c] int8; scale: one float32; partials:
// fdt_quantize_int8_partials(n) words.
// Returns a CUDA error code (0: launched).
extern "C" int fdt_quantize_int8(const void* x, void* q, void* scale, void* partials,
                                 int is_bf16, int b, int c, int h, int w, int sb, int sc,
                                 int sh, int sw, void* stream) {
  if (b < 1 || c < 1 || h < 1 || w < 1 || (long long)b * c * h * w >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, q, scale, partials, b, c, h, w, sb, sc, sh, sw, s)
                 : launch<float>(x, q, scale, partials, b, c, h, w, sb, sc, sh, sw, s);
}
