// K4: int8 x int8 -> int32 convolution with fdt's dequantization epilogue.
//
// Replaces XLA's int8 conv_general_dilated and the scaling after it in
// fdt/ops/quant.py::Int8Conv (fdt/ops/quant.py:122-133; not a Pallas kernel):
//   acc[m, n]  = sum_k xq[patch(m), k] * wq[n, k]              (int32, exact)
//   y[m, n]    = round_to_out(float(acc) * (sx * sw[n]))  (+ bias[n] in out dtype)
// The plain version is fdt_torch/ops/quant.py::conv_int8_plain (float64
// F.conv2d on the int8 values, then the same epilogue); this kernel is
// bit-equal to it: the int32 sums are exact in any order, and the epilogue
// rounds with __int2float_rn / __fmul_rn / __fadd_rn in fdt's order
// (the library is built with -fmad=false as well).
//
// Implicit GEMM over an NHWC int8 activation: M = B*Ho*Wo output pixels,
// N = Cout/groups, K = kh*kw*Cin/groups in (kh, kw, cin) order, the weights
// packed [groups][Ngp][Kp] with N and K zero-padded to the block tile
// (fdt_torch/ops/quant.py::pack_weight), so B tiles load unmasked.
//
// Bound: operations for the wide 3x3 convs (2*M*N*K at the H100's 1,979
// dense int8 TOP/s), bytes for the 1x1 convs of few channels and the heads.
// Design: a block of 4 warps computes a 128 x 64 tile of the output, each
// warp 64 x 32 by mma.sync.m16n8k32 (s8 x s8 -> s32) from shared memory;
// K advances 32 bytes a step through two shared-memory buffers, the next
// step's global loads in registers while the tensor cores run the current
// one (one barrier a step).  Each thread gathers one row of the A tile (one
// output pixel's patch) in 16-byte, 4-byte or 1-byte pieces, the widest the
// channels per group allow (16 | Cg, 4 | Cg, else the 3-channel stems), with
// zeros for padding, K past the end and rows past M.  Shared-memory rows are
// 48 bytes so that the fragment loads of a warp hit 32 distinct banks.
// The epilogue writes through the output's strides (channels-last for the
// bf16 models, NCHW for float32).  wgmma with TMA is a later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int kRow = 48;  // bytes of one tile row in shared memory

struct Geom {
  int h, w, c;              // input NHWC (the batch is in m)
  int ho, wo;
  int kw, sh, sw, ph, pw, dh, dw;
  int cg, ng, ngp, k, kp;   // per group: channels in, channels out (and padded), K (and padded)
  int m;                    // b * ho * wo
  long long osb, osc, osh, osw;  // output strides, elements
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One thread's A row for the K step at k0: 32 bytes of the patch of output
// pixel (bi, hi0 / wi0 its window's corner), as 8 words.
template <int VEC>
__device__ __forceinline__ void load_a(const int8_t* __restrict__ x, const Geom& g, int grp,
                                       int k0, bool row_ok, int bi, int hi0, int wi0,
                                       uint32_t (&r)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = 0u;
  if (!row_ok) return;
  const int kwc = g.kw * g.cg;
#pragma unroll
  for (int j = 0; j < BK / VEC; ++j) {
    const int k = k0 + j * VEC;
    if (k >= g.k) break;
    const int kr = k / kwc;
    const int rem = k - kr * kwc;
    const int ks = rem / g.cg;
    const int ci = rem - ks * g.cg;
    const int hi = hi0 + kr * g.dh;
    const int wi = wi0 + ks * g.dw;
    if (hi < 0 || hi >= g.h || wi < 0 || wi >= g.w) continue;
    const int8_t* p = x + (((long long)bi * g.h + hi) * g.w + wi) * g.c + grp * g.cg + ci;
    if constexpr (VEC == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      r[4 * j] = v.x; r[4 * j + 1] = v.y; r[4 * j + 2] = v.z; r[4 * j + 3] = v.w;
    } else if constexpr (VEC == 4) {
      r[j] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      r[j >> 2] |= (uint32_t)(uint8_t)(*p) << (8 * (j & 3));
    }
  }
}

template <int VEC, typename OUT>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                 const int8_t* __restrict__ wpack, const float* __restrict__ sw,
                 const OUT* __restrict__ bias, OUT* __restrict__ out, Geom g) {
  __shared__ __align__(16) uint8_t As[2][BM * kRow];
  __shared__ __align__(16) uint8_t Bs[2][BN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;    // mma fragment group and thread-in-group
  const int wm = warp & 1, wn = warp >> 1;    // the warp's 64 x 32 sub-tile
  const int n_blocks = g.ngp / BN;
  const int grp = blockIdx.y / n_blocks;
  const int n0 = (blockIdx.y % n_blocks) * BN;
  const int m0 = blockIdx.x * BM;

  // this thread's A row: output pixel m0 + tid
  const int m_row = m0 + tid;
  const bool row_ok = m_row < g.m;
  int bi = 0, hi0 = 0, wi0 = 0;
  if (row_ok) {
    const int hw = g.ho * g.wo;
    bi = m_row / hw;
    const int rem = m_row - bi * hw;
    const int oh = rem / g.wo;
    const int ow = rem - oh * g.wo;
    hi0 = oh * g.sh - g.ph;
    wi0 = ow * g.sw - g.pw;
  }
  // this thread's B piece: 16 bytes of weight row n0 + tid / 2
  const int8_t* wrow = wpack + ((long long)grp * g.ngp + n0 + (tid >> 1)) * g.kp + 16 * (tid & 1);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  uint32_t ra[8];
  uint4 rb;
  const int steps = g.kp / BK;
  load_a<VEC>(x, g, grp, 0, row_ok, bi, hi0, wi0, ra);
  rb = *reinterpret_cast<const uint4*>(wrow);
  {
    uint4* ad = reinterpret_cast<uint4*>(&As[0][tid * kRow]);
    ad[0] = make_uint4(ra[0], ra[1], ra[2], ra[3]);
    ad[1] = make_uint4(ra[4], ra[5], ra[6], ra[7]);
    *reinterpret_cast<uint4*>(&Bs[0][(tid >> 1) * kRow + 16 * (tid & 1)]) = rb;
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) {
      load_a<VEC>(x, g, grp, (step + 1) * BK, row_ok, bi, hi0, wi0, ra);
      rb = *reinterpret_cast<const uint4*>(wrow + (step + 1) * BK);
    }
    uint32_t bf[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* bp = &Bs[cur][(wn * 32 + ni * 8 + gq) * kRow + 4 * tq];
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint8_t* ap = &As[cur][(wm * 64 + mi * 16 + gq) * kRow + 4 * tq];
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(ap);
      af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow);
      af[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kRow + 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
    }
    if (more) {
      uint4* ad = reinterpret_cast<uint4*>(&As[cur ^ 1][tid * kRow]);
      ad[0] = make_uint4(ra[0], ra[1], ra[2], ra[3]);
      ad[1] = make_uint4(ra[4], ra[5], ra[6], ra[7]);
      *reinterpret_cast<uint4*>(&Bs[cur ^ 1][(tid >> 1) * kRow + 16 * (tid & 1)]) = rb;
    }
    __syncthreads();
  }

  // epilogue: accumulator (mi, ni, e) is row gq (+8 for e >= 2), column
  // 2 * tq + (e & 1) of the warp's 16 x 8 piece (mi, ni)
  const float sxv = *sx;
  const int hw = g.ho * g.wo;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + gq + 8 * half;
      if (m >= g.m) continue;
      const int ob = m / hw;
      const int rem = m - ob * hw;
      const int oh = rem / g.wo;
      const int ow = rem - oh * g.wo;
      OUT* orow = out + ob * g.osb + oh * g.osh + ow * g.osw;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq + e;
          if (n >= g.ng) continue;
          const int ch = grp * g.ng + n;
          const float s = __fmul_rn(sxv, sw[ch]);
          const float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]), s);
          if constexpr (sizeof(OUT) == 2) {
            __nv_bfloat16 y = __float2bfloat16_rn(v);
            if (bias) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(bias[ch])));
            orow[ch * g.osc] = y;
          } else {
            orow[ch * g.osc] = bias ? __fadd_rn(v, bias[ch]) : v;
          }
        }
      }
    }
  }
}

template <typename OUT>
int launch(int vec, const void* x, const void* sx, const void* w, const void* sw,
           const void* bias, void* out, const Geom& g, int groups, cudaStream_t stream) {
  const dim3 grid((g.m + BM - 1) / BM, groups * (g.ngp / BN));
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* swp = static_cast<const float*>(sw);
  const auto* bp = static_cast<const OUT*>(bias);
  auto* op = static_cast<OUT*>(out);
  if (vec == 16)
    conv_int8_kernel<16, OUT><<<grid, kThreads, 0, stream>>>(xp, sxp, wp, swp, bp, op, g);
  else if (vec == 4)
    conv_int8_kernel<4, OUT><<<grid, kThreads, 0, stream>>>(xp, sxp, wp, swp, bp, op, g);
  else
    conv_int8_kernel<1, OUT><<<grid, kThreads, 0, stream>>>(xp, sxp, wp, swp, bp, op, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, h, w, c] int8 contiguous; sx: one float32; wpack: int8 [groups][ngp][kp]
// (pack_weight); sw: [groups * ng] float32; bias: [groups * ng] of the output
// type, or null; out: [b, groups * ng, ho, wo] float32 (out_bf16 0) or
// bfloat16 (1) with element strides osb, osc, osh, osw.  Returns a CUDA
// error code (0: launched).
extern "C" int fdt_conv_int8(const void* x, const void* sx, const void* wpack, const void* sw,
                             const void* bias, void* out, int b, int h, int w, int c, int ho,
                             int wo, int kh, int kw, int sh, int sw_, int ph, int pw, int dh,
                             int dw, int groups, int n, int ngp, int kp, long long osb,
                             long long osc, long long osh, long long osw, int out_bf16,
                             void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 || groups < 1 || c % groups ||
      n % groups || ngp % BN || kp % BK)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.h = h; g.w = w; g.c = c; g.ho = ho; g.wo = wo;
  g.kw = kw; g.sh = sh; g.sw = sw_; g.ph = ph; g.pw = pw; g.dh = dh; g.dw = dw;
  g.cg = c / groups; g.ng = n / groups; g.ngp = ngp; g.k = kh * kw * g.cg; g.kp = kp;
  const long long m = (long long)b * ho * wo;
  if (g.ng > ngp || g.k > kp || m >= (1LL << 31) || (m + BM - 1) / BM > 2147483647LL ||
      (long long)groups * (ngp / BN) > 65535)
    return (int)cudaErrorInvalidValue;
  g.m = (int)m;
  g.osb = osb; g.osc = osc; g.osh = osh; g.osw = osw;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int vec = (g.cg % 16 == 0 && c % 16 == 0 && xa % 16 == 0) ? 16
                : (g.cg % 4 == 0 && c % 4 == 0 && xa % 4 == 0) ? 4 : 1;
  if (reinterpret_cast<uintptr_t>(wpack) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(vec, x, sx, wpack, sw, bias, out, g, groups, s)
                  : launch<float>(vec, x, sx, wpack, sw, bias, out, g, groups, s);
}
