// K4: int8 x int8 -> int32 convolution with fdt's dequantization epilogue.
//
// Replaces XLA's int8 conv_general_dilated and the scaling after it in
// fdt/ops/quant.py::Int8Conv (fdt/ops/quant.py:122-133; not a Pallas kernel):
//   acc[m, n]  = sum_k xq[patch(m), k] * wq[n, k]              (int32, exact)
//   y[m, n]    = round_to_out(float(acc) * (sx * sw[n]))  (+ bias[n] in out dtype)
// The plain version is fdt_torch/ops/quant.py::conv_int8_plain (float64
// F.conv2d on the int8 values, then the same epilogue); both variants below
// are bit-equal to it: the int32 sums are exact in any order, and the
// epilogue rounds with __int2float_rn / __fmul_rn / __fadd_rn in fdt's order
// (the library is built with -fmad=false as well).
//
// Implicit GEMM over an NHWC int8 activation: M = B*Ho*Wo output pixels,
// N = Cout/groups, K = kh*kw*Cin/groups in (kh, kw, cin) order.  The weights
// are packed once (fdt_torch/ops/quant.py::pack_weight) K-chunk-major,
// [groups][Kp/16][Ngp][16]: 16 bytes of K of every output channel side by
// side, N and K zero-padded (Ngp to 64, Kp to 64), so that one weight tile of
// a 16-byte K chunk is one contiguous run of rows.
//
// Bound: operations for the wide 3x3 and 1x1 convs (2*M*N*K at the H100's
// 1,979 dense int8 TOP/s), bytes for the 1x1 convs of few channels and the
// heads (N = 4).  The wrapper picks the variant by geometry
// (quant.py::conv_variant): conv_int8_wgmma_kernel wherever a 16-byte piece
// of a patch row lies inside one tap (Cin a multiple of 16), groups == 1 and
// the activation 16-byte aligned; the first kernel, conv_int8_kernel, for
// the rest (the 3-channel stems, grouped convs, views that are not aligned).
//
// conv_int8_wgmma_kernel<BN> (the main variant): a persistent grid, one block
// of three warpgroups an SM, walking 128 x BN output tiles (BN fitted to N:
// 8, 64, 128 or 256).  Warpgroups 0 and 1 each own 64 rows of a tile and run
// wgmma.mma_async m64nBNk32 s8 x s8 -> s32 from shared memory, both operands
// K-major without swizzle (8-row x 16-byte core matrices: a stage holds A as
// [4 chunks][128 rows][16 B] and B as [4 chunks][BN rows][16 B]).  Warpgroup
// 2 keeps a ring of kStages stages of 64 bytes of K full, each guarded by a
// full and an empty mbarrier: its thread 0 brings each weight chunk by one
// bulk copy of the TMA unit (cp.async.bulk, completion counted in bytes on
// the full barrier; the packed layout makes a tile's chunk contiguous, so no
// tensor map is needed), and its 128 threads gather the A rows by 16-byte
// cp.async with zero fill at the image's edge, past K and past M, four
// neighbouring threads on a row's 64 bytes so that every 32-byte sector read
// is used whole (a per-tap plan: the tap and channel advance by addition, no
// division in the loop).  The activation is not loaded by TMA: a 128-row
// tile of output pixels is not a box of the NHWC tensor where Wo does not
// divide 128, and stride 2 would need im2col mode; a row's address is one
// add from its tap.  The consumers keep one wgmma group in flight and free a
// stage when the group after it is issued.  Epilogue: sx * sw[n] (and the
// bias) staged once a tile per column in shared memory; dequantized in fdt's
// order; for a bf16 channels-last output the tile is staged in shared memory
// and written by 16-byte stores (a tile's rows are contiguous in y), else
// (float32 NCHW, N not a multiple of 8) stored element by element through
// the output's strides.
//
// conv_int8_kernel<VEC, OUT> (the first kernel, the fallback): a block of 4
// warps computes a 128 x 64 tile by mma.sync.m16n8k32 from shared memory,
// K advancing 32 bytes a step through two buffers staged in registers; each
// thread gathers one row of the A tile in 16-, 4- or 1-byte pieces, the
// widest the channels per group allow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_args.cuh"

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
  // this thread's B piece: 16 bytes of weight row n0 + tid / 2, K chunk
  // 2 * step + (tid & 1) of the K-chunk-major weights; a step is 2 chunks on
  const int8_t* wrow = wpack + (((long long)grp * (g.kp / 16) + (tid & 1)) * g.ngp + n0 +
                                (tid >> 1)) * 16;
  const long long wstep = 2LL * g.ngp * 16;

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
      rb = *reinterpret_cast<const uint4*>(wrow + (step + 1) * wstep);
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


// ---- conv_int8_wgmma_kernel ----

constexpr int kWgThreads = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int kTileM = 128;
constexpr int kStageK = 64;      // bytes of K a stage
constexpr int kChunks = kStageK / 16;
constexpr int kStages = 6;
constexpr int kStageA = kTileM * kStageK;

// dynamic shared memory of a block: the ring, then each consumer
// warpgroup's output tile, column scales and biases, then the barriers
template <int BN>
struct WgSmem {
  static constexpr int kStageB = BN * kStageK;
  static constexpr int kPitch = 2 * BN + 16;  // a staged bf16 row; 16 spreads the banks
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kStageA;
  static constexpr int kOut = kB + kStages * kStageB;
  static constexpr int kScale = kOut + 2 * 64 * kPitch;
  static constexpr int kBias = kScale + 2 * BN * 4;
  static constexpr int kBar = kBias + 2 * BN * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8;
};

struct WgGeom {
  int h, w, c;                // input NHWC (the batch is in m)
  int ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int n, ngp, stages;         // output channels, padded weight rows, K stages (Kp / kStageK)
  int m, tiles_m, tiles;      // b * ho * wo; 128-row tiles; tiles (m-tiles x n-tiles)
  int dense;                  // bf16 output rows of n channels, m-contiguous, 16-byte aligned
  long long osb, osc, osh, osw;  // output strides, elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes of global memory to shared memory by the TMA unit, counted on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes, of which the first src_bytes (16 or 0) are read and the rest zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma's shared-memory operand: K-major, no swizzle; lbo the bytes from one
// 16-byte K chunk to the next, sbo from one 8-row group to the next
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d += A (64 x 32, s8) * B (N x 32, s8)^T; d as wgmma lays it out: thread t
// of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 (+ 8 for d[4j +
// 2], d[4j + 3]) and columns 8j + 2 * (t % 4) (+ 1 for d[4j + 1], d[4j + 3])
template <int N>
struct Wgmma;
template <> struct Wgmma<8> {
  __device__ static __forceinline__ void mma(int (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<128> {
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<256> {
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int BN>
__device__ __forceinline__ void wg_produce(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ wpack, const WgGeom& g,
                                           uint32_t base, uint32_t full, uint32_t empty) {
  using S = WgSmem<BN>;
  // Thread t brings 16-byte chunk j = t % 4 of a stage for rows t / 4 + 32i
  // (i < 4) of each tile: four neighbouring threads read a row's 64 bytes
  // of one stage together, so every 32-byte sector a warp reads is used
  // whole.  Chunk j of stage st is K chunk 4 st + j, whose tap (kr, ks) and
  // channel c0 this thread advances by 64 bytes a stage.
  const int t = threadIdx.x - 2 * 128;
  const int j = t & 3, r0 = t >> 2;
  constexpr int kRows = kTileM / 32;  // rows a thread
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int m0 = (tile % g.tiles_m) * kTileM, n0 = (tile / g.tiles_m) * BN;
    int hi0[kRows], wi0[kRows];
    long long row[kRows];  // x's offset of each row's window corner (may lie outside x)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + r0 + 32 * i;
      hi0[i] = -(1 << 30);  // past M: every tap out of bounds
      wi0[i] = 0;
      row[i] = 0;
      if (m < g.m) {
        const int hw = g.ho * g.wo;
        const int bi = m / hw;
        const int rem = m - bi * hw;
        const int oh = rem / g.wo;
        hi0[i] = oh * g.sh - g.ph;
        wi0[i] = (rem - oh * g.wo) * g.sw - g.pw;
        row[i] = ((static_cast<long long>(bi) * g.h + hi0[i]) * g.w + wi0[i]) * g.c;
      }
    }
    const int rows_b = min(BN, g.ngp - n0);
    // tap and channel of this thread's first chunk, K chunk j
    int kr = 0, ks = 0, c0 = 16 * j;
    while (c0 >= g.c) {
      c0 -= g.c;
      if (++ks == g.kw) { ks = 0; ++kr; }
    }
    for (int st = 0; st < g.stages; ++st) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t a_s = base + S::kA + stage * kStageA;
      const uint32_t b_s = base + S::kB + stage * S::kStageB;
      if (t == 0) {
        mbar_arrive_expect_tx(full + 8 * stage, kChunks * rows_b * 16);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          bulk_copy(b_s + c * BN * 16,
                    wpack + (static_cast<long long>(st * kChunks + c) * g.ngp + n0) * 16,
                    rows_b * 16, full + 8 * stage);
      }
      const long long tap = (static_cast<long long>(kr * g.dh) * g.w + ks * g.dw) * g.c + c0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int hi = hi0[i] + kr * g.dh, wi = wi0[i] + ks * g.dw;
        const bool ok = kr < g.kh && static_cast<unsigned>(hi) < static_cast<unsigned>(g.h) &&
                        static_cast<unsigned>(wi) < static_cast<unsigned>(g.w);
        cp_async16(a_s + (j * kTileM + r0 + 32 * i) * 16, ok ? x + row[i] + tap : x,
                   ok ? 16u : 0u);
      }
      cp_async_arrive(full + 8 * stage);
      c0 += kStageK;
      while (c0 >= g.c) {
        c0 -= g.c;
        if (++ks == g.kw) { ks = 0; ++kr; }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float widen_out(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

template <int BN>
__device__ __forceinline__ void wg_consume(const float* __restrict__ sx,
                                           const float* __restrict__ sw, const void* bias,
                                           void* out, int out_bf16, const WgGeom& g,
                                           uint8_t* smem, uint32_t base, uint32_t full,
                                           uint32_t empty) {
  using S = WgSmem<BN>;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);  // this thread's rows r0, r0 + 8
  const int cq = 2 * (tid & 3);                          // and columns 8j + cq, + 1
  const float sxv = *sx;
  float* scale = reinterpret_cast<float*>(smem + S::kScale) + wg * BN;
  float* bsm = reinterpret_cast<float*>(smem + S::kBias) + wg * BN;
  uint8_t* staged = smem + S::kOut + wg * 64 * S::kPitch;
  int stage = 0;
  uint32_t phase = 0;
  int acc[BN / 2];
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int m0 = (tile % g.tiles_m) * kTileM + 64 * wg, n0 = (tile / g.tiles_m) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = 0;
    for (int st = 0; st < g.stages; ++st) {
      mbar_wait(full + 8 * stage, phase);
      // A came by cp.async (the generic proxy); wgmma reads by the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a = base + S::kA + stage * kStageA + wg * 64 * 16;
      const uint32_t b = base + S::kB + stage * S::kStageB;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kStageK / 32; ++j)
        Wgmma<BN>::mma(acc, wg_desc(a + 2 * j * kTileM * 16, kTileM * 16, 128),
                       wg_desc(b + 2 * j * BN * 16, BN * 16, 128));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (st > 0 && tid == 0) mbar_arrive(empty + 8 * prev);  // its group has finished
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (tid == 0) mbar_arrive(empty + 8 * prev);

    // epilogue: the tile's column scales sx * sw[n] and biases, then fdt's
    // rounding, row r0 (+ 8) of this warpgroup's 64
    for (int i = tid; i < BN; i += 128) {
      const int n = n0 + i;
      scale[i] = n < g.n ? __fmul_rn(sxv, sw[n]) : 0.0f;
      bsm[i] = bias && n < g.n ? widen_out(bias, n, out_bf16) : 0.0f;
    }
    named_sync(1 + wg);
    if (g.dense) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + cq;
          __nv_bfloat16 y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), scale[col + e]);
            y[e] = __float2bfloat16_rn(v);
            if (bias) y[e] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y[e]), bsm[col + e]));
          }
          __nv_bfloat162 pair;
          pair.x = y[0];
          pair.y = y[1];
          *reinterpret_cast<__nv_bfloat162*>(staged + (r0 + 8 * h) * S::kPitch + 2 * col) = pair;
        }
      }
      named_sync(1 + wg);
      constexpr int kPieces = BN / 8;  // 16-byte pieces of a staged row
      const int cols = min(BN, g.n - n0);
      auto* o = static_cast<__nv_bfloat16*>(out);
      for (int i = tid; i < 64 * kPieces; i += 128) {
        const int r = i / kPieces, p = i % kPieces;
        if (m0 + r < g.m && 8 * p < cols)
          *reinterpret_cast<uint4*>(o + static_cast<long long>(m0 + r) * g.n + n0 + 8 * p) =
              *reinterpret_cast<const uint4*>(staged + r * S::kPitch + 16 * p);
      }
    } else {
      long long orow[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        ok[h] = m < g.m;
        const int hw = g.ho * g.wo;
        const int ob = m / hw;
        const int rem = m - ob * hw;
        const int oh = rem / g.wo;
        orow[h] = ob * g.osb + oh * g.osh + (rem - oh * g.wo) * g.osw;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + cq + e, n = n0 + col;
            if (!ok[h] || n >= g.n) continue;
            const float v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), scale[col]);
            const long long at = orow[h] + n * g.osc;
            if (out_bf16) {
              __nv_bfloat16 y = __float2bfloat16_rn(v);
              if (bias) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), bsm[col]));
              static_cast<__nv_bfloat16*>(out)[at] = y;
            } else {
              static_cast<float*>(out)[at] = bias ? __fadd_rn(v, bsm[col]) : v;
            }
          }
        }
      }
    }
    named_sync(1 + wg);  // scales, biases and the staged tile are free again
  }
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
conv_int8_wgmma_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                       const int8_t* __restrict__ wpack, const float* __restrict__ sw,
                       const void* bias, void* out, int out_bf16, WgGeom g) {
  using S = WgSmem<BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + S::kBar, empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTileM + 1);  // the producers' cp.async arrivals, thread 0's bytes
      mbar_init(empty + 8 * s, 2);          // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 2 * 128)
    wg_produce<BN>(x, wpack, g, base, full, empty);
  else
    wg_consume<BN>(sx, sw, bias, out, out_bf16, g, smem, base, full, empty);
}

template <int BN>
int launch_wgmma(const void* x, const void* sx, const void* w, const void* sw, const void* bias,
                 void* out, int out_bf16, const WgGeom& g, cudaStream_t stream) {
  const int bytes = WgSmem<BN>::kBytes;
  static int sms_of[64];  // SMs of each device, once the kernel may take `bytes` there
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    int sms = 0;
    err = cudaFuncSetAttribute(conv_int8_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  conv_int8_wgmma_kernel<BN><<<min(g.tiles, sms_of[dev]), kWgThreads, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw), bias, out, out_bf16, g);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// x: [b, h, w, c] int8 contiguous; sx: one float32; wpack: int8
// [groups][kp / 16][ngp][16] (pack_weight); sw: [groups * ng] float32; bias: [groups * ng] of the output
// type, or null; out: [b, groups * ng, ho, wo] float32 (out_bf16 0) or
// bfloat16 (1) with element strides osb, osc, osh, osw.  Returns a CUDA
// error code (0: launched).
int conv_mma_sync(const void* x, const void* sx, const void* wpack, const void* sw,
                  const void* bias, void* out, int b, int h, int w, int c, int ho, int wo, int kh,
                  int kw, int sh, int sw_, int ph, int pw, int dh, int dw, int groups, int n,
                  int ngp, int kp, long long osb, long long osc, long long osh, long long osw,
                  int out_bf16, void* stream) {
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

// The wgmma variant, groups 1: the arguments of conv_mma_sync less groups,
// plus tile_n (8, 64, 128 or 256), with c a multiple of 16, x and wpack
// 16-byte aligned, kp a multiple of 64.  Returns a CUDA error code.
int conv_wgmma(const void* x, const void* sx, const void* wpack, const void* sw,
               const void* bias, void* out, int b, int h, int w, int c, int ho, int wo, int kh,
               int kw, int sh, int sw_, int ph, int pw, int dh, int dw, int n, int ngp, int kp,
               long long osb, long long osc, long long osh, long long osw, int out_bf16,
               int tile_n, void* stream) {
  const long long m = (long long)b * ho * wo;
  if (b < 1 || h < 1 || w < 1 || c < 16 || c % 16 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      n < 1 || ngp < n || kp % kStageK || (long long)kh * kw * c > kp || m >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wpack) % 16)
    return (int)cudaErrorInvalidValue;
  WgGeom g;
  g.h = h; g.w = w; g.c = c; g.ho = ho; g.wo = wo;
  g.kh = kh; g.kw = kw; g.sh = sh; g.sw = sw_; g.ph = ph; g.pw = pw; g.dh = dh; g.dw = dw;
  g.n = n; g.ngp = ngp; g.stages = kp / kStageK;
  g.m = (int)m;
  g.tiles_m = (int)((m + kTileM - 1) / kTileM);
  const long long tiles = (long long)g.tiles_m * ((n + tile_n - 1) / tile_n);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.osb = osb; g.osc = osc; g.osh = osh; g.osw = osw;
  g.dense = out_bf16 && osc == 1 && osw == n && osh == (long long)wo * n &&
            osb == (long long)ho * wo * n && n % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 8: return launch_wgmma<8>(x, sx, wpack, sw, bias, out, out_bf16, g, s);
    case 64: return launch_wgmma<64>(x, sx, wpack, sw, bias, out, out_bf16, g, s);
    case 128: return launch_wgmma<128>(x, sx, wpack, sw, bias, out, out_bf16, g, s);
    case 256: return launch_wgmma<256>(x, sx, wpack, sw, bias, out, out_bf16, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One K4 call: the fields of both entries, as conv_int8 packs them (64 bits
// each; groups 1 and tile_n 0 where an entry does not read them)
struct ConvArgs {
  uint64_t x, sx, wpack, wscale, bias, out, stream;  // wscale: sw, the weights' scales
  long long device, b, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw, groups, n, ngp, kp;
  long long osb, osc, osh, osw, out_bf16, tile_n;
};

}  // namespace

// K4's mma_sync variant on the packed ConvArgs.  Returns a CUDA error code
// (0: launched).
extern "C" int fdt_conv_int8(const void* packed) {
  const ConvArgs a = read_args<ConvArgs>(packed);
  return on_device(a.device, [&] {
    return conv_mma_sync(
        reinterpret_cast<const void*>(a.x), reinterpret_cast<const void*>(a.sx),
        reinterpret_cast<const void*>(a.wpack), reinterpret_cast<const void*>(a.wscale),
        reinterpret_cast<const void*>(a.bias), reinterpret_cast<void*>(a.out), (int)a.b,
        (int)a.h, (int)a.w, (int)a.c, (int)a.ho, (int)a.wo, (int)a.kh, (int)a.kw, (int)a.sh,
        (int)a.sw, (int)a.ph, (int)a.pw, (int)a.dh, (int)a.dw, (int)a.groups, (int)a.n,
        (int)a.ngp, (int)a.kp, a.osb, a.osc, a.osh, a.osw, (int)a.out_bf16,
        reinterpret_cast<void*>(a.stream));
  });
}

// K4's wgmma variant on the packed ConvArgs (groups 1).  Returns a CUDA
// error code (0: launched).
extern "C" int fdt_conv_int8_wgmma(const void* packed) {
  const ConvArgs a = read_args<ConvArgs>(packed);
  if (a.groups != 1) return (int)cudaErrorInvalidValue;
  return on_device(a.device, [&] {
    return conv_wgmma(
        reinterpret_cast<const void*>(a.x), reinterpret_cast<const void*>(a.sx),
        reinterpret_cast<const void*>(a.wpack), reinterpret_cast<const void*>(a.wscale),
        reinterpret_cast<const void*>(a.bias), reinterpret_cast<void*>(a.out), (int)a.b,
        (int)a.h, (int)a.w, (int)a.c, (int)a.ho, (int)a.wo, (int)a.kh, (int)a.kw, (int)a.sh,
        (int)a.sw, (int)a.ph, (int)a.pw, (int)a.dh, (int)a.dw, (int)a.n, (int)a.ngp,
        (int)a.kp, a.osb, a.osc, a.osh, a.osw, (int)a.out_bf16, (int)a.tile_n,
        reinterpret_cast<void*>(a.stream));
  });
}

// Bytes of dynamic shared memory a block of the wgmma variant takes at
// tile_n (8, 64, 128 or 256); 0 for another tile_n.
extern "C" int fdt_conv_int8_wgmma_smem(int tile_n) {
  switch (tile_n) {
    case 8: return WgSmem<8>::kBytes;
    case 64: return WgSmem<64>::kBytes;
    case 128: return WgSmem<128>::kBytes;
    case 256: return WgSmem<256>::kBytes;
    default: return 0;
  }
}

