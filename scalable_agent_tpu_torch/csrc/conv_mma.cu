// Hand-written Hopper (sm_90a) kernel for the shallow stem's bf16 weight
// gradient on tensor cores: SAME 8x8 / stride 4, C = 1, 3 or 4 channels
// into 32 features, x and g bf16, dW float32.  Its float32 counterpart,
// the band kernel, is in conv.cu.
//
// Replaces scalable_agent_tpu/ops/conv_pallas.py::_gradw_kernel at
// matmul_dtype="bfloat16" (the stem under compute_dtype=bfloat16): the same
// split-K product as conv.cu's band kernel, dW[64*C, 32] over P = N*OH*OW
// patch rows, with exact bf16 products summed in float32.  What bounds it
// on this card: the bytes.  At the main path's N=3232 frames of 72x96x3 it
// reads 0.22 GB of bf16 x and g (0.0667 ms at 3.35 TB/s) for 17.2 GFLOP,
// ~0.02 ms on bf16 tensor cores; the band kernel's FFMA loop, fed by a
// staging that converted bf16 to float through registers, took 0.70 ms.
//
// Design (conv_gradw_mma_kernel<C, XCHW, GCHW>; entry points
// sat_conv_gradw_bf16, sat_conv_gradw_c4_bf16, sat_conv_gradw_c1_bf16):
// * The contraction on mma.sync.m16n8k16 bf16 with float32 accumulators:
//     dW^T[32 features, 64*C taps] += G^T[32, 16 pixels] . P[16 pixels, 64*C]
//   two m16 tiles (the features) by 8*C n8 tiles (the taps), 16 output
//   pixels a step.  The whole [64*C, 32] tile would be 64*C accumulators a
//   thread, so the taps are split over kTapWarps warps (MmaTaps<C>: 4 at
//   C = 3 and 4, 2 at C = 1; 6, 8 and 4 n8 tiles a warp), and the
//   kPixGroups groups of them take every kPixGroups-th step of a unit.
//   wgmma's 64-row tiles are not needed: at mma.sync's rate the 17.2 GFLOP
//   take ~0.03 ms, under the bytes.
// * Units and staging.  A unit is a band of band_rows output rows of one
//   image or, where one band holds a whole image, `images` whole images
//   (16x16 frames: 4x4 outputs each).  x's rows, the K - S halo included,
//   and g's rows of a unit go raw, as they lie in memory (NHWC, or planar
//   for an NHWC view of NCHW memory), by cp.async of 16 bytes where their
//   alignment allows (8, 4 or 2 otherwise), into a ring of q.stages stages,
//   two blocks an SM (3 or 4 stages each at the frames the paths reach;
//   conv_cuda.gradw_mma_plan; on an H100 two blocks of 128 registers read
//   0.177 ms at the main path's N=3232 where one block of 246 read 0.208:
//   PERF.md, section 6).  The SAME column pads are zeroed once and never
//   written, the rows above or below the image per unit, so the inner loop
//   has no bounds checks.  A staged x row starts its data 16-byte aligned
//   (padded column 0 at element q.xo).
// * A (G^T) by ldmatrix.x4: NHWC g is [pixel][32] (64 bytes a pixel, its
//   16-byte chunk c stored at chunk c ^ ((pixel >> 1) & 3), so the 8 pixel
//   rows of an 8x8 load fall on distinct banks), read with .trans; planar g
//   is [feature][pixels], features q.gps apart (16 bytes mod 128), read
//   without.  The unit's pixels are one run in both: the 16 of a step are
//   consecutive, and past the unit's last pixel g is zeroed per unit.
// * B (patches) by 16-bit loads.  A pixel's patch row at (kh, kw-quad) is
//   4*C contiguous bf16 in NHWC, 8 bytes in a planar plane: not 16-byte
//   aligned for every pixel at C = 1 and 3, so ldmatrix cannot load it.
//   A table per unit (its last q.pix ints) gives each pixel's patch origin
//   in the staged x, so pixels of several rows and images take one step.
//   Lane (gid, t) holds column gid of each of its n8 tiles at the step's
//   pixels k = 2t, 2t+1, 2t+8, 2t+9: 4 loads and 2 packs a tile.  Tile T
//   is the dW rows 8T .. 8T+7 in NHWC (8 contiguous elements of one
//   pixel's patch row) and (kh, c) = (T / C, T % C) at kw = 0..7 in planar
//   x (8 contiguous elements of a plane row), so the 32 lanes of a load
//   read 4 runs of 8 elements and fall on distinct banks.  With NHWC g, k
//   is pixel 8*(k/8) + (k/2)%4 + 4*(k%2) of the step (a permutation that A
//   follows), which keeps the C = 4 loads on distinct banks too.  Per step
//   and 16 pixels: 2 ldmatrix.x4 a warp and 32*C 16-bit loads a block for
//   16*C mma.sync, ~1 shared-memory wavefront each: under the byte bound
//   at the main path's shape, but each load waits on a table load and an
//   mma on it, so the kernel is bound by that latency (2.6x its byte bound
//   at 72x96x3: PERF.md, section 6).
// * Deterministic: block b owns units [b*U/B, (b+1)*U/B) in order; each
//   warp accumulates its steps in order on the tensor cores (float32; a
//   fresh accumulator per unit cost the registers of the second block an
//   SM); the pixel groups are summed in index order through shared memory,
//   and the blocks' partials by reduce_partials_kernel in block order: two
//   calls give bitwise-equal dW.
// * At C = 1 an NHWC view of NCHW memory is contiguous NHWC memory, so
//   both layouts of x take the NHWC instantiation.

#include "conv_common.cuh"

namespace {

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
static_assert(kMmaThreads == kResThreads,
              "the staging helpers above spread their copies over a block "
              "of kResThreads");

template <int C>
struct MmaTaps {
  static constexpr int kTiles = kK * C;                 // n8 tiles of taps
  static constexpr int kTapWarps = C == 1 ? 2 : 4;      // warps of a step
  static constexpr int kPerWarp = kTiles / kTapWarps;   // n8 tiles a warp
  static constexpr int kPixGroups = kMmaWarps / kTapWarps;
  static constexpr int kOut = kK * kK * C * kF;         // dW entries
  static_assert(kPerWarp * kTapWarps == kTiles, "tiles split evenly");
};

struct MmaGeometry {
  long long N;            // images
  int H, W, OH, OW, pad_h, pad_w;
  int band_rows, bands;   // output rows per band, bands per image
  int images;             // images per unit (1 unless bands == 1)
  int xo;                 // element of padded column 0 in a staged x row
  int xrs;                // staged x row stride, elements
  int xplane;             // planar x: a channel's plane stride, else 0
  int ximg;               // staged x of one image
  int x_elems;            // staged x region of a unit
  int gps;                // planar g: a feature's plane stride, else 0
  int g_elems;            // staged g region of a unit
  int pix;                // table entries: a unit's pixels, to 16s
  int stage_elems;        // one stage: x + g regions + the table (bf16s)
  int stages;             // stages of the ring
};

// dW row (tap (kh*8 + kw)*C + c) of column n of n8 tile T, and the
// offset of its element from a pixel's patch origin in the staged x.
template <int C, bool XCHW>
__device__ __forceinline__ int mma_tap(int T, int n, const MmaGeometry& q,
                                       int* offset) {
  int kh, kw, c;
  if (XCHW) {
    kh = T / C;
    c = T % C;
    kw = n;
  } else {
    const int tau = 8 * T + n;
    kh = tau / (kK * C);
    kw = (tau / C) % kK;
    c = tau % C;
  }
  if (offset)
    *offset = XCHW ? c * q.xplane + kh * q.xrs + kw
                   : kh * q.xrs + kw * C + c;
  return (kh * kK + kw) * C + c;
}

// The pixel of a step that k (0..15) stands for: the identity with planar
// g, whose fragments come as they lie; with NHWC g, 8*(k/8) + (k/2)%4 +
// 4*(k%2), so a B load's lanes take pixels 4 apart in fewer banks.
template <bool GCHW>
__device__ __forceinline__ int mma_pixel(int k) {
  return GCHW ? k : 8 * (k >> 3) + ((k >> 1) & 3) + 4 * (k & 1);
}

// NHWC g of `pixels` consecutive pixels into [pixel][32] with chunk c of
// pixel p at chunk c ^ ((p >> 1) & 3).
__device__ __forceinline__ void mma_stage_g_hwc(bf16* gs, const bf16* src,
                                                int pixels) {
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int k = threadIdx.x; k < 4 * pixels; k += kMmaThreads) {
      const int p = k >> 2;
      cp_async16(gs + p * kF + 8 * ((k & 3) ^ ((p >> 1) & 3)), src + 8 * k);
    }
  } else {
    for (int i = threadIdx.x; i < pixels * kF; i += kMmaThreads) {
      const int p = i >> 5, f = i & 31;
      gs[p * kF + 8 * ((f >> 3) ^ ((p >> 1) & 3)) + (f & 7)] = src[i];
    }
  }
}

// Issues the copies of unit u into the stage at xs, zeroes its
// out-of-image x rows and g past its last pixel, and writes its table.
// Staged x of the unit's image i: padded row r, column pc, channel c at
// i*ximg + r*xrs + xo + C*pc + c (NHWC) or i*ximg + c*xplane + r*xrs +
// xo + pc (planar; ximg = C*xplane).  Staged g, from xs + x_elems: the
// unit's pixel p (image-major, then row, then column) and feature f at
// p*32 + 8*((f/8) ^ ((p/2)%4)) + f%8 (NHWC) or f*gps + p (planar).  Table,
// from xs + x_elems + g_elems: pixel p's patch origin (padded row 4*oh,
// column 4*ow of its image), and for p past the unit pixel 0's.
template <int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void mma_stage(bf16* xs, const bf16* x,
                                          const bf16* g, long long u,
                                          const MmaGeometry& q) {
  constexpr int px = XCHW ? 1 : C;  // elements per padded column
  const long long group = u / q.bands;
  const int band = static_cast<int>(u - group * q.bands);
  const long long n0 = group * q.images;
  const int imgs = static_cast<int>(
      min(static_cast<long long>(q.images), q.N - n0));
  const int oh0 = band * q.band_rows;
  const int rows = min(q.band_rows, q.OH - oh0);
  const int xr = (rows - 1) * kS + kK;  // padded input rows of the band
  const int ih0 = oh0 * kS - q.pad_h;
  const int lo = max(0, -ih0);          // first band row inside the image
  const int hi = min(xr, q.H - ih0);    // one past the last
  const long long hw = static_cast<long long>(q.H) * q.W;
  // x: a run of W*C a row and image (NHWC), of W a row, channel and image
  // (planar; an image's channels are consecutive planes).
  const int planes = XCHW ? imgs * C : imgs;
  const int dpl = XCHW ? q.xplane : q.ximg;
  res_zero_runs(xs, dpl, q.xrs, planes, 0, lo);
  res_zero_runs(xs, dpl, q.xrs, planes, hi, xr);
  res_runs(xs + lo * q.xrs + q.xo + q.pad_w * px, dpl, q.xrs,
           x + n0 * hw * C + static_cast<long long>(ih0 + lo) * q.W * px,
           XCHW ? hw : hw * C, static_cast<long long>(q.W) * px, planes,
           hi - lo, q.W * px);
  bf16* gs = xs + q.x_elems;
  const int pimg = rows * q.OW;
  const int pu = imgs * pimg;
  const int p16 = (pu + 15) & ~15;
  const long long ohw = static_cast<long long>(q.OH) * q.OW;
  const bf16 zero = __float2bfloat16(0.f);
  if (GCHW) {
    res_runs(gs, q.gps, pimg,
             g + n0 * kF * ohw + static_cast<long long>(oh0) * q.OW, ohw,
             kF * ohw, kF, imgs, pimg);
    const int tail = p16 - pu;
    for (int i = threadIdx.x; i < kF * tail; i += kMmaThreads)
      gs[(i / tail) * q.gps + pu + i % tail] = zero;
  } else {
    mma_stage_g_hwc(gs, g + (n0 * ohw + static_cast<long long>(oh0) * q.OW)
                                * kF, pu);
    for (int i = pu * kF + threadIdx.x; i < p16 * kF; i += kMmaThreads)
      gs[i] = zero;
  }
  int* table = reinterpret_cast<int*>(gs + q.g_elems);
  for (int p = threadIdx.x; p < p16; p += kMmaThreads) {
    int origin = q.xo;
    if (p < pu) {
      const int i = p / pimg, r = p - i * pimg;
      const int oh = r / q.OW, ow = r - oh * q.OW;
      origin += i * q.ximg + oh * kS * q.xrs + ow * kS * px;
    }
    table[p] = origin;
  }
}

template <int C, bool XCHW, bool GCHW>
__global__ void __launch_bounds__(kMmaThreads, 2)
    conv_gradw_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ g,
                          float* __restrict__ partial, MmaGeometry q,
                          long long units) {
  using L = MmaTaps<C>;
  extern __shared__ float4 mma_smem4[];
  bf16* smem = reinterpret_cast<bf16*>(mma_smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int tw = warp % L::kTapWarps;  // this warp's share of the taps
  const int pg = warp / L::kTapWarps;  // ... and of the steps
  const int S = q.stages;
  const long long u_begin = blockIdx.x * units / gridDim.x;
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;

  // Zero every stage once: the copies never write the pads.
  {
    uint4* s16 = reinterpret_cast<uint4*>(mma_smem4);
    const int n16 = S * q.stage_elems / 8;
    for (int i = tid; i < n16; i += kMmaThreads)
      s16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // B: the offset of column gid of each of this warp's tiles from a patch
  // origin, and the step's pixels of this lane's rows k = 2t, 2t+1, 2t+8,
  // 2t+9.  A: lane l addresses row l % 8 of matrix l / 8, the matrices
  // (features 0-7 | 8-15 of the m16 tile) x (k 0-7 | 8-15) in the order
  // a0..a3, relative to the step's first pixel.
  int toff[L::kPerWarp];
#pragma unroll
  for (int i = 0; i < L::kPerWarp; ++i)
    mma_tap<C, XCHW>(tw * L::kPerWarp + i, gid, q, &toff[i]);
  int kp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    kp[j] = mma_pixel<GCHW>(2 * t + (j & 1) + 8 * (j >> 1));
  const int mat = lane >> 3, r8 = lane & 7;
  int a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (GCHW) {
      a_off[mt] = (16 * mt + r8 + 8 * (mat & 1)) * q.gps + 8 * (mat >> 1);
    } else {
      const int p = mma_pixel<GCHW>(r8 + 8 * (mat >> 1));
      a_off[mt] = p * kF + 8 * (((mat & 1) + 2 * mt) ^ ((p >> 1) & 3));
    }
  }

  float acc[2][L::kPerWarp][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < L::kPerWarp; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][i][r] = 0.f;

  int slot_in = 0, slot_cur = 0;
  auto stage_next = [&](long long u) {
    if (u < u_end)
      mma_stage<C, XCHW, GCHW>(smem + slot_in * q.stage_elems, x, g, u, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (++slot_in == S) slot_in = 0;
  };
  for (int s = 0; s < S - 1; ++s) stage_next(u_begin + s);
  for (long long u = u_begin; u < u_end; ++u) {
    res_wait_pending(S - 2);  // this unit's copies have landed
    __syncthreads();          // ... every thread's, and the last stage is free
    stage_next(u + S - 1);
    const bf16* xs = smem + slot_cur * q.stage_elems;
    if (++slot_cur == S) slot_cur = 0;
    const long long group = u / q.bands;
    const int band = static_cast<int>(u - group * q.bands);
    const int imgs = static_cast<int>(
        min(static_cast<long long>(q.images), q.N - group * q.images));
    const int pu =
        imgs * min(q.band_rows, q.OH - band * q.band_rows) * q.OW;
    const int steps = (pu + 15) >> 4;
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(xs);
    const bf16* gs = xs + q.x_elems;
    const int* table = reinterpret_cast<const int*>(gs + q.g_elems);
    for (int st = pg; st < steps; st += L::kPixGroups) {
      const int k0 = st * 16;
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        res_ldmatrix_x4<!GCHW>(a[mt], gs + (GCHW ? k0 : k0 * kF) + a_off[mt]);
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = table[k0 + kp[j]];
#pragma unroll
      for (int i = 0; i < L::kPerWarp; ++i) {
        const unsigned v0 = xh[o[0] + toff[i]], v1 = xh[o[1] + toff[i]];
        const unsigned v2 = xh[o[2] + toff[i]], v3 = xh[o[3] + toff[i]];
        const unsigned b0 = v0 | (v1 << 16), b1 = v2 | (v3 << 16);
        res_mma(acc[0][i], a[0], b0, b1);
        res_mma(acc[1][i], a[1], b0, b1);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Accumulator r of tile (mt, i) is feature 16*mt + gid + 8*(r/2), column
  // 2t + r%2.  The pixel groups' sums meet in shared memory (the stages
  // are free now) and are added in group order.
  float* red = reinterpret_cast<float*>(mma_smem4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < L::kPerWarp; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tap = mma_tap<C, XCHW>(tw * L::kPerWarp + i,
                                         2 * t + (r & 1), q, nullptr);
        red[pg * L::kOut + tap * kF + 16 * mt + gid + 8 * (r >> 1)] =
            acc[mt][i][r];
      }
  __syncthreads();
  for (int o = tid; o < L::kOut; o += kMmaThreads) {
    float v = 0.f;
    for (int p = 0; p < L::kPixGroups; ++p) v += red[p * L::kOut + o];
    partial[static_cast<size_t>(blockIdx.x) * L::kOut + o] = v;
  }
}

template <int C, bool XCHW, bool GCHW>
cudaError_t launch_mma(const bf16* x, const bf16* g, float* partial,
                       const MmaGeometry& q, long long units, int num_blocks,
                       int smem_bytes, cudaStream_t s) {
  auto kernel = conv_gradw_mma_kernel<C, XCHW, GCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kMmaThreads, smem_bytes, s>>>(x, g, partial, q, units);
  return cudaGetLastError();
}

// Whether q describes the staged unit the kernel addresses at C channels
// (see conv_cuda.gradw_mma_plan), its ring and the pixel groups' final
// sums fitting in smem_bytes, over `units` units.
template <int C>
bool mma_layout_ok(const MmaGeometry& q, int smem_bytes, bool x_chw,
                   bool g_chw, long long units) {
  const int px = x_chw ? 1 : C;
  const int x_rows = (q.band_rows - 1) * kS + kK;
  const int p16 = (q.images * q.band_rows * q.OW + 15) & ~15;
  const int table = 2 * q.pix;  // ints, in bf16 elements
  if (q.H < 1 || q.W < 1 || q.N < 1 || q.band_rows < 1 ||
      q.OH != (q.H + kS - 1) / kS || q.OW != (q.W + kS - 1) / kS ||
      q.bands != (q.OH + q.band_rows - 1) / q.band_rows || q.images < 1 ||
      (q.bands > 1 && q.images > 1) ||
      units != (q.N + q.images - 1) / q.images * q.bands ||
      q.stages < 2 || q.stages > kResMaxStages || q.xo < 0 || q.pad_w < 0 ||
      q.pad_h < 0 || q.xrs % 8 || q.ximg % 8 || q.x_elems % 8 ||
      q.g_elems % 8 || q.stage_elems % 8 || q.pix % 16 || q.pix < p16 ||
      q.xrs < q.xo + (kS * q.OW + kS) * px ||
      q.x_elems < q.images * q.ximg ||
      q.stage_elems < q.x_elems + q.g_elems + table ||
      smem_bytes < q.stages * q.stage_elems * 2 ||
      smem_bytes < MmaTaps<C>::kPixGroups * MmaTaps<C>::kOut * 4)
    return false;
  const bool x_ok = x_chw ? q.xplane % 8 == 0 &&
                                q.xplane >= x_rows * q.xrs &&
                                q.ximg == C * q.xplane
                          : q.ximg >= x_rows * q.xrs;
  const bool g_ok = g_chw ? q.gps >= q.pix && q.g_elems >= kF * q.gps
                          : q.g_elems >= kF * q.pix;
  return x_ok && g_ok;
}

template <int C>
int gradw_mma(const bf16* x, const bf16* g, float* partial, float* dw, int N,
              int H, int W, int OH, int OW, int pad_h, int pad_w,
              int band_rows, int bands, int images, int xo, int xrs,
              int xplane, int ximg, int x_elems, int gps, int g_elems,
              int pix, int stage_elems, int stages, int smem_bytes,
              int x_chw, int g_chw, long long units, int num_blocks,
              void* stream) {
  const MmaGeometry q{N,     H,    W,       OH,     OW,     pad_h,
                      pad_w, band_rows,     bands,  images, xo,
                      xrs,   xplane,        ximg,   x_elems, gps,
                      g_elems, pix,         stage_elems,    stages};
  if (num_blocks < 1 || units < num_blocks ||
      !mma_layout_ok<C>(q, smem_bytes, x_chw, g_chw, units))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (C == 1 || !x_chw) {  // at C = 1 both layouts of x are one memory
    err = g_chw ? launch_mma<C, false, true>(x, g, partial, q, units,
                                             num_blocks, smem_bytes, s)
                : launch_mma<C, false, false>(x, g, partial, q, units,
                                              num_blocks, smem_bytes, s);
  } else if constexpr (C > 1) {
    err = g_chw ? launch_mma<C, true, true>(x, g, partial, q, units,
                                            num_blocks, smem_bytes, s)
                : launch_mma<C, true, false>(x, g, partial, q, units,
                                             num_blocks, smem_bytes, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int outputs = MmaTaps<C>::kOut;
  reduce_partials_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      partial, dw, outputs, num_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shallow stem's bf16 grad-W at 3 input channels (RGB frames), at 4
// (Atari's grayscale stack of 4) and at 1 (a gym level's one-channel
// frames).
int sat_conv_gradw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
    float* partial, float* dw, int N, int H, int W, int OH, int OW,
    int pad_h, int pad_w, int band_rows, int bands, int images, int xo,
    int xrs, int xplane, int ximg, int x_elems, int gps, int g_elems,
    int pix, int stage_elems, int stages, int smem_bytes, int x_chw,
    int g_chw, long long units, int num_blocks, void* stream) {
  return gradw_mma<3>(x, g, partial, dw, N, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, images, xo, xrs, xplane, ximg, x_elems, gps,
      g_elems, pix, stage_elems, stages, smem_bytes, x_chw, g_chw, units,
      num_blocks, stream);
}

int sat_conv_gradw_c4_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
    float* partial, float* dw, int N, int H, int W, int OH, int OW,
    int pad_h, int pad_w, int band_rows, int bands, int images, int xo,
    int xrs, int xplane, int ximg, int x_elems, int gps, int g_elems,
    int pix, int stage_elems, int stages, int smem_bytes, int x_chw,
    int g_chw, long long units, int num_blocks, void* stream) {
  return gradw_mma<4>(x, g, partial, dw, N, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, images, xo, xrs, xplane, ximg, x_elems, gps,
      g_elems, pix, stage_elems, stages, smem_bytes, x_chw, g_chw, units,
      num_blocks, stream);
}

int sat_conv_gradw_c1_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
    float* partial, float* dw, int N, int H, int W, int OH, int OW,
    int pad_h, int pad_w, int band_rows, int bands, int images, int xo,
    int xrs, int xplane, int ximg, int x_elems, int gps, int g_elems,
    int pix, int stage_elems, int stages, int smem_bytes, int x_chw,
    int g_chw, long long units, int num_blocks, void* stream) {
  return gradw_mma<1>(x, g, partial, dw, N, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, images, xo, xrs, xplane, ximg, x_elems, gps,
      g_elems, pix, stage_elems, stages, smem_bytes, x_chw, g_chw, units,
      num_blocks, stream);
}

}  // extern "C"
