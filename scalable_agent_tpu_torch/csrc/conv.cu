// Hand-written Hopper (sm_90a) kernel for the weight gradient of the
// shallow torso's SAME-padded 8x8 / stride-4 stem conv (3-channel frames
// into 32 features, Atari's grayscale stack of 4 frames: C = 4, or a gym_
// level's one-channel frames: C = 1) on float32 x and g.  Its bf16 kernel
// is in conv_mma.cu, the ResNet torso's stem's in conv_resnet.cu.
//
// Replaces scalable_agent_tpu/ops/conv_pallas.py::_gradw_kernel.  The TPU
// kernel re-lays the padded input out by space-to-depth, gathers the taps
// as contiguous slices, and accumulates the [K*K*C, F] product across a
// sequential grid over batch tiles in VMEM scratch.  What it computes is
// the split-K product
//
//   dW[kh, kw, c, f] = sum_{n, oh, ow} x[n, oh*S + kh - ph, ow*S + kw - pw, c]
//                                      * g[n, oh, ow, f]
//
// i.e. dW[192, 32] = P^T[192, P] . G[P, 32] over P = N*OH*OW patch rows
// (1.4 M at the main path's N=3232 frames of 72x96).
//
// What bounds it on this card: 17.2 GFLOP of float32 FMA over 0.45 GB of
// input, so f32 FFMA at 67 TFLOP/s (0.256 ms) and not bytes (0.133 ms).
// A design that gathers every element of a small patch tile from device
// memory (integer divides per element, two barriers per few FMAs) is
// bound by address arithmetic and barriers instead, ~10x slower.
//
// Design here:
// * Whole images, in bands of output rows.  Each image's x (and g) is one
//   contiguous span in both layouts the torso hands over, so a block stages
//   a band of BR output rows -- (BR-1)*S + K input rows, the K-S halo
//   included, plus the band's g rows -- into shared memory with cp.async
//   copies as wide as the alignment allows (16 bytes for the rows of g, 8
//   for x's rows at a pad of 2), double-buffered: the next band is in
//   flight while this one is contracted.  The band height is the largest
//   that lets two stages fit (9 of the 18 output rows at 72x96: each pixel
//   is read from device memory once, the 4-row halo a second time).  The
//   SAME padding is zero rows and columns in shared memory: the column pads
//   are zeroed once, the rows above or below the image per band, so the
//   inner loop has no bounds checks.
// * Space-to-depth addressing.  Shared memory keeps the padded band with
//   its left pad at column pw, so the patch of output (oh, ow) at taps
//   (kh, kw = 4*q .. 4*q+3) starts at padded column 4*(ow+q): a thread's
//   12 patch values (4 kw x 3 c) are three aligned 16-byte loads in either
//   layout, and all integer arithmetic sits outside the FMA loop.  Row
//   strides are padded to 8 (mod 32) floats so the 8 distinct 16-byte
//   chunks a warp reads fall on distinct banks.
// * Register tiles.  A row group of 64 threads covers the 192x32 output:
//   thread (kh, q, f-tile) holds 12x8 accumulators, reading 5 x 16 bytes of
//   shared memory per 96 FMAs.  Six row groups (384 threads, 12 warps to
//   hide shared-memory latency; one block per SM, grid = SM count) take
//   interleaved output columns of the band and are summed in shared memory
//   at the end in a fixed order.
// * Route: float32 FFMA, not 3xTF32 tensor cores.  3xTF32 could reach the
//   byte bound, but needs three mma.sync per product plus the hi/lo split of
//   every gathered patch value; FFMA at this tile is ~90% FMA instructions
//   and targets 2x its bound with exact float32 products.
// * Deterministic: block b owns the (image, band) units
//   [b*U/B, (b+1)*U/B) in order, writes its own partial [192, 32], and a
//   second kernel sums the partials over b in index order.  No atomics: two
//   calls give bitwise-equal dW.
// * Operand type: float32 only.  Under compute_dtype=bfloat16 the torso
//   hands over bf16 x and g, and _gradw_kernel rounds its patches and g to
//   bf16 and sums in float32: that variant is conv_mma.cu's
//   conv_gradw_mma_kernel, designed for bf16 operands on tensor cores.
//   Entry point: sat_conv_gradw.
// * Channels.  The band kernel, its staging and its fixed-order reduce are
//   templates on C (the 3 above; 4 for Atari's [84, 84, 4] frames, where
//   dW is [256, 32] and P = 1.43 M at N=3232; 1 for a gym_ level's
//   one-channel frames, where dW is [64, 32]), and on CT, the channels of
//   one thread's tile (TileChannels<C>): C = 3 keeps the layout above;
//   C = 4 gives a thread 2 channels (4 kw x 2 c x 8 f accumulators), so a
//   row group is 128 threads and a block has three; C = 1 gives a thread
//   its one channel (4 kw x 8 f, one 16-byte load of x and two of g per 32
//   FMAs), in six row groups of 64 threads (at C = 1 an NHWC view of NCHW
//   memory is contiguous NHWC memory: both layouts of x take the NHWC
//   instantiation).  In NHWC a tile's two channels of each tap are one
//   8-byte load.  Entry points: sat_conv_gradw_c4 and sat_conv_gradw_c1.

#include "conv_common.cuh"

namespace {

constexpr int kTileF = 8;                  // dW columns per thread
constexpr int kFTiles = kF / kTileF;       // 4
constexpr int kQuads = kK / kS;            // kw quads: 2
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;

// The band kernel's layout at C input channels, CT of them in one thread's
// tile: a thread holds (kh, kw quad, channel slice) x (8 features), i.e.
// kS * CT rows of dW by kTileF columns; a row group of threads covers the
// [K*K*C, 32] output once, and the block's row groups take interleaved
// output columns of the band.
template <int C, int CT>
struct Band {
  static_assert(C % CT == 0, "CT must divide C");
  static constexpr int kR = kK * kK * C;          // rows of dW
  static constexpr int kTileR = kS * CT;          // dW rows per thread
  static constexpr int kSlices = C / CT;          // channel slices
  static constexpr int kGroupThreads = kK * kQuads * kSlices * kFTiles;
  static constexpr int kGroups = kThreads / kGroupThreads;
  static_assert(kGroups * kGroupThreads == kThreads,
                "row groups must fill the block");
};

// The channels of one thread's tile at each channel count the kernel is
// built for (ops/conv_cuda.py GRADW_GROUPS holds the row groups that
// follow from it).  At C = 4 a whole-channel tile (16 x 8 accumulators)
// spilled 12-52 bytes at the 168 registers of 384 threads a block; two
// channels a thread (8 x 8, three row groups of 128 threads) spill nothing
// and ran as fast or up to 6% faster on an H100 (tools/gradw_c4_tile.py;
// PERF.md, section 6).  At C = 1 a thread's tile is its one channel.
template <int C>
struct TileChannels;
template <>
struct TileChannels<1> {
  static constexpr int kCT = 1;
};
template <>
struct TileChannels<3> {
  static constexpr int kCT = 3;
};
template <>
struct TileChannels<4> {
  static constexpr int kCT = 2;
};

template <int VEC>
__device__ __forceinline__ void copy_rows_vec(float* dst, int dst_stride,
                                              const float* src,
                                              long long src_stride, int rows,
                                              int len) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* s = src + r * src_stride;
    float* d = dst + r * dst_stride;
    for (int v = lane * VEC; v < len; v += 32 * VEC)
      cp_async<4 * VEC>(d + v, s + v);
  }
}

// Asynchronously copies `rows` rows of `len` floats, row r from
// src + r*src_stride to dst + r*dst_stride, one warp per row, with the
// widest cp.async that every row's alignment allows.
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* src,
                                          long long src_stride, int rows,
                                          int len) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(src) | smem_addr(dst) |
      static_cast<unsigned long long>(src_stride * 4) |
      static_cast<unsigned>(dst_stride * 4) | static_cast<unsigned>(len * 4);
  if ((bits & 15) == 0)
    copy_rows_vec<4>(dst, dst_stride, src, src_stride, rows, len);
  else if ((bits & 7) == 0)
    copy_rows_vec<2>(dst, dst_stride, src, src_stride, rows, len);
  else
    copy_rows_vec<1>(dst, dst_stride, src, src_stride, rows, len);
}

// Zeroes rows [r0, r1) of `stride` floats (a multiple of 4) at dst.
__device__ __forceinline__ void zero_rows(float* dst, int stride, int r0,
                                          int r1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float4* d = reinterpret_cast<float4*>(dst + r * stride);
    for (int v = lane; v < stride / 4; v += 32)
      d[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct Geometry {
  int H, W, OH, OW, pad_h, pad_w;
  int band_rows, bands;  // output rows per band, bands per image
  int xrs;               // padded row stride of the staged x, floats
  int xplane;            // one channel plane of the staged x (CHW), floats
  int x_floats;          // staged x region, floats (multiple of 4)
  int gps;               // plane stride of the staged g (CHW), floats
  int stage_floats;      // one stage: x region + g region
};

// Issues the copies of unit u = (image, band) into the stage at `xs`.
template <int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void stage_unit(float* xs, const float* x,
                                           const float* g, long long u,
                                           const Geometry& q) {
  const long long n = u / q.bands;
  const int band = static_cast<int>(u - n * q.bands);
  const int oh0 = band * q.band_rows;
  const int rows = min(q.band_rows, q.OH - oh0);
  const int xr = (rows - 1) * kS + kK;  // padded input rows of the band
  const int ih0 = oh0 * kS - q.pad_h;
  const int lo = max(0, -ih0);          // first band row inside the image
  const int hi = min(xr, q.H - ih0);    // one past the last
  const float* ximg = x + n * q.H * q.W * C;
  if (XCHW) {
    for (int c = 0; c < C; ++c) {
      float* plane = xs + c * q.xplane;
      zero_rows(plane, q.xrs, 0, lo);
      zero_rows(plane, q.xrs, hi, xr);
      copy_rows(plane + lo * q.xrs + q.pad_w, q.xrs,
                ximg + (c * q.H + ih0 + lo) * static_cast<long long>(q.W),
                q.W, hi - lo, q.W);
    }
  } else {
    zero_rows(xs, q.xrs, 0, lo);
    zero_rows(xs, q.xrs, hi, xr);
    copy_rows(xs + lo * q.xrs + q.pad_w * C, q.xrs,
              ximg + (ih0 + lo) * static_cast<long long>(q.W * C),
              q.W * C, hi - lo, q.W * C);
  }
  float* gs = xs + q.x_floats;
  const float* gimg = g + n * q.OH * q.OW * kF;
  if (GCHW)
    copy_rows(gs, q.gps, gimg + oh0 * q.OW, q.OH * q.OW, kF, rows * q.OW);
  else
    copy_rows(gs, q.OW * kF, gimg + oh0 * q.OW * kF, q.OW * kF, rows,
              q.OW * kF);
}

template <int C, int CT, bool XCHW, bool GCHW>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gradw_band_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           float* __restrict__ partial, Geometry q,
                           long long units) {
  using L = Band<C, CT>;
  static_assert(XCHW || CT == C || CT % 2 == 0,
                "an NHWC tile of part of the channels loads them in pairs");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int rg = tid / L::kGroupThreads;  // row group
  const int t = tid % L::kGroupThreads;
  const int ft = t % kFTiles;
  const int rt = t / kFTiles;
  const int c0 = (rt % L::kSlices) * CT;  // this thread's first channel
  const int kq = (rt / L::kSlices) % kQuads;  // kw = 4*kq .. 4*kq+3
  const int kh = rt / (L::kSlices * kQuads);
  const long long u_begin = blockIdx.x * units / gridDim.x;
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;

  // Zero both stages once: the copies write only the interior columns, so
  // the SAME column pads stay zero.
  for (int i = tid; i < q.stage_floats / 2; i += kThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float acc[L::kTileR][kTileF];
#pragma unroll
  for (int i = 0; i < L::kTileR; ++i)
#pragma unroll
    for (int f = 0; f < kTileF; ++f) acc[i][f] = 0.f;

  // This thread's first patch value within a staged band, and its g column.
  const int x_off = XCHW ? kh * q.xrs + kq * kS + c0 * q.xplane
                         : kh * q.xrs + kq * kS * C + c0;
  const int g_off = GCHW ? ft * kTileF * q.gps : ft * kTileF;

  if (u_begin < u_end) stage_unit<C, XCHW, GCHW>(smem, x, g, u_begin, q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (long long u = u_begin; u < u_end; ++u) {
    const int buf = static_cast<int>(u - u_begin) & 1;
    if (u + 1 < u_end)
      stage_unit<C, XCHW, GCHW>(smem + (buf ^ 1) * q.stage_floats, x, g,
                                u + 1, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const float* xs = smem + buf * q.stage_floats;
    const float* gs = xs + q.x_floats;
    const long long n = u / q.bands;
    const int oh0 = static_cast<int>(u - n * q.bands) * q.band_rows;
    const int rows = min(q.band_rows, q.OH - oh0);
    for (int ohl = 0; ohl < rows; ++ohl) {
      const float* xrow = xs + x_off + ohl * kS * q.xrs;
      const float* grow = gs + g_off + ohl * q.OW * (GCHW ? 1 : kF);
#pragma unroll 2
      for (int ow = rg; ow < q.OW; ow += L::kGroups) {
        float xv[L::kTileR];
        float gv[kTileF];
        if constexpr (XCHW) {
          // xv[c * 4 + kw]: the 4 taps of each channel are contiguous.
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(
                xrow + c * q.xplane + ow * kS);
            xv[c * 4 + 0] = v.x;
            xv[c * 4 + 1] = v.y;
            xv[c * 4 + 2] = v.z;
            xv[c * 4 + 3] = v.w;
          }
        } else if constexpr (CT == C) {
          // xv[kw * C + c]: the whole 4 x C patch row is contiguous.
#pragma unroll
          for (int j = 0; j < L::kTileR / 4; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                xrow + ow * kS * C + 4 * j);
            xv[4 * j + 0] = v.x;
            xv[4 * j + 1] = v.y;
            xv[4 * j + 2] = v.z;
            xv[4 * j + 3] = v.w;
          }
        } else {
          // xv[kw * CT + c]: CT of each tap's C channels, in pairs.
#pragma unroll
          for (int kw = 0; kw < kS; ++kw)
#pragma unroll
            for (int c = 0; c < CT; c += 2) {
              const float2 v = *reinterpret_cast<const float2*>(
                  xrow + (ow * kS + kw) * C + c);
              xv[kw * CT + c] = v.x;
              xv[kw * CT + c + 1] = v.y;
            }
        }
        if (GCHW) {
#pragma unroll
          for (int f = 0; f < kTileF; ++f) gv[f] = grow[f * q.gps + ow];
        } else {
#pragma unroll
          for (int j = 0; j < kTileF / 4; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(grow + ow * kF + 4 * j);
            gv[4 * j + 0] = v.x;
            gv[4 * j + 1] = v.y;
            gv[4 * j + 2] = v.z;
            gv[4 * j + 3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < L::kTileR; ++i)
#pragma unroll
          for (int f = 0; f < kTileF; ++f)
            acc[i][f] = fmaf(xv[i], gv[f], acc[i][f]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Sum the row groups in a fixed order through shared memory (the stages
  // are free now; the wrapper sizes them to hold kGroups-1 tiles of
  // [K*K*C, 32]).
  auto out_row = [&](int i) {
    const int kw = kq * kS + (XCHW ? i % 4 : i / CT);
    const int c = c0 + (XCHW ? i / 4 : i % CT);
    return (kh * kK + kw) * C + c;
  };
  if (rg > 0) {
    float* red = smem + (rg - 1) * L::kR * kF;
#pragma unroll
    for (int i = 0; i < L::kTileR; ++i)
#pragma unroll
      for (int f = 0; f < kTileF; ++f)
        red[out_row(i) * kF + ft * kTileF + f] = acc[i][f];
  }
  __syncthreads();
  if (rg == 0) {
    float* out = partial + static_cast<size_t>(blockIdx.x) * L::kR * kF;
#pragma unroll
    for (int i = 0; i < L::kTileR; ++i) {
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        const int o = out_row(i) * kF + ft * kTileF + f;
        float v = acc[i][f];
#pragma unroll
        for (int r = 0; r < L::kGroups - 1; ++r)
          v += smem[r * L::kR * kF + o];
        out[o] = v;
      }
    }
  }
}

template <int C, bool XCHW, bool GCHW>
cudaError_t launch_band(const float* x, const float* g, float* partial,
                        const Geometry& q, long long units, int num_blocks,
                        int smem_bytes, cudaStream_t s) {
  auto kernel = conv_gradw_band_kernel<C, TileChannels<C>::kCT, XCHW, GCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kThreads, smem_bytes, s>>>(x, g, partial, q, units);
  return cudaGetLastError();
}

template <int C>
int gradw(const float* x, const float* g, float* partial, float* dw, int H,
          int W, int OH, int OW, int pad_h, int pad_w, int band_rows,
          int bands, int xrs, int x_floats, int gps, int stage_floats,
          int smem_bytes, int x_chw, int g_chw, long long units,
          int num_blocks, void* stream) {
  using L = Band<C, TileChannels<C>::kCT>;
  // The stages and the final sum of the other row groups must fit.
  if (smem_bytes < 2 * stage_floats * (int)sizeof(float) ||
      smem_bytes < (L::kGroups - 1) * L::kR * kF * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const Geometry q{H,         W,     OH,  OW,
                   pad_h,     pad_w, band_rows,
                   bands,     xrs,   ((band_rows - 1) * kS + kK) * xrs,
                   x_floats,  gps,   stage_floats};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (C == 1 || !x_chw) {  // at C = 1 both layouts of x are one memory
    err = g_chw ? launch_band<C, false, true>(x, g, partial, q, units,
                                              num_blocks, smem_bytes, s)
                : launch_band<C, false, false>(x, g, partial, q, units,
                                               num_blocks, smem_bytes, s);
  } else if constexpr (C > 1) {
    err = g_chw ? launch_band<C, true, true>(x, g, partial, q, units,
                                             num_blocks, smem_bytes, s)
                : launch_band<C, true, false>(x, g, partial, q, units,
                                              num_blocks, smem_bytes, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int outputs = L::kR * kF;
  reduce_partials_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      partial, dw, outputs, num_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shallow stem's float32 grad-W at 3 input channels (RGB frames:
// DMLab, the fake and gym levels, Doom), at 4 (Atari's grayscale stack of
// 4) and at 1 (a gym level's one-channel frames).
int sat_conv_gradw(const float* x, const float* g, float* partial,
    float* dw, int H, int W, int OH, int OW, int pad_h, int pad_w,
    int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<3>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w, band_rows,
      bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw, g_chw,
      units, num_blocks, stream);
}

int sat_conv_gradw_c4(const float* x, const float* g, float* partial,
    float* dw, int H, int W, int OH, int OW, int pad_h, int pad_w,
    int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<4>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w, band_rows,
      bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw, g_chw,
      units, num_blocks, stream);
}

int sat_conv_gradw_c1(const float* x, const float* g, float* partial,
    float* dw, int H, int W, int OH, int OW, int pad_h, int pad_w,
    int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<1>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w, band_rows,
      bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw, g_chw,
      units, num_blocks, stream);
}

}  // extern "C"
