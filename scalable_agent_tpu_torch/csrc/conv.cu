// Hand-written Hopper (sm_90a) kernels for the weight gradient of the
// torsos' stem convs: the shallow torso's SAME-padded 8x8 / stride-4 stem
// (3-channel frames into 32 features, or Atari's grayscale stack of 4
// frames: C = 4), described here, and the ResNet torso's 3x3 / stride-1
// stem (3 channels into 16 features), described above
// resnet_stem_gradw_kernel below.
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
// * Operand type.  The kernel is a template on the type T of x and g:
//   float, or __nv_bfloat16 for the JAX package's matmul_dtype="bfloat16"
//   (the stem under compute_dtype=bfloat16, where the torso hands over bf16
//   x and g; _gradw_kernel rounds its patches and g to bf16 and sums in
//   float32).  The bf16 variant reads bf16 tensors, half the bytes, and
//   converts each value to float as it stages a band (bf16 -> float is
//   exact), so the shared-memory layout, the addressing and the FFMA loop
//   are the float variant's: its products are exact and its sums float32,
//   and it differs from its plain version only in summation order.  Its
//   staging is synchronous -- loads into registers, then stores -- since
//   cp.async cannot convert; a band is still loaded while the other stage
//   is contracted by the other warps.  dW is float32 in both.  Entry
//   points: sat_conv_gradw and sat_conv_gradw_bf16.
// * Channels.  The band kernel, its staging and its fixed-order reduce are
//   templates on C (the 3 above; 4 for Atari's [84, 84, 4] frames, where
//   dW is [256, 32] and P = 1.43 M at N=3232), and on CT, the channels of
//   one thread's tile (TileChannels<C>): C = 3 keeps the layout above, and
//   C = 4 gives a thread 2 channels (4 kw x 2 c x 8 f accumulators), so a
//   row group is 128 threads and a block has three.  In NHWC a tile's two
//   channels of each tap are one 8-byte load.  The C = 4 entry points are
//   sat_conv_gradw_c4 and sat_conv_gradw_c4_bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kK = 8;                      // kernel size
constexpr int kS = 4;                      // stride
constexpr int kF = 32;                     // output features
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
// PERF.md, section 6).
template <int C>
struct TileChannels;
template <>
struct TileChannels<3> {
  static constexpr int kCT = 3;
};
template <>
struct TileChannels<4> {
  static constexpr int kCT = 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

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

// The same copy from bf16 rows, converted to float on the way: loads of
// two values (one when a row is not 4-byte aligned), four per lane in
// flight before their stores, one warp per row.
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const __nv_bfloat16* src,
                                          long long src_stride, int rows,
                                          int len) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool pairs = ((reinterpret_cast<unsigned long long>(src) |
                       static_cast<unsigned long long>(src_stride * 2) |
                       static_cast<unsigned>(len * 2)) &
                      3) == 0;
  constexpr int kInFlight = 4;
  for (int r = warp; r < rows; r += kWarps) {
    const __nv_bfloat16* s = src + r * src_stride;
    float* d = dst + r * dst_stride;
    if (pairs) {
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(s);
      const int n = len / 2;
      for (int v0 = lane; v0 < n; v0 += 32 * kInFlight) {
        float2 f[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i)
          if (v0 + 32 * i < n) f[i] = __bfloat1622float2(s2[v0 + 32 * i]);
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          const int v = v0 + 32 * i;
          if (v < n) {
            d[2 * v] = f[i].x;
            d[2 * v + 1] = f[i].y;
          }
        }
      }
    } else {
      for (int v0 = lane; v0 < len; v0 += 32 * kInFlight) {
        float f[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i)
          if (v0 + 32 * i < len) f[i] = __bfloat162float(s[v0 + 32 * i]);
#pragma unroll
        for (int i = 0; i < kInFlight; ++i)
          if (v0 + 32 * i < len) d[v0 + 32 * i] = f[i];
      }
    }
  }
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
template <typename T, int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void stage_unit(float* xs, const T* x, const T* g,
                                           long long u, const Geometry& q) {
  const long long n = u / q.bands;
  const int band = static_cast<int>(u - n * q.bands);
  const int oh0 = band * q.band_rows;
  const int rows = min(q.band_rows, q.OH - oh0);
  const int xr = (rows - 1) * kS + kK;  // padded input rows of the band
  const int ih0 = oh0 * kS - q.pad_h;
  const int lo = max(0, -ih0);          // first band row inside the image
  const int hi = min(xr, q.H - ih0);    // one past the last
  const T* ximg = x + n * q.H * q.W * C;
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
  const T* gimg = g + n * q.OH * q.OW * kF;
  if (GCHW)
    copy_rows(gs, q.gps, gimg + oh0 * q.OW, q.OH * q.OW, kF, rows * q.OW);
  else
    copy_rows(gs, q.OW * kF, gimg + oh0 * q.OW * kF, q.OW * kF, rows,
              q.OW * kF);
}

template <typename T, int C, int CT, bool XCHW, bool GCHW>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gradw_band_kernel(const T* __restrict__ x, const T* __restrict__ g,
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

  if (u_begin < u_end) stage_unit<T, C, XCHW, GCHW>(smem, x, g, u_begin, q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (long long u = u_begin; u < u_end; ++u) {
    const int buf = static_cast<int>(u - u_begin) & 1;
    if (u + 1 < u_end)
      stage_unit<T, C, XCHW, GCHW>(smem + (buf ^ 1) * q.stage_floats, x, g,
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

// dw[o] = sum over blocks of partial[block][o], blocks in index order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dw, int outputs,
                                       int num_blocks) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= outputs) return;
  float s = 0.f;
  for (int b = 0; b < num_blocks; ++b) s += partial[(size_t)b * outputs + o];
  dw[o] = s;
}

template <typename T, int C, bool XCHW, bool GCHW>
cudaError_t launch_band(const T* x, const T* g, float* partial,
                        const Geometry& q, long long units, int num_blocks,
                        int smem_bytes, cudaStream_t s) {
  auto kernel =
      conv_gradw_band_kernel<T, C, TileChannels<C>::kCT, XCHW, GCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kThreads, smem_bytes, s>>>(x, g, partial, q, units);
  return cudaGetLastError();
}

template <typename T, int C>
int gradw(const T* x, const T* g, float* partial, float* dw, int H, int W,
          int OH, int OW, int pad_h, int pad_w, int band_rows, int bands,
          int xrs, int x_floats, int gps, int stage_floats, int smem_bytes,
          int x_chw, int g_chw, long long units, int num_blocks,
          void* stream) {
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
  cudaError_t err;
  if (x_chw && g_chw)
    err = launch_band<T, C, true, true>(x, g, partial, q, units, num_blocks,
                                        smem_bytes, s);
  else if (x_chw)
    err = launch_band<T, C, true, false>(x, g, partial, q, units,
                                         num_blocks, smem_bytes, s);
  else if (g_chw)
    err = launch_band<T, C, false, true>(x, g, partial, q, units,
                                         num_blocks, smem_bytes, s);
  else
    err = launch_band<T, C, false, false>(x, g, partial, q, units,
                                          num_blocks, smem_bytes, s);
  if (err != cudaSuccess) return (int)err;
  const int outputs = L::kR * kF;
  reduce_partials_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      partial, dw, outputs, num_blocks);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The ResNet torso's stem (downscale_0): SAME 3x3 / stride 1, 3 channels
// into 16 features, at the frame's full resolution.
//
// Replaces scalable_agent_tpu/ops/conv_pallas.py::_gradw_kernel at
// (K, S, C, F) = (3, 1, 3, 16), where its space-to-depth is the identity
// (depth 3) and its contraction has 27 rows:
//
//   dW[kh, kw, c, f] = sum_{n, oh, ow} x[n, oh + kh - 1, ow + kw - 1, c]
//                                      * g[n, oh, ow, f]
//
// i.e. dW[27, 16] over N*OH*OW = 22.3 M pixels at the main path's N=3232
// frames of 72x96.  What bounds it on this card: the bytes.  g has 16
// channels at full resolution and is 84% of the 1.70 GB read in float32
// (0.85 GB with bf16 x and g), against 19.3 GFLOP of FMA: 0.507 ms of bytes
// against 0.288 ms of float32 FFMA at 67 TFLOP/s; 0.253 ms of bytes at bf16
// against 0.02 ms on bf16 tensor cores.  One template,
// resnet_stem_gradw_kernel<T, XCHW, GCHW>, has a body for each operand
// type; both work on bands of kResRows = 8 whole output rows of one image
// and are deterministic the same way: block b owns the (image, band) units
// [b*U/B, (b+1)*U/B) in order, each warp sums in a fixed order, the warps
// are summed in index order through shared memory, and the blocks'
// partials by reduce_partials_kernel in block order, so two calls give
// bitwise-equal dW.  Entry points: sat_resnet_stem_gradw and
// sat_resnet_stem_gradw_bf16.
//
// float32 (a simple kernel: FFMA, no tensor cores, no TMA):
// * A block stages a band's 10 input rows (the halo included) and its 8
//   cotangent rows in shared memory in one layout whatever the tensors'
//   (pixels in order, channels innermost, the SAME column pads in place
//   and zero), double-buffered: the next band is in flight while this one
//   is contracted.  Contiguous NHWC rows go by cp.async as wide as their
//   alignment allows; an NHWC view of NCHW memory is copied synchronously,
//   transposed on the way.  Rows above or below the image are zeroed per
//   band, so the inner loop has no bounds checks.
// * Sliding windows along a row.  Warp w takes the w-th eighth of the
//   columns of each of the band's 8 rows (lane = 4 * row + feature
//   quarter).  A thread holds all 27 patch rows for 4 features (108
//   accumulators) and walks its columns left to right, so each step reads
//   the new column's 9 inputs (3 kh x 3 c) and one vector of 4 cotangent
//   values from shared memory for 108 FMAs.  The staged rows' strides put
//   the 8 rows a warp reads on distinct banks (conv_cuda.resnet_gradw_plan).
//   The 8 rows of a warp are summed by a fixed butterfly of shuffles.
//
// bf16 (tensor cores; res_mma_body): at half the bytes an FFMA loop like
// the float32 one was the limit (0.64 ms against 0.25 ms of bytes), so the
// contraction runs on mma.sync.m16n8k16 bf16 with float32 accumulators:
//   dW^T[16 features, 32 columns] += G^T[16, 16 pixels] . P[16 pixels, 32]
// M the 16 features (one m16 tile), N the 27 taps padded to 32 (four n8
// tiles), K 16 pixels of one output row: 4 mma.sync per 16 pixels and 16
// float32 accumulators a thread.  (wgmma's 64-row tiles would be three
// quarters idle here, and at mma.sync's rate the 19.3 GFLOP take ~0.04 ms,
// under the bytes.)  The products are exact and the sums float32, as
// _gradw_kernel's at matmul_dtype="bfloat16".
// * Staging.  Both layouts are staged raw, as they lie in memory, by
//   cp.async of 16 bytes where the rows' alignment allows (always for NHWC
//   g; planar rows and NHWC x rows at an even width; 8 or 4 bytes, else
//   element by element, as alignment falls), in a ring of q.stages stages
//   (3), two blocks an SM: while each contracts one band, 4 more (~30 KB
//   each at 72x96) are in flight on the SM.  (On an H100 one block of 2
//   to 6 stages read 0.40-0.42 ms at N=3232, two blocks 0.30: PERF.md.)
//   A staged output row is padded to q.wp, a
//   multiple of 16 pixels; the pad pixels of g, the SAME column pads of x
//   and the columns past them are zeroed once, before the ring starts, and
//   never written again, and rows above or below the image are zeroed per
//   band: every value the contraction reads is finite, and every pad
//   product is zero.
// * A (G^T) by ldmatrix.x4 from the staged g: NHWC g is a [pixel][16]
//   row of 32 bytes per pixel, read with .trans, its two 16-byte halves
//   swapped at pixels with bit 2 set so that the 8 pixel rows of one 8x8
//   load fall on distinct banks; planar g is [feature][pixels], read
//   without .trans, features q.grs apart (16 bytes mod 128).
// * B (patches) from the staged x band by 16-bit loads.  Column (j, i) of
//   n8 tile j < 3 is tap (kh, kw, c) = (i / 3, j, i % 3); tile 3 holds the
//   ninth (kh, c) = (2, 2) at kw = i for i < 3, and its columns 3-7 hold
//   finite staged values whose outputs are never written.  A lane's three
//   kw of one (kh, c) at pixels (p, p+1) need x at padded columns p .. p+3,
//   so 4 loads build 3 registers: 12 loads and 8 packs per 16 pixels, for
//   either layout (NHWC a column is 3 elements wide, planar 1).  Planar x
//   could use 32-bit loads from a second copy shifted by one element; at
//   14% of the bytes, one code path and one staged copy were kept.
//   conv_cuda.resnet_gradw_plan picks row strides that keep these loads
//   within 1.33 shared-memory wavefronts on average (NHWC) or 1 (planar).
// * Warp w contracts output row w of each band (a band of the last rows
//   may have fewer), its 16-pixel chunks in order into a fresh accumulator
//   that is added to the running float32 sums at the end of the band, so no
//   tensor-core accumulation runs longer than one row.

constexpr int kResK = 3;
constexpr int kResC = 3;
constexpr int kResF = 16;
constexpr int kResTaps = kResK * kResK * kResC;  // 27 rows of dW
constexpr int kResOut = kResTaps * kResF;        // 432
constexpr int kResRows = 8;                      // output rows per band
constexpr int kResFeat = 4;                      // features per thread
constexpr int kResWarps = 8;                     // column eighths
constexpr int kResThreads = 32 * kResWarps;
static_assert(kResRows * (kResF / kResFeat) == 32,
              "a warp is the band's 8 rows x 4 feature quarters");

struct ResGeometry {
  int H, W, bands;   // OH = H and OW = W (stride 1, SAME)
  int xrs, grs;      // row strides of the staged x and g, elements (bf16
                     // planar g: a feature's plane stride)
  int x_elems;       // staged x region (kResRows + 2 rows), elements
  int stage_elems;   // one stage: x region + g region
  int stages;        // stages of the ring (float32: 2)
  int xplane;        // bf16 planar x: a channel's plane stride
  int wp;            // bf16: pixels of a staged output row (W up to 16s)
};

__device__ __forceinline__ float res_float(float v) { return v; }

__device__ __forceinline__ void res_load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <int BYTES, typename T>
__device__ __forceinline__ void res_copy_rows_vec(T* dst, int dst_stride,
                                                  const T* src,
                                                  long long src_stride,
                                                  int rows, int len) {
  constexpr int kPer = BYTES / static_cast<int>(sizeof(T));
  const int chunks = len / kPer;
  for (int i = threadIdx.x; i < rows * chunks; i += kResThreads) {
    const int r = i / chunks;
    const int v = (i - r * chunks) * kPer;
    cp_async<BYTES>(reinterpret_cast<float*>(dst + r * dst_stride + v),
                    reinterpret_cast<const float*>(src + r * src_stride + v));
  }
}

// Copies `rows` rows of `len` elements, row r from src + r*src_stride to
// dst + r*dst_stride, spread over the block: by cp.async of 16, 8 or 4
// bytes as every row's alignment allows, else element by element.
template <typename T>
__device__ __forceinline__ void res_copy_rows(T* dst, int dst_stride,
                                              const T* src,
                                              long long src_stride, int rows,
                                              int len) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(src) | smem_addr(dst) |
      static_cast<unsigned long long>(src_stride * sizeof(T)) |
      static_cast<unsigned>(dst_stride * sizeof(T)) |
      static_cast<unsigned>(len * sizeof(T));
  if ((bits & 15) == 0) {
    res_copy_rows_vec<16>(dst, dst_stride, src, src_stride, rows, len);
  } else if ((bits & 7) == 0) {
    res_copy_rows_vec<8>(dst, dst_stride, src, src_stride, rows, len);
  } else if ((bits & 3) == 0) {
    res_copy_rows_vec<4>(dst, dst_stride, src, src_stride, rows, len);
  } else {
    for (int i = threadIdx.x; i < rows * len; i += kResThreads) {
      const int r = i / len;
      const int v = i - r * len;
      dst[r * dst_stride + v] = src[r * src_stride + v];
    }
  }
}

// The same rows from P planes `plane` elements apart (an NHWC view of NCHW
// memory), transposed: dst[r*dst_stride + col*P + p] = src[p*plane +
// r*len + col].  Synchronous; consecutive threads read consecutive
// elements.
template <int P, typename T>
__device__ __forceinline__ void res_copy_planes(T* dst, int dst_stride,
                                                const T* src, long long plane,
                                                int rows, int len) {
  const int per_plane = rows * len;
  for (int i = threadIdx.x; i < P * per_plane; i += kResThreads) {
    const int p = i / per_plane;
    const int rem = i - p * per_plane;
    const int r = rem / len;
    dst[r * dst_stride + (rem - r * len) * P + p] = src[p * plane + rem];
  }
}

// Zeroes rows [r0, r1) of `stride` elements (stride * sizeof(T) a multiple
// of 16 bytes) at dst.
template <typename T>
__device__ __forceinline__ void res_zero_rows(T* dst, int stride, int r0,
                                              int r1) {
  const int per_row = stride * static_cast<int>(sizeof(T)) / 16;
  uint4* d = reinterpret_cast<uint4*>(dst + r0 * stride);
  for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += kResThreads)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Issues the copies of unit u = (image, band) into the stage at `xs`.  In
// a staged x row, padded column pc (pc = 0 the left pad) starts at element
// xo + 3*pc with xo = 16 / sizeof(T) - 3, so the data (pc = 1) starts
// 16-byte aligned.
template <typename T, bool XCHW, bool GCHW>
__device__ __forceinline__ void res_stage_unit(T* xs, const T* x, const T* g,
                                               long long u,
                                               const ResGeometry& q) {
  constexpr int xo = 16 / static_cast<int>(sizeof(T)) - kResC;
  const long long n = u / q.bands;
  const int oh0 = static_cast<int>(u - n * q.bands) * kResRows;
  const int rows = min(kResRows, q.H - oh0);
  const int xr = rows + kResK - 1;  // input rows of the band, halo included
  const int ih0 = oh0 - 1;
  const int lo = max(0, -ih0);      // first band row inside the image
  const int hi = min(xr, q.H - ih0);  // one past the last
  const long long plane = static_cast<long long>(q.H) * q.W;
  res_zero_rows(xs, q.xrs, 0, lo);
  res_zero_rows(xs, q.xrs, hi, xr);
  T* xdst = xs + lo * q.xrs + xo + kResC;
  const T* ximg = x + n * plane * kResC;
  if (XCHW)
    res_copy_planes<kResC>(xdst, q.xrs,
                           ximg + static_cast<long long>(ih0 + lo) * q.W,
                           plane, hi - lo, q.W);
  else
    res_copy_rows(xdst, q.xrs,
                  ximg + static_cast<long long>(ih0 + lo) * q.W * kResC,
                  static_cast<long long>(q.W) * kResC, hi - lo, q.W * kResC);
  T* gs = xs + q.x_elems;
  const T* gimg = g + n * plane * kResF;
  if (GCHW)
    res_copy_planes<kResF>(gs, q.grs,
                           gimg + static_cast<long long>(oh0) * q.W, plane,
                           rows, q.W);
  else
    res_copy_rows(gs, q.grs, gimg + static_cast<long long>(oh0) * q.W * kResF,
                  static_cast<long long>(q.W) * kResF, rows, q.W * kResF);
}

// ---- the bf16 body ---------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kResPix = 16;     // pixels of one mma.sync step (its K)
constexpr int kResXoHwc = 5;    // element of padded column 0 in a staged
constexpr int kResXoChw = 7;    // x row: data (column 1) 16-byte aligned
constexpr int kResMaxStages = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// cp.async.wait_group takes an immediate: waits until at most `pending`
// of this thread's groups are in flight.
__device__ __forceinline__ void res_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

template <int BYTES>
__device__ __forceinline__ void res_runs_vec(bf16* dst, int dpl, int drow,
                                             const bf16* src, long long spl,
                                             long long srow, int planes,
                                             int rows, int len) {
  constexpr int kPer = BYTES / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < planes * rows; i += kResWarps) {
    const int p = i / rows, r = i - p * rows;
    bf16* d = dst + p * dpl + r * drow;
    const bf16* s = src + p * spl + r * srow;
    for (int v = lane * kPer; v < len; v += 32 * kPer) {
      if (BYTES == 16)
        cp_async16(d + v, s + v);
      else
        cp_async<BYTES>(reinterpret_cast<float*>(d + v),
                        reinterpret_cast<const float*>(s + v));
    }
  }
}

// Copies planes x rows runs of `len` elements, run (p, r) from
// src + p*spl + r*srow to dst + p*dpl + r*drow, one warp a run: by cp.async
// of 16, 8 or 4 bytes as every run's alignment allows, else element by
// element.
__device__ __forceinline__ void res_runs(bf16* dst, int dpl, int drow,
                                         const bf16* src, long long spl,
                                         long long srow, int planes,
                                         int rows, int len) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(src) | smem_addr(dst) |
      static_cast<unsigned long long>(spl * 2) |
      static_cast<unsigned long long>(srow * 2) |
      static_cast<unsigned>(dpl * 2) | static_cast<unsigned>(drow * 2) |
      static_cast<unsigned>(len * 2);
  if ((bits & 15) == 0) {
    res_runs_vec<16>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else if ((bits & 7) == 0) {
    res_runs_vec<8>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else if ((bits & 3) == 0) {
    res_runs_vec<4>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else {
    for (int i = threadIdx.x; i < planes * rows * len; i += kResThreads) {
      const int run = i / len, v = i - run * len;
      const int p = run / rows, r = run - p * rows;
      dst[p * dpl + r * drow + v] = src[p * spl + r * srow + v];
    }
  }
}

// Zeroes rows [r0, r1) of `drow` elements (a multiple of 8) in each of
// `planes` planes `dpl` elements apart (a multiple of 8).
__device__ __forceinline__ void res_zero_runs(bf16* dst, int dpl, int drow,
                                              int planes, int r0, int r1) {
  const int n = (r1 - r0) * (drow / 8);
  for (int i = threadIdx.x; i < planes * n; i += kResThreads) {
    const int p = i / n;
    reinterpret_cast<uint4*>(dst + p * dpl + r0 * drow)[i - p * n] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// NHWC g rows (32 bytes a pixel) into [pixel][16] rows of wp pixels, the
// two 16-byte halves of pixel p swapped when bit 2 of p is set.
__device__ __forceinline__ void res_stage_g_hwc(bf16* gs, int wp,
                                                const bf16* src, int W,
                                                int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int r = warp; r < rows; r += kResWarps) {
      const bf16* s = src + static_cast<long long>(r) * W * kResF;
      bf16* d = gs + r * wp * kResF;
      for (int k = lane; k < 2 * W; k += 32) {
        const int p = k >> 1;
        cp_async16(d + p * kResF + 8 * ((k & 1) ^ ((p >> 2) & 1)), s + 8 * k);
      }
    }
  } else {
    const int per_row = W * kResF;
    for (int i = threadIdx.x; i < rows * per_row; i += kResThreads) {
      const int r = i / per_row, e = i - r * per_row;
      const int p = e >> 4, f = e & 15;
      gs[(r * wp + p) * kResF + 8 * ((f >> 3) ^ ((p >> 2) & 1)) + (f & 7)] =
          src[i];
    }
  }
}

// Issues the copies (and zeroes the out-of-image rows) of image n's band
// `band` into the stage at xs.  Staged x: padded column pc of row r (row
// 0 the band's first output row - 1), channel c, at element
// r*xrs + xo + 3*pc + c (NHWC) or c*xplane + r*xrs + xo + pc (planar).
// Staged g, from xs + x_elems: output row r, pixel p, feature f at
// (r*wp + p)*16 + (f ^ (8 * bit 2 of p)) (NHWC) or f*grs + r*wp + p.
template <bool XCHW, bool GCHW>
__device__ __forceinline__ void res_mma_stage(bf16* xs, const bf16* x,
                                              const bf16* g, long long n,
                                              int band,
                                              const ResGeometry& q) {
  const int oh0 = band * kResRows;
  const int rows = min(kResRows, q.H - oh0);
  const int xr = rows + kResK - 1;  // input rows of the band, halo included
  const int ih0 = oh0 - 1;
  const int lo = max(0, -ih0);      // first band row inside the image
  const int hi = min(xr, q.H - ih0);  // one past the last
  const long long plane = static_cast<long long>(q.H) * q.W;
  if (XCHW) {
    res_zero_runs(xs, q.xplane, q.xrs, kResC, 0, lo);
    res_zero_runs(xs, q.xplane, q.xrs, kResC, hi, xr);
    res_runs(xs + lo * q.xrs + kResXoChw + 1, q.xplane, q.xrs,
             x + n * kResC * plane + static_cast<long long>(ih0 + lo) * q.W,
             plane, q.W, kResC, hi - lo, q.W);
  } else {
    res_zero_runs(xs, 0, q.xrs, 1, 0, lo);
    res_zero_runs(xs, 0, q.xrs, 1, hi, xr);
    res_runs(xs + lo * q.xrs + kResXoHwc + kResC, 0, q.xrs,
             x + (n * plane + static_cast<long long>(ih0 + lo) * q.W) * kResC,
             0, static_cast<long long>(q.W) * kResC, 1, hi - lo,
             q.W * kResC);
  }
  bf16* gs = xs + q.x_elems;
  if (GCHW) {
    const bf16* s = g + n * kResF * plane + static_cast<long long>(oh0) * q.W;
    if (q.wp == q.W)  // the band's rows are one run per feature
      res_runs(gs, q.grs, 0, s, plane, 0, kResF, 1, rows * q.W);
    else
      res_runs(gs, q.grs, q.wp, s, plane, q.W, kResF, rows, q.W);
  } else {
    res_stage_g_hwc(gs, q.wp,
                    g + (n * plane + static_cast<long long>(oh0) * q.W) *
                            kResF,
                    q.W, rows);
  }
}

template <bool TRANS>
__device__ __forceinline__ void res_ldmatrix_x4(unsigned (&r)[4],
                                                const bf16* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

__device__ __forceinline__ void res_mma(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The dW row (tap (kh*3 + kw)*3 + c) of column i of n8 tile j, or -1.
__device__ __forceinline__ int res_column_tap(int j, int i) {
  if (j < 3) return ((i / kResC) * kResK + j) * kResC + i % kResC;
  return i < kResK ? ((kResK - 1) * kResK + i) * kResC + kResC - 1 : -1;
}

template <bool XCHW, bool GCHW>
__device__ __forceinline__ void res_mma_body(const bf16* __restrict__ x,
                                             const bf16* __restrict__ g,
                                             float* __restrict__ partial,
                                             const ResGeometry& q,
                                             long long units) {
  extern __shared__ float4 res_smem4[];
  bf16* smem = reinterpret_cast<bf16*>(res_smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int S = q.stages;
  const long long u_begin = blockIdx.x * units / gridDim.x;
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;

  // Zero every stage once: the copies never write the pads.
  {
    uint4* s16 = reinterpret_cast<uint4*>(res_smem4);
    const int n16 = S * q.stage_elems / 8;
    for (int i = tid; i < n16; i += kResThreads)
      s16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // This lane's operands, relative to a chunk's staged x (padded column =
  // the chunk's first pixel) and g.  B: the lane's (kh, c) = (gid / 3,
  // gid % 3) at pixel 2t and its tile-3 value (2, 2) at kw = min(gid, 2).
  constexpr int px = XCHW ? 1 : kResC;  // elements per padded column
  const int cs = XCHW ? q.xplane : 1;   // elements per channel
  const int xo = XCHW ? kResXoChw : kResXoHwc;
  const int off_a =
      (gid / kResC) * q.xrs + (gid % kResC) * cs + xo + 2 * t * px;
  const int off_b =
      (kResK - 1) * (q.xrs + cs) + xo + (2 * t + min(gid, 2)) * px;
  // A: lane l addresses row l % 8 of the 8x8 matrix l / 8, the matrices
  // (features 0-7 | 8-15) x (pixels 0-7 | 8-15) in the order a0..a3.
  const int mat = lane >> 3, r8 = lane & 7;
  const int g_off =
      GCHW ? (r8 + 8 * (mat & 1)) * q.grs + 8 * (mat >> 1)
           : (r8 + 8 * (mat >> 1)) * kResF + 8 * ((mat & 1) ^ (r8 >> 2));
  const int g_row = GCHW ? q.wp : q.wp * kResF;  // elements per output row
  const int g_chunk = GCHW ? kResPix : kResPix * kResF;
  const int chunks = q.wp / kResPix;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // The next unit to stage: its (image, band) and ring slot; the band and
  // slot of the unit contracted.
  long long n_in = u_begin / q.bands;
  int band_in = static_cast<int>(u_begin - n_in * q.bands);
  int band_cur = band_in, slot_in = 0, slot_cur = 0;
  auto stage_next = [&](long long u) {
    if (u < u_end)
      res_mma_stage<XCHW, GCHW>(smem + slot_in * q.stage_elems, x, g, n_in,
                                band_in, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (++band_in == q.bands) {
      band_in = 0;
      ++n_in;
    }
    if (++slot_in == S) slot_in = 0;
  };
  for (int s = 0; s < S - 1; ++s) stage_next(u_begin + s);
  for (long long u = u_begin; u < u_end; ++u) {
    res_wait_pending(S - 2);  // this unit's copies have landed
    __syncthreads();          // ... every thread's, and the last stage is free
    stage_next(u + S - 1);
    const bf16* xs = smem + slot_cur * q.stage_elems;
    if (++slot_cur == S) slot_cur = 0;
    if (warp < min(kResRows, q.H - band_cur * kResRows)) {
      const unsigned short* xa =
          reinterpret_cast<const unsigned short*>(xs + warp * q.xrs) + off_a;
      const unsigned short* xb =
          reinterpret_cast<const unsigned short*>(xs + warp * q.xrs) + off_b;
      const bf16* ga = xs + q.x_elems + warp * g_row + g_off;
      float part[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll 2
      for (int cb = 0; cb < chunks; ++cb) {
        unsigned a[4];
        res_ldmatrix_x4<!GCHW>(a, ga + cb * g_chunk);
        unsigned b[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (cb * kResPix + 8 * h) * px;
          const unsigned v0 = xa[o], v1 = xa[o + px], v2 = xa[o + 2 * px],
                         v3 = xa[o + 3 * px];
          const unsigned w0 = xb[o], w1 = xb[o + px];
          b[0][h] = v0 | (v1 << 16);
          b[1][h] = v1 | (v2 << 16);
          b[2][h] = v2 | (v3 << 16);
          b[3][h] = w0 | (w1 << 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) res_mma(part[j], a, b[j][0], b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
    }
    if (++band_cur == q.bands) band_cur = 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Accumulator i of tile j is feature gid + 8*(i/2), column 2t + i%2.
  float* red = reinterpret_cast<float*>(res_smem4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tap = res_column_tap(j, 2 * t + (i & 1));
      if (tap >= 0)
        red[warp * kResOut + tap * kResF + gid + 8 * (i >> 1)] = acc[j][i];
    }
  __syncthreads();
  for (int o = tid; o < kResOut; o += kResThreads) {
    float v = 0.f;
    for (int w = 0; w < kResWarps; ++w) v += red[w * kResOut + o];
    partial[static_cast<size_t>(blockIdx.x) * kResOut + o] = v;
  }
}

// ---- the float32 body -------------------------------------------------------

template <typename T, bool XCHW, bool GCHW>
__device__ __forceinline__ void res_ffma_body(const T* __restrict__ x,
                                              const T* __restrict__ g,
                                              float* __restrict__ partial,
                                              const ResGeometry& q,
                                              long long units) {
  extern __shared__ float4 res_smem4[];
  T* smem = reinterpret_cast<T*>(res_smem4);
  constexpr int xo = 16 / static_cast<int>(sizeof(T)) - kResC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = lane >> 2;  // this thread's row of each band
  const int fq = lane & 3;    // its features: 4*fq .. 4*fq+3
  const int seg = (q.W + kResWarps - 1) / kResWarps;
  const int ow_begin = warp * seg;
  const int ow_end = min(q.W, ow_begin + seg);
  const long long u_begin = blockIdx.x * units / gridDim.x;
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;

  // Zero both stages once: the copies write only the interior columns, so
  // the SAME column pads stay zero.
  {
    uint4* s16 = reinterpret_cast<uint4*>(res_smem4);
    const int n16 = 2 * q.stage_elems * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < n16; i += kResThreads)
      s16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  float acc[kResTaps][kResFeat];
#pragma unroll
  for (int i = 0; i < kResTaps; ++i)
#pragma unroll
    for (int j = 0; j < kResFeat; ++j) acc[i][j] = 0.f;

  if (u_begin < u_end) res_stage_unit<T, XCHW, GCHW>(smem, x, g, u_begin, q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (long long u = u_begin; u < u_end; ++u) {
    const int buf = static_cast<int>(u - u_begin) & 1;
    if (u + 1 < u_end)
      res_stage_unit<T, XCHW, GCHW>(smem + (buf ^ 1) * q.stage_elems, x, g,
                                    u + 1, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const T* xs = smem + buf * q.stage_elems;
    const long long n = u / q.bands;
    const int oh0 = static_cast<int>(u - n * q.bands) * kResRows;
    if (row < min(kResRows, q.H - oh0) && ow_begin < ow_end) {
      // Padded column 0 of this row's first input row (kh = 0).
      const T* xr = xs + row * q.xrs + xo;
      const T* gr = xs + q.x_elems + row * q.grs + kResFeat * fq;
      float w0[kResK][kResC], w1[kResK][kResC];
#pragma unroll
      for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
        for (int c = 0; c < kResC; ++c) {
          w0[kh][c] = res_float(xr[kh * q.xrs + kResC * ow_begin + c]);
          w1[kh][c] = res_float(xr[kh * q.xrs + kResC * (ow_begin + 1) + c]);
        }
#pragma unroll 2
      for (int ow = ow_begin; ow < ow_end; ++ow) {
        float w2[kResK][kResC];
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < kResC; ++c)
            w2[kh][c] = res_float(xr[kh * q.xrs + kResC * (ow + 2) + c]);
        float gv[kResFeat];
        res_load4(gr + ow * kResF, gv);
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < kResC; ++c)
#pragma unroll
            for (int j = 0; j < kResFeat; ++j) {
              acc[(kh * kResK + 0) * kResC + c][j] =
                  fmaf(w0[kh][c], gv[j], acc[(kh * kResK + 0) * kResC + c][j]);
              acc[(kh * kResK + 1) * kResC + c][j] =
                  fmaf(w1[kh][c], gv[j], acc[(kh * kResK + 1) * kResC + c][j]);
              acc[(kh * kResK + 2) * kResC + c][j] =
                  fmaf(w2[kh][c], gv[j], acc[(kh * kResK + 2) * kResC + c][j]);
            }
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < kResC; ++c) {
            w0[kh][c] = w1[kh][c];
            w1[kh][c] = w2[kh][c];
          }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The warp's 8 rows (lanes 4*row + fq) by a fixed butterfly, then the
  // warps in index order through shared memory (the stages are free now).
#pragma unroll
  for (int i = 0; i < kResTaps; ++i)
#pragma unroll
    for (int j = 0; j < kResFeat; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  float* red = reinterpret_cast<float*>(res_smem4);
  if (row == 0) {
#pragma unroll
    for (int i = 0; i < kResTaps; ++i)
#pragma unroll
      for (int j = 0; j < kResFeat; ++j)
        red[warp * kResOut + i * kResF + kResFeat * fq + j] = acc[i][j];
  }
  __syncthreads();
  for (int o = tid; o < kResOut; o += kResThreads) {
    float v = 0.f;
    for (int w = 0; w < kResWarps; ++w) v += red[w * kResOut + o];
    partial[static_cast<size_t>(blockIdx.x) * kResOut + o] = v;
  }
}

template <typename T, bool XCHW, bool GCHW>
__global__ void __launch_bounds__(kResThreads, 1)
    resnet_stem_gradw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ partial, ResGeometry q,
                             long long units) {
  if constexpr (std::is_same_v<T, bf16>)
    res_mma_body<XCHW, GCHW>(x, g, partial, q, units);
  else
    res_ffma_body<T, XCHW, GCHW>(x, g, partial, q, units);
}

template <typename T, bool XCHW, bool GCHW>
cudaError_t launch_resnet(const T* x, const T* g, float* partial,
                          const ResGeometry& q, long long units,
                          int num_blocks, int smem_bytes, cudaStream_t s) {
  auto kernel = resnet_stem_gradw_kernel<T, XCHW, GCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kResThreads, smem_bytes, s>>>(x, g, partial, q, units);
  return cudaGetLastError();
}

// Whether (xrs, grs, x_elems, stage_elems, stages, xplane, wp) describe
// the staged band the body of the operand type T addresses (see
// conv_cuda.resnet_gradw_plan), with a ring of `stages` stages and the
// warps' final sums fitting in smem_bytes.
template <typename T>
bool resnet_layout_ok(int W, int xrs, int grs, int x_elems, int stage_elems,
                      int stages, int xplane, int wp, int smem_bytes,
                      bool x_chw, bool g_chw) {
  constexpr int item = static_cast<int>(sizeof(T));
  if ((xrs * item) % 16 || (grs * item) % 16 || (x_elems * item) % 16 ||
      (stage_elems * item) % 16 ||
      smem_bytes < stages * stage_elems * item ||
      smem_bytes < kResWarps * kResOut * static_cast<int>(sizeof(float)))
    return false;
  const int x_rows = kResRows + kResK - 1;
  if (!std::is_same_v<T, bf16>)
    return stages == 2 && xrs >= 16 / item + kResC * (W + 1) &&
           grs >= kResF * W && x_elems >= x_rows * xrs &&
           stage_elems >= x_elems + kResRows * grs;
  if (stages < 2 || stages > kResMaxStages || wp < W || wp % kResPix)
    return false;
  const bool x_ok =
      x_chw ? xrs >= kResXoChw + wp + 2 && (xplane * item) % 16 == 0 &&
                  xplane >= x_rows * xrs && x_elems >= kResC * xplane
            : xrs >= kResXoHwc + kResC * (wp + 2) && x_elems >= x_rows * xrs;
  const bool g_ok = g_chw ? grs >= kResRows * wp &&
                                stage_elems >= x_elems + kResF * grs
                          : grs == kResF * wp &&
                                stage_elems >= x_elems + kResRows * grs;
  return x_ok && g_ok;
}

template <typename T>
int resnet_gradw(const T* x, const T* g, float* partial, float* dw, int H,
                 int W, int bands, int xrs, int grs, int x_elems,
                 int stage_elems, int stages, int xplane, int wp,
                 int smem_bytes, int x_chw, int g_chw, long long units,
                 int num_blocks, void* stream) {
  if (H < 1 || W < 1 || bands != (H + kResRows - 1) / kResRows ||
      num_blocks < 1 || units < num_blocks ||
      !resnet_layout_ok<T>(W, xrs, grs, x_elems, stage_elems, stages, xplane,
                           wp, smem_bytes, x_chw, g_chw))
    return static_cast<int>(cudaErrorInvalidValue);
  const ResGeometry q{H,           W,      bands,  xrs, grs, x_elems,
                      stage_elems, stages, xplane, wp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_chw && g_chw)
    err = launch_resnet<T, true, true>(x, g, partial, q, units, num_blocks,
                                       smem_bytes, s);
  else if (x_chw)
    err = launch_resnet<T, true, false>(x, g, partial, q, units, num_blocks,
                                        smem_bytes, s);
  else if (g_chw)
    err = launch_resnet<T, false, true>(x, g, partial, q, units, num_blocks,
                                        smem_bytes, s);
  else
    err = launch_resnet<T, false, false>(x, g, partial, q, units, num_blocks,
                                         smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(kResOut + 255) / 256, 256, 0, s>>>(
      partial, dw, kResOut, num_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shallow stem's grad-W at 3 input channels (RGB frames: DMLab, the
// fake and gym levels, Doom) and at 4 (Atari's grayscale stack of 4).
int sat_conv_gradw(const float* x, const float* g,
    float* partial, float* dw, int H, int W, int OH, int OW, int pad_h,
    int pad_w, int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<float, 3>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

int sat_conv_gradw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
    float* partial, float* dw, int H, int W, int OH, int OW, int pad_h,
    int pad_w, int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<__nv_bfloat16, 3>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

int sat_conv_gradw_c4(const float* x, const float* g,
    float* partial, float* dw, int H, int W, int OH, int OW, int pad_h,
    int pad_w, int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<float, 4>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

int sat_conv_gradw_c4_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
    float* partial, float* dw, int H, int W, int OH, int OW, int pad_h,
    int pad_w, int band_rows, int bands, int xrs, int x_floats, int gps,
    int stage_floats, int smem_bytes, int x_chw, int g_chw, long long units,
    int num_blocks, void* stream) {
  return gradw<__nv_bfloat16, 4>(x, g, partial, dw, H, W, OH, OW, pad_h, pad_w,
      band_rows, bands, xrs, x_floats, gps, stage_floats, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

int sat_resnet_stem_gradw(const float* x, const float* g, float* partial,
                          float* dw, int H, int W, int bands, int xrs,
                          int grs, int x_elems, int stage_elems, int stages,
                          int xplane, int wp, int smem_bytes, int x_chw,
                          int g_chw, long long units, int num_blocks,
                          void* stream) {
  return resnet_gradw<float>(x, g, partial, dw, H, W, bands, xrs, grs,
                             x_elems, stage_elems, stages, xplane, wp,
                             smem_bytes, x_chw, g_chw, units, num_blocks,
                             stream);
}

int sat_resnet_stem_gradw_bf16(const __nv_bfloat16* x,
                               const __nv_bfloat16* g, float* partial,
                               float* dw, int H, int W, int bands, int xrs,
                               int grs, int x_elems, int stage_elems,
                               int stages, int xplane, int wp, int smem_bytes,
                               int x_chw, int g_chw, long long units,
                               int num_blocks, void* stream) {
  return resnet_gradw<__nv_bfloat16>(x, g, partial, dw, H, W, bands, xrs,
                                     grs, x_elems, stage_elems, stages,
                                     xplane, wp, smem_bytes, x_chw, g_chw,
                                     units, num_blocks, stream);
}

}  // extern "C"
