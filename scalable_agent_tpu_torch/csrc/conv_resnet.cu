// Hand-written Hopper (sm_90a) kernel for the weight gradient of the
// ResNet torso's stem (downscale_0): SAME 3x3 / stride 1, 3 channels (RGB
// frames) or 4 (Atari's grayscale stack) into 16 features, at the frame's
// full resolution.
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
// against 0.02 ms on bf16 tensor cores.  At C = 4 (Atari's 84x84 frames,
// dW[36, 16]) x is 20% of the bytes and the FMAs grow by a third.  One
// template, resnet_stem_gradw_kernel<T, C, XCHW, GCHW>, has a body for each
// operand type; both work on bands of kResRows = 8 whole output rows of one
// image
// and are deterministic the same way: block b owns the (image, band) units
// [b*U/B, (b+1)*U/B) in order, each warp sums in a fixed order, the warps
// are summed in index order through shared memory, and the blocks'
// partials by reduce_partials_kernel in block order, so two calls give
// bitwise-equal dW.  Entry points: sat_resnet_stem_gradw and
// sat_resnet_stem_gradw_bf16, and at C = 4 sat_resnet_stem_gradw_c4 and
// sat_resnet_stem_gradw_c4_bf16.
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
//   The 8 rows of a warp are summed by a fixed butterfly of shuffles.  At
//   C = 4 a thread holds the 36 patch rows for 2 features (72 accumulators;
//   ResC<4>::kFeat), so a warp is 4 rows by 8 feature eighths and two
//   warps cover the band's 8 rows of one quarter of the columns.
//
// bf16 (tensor cores; res_mma_body): at half the bytes an FFMA loop like
// the float32 one was the limit (0.64 ms against 0.25 ms of bytes), so the
// contraction runs on mma.sync.m16n8k16 bf16 with float32 accumulators:
//   dW^T[16 features, 32 columns] += G^T[16, 16 pixels] . P[16 pixels, 32]
// M the 16 features (one m16 tile), N the 27 taps padded to 32 (four n8
// tiles; at C = 4 the 36 taps padded to 40, five), K 16 pixels of one
// output row: 4 (5) mma.sync per 16 pixels and 16 (20) float32
// accumulators a thread.  (wgmma's 64-row tiles would be three
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
//   At C = 4 (res_column_tap): tiles 0-2 are kw = j with (kh, c) = (i / 4,
//   i % 4) for kh < 2, built as above; tile 3 is kh = 2 at (kw, c) =
//   (i / 4, i % 4) and tile 4 kh = 2, kw = 2 at c = i < 4, two loads each:
//   16 loads and 10 packs per 16 pixels.
// * Warp w contracts output row w of each band (a band of the last rows
//   may have fewer), its 16-pixel chunks in order into a fresh accumulator
//   that is added to the running float32 sums at the end of the band, so no
//   tensor-core accumulation runs longer than one row.

#include "conv_common.cuh"

namespace {

constexpr int kResK = 3;
constexpr int kResF = 16;
constexpr int kResRows = 8;                      // output rows per band

// The ResNet stem's sizes at C input channels: its dW rows (taps), the
// features one thread of the float32 body holds (4 at C = 3: 27 x 4
// accumulators; 2 at C = 4, where 36 x 4 would near the register file),
// and the bf16 body's n8 tiles (the taps padded to 32 or 40 columns).
template <int C>
struct ResC {
  static constexpr int kTaps = kResK * kResK * C;  // 27 or 36 rows of dW
  static constexpr int kOut = kTaps * kResF;       // 432 or 576
  static constexpr int kFeat = C == 3 ? 4 : 2;     // float32 features a thread
  static constexpr int kTiles = C == 3 ? 4 : 5;    // bf16 n8 tiles
};

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

template <int N>
__device__ __forceinline__ void res_load(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
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
// xo + C*pc with xo = 16 / sizeof(T) - C, so the data (pc = 1) starts
// 16-byte aligned.
template <typename T, int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void res_stage_unit(T* xs, const T* x, const T* g,
                                               long long u,
                                               const ResGeometry& q) {
  constexpr int xo = 16 / static_cast<int>(sizeof(T)) - C;
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
  T* xdst = xs + lo * q.xrs + xo + C;
  const T* ximg = x + n * plane * C;
  if (XCHW)
    res_copy_planes<C>(xdst, q.xrs,
                       ximg + static_cast<long long>(ih0 + lo) * q.W, plane,
                       hi - lo, q.W);
  else
    res_copy_rows(xdst, q.xrs,
                  ximg + static_cast<long long>(ih0 + lo) * q.W * C,
                  static_cast<long long>(q.W) * C, hi - lo, q.W * C);
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

constexpr int kResPix = 16;     // pixels of one mma.sync step (its K)
constexpr int kResXoChw = 7;    // element of padded column 0 in a staged
                                // planar x row: data (column 1) 16-byte
                                // aligned

// The same for a staged NHWC x row of C channels: 5 at C = 3, 4 at C = 4.
__host__ __device__ constexpr int res_xo_hwc(int C) { return 8 - C; }

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
// r*xrs + xo + C*pc + c (NHWC, xo = res_xo_hwc(C)) or
// c*xplane + r*xrs + kResXoChw + pc (planar).  Staged g, from
// xs + x_elems: output row r, pixel p, feature f at
// (r*wp + p)*16 + (f ^ (8 * bit 2 of p)) (NHWC) or f*grs + r*wp + p.
template <int C, bool XCHW, bool GCHW>
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
    res_zero_runs(xs, q.xplane, q.xrs, C, 0, lo);
    res_zero_runs(xs, q.xplane, q.xrs, C, hi, xr);
    res_runs(xs + lo * q.xrs + kResXoChw + 1, q.xplane, q.xrs,
             x + n * C * plane + static_cast<long long>(ih0 + lo) * q.W,
             plane, q.W, C, hi - lo, q.W);
  } else {
    res_zero_runs(xs, 0, q.xrs, 1, 0, lo);
    res_zero_runs(xs, 0, q.xrs, 1, hi, xr);
    res_runs(xs + lo * q.xrs + res_xo_hwc(C) + C, 0, q.xrs,
             x + (n * plane + static_cast<long long>(ih0 + lo) * q.W) * C, 0,
             static_cast<long long>(q.W) * C, 1, hi - lo, q.W * C);
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

// The dW row (tap (kh*3 + kw)*C + c) of column i of n8 tile j, or -1.
// C = 3: tile j < 3 is kw = j with (kh, c) = (i / 3, i % 3) for the first
// 8 of the 9 (kh, c); tile 3 holds the ninth, (2, 2), at kw = i < 3.
// C = 4: tile j < 3 is kw = j with (kh, c) = (i / 4, i % 4), kh < 2;
// tile 3 is kh = 2 at (kw, c) = (i / 4, i % 4), tile 4 kh = 2, kw = 2 at
// c = i < 4.
template <int C>
__device__ __forceinline__ int res_column_tap(int j, int i) {
  if (j < 3) return ((i / C) * kResK + j) * C + i % C;
  if constexpr (C == 3)
    return i < kResK ? ((kResK - 1) * kResK + i) * C + C - 1 : -1;
  if (j == 3) return ((kResK - 1) * kResK + i / 4) * C + i % 4;
  return i < C ? ((kResK - 1) * kResK + 2) * C + i : -1;
}

template <int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void res_mma_body(const bf16* __restrict__ x,
                                             const bf16* __restrict__ g,
                                             float* __restrict__ partial,
                                             const ResGeometry& q,
                                             long long units) {
  using R = ResC<C>;
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
  // the chunk's first pixel) and g.  B: the lane's (kh, c) = (gid / C,
  // gid % C) at pixel 2t for tiles 0-2; at C = 3 its tile-3 value (2, 2)
  // at kw = min(gid, 2); at C = 4 its tile-3 value (2, gid % 4) at
  // kw = gid / 4 and its tile-4 value (2, gid % 4) at kw = 2.
  constexpr int px = XCHW ? 1 : C;  // elements per padded column
  const int cs = XCHW ? q.xplane : 1;  // elements per channel
  const int xo = XCHW ? kResXoChw : res_xo_hwc(C);
  const int off_a = (gid / C) * q.xrs + (gid % C) * cs + xo + 2 * t * px;
  const int off_b =
      C == 3 ? (kResK - 1) * (q.xrs + cs) + xo + (2 * t + min(gid, 2)) * px
             : (kResK - 1) * q.xrs + (gid % 4) * cs + xo +
                   (2 * t + gid / 4) * px;
  const int off_c =
      (kResK - 1) * q.xrs + (gid % 4) * cs + xo + (2 * t + 2) * px;
  // A: lane l addresses row l % 8 of the 8x8 matrix l / 8, the matrices
  // (features 0-7 | 8-15) x (pixels 0-7 | 8-15) in the order a0..a3.
  const int mat = lane >> 3, r8 = lane & 7;
  const int g_off =
      GCHW ? (r8 + 8 * (mat & 1)) * q.grs + 8 * (mat >> 1)
           : (r8 + 8 * (mat >> 1)) * kResF + 8 * ((mat & 1) ^ (r8 >> 2));
  const int g_row = GCHW ? q.wp : q.wp * kResF;  // elements per output row
  const int g_chunk = GCHW ? kResPix : kResPix * kResF;
  const int chunks = q.wp / kResPix;

  float acc[R::kTiles][4];
#pragma unroll
  for (int j = 0; j < R::kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // The next unit to stage: its (image, band) and ring slot; the band and
  // slot of the unit contracted.
  long long n_in = u_begin / q.bands;
  int band_in = static_cast<int>(u_begin - n_in * q.bands);
  int band_cur = band_in, slot_in = 0, slot_cur = 0;
  auto stage_next = [&](long long u) {
    if (u < u_end)
      res_mma_stage<C, XCHW, GCHW>(smem + slot_in * q.stage_elems, x, g,
                                   n_in, band_in, q);
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
      const unsigned short* xrow =
          reinterpret_cast<const unsigned short*>(xs + warp * q.xrs);
      const unsigned short* xa = xrow + off_a;
      const unsigned short* xb = xrow + off_b;
      const unsigned short* xc = xrow + off_c;
      const bf16* ga = xs + q.x_elems + warp * g_row + g_off;
      float part[R::kTiles][4];
#pragma unroll
      for (int j = 0; j < R::kTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll 2
      for (int cb = 0; cb < chunks; ++cb) {
        unsigned a[4];
        res_ldmatrix_x4<!GCHW>(a, ga + cb * g_chunk);
        unsigned b[R::kTiles][2];
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
          if constexpr (C == 4) {
            const unsigned y0 = xc[o], y1 = xc[o + px];
            b[4][h] = y0 | (y1 << 16);
          }
        }
#pragma unroll
        for (int j = 0; j < R::kTiles; ++j)
          res_mma(part[j], a, b[j][0], b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < R::kTiles; ++j)
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
  for (int j = 0; j < R::kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tap = res_column_tap<C>(j, 2 * t + (i & 1));
      if (tap >= 0)
        red[warp * R::kOut + tap * kResF + gid + 8 * (i >> 1)] = acc[j][i];
    }
  __syncthreads();
  for (int o = tid; o < R::kOut; o += kResThreads) {
    float v = 0.f;
    for (int w = 0; w < kResWarps; ++w) v += red[w * R::kOut + o];
    partial[static_cast<size_t>(blockIdx.x) * R::kOut + o] = v;
  }
}

// ---- the float32 body -------------------------------------------------------

template <typename T, int C, bool XCHW, bool GCHW>
__device__ __forceinline__ void res_ffma_body(const T* __restrict__ x,
                                              const T* __restrict__ g,
                                              float* __restrict__ partial,
                                              const ResGeometry& q,
                                              long long units) {
  using R = ResC<C>;
  // A warp is kWarpRows rows of the band by kGroups feature groups of kFT
  // features; kRowSplit warps cover the band's 8 rows of one column
  // segment, and the block's warps kSegs segments of the row.
  constexpr int kFT = R::kFeat;
  constexpr int kGroups = kResF / kFT;
  constexpr int kWarpRows = 32 / kGroups;
  constexpr int kRowSplit = kResRows / kWarpRows;
  constexpr int kSegs = kResWarps / kRowSplit;
  static_assert(kWarpRows * kRowSplit == kResRows,
                "a band's rows split evenly over the warps");
  extern __shared__ float4 res_smem4[];
  T* smem = reinterpret_cast<T*>(res_smem4);
  constexpr int xo = 16 / static_cast<int>(sizeof(T)) - C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // This thread's row of each band and its features kFT*fq .. +kFT-1.
  const int row = lane / kGroups + kWarpRows * (warp % kRowSplit);
  const int fq = lane % kGroups;
  const int seg = (q.W + kSegs - 1) / kSegs;
  const int ow_begin = (warp / kRowSplit) * seg;
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

  float acc[R::kTaps][kFT];
#pragma unroll
  for (int i = 0; i < R::kTaps; ++i)
#pragma unroll
    for (int j = 0; j < kFT; ++j) acc[i][j] = 0.f;

  if (u_begin < u_end)
    res_stage_unit<T, C, XCHW, GCHW>(smem, x, g, u_begin, q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (long long u = u_begin; u < u_end; ++u) {
    const int buf = static_cast<int>(u - u_begin) & 1;
    if (u + 1 < u_end)
      res_stage_unit<T, C, XCHW, GCHW>(smem + (buf ^ 1) * q.stage_elems, x,
                                       g, u + 1, q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const T* xs = smem + buf * q.stage_elems;
    const long long n = u / q.bands;
    const int oh0 = static_cast<int>(u - n * q.bands) * kResRows;
    if (row < min(kResRows, q.H - oh0) && ow_begin < ow_end) {
      // Padded column 0 of this row's first input row (kh = 0).
      const T* xr = xs + row * q.xrs + xo;
      const T* gr = xs + q.x_elems + row * q.grs + kFT * fq;
      float w0[kResK][C], w1[kResK][C];
#pragma unroll
      for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          w0[kh][c] = res_float(xr[kh * q.xrs + C * ow_begin + c]);
          w1[kh][c] = res_float(xr[kh * q.xrs + C * (ow_begin + 1) + c]);
        }
#pragma unroll 2
      for (int ow = ow_begin; ow < ow_end; ++ow) {
        float w2[kResK][C];
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < C; ++c)
            w2[kh][c] = res_float(xr[kh * q.xrs + C * (ow + 2) + c]);
        float gv[kFT];
        res_load<kFT>(gr + ow * kResF, gv);
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int j = 0; j < kFT; ++j) {
              acc[(kh * kResK + 0) * C + c][j] =
                  fmaf(w0[kh][c], gv[j], acc[(kh * kResK + 0) * C + c][j]);
              acc[(kh * kResK + 1) * C + c][j] =
                  fmaf(w1[kh][c], gv[j], acc[(kh * kResK + 1) * C + c][j]);
              acc[(kh * kResK + 2) * C + c][j] =
                  fmaf(w2[kh][c], gv[j], acc[(kh * kResK + 2) * C + c][j]);
            }
#pragma unroll
        for (int kh = 0; kh < kResK; ++kh)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            w0[kh][c] = w1[kh][c];
            w1[kh][c] = w2[kh][c];
          }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The warp's rows (lanes kGroups*row + fq) by a fixed butterfly, then
  // the warps in index order through shared memory (the stages are free
  // now).
#pragma unroll
  for (int i = 0; i < R::kTaps; ++i)
#pragma unroll
    for (int j = 0; j < kFT; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int m = kGroups; m < 32; m *= 2)
        v += __shfl_xor_sync(0xffffffffu, v, m);
      acc[i][j] = v;
    }
  float* red = reinterpret_cast<float*>(res_smem4);
  if (lane < kGroups) {
#pragma unroll
    for (int i = 0; i < R::kTaps; ++i)
#pragma unroll
      for (int j = 0; j < kFT; ++j)
        red[warp * R::kOut + i * kResF + kFT * fq + j] = acc[i][j];
  }
  __syncthreads();
  for (int o = tid; o < R::kOut; o += kResThreads) {
    float v = 0.f;
    for (int w = 0; w < kResWarps; ++w) v += red[w * R::kOut + o];
    partial[static_cast<size_t>(blockIdx.x) * R::kOut + o] = v;
  }
}

template <typename T, int C, bool XCHW, bool GCHW>
__global__ void __launch_bounds__(kResThreads, 1)
    resnet_stem_gradw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ partial, ResGeometry q,
                             long long units) {
  if constexpr (std::is_same_v<T, bf16>)
    res_mma_body<C, XCHW, GCHW>(x, g, partial, q, units);
  else
    res_ffma_body<T, C, XCHW, GCHW>(x, g, partial, q, units);
}

template <typename T, int C, bool XCHW, bool GCHW>
cudaError_t launch_resnet(const T* x, const T* g, float* partial,
                          const ResGeometry& q, long long units,
                          int num_blocks, int smem_bytes, cudaStream_t s) {
  auto kernel = resnet_stem_gradw_kernel<T, C, XCHW, GCHW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kResThreads, smem_bytes, s>>>(x, g, partial, q, units);
  return cudaGetLastError();
}

// Whether (xrs, grs, x_elems, stage_elems, stages, xplane, wp) describe
// the staged band the body of the operand type T addresses at C channels
// (see conv_cuda.resnet_gradw_plan), with a ring of `stages` stages and
// the warps' final sums fitting in smem_bytes.
template <typename T, int C>
bool resnet_layout_ok(int W, int xrs, int grs, int x_elems, int stage_elems,
                      int stages, int xplane, int wp, int smem_bytes,
                      bool x_chw, bool g_chw) {
  constexpr int item = static_cast<int>(sizeof(T));
  if ((xrs * item) % 16 || (grs * item) % 16 || (x_elems * item) % 16 ||
      (stage_elems * item) % 16 ||
      smem_bytes < stages * stage_elems * item ||
      smem_bytes < kResWarps * ResC<C>::kOut * static_cast<int>(sizeof(float)))
    return false;
  const int x_rows = kResRows + kResK - 1;
  if (!std::is_same_v<T, bf16>)
    return stages == 2 && xrs >= 16 / item + C * (W + 1) &&
           grs >= kResF * W && x_elems >= x_rows * xrs &&
           stage_elems >= x_elems + kResRows * grs;
  if (stages < 2 || stages > kResMaxStages || wp < W || wp % kResPix)
    return false;
  const bool x_ok =
      x_chw ? xrs >= kResXoChw + wp + 2 && (xplane * item) % 16 == 0 &&
                  xplane >= x_rows * xrs && x_elems >= C * xplane
            : xrs >= res_xo_hwc(C) + C * (wp + 2) && x_elems >= x_rows * xrs;
  const bool g_ok = g_chw ? grs >= kResRows * wp &&
                                stage_elems >= x_elems + kResF * grs
                          : grs == kResF * wp &&
                                stage_elems >= x_elems + kResRows * grs;
  return x_ok && g_ok;
}

template <typename T, int C>
int resnet_gradw(const T* x, const T* g, float* partial, float* dw, int H,
                 int W, int bands, int xrs, int grs, int x_elems,
                 int stage_elems, int stages, int xplane, int wp,
                 int smem_bytes, int x_chw, int g_chw, long long units,
                 int num_blocks, void* stream) {
  if (H < 1 || W < 1 || bands != (H + kResRows - 1) / kResRows ||
      num_blocks < 1 || units < num_blocks ||
      !resnet_layout_ok<T, C>(W, xrs, grs, x_elems, stage_elems, stages,
                              xplane, wp, smem_bytes, x_chw, g_chw))
    return static_cast<int>(cudaErrorInvalidValue);
  const ResGeometry q{H,           W,      bands,  xrs, grs, x_elems,
                      stage_elems, stages, xplane, wp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_chw && g_chw)
    err = launch_resnet<T, C, true, true>(x, g, partial, q, units,
                                          num_blocks, smem_bytes, s);
  else if (x_chw)
    err = launch_resnet<T, C, true, false>(x, g, partial, q, units,
                                           num_blocks, smem_bytes, s);
  else if (g_chw)
    err = launch_resnet<T, C, false, true>(x, g, partial, q, units,
                                           num_blocks, smem_bytes, s);
  else
    err = launch_resnet<T, C, false, false>(x, g, partial, q, units,
                                            num_blocks, smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int outputs = ResC<C>::kOut;
  reduce_partials_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      partial, dw, outputs, num_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The ResNet stem's grad-W at 3 input channels and at Atari's 4,
// float32 and bf16 operands.
int sat_resnet_stem_gradw(const float* x, const float* g,
    float* partial, float* dw,
    int H, int W, int bands, int xrs, int grs, int x_elems, int stage_elems,
    int stages, int xplane, int wp, int smem_bytes, int x_chw, int g_chw,
    long long units, int num_blocks, void* stream) {
  return resnet_gradw<float, 3>(x, g, partial, dw, H, W, bands, xrs, grs,
      x_elems, stage_elems, stages, xplane, wp, smem_bytes, x_chw, g_chw,
      units, num_blocks, stream);
}

int sat_resnet_stem_gradw_bf16(const __nv_bfloat16* x,
    const __nv_bfloat16* g, float* partial, float* dw,
    int H, int W, int bands, int xrs, int grs, int x_elems, int stage_elems,
    int stages, int xplane, int wp, int smem_bytes, int x_chw, int g_chw,
    long long units, int num_blocks, void* stream) {
  return resnet_gradw<__nv_bfloat16, 3>(x, g, partial, dw, H, W, bands,
      xrs, grs, x_elems, stage_elems, stages, xplane, wp, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

int sat_resnet_stem_gradw_c4(const float* x, const float* g,
    float* partial, float* dw,
    int H, int W, int bands, int xrs, int grs, int x_elems, int stage_elems,
    int stages, int xplane, int wp, int smem_bytes, int x_chw, int g_chw,
    long long units, int num_blocks, void* stream) {
  return resnet_gradw<float, 4>(x, g, partial, dw, H, W, bands, xrs, grs,
      x_elems, stage_elems, stages, xplane, wp, smem_bytes, x_chw, g_chw,
      units, num_blocks, stream);
}

int sat_resnet_stem_gradw_c4_bf16(const __nv_bfloat16* x,
    const __nv_bfloat16* g, float* partial, float* dw,
    int H, int W, int bands, int xrs, int grs, int x_elems, int stage_elems,
    int stages, int xplane, int wp, int smem_bytes, int x_chw, int g_chw,
    long long units, int num_blocks, void* stream) {
  return resnet_gradw<__nv_bfloat16, 4>(x, g, partial, dw, H, W, bands,
      xrs, grs, x_elems, stage_elems, stages, xplane, wp, smem_bytes, x_chw,
      g_chw, units, num_blocks, stream);
}

}  // extern "C"
