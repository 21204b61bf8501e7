// Hand-written Hopper (sm_90a) kernel for the weight gradient of the
// torso's SAME-padded strided stem conv.
//
// Replaces scalable_agent_tpu/ops/conv_pallas.py::_gradw_kernel.  The TPU
// kernel re-lays the padded input out by space-to-depth, gathers the D*D
// taps as contiguous slices, and accumulates the [K*K*C, F] product across
// a sequential grid over batch tiles in VMEM scratch.  What it computes is
// the row contraction
//
//   dW[kh, kw, c, f] = sum_{n, oh, ow} x[n, oh*S + kh - ph, ow*S + kw - pw, c]
//                                      * g[n, oh, ow, f]
//
// over P = N*OH*OW rows (1.4 M at the main path's N=3232, 72x96 frames).
//
// Design here: blocks cannot carry a sum from one to the next, so each block
// owns a contiguous range of rows and writes its own [K*K*C, F] partial sum;
// a second kernel reduces the partials in a fixed order (deterministic, no
// atomics).  The im2col gather happens inside the block: a tile of TP rows'
// patches is staged in shared memory straight from x, with the SAME padding
// applied as bounds checks (nothing padded is materialised), x and g are
// read through element strides so an NCHW or channels-last tensor is taken
// as a view without a copy, and the output is written in HWIO order
// directly (the TPU kernel's (dh, dw, sh, sw, c) row order needs no undoing).
// Each thread accumulates a RI x 4 register tile of the output.
// Bound on the card: 17 GFLOP of f32 FMA over ~0.45 GB of input, i.e.
// compute-bound at ~0.26 ms; see PERF.md for what this simple design gets.

#include <cuda_runtime.h>

namespace {

constexpr int kTP = 32;        // rows (output positions) per staged tile
constexpr int kThreads = 256;
constexpr int kMaxRI = 8;      // output rows per thread

__global__ void conv_gradw_partial_kernel(
    const float* __restrict__ x, long long sxn, long long sxh, long long sxw,
    long long sxc, const float* __restrict__ g, long long sgn, long long sgh,
    long long sgw, long long sgf, float* __restrict__ partial, int H, int W,
    int C, int OH, int OW, int F, int K, int S, int pad_h, int pad_w,
    long long num_rows, long long rows_per_block) {
  extern __shared__ float smem[];
  const int R = K * K * C;
  float* sp = smem;             // patches, [kTP][R]
  float* sg = smem + kTP * R;   // cotangent rows, [kTP][F]
  const int tid = threadIdx.x;
  const int tf_count = F / 4;   // thread columns, 4 consecutive f each
  const int tr_count = kThreads / tf_count;
  const int tf = tid % tf_count;
  const int tr = tid / tf_count;
  const bool active = tr < tr_count;
  const int ri = (R + tr_count - 1) / tr_count;
  float acc[kMaxRI][4];
#pragma unroll
  for (int i = 0; i < kMaxRI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  const long long p_begin = (long long)blockIdx.x * rows_per_block;
  long long p_end = p_begin + rows_per_block;
  if (p_end > num_rows) p_end = num_rows;
  const int plane = OH * OW;
  for (long long p0 = p_begin; p0 < p_end; p0 += kTP) {
    for (int e = tid; e < kTP * R; e += kThreads) {
      const int pp = e / R;
      const int r = e - pp * R;
      const long long p = p0 + pp;
      float v = 0.f;
      if (p < p_end) {
        const long long n = p / plane;
        const int rem = (int)(p - n * plane);
        const int oh = rem / OW;
        const int ow = rem - oh * OW;
        const int kh = r / (K * C);
        const int r2 = r - kh * K * C;
        const int kw = r2 / C;
        const int c = r2 - kw * C;
        const int ih = oh * S + kh - pad_h;
        const int iw = ow * S + kw - pad_w;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = __ldg(x + n * sxn + ih * sxh + iw * sxw + c * sxc);
      }
      sp[pp * R + r] = v;
    }
    for (int e = tid; e < kTP * F; e += kThreads) {
      const int pp = e / F;
      const int f = e - pp * F;
      const long long p = p0 + pp;
      float v = 0.f;
      if (p < p_end) {
        const long long n = p / plane;
        const int rem = (int)(p - n * plane);
        const int oh = rem / OW;
        const int ow = rem - oh * OW;
        v = __ldg(g + n * sgn + oh * sgh + ow * sgw + f * sgf);
      }
      sg[pp * F + f] = v;
    }
    __syncthreads();
    if (active) {
      for (int pp = 0; pp < kTP; ++pp) {
        const float* gp = sg + pp * F + tf * 4;
        const float g0 = gp[0], g1 = gp[1], g2 = gp[2], g3 = gp[3];
        const float* xp = sp + pp * R;
#pragma unroll
        for (int i = 0; i < kMaxRI; ++i) {
          if (i < ri) {
            const int r = tr + i * tr_count;
            const float xv = (r < R) ? xp[r] : 0.f;
            acc[i][0] = fmaf(xv, g0, acc[i][0]);
            acc[i][1] = fmaf(xv, g1, acc[i][1]);
            acc[i][2] = fmaf(xv, g2, acc[i][2]);
            acc[i][3] = fmaf(xv, g3, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* out = partial + (size_t)blockIdx.x * R * F;
#pragma unroll
  for (int i = 0; i < kMaxRI; ++i) {
    const int r = tr + i * tr_count;
    if (i < ri && r < R) {
#pragma unroll
      for (int q = 0; q < 4; ++q) out[(size_t)r * F + tf * 4 + q] = acc[i][q];
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

}  // namespace

extern "C" {

// Largest number of output rows each thread may own, for the host-side
// shape check.
int sat_conv_gradw_max_rows_per_thread() { return kMaxRI; }
int sat_conv_gradw_threads() { return kThreads; }
int sat_conv_gradw_tile_rows() { return kTP; }

int sat_conv_gradw(const float* x, long long sxn, long long sxh,
                   long long sxw, long long sxc, const float* g,
                   long long sgn, long long sgh, long long sgw, long long sgf,
                   float* partial, float* dw, int N, int H, int W, int C,
                   int OH, int OW, int F, int K, int S, int pad_h, int pad_w,
                   long long rows_per_block, int num_blocks, void* stream) {
  const int R = K * K * C;
  const size_t shared = (size_t)kTP * (R + F) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_gradw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const long long num_rows = (long long)N * OH * OW;
  conv_gradw_partial_kernel<<<num_blocks, kThreads, shared, s>>>(
      x, sxn, sxh, sxw, sxc, g, sgn, sgh, sgw, sgf, partial, H, W, C, OH, OW,
      F, K, S, pad_h, pad_w, num_rows, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outputs = R * F;
  reduce_partials_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      partial, dw, outputs, num_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
