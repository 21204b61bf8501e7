// Hand-written Hopper (sm_90a) kernels for the done-reset LSTM core.
//
// Counterpart of scalable_agent_tpu/ops/lstm_pallas.py.  Four kernels and
// a plain C interface (loaded with ctypes by ops/_build.py):
//
// * lstm_step_kernel         replaces _fwd_kernel_lean at the actor's T=1
//   (one launch per step; a T>1 forward that needs no gradient is T
//   launches).  The step is a [B, D+H] x [D+H, 4H] product plus the cell:
//   at B=32, D=266, H=256 it moves 2.3 MB (0.7 us at 3.35 TB/s) and does
//   34 MFLOP, so what bounds it on this card is latency: one launch, the
//   weights' trip from L2, a short reduction.  Giving one block to each
//   batch row (as lstm_fwd_kernel below does) keeps 32 of 132 SMs busy,
//   each thread walking all 522 weight rows with dependent L2 loads and
//   every block re-reading the same 2.1 MB: ~10x slower.  Here the gate
//   columns are split across the card instead: a cluster of 4 CTAs owns 8
//   hidden units j0..j0+7 (their 32 gate columns j, H+j, 2H+j, 3H+j) for
//   every batch row, so the pointwise cell stays inside the cluster.  Each CTA takes a quarter of the 522-deep
//   reduction: it stages its [131, 8 units x 4 gates] slice of [Wi; Wh] in
//   shared memory once (32-byte segments, every weight byte read once per
//   launch, the learner's [D, 4H] layout as it is) and [x | keep*h] for 32
//   batch rows at a time, then each thread accumulates the 4 gates of one
//   (row, unit).  The four partial gate vectors are summed through
//   distributed shared memory (cluster.map_shared_rank) in rank order, a
//   fixed order, by the CTA that owns the row; it applies the bias and the
//   cell.  For H=256 that is 128 CTAs, one per SM.
//
// * lstm_fwd_kernel          replaces _fwd_kernel (the residual forward for
//   BPTT).  On the TPU the grid runs T in order and keeps the (c, h) carry
//   in VMEM.  Here batch rows are independent, so one block owns one batch
//   row and loops over T itself: the carry stays in registers (thread j
//   owns hidden unit j, all four of its gates), and no synchronisation
//   between blocks is needed.  The block computes x_t.Wi + h.Wh + b in its
//   own body, reading Wi/Wh coalesced from L2 (2.1 MB of f32 weights stay
//   resident in the 50 MB L2 across steps).  Bound on the card: at T=101,
//   B=32 the work is 3.4 GFLOP, compute-bound at ~51 us of f32 FMA.  This
//   simple design re-reads both weight matrices from L2 every step with
//   only B SMs busy and runs far from that bound; PERF.md has its time.
//
// * lstm_bwd_chain_kernel    the sequential half of _bwd_kernel: the
//   reverse dh/dc chain (one block per row, carried grads masked by keep),
//   dgates [T,B,4H] stashed to device memory, and dh_prev = dgates.Wh^T as
//   a warp-cooperative coalesced reduction.  The TPU kernel accumulated
//   dWi/dWh/db across its sequential grid in VMEM scratch; blocks on Hopper
//   cannot, so those products (and dx = dgates.Wi^T, which feeds no
//   recurrence) leave the chain and run in sgemm_kernel over the T*B rows.
//
// * sgemm_kernel             a strided f32 tiled GEMM (64x64 tiles, 16-deep
//   k-slices in shared memory, 4x4 outputs per thread).  Strides make every
//   transpose a view: dWi = x^T.dgates, dWh = hpost^T.dgates,
//   db = 1^T.dgates (stride-0 ones) and dx = dgates.Wi^T.  Single pass,
//   no atomics: each output is summed by one thread in row order, so the
//   result is deterministic.
//
// Every entry point launches on the caller's stream, allocates nothing,
// keeps no state between launches, and returns cudaGetLastError() so a
// refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

constexpr int kStepUnits = 8;   // hidden units per cluster: 32 gate columns
constexpr int kStepSplit = 4;   // CTAs per cluster, each a quarter of D+H
constexpr int kStepRows = 32;   // batch rows per pass
constexpr int kStepThreads = kStepRows * kStepUnits;  // one (row, unit) each

// Rows of the D+H reduction each CTA of a cluster takes.
inline int step_slice(int k) { return (k + kStepSplit - 1) / kStepSplit; }

// Row stride of the staged [x | keep*h]: odd, so the 4 rows a warp reads
// fall on distinct banks.
__host__ __device__ inline int step_xstride(int ks) { return ks | 1; }

inline size_t step_shared_bytes(int k) {
  const int ks = step_slice(k);
  return sizeof(float4) * ((size_t)ks * kStepUnits + kStepRows * kStepUnits) +
         sizeof(float) * (size_t)kStepRows * step_xstride(ks);
}

// One done-reset LSTM step for all B rows: y = h' and c_out = c' of
// gates = [x | keep*h0] . [Wi; Wh] + b.  Cluster c owns hidden units
// j0 = 8c .. 8c+7; its CTA of rank r reduces over rows [r*ks, (r+1)*ks) of
// the D+H stack.
__global__ void __cluster_dims__(kStepSplit, 1, 1)
    __launch_bounds__(kStepThreads)
        lstm_step_kernel(const float* __restrict__ x,
                         const float* __restrict__ done,
                         const float* __restrict__ c0,
                         const float* __restrict__ h0,
                         const float* __restrict__ wi,
                         const float* __restrict__ wh,
                         const float* __restrict__ bias,
                         float* __restrict__ y, float* __restrict__ c_out,
                         int B, int D, int H, int ks) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = (blockIdx.x / kStepSplit) * kStepUnits;
  const int G = 4 * H;
  const int k0 = rank * ks;
  const int nk = max(0, min(ks, D + H - k0));
  const int xstride = step_xstride(ks);
  float4* ws = smem4;                              // [ks][unit]: 4 gates
  float4* part = smem4 + ks * kStepUnits;          // [row][unit]: 4 gates
  float* xs = reinterpret_cast<float*>(part + kStepRows * kStepUnits);
  const int tid = threadIdx.x;
  const int unit = tid % kStepUnits;
  const int row = tid / kStepUnits;

  // The weight slice, once per launch: rows k0..k0+nk of [Wi; Wh], the
  // columns g*H + j0 .. +7 of each gate g, read as 32-byte segments and
  // stored gate-interleaved so a thread reads its unit's 4 gates at once.
  // Four loads a thread are in flight before the first store.
  float* wsf = reinterpret_cast<float*>(ws);
  for (int base = 0; base < nk * 8; base += 4 * kStepThreads) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = base + i * kStepThreads + tid;
      if (e < nk * 8) {
        const int k = k0 + (e >> 3), gate = (e >> 1) & 3, half = e & 1;
        const float* wrow =
            k < D ? wi + (size_t)k * G : wh + (size_t)(k - D) * G;
        v[i] = __ldg(reinterpret_cast<const float4*>(wrow + gate * H + j0 +
                                                     4 * half));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = base + i * kStepThreads + tid;
      if (e < nk * 8) {
        const int gate = (e >> 1) & 3, half = e & 1;
        float* d = wsf + ((e >> 3) * kStepUnits + 4 * half) * 4 + gate;
        d[0] = v[i].x;
        d[4] = v[i].y;
        d[8] = v[i].z;
        d[12] = v[i].w;
      }
    }
  }
  for (int b0 = 0; b0 < B; b0 += kStepRows) {
    const int nb = min(kStepRows, B - b0);
    // [x | keep*h] for this pass's rows, this CTA's reduction rows: the 8
    // threads of a row stage it (the done-reset multiplies the carry
    // before the step).
    if (row < nb) {
      const int b = b0 + row;
      const float keep = 1.0f - done[b];
      float* dst = xs + row * xstride;
#pragma unroll 8
      for (int kk = unit; kk < nk; kk += kStepUnits) {
        const int k = k0 + kk;
        dst[kk] = k < D ? x[(size_t)b * D + k]
                        : keep * h0[(size_t)b * H + (k - D)];
      }
    }
    __syncthreads();
    if (row < nb) {
      // Two partial sums (even and odd reduction rows) halve the FMA chain.
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      const float* xr = xs + row * xstride;
      int kk = 0;
#pragma unroll 2
      for (; kk + 1 < nk; kk += 2) {
        const float x0 = xr[kk], x1 = xr[kk + 1];
        const float4 w0 = ws[kk * kStepUnits + unit];
        const float4 w1 = ws[(kk + 1) * kStepUnits + unit];
        a0.x = fmaf(x0, w0.x, a0.x);
        a0.y = fmaf(x0, w0.y, a0.y);
        a0.z = fmaf(x0, w0.z, a0.z);
        a0.w = fmaf(x0, w0.w, a0.w);
        a1.x = fmaf(x1, w1.x, a1.x);
        a1.y = fmaf(x1, w1.y, a1.y);
        a1.z = fmaf(x1, w1.z, a1.z);
        a1.w = fmaf(x1, w1.w, a1.w);
      }
      if (kk < nk) {
        const float x0 = xr[kk];
        const float4 w0 = ws[kk * kStepUnits + unit];
        a0.x = fmaf(x0, w0.x, a0.x);
        a0.y = fmaf(x0, w0.y, a0.y);
        a0.z = fmaf(x0, w0.z, a0.z);
        a0.w = fmaf(x0, w0.w, a0.w);
      }
      part[row * kStepUnits + unit] =
          make_float4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
    }
    cluster.sync();  // every CTA's partial gates of this pass are visible
    // Rank r finalises rows r*8 .. r*8+7 of the pass: the four partials in
    // rank order, then the bias and the cell.
    constexpr int kOwnRows = kStepRows / kStepSplit;
    if (tid < kOwnRows * kStepUnits) {
      const int r = rank * kOwnRows + tid / kStepUnits;
      const int u = tid % kStepUnits;
      if (r < nb) {
        float4 s = *cluster.map_shared_rank(part + r * kStepUnits + u, 0);
#pragma unroll
        for (int q = 1; q < kStepSplit; ++q) {
          const float4 p =
              *cluster.map_shared_rank(part + r * kStepUnits + u, q);
          s.x += p.x;
          s.y += p.y;
          s.z += p.z;
          s.w += p.w;
        }
        const int b = b0 + r, j = j0 + u;
        const size_t o = (size_t)b * H + j;
        const float keep = 1.0f - done[b];
        const float ig = sigmoid_f(s.x + bias[j]);
        const float fg = sigmoid_f(s.y + bias[H + j]);
        const float gg = tanhf(s.z + bias[2 * H + j]);
        const float og = sigmoid_f(s.w + bias[3 * H + j]);
        const float cn = fg * (keep * c0[o]) + ig * gg;
        const float hn = og * tanhf(cn);
        y[o] = hn;
        c_out[o] = cn;
      }
    }
    cluster.sync();  // partials read before the next pass or exit
  }
}

__global__ void lstm_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ done,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wi, const float* __restrict__ wh,
    const float* __restrict__ bias, float* __restrict__ ys,
    float* __restrict__ ifgo, float* __restrict__ cpost,
    float* __restrict__ hpost, float* __restrict__ cnew,
    float* __restrict__ c_out, float* __restrict__ h_out, int T, int B,
    int D, int H) {
  extern __shared__ float smem[];
  float* sx = smem;      // x_t of this row, [D]
  float* sh = smem + D;  // post-reset h of this row, [H]
  const int b = blockIdx.x;
  const int j = threadIdx.x;  // hidden unit; blockDim.x == H
  const int G = 4 * H;
  float c = c0[(size_t)b * H + j];
  float h = h0[(size_t)b * H + j];
  const float bi = bias[j], bf = bias[H + j], bg = bias[2 * H + j],
              bo = bias[3 * H + j];
  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)t * B + b;
    // The done-reset multiplies the carry BEFORE the step.
    const float keep = 1.0f - done[row];
    c *= keep;
    h *= keep;
    for (int k = j; k < D; k += H) sx[k] = x[row * D + k];
    sh[j] = h;
    __syncthreads();
    float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
    const float* w = wi + j;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float xk = sx[k];
      const float* wk = w + (size_t)k * G;
      ai = fmaf(xk, __ldg(wk), ai);
      af = fmaf(xk, __ldg(wk + H), af);
      ag = fmaf(xk, __ldg(wk + 2 * H), ag);
      ao = fmaf(xk, __ldg(wk + 3 * H), ao);
    }
    float ri = 0.f, rf = 0.f, rg = 0.f, ro = 0.f;
    w = wh + j;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float hk = sh[k];
      const float* wk = w + (size_t)k * G;
      ri = fmaf(hk, __ldg(wk), ri);
      rf = fmaf(hk, __ldg(wk + H), rf);
      rg = fmaf(hk, __ldg(wk + 2 * H), rg);
      ro = fmaf(hk, __ldg(wk + 3 * H), ro);
    }
    const float ig = sigmoid_f(ai + ri + bi);
    const float fg = sigmoid_f(af + rf + bf);
    const float gg = tanhf(ag + rg + bg);
    const float og = sigmoid_f(ao + ro + bo);
    const float cn = fg * c + ig * gg;
    const float hn = og * tanhf(cn);
    cpost[row * H + j] = c;
    hpost[row * H + j] = h;
    cnew[row * H + j] = cn;
    float* gates = ifgo + row * G;
    gates[j] = ig;
    gates[H + j] = fg;
    gates[2 * H + j] = gg;
    gates[3 * H + j] = og;
    ys[row * H + j] = hn;
    c = cn;
    h = hn;
    // sx/sh are rewritten by the next step.
    __syncthreads();
  }
  c_out[(size_t)b * H + j] = c;
  h_out[(size_t)b * H + j] = h;
}

__global__ void lstm_bwd_chain_kernel(
    const float* __restrict__ dys, const float* __restrict__ done,
    const float* __restrict__ ifgo, const float* __restrict__ cpost,
    const float* __restrict__ cnew, const float* __restrict__ wh,
    const float* __restrict__ dct, const float* __restrict__ dht,
    float* __restrict__ dgates, float* __restrict__ dc0,
    float* __restrict__ dh0, int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* sdg = smem;      // dgates of this row and step, [4H]
  float* sdh = smem + G;  // dh_prev, [H]
  const int b = blockIdx.x;
  const int j = threadIdx.x;  // hidden unit; blockDim.x == H
  const int lane = j & 31;
  const int warp = j >> 5;
  const int num_warps = H >> 5;
  float dc = dct[(size_t)b * H + j];
  float dh = dht[(size_t)b * H + j];
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b;
    const float* gates = ifgo + row * G;
    const float ig = gates[j], fg = gates[H + j], gg = gates[2 * H + j],
                og = gates[3 * H + j];
    const float tc = tanhf(cnew[row * H + j]);
    const float dh_tot = dys[row * H + j] + dh;
    const float d_o = dh_tot * tc * og * (1.0f - og);
    const float dc_tot = dc + dh_tot * og * (1.0f - tc * tc);
    const float d_f = dc_tot * cpost[row * H + j] * fg * (1.0f - fg);
    const float d_i = dc_tot * gg * ig * (1.0f - ig);
    const float d_g = dc_tot * ig * (1.0f - gg * gg);
    sdg[j] = d_i;
    sdg[H + j] = d_f;
    sdg[2 * H + j] = d_g;
    sdg[3 * H + j] = d_o;
    float* out = dgates + row * G;
    out[j] = d_i;
    out[H + j] = d_f;
    out[2 * H + j] = d_g;
    out[3 * H + j] = d_o;
    __syncthreads();
    // dh_prev[k] = sum_n dgates[n] * Wh[k, n]: one warp per row k of Wh,
    // lanes walk the row contiguously, then a shuffle reduction.
    for (int k = warp; k < H; k += num_warps) {
      const float* wrow = wh + (size_t)k * G;
      float s = 0.f;
      for (int n = lane; n < G; n += 32) s = fmaf(sdg[n], __ldg(wrow + n), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) sdh[k] = s;
    }
    __syncthreads();
    // Chain through the pre-step reset: grads vanish where done was 1.
    const float keep = 1.0f - done[row];
    dh = sdh[j] * keep;
    dc = dc_tot * fg * keep;
  }
  dc0[(size_t)b * H + j] = dc;
  dh0[(size_t)b * H + j] = dh;
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;

// C[M,N] (row-major, dense) = A[M,K] . B[K,N], A and B given by element
// strides (any of them may be 0 for a broadcast operand).
__global__ void sgemm_kernel(const float* __restrict__ a, long long sam,
                             long long sak, const float* __restrict__ bm,
                             long long sbk, long long sbn,
                             float* __restrict__ c, int M, int N, int K) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // Load order follows whichever index is contiguous in memory, so each
  // warp's reads are coalesced for either operand orientation.
  const bool a_m_fast = (sam == 1);
  const bool b_n_fast = (sbn == 1) || (sbk != 1);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int mm = a_m_fast ? (e % kBM) : (e / kBK);
      const int kk = a_m_fast ? (e / kBM) : (e % kBK);
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < M && gk < K) ? a[gm * sam + gk * sak] : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int nn = b_n_fast ? (e % kBN) : (e / kBK);
      const int kk = b_n_fast ? (e / kBN) : (e % kBK);
      const int gk = k0 + kk, gn = n0 + nn;
      bs[kk][nn] = (gk < K && gn < N) ? bm[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[kk][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gn = n0 + tx + 16 * q;
      if (gn < N) c[(size_t)gm * N + gn] = acc[i][q];
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* sat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int sat_lstm_forward(const float* x, const float* done, const float* c0,
                     const float* h0, const float* wi, const float* wh,
                     const float* bias, float* ys, float* ifgo, float* cpost,
                     float* hpost, float* cnew, float* c_out, float* h_out,
                     int T, int B, int D, int H, void* stream) {
  const size_t shared = (size_t)(D + H) * sizeof(float);
  cudaError_t err = allow_shared(lstm_fwd_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_fwd_kernel<<<B, H, shared, (cudaStream_t)stream>>>(
      x, done, c0, h0, wi, wh, bias, ys, ifgo, cpost, hpost, cnew, c_out,
      h_out, T, B, D, H);
  return (int)cudaGetLastError();
}

int sat_lstm_step(const float* x, const float* done, const float* c0,
                  const float* h0, const float* wi, const float* wh,
                  const float* bias, float* y, float* c_out, int B, int D,
                  int H, void* stream) {
  if (H % kStepUnits != 0) return (int)cudaErrorInvalidValue;
  const int ks = step_slice(D + H);
  const size_t shared = step_shared_bytes(D + H);
  cudaError_t err = allow_shared(lstm_step_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_step_kernel<<<(H / kStepUnits) * kStepSplit, kStepThreads, shared,
                     (cudaStream_t)stream>>>(x, done, c0, h0, wi, wh, bias,
                                             y, c_out, B, D, H, ks);
  return (int)cudaGetLastError();
}

int sat_lstm_backward_chain(const float* dys, const float* done,
                            const float* ifgo, const float* cpost,
                            const float* cnew, const float* wh,
                            const float* dct, const float* dht, float* dgates,
                            float* dc0, float* dh0, int T, int B, int H,
                            void* stream) {
  const size_t shared = (size_t)(5 * H) * sizeof(float);
  cudaError_t err = allow_shared(lstm_bwd_chain_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_chain_kernel<<<B, H, shared, (cudaStream_t)stream>>>(
      dys, done, ifgo, cpost, cnew, wh, dct, dht, dgates, dc0, dh0, T, B, H);
  return (int)cudaGetLastError();
}

int sat_sgemm(const float* a, long long sam, long long sak, const float* b,
              long long sbk, long long sbn, float* c, int M, int N, int K,
              void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  sgemm_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      a, sam, sak, b, sbk, sbn, c, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
