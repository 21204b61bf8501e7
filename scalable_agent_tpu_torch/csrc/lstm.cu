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
//   batch row keeps 32 of 132 SMs busy, each thread walking all 522
//   weight rows with dependent L2 loads and every block re-reading the
//   same 2.1 MB: ~10x slower.  Here the gate columns are split across the
//   card instead: a cluster of 4 CTAs owns 8 hidden units j0..j0+7 (their
//   32 gate columns j, H+j, 2H+j, 3H+j) for every batch row, so the
//   pointwise cell stays inside the cluster.  Each CTA takes a quarter of
//   the 522-deep reduction: it stages its [131, 8 units x 4 gates] slice
//   of [Wi; Wh] in shared memory once (32-byte segments, every weight byte read once per
//   launch, the learner's [D, 4H] layout as it is) and [x | keep*h] for 32
//   batch rows at a time, then each thread accumulates the 4 gates of one
//   (row, unit).  The four partial gate vectors are summed through
//   distributed shared memory (cluster.map_shared_rank) in rank order, a
//   fixed order, by the CTA that owns the row; it applies the bias and the
//   cell.  For H=256 that is 128 CTAs, one per SM.
//
// * sgemm_kernel<true> + lstm_resid_kernel  replace _fwd_kernel (the
//   residual forward for BPTT), two launches on one stream.  At T=101,
//   B=32 the work is 3.4 GFLOP (~51 us of f32 FMA on the card); what made
//   a one-block-per-row loop 230x slower than that was latency: every step
//   re-read 2.1 MB of Wi/Wh from L2 with dependent loads on 32 SMs.
//   - The input projection has no recurrence (the done-reset touches only
//     the carry), so it leaves the loop: pre[T*B, 4H] = x.Wi + b over all
//     T*B rows in one launch of the tiled GEMM below, the bias added in its
//     epilogue.  The gates are then (x.Wi + b) + h.Wh, not the TPU
//     kernel's (x.Wi + h.Wh) + b: about one ulp apart.
//   - The recurrence keeps Wh on chip for all T steps.  A cluster of 8
//     CTAs owns R batch rows (clusters split the batch and never meet);
//     CTA r owns hidden units [r*H/8, (r+1)*H/8) and their 4H/8 gate
//     columns, and stages that [H, 4H/8] slice of Wh in shared memory once
//     (128 KiB at H=256), so every weight byte is read from device memory
//     once per launch.  Where the slice does not fit (H above ~300), the
//     rows past `resident` are read from L2 each step.  A step: each
//     thread (unit, eighth of the H-deep reduction) sums its rows for the
//     R batch rows from the CTA's copy of keep*h; the 8 partial gate
//     vectors are summed in a fixed order by the thread that owns the
//     (row, unit) cell, which adds pre, applies the cell (c stays in its
//     register), writes ys and the residuals in today's layouts (a CTA's
//     units are contiguous in each gate, so the stores coalesce) and
//     stores keep_{t+1}*h' into every CTA's next-step h buffer through
//     distributed shared memory.  The h buffers are double-buffered, so
//     one cluster.sync() per step separates the reads of one step from
//     the writes of the next.  No atomics: calls are bitwise repeatable.
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
//   result is deterministic.  The instances with a bias epilogue,
//   sgemm_kernel<true, Op>, are the residual forward's input projection,
//   so the profiler tells the forward's GEMM from BPTT's
//   (sgemm_kernel<false, Op>).
//
// Operand types.  Every kernel is a template on the type of its products'
// operands, `Op`: float, or __nv_bfloat16 for the JAX package's
// matmul_dtype="bfloat16" (lstm_pallas.py::_mm and _bwd_kernel's mm, the
// default under compute_dtype=bfloat16).  The bf16 variant reads the same
// float32 tensors and rounds each operand to bf16 in registers as it is
// staged or loaded (round-to-nearest-even, JAX's astype), then multiplies
// and sums in float32: a product of two bf16 values is exact in float32,
// so the two variants differ only in what they round, and the bf16 one
// from its plain version only in summation order.  What is rounded is
// what JAX rounds: x, keep*h, Wi and Wh in the forwards; dgates, Wi and
// Wh in dx and dh_prev, x, hpost and dgates in dWi and dWh.  Not rounded:
// the carries, ys, every residual (hpost is the float32 h), the bias, and
// db, which sums the float32 dgates (sgemm_kernel<false, float>).  The
// shared-memory layouts stay float32, so the bf16 variant keeps the float
// variant's geometry; it saves no bytes (a later design can stage bf16).
// The entry points of the bf16 variant end in _bf16.
//
// Every entry point launches on the caller's stream, allocates nothing,
// keeps no state between launches, and returns cudaGetLastError() so a
// refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// A product operand at the operand type Op, held as a float.
template <typename Op>
__device__ __forceinline__ float operand(float v) {
  return v;
}
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
template <typename Op>
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
        d[0] = operand<Op>(v[i].x);
        d[4] = operand<Op>(v[i].y);
        d[8] = operand<Op>(v[i].z);
        d[12] = operand<Op>(v[i].w);
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
        dst[kk] = operand<Op>(k < D ? x[(size_t)b * D + k]
                                    : keep * h0[(size_t)b * H + (k - D)]);
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

constexpr int kResidCluster = 8;  // CTAs per cluster: the portable maximum

// Most threads a CTA of lstm_resid_kernel<R> runs (blockDim.x == H): its
// R float4 accumulators and their operands must fit 65536 / threads
// registers.  The plan (ops/lstm_cuda.py::resid_plan) caps R by H to match.
__host__ __device__ constexpr int resid_max_threads(int rows) {
  return rows >= 8 ? 256 : rows >= 4 ? 512 : 1024;
}

__device__ __forceinline__ void fma4(float a, const float4& w, float4& acc) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// Four reduction rows k..k+3 of h.Wh for R batch rows: w[i] holds the 4
// gates of this thread's unit in row k+i of Wh, hb the R rows of keep*h.
template <int R>
__device__ __forceinline__ void resid_fma(float4 (&acc)[R], const float* hb,
                                          int H, int k, const float4 (&w)[4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 h = *reinterpret_cast<const float4*>(hb + r * H + k);
    fma4(h.x, w[0], acc[r]);
    fma4(h.y, w[1], acc[r]);
    fma4(h.z, w[2], acc[r]);
    fma4(h.w, w[3], acc[r]);
  }
}

// The recurrence of the residual forward over pre = x.Wi + b.  Cluster q
// owns batch rows [q*R, q*R + R); its CTA of rank r owns hidden units
// j0 = r*U .. j0+U-1 (U = H/8).  Shared memory: ws [resident][U] float4
// (the 4 gates of a unit in one vector), part [8][R][U] float4 (partial
// gates), hbuf [2][R][H] (keep*h of this step and the next, as operands).
template <int R, typename Op>
__global__ void __cluster_dims__(kResidCluster, 1, 1)
    __launch_bounds__(resid_max_threads(R))
        lstm_resid_kernel(const float* __restrict__ pre,
                          const float* __restrict__ done,
                          const float* __restrict__ c0,
                          const float* __restrict__ h0,
                          const float* __restrict__ wh,
                          float* __restrict__ ys, float* __restrict__ ifgo,
                          float* __restrict__ cpost,
                          float* __restrict__ hpost,
                          float* __restrict__ cnew,
                          float* __restrict__ c_out,
                          float* __restrict__ h_out, int T, int B, int H,
                          int resident) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / kResidCluster;
  const int j0 = rank * U;
  const int b0 = (blockIdx.x / kResidCluster) * R;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  float4* ws = smem4;
  float4* part = ws + (size_t)resident * U;
  float* hbuf = reinterpret_cast<float*>(part + kResidCluster * R * U);

  // The resident rows of this CTA's Wh slice, once per launch: columns
  // g*H + j0 .. +U-1 of each gate g, read as float4 (8 loads a thread in
  // flight) and stored gate-interleaved.
  const int quads = U / 4;
  const int n4 = resident * 4 * quads;
  for (int base = 0; base < n4; base += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * blockDim.x + tid;
      if (e < n4) {
        const int k = e / (4 * quads), g = (e / quads) % 4, q = e % quads;
        v[i] = __ldg(reinterpret_cast<const float4*>(wh + (size_t)k * G +
                                                     g * H + j0 + 4 * q));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * blockDim.x + tid;
      if (e < n4) {
        const int k = e / (4 * quads), g = (e / quads) % 4, q = e % quads;
        float* d = reinterpret_cast<float*>(ws + k * U + 4 * q) + g;
        d[0] = operand<Op>(v[i].x);
        d[4] = operand<Op>(v[i].y);
        d[8] = operand<Op>(v[i].z);
        d[12] = operand<Op>(v[i].w);
      }
    }
  }
  // h buffer 0 holds step 0's post-reset h (the done-reset multiplies the
  // carry BEFORE the step); rows past B stay 0 in both buffers.
  for (int e = tid; e < 2 * R * H; e += blockDim.x) {
    const int b = b0 + (e / H) % R;
    hbuf[e] = (e < R * H && b < B)
                  ? operand<Op>((1.0f - done[b]) * h0[(size_t)b * H + e % H])
                  : 0.f;
  }
  // Thread tid is (s, u) = (tid / U, tid % U) in both of its roles:
  // - reduction: unit u over rows [s*H/8, (s+1)*H/8) of Wh, the first
  //   `resident` of them from shared memory, the rest from L2;
  // - for s < R, owner of the cell (batch row b0 + s, unit j0 + u): its c
  //   and h in registers (float32: the h buffers hold the operands), the
  //   sum of the partials, the cell and the stores.
  const int s = tid / U, u = tid % U;
  const int fb = b0 + s, fj = j0 + u;
  const bool owner = s < R && fb < B;
  const int kb = s * U, ke = kb + U;
  const int km = min(max(resident, kb), ke);
  const float* wcol = wh + j0 + u;
  float c = owner ? c0[(size_t)fb * H + fj] : 0.f;
  float h = owner ? h0[(size_t)fb * H + fj] : 0.f;
  cluster.sync();  // every CTA staged and running before any DSMEM store

  for (int t = 0; t < T; ++t) {
    const float* hb = hbuf + (t & 1) * R * H;
    float* hnext = hbuf + ((t + 1) & 1) * R * H;
    // The owner's inputs, issued before the reduction hides their latency.
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    float keep = 1.f, keep_next = 1.f;
    const size_t row = (size_t)t * B + fb;
    if (owner) {
      const float* pr = pre + row * G + fj;
      p = make_float4(pr[0], pr[H], pr[2 * H], pr[3 * H]);
      keep = 1.0f - done[row];
      if (t + 1 < T) keep_next = 1.0f - done[row + B];
    }
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = kb; k < km; k += 4) {
      const float4 w[4] = {ws[k * U + u], ws[(k + 1) * U + u],
                           ws[(k + 2) * U + u], ws[(k + 3) * U + u]};
      resid_fma<R>(acc, hb, H, k, w);
    }
    for (int k = km; k < ke; k += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* col = wcol + (size_t)(k + i) * G;
        w[i] = make_float4(
            operand<Op>(__ldg(col)), operand<Op>(__ldg(col + H)),
            operand<Op>(__ldg(col + 2 * H)), operand<Op>(__ldg(col + 3 * H)));
      }
      resid_fma<R>(acc, hb, H, k, w);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part[(s * R + r) * U + u] = acc[r];
    __syncthreads();
    if (owner) {
      // The 8 partials in slice order, then pre: (x.Wi + b) + h.Wh.
      float4 g = part[s * U + u];
#pragma unroll
      for (int q = 1; q < kResidCluster; ++q) {
        const float4 o = part[(q * R + s) * U + u];
        g.x += o.x;
        g.y += o.y;
        g.z += o.z;
        g.w += o.w;
      }
      const float ig = sigmoid_f(p.x + g.x);
      const float fg = sigmoid_f(p.y + g.y);
      const float gg = tanhf(p.z + g.z);
      const float og = sigmoid_f(p.w + g.w);
      const float cp = keep * c;
      const float cn = fg * cp + ig * gg;
      const float hn = og * tanhf(cn);
      const size_t o = row * H + fj;
      cpost[o] = cp;
      hpost[o] = keep * h;
      cnew[o] = cn;
      ys[o] = hn;
      float* gates = ifgo + row * G + fj;
      gates[0] = ig;
      gates[H] = fg;
      gates[2 * H] = gg;
      gates[3 * H] = og;
      c = cn;
      h = hn;
      if (t + 1 < T) {
        const float hk = operand<Op>(keep_next * hn);
#pragma unroll
        for (int q = 0; q < kResidCluster; ++q)
          *cluster.map_shared_rank(hnext + s * H + fj, q) = hk;
      }
    }
    // The next step's h is in every CTA, and this step's reads of hb and
    // part are done; the last one also keeps every CTA's shared memory
    // alive until no other CTA can store into it.
    cluster.sync();
  }
  if (owner) {
    c_out[(size_t)fb * H + fj] = c;
    h_out[(size_t)fb * H + fj] = h;
  }
}

template <typename Op>
__global__ void lstm_bwd_chain_kernel(
    const float* __restrict__ dys, const float* __restrict__ done,
    const float* __restrict__ ifgo, const float* __restrict__ cpost,
    const float* __restrict__ cnew, const float* __restrict__ wh,
    const float* __restrict__ dct, const float* __restrict__ dht,
    float* __restrict__ dgates, float* __restrict__ dc0,
    float* __restrict__ dh0, int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* sdg = smem;      // dgates of this row and step as operands, [4H]
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
    sdg[j] = operand<Op>(d_i);
    sdg[H + j] = operand<Op>(d_f);
    sdg[2 * H + j] = operand<Op>(d_g);
    sdg[3 * H + j] = operand<Op>(d_o);
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
      for (int n = lane; n < G; n += 32)
        s = fmaf(sdg[n], operand<Op>(__ldg(wrow + n)), s);
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

// C[M,N] (row-major, dense) = A[M,K] . B[K,N] (+ bias[N] if kBias), A and
// B given by element strides (any of them may be 0 for a broadcast
// operand), each element taken at the operand type Op.
template <bool kBias, typename Op>
__global__ void sgemm_kernel(const float* __restrict__ a, long long sam,
                             long long sak, const float* __restrict__ bm,
                             long long sbk, long long sbn,
                             float* __restrict__ c,
                             const float* __restrict__ bias, int M, int N,
                             int K) {
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
      as[kk][mm] =
          (gm < M && gk < K) ? operand<Op>(a[gm * sam + gk * sak]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int nn = b_n_fast ? (e % kBN) : (e / kBK);
      const int kk = b_n_fast ? (e / kBN) : (e % kBK);
      const int gk = k0 + kk, gn = n0 + nn;
      bs[kk][nn] =
          (gk < K && gn < N) ? operand<Op>(bm[gk * sbk + gn * sbn]) : 0.f;
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
      if (gn < N) c[(size_t)gm * N + gn] = kBias ? acc[i][q] + bias[gn]
                                                 : acc[i][q];
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

template <int R, typename Op>
cudaError_t launch_resid(const float* pre, const float* done,
                         const float* c0, const float* h0, const float* wh,
                         float* ys, float* ifgo, float* cpost, float* hpost,
                         float* cnew, float* c_out, float* h_out, int T,
                         int B, int H, int resident, size_t shared,
                         cudaStream_t stream) {
  if (H > resid_max_threads(R)) return cudaErrorInvalidValue;
  cudaError_t err = allow_shared(lstm_resid_kernel<R, Op>, shared);
  if (err != cudaSuccess) return err;
  const int clusters = (B + R - 1) / R;
  lstm_resid_kernel<R, Op><<<clusters * kResidCluster, H, shared, stream>>>(
      pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out, T,
      B, H, resident);
  return cudaGetLastError();
}

template <int R>
int active_clusters(int H, size_t shared) {
  cudaError_t err = allow_shared(lstm_resid_kernel<R, float>, shared);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kResidCluster, 1, 1);
  config.blockDim = dim3(H, 1, 1);
  config.dynamicSmemBytes = shared;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)lstm_resid_kernel<R, float>, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

template <typename Op>
int forward_resid(const float* x, const float* done, const float* c0,
                  const float* h0, const float* wi, const float* wh,
                  const float* bias, float* pre, float* ys, float* ifgo,
                  float* cpost, float* hpost, float* cnew, float* c_out,
                  float* h_out, int T, int B, int D, int H, int rows,
                  int resident, int shared, void* stream) {
  if (H % (4 * kResidCluster) != 0 || resident % 4 != 0 || resident < 0 ||
      resident > H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int M = T * B, N = 4 * H;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  sgemm_kernel<true, Op><<<grid, kGemmThreads, 0, s>>>(x, D, 1, wi, N, 1,
                                                       pre, bias, M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (rows) {
    case 1:
      return (int)launch_resid<1, Op>(pre, done, c0, h0, wh, ys, ifgo, cpost,
                                      hpost, cnew, c_out, h_out, T, B, H,
                                      resident, shared, s);
    case 2:
      return (int)launch_resid<2, Op>(pre, done, c0, h0, wh, ys, ifgo, cpost,
                                      hpost, cnew, c_out, h_out, T, B, H,
                                      resident, shared, s);
    case 4:
      return (int)launch_resid<4, Op>(pre, done, c0, h0, wh, ys, ifgo, cpost,
                                      hpost, cnew, c_out, h_out, T, B, H,
                                      resident, shared, s);
    case 8:
      return (int)launch_resid<8, Op>(pre, done, c0, h0, wh, ys, ifgo, cpost,
                                      hpost, cnew, c_out, h_out, T, B, H,
                                      resident, shared, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Op>
int step(const float* x, const float* done, const float* c0, const float* h0,
         const float* wi, const float* wh, const float* bias, float* y,
         float* c_out, int B, int D, int H, void* stream) {
  if (H % kStepUnits != 0) return (int)cudaErrorInvalidValue;
  const int ks = step_slice(D + H);
  const size_t shared = step_shared_bytes(D + H);
  cudaError_t err = allow_shared(lstm_step_kernel<Op>, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_step_kernel<Op><<<(H / kStepUnits) * kStepSplit, kStepThreads, shared,
                         (cudaStream_t)stream>>>(x, done, c0, h0, wi, wh,
                                                 bias, y, c_out, B, D, H, ks);
  return (int)cudaGetLastError();
}

template <typename Op>
int backward_chain(const float* dys, const float* done, const float* ifgo,
                   const float* cpost, const float* cnew, const float* wh,
                   const float* dct, const float* dht, float* dgates,
                   float* dc0, float* dh0, int T, int B, int H,
                   void* stream) {
  const size_t shared = (size_t)(5 * H) * sizeof(float);
  cudaError_t err = allow_shared(lstm_bwd_chain_kernel<Op>, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_chain_kernel<Op><<<B, H, shared, (cudaStream_t)stream>>>(
      dys, done, ifgo, cpost, cnew, wh, dct, dht, dgates, dc0, dh0, T, B, H);
  return (int)cudaGetLastError();
}

template <typename Op>
int gemm(const float* a, long long sam, long long sak, const float* b,
         long long sbk, long long sbn, float* c, int M, int N, int K,
         void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  sgemm_kernel<false, Op><<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      a, sam, sak, b, sbk, sbn, c, nullptr, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The residual forward: pre = x.Wi + b (sgemm_kernel<true, Op>), then
// lstm_resid_kernel<rows, Op> over it.  `pre` is the caller's [T*B, 4H]
// scratch; rows, resident and shared come from lstm_cuda.resid_plan.
int sat_lstm_forward_resid(const float* x, const float* done,
                           const float* c0, const float* h0, const float* wi,
                           const float* wh, const float* bias, float* pre,
                           float* ys, float* ifgo, float* cpost, float* hpost,
                           float* cnew, float* c_out, float* h_out, int T,
                           int B, int D, int H, int rows, int resident,
                           int shared, void* stream) {
  return forward_resid<float>(x, done, c0, h0, wi, wh, bias, pre, ys, ifgo,
                              cpost, hpost, cnew, c_out, h_out, T, B, D, H,
                              rows, resident, shared, stream);
}

int sat_lstm_forward_resid_bf16(const float* x, const float* done,
                                const float* c0, const float* h0,
                                const float* wi, const float* wh,
                                const float* bias, float* pre, float* ys,
                                float* ifgo, float* cpost, float* hpost,
                                float* cnew, float* c_out, float* h_out,
                                int T, int B, int D, int H, int rows,
                                int resident, int shared, void* stream) {
  return forward_resid<__nv_bfloat16>(x, done, c0, h0, wi, wh, bias, pre, ys,
                                      ifgo, cpost, hpost, cnew, c_out, h_out,
                                      T, B, D, H, rows, resident, shared,
                                      stream);
}

// How many clusters of lstm_resid_kernel<rows, float> the card holds at
// once with `shared` bytes of shared memory a CTA
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int sat_lstm_resid_active_clusters(int H, int rows, int shared) {
  switch (rows) {
    case 1: return active_clusters<1>(H, shared);
    case 2: return active_clusters<2>(H, shared);
    case 4: return active_clusters<4>(H, shared);
    case 8: return active_clusters<8>(H, shared);
    default: return -(int)cudaErrorInvalidValue;
  }
}

int sat_lstm_step(const float* x, const float* done, const float* c0,
                  const float* h0, const float* wi, const float* wh,
                  const float* bias, float* y, float* c_out, int B, int D,
                  int H, void* stream) {
  return step<float>(x, done, c0, h0, wi, wh, bias, y, c_out, B, D, H,
                     stream);
}

int sat_lstm_step_bf16(const float* x, const float* done, const float* c0,
                       const float* h0, const float* wi, const float* wh,
                       const float* bias, float* y, float* c_out, int B,
                       int D, int H, void* stream) {
  return step<__nv_bfloat16>(x, done, c0, h0, wi, wh, bias, y, c_out, B, D,
                             H, stream);
}

int sat_lstm_backward_chain(const float* dys, const float* done,
                            const float* ifgo, const float* cpost,
                            const float* cnew, const float* wh,
                            const float* dct, const float* dht, float* dgates,
                            float* dc0, float* dh0, int T, int B, int H,
                            void* stream) {
  return backward_chain<float>(dys, done, ifgo, cpost, cnew, wh, dct, dht,
                               dgates, dc0, dh0, T, B, H, stream);
}

int sat_lstm_backward_chain_bf16(const float* dys, const float* done,
                                 const float* ifgo, const float* cpost,
                                 const float* cnew, const float* wh,
                                 const float* dct, const float* dht,
                                 float* dgates, float* dc0, float* dh0, int T,
                                 int B, int H, void* stream) {
  return backward_chain<__nv_bfloat16>(dys, done, ifgo, cpost, cnew, wh, dct,
                                       dht, dgates, dc0, dh0, T, B, H,
                                       stream);
}

int sat_sgemm(const float* a, long long sam, long long sak, const float* b,
              long long sbk, long long sbn, float* c, int M, int N, int K,
              void* stream) {
  return gemm<float>(a, sam, sak, b, sbk, sbn, c, M, N, K, stream);
}

int sat_sgemm_bf16(const float* a, long long sam, long long sak,
                   const float* b, long long sbk, long long sbn, float* c,
                   int M, int N, int K, void* stream) {
  return gemm<__nv_bfloat16>(a, sam, sak, b, sbk, sbn, c, M, N, K, stream);
}

}  // extern "C"
