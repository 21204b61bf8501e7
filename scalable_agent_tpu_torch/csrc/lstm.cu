// Hand-written Hopper (sm_90a) kernels for the done-reset LSTM core.
//
// Counterpart of scalable_agent_tpu/ops/lstm_pallas.py.  The kernels and
// a plain C interface (loaded with ctypes by ops/_build.py):
//
// * lstm_step_kernel (float32) and lstm_step_mma_kernel (bf16 operands)
//   replace _fwd_kernel_lean at the actor's T=1: one launch a step.  The
//   step is a [B, D+H] x [D+H, 4H] product plus the cell: at B=32, D=266,
//   H=256 it moves 2.3 MB (0.7 us at 3.35 TB/s) and does 34 MFLOP, so what
//   bounds it on this card is latency: one launch, the weights' trip from
//   L2, a short reduction.  Giving one block to each batch row keeps 32 of
//   132 SMs busy, each thread walking all 522 weight rows with dependent L2
//   loads and every block re-reading the same 2.1 MB: ~10x slower.  Both
//   split the gate columns across the card instead, each CTA owning a few
//   hidden units j (their gate columns j, H+j, 2H+j, 3H+j) for every batch
//   row, so the pointwise cell stays with the units.
//   - float32 (FFMA): a cluster of 4 CTAs owns 8 hidden units.  Each CTA
//     takes a quarter of the 522-deep reduction: it stages its [131, 8
//     units x 4 gates] slice of [Wi; Wh] in shared memory once (32-byte
//     segments, every weight byte read once per launch, the learner's
//     [D, 4H] layout as it is) and [x | keep*h] for 32 batch rows at a
//     time, then each thread accumulates the 4 gates of one (row, unit).
//     The four partial gate vectors are summed through distributed shared
//     memory (cluster.map_shared_rank) in rank order, a fixed order, by
//     the CTA that owns the row; it applies the bias and the cell.  For
//     H=256 that is 128 CTAs, one per SM.
//   - bf16 operands (mma.sync m16n8k16, float32 accumulators): no cluster
//     and no shared-memory staging.  CTA (c, m) owns kMmaStepUnits = 8
//     hidden units, their 32 gate columns four n8 tiles, over the whole
//     D+H depth, for the kMmaStepRows = 16 batch rows of m16 tile m (64
//     CTAs at H=256, B=32).  The depth is cut into k16 steps (zero past
//     D+H) dealt to the 8 warps in turn; each lane loads the elements of
//     its A and B fragments for all its steps straight from global memory
//     into registers (x and h by 4-byte loads, so an odd D's unaligned
//     rows need nothing; a weight fragment's 8 columns are one 32-byte
//     sector), every load issued before the first is used: one trip to
//     L2.  It then rounds them to bf16 pairs (keep*h in float32 first)
//     and runs the mma.  The warps' partial gates meet in shared memory
//     and the thread that owns (row, unit) sums them in warp order, a
//     fixed order, after one __syncthreads(), then adds the bias and
//     applies the cell.  Staging [x | h] and the weight slice through
//     shared memory was slower on the card (PERF.md): every CTA of a
//     batch tile reads the same rows, so the copies queue at L2, and
//     forming fragments from the staged float32 took as long again.  A
//     T>1 forward that needs no gradient is not a loop of steps: see
//     lstm_lean_unroll_kernel below.
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
//   - The same two launches are the lean forward at T>1 (ys and the final
//     carry only; the IMPACT target network's unroll, which takes no
//     gradient): sgemm_kernel<true> and lstm_lean_unroll_kernel, the
//     recurrence below compiled without the residual stores, so its ys and
//     carry are bitwise the residual forward's.  The TPU kernel ran that
//     unroll as one pallas_call with Wi and Wh resident over its grid of T.
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
// * bptt_chain_kernel + the products + bptt_reduce_kernel  replace
//   _bwd_kernel (BPTT), one C call per variant (sat_lstm_backward[_bf16]).
//   At T=101, B=32 the work is 5.2 GFLOP for dx, dWi and dWh plus 1.7 for
//   the chain's dh_prev = dgates.Wh^T (7 us on bf16 tensor cores) over
//   38 MB of operands (11 us at 3.35 TB/s); what made a one-block-per-row
//   chain ~400x slower than that bound was latency: every step re-read
//   1 MiB of Wh from L2 with dependent loads on 32 SMs, and a 1-row GEMM
//   summed db.
//   - The chain mirrors lstm_resid_kernel in reverse.  A cluster of 8 CTAs
//     owns R batch rows; CTA r owns hidden units k in [r*H/8, (r+1)*H/8)
//     and stages THEIR rows of Wh, all 4H columns, in shared memory once
//     ([H/8, 4H]: 128 KiB at H=256; past `resident` depth positions the
//     rest is read from L2 each step), so it computes dh_prev for its own
//     units, which are the units its cells need.  A step: the owner thread
//     of (row, unit j) holds dc and dh in registers, computes the 4 dgates
//     of j from the step's residuals (loaded one step ahead, off the
//     critical path), stashes them for the products, adds them to its
//     float32 db sums and stores the rounded operands as one float4 into
//     every CTA's double-buffered [R, H] x 4-gate dgates buffer through
//     distributed shared memory; one cluster.sync(); each thread sums one
//     unit over an eighth of the 4H depth for the R rows, the owner adds
//     the 8 partials in a fixed order and chains dh and dc through the
//     reset.  No atomics: calls are bitwise repeatable.
//   - db: each owner sums its dgates over t in float32 registers and writes
//     a [B, 4H] partial that bptt_reduce_kernel sums over B in row order:
//     time, then batch, where the TPU kernel summed each step's batch,
//     then time -- the same float32 terms, another rounding order.
//   - dx = dgates.Wi^T and [dWi; dWh] = [x | hpost]^T.dgates leave the chain
//     (the TPU kernel accumulated them across its sequential grid in VMEM
//     scratch; blocks on Hopper cannot).  The bf16 variant stashes dgates
//     as bf16 and runs them on bf16 tensor cores (bptt_dx_kernel,
//     bptt_dw_kernel: mma.sync m16n8k16 from ldmatrix'd shared tiles,
//     float32 accumulators, x, hpost and Wi rounded as they are staged);
//     the 3232-deep weight gradient is cut into fixed K slices whose
//     partials bptt_reduce_kernel sums in slice order.  The float32
//     variant stashes float32 dgates and keeps sgemm_kernel<false, float>
//     (TF32 stays off: no tensor cores).
//
// * sgemm_kernel             a strided f32 tiled GEMM (64x64 tiles, 16-deep
//   k-slices in shared memory, 4x4 outputs per thread).  Strides make every
//   transpose a view: dWi = x^T.dgates, dWh = hpost^T.dgates and
//   dx = dgates.Wi^T.  Single pass, no atomics: each output is summed by
//   one thread in row order, so the result is deterministic.  The
//   instances with a bias epilogue, sgemm_kernel<true, Op>, are the
//   residual forward's input projection, so the profiler tells the
//   forward's GEMM from BPTT's (sgemm_kernel<false, float>).
//
// Operand types.  Every kernel but the T=1 step is a template on the type
// of its products' operands, `Op`: float, or __nv_bfloat16 for the JAX
// package's matmul_dtype="bfloat16" (lstm_pallas.py::_mm and _bwd_kernel's
// mm, the default under compute_dtype=bfloat16); the T=1 step has a kernel
// for each (lstm_step_kernel, lstm_step_mma_kernel).  The bf16 variant
// reads the same float32 tensors and rounds each operand to bf16 in
// registers as it is staged, loaded or packed into a fragment
// (round-to-nearest-even, JAX's astype), then multiplies and sums in
// float32: a product of two bf16 values is exact in float32, so the two
// variants differ only in what they round, and the bf16 one from its
// plain version only in summation order.  What is rounded is what JAX
// rounds: x, keep*h, Wi and Wh in the forwards; dgates, Wi and Wh in dx
// and dh_prev, x, hpost and dgates in dWi and dWh.  Not rounded: the
// carries, ys, every residual (hpost is the float32 h), the bias, and db,
// which sums the float32 dgates in the chain.  The recurrent kernels'
// shared-memory layouts stay float32, so the bf16 variant keeps the float
// variant's geometry; BPTT's products stage bf16 tiles (they feed tensor
// cores) and its dgates stash is bf16; the bf16 T=1 step packs its
// fragments in registers.  The entry points of the bf16 variant end in
// _bf16.
//
// Every entry point launches on the caller's stream, allocates nothing,
// keeps no state between launches, and returns cudaGetLastError() so a
// refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

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

// One done-reset LSTM step for all B rows, float32: y = h' and c_out = c'
// of gates = [x | keep*h0] . [Wi; Wh] + b.  Cluster c owns hidden units
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

// The recurrence over pre = x.Wi + b.  Cluster q owns batch rows
// [q*R, q*R + R); its CTA of rank r owns hidden units j0 = r*U .. j0+U-1
// (U = H/8).  Shared memory: ws [resident][U] float4 (the 4 gates of a
// unit in one vector), part [8][R][U] float4 (partial gates), hbuf
// [2][R][H] (keep*h of this step and the next, as operands).  kStash
// writes the residuals ifgo, cpost, hpost and cnew (lstm_resid_kernel);
// without it they are never touched (lstm_lean_unroll_kernel), and ys and
// the final carry come out bit for bit the same.
template <int R, typename Op, bool kStash>
__device__ __forceinline__ void recurrence(
    const float* __restrict__ pre, const float* __restrict__ done,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ wh, float* __restrict__ ys,
    float* __restrict__ ifgo, float* __restrict__ cpost,
    float* __restrict__ hpost, float* __restrict__ cnew,
    float* __restrict__ c_out, float* __restrict__ h_out, int T, int B,
    int H, int resident) {
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
      ys[o] = hn;
      if constexpr (kStash) {
        cpost[o] = cp;
        hpost[o] = keep * h;
        cnew[o] = cn;
        float* gates = ifgo + row * G + fj;
        gates[0] = ig;
        gates[H] = fg;
        gates[2 * H] = gg;
        gates[3 * H] = og;
      }
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

// The residual forward's recurrence: ys, the residuals and the final carry.
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
  recurrence<R, Op, true>(pre, done, c0, h0, wh, ys, ifgo, cpost, hpost,
                          cnew, c_out, h_out, T, B, H, resident);
}

// The lean forward's recurrence at T>1: ys and the final carry only.  It
// takes the residual kernel's arguments (the residual pointers unused) so
// that one launcher serves both.
template <int R, typename Op>
__global__ void __cluster_dims__(kResidCluster, 1, 1)
    __launch_bounds__(resid_max_threads(R))
        lstm_lean_unroll_kernel(const float* __restrict__ pre,
                                const float* __restrict__ done,
                                const float* __restrict__ c0,
                                const float* __restrict__ h0,
                                const float* __restrict__ wh,
                                float* __restrict__ ys,
                                float* __restrict__ ifgo,
                                float* __restrict__ cpost,
                                float* __restrict__ hpost,
                                float* __restrict__ cnew,
                                float* __restrict__ c_out,
                                float* __restrict__ h_out, int T, int B,
                                int H, int resident) {
  recurrence<R, Op, false>(pre, done, c0, h0, wh, ys, ifgo, cpost, hpost,
                           cnew, c_out, h_out, T, B, H, resident);
}

// The type BPTT stashes its dgates in: the products' operand type.
__device__ __forceinline__ void store_operand(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_operand(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four depth positions j..j+3 of dh_prev = dgates.Wh^T for R batch rows:
// w[i] holds Wh[k][g*H + j+i] of this thread's unit k for the 4 gates g,
// dg the R rows' operand dgates, gate-interleaved ([R][H] float4).
template <int R>
__device__ __forceinline__ void bptt_fma(float4 (&acc)[R], const float4* dg,
                                         int H, int j, const float4 (&w)[4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d = dg[r * H + j + i];
      acc[r].x = fmaf(d.x, w[i].x, acc[r].x);
      acc[r].y = fmaf(d.y, w[i].y, acc[r].y);
      acc[r].z = fmaf(d.z, w[i].z, acc[r].z);
      acc[r].w = fmaf(d.w, w[i].w, acc[r].w);
    }
  }
}

// The reverse chain of BPTT.  Cluster q owns batch rows [q*R, q*R + R); its
// CTA of rank r owns hidden units j0 = r*U .. j0+U-1 (U = H/8): the cells
// (row, unit) it chains and the rows k of Wh its dh_prev needs.  Shared
// memory: ws [resident][U] float4 (Wh[j0+u][g*H + j] over the gates g, for
// depth position j), dgb [2][R][H] float4 (the step's operand dgates of
// every unit, gate-interleaved, double-buffered), part [8][R][U] (partial
// dh_prev).  Writes dgates [T*B, 4H] at the operand type, dc0, dh0 and
// dbpart [B, 4H] (each row's dgates summed over t in float32).
template <int R, typename Op>
__global__ void __cluster_dims__(kResidCluster, 1, 1)
    __launch_bounds__(resid_max_threads(R))
        bptt_chain_kernel(const float* __restrict__ dys,
                          const float* __restrict__ done,
                          const float* __restrict__ ifgo,
                          const float* __restrict__ cpost,
                          const float* __restrict__ cnew,
                          const float* __restrict__ wh,
                          const float* __restrict__ dct,
                          const float* __restrict__ dht,
                          Op* __restrict__ dgates,
                          float* __restrict__ dbpart,
                          float* __restrict__ dc0, float* __restrict__ dh0,
                          int T, int B, int H, int resident) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / kResidCluster;
  const int j0 = rank * U;
  const int b0 = (blockIdx.x / kResidCluster) * R;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  float4* ws = smem4;
  float4* dgbuf = ws + (size_t)resident * U;
  float* part = reinterpret_cast<float*>(dgbuf + 2 * R * H);

  // The resident depth positions of this CTA's Wh rows, once per launch:
  // each load is 4 consecutive columns of one gate of one row; a warp's
  // lanes take 4 gates x 8 rows, so each of the 4 scalar stores a lane
  // makes falls on its own bank.  8 loads a thread in flight.
  const int n4 = resident * U;
  for (int base = 0; base < n4; base += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * blockDim.x + tid;
      if (e < n4) {
        const int g = e & 3, u = (e >> 2) % U, jq = (e >> 2) / U;
        v[i] = __ldg(reinterpret_cast<const float4*>(
            wh + (size_t)(j0 + u) * G + g * H + 4 * jq));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * blockDim.x + tid;
      if (e < n4) {
        const int g = e & 3, u = (e >> 2) % U, jq = (e >> 2) / U;
        float* d = reinterpret_cast<float*>(ws + 4 * jq * U + u) + g;
        d[0] = operand<Op>(v[i].x);
        d[4 * U] = operand<Op>(v[i].y);
        d[8 * U] = operand<Op>(v[i].z);
        d[12 * U] = operand<Op>(v[i].w);
      }
    }
  }
  // Rows past B are never written and stay 0.
  for (int e = tid; e < 2 * R * H; e += blockDim.x)
    dgbuf[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  // Thread tid is (s, u) = (tid / U, tid % U) in both of its roles:
  // - reduction: unit k = j0 + u over depth positions [s*U, (s+1)*U) (all
  //   4 gates of each), the first `resident` from shared memory, the rest
  //   from L2;
  // - for s < R, owner of the cell (batch row b0 + s, unit j0 + u): dc, dh
  //   and the db sums in registers, the dgates, the stores, the chain.
  const int s = tid / U, u = tid % U;
  const int fb = b0 + s, fj = j0 + u;
  const bool owner = s < R && fb < B;
  const int jb = s * U, je = jb + U;
  const int jm = min(max(resident, jb), je);
  const float* wrow = wh + (size_t)(j0 + u) * G;
  float dc = 0.f, dh = 0.f;
  float4 db = make_float4(0.f, 0.f, 0.f, 0.f);
  // The owner's inputs of step t, loaded during step t+1.
  float4 gate = db;
  float cp = 0.f, cn = 0.f, dy = 0.f, keep = 1.f;
  auto load = [&](int t) {
    const size_t row = (size_t)t * B + fb;
    const float* gp = ifgo + row * G + fj;
    gate = make_float4(gp[0], gp[H], gp[2 * H], gp[3 * H]);
    const size_t o = row * H + fj;
    cp = cpost[o];
    cn = cnew[o];
    dy = dys[o];
    keep = 1.0f - done[row];
  };
  if (owner) {
    dc = dct[(size_t)fb * H + fj];
    dh = dht[(size_t)fb * H + fj];
    load(T - 1);
  }
  cluster.sync();  // every CTA staged and running before any DSMEM store

  for (int t = T - 1; t >= 0; --t) {
    float4* dgb = dgbuf + (t & 1) * R * H;
    float dc_tot = 0.f, fg = 0.f, kp = 1.f;
    if (owner) {
      const float ig = gate.x, gg = gate.z, og = gate.w;
      fg = gate.y;
      const float tc = tanhf(cn);
      const float dh_tot = dy + dh;
      const float d_o = dh_tot * tc * og * (1.0f - og);
      dc_tot = dc + dh_tot * og * (1.0f - tc * tc);
      const float d_f = dc_tot * cp * fg * (1.0f - fg);
      const float d_i = dc_tot * gg * ig * (1.0f - ig);
      const float d_g = dc_tot * ig * (1.0f - gg * gg);
      db.x += d_i;
      db.y += d_f;
      db.z += d_g;
      db.w += d_o;
      Op* out = dgates + ((size_t)t * B + fb) * G + fj;
      store_operand(out, d_i);
      store_operand(out + H, d_f);
      store_operand(out + 2 * H, d_g);
      store_operand(out + 3 * H, d_o);
      const float4 v = make_float4(operand<Op>(d_i), operand<Op>(d_f),
                                   operand<Op>(d_g), operand<Op>(d_o));
#pragma unroll
      for (int q = 0; q < kResidCluster; ++q)
        *cluster.map_shared_rank(dgb + s * H + fj, q) = v;
      kp = keep;
      if (t > 0) load(t - 1);  // in flight across the barrier and the sum
    }
    // This step's dgates are in every CTA.  The previous use of this
    // buffer (step t+2) was read before step t+1's barrier, and the last
    // barrier keeps every CTA's shared memory alive until no other CTA
    // can store into it.
    cluster.sync();
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = jb; j < jm; j += 4) {
      const float4 w[4] = {ws[j * U + u], ws[(j + 1) * U + u],
                           ws[(j + 2) * U + u], ws[(j + 3) * U + u]};
      bptt_fma<R>(acc, dgb, H, j, w);
    }
    for (int j = jm; j < je; j += 4) {
      float4 q[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        q[g] = __ldg(reinterpret_cast<const float4*>(wrow + g * H + j));
      const float4 w[4] = {
          make_float4(operand<Op>(q[0].x), operand<Op>(q[1].x),
                      operand<Op>(q[2].x), operand<Op>(q[3].x)),
          make_float4(operand<Op>(q[0].y), operand<Op>(q[1].y),
                      operand<Op>(q[2].y), operand<Op>(q[3].y)),
          make_float4(operand<Op>(q[0].z), operand<Op>(q[1].z),
                      operand<Op>(q[2].z), operand<Op>(q[3].z)),
          make_float4(operand<Op>(q[0].w), operand<Op>(q[1].w),
                      operand<Op>(q[2].w), operand<Op>(q[3].w))};
      bptt_fma<R>(acc, dgb, H, j, w);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      part[(s * R + r) * U + u] =
          (acc[r].x + acc[r].y) + (acc[r].z + acc[r].w);
    __syncthreads();
    if (owner) {
      // The 8 partials in slice order; then the chain through the
      // pre-step reset: grads vanish where done was 1.
      float dh_prev = part[s * U + u];
#pragma unroll
      for (int q = 1; q < kResidCluster; ++q)
        dh_prev += part[(q * R + s) * U + u];
      dh = dh_prev * kp;
      dc = dc_tot * fg * kp;
    }
  }
  if (owner) {
    dc0[(size_t)fb * H + fj] = dc;
    dh0[(size_t)fb * H + fj] = dh;
    float* p = dbpart + (size_t)fb * G + fj;
    p[0] = db.x;
    p[H] = db.y;
    p[2 * H] = db.z;
    p[3 * H] = db.w;
  }
}

// db = the B rows of dbpart summed in row order; with splits > 0 also
// [dWi; dWh] = the `splits` K-slice partials of bptt_dw_kernel summed in
// slice order (the bf16 variant).  One thread an output.
__global__ void bptt_reduce_kernel(const float* __restrict__ dbpart,
                                   float* __restrict__ db,
                                   const float* __restrict__ wpart,
                                   float* __restrict__ dwi,
                                   float* __restrict__ dwh, int B, int D,
                                   int H, int splits) {
  const int G = 4 * H;
  const size_t stride = (size_t)(D + H) * G;
  const size_t total = G + (splits > 0 ? stride : 0);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < (size_t)G) {
      float acc = dbpart[e];
      for (int b = 1; b < B; ++b) acc += dbpart[(size_t)b * G + e];
      db[e] = acc;
    } else {
      const size_t w = e - G;
      float acc = wpart[w];
      for (int z = 1; z < splits; ++z) acc += wpart[z * stride + w];
      if (w < (size_t)D * G)
        dwi[w] = acc;
      else
        dwh[w - (size_t)D * G] = acc;
    }
  }
}

// BPTT's products on bf16 tensor cores: 64x64 output tiles, 32-deep bf16
// tiles in shared memory (double-buffered, the next tile's global loads in
// registers while the current one is multiplied), 4 warps of 32x32, each
// a 2x4 grid of mma.sync m16n8k16 with float32 accumulators.  Shared
// tiles are stored with their contiguous global dimension contiguous:
// kTrans = false keeps [row][k] (K-contiguous operands, dx), kTrans = true
// [k][row] (dW, whose operands run along K); ldmatrix (.trans) turns
// either into the mma fragments.  Rows padded by 8 bf16 so that the
// 8 rows of each ldmatrix fall on distinct banks.
constexpr int kMmaTile = 64;    // BM = BN
constexpr int kMmaK = 32;       // BK
constexpr int kMmaThreads = 128;
constexpr int kLdN = kMmaK + 8;     // [row][k] row stride, in bf16
constexpr int kLdT = kMmaTile + 8;  // [k][row] row stride, in bf16

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(shared_address(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(shared_address(p)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- The bf16 lean step on tensor cores (lstm_step_mma_kernel) ------------

constexpr int kMmaStepUnits = 8;  // hidden units a CTA: 32 columns, four n8
constexpr int kMmaStepRows = 16;  // batch rows a CTA: one m16 tile
constexpr int kMmaStepWarps = 8;  // the k16 steps are dealt to them in turn
constexpr int kMmaStepThreads = 32 * kMmaStepWarps;
constexpr int kMmaStepDepth = 5;  // k16 steps a warp holds in registers:
                                  // D+H up to 640 in one round of loads

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One done-reset LSTM step with bf16 operands: y = h' and c_out = c' of
// gates = [x | keep*h0] . [Wi; Wh] + b, x, keep*h0, Wi and Wh rounded to
// bf16 (RNE), the products summed in float32.  CTA (c, m) owns hidden
// units j0 = c*U .. j0+U-1, their 4U gate columns n = gate*U + u, over the
// whole depth, for batch rows b0 = m*M .. b0+M-1.  Warp w takes the k16
// steps w, w+8, ...: it loads each step's A and B fragment elements from
// global memory straight into registers, every load of a round issued
// before the first is used, and packs them to bf16 pairs only then.
template <int U, int M>
__global__ void __launch_bounds__(kMmaStepThreads)
    lstm_step_mma_kernel(const float* __restrict__ x,
                         const float* __restrict__ done,
                         const float* __restrict__ c0,
                         const float* __restrict__ h0,
                         const float* __restrict__ wi,
                         const float* __restrict__ wh,
                         const float* __restrict__ bias,
                         float* __restrict__ y, float* __restrict__ c_out,
                         int B, int D, int H) {
  constexpr int N = 4 * U;    // gate columns
  constexpr int NT = N / 8;   // n8 tiles
  constexpr int MT = M / 16;  // m16 tiles
  constexpr int S = kMmaStepDepth;
  __shared__ __align__(16) float part[kMmaStepWarps][M][N];  // partial gates
  const int K = D + H, G = 4 * H, ksteps = (K + 15) / 16;
  const int j0 = blockIdx.x * U, b0 = blockIdx.y * M;
  const int nb = min(M, B - b0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The lane's A rows 16mt + g + 8hi (a row past the batch reads the last
  // one: its products land in rows no one reads) and B columns n = 8nt + g.
  const float* xrow[MT][2];
  const float* hrow[MT][2];
  float keep[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = b0 + min(16 * mt + g + 8 * hi, nb - 1);
      xrow[mt][hi] = x + (size_t)r * D;
      hrow[mt][hi] = h0 + (size_t)r * H;
      keep[mt][hi] = 1.0f - done[r];
    }
  int bcol[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 8 * nt + g;
    bcol[nt] = n / U * H + j0 + n % U;
  }
  // The epilogue's cell: thread tid owns (row tid / U, unit tid % U).
  const int orow = tid / U, ou = tid % U, oj = j0 + ou;
  const bool owner = orow < nb;
  float okeep = 0.f, oc = 0.f, obias[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner) {
    okeep = 1.0f - done[b0 + orow];
    oc = c0[(size_t)(b0 + orow) * H + oj];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) obias[gate] = bias[gate * H + oj];
  }

  float acc[MT][NT][4] = {};
  for (int first = warp; first < ksteps; first += S * kMmaStepWarps) {
    // Element q of a step is depth kb + (q & 1) + 8 (q >> 1), kb its lane's
    // 16*step + 2*t4: the two halves of a fragment's two registers.
    float av[S][MT][2][4], bv[S][NT][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 16 * (first + s * kMmaStepWarps) + 2 * t4 + (q & 1) +
                      8 * (q >> 1);
        const bool in = k < K;
        const float* wrow =
            k < D ? wi + (size_t)k * G : wh + (size_t)(k - D) * G;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          bv[s][nt][q] = in ? __ldg(wrow + bcol[nt]) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            av[s][mt][hi][q] = in ? __ldg(k < D ? xrow[mt][hi] + k
                                                : hrow[mt][hi] + (k - D))
                                     : 0.f;
      }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int step = first + s * kMmaStepWarps;
      if (step >= ksteps) break;  // warp-uniform: mma.sync needs every lane
      const int kb = 16 * step + 2 * t4;
      unsigned bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf[nt][0] = pack_bf16(bv[s][nt][0], bv[s][nt][1]);
        bf[nt][1] = pack_bf16(bv[s][nt][2], bv[s][nt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float o[2][4];  // the operands: keep*h where the depth is h's
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = kb + (q & 1) + 8 * (q >> 1);
            const float v = av[s][mt][hi][q];
            o[hi][q] = k < D ? v : keep[mt][hi] * v;
          }
        const unsigned a[4] = {pack_bf16(o[0][0], o[0][1]),
                               pack_bf16(o[1][0], o[1][1]),
                               pack_bf16(o[0][2], o[0][3]),
                               pack_bf16(o[1][2], o[1][3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }
  // Each warp's partial gates (c0, c1 at row g, c2, c3 at row g + 8).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = &part[warp][16 * mt + g][8 * nt + 2 * t4];
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * N) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  if (owner) {
    // The partials in warp order, then the bias and the cell.
    float s4[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      float sum = part[0][orow][gate * U + ou];
#pragma unroll
      for (int w = 1; w < kMmaStepWarps; ++w)
        sum += part[w][orow][gate * U + ou];
      s4[gate] = sum + obias[gate];
    }
    const float ig = sigmoid_f(s4[0]);
    const float fg = sigmoid_f(s4[1]);
    const float gg = tanhf(s4[2]);
    const float og = sigmoid_f(s4[3]);
    const float cn = fg * (okeep * oc) + ig * gg;
    const size_t o = (size_t)(b0 + orow) * H + oj;
    y[o] = og * tanhf(cn);
    c_out[o] = cn;
  }
}

// One warp's 32x32 share of a 64x64 tile over one kMmaK-deep tile pair.
// Lane l addresses row l%8 of the 8x8 matrix l/8 of each ldmatrix.x4:
// A's matrices are (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
// (m 8-15, k 8-15) -- a0..a3; B's are (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15) -- b0, b1 of two n8 tiles.
template <bool kTrans>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int wm,
                                         int wn, int lane,
                                         float (&acc)[2][4][4]) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kMmaK; kk += 16) {
    unsigned a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wm + 16 * mi + 8 * (mat & 1), k = kk + 8 * (mat >> 1);
      ldmatrix_x4<kTrans>(a[mi], kTrans ? as + (k + r) * kLdT + m
                                        : as + (m + r) * kLdN + k);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int n = wn + 16 * ni + 8 * (mat >> 1), k = kk + 8 * (mat & 1);
      ldmatrix_x4<kTrans>(b[ni], kTrans ? bs + (k + r) * kLdT + n
                                        : bs + (n + r) * kLdN + k);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        mma_bf16(acc[mi][nj], a[mi], b[nj >> 1][2 * (nj & 1)],
                 b[nj >> 1][2 * (nj & 1) + 1]);
  }
}

// Writes a block's 64x64 accumulators to c[M, N] (row stride N).
__device__ __forceinline__ void mma_store(const float (&acc)[2][4][4],
                                          float* __restrict__ c, int m0,
                                          int n0, int wm, int wn, int lane,
                                          int M, int N) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mi + g + 8 * h;
        const int n = n0 + wn + 8 * nj + 2 * t4;
        if (m >= M) continue;
        if (n < N) c[(size_t)m * N + n] = acc[mi][nj][2 * h];
        if (n + 1 < N) c[(size_t)m * N + n + 1] = acc[mi][nj][2 * h + 1];
      }
}

// dx[M, N] = dgates[M, K] . Wi[N, K]^T with M = T*B, N = D, K = 4H (a
// multiple of kMmaK): both operands K-contiguous, Wi rounded to bf16 as
// it is staged.
__global__ void __launch_bounds__(kMmaThreads)
    bptt_dx_kernel(const __nv_bfloat16* __restrict__ dg,
                   const float* __restrict__ wi, float* __restrict__ dx,
                   int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kMmaTile * kLdN];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kMmaTile * kLdN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  const int m0 = blockIdx.y * kMmaTile, n0 = blockIdx.x * kMmaTile;
  // A: 64 rows x 4 chunks of 8 bf16, 2 a thread.  B: 64 rows x 16 pairs
  // of float32, 8 a thread, a row's 16 pairs on 16 neighbouring lanes.
  uint4 ra[2];
  float2 rb[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + kMmaThreads * q, m = m0 + (c >> 2);
      ra[q] = m < M ? *reinterpret_cast<const uint4*>(
                          dg + (size_t)m * K + k0 + 8 * (c & 3))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = tid + kMmaThreads * q, n = n0 + (p >> 4);
      rb[q] = n < N ? *reinterpret_cast<const float2*>(
                          wi + (size_t)n * K + k0 + 2 * (p & 15))
                    : make_float2(0.f, 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + kMmaThreads * q;
      *reinterpret_cast<uint4*>(&as[buf][(c >> 2) * kLdN + 8 * (c & 3)]) =
          ra[q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = tid + kMmaThreads * q;
      *reinterpret_cast<__nv_bfloat162*>(
          &bs[buf][(p >> 4) * kLdN + 2 * (p & 15)]) =
          __floats2bfloat162_rn(rb[q].x, rb[q].y);
    }
  };
  float acc[2][4][4] = {};
  const int nk = K / kMmaK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kMmaK);
    mma_tile<false>(as[kt & 1], bs[kt & 1], wm, wn, lane, acc);
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }
  mma_store(acc, dx, m0, n0, wm, wn, lane, M, N);
}

// Slice blockIdx.z of the stacked weight gradient [dWi; dWh] =
// [x | hpost]^T . dgates: rows [z*kslice, (z+1)*kslice) of the K = T*B
// into wpart[z] ([D+H, 4H]).  A's column m < D is x's, the rest hpost's,
// both rounded to bf16 as they are staged; both operands run along K.
__global__ void __launch_bounds__(kMmaThreads)
    bptt_dw_kernel(const float* __restrict__ x,
                   const float* __restrict__ hpost,
                   const __nv_bfloat16* __restrict__ dg,
                   float* __restrict__ wpart, int K, int D, int H,
                   int kslice) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kMmaK * kLdT];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kMmaK * kLdT];
  const int M = D + H, N = 4 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  const int m0 = blockIdx.y * kMmaTile, n0 = blockIdx.x * kMmaTile;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  // A: 32 k-rows x 32 pairs of columns, 8 a thread, a row's pairs on the
  // 32 lanes of a warp.  B: 32 k-rows x 8 chunks of 8 bf16, 2 a thread.
  float2 ra[8];
  uint4 rb[2];
  auto column = [&](int k, int m) {
    if (k >= ke || m >= M) return 0.f;
    return m < D ? x[(size_t)k * D + m] : hpost[(size_t)k * H + (m - D)];
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = tid + kMmaThreads * q;
      const int k = k0 + (p >> 5), m = m0 + 2 * (p & 31);
      ra[q] = make_float2(column(k, m), column(k, m + 1));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + kMmaThreads * q, k = k0 + (c >> 3);
      rb[q] = k < ke ? *reinterpret_cast<const uint4*>(
                           dg + (size_t)k * N + n0 + 8 * (c & 7))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = tid + kMmaThreads * q;
      *reinterpret_cast<__nv_bfloat162*>(
          &as[buf][(p >> 5) * kLdT + 2 * (p & 31)]) =
          __floats2bfloat162_rn(ra[q].x, ra[q].y);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + kMmaThreads * q;
      *reinterpret_cast<uint4*>(&bs[buf][(c >> 3) * kLdT + 8 * (c & 7)]) =
          rb[q];
    }
  };
  float acc[2][4][4] = {};
  const int nk = ke > kb ? (ke - kb + kMmaK - 1) / kMmaK : 0;
  if (nk > 0) {
    load(kb);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kb + (kt + 1) * kMmaK);
    mma_tile<true>(as[kt & 1], bs[kt & 1], wm, wn, lane, acc);
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }
  mma_store(acc, wpart + (size_t)blockIdx.z * M * N, m0, n0, wm, wn, lane, M,
            N);
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

// The recurrence over pre: lstm_resid_kernel<R, Op> with the residual
// stores, lstm_lean_unroll_kernel<R, Op> without.
template <int R, typename Op, bool kStash>
cudaError_t launch_recurrence(const float* pre, const float* done,
                              const float* c0, const float* h0,
                              const float* wh, float* ys, float* ifgo,
                              float* cpost, float* hpost, float* cnew,
                              float* c_out, float* h_out, int T, int B, int H,
                              int resident, size_t shared,
                              cudaStream_t stream) {
  if (H > resid_max_threads(R)) return cudaErrorInvalidValue;
  const auto kernel = kStash ? &lstm_resid_kernel<R, Op>
                             : &lstm_lean_unroll_kernel<R, Op>;
  cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return err;
  const int clusters = (B + R - 1) / R;
  kernel<<<clusters * kResidCluster, H, shared, stream>>>(
      pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out, T,
      B, H, resident);
  return cudaGetLastError();
}

// How many clusters of 8 CTAs of `kernel` (H threads, `shared` bytes of
// shared memory a CTA) the card holds at once, or minus a CUDA error code.
template <typename Kernel>
int active_clusters(Kernel kernel, int H, size_t shared) {
  cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kResidCluster, 1, 1);
  config.blockDim = dim3(H, 1, 1);
  config.dynamicSmemBytes = shared;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                       &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// The residual forward (kStash) or the lean one at T>1: pre = x.Wi + b
// over all T*B rows, then the recurrence over it.
template <typename Op, bool kStash>
int forward(const float* x, const float* done, const float* c0,
            const float* h0, const float* wi, const float* wh,
            const float* bias, float* pre, float* ys, float* ifgo,
            float* cpost, float* hpost, float* cnew, float* c_out,
            float* h_out, int T, int B, int D, int H, int rows, int resident,
            int shared, void* stream) {
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
      return (int)launch_recurrence<1, Op, kStash>(
          pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out,
          T, B, H, resident, shared, s);
    case 2:
      return (int)launch_recurrence<2, Op, kStash>(
          pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out,
          T, B, H, resident, shared, s);
    case 4:
      return (int)launch_recurrence<4, Op, kStash>(
          pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out,
          T, B, H, resident, shared, s);
    case 8:
      return (int)launch_recurrence<8, Op, kStash>(
          pre, done, c0, h0, wh, ys, ifgo, cpost, hpost, cnew, c_out, h_out,
          T, B, H, resident, shared, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int step(const float* x, const float* done, const float* c0, const float* h0,
         const float* wi, const float* wh, const float* bias, float* y,
         float* c_out, int B, int D, int H, void* stream) {
  if (H % kStepUnits != 0) return (int)cudaErrorInvalidValue;
  const int ks = step_slice(D + H);
  const size_t shared = step_shared_bytes(D + H);
  cudaError_t err = allow_shared(lstm_step_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  lstm_step_kernel<<<(H / kStepUnits) * kStepSplit, kStepThreads, shared,
                     (cudaStream_t)stream>>>(x, done, c0, h0, wi, wh, bias, y,
                                             c_out, B, D, H, ks);
  return (int)cudaGetLastError();
}

template <int U, int M>
int step_mma(const float* x, const float* done, const float* c0,
             const float* h0, const float* wi, const float* wh,
             const float* bias, float* y, float* c_out, int B, int D, int H,
             void* stream) {
  if (H % U != 0 || M * U > kMmaStepThreads) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / U, (B + M - 1) / M);
  lstm_step_mma_kernel<U, M><<<grid, kMmaStepThreads, 0,
                               (cudaStream_t)stream>>>(
      x, done, c0, h0, wi, wh, bias, y, c_out, B, D, H);
  return (int)cudaGetLastError();
}

// Everything sat_lstm_backward[_bf16] is given.
struct BpttArgs {
  const float *dys, *done, *ifgo, *cpost, *hpost, *cnew, *x, *wi, *wh, *dct,
      *dht;
  float *dx, *dc0, *dh0, *dwi, *dwh, *db;
  void* dgates;  // [T*B, 4H] scratch at the operand type
  float *dbpart, *wpart;
  int T, B, D, H, rows, resident, shared, splits;
  cudaStream_t stream;
};

template <int R, typename Op>
cudaError_t launch_bptt_chain(const BpttArgs& a) {
  if (a.H > resid_max_threads(R)) return cudaErrorInvalidValue;
  cudaError_t err = allow_shared(bptt_chain_kernel<R, Op>, a.shared);
  if (err != cudaSuccess) return err;
  const int clusters = (a.B + R - 1) / R;
  bptt_chain_kernel<R, Op>
      <<<clusters * kResidCluster, a.H, a.shared, a.stream>>>(
          a.dys, a.done, a.ifgo, a.cpost, a.cnew, a.wh, a.dct, a.dht,
          static_cast<Op*>(a.dgates), a.dbpart, a.dc0, a.dh0, a.T, a.B, a.H,
          a.resident);
  return cudaGetLastError();
}

// dx, dWi and dWh from the float32 variant's dgates: three launches of the
// strided float32 GEMM.
cudaError_t bptt_products(const BpttArgs& a, const float* dg) {
  const int M = a.T * a.B, G = 4 * a.H;
  const dim3 dx_grid((a.D + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  sgemm_kernel<false, float><<<dx_grid, kGemmThreads, 0, a.stream>>>(
      dg, G, 1, a.wi, 1, G, a.dx, nullptr, M, a.D, G);
  const dim3 dwi_grid((G + kBN - 1) / kBN, (a.D + kBM - 1) / kBM);
  sgemm_kernel<false, float><<<dwi_grid, kGemmThreads, 0, a.stream>>>(
      a.x, 1, a.D, dg, G, 1, a.dwi, nullptr, a.D, G, M);
  const dim3 dwh_grid((G + kBN - 1) / kBN, (a.H + kBM - 1) / kBM);
  sgemm_kernel<false, float><<<dwh_grid, kGemmThreads, 0, a.stream>>>(
      a.hpost, 1, a.H, dg, G, 1, a.dwh, nullptr, a.H, G, M);
  return cudaGetLastError();
}

// dx and the K-slice partials of [dWi; dWh] from the bf16 variant's
// dgates, on tensor cores: two launches.
cudaError_t bptt_products(const BpttArgs& a, const __nv_bfloat16* dg) {
  const int M = a.T * a.B, G = 4 * a.H;
  const dim3 dx_grid((a.D + kMmaTile - 1) / kMmaTile,
                     (M + kMmaTile - 1) / kMmaTile);
  bptt_dx_kernel<<<dx_grid, kMmaThreads, 0, a.stream>>>(dg, a.wi, a.dx, M,
                                                         a.D, G);
  const int ktiles = (M + kMmaK - 1) / kMmaK;
  const int kslice = (ktiles + a.splits - 1) / a.splits * kMmaK;
  const dim3 dw_grid(G / kMmaTile, (a.D + a.H + kMmaTile - 1) / kMmaTile,
                     a.splits);
  bptt_dw_kernel<<<dw_grid, kMmaThreads, 0, a.stream>>>(
      a.x, a.hpost, dg, a.wpart, M, a.D, a.H, kslice);
  return cudaGetLastError();
}

// BPTT: the chain, the products, then the reduction of db (and, in the
// bf16 variant, of the dW slices): 5 launches for float32, 4 for bf16.
template <typename Op>
int backward(const BpttArgs& a) {
  const bool sliced = std::is_same<Op, __nv_bfloat16>::value;
  if (a.H % (4 * kResidCluster) != 0 || a.resident % 4 != 0 ||
      a.resident < 0 || a.resident > a.H || (sliced && a.splits < 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (a.rows) {
    case 1: err = launch_bptt_chain<1, Op>(a); break;
    case 2: err = launch_bptt_chain<2, Op>(a); break;
    case 4: err = launch_bptt_chain<4, Op>(a); break;
    case 8: err = launch_bptt_chain<8, Op>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = bptt_products(a, static_cast<const Op*>(a.dgates));
  if (err != cudaSuccess) return (int)err;
  const int splits = sliced ? a.splits : 0;
  const size_t G = 4 * (size_t)a.H;
  const size_t total = G + (sliced ? (a.D + a.H) * G : 0);
  const int blocks = (int)std::min<size_t>((total + 255) / 256, 2048);
  bptt_reduce_kernel<<<blocks, 256, 0, a.stream>>>(
      a.dbpart, a.db, a.wpart, a.dwi, a.dwh, a.B, a.D, a.H, splits);
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
  return forward<float, true>(x, done, c0, h0, wi, wh, bias, pre, ys, ifgo,
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
  return forward<__nv_bfloat16, true>(x, done, c0, h0, wi, wh, bias, pre,
                                      ys, ifgo, cpost, hpost, cnew, c_out,
                                      h_out, T, B, D, H, rows, resident,
                                      shared, stream);
}

// The lean forward at T>1: the residual forward's two launches, the
// recurrence lstm_lean_unroll_kernel<rows, Op>, which writes ys and the
// final carry only.  Arguments as sat_lstm_forward_resid's without the
// residuals.
int sat_lstm_forward_lean(const float* x, const float* done, const float* c0,
                          const float* h0, const float* wi, const float* wh,
                          const float* bias, float* pre, float* ys,
                          float* c_out, float* h_out, int T, int B, int D,
                          int H, int rows, int resident, int shared,
                          void* stream) {
  return forward<float, false>(x, done, c0, h0, wi, wh, bias, pre, ys,
                               nullptr, nullptr, nullptr, nullptr, c_out,
                               h_out, T, B, D, H, rows, resident, shared,
                               stream);
}

int sat_lstm_forward_lean_bf16(const float* x, const float* done,
                               const float* c0, const float* h0,
                               const float* wi, const float* wh,
                               const float* bias, float* pre, float* ys,
                               float* c_out, float* h_out, int T, int B,
                               int D, int H, int rows, int resident,
                               int shared, void* stream) {
  return forward<__nv_bfloat16, false>(x, done, c0, h0, wi, wh, bias, pre,
                                       ys, nullptr, nullptr, nullptr, nullptr,
                                       c_out, h_out, T, B, D, H, rows,
                                       resident, shared, stream);
}

// How many clusters of lstm_resid_kernel<rows, float> (the residual
// forward's recurrence) or of bptt_chain_kernel<rows, float> (BPTT's
// chain) the card holds at once with `shared` bytes of shared memory a CTA
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int sat_lstm_resid_active_clusters(int H, int rows, int shared) {
  switch (rows) {
    case 1: return active_clusters(lstm_resid_kernel<1, float>, H, shared);
    case 2: return active_clusters(lstm_resid_kernel<2, float>, H, shared);
    case 4: return active_clusters(lstm_resid_kernel<4, float>, H, shared);
    case 8: return active_clusters(lstm_resid_kernel<8, float>, H, shared);
    default: return -(int)cudaErrorInvalidValue;
  }
}

int sat_lstm_bptt_active_clusters(int H, int rows, int shared) {
  switch (rows) {
    case 1: return active_clusters(bptt_chain_kernel<1, float>, H, shared);
    case 2: return active_clusters(bptt_chain_kernel<2, float>, H, shared);
    case 4: return active_clusters(bptt_chain_kernel<4, float>, H, shared);
    case 8: return active_clusters(bptt_chain_kernel<8, float>, H, shared);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The lean step at T=1: lstm_step_kernel (float32 operands) and
// lstm_step_mma_kernel<kMmaStepUnits, kMmaStepRows> (bf16 operands).
int sat_lstm_step(const float* x, const float* done, const float* c0,
                  const float* h0, const float* wi, const float* wh,
                  const float* bias, float* y, float* c_out, int B, int D,
                  int H, void* stream) {
  return step(x, done, c0, h0, wi, wh, bias, y, c_out, B, D, H, stream);
}

int sat_lstm_step_bf16(const float* x, const float* done, const float* c0,
                       const float* h0, const float* wi, const float* wh,
                       const float* bias, float* y, float* c_out, int B,
                       int D, int H, void* stream) {
  return step_mma<kMmaStepUnits, kMmaStepRows>(x, done, c0, h0, wi, wh, bias,
                                               y, c_out, B, D, H, stream);
}

// BPTT of the residual forward: bptt_chain_kernel<rows, Op>, the
// products, bptt_reduce_kernel.  dgates is the caller's [T*B, 4H] scratch
// at the operand type (float32 here, bf16 in the _bf16 variant), dbpart
// its [B, 4H] float32 scratch, wpart its [splits, D+H, 4H] float32
// scratch for the bf16 variant's dW slices (unused here); rows, resident
// and shared come from lstm_cuda.bptt_plan, splits from
// lstm_cuda.wgrad_splits.
int sat_lstm_backward(const float* dys, const float* done, const float* ifgo,
                      const float* cpost, const float* hpost,
                      const float* cnew, const float* x, const float* wi,
                      const float* wh, const float* dct, const float* dht,
                      float* dx, float* dc0, float* dh0, float* dwi,
                      float* dwh, float* db, void* dgates, float* dbpart,
                      float* wpart, int T, int B, int D, int H, int rows,
                      int resident, int shared, int splits, void* stream) {
  return backward<float>({dys, done, ifgo, cpost, hpost, cnew, x, wi, wh,
                          dct, dht, dx, dc0, dh0, dwi, dwh, db, dgates,
                          dbpart, wpart, T, B, D, H, rows, resident, shared,
                          splits, (cudaStream_t)stream});
}

int sat_lstm_backward_bf16(const float* dys, const float* done,
                           const float* ifgo, const float* cpost,
                           const float* hpost, const float* cnew,
                           const float* x, const float* wi, const float* wh,
                           const float* dct, const float* dht, float* dx,
                           float* dc0, float* dh0, float* dwi, float* dwh,
                           float* db, void* dgates, float* dbpart,
                           float* wpart, int T, int B, int D, int H, int rows,
                           int resident, int shared, int splits,
                           void* stream) {
  return backward<__nv_bfloat16>({dys, done, ifgo, cpost, hpost, cnew, x, wi,
                                  wh, dct, dht, dx, dc0, dh0, dwi, dwh, db,
                                  dgates, dbpart, wpart, T, B, D, H, rows,
                                  resident, shared, splits,
                                  (cudaStream_t)stream});
}

}  // extern "C"
