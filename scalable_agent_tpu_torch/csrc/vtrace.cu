// Hand-written Hopper (sm_90a) kernel for fused V-trace.
//
// Counterpart of scalable_agent_tpu/ops/vtrace_pallas.py (_vtrace_kernel,
// launched by vtrace_fused).  One kernel and a plain C interface (loaded
// with ctypes by ops/_build.py):
//
// * vtrace_kernel   all of V-trace in one pass: rho = exp(log_rho), the
//   clipped rho-bar and c, the deltas, the reverse recurrence
//   acc_t = delta_t + gamma_t c_t acc_{t+1}, vs_t = v_t + acc_t and the
//   clipped-pg-rho advantages.  The TPU kernel tiles the batch in 128-lane
//   blocks and runs T on a fori_loop with the deltas staged in VMEM
//   scratch.  Here every column n < N of the row-major [T, N] inputs is
//   independent, so one thread owns one column and walks t from T-1 down
//   to 0 with acc, v_{t+1} and vs_{t+1} in registers (both start from the
//   bootstrap value): each input is read once, each output written once,
//   and nothing is staged in shared or device memory.  A warp's loads for
//   one t are 32 neighbouring floats, so they coalesce.
//
//   Bound on the card: bytes.  At the learner's [100, 32] it moves 77 KB,
//   ~0.02 us of HBM time, so one launch is latency-bound by its T
//   dependent steps; at [100, 8192] the bytes bound is ~6 us.  Loads do
//   not depend on acc, so the unrolled loop can issue them ahead of the
//   recurrence.  PERF.md has its time.
//
//   Clipping keeps NaN: rho > thr ? thr : rho leaves a NaN rho NaN (as
//   jnp.minimum and torch.clamp do; fminf would return thr), so a NaN
//   log-rho still reaches the loss and trips the learner's non-finite
//   guard.  A threshold of None is passed as has_clip = 0.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kVtraceThreads = 128;

__device__ __forceinline__ float clip_keep_nan(float rho, float thr,
                                               int has_clip) {
  return (has_clip && rho > thr) ? thr : rho;
}

__global__ void __launch_bounds__(kVtraceThreads) vtrace_kernel(
    const float* __restrict__ log_rhos, const float* __restrict__ discounts,
    const float* __restrict__ rewards, const float* __restrict__ values,
    const float* __restrict__ bootstrap, float* __restrict__ vs,
    float* __restrict__ pg, int T, int N, float clip_rho, int has_clip_rho,
    float clip_pg_rho, int has_clip_pg_rho) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float boot = bootstrap[n];
  float acc = 0.0f;
  float v_next = boot;   // v_{t+1}
  float vs_next = boot;  // vs_{t+1}
#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * N + n;
    const float rho = expf(log_rhos[i]);
    const float gamma = discounts[i];
    const float r = rewards[i];
    const float v = values[i];
    const float rho_bar = clip_keep_nan(rho, clip_rho, has_clip_rho);
    const float c = clip_keep_nan(rho, 1.0f, 1);
    const float pg_rho = clip_keep_nan(rho, clip_pg_rho, has_clip_pg_rho);
    const float delta = rho_bar * (r + gamma * v_next - v);
    acc = delta + (gamma * c) * acc;
    const float vs_t = v + acc;
    vs[i] = vs_t;
    pg[i] = pg_rho * (r + gamma * vs_next - v);
    v_next = v;
    vs_next = vs_t;
  }
}

}  // namespace

extern "C" {

int sat_vtrace(const float* log_rhos, const float* discounts,
               const float* rewards, const float* values,
               const float* bootstrap, float* vs, float* pg, int T, int N,
               float clip_rho, int has_clip_rho, float clip_pg_rho,
               int has_clip_pg_rho, void* stream) {
  const int blocks = (N + kVtraceThreads - 1) / kVtraceThreads;
  vtrace_kernel<<<blocks, kVtraceThreads, 0, (cudaStream_t)stream>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, N,
      clip_rho, has_clip_rho, clip_pg_rho, has_clip_pg_rho);
  return (int)cudaGetLastError();
}

}  // extern "C"
