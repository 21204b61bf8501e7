// Hand-written Hopper (sm_90a) kernel for fused V-trace.
//
// Counterpart of scalable_agent_tpu/ops/vtrace_pallas.py (_vtrace_kernel,
// launched by vtrace_fused).  One kernel and a plain C interface (loaded
// with ctypes by ops/_build.py):
//
// * vtrace_chunked_kernel   all of V-trace in one pass: rho = exp(log_rho),
//   the clipped rho-bar and c, the deltas, the reverse recurrence
//   acc_t = delta_t + a_t acc_{t+1} with a_t = gamma_t c_t,
//   vs_t = v_t + acc_t and the clipped-pg-rho advantages.  The TPU kernel
//   tiles the batch in 128-lane blocks and runs T on a fori_loop with the
//   deltas staged in VMEM scratch.
//
//   Bound on the card: bytes (77 KB at the learner's [100, 32], ~0.02 us
//   of HBM time; ~20 MB and ~5.9 us at [100, 8192]).  A walk of T
//   dependent steps, each waiting on its own loads, is bound instead by
//   memory latency: one thread per column walking all of T spent ~150 ns
//   a step.  So the time axis is split across warps, which is possible
//   because each step is the affine map f_t(x) = delta_t + a_t x and maps
//   compose (the JAX package's compose_affine and associative scan rely on
//   the same):
//
//   - Columns on lanes, time across warps.  A CTA owns 32 consecutive
//     columns, so a row of its tile is one 128-byte line, and `chunks`
//     warps (kChunks, or T when T is smaller: no chunk is empty).  T =
//     base * chunks + extra; warp w owns base steps, one more if w <
//     extra, starting at w * base + min(w, extra).
//   - All of a window's loads in flight at once.  A thread loads up to K
//     steps of its four inputs into registers, plus v at its chunk's far
//     end (or the bootstrap for the last chunk), before it uses any of
//     them: one memory latency a window, not one per few steps.  K is a
//     template argument, the smallest of 1, 2, 4 and 8 that holds a whole
//     chunk (8 for the learner's 6-7 steps): the windows are unrolled and
//     predicated, so a window longer than the chunk only costs
//     instructions.  A chunk longer than 8 steps is walked in windows from
//     its end, and reloaded for the replay.
//   - 16 chunks: shorter chains than 8, while two CTAs of 512 threads (63
//     registers) still fit an SM, so [100, 8192]'s 256 CTAs run in one
//     wave; 32 chunks (1024 threads) would take two.  PERF.md has the
//     times of these choices (tools/vtrace_schedule.py).
//   - Compose, combine, replay.  Each thread folds its chunk's steps, from
//     the last to the first, into one map (A, B): A <- a A, B <- delta +
//     a B.  The maps go through shared memory; each thread applies those
//     of the later chunks to 0, from the last chunk back to its own, in
//     that fixed order, which gives its chunk's carry-in acc at the
//     chunk's end.  The chunk is then replayed from its carry-in with the
//     sequential walk's arithmetic and order, so only the carry-ins round
//     differently from a walk over all of T.  pg_t needs vs_{t+1}: at a
//     chunk's end that is v + carry-in, and for the last chunk the
//     bootstrap itself, as the walk starts.
//   - Stores go straight from registers, 128 bytes a warp a step.
//
//   No atomics and a fixed order of every sum: the same inputs give the
//   same bits on every call.  The plain version in ops/vtrace_cuda.py
//   runs this schedule step for step.
//
//   Clipping keeps NaN: rho > thr ? thr : rho leaves a NaN rho NaN (as
//   jnp.minimum and torch.clamp do; fminf would return thr), so a NaN
//   log-rho still reaches vs and the advantages at its step and every
//   earlier one of its column, through the chunk maps and carry-ins as
//   through the walk, and trips the learner's non-finite guard.  A
//   threshold of None is passed as has_clip = 0.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // columns a CTA owns: one 128-byte line a row
constexpr int kChunks = 16;  // time chunks (warps) a CTA splits T into
constexpr int kMaxWindow = 8;  // most steps a thread holds in registers

struct Clips {
  float rho, pg_rho;
  int has_rho, has_pg_rho;
};

__device__ __forceinline__ float clip_keep_nan(float rho, float thr,
                                               int has_clip) {
  return (has_clip && rho > thr) ? thr : rho;
}

// One window of a thread's column: the four inputs at steps ws .. ws+len-1.
template <int K>
struct Window {
  float log_rho[K], gamma[K], reward[K], value[K];
};

template <int K>
__device__ __forceinline__ void load_window(
    Window<K>& w, const float* __restrict__ log_rhos,
    const float* __restrict__ discounts, const float* __restrict__ rewards,
    const float* __restrict__ values, int ws, int len, int N, int n,
    bool active) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w.log_rho[k] = w.gamma[k] = w.reward[k] = w.value[k] = 0.0f;
    if (active && k < len) {
      const size_t i = (size_t)(ws + k) * N + n;
      w.log_rho[k] = __ldg(log_rhos + i);
      w.gamma[k] = __ldg(discounts + i);
      w.reward[k] = __ldg(rewards + i);
      w.value[k] = __ldg(values + i);
    }
  }
}

// delta_t and a_t = gamma_t c_t of one step, given v_{t+1}: the
// sequential walk's arithmetic.
template <int K>
__device__ __forceinline__ void step_map(const Window<K>& w, int k,
                                         float v_next, const Clips& clips,
                                         float& delta, float& a) {
  const float rho = expf(w.log_rho[k]);
  const float rho_bar = clip_keep_nan(rho, clips.rho, clips.has_rho);
  const float c = clip_keep_nan(rho, 1.0f, 1);
  delta = rho_bar * (w.reward[k] + w.gamma[k] * v_next - w.value[k]);
  a = w.gamma[k] * c;
}

// (A, B) <- f_ws o ... o f_{ws+len-1} o (A, B); v_next enters as v at the
// window's end and leaves as v at its start.
template <int K>
__device__ __forceinline__ void compose_window(const Window<K>& w, int len,
                                               const Clips& clips,
                                               float& v_next, float& A,
                                               float& B) {
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (k < len) {
      float delta, a;
      step_map(w, k, v_next, clips, delta, a);
      A = a * A;
      B = delta + a * B;
      v_next = w.value[k];
    }
  }
}

// The sequential walk over one window, from its last step to its first.
template <int K>
__device__ __forceinline__ void replay_window(
    const Window<K>& w, int ws, int len, int N, int n, bool active,
    const Clips& clips, float& acc, float& v_next, float& vs_next,
    float* __restrict__ vs, float* __restrict__ pg) {
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (k < len) {
      float delta, a;
      step_map(w, k, v_next, clips, delta, a);
      acc = delta + a * acc;
      const float rho = expf(w.log_rho[k]);
      const float pg_rho = clip_keep_nan(rho, clips.pg_rho,
                                         clips.has_pg_rho);
      const float vs_t = w.value[k] + acc;
      if (active) {
        const size_t i = (size_t)(ws + k) * N + n;
        vs[i] = vs_t;
        pg[i] = pg_rho * (w.reward[k] + w.gamma[k] * vs_next - w.value[k]);
      }
      v_next = w.value[k];
      vs_next = vs_t;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kLanes * kChunks) vtrace_chunked_kernel(
    const float* __restrict__ log_rhos, const float* __restrict__ discounts,
    const float* __restrict__ rewards, const float* __restrict__ values,
    const float* __restrict__ bootstrap, float* __restrict__ vs,
    float* __restrict__ pg, int T, int N, int chunks, int base, int extra,
    Clips clips) {
  __shared__ float map_a[kChunks][kLanes];
  __shared__ float map_b[kChunks][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int chunk = threadIdx.x / kLanes;
  const int n = blockIdx.x * kLanes + lane;
  const bool active = n < N;
  const int t0 = chunk * base + min(chunk, extra);
  const int t1 = t0 + base + (chunk < extra);
  const bool last = t1 == T;
  const bool one_window = t1 - t0 <= K;

  // Compose: the windows from the chunk's end back to its start.  The
  // first window's loads and v at the chunk's end are issued together.
  float v_end = 0.0f;
  if (active) v_end = last ? __ldg(bootstrap + n)
                           : __ldg(values + (size_t)t1 * N + n);
  Window<K> w;
  float A = 1.0f, B = 0.0f, v_next = v_end;
  for (int te = t1; te > t0;) {
    const int ws = max(t0, te - K);
    load_window(w, log_rhos, discounts, rewards, values, ws, te - ws, N, n,
                active);
    compose_window(w, te - ws, clips, v_next, A, B);
    te = ws;
  }
  map_a[chunk][lane] = A;
  map_b[chunk][lane] = B;
  __syncthreads();

  // Combine: apply the later chunks' maps to 0, last chunk first.
  float acc = 0.0f;
  for (int u = chunks - 1; u > chunk; --u) {
    acc = map_b[u][lane] + map_a[u][lane] * acc;
  }

  // Replay from the carry-in; one window's registers are still loaded.
  v_next = v_end;
  float vs_next = last ? v_end : v_end + acc;
  for (int te = t1; te > t0;) {
    const int ws = max(t0, te - K);
    if (!one_window) {
      load_window(w, log_rhos, discounts, rewards, values, ws, te - ws, N,
                  n, active);
    }
    replay_window(w, ws, te - ws, N, n, active, clips, acc, v_next, vs_next,
                  vs, pg);
    te = ws;
  }
}

template <int K>
int launch(const float* log_rhos, const float* discounts,
           const float* rewards, const float* values, const float* bootstrap,
           float* vs, float* pg, int T, int N, const Clips& clips,
           cudaStream_t stream) {
  const int chunks = T < kChunks ? T : kChunks;
  const int blocks = (N + kLanes - 1) / kLanes;
  vtrace_chunked_kernel<K><<<blocks, kLanes * chunks, 0, stream>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, N, chunks,
      T / chunks, T % chunks, clips);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sat_vtrace(const float* log_rhos, const float* discounts,
               const float* rewards, const float* values,
               const float* bootstrap, float* vs, float* pg, int T, int N,
               float clip_rho, int has_clip_rho, float clip_pg_rho,
               int has_clip_pg_rho, void* stream) {
  if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const Clips clips{clip_rho, clip_pg_rho, has_clip_rho, has_clip_pg_rho};
  const int longest = (T + kChunks - 1) / kChunks;  // steps of chunk 0
  auto* run = longest <= 1 ? launch<1> : longest <= 2 ? launch<2>
              : longest <= 4 ? launch<4> : launch<kMaxWindow>;
  return run(log_rhos, discounts, rewards, values, bootstrap, vs, pg, T, N,
             clips, (cudaStream_t)stream);
}

}  // extern "C"
