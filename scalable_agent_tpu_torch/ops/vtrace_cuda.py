"""Fused V-trace: a hand-written Hopper kernel and its plain PyTorch
version.

The counterpart of ``scalable_agent_tpu/ops/vtrace_pallas.py``, with the
same contract: rank-2 ``[T, N]`` float32 inputs, bootstrap ``[N]``, returns
``(vs, pg_advantages)``; callers flatten extra trailing dims into N
(``ops/vtrace.py``).  The outputs feed the loss under stop-gradient, so
there is no backward.

Kernel (``csrc/vtrace.cu``), launch counter ``LAUNCHES["vtrace_fused"]``:
replaces ``vtrace_pallas.py::_vtrace_kernel`` (via ``vtrace_fused``).  A
CTA owns 32 columns and splits T into ``KERNEL_CHUNKS`` chunks, one warp
each: every thread folds its chunk's steps into one affine map, the maps
are combined in a fixed order into each chunk's carry-in, and each chunk
replays its steps from it.  See the source's header comment and PERF.md
for its bound.  ``vtrace_fused_plain`` runs the same schedule; with
``chunks=1`` it is the sequential walk over all of T.

A clip threshold of ``None`` disables that clip.  Clipping keeps NaN: a
NaN log-rho stays NaN through ``vs`` and the advantages, as in the JAX
kernel.

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches its kernel or raises; it never falls back.
"""

from typing import Optional, Tuple

import torch

from scalable_agent_tpu_torch.ops import _build

LAUNCHES = {"vtrace_fused": 0}
# Time chunks of the kernel's CTA (kChunks in csrc/vtrace.cu).
KERNEL_CHUNKS = 16


def _clip(rho, threshold: Optional[float]):
    """min(threshold, rho) that keeps a NaN rho NaN (torch.clamp does)."""
    return rho if threshold is None else torch.clamp(rho, max=threshold)


def vtrace_fused_plain(log_rhos, discounts, rewards, values, bootstrap_value,
                       clip_rho_threshold: Optional[float] = 1.0,
                       clip_pg_rho_threshold: Optional[float] = 1.0,
                       chunks: int = KERNEL_CHUNKS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in the kernel's order, as plain tensor ops on
    [N] rows: T cut into ``min(chunks, T)`` chunks, each chunk's steps
    folded into one affine map from its last step to its first, the maps
    combined from the last chunk back into each chunk's carry-in, then each
    chunk's sequential walk from its carry-in."""
    # ops/vtrace.py imports this module.
    from scalable_agent_tpu_torch.ops.vtrace import compose_affine

    steps = log_rhos.shape[0]
    count = max(1, min(chunks, steps))
    # T = base * count + extra: chunk w has base steps, one more if w < extra.
    base, extra = divmod(steps, count)
    bounds = [w * base + min(w, extra) for w in range(count + 1)]
    rhos = torch.exp(log_rhos)
    rho_bar = _clip(rhos, clip_rho_threshold)
    cs = _clip(rhos, 1.0)
    pg_rhos = _clip(rhos, clip_pg_rho_threshold)
    # v at each chunk's far end: the next chunk's first v, or the bootstrap.
    v_ends = [values[t1] if t1 < steps else bootstrap_value
              for t1 in bounds[1:]]

    def step_map(t, v_next):
        gamma = discounts[t]
        delta = rho_bar[t] * (rewards[t] + gamma * v_next - values[t])
        return gamma * cs[t], delta

    maps = []
    for w in range(count):
        A, B = torch.ones_like(bootstrap_value), torch.zeros_like(
            bootstrap_value)
        v_next = v_ends[w]
        for t in reversed(range(bounds[w], bounds[w + 1])):
            A, B = compose_affine((A, B), step_map(t, v_next))
            v_next = values[t]
        maps.append((A, B))
    # Chunk w's carry-in: the maps of chunks count-1, ..., w+1 applied to 0.
    carries = [torch.zeros_like(bootstrap_value)]
    for A, B in maps[:0:-1]:
        carries.append(B + A * carries[-1])
    carries.reverse()

    vs = torch.empty_like(values)
    pg = torch.empty_like(values)
    for w in range(count):
        acc, v_next = carries[w], v_ends[w]
        vs_next = v_next if bounds[w + 1] == steps else v_next + acc
        for t in reversed(range(bounds[w], bounds[w + 1])):
            a, delta = step_map(t, v_next)
            acc = delta + a * acc
            vs[t] = values[t] + acc
            pg[t] = pg_rhos[t] * (rewards[t] + discounts[t] * vs_next
                                  - values[t])
            v_next, vs_next = values[t], vs[t]
    return vs, pg


def vtrace_fused(log_rhos, discounts, rewards, values, bootstrap_value,
                 clip_rho_threshold: Optional[float] = 1.0,
                 clip_pg_rho_threshold: Optional[float] = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vs, pg_advantages) [T, N] for [T, N] inputs and bootstrap [N]."""
    inputs = (log_rhos, discounts, rewards, values, bootstrap_value)
    if _build.on_cpu("V-trace", *inputs):
        return vtrace_fused_plain(*inputs, clip_rho_threshold,
                                  clip_pg_rho_threshold)
    if log_rhos.dim() != 2:
        raise ValueError(f"log_rhos must be rank 2 [T, N], got shape "
                         f"{tuple(log_rhos.shape)}")
    steps, columns = log_rhos.shape
    if steps < 1 or columns < 1:
        raise ValueError(f"need T >= 1 and N >= 1, got {steps} x {columns}")
    for name, t in zip(("log_rhos", "discounts", "rewards", "values"),
                       inputs[:4]):
        _build.check_operand(name, t, (steps, columns))
    _build.check_operand("bootstrap_value", bootstrap_value, (columns,))
    vs = torch.empty_like(values)
    pg = torch.empty_like(values)
    code = _build.library().sat_vtrace(
        *(t.data_ptr() for t in inputs), vs.data_ptr(), pg.data_ptr(),
        steps, columns,
        0.0 if clip_rho_threshold is None else float(clip_rho_threshold),
        int(clip_rho_threshold is not None),
        0.0 if clip_pg_rho_threshold is None
        else float(clip_pg_rho_threshold),
        int(clip_pg_rho_threshold is not None),
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "vtrace kernel")
    _build.count_launch(LAUNCHES, "vtrace_fused")
    return vs, pg
