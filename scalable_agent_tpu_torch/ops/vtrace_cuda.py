"""Fused V-trace: a hand-written Hopper kernel and its plain PyTorch
version.

The counterpart of ``scalable_agent_tpu/ops/vtrace_pallas.py``, with the
same contract: rank-2 ``[T, N]`` float32 inputs, bootstrap ``[N]``, returns
``(vs, pg_advantages)``; callers flatten extra trailing dims into N
(``ops/vtrace.py``).  The outputs feed the loss under stop-gradient, so
there is no backward.

Kernel (``csrc/vtrace.cu``), launch counter ``LAUNCHES["vtrace_fused"]``:
replaces ``vtrace_pallas.py::_vtrace_kernel`` (via ``vtrace_fused``).  One
thread per column walks t from T-1 down to 0 with the recurrence carry in
registers; see the source's header comment and PERF.md for its bound.

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


def _clip(rho, threshold: Optional[float]):
    """min(threshold, rho) that keeps a NaN rho NaN (torch.clamp does)."""
    return rho if threshold is None else torch.clamp(rho, max=threshold)


def vtrace_fused_plain(log_rhos, discounts, rewards, values, bootstrap_value,
                       clip_rho_threshold: Optional[float] = 1.0,
                       clip_pg_rho_threshold: Optional[float] = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as plain tensor ops: one reverse pass over
    T on [N] rows, each step in the kernel's order."""
    rhos = torch.exp(log_rhos)
    rho_bar = _clip(rhos, clip_rho_threshold)
    cs = _clip(rhos, 1.0)
    pg_rhos = _clip(rhos, clip_pg_rho_threshold)
    vs = torch.empty_like(values)
    pg = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_value)
    v_next = vs_next = bootstrap_value
    for t in reversed(range(log_rhos.shape[0])):
        gamma, r, v = discounts[t], rewards[t], values[t]
        delta = rho_bar[t] * (r + gamma * v_next - v)
        acc = delta + (gamma * cs[t]) * acc
        vs[t] = v + acc
        pg[t] = pg_rhos[t] * (r + gamma * vs_next - v)
        v_next, vs_next = v, vs[t]
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
