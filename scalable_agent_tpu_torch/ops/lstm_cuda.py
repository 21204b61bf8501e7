"""Fused done-reset LSTM unroll: hand-written Hopper kernels and their
plain PyTorch versions.

The counterpart of ``scalable_agent_tpu/ops/lstm_pallas.py``, with the same
math and parameter layout: gate order (i, f, g, o); i/f/o sigmoid, g tanh;
``c' = f*c + i*g``; ``h' = o*tanh(c')``; the carry is multiplied by
``1 - done`` BEFORE each step; ``Wi [D,4H]``, ``Wh [H,4H]``, ``b [4H]``.
Every tensor is float32.  ``matmul_dtype`` is the JAX package's: the
operand type of the products (x.Wi and h.Wh; in BPTT dx, dh_prev, dWi and
dWh), ``"float32"`` or ``"bfloat16"`` -- the latter rounds each operand to
bf16 (``.to(bfloat16)``, round-to-nearest-even) and sums the exact
products in float32, as ``lstm_pallas.py::_mm`` does.  Carries, outputs,
residuals, the bias and db stay float32 (db sums the unrounded dgates).
``compute_dtype=bfloat16`` resolves to ``"bfloat16"`` (config.py).

Kernels (``csrc/lstm.cu``), one launch counter each in ``LAUNCHES`` per
operand type (the bf16 variants' counters end in ``_bf16``; every kernel
reads float32 and rounds the operands in registers, each a template on
their type but the T=1 step, which has a kernel for each):

- ``lstm_fwd_lean`` replaces ``lstm_pallas.py::_fwd_kernel_lean`` (ys and
  the final carry only; actor inference and every forward that needs no
  gradient) at T=1: one done-reset step for all batch rows, one launch.
  The step is latency-bound (2.3 MB, 34 MFLOP at B=32, D=266, H=256), so
  the gate columns are split over the card, each CTA owning a few hidden
  units.  float32 (``lstm_step_kernel``): clusters of 4 CTAs own 8 units
  for every batch row, each CTA a quarter of the D+H reduction, the
  partial gates summed through distributed shared memory in a fixed
  order.  bf16 operands (``lstm_step_mma_kernel``): no cluster; a CTA owns
  8 units for 16 batch rows over the whole depth on ``mma.sync`` tensor
  cores, each lane loading its fragments' elements straight into
  registers, all before the first use; the warps' partial gates are
  summed in a fixed order.
- ``lstm_fwd_lean_unroll`` replaces the same TPU kernel at T>1 (the IMPACT
  target network's unroll): one C call (``sat_lstm_forward_lean[_bf16]``),
  the residual forward's two launches below without its residual stores,
  Wh resident over all T steps as the TPU kernel's constant-index blocks
  keep Wi and Wh; its ys and carry are bitwise the residual forward's, so
  its gates are summed as ``(x.Wi + b) + h.Wh`` too.
- ``lstm_fwd_resid`` replaces ``lstm_pallas.py::_fwd_kernel`` (also the
  residuals ``ifgo [T,B,4H]``, ``cpost``/``hpost``/``cnew [T,B,H]``) with
  two launches.  The input projection has no recurrence, so
  ``pre = x.Wi + b`` over all T*B rows is one launch of the hand-written
  GEMM (``pre`` is the wrapper's scratch).  Then the recurrence keeps Wh
  on chip for all T steps: clusters of 8 CTAs split the batch, each CTA
  owns H/8 hidden units and holds their slice of Wh in shared memory,
  and the new h reaches every CTA of the cluster through distributed
  shared memory, one cluster barrier per step.  ``resid_plan`` sizes it.
- ``lstm_bptt`` replaces ``lstm_pallas.py::_bwd_kernel`` with one C call
  (``sat_lstm_backward[_bf16]``).  The reverse chain is the residual
  forward's cluster design in reverse: each CTA of a cluster of 8 holds
  ITS units' rows of Wh (all 4H columns) in shared memory, so it computes
  those units' ``dh_prev`` from the step's dgates, which every owner
  stores into every CTA through distributed shared memory, one cluster
  barrier per step; the owners also sum db over t in registers.  It
  stashes ``dgates [T,B,4H]`` at the operand type for ``dx``, ``dWi`` and
  ``dWh``: hand-written bf16 tensor-core GEMMs in the bf16 variant (the
  weight gradient in fixed K slices), the strided float32 GEMM in the
  float32 one.  A last launch sums db over the batch (and the dW slices)
  in a fixed order.  ``bptt_plan`` and ``wgrad_splits`` size it.

What bounds them on the card, and what the design does about it, is in
the source's header comment and in PERF.md.

A wrapper takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; it never falls back.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from scalable_agent_tpu_torch.ops import _build

MATMUL_DTYPES = ("float32", "bfloat16")
LAUNCHES = {name + suffix: 0
            for name in ("lstm_fwd_lean", "lstm_fwd_lean_unroll",
                         "lstm_fwd_resid", "lstm_bptt")
            for suffix in ("", "_bf16")}


def _check_matmul_dtype(matmul_dtype: str) -> str:
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(
            f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype!r}")
    return matmul_dtype


def _suffix(matmul_dtype: str) -> str:
    """The suffix of a variant's C entry points and launch counters."""
    return "_bf16" if _check_matmul_dtype(matmul_dtype) == "bfloat16" else ""


class Residuals(NamedTuple):
    """What the residual forward stashes for BPTT, all [T, B, ...]."""

    ifgo: torch.Tensor   # gate activations, [T, B, 4H]
    cpost: torch.Tensor  # post-reset carries fed to each step, [T, B, H]
    hpost: torch.Tensor
    cnew: torch.Tensor   # each step's new cell state, [T, B, H]


class Forward(NamedTuple):
    ys: torch.Tensor                 # [T, B, H]
    c: torch.Tensor                  # final carry, [B, H]
    h: torch.Tensor
    residuals: Optional[Residuals]   # None from the lean variant


class Gradients(NamedTuple):
    dx: torch.Tensor
    dc0: torch.Tensor
    dh0: torch.Tensor
    dwi: torch.Tensor
    dwh: torch.Tensor
    db: torch.Tensor


# -- plain PyTorch versions --------------------------------------------------


def _mm(a, b, matmul_dtype: str):
    """``a @ b`` of float32 tensors with the operands rounded to
    ``matmul_dtype`` and the products summed in float32
    (``lstm_pallas.py::_mm``)."""
    if matmul_dtype == "bfloat16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    return a @ b


def _cell(x_t, done_t, c, h, wi, wh, b, matmul_dtype="float32"):
    """One done-reset step: the carry is multiplied by ``1 - done`` before
    it.  Returns ((i, f, g, o), post-reset c, post-reset h, c', h')."""
    hidden = c.shape[-1]
    keep = (1.0 - done_t)[:, None]
    c = keep * c
    h = keep * h
    gates = _mm(x_t, wi, matmul_dtype) + _mm(h, wh, matmul_dtype) + b
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden:2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden:])
    c_new = f * c + i * g
    return (i, f, g, o), c, h, c_new, o * torch.tanh(c_new)


def lstm_step_plain(x_t, done_t, c, h, wi, wh, b, matmul_dtype="float32"):
    """The plain version of the lean step kernel: (h', c')."""
    *_, c_new, h_new = _cell(x_t, done_t, c, h, wi, wh, b,
                             _check_matmul_dtype(matmul_dtype))
    return h_new, c_new


def lstm_forward_plain(x, done, c0, h0, wi, wh, b, residuals: bool,
                       matmul_dtype: str = "float32") -> Forward:
    """The forward as a loop of plain tensor ops over T."""
    _check_matmul_dtype(matmul_dtype)
    c, h = c0, h0
    ys, stash = [], []
    for t in range(x.shape[0]):
        gates, c_post, h_post, c, h = _cell(x[t], done[t], c, h, wi, wh, b,
                                            matmul_dtype)
        if residuals:
            stash.append((torch.cat(gates, dim=-1), c_post, h_post, c))
        ys.append(h)
    res = None
    if residuals:
        res = Residuals(*(torch.stack(parts) for parts in zip(*stash)))
    return Forward(torch.stack(ys), c, h, res)


def lstm_backward_plain(dys, dct, dht, x, done, wi, wh, res: Residuals,
                        matmul_dtype: str = "float32") -> Gradients:
    """BPTT as a reverse loop of plain tensor ops (the math of
    ``lstm_pallas.py::_bwd_kernel``: dgates, x and hpost are product
    operands, db sums the float32 dgates)."""
    _check_matmul_dtype(matmul_dtype)
    mm = lambda a, b: _mm(a, b, matmul_dtype)
    hidden = dct.shape[-1]
    dc, dh = dct, dht
    dwi = torch.zeros_like(wi)
    dwh = torch.zeros_like(wh)
    db = torch.zeros(wi.shape[-1], dtype=wi.dtype, device=wi.device)
    dxs = []
    for t in reversed(range(x.shape[0])):
        ifgo = res.ifgo[t]
        i = ifgo[:, :hidden]
        f = ifgo[:, hidden:2 * hidden]
        g = ifgo[:, 2 * hidden:3 * hidden]
        o = ifgo[:, 3 * hidden:]
        tanh_c = torch.tanh(res.cnew[t])
        dh = dys[t] + dh
        do = dh * tanh_c * o * (1.0 - o)
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        df = dc * res.cpost[t] * f * (1.0 - f)
        di = dc * g * i * (1.0 - i)
        dg = dc * i * (1.0 - g * g)
        dgates = torch.cat([di, df, dg, do], dim=-1)
        dxs.append(mm(dgates, wi.T))
        dh_prev = mm(dgates, wh.T)
        dwi = dwi + mm(x[t].T, dgates)
        dwh = dwh + mm(res.hpost[t].T, dgates)
        db = db + dgates.sum(dim=0)
        keep = (1.0 - done[t])[:, None]
        dc = dc * f * keep
        dh = dh_prev * keep
    dx = torch.stack(dxs[::-1])
    return Gradients(dx, dc, dh, dwi, dwh, db)


# -- kernel wrappers ---------------------------------------------------------


def _check_hidden(hidden):
    if hidden % 32 or not 32 <= hidden <= 1024:
        raise ValueError(
            f"the CUDA LSTM kernels run one thread per hidden unit and "
            f"need H a multiple of 32 in [32, 1024], got {hidden}")


RESID_CLUSTER = 8     # CTAs per cluster of the recurrence kernel
SMEM_LIMIT = 232_448  # shared memory one block can use on an H100


class ResidPlan(NamedTuple):
    """Launch geometry of the residual forward's recurrence kernel."""

    rows: int        # batch rows per cluster (R)
    clusters: int
    resident: int    # rows of a CTA's [H, 4H/8] Wh slice in shared memory
    smem_bytes: int  # dynamic shared memory per CTA


def _fit(batch, hidden, fixed_per_row, cls):
    """The plan of a cluster kernel.  R is the least power of two that
    covers the batch with at most 8 clusters (64 SMs, co-resident on an
    H100), capped by H so that a CTA of H threads keeps its 4R
    accumulators in registers (csrc/lstm.cu's ``resid_max_threads``).  A
    CTA holds ``fixed_per_row * R * H`` bytes of buffers, then as many of
    its Wh slice's 2*H-byte rows as fit, a multiple of 4 (the kernels'
    float4 loop)."""
    _check_hidden(hidden)
    most = 8 if hidden <= 256 else 4 if hidden <= 512 else 2
    rows = 1
    while rows < min(-(-batch // RESID_CLUSTER), most):
        rows *= 2
    fixed = fixed_per_row * rows * hidden
    row_bytes = 2 * hidden
    resident = min(hidden, (SMEM_LIMIT - fixed) // row_bytes // 4 * 4)
    return cls(rows, -(-batch // rows), resident, fixed + resident * row_bytes)


def resid_plan(batch: int, hidden: int) -> ResidPlan:
    """R as ``_fit`` picks it.  A CTA holds 8 partial gate vectors and two
    h buffers for its R rows (24*R*H bytes), then as many rows of its [H, 4H/8] Wh slice (2*H bytes
    each) as fit: all of them up to about H=300.  T and D do not enter the
    plan."""
    return _fit(batch, hidden, 24, ResidPlan)


class BpttPlan(NamedTuple):
    """Launch geometry of BPTT's reverse-chain kernel."""

    rows: int        # batch rows per cluster (R)
    clusters: int
    resident: int    # depth positions j of a CTA's [H/8, 4H] Wh slice in
    #                  shared memory (each the 4 gate columns g*H + j)
    smem_bytes: int  # dynamic shared memory per CTA


def bptt_plan(batch: int, hidden: int) -> BpttPlan:
    """R as ``_fit`` picks it.  A CTA holds two [R, H] x 4-gate dgates
    buffers and 8 partial dh_prev vectors for its R rows (36*R*H bytes),
    then as many depth positions of its [H/8, 4H] Wh slice (4 gates x H/8
    units: 2*H bytes each) as fit: all of them up to about H=300.  T and D
    do not enter the plan."""
    return _fit(batch, hidden, 36, BpttPlan)


GEMM_TILE = 64        # output tile of the bf16 variant's GEMMs
GEMM_DEPTH = 32       # K of one shared-memory tile
WGRAD_BLOCKS = 528    # 4 blocks of the dW GEMM on each of 132 SMs


def wgrad_splits(rows: int, in_dim: int, hidden: int) -> int:
    """How many fixed K slices the bf16 variant cuts the [D+H, 4H] weight
    gradient's ``rows``-deep sum into: enough for about WGRAD_BLOCKS
    blocks, at most one a 32-deep tile.  Each slice's partial is summed in
    slice order, so the result depends on the shapes only."""
    tiles = -(-(in_dim + hidden) // GEMM_TILE) * (4 * hidden // GEMM_TILE)
    return max(1, min(-(-rows // GEMM_DEPTH), -(-WGRAD_BLOCKS // tiles)))


def _active_clusters(entry: str, plan, hidden: int) -> int:
    n = getattr(_build.library(), entry)(hidden, plan.rows, plan.smem_bytes)
    if n < 0:
        _build.check(-n, "lstm cluster occupancy query")
    return n


def resid_active_clusters(plan: ResidPlan, hidden: int) -> int:
    """How many clusters of the recurrence kernel the card holds at once
    under ``plan`` (``cudaOccupancyMaxActiveClusters``); more clusters than
    that run in waves."""
    return _active_clusters("sat_lstm_resid_active_clusters", plan, hidden)


def bptt_active_clusters(plan: BpttPlan, hidden: int) -> int:
    """The same for BPTT's reverse-chain kernel."""
    return _active_clusters("sat_lstm_bptt_active_clusters", plan, hidden)


def _stream():
    return torch.cuda.current_stream().cuda_stream


Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


def lean_forward(step: Step, x, done, c0, h0) -> Forward:
    """The lean forward as T calls of ``step(x_t, done_t, c, h) -> (h', c')``:
    the plain version's loop (on the card a T=1 forward is one launch of
    the step kernel and a longer one the lean unroll).  At T=1 ``ys`` is a
    view of the new h."""
    c, h = c0, h0
    ys = []
    for t in range(x.shape[0]):
        h, c = step(x[t], done[t], c, h)
        ys.append(h)
    return Forward(ys[0][None] if len(ys) == 1 else torch.stack(ys), c, h,
                   None)


def lstm_forward(x, done, c0, h0, wi, wh, b, residuals: bool,
                 matmul_dtype: str = "float32") -> Forward:
    """Done-reset LSTM forward.  ``residuals=False`` is the lean variant
    (``_fwd_kernel_lean``: the step kernel at T=1, the lean unroll past
    it), ``True`` also stashes what BPTT needs (``_fwd_kernel``)."""
    suffix = _suffix(matmul_dtype)
    if _build.on_cpu("LSTM", x, done, c0, h0, wi, wh, b):
        if residuals:
            return lstm_forward_plain(x, done, c0, h0, wi, wh, b, True,
                                      matmul_dtype)
        return lean_forward(
            lambda x_t, done_t, c, h: lstm_step_plain(
                x_t, done_t, c, h, wi, wh, b, matmul_dtype),
            x, done, c0, h0)
    steps, batch, in_dim = x.shape
    hidden = c0.shape[-1]
    _check_hidden(hidden)
    if steps < 1 or batch < 1:
        raise ValueError(f"need T >= 1 and B >= 1, got x {tuple(x.shape)}")
    for name, t, shape in (
            ("x", x, (steps, batch, in_dim)), ("done", done, (steps, batch)),
            ("c0", c0, (batch, hidden)), ("h0", h0, (batch, hidden)),
            ("wi", wi, (in_dim, 4 * hidden)),
            ("wh", wh, (hidden, 4 * hidden)), ("b", b, (4 * hidden,))):
        _build.check_operand(name, t, shape)
    if wi.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("the LSTM kernels read Wi and Wh in 16-byte "
                         "vectors: they must be 16-byte aligned")
    lib = _build.library()
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=x.device)
    ys = empty(steps, batch, hidden)
    c_out = empty(batch, hidden)
    if not residuals and steps == 1:
        code = getattr(lib, "sat_lstm_step" + suffix)(
            *(t.data_ptr() for t in (x, done, c0, h0, wi, wh, b, ys,
                                     c_out)),
            batch, in_dim, hidden, _stream())
        _build.check(code, "lstm step kernel")
        _build.count_launch(LAUNCHES, "lstm_fwd_lean" + suffix)
        return Forward(ys, c_out, ys[0], None)
    h_out = empty(batch, hidden)
    pre = empty(steps * batch, 4 * hidden)  # x.Wi + b, scratch
    plan = resid_plan(batch, hidden)
    geometry = (steps, batch, in_dim, hidden, plan.rows, plan.resident,
                plan.smem_bytes, _stream())
    if not residuals:
        code = getattr(lib, "sat_lstm_forward_lean" + suffix)(
            *(t.data_ptr() for t in (x, done, c0, h0, wi, wh, b, pre, ys,
                                     c_out, h_out)), *geometry)
        _build.check(code, "lstm lean unroll kernels")
        _build.count_launch(LAUNCHES, "lstm_fwd_lean_unroll" + suffix)
        return Forward(ys, c_out, h_out, None)
    res = Residuals(empty(steps, batch, 4 * hidden),
                    empty(steps, batch, hidden),
                    empty(steps, batch, hidden),
                    empty(steps, batch, hidden))
    code = getattr(lib, "sat_lstm_forward_resid" + suffix)(
        *(t.data_ptr() for t in (x, done, c0, h0, wi, wh, b, pre, ys, *res,
                                 c_out, h_out)), *geometry)
    _build.check(code, "lstm residual forward kernels")
    _build.count_launch(LAUNCHES, "lstm_fwd_resid" + suffix)
    return Forward(ys, c_out, h_out, res)


def lstm_backward(dys, dct, dht, x, done, wi, wh, res: Residuals,
                  matmul_dtype: str = "float32") -> Gradients:
    """BPTT of ``lstm_forward(..., residuals=True)`` for the cotangents
    (dys, dcT, dhT)."""
    suffix = _suffix(matmul_dtype)
    if _build.on_cpu("LSTM", dys, dct, dht, x, done, wi, wh, *res):
        return lstm_backward_plain(dys, dct, dht, x, done, wi, wh, res,
                                   matmul_dtype)
    steps, batch, in_dim = x.shape
    hidden = wh.shape[0]
    gates = 4 * hidden
    _check_hidden(hidden)
    for name, t, shape in (
            ("dys", dys, (steps, batch, hidden)),
            ("dcT", dct, (batch, hidden)), ("dhT", dht, (batch, hidden)),
            ("x", x, (steps, batch, in_dim)),
            ("done", done, (steps, batch)), ("wi", wi, (in_dim, gates)),
            ("wh", wh, (hidden, gates)),
            ("ifgo", res.ifgo, (steps, batch, gates)),
            ("cpost", res.cpost, (steps, batch, hidden)),
            ("hpost", res.hpost, (steps, batch, hidden)),
            ("cnew", res.cnew, (steps, batch, hidden))):
        _build.check_operand(name, t, shape)
    if wi.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("the LSTM kernels read Wi and Wh in 16-byte "
                         "vectors: they must be 16-byte aligned")
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=x.device)
    plan = bptt_plan(batch, hidden)
    bf16 = matmul_dtype == "bfloat16"
    splits = wgrad_splits(steps * batch, in_dim, hidden) if bf16 else 0
    grads = Gradients(empty(steps, batch, in_dim), empty(batch, hidden),
                      empty(batch, hidden), empty(in_dim, gates),
                      empty(hidden, gates), empty(gates))
    # Scratch: dgates at the operand type, each row's db over t, and the
    # bf16 variant's dW slices.
    dgates = empty(steps, batch, gates,
                   dtype=torch.bfloat16 if bf16 else torch.float32)
    dbpart = empty(batch, gates)
    wpart = empty(splits, in_dim + hidden, gates)
    code = getattr(_build.library(), "sat_lstm_backward" + suffix)(
        *(t.data_ptr() for t in (dys, done, res.ifgo, res.cpost, res.hpost,
                                 res.cnew, x, wi, wh, dct, dht, *grads,
                                 dgates, dbpart, wpart)),
        steps, batch, in_dim, hidden, plan.rows, plan.resident,
        plan.smem_bytes, splits, _stream())
    _build.check(code, "lstm backward kernels")
    _build.count_launch(LAUNCHES, "lstm_bptt" + suffix)
    return grads


class _LSTMUnroll(torch.autograd.Function):
    """Residual forward + BPTT kernel as one differentiable op; every
    gradient is float32, as every input is."""

    @staticmethod
    def forward(ctx, x, done, c0, h0, wi, wh, b, matmul_dtype):
        out = lstm_forward(x, done, c0, h0, wi, wh, b, residuals=True,
                           matmul_dtype=matmul_dtype)
        ctx.save_for_backward(x, done, wi, wh, *out.residuals)
        ctx.matmul_dtype = matmul_dtype
        return out.ys, out.c, out.h

    @staticmethod
    def backward(ctx, dys, dct, dht):
        x, done, wi, wh, *res = ctx.saved_tensors
        zeros = lambda t, like: (torch.zeros_like(like) if t is None
                                 else t.contiguous())
        grads = lstm_backward(
            zeros(dys, res[3]), zeros(dct, res[3][0]),
            zeros(dht, res[3][0]), x, done, wi, wh, Residuals(*res),
            ctx.matmul_dtype)
        return (grads.dx, None, grads.dc0, grads.dh0, grads.dwi, grads.dwh,
                grads.db, None)


def lstm_unroll(x, done, c0, h0, wi, wh, b, matmul_dtype: str = "float32",
                residuals: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused done-reset LSTM unroll, the contract of
    ``lstm_pallas.lstm_unroll`` (``matmul_dtype`` as there).

    x [T,B,D] float32, done [T,B] float32 (1.0 resets the carry BEFORE the
    step), c0/h0 [B,H], wi [D,4H], wh [H,4H], b [4H] in (i,f,g,o) order.
    Returns ``(ys [T,B,H], (cT, hT))``, differentiable in everything but
    ``done``.  Where no gradient can flow (``torch.no_grad()``, or no input
    requires one) it runs the lean forward, which writes no residuals,
    unless ``residuals``: then it runs the residual forward of the
    differentiated unroll (and drops the residuals), so the values equal
    that unroll's.
    """
    args = (x, done, c0, h0, wi, wh, b)
    _check_matmul_dtype(matmul_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, c0, h0, wi, wh, b)):
        ys, c, h = _LSTMUnroll.apply(*args, matmul_dtype)
    else:
        ys, c, h, _ = lstm_forward(*args, residuals=residuals,
                                   matmul_dtype=matmul_dtype)
    return ys, (c, h)
