"""Fused done-reset LSTM unroll: hand-written Hopper kernels and their
plain PyTorch versions.

The counterpart of ``scalable_agent_tpu/ops/lstm_pallas.py``, with the same
math and parameter layout: gate order (i, f, g, o); i/f/o sigmoid, g tanh;
``c' = f*c + i*g``; ``h' = o*tanh(c')``; the carry is multiplied by
``1 - done`` BEFORE each step; ``Wi [D,4H]``, ``Wh [H,4H]``, ``b [4H]``.
Everything is float32 (the JAX package's ``matmul_dtype="float32"``).

Kernels (``csrc/lstm.cu``), one launch counter each in ``LAUNCHES``:

- ``lstm_fwd_lean`` replaces ``lstm_pallas.py::_fwd_kernel_lean`` (ys and
  the final carry only; actor inference and every forward that needs no
  gradient).
- ``lstm_fwd_resid`` replaces ``lstm_pallas.py::_fwd_kernel`` (also the
  residuals ``ifgo [T,B,4H]``, ``cpost``/``hpost``/``cnew [T,B,H]``).
- ``lstm_bptt`` replaces ``lstm_pallas.py::_bwd_kernel``: a reverse-chain
  kernel that stashes ``dgates [T,B,4H]``, then the hand-written strided
  GEMM for ``dx``, ``dWi``, ``dWh`` and ``db`` over the T*B rows.

What bounds them on the card, and what the design does about it, is in
the source's header comment and in PERF.md.

A wrapper takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; it never falls back.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from scalable_agent_tpu_torch.ops import _build

LAUNCHES = {"lstm_fwd_lean": 0, "lstm_fwd_resid": 0, "lstm_bptt": 0}


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


def lstm_forward_plain(x, done, c0, h0, wi, wh, b,
                       residuals: bool) -> Forward:
    """The forward as a loop of plain tensor ops over T."""
    hidden = c0.shape[-1]
    c, h = c0, h0
    ys, stash = [], []
    for t in range(x.shape[0]):
        keep = (1.0 - done[t])[:, None]
        c = keep * c
        h = keep * h
        gates = x[t] @ wi + h @ wh + b
        i = torch.sigmoid(gates[:, :hidden])
        f = torch.sigmoid(gates[:, hidden:2 * hidden])
        g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
        o = torch.sigmoid(gates[:, 3 * hidden:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if residuals:
            stash.append((torch.cat([i, f, g, o], dim=-1), c, h, c_new))
        ys.append(h_new)
        c, h = c_new, h_new
    res = None
    if residuals:
        res = Residuals(*(torch.stack(parts) for parts in zip(*stash)))
    return Forward(torch.stack(ys), c, h, res)


def lstm_backward_plain(dys, dct, dht, x, done, wi, wh,
                        res: Residuals) -> Gradients:
    """BPTT as a reverse loop of plain tensor ops (the math of
    ``lstm_pallas.py::_bwd_kernel``)."""
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
        dxs.append(dgates @ wi.T)
        dh_prev = dgates @ wh.T
        dwi = dwi + x[t].T @ dgates
        dwh = dwh + res.hpost[t].T @ dgates
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def lstm_forward(x, done, c0, h0, wi, wh, b, residuals: bool) -> Forward:
    """Done-reset LSTM forward.  ``residuals=False`` is the lean variant
    (``_fwd_kernel_lean``), ``True`` also stashes what BPTT needs
    (``_fwd_kernel``)."""
    if _build.on_cpu("LSTM", x, done, c0, h0, wi, wh, b):
        return lstm_forward_plain(x, done, c0, h0, wi, wh, b, residuals)
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
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=x.device)
    ys = empty(steps, batch, hidden)
    c_out, h_out = empty(batch, hidden), empty(batch, hidden)
    res = None
    if residuals:
        res = Residuals(empty(steps, batch, 4 * hidden),
                        empty(steps, batch, hidden),
                        empty(steps, batch, hidden),
                        empty(steps, batch, hidden))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    code = lib.sat_lstm_forward(
        ptr(x), ptr(done), ptr(c0), ptr(h0), ptr(wi), ptr(wh), ptr(b),
        ptr(ys), *(ptr(t) for t in (res or (None,) * 4)),
        ptr(c_out), ptr(h_out), steps, batch, in_dim, hidden,
        int(residuals), _stream())
    _build.check(code, "lstm forward kernel")
    _build.count_launch(
        LAUNCHES, "lstm_fwd_resid" if residuals else "lstm_fwd_lean")
    return Forward(ys, c_out, h_out, res)


def _gemm(lib, a, a_strides, b, b_strides, m, n, k, out):
    code = lib.sat_sgemm(a.data_ptr(), *a_strides, b.data_ptr(), *b_strides,
                         out.data_ptr(), m, n, k, _stream())
    _build.check(code, "lstm gemm kernel")


def lstm_backward(dys, dct, dht, x, done, wi, wh,
                  res: Residuals) -> Gradients:
    """BPTT of ``lstm_forward(..., residuals=True)`` for the cotangents
    (dys, dcT, dhT)."""
    if _build.on_cpu("LSTM", dys, dct, dht, x, done, wi, wh, *res):
        return lstm_backward_plain(dys, dct, dht, x, done, wi, wh, res)
    steps, batch, in_dim = x.shape
    hidden = wh.shape[0]
    gates = 4 * hidden
    _check_hidden(hidden)
    for name, t, shape in (
            ("dys", dys, (steps, batch, hidden)),
            ("dcT", dct, (batch, hidden)), ("dhT", dht, (batch, hidden)), ("x", x, (steps, batch, in_dim)),
            ("done", done, (steps, batch)), ("wi", wi, (in_dim, gates)),
            ("wh", wh, (hidden, gates)),
            ("ifgo", res.ifgo, (steps, batch, gates)),
            ("cpost", res.cpost, (steps, batch, hidden)),
            ("hpost", res.hpost, (steps, batch, hidden)),
            ("cnew", res.cnew, (steps, batch, hidden))):
        _build.check_operand(name, t, shape)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=x.device)
    dgates = empty(steps, batch, gates)
    dc0, dh0 = empty(batch, hidden), empty(batch, hidden)
    lib = _build.library()
    code = lib.sat_lstm_backward_chain(
        dys.data_ptr(), done.data_ptr(), res.ifgo.data_ptr(),
        res.cpost.data_ptr(), res.cnew.data_ptr(), wh.data_ptr(),
        dct.data_ptr(), dht.data_ptr(), dgates.data_ptr(), dc0.data_ptr(),
        dh0.data_ptr(), steps, batch, hidden, _stream())
    _build.check(code, "lstm backward chain kernel")
    rows = steps * batch
    dx = empty(steps, batch, in_dim)
    dwi, dwh, db = empty(in_dim, gates), empty(hidden, gates), empty(gates)
    ones = torch.ones(1, dtype=torch.float32, device=x.device)
    # dx = dgates . Wi^T;  dWi = x^T . dgates;  dWh = hpost^T . dgates;
    # db = 1^T . dgates (a stride-0 row of ones).
    _gemm(lib, dgates, (gates, 1), wi, (1, gates), rows, in_dim, gates, dx)
    _gemm(lib, x, (1, in_dim), dgates, (gates, 1), in_dim, gates, rows, dwi)
    _gemm(lib, res.hpost, (1, hidden), dgates, (gates, 1), hidden, gates,
          rows, dwh)
    _gemm(lib, ones, (0, 0), dgates, (gates, 1), 1, gates, rows, db)
    _build.count_launch(LAUNCHES, "lstm_bptt")
    return Gradients(dx, dc0, dh0, dwi, dwh, db)


class _LSTMUnroll(torch.autograd.Function):
    """Residual forward + BPTT kernel as one differentiable op."""

    @staticmethod
    def forward(ctx, x, done, c0, h0, wi, wh, b):
        out = lstm_forward(x, done, c0, h0, wi, wh, b, residuals=True)
        ctx.save_for_backward(x, done, wi, wh, *out.residuals)
        return out.ys, out.c, out.h

    @staticmethod
    def backward(ctx, dys, dct, dht):
        x, done, wi, wh, *res = ctx.saved_tensors
        zeros = lambda t, like: (torch.zeros_like(like) if t is None
                                 else t.contiguous())
        grads = lstm_backward(
            zeros(dys, res[3]), zeros(dct, res[3][0]),
            zeros(dht, res[3][0]), x, done, wi, wh, Residuals(*res))
        return (grads.dx, None, grads.dc0, grads.dh0, grads.dwi, grads.dwh,
                grads.db)


def lstm_unroll(x, done, c0, h0, wi, wh, b
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused done-reset LSTM unroll, the contract of
    ``lstm_pallas.lstm_unroll``.

    x [T,B,D] float32, done [T,B] float32 (1.0 resets the carry BEFORE the
    step), c0/h0 [B,H], wi [D,4H], wh [H,4H], b [4H] in (i,f,g,o) order.
    Returns ``(ys [T,B,H], (cT, hT))``, differentiable in everything but
    ``done``.  Where no gradient can flow (``torch.no_grad()``, or no input
    requires one) it runs the lean forward, which writes no residuals.
    """
    args = (x, done, c0, h0, wi, wh, b)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, c0, h0, wi, wh, b)):
        ys, c, h = _LSTMUnroll.apply(*args)
    else:
        ys, c, h, _ = lstm_forward(*args, residuals=False)
    return ys, (c, h)
