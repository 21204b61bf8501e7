"""The port's done-reset LSTM (scalable_agent_tpu_torch/ops/lstm_cuda.py)
held against the JAX package's Pallas LSTM (ops/lstm_pallas.py), run as
the JAX package's own tests run it on the CPU: in interpret mode.

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold that arithmetic (forward, residuals, BPTT) to the Pallas
kernel's; chip_smoke.py holds the CUDA kernels to the same plain versions
on the card.

Tolerances: float32 on both sides, the same operations summed in another
order over at most D+H = 28 terms per dot product and T*B = 20 rows per
weight gradient — rtol/atol 1e-5 is ~100x f32 epsilon at these scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.ops import lstm_pallas
from scalable_agent_tpu_torch.ops import lstm_cuda

T, B, D, H = 5, 4, 12, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, done_rate=0.3):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, scale=1.0: (
        rng.standard_normal(shape) * scale).astype(np.float32)
    done = (rng.random((T, B)) < done_rate).astype(np.float32)
    return dict(x=f32(T, B, D), done=done, c0=f32(B, H, scale=0.5),
                h0=np.tanh(f32(B, H)), wi=f32(D, 4 * H, scale=D ** -0.5),
                wh=f32(H, 4 * H, scale=H ** -0.5), b=f32(4 * H, scale=0.1))


ORDER = ("x", "done", "c0", "h0", "wi", "wh", "b")


def _jax_unroll(arrays):
    return lstm_pallas.lstm_unroll(*(jnp.asarray(arrays[k]) for k in ORDER),
                                   True, "float32")


def _torch(arrays, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad and k != "done")
            for k, v in arrays.items()}


@pytest.mark.parametrize("seed,done_rate", [(0, 0.3), (1, 0.0), (2, 1.0)])
def test_forward_matches_pallas(seed, done_rate):
    arrays = _inputs(seed, done_rate)
    ys_j, (c_j, h_j) = _jax_unroll(arrays)
    t = _torch(arrays)
    ys, (c, h) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)


def test_all_gradients_match_pallas_vjp():
    """Every gradient of the unroll (x, c0, h0, Wi, Wh, b) for random
    cotangents on (ys, cT, hT), against jax.vjp through the Pallas
    custom VJP (its residual forward and BPTT kernel)."""
    arrays = _inputs(3)
    rng = np.random.default_rng(4)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    dct = rng.standard_normal((B, H)).astype(np.float32)
    dht = rng.standard_normal((B, H)).astype(np.float32)

    diff_keys = ("x", "c0", "h0", "wi", "wh", "b")

    def f(x, c0, h0, wi, wh, b):
        return lstm_pallas.lstm_unroll(
            x, jnp.asarray(arrays["done"]), c0, h0, wi, wh, b, True,
            "float32")

    _, vjp = jax.vjp(f, *(jnp.asarray(arrays[k]) for k in diff_keys))
    grads_j = vjp((jnp.asarray(dys), (jnp.asarray(dct), jnp.asarray(dht))))

    t = _torch(arrays, requires_grad=True)
    ys, (c, h) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    grads = torch.autograd.grad(
        (ys, c, h), [t[k] for k in diff_keys],
        (torch.tensor(dys), torch.tensor(dct), torch.tensor(dht)))
    for key, got, want in zip(diff_keys, grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=key, **TOL)


def test_bptt_plain_matches_autograd_of_the_plain_forward():
    """The hand-written BPTT's plain version against torch's own autograd
    through the plain forward: an oracle independent of both kernels."""
    t = _torch(_inputs(5), requires_grad=True)
    args = [t[k] for k in ORDER]
    out = lstm_cuda.lstm_forward_plain(*args, residuals=True)
    rng = np.random.default_rng(6)
    dys = torch.tensor(rng.standard_normal((T, B, H)), dtype=torch.float32)
    dct = torch.tensor(rng.standard_normal((B, H)), dtype=torch.float32)
    dht = torch.tensor(rng.standard_normal((B, H)), dtype=torch.float32)
    auto = torch.autograd.grad((out.ys, out.c, out.h),
                               [t[k] for k in ("x", "c0", "h0", "wi", "wh",
                                               "b")], (dys, dct, dht))
    res = lstm_cuda.Residuals(*(r.detach() for r in out.residuals))
    hand = lstm_cuda.lstm_backward_plain(
        dys, dct, dht, t["x"].detach(), t["done"], t["wi"].detach(),
        t["wh"].detach(), res)
    for got, want in zip(hand, auto):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_unused_outputs_get_zero_cotangents():
    """Only hT feeds the loss: the autograd Function must fill the missing
    cotangents (ys, cT) with zeros, as jax.vjp does."""
    arrays = _inputs(7)
    t = _torch(arrays, requires_grad=True)
    _, (_, h) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    dwh, = torch.autograd.grad(h.sum(), [t["wh"]])

    def f(wh):
        _, (_, hj) = lstm_pallas.lstm_unroll(
            *(jnp.asarray(arrays[k]) for k in ORDER[:5]), wh,
            jnp.asarray(arrays["b"]), True, "float32")
        return jnp.sum(hj)

    np.testing.assert_allclose(
        dwh.numpy(), np.asarray(jax.grad(f)(jnp.asarray(arrays["wh"]))),
        **TOL)


def test_no_grad_runs_the_lean_forward(monkeypatch):
    """Inference (no_grad, or nothing requiring grad) takes the lean
    variant; a differentiable call takes the residual one."""
    seen = []
    real = lstm_cuda.lstm_forward

    def spy(*args, residuals, **kwargs):
        seen.append(residuals)
        return real(*args, residuals=residuals, **kwargs)

    monkeypatch.setattr(lstm_cuda, "lstm_forward", spy)
    t = _torch(_inputs(8), requires_grad=True)
    with torch.no_grad():
        lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    lstm_cuda.lstm_unroll(*(t[k].detach() for k in ORDER))
    lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    assert seen == [False, False, True]


def test_cuda_wrapper_refuses_mixed_devices():
    t = _torch(_inputs(9))
    meta = {k: v.to("meta") for k, v in t.items()}
    meta["x"] = t["x"]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        lstm_cuda.lstm_forward(*(meta[k] for k in ORDER), residuals=False)


@pytest.mark.parametrize("batch", [1, 33])
def test_lean_step_at_full_width_matches_pallas(batch):
    """The actor's lean forward, T=1 at the agent's width (D=266, H=256),
    against the Pallas lean kernel in interpret mode."""
    rng = np.random.default_rng(batch)
    d, h = 266, 256
    f32 = lambda *shape, scale=1.0: (
        rng.standard_normal(shape) * scale).astype(np.float32)
    arrays = dict(x=f32(1, batch, d),
                  done=(rng.random((1, batch)) < 0.3).astype(np.float32),
                  c0=f32(batch, h, scale=0.5), h0=np.tanh(f32(batch, h)),
                  wi=f32(d, 4 * h, scale=d ** -0.5),
                  wh=f32(h, 4 * h, scale=h ** -0.5), b=f32(4 * h, scale=0.1))
    ys_j, (c_j, h_j) = _jax_unroll(arrays)
    t = _torch(arrays)
    with torch.no_grad():
        ys, (c, hh) = lstm_cuda.lstm_unroll(*(t[k] for k in ORDER))
    for got, want in ((ys, ys_j), (c, c_j), (hh, h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hidden", [32, 256, 320, 512, 1024])
@pytest.mark.parametrize("batch", [1, 31, 32, 33, 64])
def test_resid_plan_fits_and_covers_the_batch(batch, hidden):
    """Every batch row in exactly one cluster (none empty), the shared
    memory within an H100 block's 232,448 bytes, a CTA of H threads within
    the register cap of its R, and the resident rows a multiple of 4 that
    the kernel's float4 loop can split at."""
    plan = lstm_cuda.resid_plan(batch, hidden)
    assert plan.rows in (1, 2, 4, 8)
    assert (plan.clusters - 1) * plan.rows < batch <= plan.clusters * plan.rows
    assert plan.smem_bytes <= lstm_cuda.SMEM_LIMIT
    assert plan.smem_bytes == (24 * plan.rows + 2 * plan.resident) * hidden
    assert 0 < plan.resident <= hidden and plan.resident % 4 == 0
    assert hidden <= {8: 256, 4: 512}.get(plan.rows, 1024)
    if batch <= lstm_cuda.RESID_CLUSTER * plan.rows:
        assert plan.clusters <= lstm_cuda.RESID_CLUSTER


def test_resid_plan_keeps_all_of_wh_on_chip_at_the_main_path():
    """B=32, H=256: 8 clusters of 4 rows, each CTA's [256, 128] slice of
    Wh (128 KiB) whole in shared memory; at B=1 one cluster."""
    assert lstm_cuda.resid_plan(32, 256) == lstm_cuda.ResidPlan(
        rows=4, clusters=8, resident=256, smem_bytes=155_648)
    assert lstm_cuda.resid_plan(1, 256) == lstm_cuda.ResidPlan(1, 1, 256,
                                                               137_216)


@pytest.mark.parametrize("batch,resident", [(4, 212), (32, 176)])
def test_resid_plan_streams_the_rest_of_wh_at_h512(batch, resident):
    """H=512: a CTA's slice of Wh is 512 KiB, so only `resident` of its 512
    rows stay in shared memory and the rest are read from L2 each step."""
    plan = lstm_cuda.resid_plan(batch, 512)
    assert plan.resident == resident < 512


def test_resid_cuda_route_launches_the_kernels_only(monkeypatch):
    """On the card the residual forward is one call of its C entry point
    (input-projection GEMM + recurrence), with the plan's geometry and a
    pointer for every operand, counted once; it never runs the plain loop
    or a PyTorch matmul.  The library is a stand-in, so the test needs no
    card."""
    calls = []

    class FakeLibrary:
        def sat_lstm_forward_resid(self, *args):
            calls.append(args)
            return 0

    forbidden = lambda *a, **k: pytest.fail("the CUDA route ran PyTorch math")
    monkeypatch.setattr(lstm_cuda._build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(lstm_cuda._build, "library", FakeLibrary)
    monkeypatch.setattr(lstm_cuda, "_stream", lambda: 7)
    monkeypatch.setattr(lstm_cuda, "lstm_forward_plain", forbidden)
    monkeypatch.setattr(torch, "matmul", forbidden)
    monkeypatch.setattr(torch.Tensor, "__matmul__", forbidden)
    t = _torch(_inputs(12, done_rate=0.1))
    hidden = 32
    t.update(c0=torch.zeros(B, hidden), h0=torch.zeros(B, hidden),
             wi=torch.zeros(D, 4 * hidden), wh=torch.zeros(hidden, 4 * hidden),
             b=torch.zeros(4 * hidden))
    before = lstm_cuda.LAUNCHES["lstm_fwd_resid"]
    out = lstm_cuda.lstm_forward(*(t[k] for k in ORDER), residuals=True)
    args, = calls
    argtypes, _ = lstm_cuda._build._SIGNATURES["sat_lstm_forward_resid"]
    assert len(args) == len(argtypes)
    plan = lstm_cuda.resid_plan(B, hidden)
    assert args[15:] == (T, B, D, hidden, plan.rows, plan.resident,
                         plan.smem_bytes, 7)
    outputs = [out.ys, *out.residuals, out.c, out.h]
    assert list(args[:7]) == [t[k].data_ptr() for k in ORDER]
    assert list(args[8:15]) == [o.data_ptr() for o in outputs]
    assert len(set(args[:15])) == 15  # pre is scratch of its own
    assert lstm_cuda.LAUNCHES["lstm_fwd_resid"] == before + 1


@pytest.mark.parametrize("hidden", [32, 256, 320, 512, 1024])
@pytest.mark.parametrize("batch", [1, 31, 32, 33, 64])
def test_bptt_plan_fits_and_covers_the_batch(batch, hidden):
    """BPTT's chain: every batch row in exactly one cluster (none empty),
    the shared memory (two [R, H] x 4-gate dgates buffers, 8 partial
    dh_prev vectors, then 2*H bytes per resident depth position of the
    CTA's [H/8, 4H] Wh slice) within an H100 block's 232,448 bytes, a CTA
    of H threads within the register cap of its R, and the resident depth
    a multiple of 4 that the kernel's float4 loop can split at."""
    plan = lstm_cuda.bptt_plan(batch, hidden)
    assert plan.rows in (1, 2, 4, 8)
    assert (plan.clusters - 1) * plan.rows < batch <= plan.clusters * plan.rows
    assert plan.smem_bytes <= lstm_cuda.SMEM_LIMIT
    assert plan.smem_bytes == (36 * plan.rows + 2 * plan.resident) * hidden
    assert 0 < plan.resident <= hidden and plan.resident % 4 == 0
    assert hidden <= {8: 256, 4: 512}.get(plan.rows, 1024)
    if batch <= lstm_cuda.RESID_CLUSTER * plan.rows:
        assert plan.clusters <= lstm_cuda.RESID_CLUSTER


def test_bptt_plan_keeps_all_of_wh_on_chip_at_the_main_path():
    """B=32, H=256: 8 clusters of 4 rows (64 SMs), each CTA's [32, 1024]
    rows of Wh (128 KiB) whole in shared memory beside 36 KiB of dgates
    buffers and partials; at H=512 only part of the depth stays."""
    assert lstm_cuda.bptt_plan(32, 256) == lstm_cuda.BpttPlan(
        rows=4, clusters=8, resident=256, smem_bytes=167_936)
    assert lstm_cuda.bptt_plan(1, 256) == lstm_cuda.BpttPlan(1, 1, 256,
                                                             140_288)
    assert lstm_cuda.bptt_plan(4, 512).resident == 208


@pytest.mark.parametrize("rows,in_dim,hidden,splits", [
    (101 * 32, 266, 256, 4), (5 * 4, 12, 32, 1), (101, 266, 256, 4),
    (3, 266, 256, 1), (101 * 64, 266, 512, 2)])
def test_wgrad_splits_cut_the_depth_into_whole_tiles(rows, in_dim, hidden,
                                                     splits):
    """The bf16 weight gradient's K slices: ~528 blocks of 64x64 tiles, at
    most one slice a 32-deep tile, at least one; the main path's 144 tiles
    take 4 slices of 26 tiles (the last 23)."""
    assert lstm_cuda.wgrad_splits(rows, in_dim, hidden) == splits


@pytest.mark.parametrize("matmul_dtype,suffix,stash", [
    ("float32", "", torch.float32), ("bfloat16", "_bf16", torch.bfloat16)])
def test_bptt_cuda_route_launches_the_kernels_only(monkeypatch, matmul_dtype,
                                                   suffix, stash):
    """On the card BPTT is one call of its C entry point (chain, products,
    reduction), with the plan's geometry and a pointer for every operand,
    counted once; it never runs the plain loop or a PyTorch matmul.  The
    dgates scratch is at the operand type, and only the bf16 variant cuts
    the weight gradient into slices.  The library is a stand-in, so the
    test needs no card."""
    calls, scratch = [], []

    class FakeLibrary:
        def __getattr__(self, name):
            assert name == "sat_lstm_backward" + suffix
            return lambda *args: calls.append(args) or 0

    real_empty = torch.empty

    def spy_empty(*shape, **kwargs):
        t = real_empty(*shape, **kwargs)
        scratch.append(t)
        return t

    forbidden = lambda *a, **k: pytest.fail("the CUDA route ran PyTorch math")
    monkeypatch.setattr(lstm_cuda._build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(lstm_cuda._build, "library", FakeLibrary)
    monkeypatch.setattr(lstm_cuda, "_stream", lambda: 7)
    monkeypatch.setattr(lstm_cuda, "lstm_backward_plain", forbidden)
    monkeypatch.setattr(torch, "matmul", forbidden)
    monkeypatch.setattr(torch.Tensor, "__matmul__", forbidden)
    t = _torch(_inputs(14, done_rate=0.1))
    hidden = 32
    res = lstm_cuda.Residuals(torch.rand(T, B, 4 * hidden),
                              *(torch.rand(T, B, hidden) for _ in range(3)))
    dys = torch.ones(T, B, hidden)
    dct, dht = torch.ones(B, hidden), torch.ones(B, hidden)
    wi, wh = torch.zeros(D, 4 * hidden), torch.zeros(hidden, 4 * hidden)
    monkeypatch.setattr(torch, "empty", spy_empty)
    counter = "lstm_bptt" + suffix
    before = lstm_cuda.LAUNCHES[counter]
    grads = lstm_cuda.lstm_backward(dys, dct, dht, t["x"], t["done"], wi, wh,
                                    res, matmul_dtype)
    args, = calls
    argtypes, _ = lstm_cuda._build._SIGNATURES["sat_lstm_backward" + suffix]
    assert len(args) == len(argtypes) == 29
    plan = lstm_cuda.bptt_plan(B, hidden)
    splits = lstm_cuda.wgrad_splits(T * B, D, hidden) if suffix else 0
    assert args[20:] == (T, B, D, hidden, plan.rows, plan.resident,
                         plan.smem_bytes, splits, 7)
    inputs = [dys, t["done"], res.ifgo, res.cpost, res.hpost, res.cnew,
              t["x"], wi, wh, dct, dht]
    assert list(args[:11]) == [x.data_ptr() for x in inputs]
    assert list(args[11:17]) == [g.data_ptr() for g in grads]
    dgates, dbpart, wpart = scratch[-3:]
    assert list(args[17:20]) == [dgates.data_ptr(), dbpart.data_ptr(),
                                 wpart.data_ptr()]
    assert dgates.shape == (T, B, 4 * hidden) and dgates.dtype == stash
    assert dbpart.shape == (B, 4 * hidden) and dbpart.dtype == torch.float32
    assert wpart.shape == (splits, D + hidden, 4 * hidden)
    # One buffer for each operand (the float32 variant's slice scratch is
    # empty and never read).
    owned = args[:19] + (args[19:20] if splits else ())
    assert len(set(owned)) == len(owned)
    assert [tuple(g.shape) for g in grads] == [
        (T, B, D), (B, hidden), (B, hidden), (D, 4 * hidden),
        (hidden, 4 * hidden), (4 * hidden,)]
    assert lstm_cuda.LAUNCHES[counter] == before + 1


def _fake_card(monkeypatch, calls, *plain):
    """The CUDA route with a stand-in library whose entry points record
    their arguments: no card needed.  The plain versions ``plain`` and
    PyTorch's matmul fail the test if the route runs them."""

    class FakeLibrary:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    forbidden = lambda *a, **k: pytest.fail("the CUDA route ran PyTorch math")
    monkeypatch.setattr(lstm_cuda._build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(lstm_cuda._build, "library", FakeLibrary)
    monkeypatch.setattr(lstm_cuda, "_stream", lambda: 7)
    for name in plain:
        monkeypatch.setattr(lstm_cuda, name, forbidden)
    monkeypatch.setattr(torch, "matmul", forbidden)
    monkeypatch.setattr(torch.Tensor, "__matmul__", forbidden)


def _zero_case(steps, batch, in_dim=D, hidden=32):
    """Zero forward inputs of these shapes: a wrapper's operands."""
    return dict(x=torch.zeros(steps, batch, in_dim),
                done=torch.zeros(steps, batch),
                c0=torch.zeros(batch, hidden), h0=torch.zeros(batch, hidden),
                wi=torch.zeros(in_dim, 4 * hidden),
                wh=torch.zeros(hidden, 4 * hidden), b=torch.zeros(4 * hidden))


LEAN_PLAIN = ("lean_forward", "lstm_step_plain", "lstm_forward_plain")


@pytest.mark.parametrize("matmul_dtype,suffix", [("float32", ""),
                                                 ("bfloat16", "_bf16")])
@pytest.mark.parametrize("batch", [1, 33])
def test_lean_step_cuda_route_launches_the_step_kernel_only(
        monkeypatch, matmul_dtype, suffix, batch):
    """At T=1 the lean forward is one call of the step kernel of its
    operand type (``sat_lstm_step``: the float32 FFMA kernel;
    ``sat_lstm_step_bf16``: the tensor-core kernel), with a pointer for
    every operand, counted once under ``lstm_fwd_lean[_bf16]``; ys is a
    view of h.  It never runs the plain step or a PyTorch matmul."""
    calls = []
    _fake_card(monkeypatch, calls, *LEAN_PLAIN)
    t = _zero_case(1, batch)
    before = dict(lstm_cuda.LAUNCHES)
    out = lstm_cuda.lstm_forward(*(t[k] for k in ORDER), residuals=False,
                                 matmul_dtype=matmul_dtype)
    (name, args), = calls
    assert name == "sat_lstm_step" + suffix
    argtypes, _ = lstm_cuda._build._SIGNATURES[name]
    assert len(args) == len(argtypes) == 13
    assert list(args[:7]) == [t[k].data_ptr() for k in ORDER]
    assert args[7:] == (out.ys.data_ptr(), out.c.data_ptr(), batch, D, 32, 7)
    assert out.h.data_ptr() == out.ys.data_ptr() and out.residuals is None
    assert out.ys.shape == (1, batch, 32) and out.c.shape == (batch, 32)
    grown = {k: v - before[k] for k, v in lstm_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"lstm_fwd_lean" + suffix: 1}


@pytest.mark.parametrize("matmul_dtype,suffix", [("float32", ""),
                                                 ("bfloat16", "_bf16")])
@pytest.mark.parametrize("steps,batch,hidden", [(2, 4, 32), (T, 33, 64),
                                                (101, 32, 256)])
def test_lean_unroll_cuda_route_launches_the_kernels_only(
        monkeypatch, matmul_dtype, suffix, steps, batch, hidden):
    """At T>1 the lean forward is one call of ``sat_lstm_forward_lean``
    (the input-projection GEMM, then the recurrence with Wh resident and
    no residual stores), with the residual forward's plan and a pointer
    for every operand, counted once under ``lstm_fwd_lean_unroll``: not T
    step launches, and never the plain loop or a PyTorch matmul."""
    calls = []
    _fake_card(monkeypatch, calls, *LEAN_PLAIN)
    t = _zero_case(steps, batch, hidden=hidden)
    before = dict(lstm_cuda.LAUNCHES)
    out = lstm_cuda.lstm_forward(*(t[k] for k in ORDER), residuals=False,
                                 matmul_dtype=matmul_dtype)
    (name, args), = calls
    assert name == "sat_lstm_forward_lean" + suffix
    argtypes, _ = lstm_cuda._build._SIGNATURES[name]
    assert len(args) == len(argtypes) == 19
    plan = lstm_cuda.resid_plan(batch, hidden)
    assert args[11:] == (steps, batch, D, hidden, plan.rows, plan.resident,
                         plan.smem_bytes, 7)
    assert list(args[:7]) == [t[k].data_ptr() for k in ORDER]
    assert list(args[8:11]) == [o.data_ptr() for o in out[:3]]
    assert len(set(args[:11])) == 11  # pre is scratch of its own
    assert out.ys.shape == (steps, batch, hidden) and out.residuals is None
    grown = {k: v - before[k] for k, v in lstm_cuda.LAUNCHES.items()
             if v != before[k]}
    assert grown == {"lstm_fwd_lean_unroll" + suffix: 1}


# csrc/lstm.cu's lstm_step_mma_kernel geometry (kMmaStepUnits, kMmaStepRows,
# kMmaStepWarps, kMmaStepDepth): change these with the kernel.
MMA_UNITS, MMA_ROWS, MMA_WARPS, MMA_DEPTH = 8, 16, 8, 5


def test_step_mma_mirror_has_the_kernels_geometry():
    """The emulator's MMA_* constants are csrc/lstm.cu's kMmaStep*."""
    import re
    from pathlib import Path

    source = (Path(lstm_cuda.__file__).resolve().parents[1] / "csrc"
              / "lstm.cu").read_text()
    found = {name: int(value) for name, value in re.findall(
        r"constexpr int (kMmaStep\w+) = (\d+);", source)}
    assert found == {"kMmaStepUnits": MMA_UNITS, "kMmaStepRows": MMA_ROWS,
                     "kMmaStepWarps": MMA_WARPS,
                     "kMmaStepDepth": MMA_DEPTH}


def _bf16(v):
    return torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulate_step_mma(x, done, c0, h0, wi, wh, b):
    """The bf16 step kernel's arithmetic, index by index: each CTA's and
    warp's k16 steps, each lane's fragment elements as the kernel loads
    them (its rows, depths and weight columns), placed into the mma tiles
    by the PTX layout of m16n8k16 (A: row g + 8 (i & 1), depth 2 t4 + h +
    8 (i >> 1) of register i, half h; B: depth 2 t4 + h + 8 j of register
    j, column g; C: row g + 8 (i >> 1), column 2 t4 + (i & 1)), the
    partials summed in warp order, then the bias and the cell.  numpy
    arrays in, (h', c') out, float32."""
    batch, in_dim = x.shape
    hidden = h0.shape[1]
    depth = in_dim + hidden
    steps = -(-depth // 16)
    units, rows = MMA_UNITS, MMA_ROWS
    cols = 4 * units
    keep_all = 1.0 - done
    lane = np.arange(32)
    g, t4 = lane >> 2, lane & 3
    y = np.zeros((batch, hidden), np.float32)
    c_out = np.zeros_like(y)
    for j0 in range(0, hidden, units):
        for b0 in range(0, batch, rows):
            nb = min(rows, batch - b0)
            part = np.zeros((MMA_WARPS, rows, cols), np.float64)
            for warp in range(MMA_WARPS):
                acc = np.zeros((cols // 8, 32, 4))
                for step in range(warp, steps, MMA_WARPS):
                    kb = 16 * step + 2 * t4

                    def operand(k, hi):
                        r = b0 + np.minimum(g + 8 * hi, nb - 1)
                        v = np.zeros(32, np.float32)
                        for i in range(32):
                            kk = k[i]
                            if kk < in_dim:
                                v[i] = x[r[i], kk]
                            elif kk < depth:
                                v[i] = keep_all[r[i]] * h0[r[i], kk - in_dim]
                        return _bf16(v)

                    # o[hi][q]: depth kb + (q & 1) + 8 (q >> 1).
                    o = [[operand(kb + (q & 1) + 8 * (q >> 1), hi)
                          for q in range(4)] for hi in range(2)]
                    regs_a = [(o[0][0], o[0][1]), (o[1][0], o[1][1]),
                              (o[0][2], o[0][3]), (o[1][2], o[1][3])]
                    tile_a = np.zeros((16, 16))
                    for i, (lo, hi_) in enumerate(regs_a):
                        for h, v in enumerate((lo, hi_)):
                            tile_a[g + 8 * (i & 1),
                                   2 * t4 + h + 8 * (i >> 1)] = v
                    for nt in range(cols // 8):
                        n = 8 * nt + g
                        col = n // units * hidden + j0 + n % units
                        w = np.concatenate([wi, wh])
                        bv = []
                        for q in range(4):
                            k = kb + (q & 1) + 8 * (q >> 1)
                            bv.append(_bf16(np.where(
                                k < depth, w[np.minimum(k, depth - 1), col],
                                0.0)))
                        tile_b = np.zeros((16, 8))
                        for j, pair in enumerate(((bv[0], bv[1]),
                                                  (bv[2], bv[3]))):
                            for h, v in enumerate(pair):
                                tile_b[2 * t4 + h + 8 * j, g] = v
                        prod = tile_a @ tile_b
                        for i in range(4):
                            acc[nt, :, i] += prod[g + 8 * (i >> 1),
                                                  2 * t4 + (i & 1)]
                for nt in range(cols // 8):
                    for i in range(4):
                        part[warp, g + 8 * (i >> 1),
                             8 * nt + 2 * t4 + (i & 1)] = acc[nt, :, i]
            for row in range(nb):
                for u in range(units):
                    gates = [part[:, row, gate * units + u].astype(
                        np.float32).sum(dtype=np.float32)
                        + b[gate * hidden + j0 + u] for gate in range(4)]
                    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
                    keep = keep_all[b0 + row]
                    cn = (sig(gates[1]) * keep * c0[b0 + row, j0 + u]
                          + sig(gates[0]) * np.tanh(gates[2]))
                    y[b0 + row, j0 + u] = sig(gates[3]) * np.tanh(cn)
                    c_out[b0 + row, j0 + u] = cn
    return y, c_out


@pytest.mark.parametrize("batch,in_dim", [(1, 12), (8, 13), (33, 12),
                                          (3, 621)])
def test_step_mma_fragments_match_the_plain_step(batch, in_dim):
    """The bf16 step kernel's fragment index math, emulated lane by lane
    (``_emulate_step_mma``), gives the plain bf16 step: a row, depth or
    weight column the kernel loads into the wrong register shows here.
    Ragged batches (a CTA's rows past the batch read its last row), odd
    D, and a depth past one round of loads (D+H = 653: 41 k16 steps, so
    warp 0 takes 6, past MMA_DEPTH = 5)."""
    rng = np.random.default_rng(batch + in_dim)
    hidden = 32
    f32 = lambda *shape, scale=1.0: (
        rng.standard_normal(shape) * scale).astype(np.float32)
    x, c0 = f32(batch, in_dim), f32(batch, hidden, scale=0.5)
    h0 = np.tanh(f32(batch, hidden))
    wi = f32(in_dim, 4 * hidden, scale=in_dim ** -0.5)
    wh = f32(hidden, 4 * hidden, scale=hidden ** -0.5)
    b = f32(4 * hidden, scale=0.1)
    done = (rng.random(batch) < 0.3).astype(np.float32)
    y, c = _emulate_step_mma(x, done, c0, h0, wi, wh, b)
    t = lambda v: torch.from_numpy(v)
    h_want, c_want = lstm_cuda.lstm_step_plain(
        t(x), t(done), t(c0), t(h0), t(wi), t(wh), t(b), "bfloat16")
    np.testing.assert_allclose(y, h_want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c, c_want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 5])
def test_lean_forward_runs_one_step_per_time_step(steps):
    """The plain lean route on the CPU: T calls of the step, the carry
    threaded through, against the Pallas lean kernel.  At T=1 ys is a view
    of the new h, with no copy."""
    arrays = _inputs(11)
    arrays["x"], arrays["done"] = (arrays["x"][:steps],
                                   arrays["done"][:steps])
    t = _torch(arrays)
    calls = []

    def step(x_t, done_t, c, h):
        calls.append(x_t.shape)
        return lstm_cuda.lstm_step_plain(x_t, done_t, c, h, t["wi"],
                                         t["wh"], t["b"])

    out = lstm_cuda.lean_forward(step, t["x"], t["done"], t["c0"], t["h0"])
    assert calls == [(B, D)] * steps and out.residuals is None
    ys_j, (c_j, h_j) = _jax_unroll(arrays)
    np.testing.assert_allclose(out.ys.numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(out.c.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(out.h.numpy(), np.asarray(h_j), **TOL)
    if steps == 1:
        assert out.ys[0].data_ptr() == out.h.data_ptr()
    plain = lstm_cuda.lstm_forward_plain(*(t[k] for k in ORDER),
                                         residuals=False)
    for got, want in zip(out[:3], plain[:3]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
