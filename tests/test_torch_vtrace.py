"""The port's V-trace dispatch (ops/vtrace.py) and fused kernel wrapper
(ops/vtrace_cuda.py) against the JAX package's V-trace.

Every port ``scan_impl`` (``pallas``: the kernel's plain version, which is
what the wrapper runs for CPU tensors; ``associative``: the log-depth scan
over ``compose_affine``; ``sequential``: the reverse loop) is held against
JAX ``from_importance_weights(scan_impl="pallas")``, which runs
``vtrace_pallas.vtrace_fused`` in interpret mode on the CPU, and
``associative`` and ``sequential`` also against the JAX function of the
same name.  Cases: T=1, T=100 and T=101, B on and past the kernel's
128-lane tile, a rank-3 [T, B, C] input, clip thresholds of ``None``, and
a NaN log-rho that must stay NaN.

The kernel's schedule (``vtrace_fused_plain``: T cut into chunks, each
folded into an affine map, the maps combined into carry-ins, each chunk
replayed) is held against JAX ``vtrace_fused(interpret=True)`` at T from 1
to 101 (fewer steps than chunks included), N of 1, 33 and 257, chunk
counts 1, 2, 8 and the kernel's 16, NaN log-rhos on a chunk boundary and
inside a chunk, a +inf rho, a column done at every step and clips of
``None``; with one chunk it is the sequential walk bit for bit.

Tolerances: float32 on both sides with sums in another order, rtol 1e-5
(atol 1e-5 for entries near 0); the diagnostics are reductions over at
most a few thousand cells, rtol 1e-5 / atol 1e-6.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.ops import vtrace as vtrace_j
from scalable_agent_tpu.ops import vtrace_pallas
from scalable_agent_tpu_torch.ops import vtrace, vtrace_cuda

CASES = {
    "t1": dict(shape=(1, 5)),
    "t100": dict(shape=(100, 32)),
    "t101": dict(shape=(101, 7)),
    "b128": dict(shape=(6, 128)),
    "b257": dict(shape=(4, 257)),
    "rank3": dict(shape=(5, 3, 2)),
    "clip_none": dict(shape=(7, 4), clips=(None, None)),
    "nan_log_rho": dict(shape=(6, 3), nan_at=(2, 1)),
}


def _inputs(name):
    case = CASES[name]
    shape = case["shape"]
    rng = np.random.default_rng(sum(shape) + len(name))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = dict(
        log_rhos=(rng.random(shape) * 6.0 - 3.0).astype(np.float32),
        discounts=(0.99 * (rng.random(shape) > 0.05)).astype(np.float32),
        rewards=f32(*shape),
        values=f32(*shape),
        bootstrap_value=f32(*shape[1:]))
    if "nan_at" in case:
        arrays["log_rhos"][case["nan_at"]] = np.nan
    clips = case.get("clips", (1.0, 1.0))
    return arrays, dict(clip_rho_threshold=clips[0],
                        clip_pg_rho_threshold=clips[1])


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    arrays, clips = _inputs(name)
    out = vtrace_j.from_importance_weights(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **clips,
        scan_impl="pallas")
    return np.asarray(out.vs), np.asarray(out.pg_advantages), {
        k: float(v) for k, v in out.diagnostics._asdict().items()}


@pytest.mark.parametrize("scan_impl", ["pallas", "associative",
                                       "sequential"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_from_importance_weights_matches_the_jax_kernel(case, scan_impl):
    arrays, clips = _inputs(case)
    want_vs, want_pg, _ = _jax_result(case)
    got = vtrace.from_importance_weights(
        **{k: torch.tensor(v) for k, v in arrays.items()}, **clips,
        scan_impl=scan_impl)
    np.testing.assert_allclose(got.vs.numpy(), want_vs, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(), want_pg,
                               rtol=1e-5, atol=1e-5)
    if "nan_at" in CASES[case]:
        # The NaN reaches vs at its own step and every earlier one.
        t, b = CASES[case]["nan_at"]
        assert np.isnan(got.vs.numpy()[:t + 1, b]).all()
        assert np.isfinite(np.delete(got.vs.numpy(), b, axis=1)).all()


@pytest.mark.parametrize("scan_impl", ["associative", "sequential"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_scan_impl_matches_the_jax_function_of_its_name(case,
                                                             scan_impl):
    """``associative`` against JAX's associative scan, ``sequential``
    against its reverse ``lax.scan``."""
    arrays, clips = _inputs(case)
    want = vtrace_j.from_importance_weights(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **clips,
        scan_impl=scan_impl)
    got = vtrace.from_importance_weights(
        **{k: torch.tensor(v) for k, v in arrays.items()}, **clips,
        scan_impl=scan_impl)
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(want.vs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               np.asarray(want.pg_advantages),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5, 7, 8, 9, 16, 100, 101])
def test_associative_scan_solves_the_recurrence_at_any_T(steps):
    """The doubling levels must cover every step for any T, powers of two
    or not: held against the recurrence in float64."""
    rng = np.random.default_rng(steps)
    a = rng.random((steps, 6)).astype(np.float32)
    b = rng.standard_normal((steps, 6)).astype(np.float32)
    want = np.zeros((steps, 6))
    acc = np.zeros(6)
    for t in reversed(range(steps)):
        acc = b[t].astype(np.float64) + a[t] * acc
        want[t] = acc
    got = vtrace._linear_recurrence_reverse(
        torch.tensor(a), torch.tensor(b), "associative")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- The kernel's schedule (vtrace_fused_plain) against the JAX kernel.

def _kernel_inputs(steps, cols, seed=0):
    rng = np.random.default_rng(1000 * steps + cols + seed)
    shape = (steps, cols)
    return [(rng.random(shape) * 6.0 - 3.0).astype(np.float32),
            (0.99 * (rng.random(shape) > 0.05)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(cols).astype(np.float32)]


def _jax_kernel(arrays, clips=(1.0, 1.0)):
    vs, pg = vtrace_pallas.vtrace_fused(
        *(jnp.asarray(a) for a in arrays), clip_rho_threshold=clips[0],
        clip_pg_rho_threshold=clips[1], interpret=True)
    return np.asarray(vs), np.asarray(pg)


@functools.lru_cache(maxsize=None)
def _jax_kernel_result(steps, cols):
    return _jax_kernel(_kernel_inputs(steps, cols))


def _schedule(arrays, clips=(1.0, 1.0), **kw):
    vs, pg = vtrace_cuda.vtrace_fused_plain(
        *(torch.tensor(a) for a in arrays), *clips, **kw)
    return vs.numpy(), pg.numpy()


def _assert_close(got, want, scaled=False):
    """rtol 1e-5, atol 1e-5; with ``scaled``, atol 1e-5 of the output's
    largest magnitude (floored at 1), as chip_smoke.py holds the kernel."""
    for g, w in zip(got, want):
        scale = max(1.0, float(np.nanmax(np.abs(w)))) if scaled else 1.0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("chunks", [1, 2, 8, vtrace_cuda.KERNEL_CHUNKS])
@pytest.mark.parametrize("cols", [1, 33, 257])
@pytest.mark.parametrize("steps", [1, 2, 3, 7, 8, 9, 100, 101])
def test_kernel_schedule_matches_the_jax_kernel(steps, cols, chunks):
    _assert_close(_schedule(_kernel_inputs(steps, cols), chunks=chunks),
                  _jax_kernel_result(steps, cols))


def _chunk_starts(steps, chunks):
    base, extra = divmod(steps, chunks)
    return [w * base + min(w, extra) for w in range(chunks)]


@pytest.mark.parametrize("where", ["boundary", "inside"])
def test_kernel_schedule_keeps_a_nan_log_rho_in_its_column(where):
    """A NaN log-rho on a chunk's first step or inside a chunk is NaN in vs
    and the advantages at its step and every earlier one of its column,
    and nowhere else."""
    steps, cols, col = 100, 33, 5
    start = _chunk_starts(steps, vtrace_cuda.KERNEL_CHUNKS)[6]
    t = start if where == "boundary" else start + 2
    arrays = _kernel_inputs(steps, cols)
    arrays[0][t, col] = np.nan
    got = _schedule(arrays)
    _assert_close(got, _jax_kernel(arrays))
    want = np.zeros((steps, cols), bool)
    want[:t + 1, col] = True
    for out in got:
        np.testing.assert_array_equal(np.isnan(out), want)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (None, None)],
                         ids=["clipped", "clips_none"])
def test_kernel_schedule_takes_an_inf_rho_as_the_jax_kernel(clips):
    arrays = _kernel_inputs(101, 33, seed=1)
    arrays[0][40, 3] = np.inf
    arrays[0][7, 20] = np.inf
    _assert_close(_schedule(arrays, clips), _jax_kernel(arrays, clips))


def test_kernel_schedule_with_a_column_done_at_every_step():
    arrays = _kernel_inputs(100, 33, seed=2)
    arrays[1][:, 4] = 0.0
    got = _schedule(arrays)
    _assert_close(got, _jax_kernel(arrays))
    # Nothing carries over a done step: vs = v + rho-bar (r - v) there.
    rho_bar = np.minimum(np.exp(arrays[0][:, 4]), 1.0)
    np.testing.assert_allclose(
        got[0][:, 4],
        arrays[3][:, 4] + rho_bar * (arrays[2][:, 4] - arrays[3][:, 4]),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunks", [1, 2, vtrace_cuda.KERNEL_CHUNKS])
def test_kernel_schedule_with_clips_of_none(chunks):
    """Unclipped rhos (up to e^3) grow pg to ~1e3 over 101 steps, where
    r + gamma vs_{t+1} - v cancels: one float32 ulp of vs_{t+1} is ~1e-5
    there, and the sequential walk (chunks=1) and JAX's own associative
    scan each miss an elementwise rtol of 1e-5 on single entries of such
    inputs.  So the entries are held at 1e-5 of the output's scale."""
    arrays = _kernel_inputs(101, 33, seed=3)
    _assert_close(_schedule(arrays, (None, None), chunks=chunks),
                  _jax_kernel(arrays, (None, None)), scaled=True)


def _sequential_walk(log_rhos, discounts, rewards, values, bootstrap_value,
                     clip_rho_threshold=1.0, clip_pg_rho_threshold=1.0):
    """The kernel's arithmetic as one reverse pass over all of T."""
    clip = lambda rho, thr: rho if thr is None else torch.clamp(rho, max=thr)
    rhos = torch.exp(log_rhos)
    rho_bar = clip(rhos, clip_rho_threshold)
    cs = clip(rhos, 1.0)
    pg_rhos = clip(rhos, clip_pg_rho_threshold)
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


@pytest.mark.parametrize("steps,clips", [(1, (1.0, 1.0)), (100, (1.0, 1.0)),
                                         (101, (None, None))])
def test_one_chunk_is_the_sequential_walk_bit_for_bit(steps, clips):
    arrays = [torch.tensor(a) for a in _kernel_inputs(steps, 33, seed=4)]
    arrays[0][steps // 2, 7] = float("nan")
    got = vtrace_cuda.vtrace_fused_plain(*arrays, *clips, chunks=1)
    want = _sequential_walk(*arrays, *clips)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                      w.view(torch.int32).numpy())


@pytest.mark.parametrize("case", ["t1", "b257", "rank3", "clip_none"])
def test_diagnostics_match_jax_key_by_key(case):
    arrays, clips = _inputs(case)
    _, _, want = _jax_result(case)
    got = vtrace.from_importance_weights(
        **{k: torch.tensor(v) for k, v in arrays.items()}, **clips,
        scan_impl="pallas").diagnostics
    assert set(got._fields) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(float(getattr(got, key)), value,
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_diagnostics_are_computed_only_when_read(monkeypatch):
    """The learner never reads ``diagnostics``: V-trace must not compute
    them on its path, only when a caller reads the field."""
    calls = []
    real = vtrace.importance_diagnostics
    monkeypatch.setattr(vtrace, "importance_diagnostics",
                        lambda *a: calls.append(1) or real(*a))
    arrays, clips = _inputs("b128")
    logits = torch.randn((6, 128, 4), generator=torch.Generator()
                         .manual_seed(0))
    actions = torch.zeros((6, 128), dtype=torch.int64)
    out = vtrace.from_logits(
        logits, logits + 0.1, actions,
        *(torch.tensor(arrays[k]) for k in ("discounts", "rewards",
                                            "values", "bootstrap_value")),
        **clips, scan_impl="pallas")
    assert calls == []
    assert set(out.diagnostics._fields) == set(_jax_result("b128")[2])
    assert calls == [1]


def test_diagnostics_survive_an_extreme_log_rho():
    """exp(2 * 50) overflows float32: the ESS must max-shift first, as the
    JAX package does."""
    rng = np.random.default_rng(50)
    log_rhos = (rng.standard_normal((8, 6)) * 0.5).astype(np.float32)
    log_rhos[3, 2] = 50.0
    log_rhos[5, 4] = 48.5
    want = vtrace_j.importance_diagnostics(jnp.asarray(log_rhos))
    got = vtrace.importance_diagnostics(torch.tensor(log_rhos))
    for key, value in want._asdict().items():
        assert np.isfinite(float(getattr(got, key))), key
        np.testing.assert_allclose(float(getattr(got, key)), float(value),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_an_inf_rho_clips_as_in_jax():
    """An inf rho is clipped to the thresholds like jnp.minimum does."""
    arrays, clips = _inputs("clip_none")
    arrays["log_rhos"][1, 2] = np.inf
    want = vtrace_j.from_importance_weights(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        scan_impl="pallas")
    got = vtrace.from_importance_weights(
        **{k: torch.tensor(v) for k, v in arrays.items()},
        scan_impl="pallas")
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(want.vs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               np.asarray(want.pg_advantages),
                               rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_wrappers_cpu_path():
    arrays, _ = _inputs("b128")
    args = [torch.tensor(v) for v in arrays.values()]
    before = vtrace_cuda.LAUNCHES["vtrace_fused"]
    for got, want in zip(vtrace_cuda.vtrace_fused(*args),
                         vtrace_cuda.vtrace_fused_plain(*args)):
        assert torch.equal(got, want)
    assert vtrace_cuda.LAUNCHES["vtrace_fused"] == before


def test_wrapper_refuses_other_devices():
    t = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        vtrace_cuda.vtrace_fused(t, t, t, t, torch.zeros(3, device="meta"))


@pytest.mark.parametrize("scan_impl", ["time_sharded", "bogus"])
def test_other_scan_impls_raise(scan_impl):
    arrays, _ = _inputs("t1")
    with pytest.raises(ValueError, match="ROADMAP|unknown"):
        vtrace.from_importance_weights(
            **{k: torch.tensor(v) for k, v in arrays.items()},
            scan_impl=scan_impl)


def test_schedule_tool_edits_still_apply_to_the_kernel():
    """tools/vtrace_schedule.py builds its variants by editing the
    kernel's source; each edit must still find its text."""
    from scalable_agent_tpu_torch.tools import vtrace_schedule

    texts = vtrace_schedule.variant_sources()
    assert list(texts) == list(vtrace_schedule.VARIANTS)
    assert len(set(texts.values())) == len(texts)
    assert texts[next(iter(texts))] == (
        vtrace_schedule._build.SOURCE_DIR / "vtrace.cu").read_text()
