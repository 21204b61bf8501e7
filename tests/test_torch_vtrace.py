"""The port's V-trace dispatch (ops/vtrace.py) and fused kernel wrapper
(ops/vtrace_cuda.py) against the JAX package's fused Pallas kernel.

Every port ``scan_impl`` (``pallas``: the kernel's plain version, which is
what the wrapper runs for CPU tensors; ``associative``/``sequential``: the
plain reverse loop) is held against JAX
``from_importance_weights(scan_impl="pallas")``, which runs
``vtrace_pallas.vtrace_fused`` in interpret mode on the CPU.  Cases: T=1,
B on and past the kernel's 128-lane tile, a rank-3 [T, B, C] input,
clip thresholds of ``None``, and a NaN log-rho that must stay NaN.

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
from scalable_agent_tpu_torch.ops import vtrace, vtrace_cuda

CASES = {
    "t1": dict(shape=(1, 5)),
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
