"""The port's IMPACT surrogate (scalable_agent_tpu_torch/ops/impact.py), its
learner (``Learner(loss="impact")``: the target network, its schedule and
replayed updates), the target's checkpoints, and V-trace against its
O(T^2) oracle, held against the live JAX package.

- The surrogate against JAX ``surrogate_from_logits`` on the same numpy
  inputs, a Discrete and a composite (tuple) policy, every output and the
  loss's gradient in the online logits at 1e-6 (float32 sums in another
  order), the JAX side computed once per module.
- Twins of JAX ``tests/test_replay.py``'s ``TestImpactSurrogate`` and
  ``TestImpactLearner`` on the port's learner.
- The target network in checkpoints: an impact run's steps carry it and
  verify against their manifest; an impact run restoring a vtrace step
  starts its target from the restored parameters; a vtrace run carries a
  restored target through unused and saves it again; ``convert``'s target
  maps round-trip bitwise.
- The twin of JAX ``tests/test_vtrace.py``'s ``ground_truth_vtrace``
  check: the port's ``vtrace.from_logits`` under every ``scan_impl``
  (``pallas`` is the kernel's plain version on the CPU) against the
  literal O(T^2) expansion, with target logits that differ from the
  behaviour logits (the IMPACT case: the target network's logits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.ops import distributions as jax_distributions
from scalable_agent_tpu.ops import impact as jax_impact
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import distributions, impact, vtrace
from scalable_agent_tpu_torch.runtime import (
    CheckpointManager,
    Learner,
    LearnerHyperparams,
)
from scalable_agent_tpu_torch.runtime.learner import learning_telemetry_spec

import test_torch_transport as transport_case

T, B, A, H = 4, 3, 4, 16
FPU = T * B
SURROGATE_TOL = 1e-6
# (name, dist sizes): a Discrete policy and a tuple of two.
SPACES = {"discrete": (A,), "composite": (3, 5)}


# ---------------------------------------------------------------------------
# The surrogate against JAX
# ---------------------------------------------------------------------------


def _surrogate_inputs(sizes, seed):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    target = rng.standard_normal((T, B, n)).astype(np.float32)
    online = target + 0.4 * rng.standard_normal((T, B, n)).astype(np.float32)
    actions = np.stack([rng.integers(0, s, (T, B)) for s in sizes], -1)
    if len(sizes) == 1:
        actions = actions[..., 0]
    adv = rng.standard_normal((T, B)).astype(np.float32)
    return online, target, actions.astype(np.int32), adv


def _jax_surrogate(sizes, online, target, actions, adv, eps):
    spec = jax_distributions.DistributionSpec(sizes=tuple(sizes))

    def loss(logits):
        return jax_impact.surrogate_from_logits(
            logits, target, actions, adv, clip_epsilon=eps,
            dist_spec=spec).loss

    out = jax_impact.surrogate_from_logits(online, target, actions, adv,
                                           clip_epsilon=eps, dist_spec=spec)
    fields = {k: float(v) for k, v in out._asdict().items()}
    return fields, np.asarray(jax.grad(loss)(jnp.asarray(online)))


@pytest.fixture(scope="module")
def jax_surrogates():
    """The JAX surrogate and its gradient, once per space and clip."""
    out = {}
    for name, sizes in SPACES.items():
        for eps in (0.1, 0.3):
            inputs = _surrogate_inputs(sizes, seed=len(sizes))
            out[name, eps] = (inputs, _jax_surrogate(sizes, *inputs, eps))
    return out


@pytest.mark.parametrize("eps", [0.1, 0.3])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_surrogate_matches_jax(jax_surrogates, space, eps):
    (online, target, actions, adv), (want, want_grad) = jax_surrogates[
        space, eps]
    spec = distributions.DistributionSpec(sizes=SPACES[space])
    logits = torch.tensor(online, requires_grad=True)
    got = impact.surrogate_from_logits(
        logits, torch.tensor(target), torch.tensor(actions).long(),
        torch.tensor(adv), clip_epsilon=eps, dist_spec=spec)
    for key, value in want.items():
        np.testing.assert_allclose(float(getattr(got, key).detach()), value,
                                   rtol=SURROGATE_TOL, atol=SURROGATE_TOL,
                                   err_msg=key)
    assert 0.0 < want["clip_fraction"] < 1.0  # the clip is exercised
    (grad,) = torch.autograd.grad(got.loss, logits)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=SURROGATE_TOL,
                               atol=SURROGATE_TOL)


class TestImpactSurrogate:
    """Twins of JAX ``tests/test_replay.py::TestImpactSurrogate``."""

    def test_unit_ratio_reduces_to_advantage_sum(self):
        rng = np.random.default_rng(0)
        logits = torch.tensor(rng.standard_normal((3, 2, A)),
                              dtype=torch.float32)
        actions = torch.tensor(rng.integers(0, A, (3, 2)))
        adv = torch.tensor(rng.standard_normal((3, 2)), dtype=torch.float32)
        out = impact.surrogate_from_logits(logits, logits, actions, adv)
        assert float(out.ratio_mean) == pytest.approx(1.0, abs=1e-6)
        assert float(out.clip_fraction) == 0.0
        assert float(out.loss) == pytest.approx(-float(adv.sum()), rel=1e-5)

    def test_clip_activates_on_drifted_online_net(self):
        rng = np.random.default_rng(1)
        target = rng.standard_normal((3, 2, A)).astype(np.float32)
        online = target + 5.0 * rng.standard_normal(
            (3, 2, A)).astype(np.float32)
        actions = torch.tensor(rng.integers(0, A, (3, 2)))
        out = impact.surrogate_from_logits(
            torch.tensor(online), torch.tensor(target), actions,
            torch.ones(3, 2), clip_epsilon=0.1)
        assert float(out.clip_fraction) > 0.0
        assert float(out.loss) >= -(3 * 2) * 1.1 - 1e-4

    def test_clip_epsilon_validated(self):
        with pytest.raises(ValueError, match="clip_epsilon"):
            impact.surrogate_from_logits(
                torch.zeros(1, 1, A), torch.zeros(1, 1, A),
                torch.zeros(1, 1, dtype=torch.long), torch.zeros(1, 1),
                clip_epsilon=0.0)


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------


def _learner(**kwargs) -> Learner:
    torch.manual_seed(0)
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    return Learner(agent, LearnerHyperparams(total_environment_frames=1e6),
                   FPU, **kwargs)


def _traj(seed):
    host = transport_case.example(t=T, b=B, num_actions=A, core=H,
                                  seed=seed)
    return transport_case.make_transport("per_leaf", "cpu").put(host)[0]


def _params(learner):
    return {k: v.detach().clone() for k, v in learner._params.items()}


def _copy(tensors):
    return {k: v.clone() for k, v in tensors.items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class TestImpactLearner:
    """Twins of JAX ``tests/test_replay.py::TestImpactLearner``."""

    def test_impact_update_trains_and_reports_diagnostics(self):
        learner = _learner(loss="impact")
        assert learner.loss_name == "impact"
        target = learner.state.target_params
        assert target is not None and _equal(target, _params(learner))
        assert all(t.data_ptr() != p.data_ptr() and not t.requires_grad
                   for t, p in zip(target.values(),
                                   learner._params.values()))
        m = learner.update(_traj(0))
        assert np.isfinite(float(m["total_loss"]))
        # The first update's target is the initial online net: ratio 1.
        assert float(m["impact_ratio_mean"]) == pytest.approx(1.0, abs=1e-5)
        assert float(m["impact_clip_fraction"]) == 0.0
        for key in ("impact_log_ratio_p95", "impact_ess_frac",
                    "impact_log_ratio_mean"):
            assert np.isfinite(float(m[key])), key

    def test_target_network_hard_copies_on_schedule(self):
        learner = _learner(loss="impact", target_update_interval=2)
        init_target = _copy(learner.state.target_params)
        learner.update(_traj(0))
        assert _equal(learner.state.target_params, init_target)
        assert not _equal(_params(learner), init_target)
        learner.update(_traj(1))
        # The schedule fires: the target is the just-updated parameters.
        assert _equal(learner.state.target_params, _params(learner))

    def test_replayed_update_holds_frames_and_schedule(self):
        learner = _learner(loss="impact", target_update_interval=2)
        learner.update(_traj(0))
        frames = learner.state.env_frames
        target = _copy(learner.state.target_params)
        params = _params(learner)
        m = learner.update(_traj(1), fresh=False)
        assert learner.state.env_frames == frames
        assert float(m["env_frames"]) == frames
        # The learning rate's frame count is held too.
        assert float(m["learning_rate"]) == pytest.approx(
            learner._hp.learning_rate * (1 - frames / 1e6))
        assert _equal(learner.state.target_params, target)
        assert not _equal(_params(learner), params), "replay did not train"

    def test_invalid_loss_and_interval_raise(self):
        with pytest.raises(ValueError, match="loss"):
            _learner(loss="ppo")
        with pytest.raises(ValueError, match="target_update_interval"):
            _learner(loss="impact", target_update_interval=0)

    def test_skipped_update_copies_the_kept_params(self):
        """A non-finite update at the schedule copies the parameters the
        guard kept into the target, never a poisoned step."""
        learner = _learner(loss="impact", target_update_interval=1)
        learner.update(_traj(0))
        kept = _params(learner)
        bad = _traj(1)
        bad = bad._replace(env_outputs=bad.env_outputs._replace(
            reward=bad.env_outputs.reward * float("nan")))
        m = learner.update(bad)
        assert float(m["update_skipped"]) == 1.0
        assert _equal(_params(learner), kept)
        assert _equal(learner.state.target_params, kept)

    def test_target_unroll_takes_the_lean_route(self, monkeypatch):
        """The target network's unroll runs without gradients, so the core
        takes the lean forward (no residuals) and the agent's own
        parameters are back in place after it."""
        from scalable_agent_tpu_torch.ops import lstm_cuda

        calls = []
        real = lstm_cuda.lstm_forward

        def spy(*args, residuals, **kwargs):
            calls.append((residuals, torch.is_grad_enabled()))
            return real(*args, residuals=residuals, **kwargs)

        monkeypatch.setattr(lstm_cuda, "lstm_forward", spy)
        learner = _learner(loss="impact")
        before = {k: v for k, v in learner._agent.named_parameters()}
        learner.update(_traj(0))
        # The online unroll's residual forward (inside its autograd
        # function), then the target's lean forward.
        assert calls == [(True, False), (False, False)]
        assert {k: v for k, v in learner._agent.named_parameters()} == before

    def test_telemetry_spec_is_the_jax_one(self):
        from scalable_agent_tpu.runtime import learner as jax_learner

        for loss in ("vtrace", "impact"):
            ours = learning_telemetry_spec(loss)
            theirs = jax_learner.learning_telemetry_spec(loss)
            assert ours.gauges() == theirs.gauges()
            assert ours.histograms() == theirs.histograms()
        learner = _learner(loss="impact")
        learner.update(_traj(0))
        learner.update(_traj(1), fresh=False)
        fetched = learner.fetch_device_telemetry()
        spec = learner._learn_spec
        assert float(spec.value(fetched, "impact_ratio")["count"]) == 2.0
        assert np.isfinite(float(spec.value(fetched, "impact_ess_frac")))


# ---------------------------------------------------------------------------
# Checkpoints and conversion
# ---------------------------------------------------------------------------


def _trained(loss, updates, tmp_path, name):
    learner = _learner(loss=loss, target_update_interval=5)
    for i in range(updates):
        learner.update(_traj(i))
    ckpt = CheckpointManager(str(tmp_path / name))
    assert ckpt.maybe_save(updates, learner.state_dict(), force=True)
    return learner, ckpt


def test_impact_checkpoint_round_trips_the_target(tmp_path):
    learner, ckpt = _trained("impact", 2, tmp_path, "impact")
    step, saved = ckpt.restore()
    assert step == 2 and ckpt.verify(step, saved)[0]
    assert set(saved) >= {"params", "opt_state", "target_params"}
    # Two updates before the interval's copy: the target is the initial
    # net, not the parameters.
    assert not _equal(saved["target_params"], saved["params"])
    fresh = _learner(loss="impact", target_update_interval=5)
    fresh.load_state_dict(saved)
    assert _equal(fresh.state.target_params, learner.state.target_params)
    assert _equal(_params(fresh), _params(learner))


def test_impact_run_restoring_a_vtrace_step_starts_its_target(tmp_path):
    learner, ckpt = _trained("vtrace", 2, tmp_path, "vtrace")
    step, saved = ckpt.restore()
    assert "target_params" not in saved and ckpt.verify(step, saved)[0]
    resumed = _learner(loss="impact")
    resumed.load_state_dict(saved)
    assert _equal(resumed.state.target_params, _params(learner))
    assert all(t.data_ptr() != p.data_ptr() for t, p in zip(
        resumed.state.target_params.values(), resumed._params.values()))
    m = resumed.update(_traj(5))
    assert float(m["impact_ratio_mean"]) == pytest.approx(1.0, abs=1e-5)


def test_vtrace_run_carries_a_restored_target_through(tmp_path):
    learner, ckpt = _trained("impact", 2, tmp_path, "impact")
    step, saved = ckpt.restore()
    resumed = _learner(loss="vtrace")
    resumed.load_state_dict(saved)
    target = _copy(resumed.state.target_params)
    assert _equal(target, learner.state.target_params)
    resumed.update(_traj(7))
    assert _equal(resumed.state.target_params, target)
    assert ckpt.maybe_save(3, resumed.state_dict(), force=True)
    step, again = ckpt.restore()
    assert step == 3 and ckpt.verify(step, again)[0]
    assert _equal(again["target_params"], target)


def test_convert_maps_the_target_both_ways():
    learner = _learner(loss="impact")
    tree = convert.state_dict_to_flax(learner.state.target_params)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        convert.state_dict_to_flax(learner._params))
    back = convert.flax_to_state_dict(tree)
    assert _equal(back, learner.state.target_params)


# ---------------------------------------------------------------------------
# V-trace against the O(T^2) oracle
# ---------------------------------------------------------------------------


def ground_truth_vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
                        clip_rho_threshold, clip_pg_rho_threshold):
    """The literal O(T^2) V-trace expansion in numpy (a copy of JAX
    ``tests/test_vtrace.py:27``)."""
    vs = []
    seq_len = len(discounts)
    rhos = np.exp(log_rhos)
    cs = np.minimum(rhos, 1.0)
    clipped_rhos = rhos
    if clip_rho_threshold:
        clipped_rhos = np.minimum(rhos, clip_rho_threshold)
    clipped_pg_rhos = rhos
    if clip_pg_rho_threshold:
        clipped_pg_rhos = np.minimum(rhos, clip_pg_rho_threshold)
    values_t_plus_1 = np.concatenate(
        [values, bootstrap_value[None, :]], axis=0)
    for s in range(seq_len):
        v_s = np.copy(values[s])
        for t in range(s, seq_len):
            v_s += (
                np.prod(discounts[s:t], axis=0)
                * np.prod(cs[s:t], axis=0)
                * clipped_rhos[t]
                * (rewards[t] + discounts[t] * values_t_plus_1[t + 1]
                   - values[t]))
        vs.append(v_s)
    vs = np.stack(vs, axis=0)
    vs_t_plus_1 = np.concatenate([vs[1:], bootstrap_value[None, :]], axis=0)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return vs, pg_advantages


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("clips", [(3.7, 2.2), (1.0, 1.0), (None, None)],
                         ids=["clipped", "reference", "unclipped"])
@pytest.mark.parametrize("batch_size", [1, 5])
@pytest.mark.parametrize("scan_impl", vtrace.SCAN_IMPLS)
def test_from_logits_matches_the_ground_truth(scan_impl, batch_size, clips):
    seq_len, num_actions = 6, 4
    rng = np.random.RandomState(seq_len * 100 + batch_size)
    behaviour = rng.standard_normal(
        (seq_len, batch_size, num_actions)).astype(np.float32)
    # The target policy: another net's logits (IMPACT's target network).
    target = (behaviour + rng.standard_normal(behaviour.shape)
              .astype(np.float32))
    actions = rng.randint(0, num_actions, (seq_len, batch_size))
    discounts = (rng.uniform(0.0, 1.0, (seq_len, batch_size))
                 * 0.9).astype(np.float32)
    rewards = (np.arange(seq_len * batch_size, dtype=np.float32)
               .reshape(seq_len, batch_size) / 10.0)
    values = (np.arange(seq_len * batch_size, dtype=np.float32)
              .reshape(seq_len, batch_size) / 100.0)
    bootstrap = np.arange(batch_size, dtype=np.float32) + 1.0
    pick = lambda lp: np.take_along_axis(lp, actions[..., None], -1)[..., 0]
    log_rhos = pick(_log_softmax(target)) - pick(_log_softmax(behaviour))
    assert np.abs(log_rhos).max() > 0.5  # off-policy by construction
    out = vtrace.from_logits(
        torch.tensor(behaviour), torch.tensor(target),
        torch.tensor(actions), torch.tensor(discounts),
        torch.tensor(rewards), torch.tensor(values),
        torch.tensor(bootstrap), clip_rho_threshold=clips[0],
        clip_pg_rho_threshold=clips[1], scan_impl=scan_impl)
    gt_vs, gt_pg = ground_truth_vtrace(log_rhos, discounts, rewards, values,
                                       bootstrap, *clips)
    np.testing.assert_allclose(out.log_rhos.numpy(), log_rhos, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.vs.numpy(), gt_vs, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.pg_advantages.numpy(), gt_pg, rtol=1e-4,
                               atol=1e-5)


def test_replay_flags_are_ported():
    from scalable_agent_tpu.config import Config as JaxConfig
    from scalable_agent_tpu_torch.config import UNPORTED_FLAGS, Config

    for name in ("loss", "replay_ratio", "replay_capacity",
                 "target_update_interval", "impact_clip_epsilon"):
        assert name not in UNPORTED_FLAGS
        assert getattr(Config(), name) == getattr(JaxConfig(), name)
    # actor and service_max_batch ported, then inference_mode and
    # accum_fused_shards, then the sentinel's two flags and chaos_channel,
    # then train_backend and updates_per_dispatch.
    assert len(UNPORTED_FLAGS) == 15
    config = Config.from_argv(["--loss=impact", "--replay_ratio=2",
                               "--target_update_interval=7"])
    assert (config.loss, config.replay_ratio,
            config.target_update_interval) == ("impact", 2, 7)
    assert dataclasses.replace(config, impact_clip_epsilon=0.2)
