"""The port's V-trace, losses and distributions against the JAX package's
(ops/vtrace.py, ops/losses.py, ops/distributions.py) on the same numpy
inputs.

Tolerances: float32 on both sides; V-trace's recurrence is a reverse loop
here and an associative scan there (another summation order over T <= 7
steps), hence rtol/atol 1e-5; elementwise ops and small sums 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.ops import distributions as dist_j
from scalable_agent_tpu.ops import losses as losses_j
from scalable_agent_tpu.ops import vtrace as vtrace_j
from scalable_agent_tpu_torch.ops import distributions, losses, vtrace

A = 6


def _vtrace_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        log_rhos=f32(*shape) * 0.8,
        discounts=(0.99 * (rng.random(shape) > 0.2)).astype(np.float32),
        rewards=f32(*shape),
        values=f32(*shape),
        bootstrap_value=f32(*shape[1:]))


@pytest.mark.parametrize("shape", [(7, 5), (1, 3), (4, 2, 3)])
@pytest.mark.parametrize("clips", [(1.0, 1.0), (3.7, 2.2), (None, None)])
def test_from_importance_weights_matches_jax(shape, clips):
    arrays = _vtrace_inputs(sum(shape), shape)
    kw = dict(clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
    want = vtrace_j.from_importance_weights(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    got = vtrace.from_importance_weights(
        **{k: torch.tensor(v) for k, v in arrays.items()}, **kw)
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(want.vs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               np.asarray(want.pg_advantages),
                               rtol=1e-5, atol=1e-5)


def test_from_logits_matches_jax_and_detaches():
    rng = np.random.default_rng(3)
    T, B = 6, 4
    behaviour = rng.standard_normal((T, B, A)).astype(np.float32)
    target = rng.standard_normal((T, B, A)).astype(np.float32)
    actions = rng.integers(0, A, (T, B))
    rest = _vtrace_inputs(4, (T, B))
    del rest["log_rhos"]
    want = vtrace_j.from_logits(
        jnp.asarray(behaviour), jnp.asarray(target),
        jnp.asarray(actions, jnp.int32),
        **{k: jnp.asarray(v) for k, v in rest.items()})
    target_t = torch.tensor(target, requires_grad=True)
    got = vtrace.from_logits(
        torch.tensor(behaviour), target_t, torch.tensor(actions),
        **{k: torch.tensor(v) for k, v in rest.items()})
    for name in ("vs", "pg_advantages", "log_rhos",
                 "behaviour_action_log_probs", "target_action_log_probs"):
        value = getattr(got, name)
        assert not value.requires_grad, name
        np.testing.assert_allclose(value.numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 3, A)).astype(np.float32)
    actions = rng.integers(0, A, (5, 3))
    adv = rng.standard_normal((5, 3)).astype(np.float32)
    pairs = [
        (losses.compute_baseline_loss(torch.tensor(adv)),
         losses_j.compute_baseline_loss(jnp.asarray(adv))),
        (losses.compute_entropy_loss(torch.tensor(logits)),
         losses_j.compute_entropy_loss(jnp.asarray(logits))),
        (losses.compute_policy_gradient_loss(
            torch.tensor(logits), torch.tensor(actions), torch.tensor(adv)),
         losses_j.compute_policy_gradient_loss(
             jnp.asarray(logits), jnp.asarray(actions, jnp.int32),
             jnp.asarray(adv))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_policy_gradient_loss_stops_advantage_gradient():
    adv = torch.ones(2, 3, requires_grad=True)
    logits = torch.zeros(2, 3, A, requires_grad=True)
    loss = losses.compute_policy_gradient_loss(
        logits, torch.zeros(2, 3, dtype=torch.long), adv)
    g_logits, g_adv = torch.autograd.grad(loss, [logits, adv],
                                          allow_unused=True)
    assert g_adv is None and float(g_logits.abs().sum()) > 0


@pytest.mark.parametrize("mode", ["abs_one", "soft_asymmetric", "none"])
def test_clip_rewards_match_jax(mode):
    rewards = np.linspace(-12.0, 12.0, 41).astype(np.float32)
    np.testing.assert_allclose(
        losses.clip_rewards(torch.tensor(rewards), mode).numpy(),
        np.asarray(losses_j.clip_rewards(jnp.asarray(rewards), mode)),
        rtol=1e-6, atol=1e-6)


def test_distributions_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((4, 5, A)) * 3).astype(np.float32)
    actions = rng.integers(0, A, (4, 5))
    spec = distributions.DistributionSpec(sizes=(A,))
    spec_j = dist_j.DistributionSpec(sizes=(A,))
    np.testing.assert_allclose(
        distributions.log_prob(torch.tensor(logits), torch.tensor(actions),
                               spec).numpy(),
        np.asarray(dist_j.log_prob(jnp.asarray(logits),
                                   jnp.asarray(actions), spec_j)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        distributions.entropy(torch.tensor(logits), spec).numpy(),
        np.asarray(dist_j.entropy(jnp.asarray(logits), spec_j)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        distributions.one_hot_actions(torch.tensor(actions), spec).numpy(),
        np.asarray(dist_j.one_hot_actions(jnp.asarray(actions), spec_j)))


def test_sample_follows_the_softmax():
    """The two frameworks' generators give different draws from one
    seed, so sampling is held to its distribution: 60k draws from a fixed
    softmax, each action's frequency within 5 standard errors."""
    probs = np.array([0.05, 0.1, 0.15, 0.2, 0.2, 0.3], np.float32)
    logits = torch.tensor(np.log(probs)).expand(60000, A)
    gen = torch.Generator().manual_seed(0)
    draws = distributions.sample(gen, logits,
                                 distributions.DistributionSpec((A,)))
    assert draws.shape == (60000,) and draws.dtype == torch.int64
    freq = np.bincount(draws.numpy(), minlength=A) / 60000
    stderr = np.sqrt(probs * (1 - probs) / 60000)
    assert np.all(np.abs(freq - probs) < 5 * stderr)
    again = distributions.sample(torch.Generator().manual_seed(0), logits,
                                 distributions.DistributionSpec((A,)))
    assert torch.equal(draws, again)


def test_composite_spaces_are_refused():
    """Composite policies are ported (tests/test_torch_composite.py holds
    them): a (2, 3) spec gives JAX's joint log-prob; what is refused now
    is an action layout whose component axis does not match the spec."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5)).astype(np.float32)
    actions = np.array([[1, 2], [0, 1]])
    spec = distributions.DistributionSpec((2, 3))
    np.testing.assert_allclose(
        distributions.log_prob(torch.tensor(logits), torch.tensor(actions),
                               spec).numpy(),
        np.asarray(dist_j.log_prob(jnp.asarray(logits), jnp.asarray(actions),
                                   dist_j.DistributionSpec((2, 3)))),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="2 components"):
        distributions.log_prob(torch.tensor(logits),
                               torch.zeros(2, 3, dtype=torch.long), spec)
