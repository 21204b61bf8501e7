"""IMPALA loss terms and reward transforms (``scalable_agent_tpu/ops/
losses.py``; reference: experiment.py:324-343, 377-382).  Every term is a
SUM over time and batch, not a mean, so the reference's cost
hyperparameters transfer unchanged."""

from typing import Optional

import torch

from scalable_agent_tpu_torch.ops import distributions


def _default_spec(logits, dist_spec):
    if dist_spec is not None:
        return dist_spec
    return distributions.DistributionSpec(sizes=(logits.shape[-1],))


def compute_baseline_loss(advantages):
    """0.5 * sum(advantages^2)."""
    return 0.5 * torch.sum(torch.square(advantages.float()))


def compute_entropy_loss(
        logits,
        dist_spec: Optional[distributions.DistributionSpec] = None):
    """Negative total policy entropy."""
    return -torch.sum(distributions.entropy(
        logits, _default_spec(logits, dist_spec)))


def compute_policy_gradient_loss(
        logits, actions, advantages,
        dist_spec: Optional[distributions.DistributionSpec] = None):
    """sum(cross_entropy(actions) * stop_grad(advantages))."""
    cross_entropy = -distributions.log_prob(
        logits, actions, _default_spec(logits, dist_spec))
    return torch.sum(cross_entropy * advantages.detach())


def clip_rewards(rewards, mode: str):
    """'abs_one' clips to [-1, 1]; 'soft_asymmetric' squashes with tanh on a
    +/-5 scale, negative rewards down-weighted by 0.3; 'none' passes."""
    rewards = rewards.float()
    if mode == "abs_one":
        return torch.clamp(rewards, -1.0, 1.0)
    if mode == "soft_asymmetric":
        squeezed = torch.tanh(rewards / 5.0)
        return torch.where(rewards < 0, 0.3 * squeezed, squeezed) * 5.0
    if mode == "none":
        return rewards
    raise ValueError(f"unknown reward clipping mode: {mode!r}")
