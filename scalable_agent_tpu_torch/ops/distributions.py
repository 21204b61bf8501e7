"""Categorical action distributions over one concatenated logits tensor.

The single-Discrete part of ``scalable_agent_tpu/ops/distributions.py``
(reference: algorithms/utils/action_distributions.py:49-108): a static
``DistributionSpec`` plus plain functions.  Composite (tuple) policies are
not ported yet (ROADMAP.md, queue 1).
"""

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class DistributionSpec(NamedTuple):
    """Static shape of a categorical policy: logit width per component."""

    sizes: Tuple[int, ...]

    @property
    def num_logits(self) -> int:
        return sum(self.sizes)

    @property
    def num_components(self) -> int:
        return len(self.sizes)


def _single(logits, spec: DistributionSpec) -> None:
    if spec.num_components != 1:
        raise NotImplementedError(
            "composite policies are not ported yet (ROADMAP.md, queue 1)")
    if logits.shape[-1] != spec.num_logits:
        raise ValueError(
            f"logits last dim {logits.shape[-1]} != spec {spec.num_logits}")


def sample(generator: torch.Generator, logits, spec: DistributionSpec):
    """Sample one action per row of ``logits [..., n]`` -> int64 [...],
    drawing from ``generator`` (which must live on the logits' device)."""
    _single(logits, spec)
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(logits.shape[:-1])


def log_prob(logits, actions, spec: DistributionSpec):
    """log pi(a|s) for int actions [...] under logits [..., n]."""
    _single(logits, spec)
    log_pi = F.log_softmax(logits.float(), dim=-1)
    return log_pi.gather(-1, actions.long()[..., None])[..., 0]


def entropy(logits, spec: DistributionSpec):
    _single(logits, spec)
    log_p = F.log_softmax(logits.float(), dim=-1)
    return -(log_p.exp() * log_p).sum(dim=-1)


def kl_divergence(p_logits, q_logits, spec: DistributionSpec):
    """KL(p || q) of the categoricals given by two logits tensors."""
    _single(p_logits, spec)
    log_p = F.log_softmax(p_logits.float(), dim=-1)
    log_q = F.log_softmax(q_logits.float(), dim=-1)
    return (log_p.exp() * (log_p - log_q)).sum(dim=-1)


def one_hot_actions(actions, spec: DistributionSpec):
    """The "last action" input of the agent: float32 one-hot [..., n]."""
    if spec.num_components != 1:
        raise NotImplementedError(
            "composite policies are not ported yet (ROADMAP.md, queue 1)")
    return F.one_hot(actions.long(), spec.num_logits).float()
