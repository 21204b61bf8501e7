"""Categorical and tuple-categorical action distributions.

A copy of ``scalable_agent_tpu/ops/distributions.py`` on torch (reference:
algorithms/utils/action_distributions.py, ``CategoricalActionDistribution``
:49-108, ``TupleActionDistribution`` :111-201, ``calc_num_logits``
:10-17):

- A distribution is a static ``DistributionSpec`` (the logit width of each
  independent component) plus plain functions over one concatenated
  logits tensor [..., sum(sizes)].
- The components are independent, so log_prob, entropy and KL are sums
  over components, added in component order.
- Actions are integers with a trailing component axis [..., K]; a
  single-component policy keeps the component-less layout ([T, B], [B]).

``sample`` draws from the caller's ``torch.Generator``, which lives on
the logits' device: one draw of ``torch.multinomial(probs, 1)`` per
component, in component order, without its validity checks (``sample``).
"""

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from scalable_agent_tpu_torch.envs.spaces import (
    Space,
    TupleSpace,
    calc_num_logits,
)


class DistributionSpec(NamedTuple):
    """Static shape of a (tuple-)categorical policy: logit width per
    independent component."""

    sizes: Tuple[int, ...]

    @property
    def num_logits(self) -> int:
        return sum(self.sizes)

    @property
    def num_components(self) -> int:
        return len(self.sizes)


def spec_for_space(space: Space) -> DistributionSpec:
    """Space -> DistributionSpec: one component for each leaf of a
    TupleSpace, its width the leaf's ``calc_num_logits`` (which raises for
    a space no categorical policy covers)."""
    if isinstance(space, TupleSpace):
        return DistributionSpec(sizes=tuple(
            size for sub in space.spaces for size in spec_for_space(sub).sizes))
    return DistributionSpec(sizes=(calc_num_logits(space),))


def _component_logits(logits, spec: DistributionSpec):
    """[..., num_logits] as float32 per-component slices."""
    if logits.shape[-1] != spec.num_logits:
        raise ValueError(
            f"logits last dim {logits.shape[-1]} != spec {spec.num_logits}")
    logits = logits.float()
    if spec.num_components == 1:
        return [logits]
    return list(torch.split(logits, spec.sizes, dim=-1))


def _component_actions(actions, spec: DistributionSpec):
    """Actions [..., K] (or [...] when K == 1) -> list of [...] int64."""
    k = spec.num_components
    actions = actions.long()
    if k == 1:
        # A single-component policy always uses the component-less
        # layout: never a trailing K axis, which a batch of 1 would
        # make ambiguous.
        return [actions]
    if actions.shape[-1] != k:
        raise ValueError(
            f"actions last dim {actions.shape[-1]} != {k} components")
    return list(actions.unbind(-1))


def sample(generator: torch.Generator, logits, spec: DistributionSpec):
    """Sample every component from ``generator`` -> int64 [..., K],
    [...] for K == 1.  Each draw is ``torch.multinomial(probs, 1)``'s
    exponential race, ``argmax(probs / q)`` with ``q ~ Exp(1)`` from the
    generator, written out: the same draws from the same generator state
    (``tests/test_torch_ingraph.py`` holds them bitwise), without
    multinomial's validity checks, which read the probabilities back to
    the host (two syncs a call on the card; the in-graph backend issues
    whole unrolls without one).  So a NaN or negative probability draws
    an action (``argmax`` over the race) where multinomial raised, as the
    JAX sampler draws one."""
    parts = []
    for chunk in _component_logits(logits, spec):
        probs = torch.softmax(chunk, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        race = torch.empty_like(flat).exponential_(1, generator=generator)
        draws = torch.argmax(flat / race, dim=-1)
        parts.append(draws.reshape(chunk.shape[:-1]))
    if spec.num_components == 1:
        return parts[0]
    return torch.stack(parts, dim=-1)


def log_prob(logits, actions, spec: DistributionSpec):
    """Joint log pi(a|s): the sum of the component log-probs
    (reference: TupleActionDistribution.log_prob, :160-165)."""
    total = None
    for chunk, action in zip(_component_logits(logits, spec),
                             _component_actions(actions, spec)):
        lp = F.log_softmax(chunk, dim=-1).gather(-1, action[..., None])[
            ..., 0]
        total = lp if total is None else total + lp
    return total


def entropy(logits, spec: DistributionSpec):
    """Joint entropy: the sum of the component entropies
    (reference: TupleActionDistribution.entropy, :180-184)."""
    total = None
    for chunk in _component_logits(logits, spec):
        log_p = F.log_softmax(chunk, dim=-1)
        ent = -(log_p.exp() * log_p).sum(dim=-1)
        total = ent if total is None else total + ent
    return total


def kl_divergence(p_logits, q_logits, spec: DistributionSpec):
    """KL(p || q), summed over components (reference:
    CategoricalActionDistribution.kl_divergence :96-100)."""
    total = None
    for p_chunk, q_chunk in zip(_component_logits(p_logits, spec),
                                _component_logits(q_logits, spec)):
        log_p = F.log_softmax(p_chunk, dim=-1)
        log_q = F.log_softmax(q_chunk, dim=-1)
        kl = (log_p.exp() * (log_p - log_q)).sum(dim=-1)
        total = kl if total is None else total + kl
    return total


def symmetric_kl(p_logits, q_logits, spec: DistributionSpec):
    """0.5 * (KL(p || q) + KL(q || p)), summed over components: what the
    reference's ``kl_divergence`` computes (reference:
    CategoricalActionDistribution._kl_symmetric :84-101)."""
    return 0.5 * (kl_divergence(p_logits, q_logits, spec)
                  + kl_divergence(q_logits, p_logits, spec))


def kl_to_prior(logits, spec: DistributionSpec):
    """Symmetric KL against the uniform prior of each component, summed
    over components (reference: CategoricalActionDistribution.kl_prior
    :95-98, TupleActionDistribution.kl_prior :187-191)."""
    total = None
    for chunk in _component_logits(logits, spec):
        component_spec = DistributionSpec(sizes=(chunk.shape[-1],))
        kl = symmetric_kl(chunk, torch.zeros_like(chunk), component_spec)
        total = kl if total is None else total + kl
    return total


def one_hot_actions(actions, spec: DistributionSpec):
    """The agent's "last action" input: the per-component float32
    one-hots concatenated, [..., num_logits] (generalizes the reference's
    single one_hot, experiment.py:196-198)."""
    parts = [F.one_hot(action, size).float()
             for size, action in zip(spec.sizes,
                                     _component_actions(actions, spec))]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
