"""The IMPACT clipped-target surrogate (Luo et al., arXiv:1912.00167).

A copy of ``scalable_agent_tpu/ops/impact.py`` on torch.  A target network
pi_tgt (a periodic hard copy of the online parameters, kept by the
learner) anchors the surrogate:

    r_t = pi_theta(a_t|s_t) / pi_tgt(a_t|s_t)
    L = -sum min(r_t * A_t, clip(r_t, 1 - eps, 1 + eps) * A_t)

The advantages A_t are V-trace's pg-advantages computed with the TARGET
network as V-trace's target policy, so the behaviour-to-target correction
beta = min(c_bar, pi_tgt/mu) is V-trace's clipped pg-rho and is not
applied again here.  Every loss term is a SUM over time and batch, as in
``ops/losses.py``, so the cost hyperparameters carry over between
``--loss=vtrace`` and ``--loss=impact``.  Composite (tuple) policies take
joint log-probs, summed over components (``ops/distributions.py``).
"""

from typing import NamedTuple, Optional

import torch

from scalable_agent_tpu_torch.ops import distributions

__all__ = ["ImpactSurrogate", "surrogate_from_logits"]


class ImpactSurrogate(NamedTuple):
    """The clipped-target policy loss and its diagnostics, 0-d tensors.

    loss: the negated summed surrogate (differentiable in the online
        logits).
    ratio_mean: mean r_t over the batch (about 1 while the online net
        stays near its target).
    clip_fraction: fraction of (t, b) cells where the clipped side of the
        min is the smaller one.
    log_ratio_mean, log_ratio_p95: location and tail of log r_t.
    ess_frac: effective sample size of the r_t, (sum r)^2 / (N sum r^2).
    """

    loss: torch.Tensor
    ratio_mean: torch.Tensor
    clip_fraction: torch.Tensor
    log_ratio_mean: Optional[torch.Tensor] = None
    log_ratio_p95: Optional[torch.Tensor] = None
    ess_frac: Optional[torch.Tensor] = None


def surrogate_from_logits(
    online_logits,
    target_logits,
    actions,
    advantages,
    clip_epsilon: float = 0.3,
    dist_spec: Optional[distributions.DistributionSpec] = None,
) -> ImpactSurrogate:
    """The surrogate from logits [T, B, NUM_LOGITS], actions [T, B]
    ([T, B, K] for a composite ``dist_spec``) and the V-trace
    pg-advantages [T, B] (taken as constants)."""
    if clip_epsilon <= 0.0:
        raise ValueError(
            f"impact clip_epsilon must be > 0, got {clip_epsilon}")
    online_logits = torch.as_tensor(online_logits).float()
    target_logits = torch.as_tensor(target_logits).float()
    actions = torch.as_tensor(actions)
    if dist_spec is None:
        dist_spec = distributions.DistributionSpec(
            sizes=(online_logits.shape[-1],))
    lp_online = distributions.log_prob(online_logits, actions, dist_spec)
    lp_target = distributions.log_prob(
        target_logits.detach(), actions, dist_spec).detach()
    ratio = torch.exp(lp_online - lp_target)
    adv = torch.as_tensor(advantages).float().detach()
    clipped = torch.clamp(ratio, 1.0 - clip_epsilon, 1.0 + clip_epsilon)
    loss = -torch.sum(torch.minimum(ratio * adv, clipped * adv))
    with torch.no_grad():
        clip_active = clipped * adv < ratio * adv
        log_ratio = (lp_online - lp_target).detach()
        # ESS does not change with the weights' scale: shift by the
        # largest log ratio so exp(2 log r) cannot overflow.
        shifted = torch.exp(log_ratio - log_ratio.max())
        ess_frac = torch.square(shifted.sum()) / torch.clamp(
            log_ratio.numel() * torch.square(shifted).sum(), min=1e-30)
        return ImpactSurrogate(
            loss=loss,
            ratio_mean=ratio.detach().mean(),
            clip_fraction=clip_active.float().mean(),
            log_ratio_mean=log_ratio.mean(),
            log_ratio_p95=torch.quantile(log_ratio.reshape(-1), 0.95),
            ess_frac=ess_frac)
