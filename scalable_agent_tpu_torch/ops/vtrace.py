"""V-trace off-policy actor-critic targets.

The counterpart of ``scalable_agent_tpu/ops/vtrace.py`` (reference:
vtrace.py:71-280).  The recurrence

    acc_s = delta_s + (discount_s * c_s) * acc_{s+1}

runs as a plain reverse loop over time.  On the JAX package's main path it
is an ``associative_scan`` outside any kernel, so plain tensor code is its
counterpart here; the fused V-trace kernel (``ops/vtrace_pallas.py``) is
still to be ported (ROADMAP.md, queue 2).  Every output is detached, as in
the reference.  Extra trailing dimensions ([T, B, C...]) are supported.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class VTraceReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor


class VTraceFromLogitsReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor
    log_rhos: torch.Tensor
    behaviour_action_log_probs: torch.Tensor
    target_action_log_probs: torch.Tensor


def log_probs_from_logits_and_actions(policy_logits, actions):
    """log softmax(policy_logits)[actions]: [T, B, A] x [T, B] -> [T, B]."""
    log_pi = F.log_softmax(policy_logits.float(), dim=-1)
    return log_pi.gather(-1, actions.long()[..., None])[..., 0]


@torch.no_grad()
def from_importance_weights(
    log_rhos,
    discounts,
    rewards,
    values,
    bootstrap_value,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
) -> VTraceReturns:
    """V-trace targets from log importance weights.  Shapes:
    log_rhos/discounts/rewards/values [T, B, C...], bootstrap_value
    [B, C...]."""
    log_rhos, discounts, rewards, values, bootstrap_value = (
        t.detach().float() for t in (log_rhos, discounts, rewards, values,
                                     bootstrap_value))
    if values.dim() != log_rhos.dim():
        raise ValueError(
            f"values rank {values.dim()} != log_rhos rank {log_rhos.dim()}")
    if bootstrap_value.dim() != log_rhos.dim() - 1:
        raise ValueError(
            f"bootstrap_value rank {bootstrap_value.dim()} != log_rhos rank "
            f"{log_rhos.dim()} - 1")
    if discounts.dim() != log_rhos.dim() or rewards.dim() != log_rhos.dim():
        raise ValueError("discounts/rewards rank must match log_rhos rank")
    rhos = torch.exp(log_rhos)
    clipped_rhos = (torch.clamp(rhos, max=clip_rho_threshold)
                    if clip_rho_threshold is not None else rhos)
    cs = torch.clamp(rhos, max=1.0)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)
    a = discounts * cs
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = []
    for t in reversed(range(log_rhos.shape[0])):
        acc = deltas[t] + a[t] * acc
        vs_minus_v.append(acc)
    vs = torch.stack(vs_minus_v[::-1]) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = (torch.clamp(rhos, max=clip_pg_rho_threshold)
                       if clip_pg_rho_threshold is not None else rhos)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)


def from_logits(
    behaviour_policy_logits,
    target_policy_logits,
    actions,
    discounts,
    rewards,
    values,
    bootstrap_value,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
) -> VTraceFromLogitsReturns:
    """V-trace for softmax policies: logits [T, B, A], actions [T, B],
    discounts/rewards/values [T, B], bootstrap_value [B]."""
    if behaviour_policy_logits.dim() != 3 or target_policy_logits.dim() != 3:
        raise ValueError("policy logits must be rank 3 [T, B, NUM_LOGITS]")
    if actions.dim() != 2:
        raise ValueError("actions must be rank 2 [T, B]")
    with torch.no_grad():
        behaviour_log_probs = log_probs_from_logits_and_actions(
            behaviour_policy_logits, actions)
        target_log_probs = log_probs_from_logits_and_actions(
            target_policy_logits, actions)
        log_rhos = target_log_probs - behaviour_log_probs
    returns = from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold)
    return VTraceFromLogitsReturns(
        vs=returns.vs,
        pg_advantages=returns.pg_advantages,
        log_rhos=log_rhos,
        behaviour_action_log_probs=behaviour_log_probs,
        target_action_log_probs=target_log_probs)
