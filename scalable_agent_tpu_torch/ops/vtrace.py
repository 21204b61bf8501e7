"""V-trace off-policy actor-critic targets.

The counterpart of ``scalable_agent_tpu/ops/vtrace.py`` (reference:
vtrace.py:71-280), with the same ``scan_impl`` dispatch:

- ``"associative"`` solves the recurrence

      acc_s = delta_s + (discount_s * c_s) * acc_{s+1}

  as the JAX package does, by composing the steps' affine maps
  (``compose_affine``) in a log-depth reverse scan: about log2(T)
  doubling levels of tensor ops over all of T.  ``"sequential"`` is the
  reverse loop over time (JAX: a reverse ``lax.scan``).
- ``"pallas"`` names the fused V-trace kernel (``ops/vtrace_pallas.py``);
  its counterpart is the hand-written CUDA kernel in ``ops/vtrace_cuda.py``.
  Extra trailing dims are flattened into its batch axis.
- ``"time_sharded"`` shards time over a mesh's seq axis, which the port
  does not have yet (ROADMAP.md, queue 1): it raises.

Every output is detached, as in the reference.  ``diagnostics`` carries
the same off-policyness scalars as the JAX package's
``importance_diagnostics``; it is computed when it is read, so a caller
that never reads it (the learner) does not pay for it, as a jitted JAX
caller does not.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from scalable_agent_tpu_torch.ops import distributions, vtrace_cuda

SCAN_IMPLS = ("associative", "sequential", "pallas")


class VTraceDiagnostics(NamedTuple):
    """Scalar off-policyness diagnostics of one V-trace batch, as in the
    JAX package: fractions of cells whose rho exceeded each clip (strict
    ``>``; 0 for a clip of ``None``), the mean and 95th percentile of log
    rho, and the effective sample size of the unclipped weights as a
    fraction of N."""

    rho_clip_fraction: torch.Tensor
    cs_clip_fraction: torch.Tensor
    pg_rho_clip_fraction: torch.Tensor
    log_rho_mean: torch.Tensor
    log_rho_p95: torch.Tensor
    ess_frac: torch.Tensor


def _diagnostics(returns) -> VTraceDiagnostics:
    """``importance_diagnostics`` of the batch, computed when read."""
    return importance_diagnostics(*returns.importance)


class VTraceReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor
    # (log_rhos, clip_rho_threshold, clip_pg_rho_threshold), from which
    # ``diagnostics`` is computed.
    importance: Tuple = ()

    diagnostics = property(_diagnostics)


class VTraceFromLogitsReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor
    log_rhos: torch.Tensor
    behaviour_action_log_probs: torch.Tensor
    target_action_log_probs: torch.Tensor
    importance: Tuple = ()

    diagnostics = property(_diagnostics)


@torch.no_grad()
def importance_diagnostics(log_rhos,
                           clip_rho_threshold: Optional[float] = 1.0,
                           clip_pg_rho_threshold: Optional[float] = 1.0
                           ) -> VTraceDiagnostics:
    """Off-policyness diagnostics from log importance ratios (the JAX
    package's ``importance_diagnostics``)."""
    log_rhos = log_rhos.detach().float()
    rhos = torch.exp(log_rhos)
    zero = torch.zeros((), dtype=torch.float32, device=log_rhos.device)
    fractions = {}  # one reduction per distinct threshold

    def fraction(threshold):
        if threshold is None:
            return zero
        if threshold not in fractions:
            fractions[threshold] = (rhos > threshold).float().mean()
        return fractions[threshold]

    # ESS is scale-invariant in the weights, so shift by the max log ratio
    # before exponentiating: exp(2 * log_rho) overflows float32 from
    # log_rho ~ 44.
    shifted = torch.exp(log_rhos - log_rhos.max())
    sum_rho = shifted.sum()
    sum_rho_sq = shifted.square().sum()
    n = float(log_rhos.numel())
    ess_frac = sum_rho.square() / torch.clamp(n * sum_rho_sq, min=1e-30)
    return VTraceDiagnostics(
        rho_clip_fraction=fraction(clip_rho_threshold),
        cs_clip_fraction=fraction(1.0),
        pg_rho_clip_fraction=fraction(clip_pg_rho_threshold),
        log_rho_mean=log_rhos.mean(),
        log_rho_p95=torch.quantile(log_rhos.reshape(-1), 0.95),
        ess_frac=ess_frac)


def compose_affine(later, earlier):
    """Affine-map composition for the reverse recurrence (the JAX
    package's ``compose_affine``): each step is f(x) = b + a * x, and
    f_earlier o f_later is (a_e * a_l, b_e + a_e * b_l)."""
    a_l, b_l = later
    a_e, b_e = earlier
    return a_e * a_l, b_e + a_e * b_l


def _linear_recurrence_reverse(a, b, scan_impl: str):
    """Solve acc_s = b_s + a_s * acc_{s+1} with acc_T = 0, over axis 0.

    ``associative``: a Hillis-Steele reverse scan.  After the level of
    shift d, entry s holds the composed map of steps [s, s + 2d) (cut at
    T), so ceil(log2 T) levels leave f_s o ... o f_{T-1} at s, whose b is
    its value at 0.  ``sequential``: the reverse loop."""
    if scan_impl == "sequential":
        acc = torch.zeros_like(b[0])
        out = []
        for t in reversed(range(b.shape[0])):
            acc = b[t] + a[t] * acc
            out.append(acc)
        return torch.stack(out[::-1])
    shift = 1
    while shift < b.shape[0]:
        a_c, b_c = compose_affine((a[shift:], b[shift:]),
                                  (a[:-shift], b[:-shift]))
        a = torch.cat([a_c, a[-shift:]])
        b = torch.cat([b_c, b[-shift:]])
        shift *= 2
    return b


def _recurrence_path(log_rhos, discounts, rewards, values, bootstrap_value,
                     clip_rho_threshold, clip_pg_rho_threshold, scan_impl):
    """The non-kernel paths: elementwise prologue, the recurrence by
    ``scan_impl``, elementwise epilogue."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = (torch.clamp(rhos, max=clip_rho_threshold)
                    if clip_rho_threshold is not None else rhos)
    cs = torch.clamp(rhos, max=1.0)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)
    vs = _linear_recurrence_reverse(discounts * cs, deltas,
                                    scan_impl) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = (torch.clamp(rhos, max=clip_pg_rho_threshold)
                       if clip_pg_rho_threshold is not None else rhos)
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values)
    return vs, pg_advantages


@torch.no_grad()
def from_importance_weights(
    log_rhos,
    discounts,
    rewards,
    values,
    bootstrap_value,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    scan_impl: str = "associative",
) -> VTraceReturns:
    """V-trace targets from log importance weights.  Shapes:
    log_rhos/discounts/rewards/values [T, B, C...], bootstrap_value
    [B, C...]."""
    if scan_impl == "time_sharded":
        raise ValueError(
            "scan_impl='time_sharded' shards time over a mesh's seq axis, "
            "which is not ported to scalable_agent_tpu_torch yet "
            "(ROADMAP.md, queue 1)")
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl: {scan_impl!r}")
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
    if scan_impl == "pallas":
        # The kernel is rank 2 [T, N]: trailing value dims flatten into
        # the batch, since the recurrence is independent per column.
        shape = log_rhos.shape
        flat = lambda t: t.reshape(shape[0], -1).contiguous()
        vs, pg_advantages = vtrace_cuda.vtrace_fused(
            flat(log_rhos), flat(discounts), flat(rewards), flat(values),
            bootstrap_value.reshape(-1).contiguous(),
            clip_rho_threshold=clip_rho_threshold,
            clip_pg_rho_threshold=clip_pg_rho_threshold)
        vs, pg_advantages = vs.reshape(shape), pg_advantages.reshape(shape)
    else:
        vs, pg_advantages = _recurrence_path(
            log_rhos, discounts, rewards, values, bootstrap_value,
            clip_rho_threshold, clip_pg_rho_threshold, scan_impl)
    return VTraceReturns(
        vs=vs, pg_advantages=pg_advantages,
        importance=(log_rhos, clip_rho_threshold, clip_pg_rho_threshold))


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
    scan_impl: str = "associative",
    dist_spec=None,
) -> VTraceFromLogitsReturns:
    """V-trace for softmax policies: logits [T, B, NUM_LOGITS], actions
    [T, B] ([T, B, K] for a composite policy given by ``dist_spec``, an
    ``ops/distributions.DistributionSpec``: the log-rhos are then joint,
    summed component log-prob ratios, as
    ``scalable_agent_tpu/ops/vtrace.py:326-339`` computes them),
    discounts/rewards/values [T, B], bootstrap_value [B]."""
    if behaviour_policy_logits.dim() != 3 or target_policy_logits.dim() != 3:
        raise ValueError("policy logits must be rank 3 [T, B, NUM_LOGITS]")
    spec = dist_spec or distributions.DistributionSpec(
        (behaviour_policy_logits.shape[-1],))
    if spec.num_components > 1 and actions.dim() != 3:
        raise ValueError("composite actions must be rank 3 [T, B, K]")
    if spec.num_components == 1 and actions.dim() != 2:
        raise ValueError("actions must be rank 2 [T, B]")
    with torch.no_grad():
        behaviour_log_probs = distributions.log_prob(
            behaviour_policy_logits, actions, spec)
        target_log_probs = distributions.log_prob(
            target_policy_logits, actions, spec)
        log_rhos = target_log_probs - behaviour_log_probs
    returns = from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        scan_impl=scan_impl)
    return VTraceFromLogitsReturns(
        vs=returns.vs,
        pg_advantages=returns.pg_advantages,
        log_rhos=log_rhos,
        behaviour_action_log_probs=behaviour_log_probs,
        target_action_log_probs=target_log_probs,
        importance=returns.importance)
