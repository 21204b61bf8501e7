"""The learner: one IMPALA update on a [T+1, B] trajectory batch.

The counterpart of ``scalable_agent_tpu/runtime/learner.py``'s single-device
update (``_forward``, ``_loss_vtrace``, ``_update_impl``; reference:
experiment.py:346-427):

- ONE whole-trajectory forward (the fused single-forward loss) gives both
  the quantities V-trace compares against the behaviour policy and the
  differentiated loss outputs; V-trace detaches everything it returns.
- RMSProp is written out by hand, because ``torch.optim.RMSprop`` differs
  from the optax transform the JAX learner uses: the mean-square
  accumulator ``nu`` starts at ONE (TF's RMSPropOptimizer, the reference),
  and eps=0.1 is added INSIDE the root: ``g / sqrt(nu + eps)``.
- The learning rate ``lr0 * max(0, 1 - frames/total)`` multiplies the
  update after the optimizer, keyed on env frames (reference:
  experiment.py:409-420).
- ``rmsprop_momentum != 0`` adds optax's ``trace`` after the scaling, as
  ``optax.rmsprop(momentum=...)`` chains it: ``m = -g/sqrt(nu + eps) +
  momentum * m`` from m = 0, then ``param += lr * m``.  The trace holds
  steps before the lr multiplies them; TF accumulates lr-scaled steps, so
  the two differ while the lr changes (the JAX learner warns of it, and
  so does this one, once, at construction).  At momentum 0 there is no
  trace at all and the update is the plain one above.
- The non-finite guard: a NaN/Inf loss or gradient makes the update a
  no-op on params, ``nu`` and the momentum trace (frames still advance),
  counted in ``nonfinite_skips``/``nonfinite_streak`` without a host
  sync.
  ``NonFiniteTracker`` reads those counters from the metrics the driver
  fetches at log time and decides when the streak calls for a rollback.
- ``fused_forward=False`` is the JAX learner's two-pass reference: a
  separate unroll without gradients gives the quantities V-trace compares
  against the behaviour policy (``_comparison_forward``), the
  differentiated one the loss.  The two are equal in value by
  construction (the comparison unroll runs the same kernels, the core's
  residual forward included), so both shapes give the same update.
- The ``nan_grad`` fault point (``runtime/faults.py``) multiplies the
  trajectory's rewards by NaN before the loss.
- ``loss="impact"`` trains on the IMPACT clipped-target surrogate
  (``ops/impact.py``; JAX ``_loss_impact``): ``TrainState.target_params``
  holds a target network, a copy of the parameters by name, distinct from
  them.  The loss makes the one online unroll, then the target's unroll
  without gradients (``torch.func.functional_call`` over the target
  tensors, so the core takes its lean kernel over all T+1 steps), V-trace
  with the target's logits as its target policy, and the surrogate beside
  the vtrace branch's baseline and entropy terms.  Every
  ``target_update_interval`` fresh updates the updated parameters are
  copied into the target, after the guard's select (a skipped update
  copies the parameters it kept).  ``update(trajectory, fresh=False)`` is
  a replayed update (``runtime/replay.py``): it trains but holds
  ``env_frames``, the learning rate's frame count and the target
  schedule, and counts in ``learner/replayed_updates_total``.

V-trace's recurrence follows ``scan_impl`` (``ops/vtrace.py``): ``"auto"``
resolves to ``"associative"``, as the JAX learner resolves it on a mesh
without a seq axis (the port has none); ``"pallas"`` runs the fused CUDA
kernel (``ops/vtrace_cuda.py``).

Parameters, their gradients, the loss, V-trace and RMSProp's ``nu`` are
float32 under either compute dtype: the agent casts its outputs to float32
and its parameters are float32 (the dtype policy, models/agent.py).

The parameters live in the agent module; ``TrainState`` holds what the JAX
TrainState holds besides them.  ``state_dict``/``load_state_dict`` give the
whole of it (parameters included) for checkpoints.

Device telemetry (``obs/device_telemetry.py``), as in the JAX learner:
``learner_telemetry_spec`` (update and skip counters, the last loss, a
grad-norm histogram) and, with ``learn_telemetry``,
``learning_telemetry_spec`` (the learning-dynamics gauges: entropy and KL
of the policy, V-trace's importance diagnostics, the baseline's explained
variance, the torso's dead units, and per ``LAYER_GROUPS`` group the
grad norm, param norm and update ratio).  Their buffers live on the
learner's device and are updated in place inside ``update`` with no host
sync; ``publish_device_telemetry`` copies them to the host once and folds
them into the metrics registry as ``devtel/*``.  The learning-dynamics
scalars also ride the metrics dict.  ``update_flops`` counts the update's
FLOPs for the live MFU gauge (``obs/ledger.py``).
"""

import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from scalable_agent_tpu_torch.convert import layer_group
from scalable_agent_tpu_torch.models.agent import CORE_SIZE, ImpalaAgent
from scalable_agent_tpu_torch.models.instruction import (
    EMBEDDING_SIZE,
    LSTM_SIZE,
)
from scalable_agent_tpu_torch.models.networks import TORSO_SIZE, conv_shapes
from scalable_agent_tpu_torch.obs import (
    DeviceTelemetry,
    TelemetryPublisher,
    get_flight_recorder,
    get_registry,
    get_tracer,
)
from scalable_agent_tpu_torch.obs.device_telemetry import (
    fetch_merged,
    merge_init,
)
from scalable_agent_tpu_torch.obs.learning import LAYER_GROUPS
from scalable_agent_tpu_torch.ops import distributions
from scalable_agent_tpu_torch.ops import impact as impact_lib
from scalable_agent_tpu_torch.ops import losses as losses_lib
from scalable_agent_tpu_torch.ops import vtrace
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.types import AgentOutput, AgentState, StepOutput
from scalable_agent_tpu_torch.utils.text import MAX_INSTRUCTION_LEN


class Trajectory(NamedTuple):
    """Device-side trajectory batch.  agent_state: AgentState [B, H];
    env_outputs: StepOutput [T+1, B, ...]; agent_outputs: AgentOutput
    [T+1, B, ...]."""

    agent_state: AgentState
    env_outputs: StepOutput
    agent_outputs: AgentOutput


class LearnerHyperparams(NamedTuple):
    """Loss/optimizer knobs, reference defaults (experiment.py:61-95)."""

    entropy_cost: float = 0.00025
    baseline_cost: float = 0.5
    discounting: float = 0.99
    reward_clipping: str = "abs_one"
    learning_rate: float = 0.00048
    total_environment_frames: float = 1e9
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    rmsprop_epsilon: float = 0.1
    clip_rho_threshold: float = 1.0
    clip_pg_rho_threshold: float = 1.0


def learner_telemetry_spec() -> DeviceTelemetry:
    """The learner's device instruments: update and skip counters, the
    newest loss, and a log-bucketed grad-norm histogram."""
    return (
        DeviceTelemetry("learner")
        .counter("updates", "update steps executed on device")
        .counter("skipped", "updates the fused non-finite guard no-op'd")
        .gauge("loss", "total_loss of the newest accumulated update")
        .histogram(
            "grad_norm",
            (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0),
            "global grad norm per update, log-ish buckets")
    )


# The IMPACT clip fraction's histogram buckets (JAX ``_FRACTION_EDGES``).
_FRACTION_EDGES = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
LOSSES = ("vtrace", "impact")


def learning_telemetry_spec(loss: str = "vtrace") -> DeviceTelemetry:
    """The learning-dynamics gauges of the newest update, as the JAX
    package declares them for ``loss``: under ``impact`` also the IMPACT
    ratio and clip-fraction histograms (every update between fetches) and
    the online-to-target drift gauges."""
    spec = DeviceTelemetry("learn")
    for name, help_text in (
        ("entropy_frac",
         "policy entropy / max entropy (1.0 = uniform; ~0 = collapsed)"),
        ("kl",
         "KL(behaviour || learner) — how far the learner has moved off "
         "the data-generating policy"),
        ("ess_frac",
         "effective sample size of the V-trace importance weights as a "
         "fraction of the batch (1.0 = on-policy)"),
        ("explained_variance",
         "1 - Var(vs - baseline)/Var(vs): how much of the value target "
         "the baseline explains (<=0 = diverging critic)"),
        ("rho_clip_fraction",
         "fraction of V-trace rhos cut by clip_rho_threshold"),
        ("cs_clip_fraction",
         "fraction of V-trace cs cut by the c-bar clip"),
        ("pg_rho_clip_fraction",
         "fraction of pg-rhos cut by clip_pg_rho_threshold"),
        ("log_rho_mean",
         "mean log importance ratio log(pi/mu) (0 = on-policy)"),
        ("log_rho_p95",
         "p95 log importance ratio — the off-policy tail"),
        ("dead_torso_frac",
         "fraction of conv-torso output units at <=0 across the whole "
         "batch (dead ReLUs)"),
    ):
        spec.gauge(name, help_text)
    for group in LAYER_GROUPS:
        spec.gauge(f"grad_norm_{group}",
                   f"gradient norm over the {group} param group")
        spec.gauge(f"param_norm_{group}",
                   f"param norm of the {group} param group")
        spec.gauge(f"update_ratio_{group}",
                   f"|lr-scaled update| / |param| for the {group} group "
                   "(healthy ~1e-4..1e-2)")
    if loss == "impact":
        spec.histogram(
            "impact_ratio",
            (0.5, 0.8, 0.9, 0.95, 1.0, 1.05, 1.1, 1.25, 2.0),
            "per-update mean IMPACT ratio pi_theta/pi_tgt (~1 = online "
            "net hugging its target anchor)")
        spec.histogram(
            "impact_clip_fraction", _FRACTION_EDGES,
            "per-update fraction of cells where the IMPACT clip bound "
            "was active")
        spec.gauge("impact_log_ratio_p95",
                   "p95 of log(pi_theta/pi_tgt) — online-to-target "
                   "drift tail")
        spec.gauge("impact_ess_frac",
                   "ESS fraction of the online-to-target importance "
                   "weights")
    return spec


def update_flops(frame_shape: Sequence[int], num_logits: int,
                 unroll_length: int, batch_size: int,
                 core_size: int = CORE_SIZE, torso_type: str = "shallow",
                 use_instruction: bool = False,
                 loss: str = "vtrace") -> float:
    """FLOPs of one update at 2 per multiply-add: every product and
    convolution of the agent's forward over the [T+1, B] trajectory and
    of its backward, elementwise work left out (as
    ``torch.utils.flop_counter.FlopCounterMode`` counts).  The backward
    computes each layer's weight gradient and input gradient, but the
    stem conv's input is the frame, which takes no gradient.  With
    ``use_instruction`` the instruction encoder's products count too: one
    input projection over every token and a recurrent product at every
    token but the first (whose carry is zero).  Counts the default update
    (``fused_forward``, no ``remat_torso``: recomputation is not model
    work).  ``num_logits`` is the policy's logit count (the one-hot last
    action's width and the policy head's), the action count of a
    Discrete space.  ``loss="impact"`` adds the target network's forward
    over the trajectory (no backward)."""
    convs, flat = conv_shapes(torso_type, frame_shape)
    forward = backward = 0
    for i, conv in enumerate(convs):
        macs = (conv.out_height * conv.out_width * conv.out_channels
                * conv.kernel * conv.kernel * conv.in_channels)
        forward += macs
        backward += macs if i == 0 else 2 * macs
    gates = 4 * core_size
    in_features = TORSO_SIZE + 1 + num_logits
    layers = [flat * TORSO_SIZE]                                # fc
    if use_instruction:
        in_features += LSTM_SIZE
        layers += [MAX_INSTRUCTION_LEN * EMBEDDING_SIZE * 4 * LSTM_SIZE,
                   (MAX_INSTRUCTION_LEN - 1) * LSTM_SIZE * 4 * LSTM_SIZE]
    layers += [in_features * gates,                            # x.Wi
               core_size * gates,                              # h.Wh
               core_size * (num_logits + 1)]                   # heads
    for macs in layers:
        forward += macs
        backward += 2 * macs
    forwards = 2 if loss == "impact" else 1
    return 2.0 * (unroll_length + 1) * batch_size * (forwards * forward
                                                     + backward)


@dataclasses.dataclass
class TrainState:
    """Optimizer state and counters.  ``env_frames`` is a host float: it
    advances by ``frames_per_update`` per update and needs no device
    value."""

    opt_state: Dict[str, torch.Tensor]  # RMSProp nu, by parameter name
    env_frames: float
    nonfinite_skips: torch.Tensor  # f32 scalars on the params' device
    nonfinite_streak: torch.Tensor
    # The momentum trace by parameter name; None at rmsprop_momentum 0.
    momentum: Optional[Dict[str, torch.Tensor]] = None
    # The IMPACT target network by parameter name (plain tensors, distinct
    # from the parameters); None under loss="vtrace" unless a restored
    # checkpoint brought one, which is then carried through unused.
    target_params: Optional[Dict[str, torch.Tensor]] = None


class Learner:
    """Owns the update for one agent.  ``frames_per_update`` =
    batch_size * unroll_length * num_action_repeats."""

    def __init__(self, agent: ImpalaAgent, hp: LearnerHyperparams,
                 frames_per_update: int, env_frames: float = 0.0,
                 scan_impl: str = "auto", fused_forward: bool = True,
                 learn_telemetry: bool = True, loss: str = "vtrace",
                 target_update_interval: int = 100,
                 impact_clip_epsilon: float = 0.3):
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r} (vtrace | impact)")
        if target_update_interval < 1:
            raise ValueError(
                f"target_update_interval must be >= 1, got "
                f"{target_update_interval}")
        self.loss_name = loss
        self._target_update_interval = int(target_update_interval)
        self._impact_clip_epsilon = float(impact_clip_epsilon)
        if scan_impl == "auto":
            scan_impl = "associative"
        if scan_impl not in vtrace.SCAN_IMPLS:
            raise ValueError(
                f"scan_impl {scan_impl!r} is not one of auto, "
                f"{', '.join(vtrace.SCAN_IMPLS)} (time_sharded needs a seq "
                f"mesh axis, not ported yet: ROADMAP.md, queue 1)")
        self.scan_impl = scan_impl
        self._fused_forward = bool(fused_forward)
        self._agent = agent
        self._hp = hp
        self._frames_per_update = float(frames_per_update)
        self._params = dict(agent.named_parameters())
        device = next(agent.parameters()).device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
        self.state = TrainState(
            opt_state={name: torch.ones_like(p)
                       for name, p in self._params.items()},
            env_frames=float(env_frames),
            nonfinite_skips=zero(),
            nonfinite_streak=zero(),
            momentum=({name: torch.zeros_like(p)
                       for name, p in self._params.items()}
                      if hp.rmsprop_momentum else None),
            target_params=(self._copy_params()
                           if loss == "impact" else None))
        if hp.rmsprop_momentum:
            warnings.warn(
                "rmsprop_momentum != 0: the momentum trace accumulates "
                "un-lr-scaled steps (TF accumulates lr-scaled steps), so "
                "updates diverge from the reference while the decayed lr "
                "changes between steps", stacklevel=2)
        # [groups, parameters]: 1 where the parameter is in the group, to
        # sum per-parameter squared norms into LAYER_GROUPS groups.
        groups = [layer_group(name) for name in self._params]
        self._group_matrix = torch.tensor(
            [[float(g == group) for g in groups] for group in LAYER_GROUPS],
            device=device)
        self._devtel_spec = learner_telemetry_spec()
        self._learn_enabled = bool(learn_telemetry)
        self._learn_spec = (learning_telemetry_spec(loss)
                            if self._learn_enabled
                            else DeviceTelemetry("learn"))
        # entropy_frac's normalizer: the uniform policy's entropy.
        self._max_entropy = max(
            float(sum(np.log(s) for s in agent.dist_spec.sizes)), 1e-6)
        self._devtel = merge_init(self.devtel_specs, device)
        self._devtel_publisher = TelemetryPublisher(self.devtel_specs)
        registry = get_registry()
        self._updates_counter = registry.counter(
            "learner/updates_total", "update steps dispatched")
        self._frames_counter = registry.counter(
            "learner/env_frames_total",
            "env frames consumed by dispatched updates")
        self._replayed_counter = registry.counter(
            "learner/replayed_updates_total",
            "update steps dispatched on REPLAYED batches (their frames "
            "were already counted at fresh consumption)")
        if loss == "impact":
            # The anchor cadence, for obs.report's staleness budget.
            registry.gauge(
                "replay/target_update_interval",
                "fresh updates between IMPACT target-network hard "
                "copies (the clipped-target surrogate's anchor "
                "cadence)").set(float(self._target_update_interval))

    def _copy_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as new plain tensors by name."""
        return {name: p.detach().clone() for name, p in self._params.items()}

    # -- device telemetry --------------------------------------------------

    @property
    def devtel_specs(self):
        """Every non-empty spec whose buffers the update carries."""
        return [spec for spec in (self._devtel_spec, self._learn_spec)
                if not spec.empty]

    def fetch_device_telemetry(self) -> Dict[str, np.ndarray]:
        """The telemetry on the host, in one device-to-host copy (which
        waits for the updates issued so far)."""
        return fetch_merged(self.devtel_specs, self._devtel)

    def publish_device_telemetry(self) -> Dict[str, np.ndarray]:
        """Fetch and fold into the metrics registry (``devtel/*``)."""
        fetched = self.fetch_device_telemetry()
        self._devtel_publisher.publish(fetched)
        return fetched

    def _forward(self, trajectory: Trajectory, capture: bool = False):
        """The ONE whole-trajectory unroll of the update: ((logits
        [T+1,B,A], baselines [T+1,B]), dead_torso_frac or None).
        ``capture`` also takes the torso's output from that unroll (a
        forward hook, as JAX's ``capture_intermediates``) for the fraction
        of its units that are <= 0 over the whole batch."""
        captured = []
        handle = (self._agent.convnet.register_forward_hook(
            lambda module, args, out: captured.append(out))
            if capture else None)
        try:
            (logits, baselines), _ = self._agent(
                trajectory.agent_outputs.action, trajectory.env_outputs,
                trajectory.agent_state)
        finally:
            if handle is not None:
                handle.remove()
        dead = None
        if captured:
            conv_out = captured[0].detach().float()
            dead = (conv_out <= 0.0).all(dim=0).float().mean()
        return (logits, baselines), dead

    @torch.no_grad()
    def _comparison_forward(self, trajectory: Trajectory):
        """The two-pass reference's (``fused_forward=False``) separate
        unroll for the quantities V-trace reads, without gradients.  The
        core runs its residual forward here too, the kernel of the
        differentiated unroll, so the two unrolls are equal in value."""
        (logits, baselines), _ = self._agent(
            trajectory.agent_outputs.action, trajectory.env_outputs,
            trajectory.agent_state, residual_core=True)
        return logits, baselines

    @torch.no_grad()
    def _target_forward(self, trajectory: Trajectory):
        """The target network's unroll: the agent over the target tensors,
        without gradients, so the core runs its lean kernel over every
        step and keeps no residuals; its logits [T+1, B, A]."""
        (logits, _), _ = torch.func.functional_call(
            self._agent, self.state.target_params,
            (trajectory.agent_outputs.action, trajectory.env_outputs,
             trajectory.agent_state))
        return logits

    def _loss_impact(self, trajectory: Trajectory):
        """The IMPACT surrogate (JAX ``_loss_impact``): V-trace's
        advantages with the TARGET network as the target policy, then the
        ratio clip of pi_theta against pi_tgt; the baseline and entropy
        terms as in the vtrace branch."""
        hp = self._hp
        (online_logits, baselines), dead_torso = self._forward(
            trajectory, capture=self._learn_enabled)
        if self._fused_forward:
            comparison_baselines = baselines
        else:
            _, comparison_baselines = self._comparison_forward(trajectory)
        anchor_logits = self._target_forward(trajectory)
        bootstrap_value = comparison_baselines[-1]
        behaviour = AgentOutput(*(t[1:] for t in trajectory.agent_outputs))
        env = trajectory.env_outputs
        online_logits = online_logits[:-1]
        anchor_logits = anchor_logits[:-1]
        baselines = baselines[:-1]
        comparison_baselines = comparison_baselines[:-1]
        rewards = losses_lib.clip_rewards(env.reward[1:], hp.reward_clipping)
        discounts = torch.where(
            env.done[1:], torch.zeros_like(rewards),
            torch.full_like(rewards, hp.discounting))
        dist_spec = self._agent.dist_spec
        vt = vtrace.from_logits(
            behaviour_policy_logits=behaviour.policy_logits,
            target_policy_logits=anchor_logits,
            actions=behaviour.action,
            discounts=discounts,
            rewards=rewards,
            values=comparison_baselines,
            bootstrap_value=bootstrap_value,
            clip_rho_threshold=hp.clip_rho_threshold,
            clip_pg_rho_threshold=hp.clip_pg_rho_threshold,
            scan_impl=self.scan_impl,
            dist_spec=dist_spec)
        surrogate = impact_lib.surrogate_from_logits(
            online_logits, anchor_logits, behaviour.action,
            vt.pg_advantages, clip_epsilon=self._impact_clip_epsilon,
            dist_spec=dist_spec)
        baseline_loss = losses_lib.compute_baseline_loss(vt.vs - baselines)
        entropy_loss = losses_lib.compute_entropy_loss(
            online_logits, dist_spec=dist_spec)
        total = (surrogate.loss + hp.baseline_cost * baseline_loss
                 + hp.entropy_cost * entropy_loss)
        metrics = {
            "total_loss": total,
            "policy_gradient_loss": surrogate.loss,
            "baseline_loss": baseline_loss,
            "entropy_loss": entropy_loss,
            "impact_ratio_mean": surrogate.ratio_mean,
            "impact_clip_fraction": surrogate.clip_fraction,
        }
        if self._learn_enabled:
            metrics.update(self._learning_metrics(
                vt, behaviour.policy_logits, online_logits, baselines,
                dist_spec, dead_torso))
            metrics["impact_log_ratio_mean"] = surrogate.log_ratio_mean
            metrics["impact_log_ratio_p95"] = surrogate.log_ratio_p95
            metrics["impact_ess_frac"] = surrogate.ess_frac
        return total, metrics

    def _loss_vtrace(self, trajectory: Trajectory):
        hp = self._hp
        (target_logits, baselines), dead_torso = self._forward(
            trajectory, capture=self._learn_enabled)
        if self._fused_forward:
            comparison_logits, comparison_baselines = (target_logits,
                                                       baselines)
        else:
            comparison_logits, comparison_baselines = (
                self._comparison_forward(trajectory))
        # The last baseline bootstraps; drop the last learner output and
        # the first behaviour/env entry (reference: experiment.py:368-375).
        bootstrap_value = comparison_baselines[-1]
        behaviour = AgentOutput(*(t[1:] for t in trajectory.agent_outputs))
        env = trajectory.env_outputs
        target_logits = target_logits[:-1]
        baselines = baselines[:-1]
        comparison_logits = comparison_logits[:-1]
        comparison_baselines = comparison_baselines[:-1]
        rewards = losses_lib.clip_rewards(env.reward[1:], hp.reward_clipping)
        discounts = torch.where(
            env.done[1:], torch.zeros_like(rewards),
            torch.full_like(rewards, hp.discounting))
        dist_spec = self._agent.dist_spec
        # V-trace reads the comparison quantities (the same tensors in the
        # fused path); it detaches everything it returns.
        vt = vtrace.from_logits(
            behaviour_policy_logits=behaviour.policy_logits,
            target_policy_logits=comparison_logits,
            actions=behaviour.action,
            discounts=discounts,
            rewards=rewards,
            values=comparison_baselines,
            bootstrap_value=bootstrap_value,
            clip_rho_threshold=hp.clip_rho_threshold,
            clip_pg_rho_threshold=hp.clip_pg_rho_threshold,
            scan_impl=self.scan_impl,
            dist_spec=dist_spec)
        pg_loss = losses_lib.compute_policy_gradient_loss(
            target_logits, behaviour.action, vt.pg_advantages,
            dist_spec=dist_spec)
        baseline_loss = losses_lib.compute_baseline_loss(vt.vs - baselines)
        entropy_loss = losses_lib.compute_entropy_loss(
            target_logits, dist_spec=dist_spec)
        total = (pg_loss + hp.baseline_cost * baseline_loss
                 + hp.entropy_cost * entropy_loss)
        metrics = {
            "total_loss": total,
            "policy_gradient_loss": pg_loss,
            "baseline_loss": baseline_loss,
            "entropy_loss": entropy_loss,
        }
        if self._learn_enabled:
            metrics.update(self._learning_metrics(
                vt, behaviour.policy_logits, target_logits, baselines,
                dist_spec, dead_torso))
        return total, metrics

    @torch.no_grad()
    def _learning_metrics(self, vt, behaviour_logits, online_logits,
                          baselines, dist_spec, dead_torso
                          ) -> Dict[str, torch.Tensor]:
        """The learning-dynamics scalars: V-trace's importance
        diagnostics, the policy's entropy (absolute and normalized), KL
        from the behaviour policy, the baseline's explained variance and
        the torso's dead units.  Observation only: detached from the
        loss."""
        diag = vt.diagnostics
        online = online_logits.detach()
        entropy = distributions.entropy(online, dist_spec).mean()
        kl = distributions.kl_divergence(
            behaviour_logits.detach(), online, dist_spec).mean()
        vs = vt.vs
        explained_variance = 1.0 - (
            torch.var(vs - baselines.detach(), unbiased=False)
            / torch.clamp(torch.var(vs, unbiased=False), min=1e-8))
        return {
            "policy_entropy": entropy,
            "entropy_frac": entropy / self._max_entropy,
            "behaviour_kl": kl,
            "explained_variance": explained_variance,
            "rho_clip_fraction": diag.rho_clip_fraction,
            "cs_clip_fraction": diag.cs_clip_fraction,
            "pg_rho_clip_fraction": diag.pg_rho_clip_fraction,
            "log_rho_mean": diag.log_rho_mean,
            "log_rho_p95": diag.log_rho_p95,
            "ess_frac": diag.ess_frac,
            "dead_torso_frac": dead_torso,
        }

    def update(self, trajectory: Trajectory,
               fresh: bool = True) -> Dict[str, torch.Tensor]:
        """One update in place (params, ``nu``, counters, telemetry);
        returns the metrics as 0-d tensors (no host sync).
        ``fresh=False`` marks a replayed batch: the update holds
        ``env_frames`` and the target schedule, whose frames were counted
        when the batch was consumed fresh."""
        with get_tracer().span("learner/update", cat="learner"):
            metrics = self._update(trajectory, fresh)
        self._updates_counter.inc()
        if fresh:
            self._frames_counter.inc(self._frames_per_update)
        else:
            self._replayed_counter.inc()
        get_flight_recorder().record(
            "update", "learner",
            {"update": int(self._updates_counter.value)})
        return metrics

    def _update(self, trajectory: Trajectory,
                fresh: bool = True) -> Dict[str, torch.Tensor]:
        hp = self._hp
        injector = get_fault_injector()
        if injector.active and injector.should_fire("nan_grad"):
            # Chaos: poison this batch's rewards so the loss and every
            # gradient go NaN; the guard must absorb it as a skip.
            env = trajectory.env_outputs
            trajectory = trajectory._replace(env_outputs=env._replace(
                reward=env.reward * float("nan")))
        names = list(self._params)
        params = [self._params[name] for name in names]
        loss_fn = (self._loss_impact if self.loss_name == "impact"
                   else self._loss_vtrace)
        total, metrics = loss_fn(trajectory)
        grads = torch.autograd.grad(total, params)
        state = self.state
        frames = state.env_frames
        lr = hp.learning_rate * max(
            0.0, 1.0 - frames / hp.total_environment_frames)
        # The lr-scaled updates as applied, taken whether or not the
        # guard keeps them (as in JAX), for the update ratios.
        steps = []
        with torch.no_grad():
            finite = torch.isfinite(total)
            for grad in grads:
                finite = finite & torch.isfinite(grad).all()
            decay, eps = hp.rmsprop_decay, hp.rmsprop_epsilon
            momentum = hp.rmsprop_momentum
            for name, param, grad in zip(names, params, grads):
                nu = state.opt_state[name]
                new_nu = decay * nu + (1.0 - decay) * grad * grad
                if momentum:
                    trace = state.momentum[name]
                    new_trace = (-(grad * torch.rsqrt(new_nu + eps))
                                 + momentum * trace)
                    step = lr * new_trace
                    new_param = param + step
                    trace.copy_(torch.where(finite, new_trace, trace))
                else:
                    step = lr * (grad * torch.rsqrt(new_nu + eps))
                    new_param = param - step
                param.copy_(torch.where(finite, new_param, param))
                nu.copy_(torch.where(finite, new_nu, nu))
                steps.append(step)
            skipped = 1.0 - finite.float()
            state.nonfinite_skips = state.nonfinite_skips + skipped
            state.nonfinite_streak = torch.where(
                finite, torch.zeros_like(skipped),
                state.nonfinite_streak + 1.0)
            grad_sq = self._group_sq(grads)
            grad_norm = torch.sqrt(grad_sq.sum())
            if self.loss_name == "impact" and fresh:
                # The hard copy: the updated (or, after a skip, the kept)
                # parameters overwrite the target every interval-th fresh
                # update, keyed on the frame count as in JAX.  The frame
                # count is a host float, so the schedule is decided here
                # and the copy needs no host sync.
                k_next = (frames + self._frames_per_update) \
                    / self._frames_per_update
                if round(k_next) % self._target_update_interval == 0:
                    torch._foreach_copy_(
                        [state.target_params[name] for name in names],
                        params)
        if fresh:
            state.env_frames = frames + self._frames_per_update
        metrics = {name: value.detach() for name, value in metrics.items()}
        metrics.update(
            learning_rate=torch.tensor(lr, dtype=torch.float64),
            grad_norm=grad_norm,
            update_skipped=skipped,
            nonfinite_skips=state.nonfinite_skips,
            nonfinite_streak=state.nonfinite_streak,
            env_frames=torch.tensor(state.env_frames, dtype=torch.float64))
        self._accumulate_telemetry(metrics, grad_sq, steps, params)
        return metrics

    def _group_sq(self, tensors) -> torch.Tensor:
        """Squared L2 norms summed per LAYER_GROUPS group, [groups]: the
        per-tensor norms in one multi-tensor launch, then one weighted
        sum."""
        norms = torch.stack(torch._foreach_norm(list(tensors)))
        return (self._group_matrix * norms.square()).sum(dim=1)

    @torch.no_grad()
    def _accumulate_telemetry(self, metrics, grad_sq, steps,
                              params) -> None:
        """Fold this update into the device telemetry, in place on the
        learner's stream (no host sync).  A non-finite grad norm stays
        out of the histogram: its sum is cumulative."""
        spec, tel = self._devtel_spec, self._devtel
        spec.inc(tel, "updates")
        spec.set(tel, "loss", metrics["total_loss"])
        grad_norm = metrics["grad_norm"]
        spec.observe(tel, "grad_norm", grad_norm,
                     where=torch.isfinite(grad_norm))
        spec.inc(tel, "skipped", metrics["update_skipped"])
        if not self._learn_enabled:
            return
        gauges = {name: metrics[name] for name in (
            "entropy_frac", "ess_frac", "explained_variance",
            "rho_clip_fraction", "cs_clip_fraction", "pg_rho_clip_fraction",
            "log_rho_mean", "log_rho_p95", "dead_torso_frac")}
        gauges["kl"] = metrics["behaviour_kl"]
        if self.loss_name == "impact":
            # Histograms, so the fetch aggregates every update since the
            # last one.
            for hist, key in (("impact_ratio", "impact_ratio_mean"),
                              ("impact_clip_fraction",
                               "impact_clip_fraction")):
                value = metrics[key]
                self._learn_spec.observe(tel, hist, value,
                                         where=torch.isfinite(value))
            gauges["impact_log_ratio_p95"] = metrics["impact_log_ratio_p95"]
            gauges["impact_ess_frac"] = metrics["impact_ess_frac"]
        grad_norms = grad_sq.sqrt()
        param_norms = self._group_sq(params).sqrt()
        ratios = self._group_sq(steps).sqrt() / (param_norms + 1e-8)
        for i, group in enumerate(LAYER_GROUPS):
            gauges[f"grad_norm_{group}"] = grad_norms[i]
            gauges[f"param_norm_{group}"] = param_norms[i]
            gauges[f"update_ratio_{group}"] = ratios[i]
        self._learn_spec.set_many(tel, gauges)

    def state_dict(self) -> Dict[str, object]:
        """Everything a checkpoint holds: parameters, RMSProp ``nu`` and,
        at ``rmsprop_momentum != 0``, the momentum trace, and where the run
        keeps one the IMPACT target network (each by parameter name),
        ``env_frames`` and the non-finite counters.  The tensors are the
        live ones, not copies."""
        state = self.state
        saved = {
            "params": dict(self._params),
            "opt_state": dict(state.opt_state),
            "env_frames": state.env_frames,
            "nonfinite_skips": state.nonfinite_skips,
            "nonfinite_streak": state.nonfinite_streak,
        }
        if state.momentum is not None:
            saved["momentum"] = dict(state.momentum)
        if state.target_params is not None:
            saved["target_params"] = dict(state.target_params)
        return saved

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, object]) -> None:
        """Copy a ``state_dict`` (on any device) into this learner.  A
        momentum trace saved and none wanted, or the other way round,
        raises: a resume never drops a trace or starts a fresh one.  The
        target network migrates both ways, as the JAX package's does: an
        impact run restoring a state without one starts it from the
        restored parameters; a vtrace run keeps a restored one, unused,
        so its next checkpoint still holds it."""
        theirs, ours = "momentum" in saved, self.state.momentum is not None
        if theirs != ours:
            raise ValueError(
                f"checkpoint holds {'a' if theirs else 'no'} RMSProp "
                f"momentum trace but this run has rmsprop_momentum="
                f"{self._hp.rmsprop_momentum}: resume with the "
                f"rmsprop_momentum the checkpoint was trained with")
        groups = {"params": self._params, "opt_state": self.state.opt_state}
        if ours:
            groups["momentum"] = self.state.momentum
        if "target_params" in saved:
            if self.state.target_params is None:
                self.state.target_params = {
                    name: torch.empty_like(p)
                    for name, p in self._params.items()}
            groups["target_params"] = self.state.target_params
        elif self.loss_name == "vtrace":
            self.state.target_params = None
        for group, tensors in groups.items():
            if set(saved[group]) != set(tensors):
                raise ValueError(
                    f"checkpoint {group} names differ from the agent's: "
                    f"{sorted(set(saved[group]) ^ set(tensors))}")
            for name, tensor in tensors.items():
                tensor.copy_(saved[group][name])
        state = self.state
        if self.loss_name == "impact" and "target_params" not in saved:
            torch._foreach_copy_(
                [state.target_params[name] for name in self._params],
                list(self._params.values()))
        state.env_frames = float(saved["env_frames"])
        for key in ("nonfinite_skips", "nonfinite_streak"):
            getattr(state, key).copy_(torch.as_tensor(saved[key]))


class NonFiniteTracker:
    """The host side of the non-finite guard.

    The update carries cumulative and consecutive skip counters and puts
    them in its metrics; the driver hands this tracker the metrics it
    fetches at log time anyway.  It counts the skips (``skips_total``, the
    registry's ``learner/nonfinite_skips_total``, a flight-recorder event)
    and answers the one policy question: has the consecutive-skip streak
    reached ``tolerance`` (the caller rolls back or exits)?
    ``tolerance=0`` disables the policy; skips are still counted.  The
    counterpart of ``scalable_agent_tpu/runtime/learner.py``'s tracker.
    """

    def __init__(self, tolerance: int, registry=None):
        self.tolerance = int(tolerance)
        self.skips_total = 0.0
        self._last_total = 0.0
        self._counter = (registry or get_registry()).counter(
            "learner/nonfinite_skips_total",
            "updates skipped by the non-finite guard (params/opt_state "
            "held, env frames still retired)")

    def observe(self, host_metrics: Dict[str, float]) -> bool:
        """Fold one fetched metrics dict in; True when the consecutive
        streak has reached the tolerance."""
        total = float(host_metrics.get("nonfinite_skips", 0.0))
        streak = float(host_metrics.get("nonfinite_streak", 0.0))
        delta = total - self._last_total
        if delta > 0:
            self.skips_total += delta
            self._counter.inc(delta)
            get_flight_recorder().record(
                "nonfinite_skip", "learner",
                {"skips_total": total, "streak": streak})
        self._last_total = max(self._last_total, total)
        return bool(self.tolerance > 0 and streak >= self.tolerance)

    def rebase(self, total: float):
        """Re-anchor after a rollback or a resume: the restored state's
        cumulative counter is older than what was already counted, and
        the next ``observe`` must not count the gap twice."""
        self._last_total = float(total)
