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
- The non-finite guard: a NaN/Inf loss or gradient makes the update a
  no-op on params and ``nu`` (frames still advance), counted in
  ``nonfinite_skips``/``nonfinite_streak`` without a host sync.

V-trace's recurrence follows ``scan_impl`` (``ops/vtrace.py``): ``"auto"``
resolves to ``"associative"``, as the JAX learner resolves it on a mesh
without a seq axis (the port has none); ``"pallas"`` runs the fused CUDA
kernel (``ops/vtrace_cuda.py``).

The parameters live in the agent module; ``TrainState`` holds what the JAX
TrainState holds besides them.  ``state_dict``/``load_state_dict`` give the
whole of it (parameters included) for checkpoints.  Device telemetry and
the learning-dynamics metrics are not ported yet (ROADMAP.md, queue 1).
"""

import dataclasses
from typing import Dict, NamedTuple

import torch

from scalable_agent_tpu_torch.models.agent import ImpalaAgent
from scalable_agent_tpu_torch.ops import losses as losses_lib
from scalable_agent_tpu_torch.ops import vtrace
from scalable_agent_tpu_torch.types import AgentOutput, AgentState, StepOutput


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
    rmsprop_epsilon: float = 0.1
    clip_rho_threshold: float = 1.0
    clip_pg_rho_threshold: float = 1.0


@dataclasses.dataclass
class TrainState:
    """Optimizer state and counters.  ``env_frames`` is a host float: it
    advances by ``frames_per_update`` per update and needs no device
    value."""

    opt_state: Dict[str, torch.Tensor]  # RMSProp nu, by parameter name
    env_frames: float
    nonfinite_skips: torch.Tensor  # f32 scalars on the params' device
    nonfinite_streak: torch.Tensor


class Learner:
    """Owns the update for one agent.  ``frames_per_update`` =
    batch_size * unroll_length * num_action_repeats."""

    def __init__(self, agent: ImpalaAgent, hp: LearnerHyperparams,
                 frames_per_update: int, env_frames: float = 0.0,
                 scan_impl: str = "auto"):
        if scan_impl == "auto":
            scan_impl = "associative"
        if scan_impl not in vtrace.SCAN_IMPLS:
            raise ValueError(
                f"scan_impl {scan_impl!r} is not one of auto, "
                f"{', '.join(vtrace.SCAN_IMPLS)} (time_sharded needs a seq "
                f"mesh axis, not ported yet: ROADMAP.md, queue 1)")
        self.scan_impl = scan_impl
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
            nonfinite_streak=zero())

    def _forward(self, trajectory: Trajectory):
        """The ONE whole-trajectory unroll of the update: (logits [T+1,B,A],
        baselines [T+1,B])."""
        (logits, baselines), _ = self._agent(
            trajectory.agent_outputs.action, trajectory.env_outputs,
            trajectory.agent_state)
        return logits, baselines

    def _loss_vtrace(self, trajectory: Trajectory):
        hp = self._hp
        target_logits, baselines = self._forward(trajectory)
        # The last baseline bootstraps; drop the last learner output and
        # the first behaviour/env entry (reference: experiment.py:368-375).
        bootstrap_value = baselines[-1]
        behaviour = AgentOutput(*(t[1:] for t in trajectory.agent_outputs))
        env = trajectory.env_outputs
        target_logits = target_logits[:-1]
        baselines = baselines[:-1]
        rewards = losses_lib.clip_rewards(env.reward[1:], hp.reward_clipping)
        discounts = torch.where(
            env.done[1:], torch.zeros_like(rewards),
            torch.full_like(rewards, hp.discounting))
        dist_spec = self._agent.dist_spec
        vt = vtrace.from_logits(
            behaviour_policy_logits=behaviour.policy_logits,
            target_policy_logits=target_logits,
            actions=behaviour.action,
            discounts=discounts,
            rewards=rewards,
            values=baselines,
            bootstrap_value=bootstrap_value,
            clip_rho_threshold=hp.clip_rho_threshold,
            clip_pg_rho_threshold=hp.clip_pg_rho_threshold,
            scan_impl=self.scan_impl)
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
        return total, metrics

    def update(self, trajectory: Trajectory) -> Dict[str, torch.Tensor]:
        """One update in place (params, ``nu``, counters); returns the
        metrics as 0-d tensors (no host sync)."""
        hp = self._hp
        names = list(self._params)
        params = [self._params[name] for name in names]
        total, metrics = self._loss_vtrace(trajectory)
        grads = torch.autograd.grad(total, params)
        state = self.state
        frames = state.env_frames
        lr = hp.learning_rate * max(
            0.0, 1.0 - frames / hp.total_environment_frames)
        with torch.no_grad():
            finite = torch.isfinite(total)
            for grad in grads:
                finite = finite & torch.isfinite(grad).all()
            decay, eps = hp.rmsprop_decay, hp.rmsprop_epsilon
            for name, param, grad in zip(names, params, grads):
                nu = state.opt_state[name]
                new_nu = decay * nu + (1.0 - decay) * grad * grad
                new_param = param - lr * (grad * torch.rsqrt(new_nu + eps))
                param.copy_(torch.where(finite, new_param, param))
                nu.copy_(torch.where(finite, new_nu, nu))
            skipped = 1.0 - finite.float()
            state.nonfinite_skips = state.nonfinite_skips + skipped
            state.nonfinite_streak = torch.where(
                finite, torch.zeros_like(skipped),
                state.nonfinite_streak + 1.0)
            grad_norm = torch.sqrt(sum(grad.square().sum() for grad in grads))
        state.env_frames = frames + self._frames_per_update
        metrics = {name: value.detach() for name, value in metrics.items()}
        metrics.update(
            learning_rate=torch.tensor(lr, dtype=torch.float64),
            grad_norm=grad_norm,
            update_skipped=skipped,
            nonfinite_skips=state.nonfinite_skips,
            nonfinite_streak=state.nonfinite_streak,
            env_frames=torch.tensor(state.env_frames, dtype=torch.float64))
        return metrics

    def state_dict(self) -> Dict[str, object]:
        """Everything a checkpoint holds: parameters, RMSProp ``nu`` (both
        by parameter name), ``env_frames`` and the non-finite counters.
        The tensors are the live ones, not copies."""
        state = self.state
        return {
            "params": dict(self._params),
            "opt_state": dict(state.opt_state),
            "env_frames": state.env_frames,
            "nonfinite_skips": state.nonfinite_skips,
            "nonfinite_streak": state.nonfinite_streak,
        }

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, object]) -> None:
        """Copy a ``state_dict`` (on any device) into this learner."""
        for group in ("params", "opt_state"):
            ours = (self._params if group == "params"
                    else self.state.opt_state)
            if set(saved[group]) != set(ours):
                raise ValueError(
                    f"checkpoint {group} names differ from the agent's: "
                    f"{sorted(set(saved[group]) ^ set(ours))}")
            for name, tensor in ours.items():
                tensor.copy_(saved[group][name])
        state = self.state
        state.env_frames = float(saved["env_frames"])
        for key in ("nonfinite_skips", "nonfinite_streak"):
            getattr(state, key).copy_(torch.as_tensor(saved[key]))
