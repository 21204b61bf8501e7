"""In-graph training: the rollout and the IMPALA update on the card, with
no host traffic inside a dispatch.

The counterpart of ``scalable_agent_tpu/runtime/ingraph.py``.  With a
device env (``envs/device/``) the whole actor side (T inference steps, T
env transitions, the trajectory's assembly) and the learner's update run on
the card, one after the other, through the port's kernels: the lean step
kernel in every rollout step, the residual forward, the BPTT, the stem's
grad-W and, under ``--scan_impl=pallas``, V-trace's kernel in the update.
The host only issues the work; nothing is read back inside a dispatch, so
dispatches queue on the card back to back and the caller fetches metrics
on its own cadence.  JAX compiles a dispatch into one program; here it is
a Python loop of eager launches whose order is the program.

As in JAX:

- The trajectory is the reference's T+1 overlap layout (entry 0 of unroll
  k+1 is the last entry of unroll k, reference: experiment.py:311-321),
  carried by ``RolloutCarry``.  Episode sums and the env telemetry read
  the ``[1:]`` slice: entry 0 was the previous unroll's last step.
- The rollout runs under the current parameters (no policy lag);
  V-trace corrects whatever gap there is, as in the host backend.
- The megaloop: one dispatch runs K = ``updates_per_dispatch`` iterations
  (rollout, update).  K updates are bit-exact with K dispatches of 1 (the
  same loop body in the same order).  The gauges are the last update's;
  the episode stats aggregate over all K unrolls; the non-finite streak's
  peak over the dispatch rides ``TrainCarry.streak_peak``, so a streak that
  reaches the tolerance and resets inside a dispatch is still seen.
- Sampling is keyed by the global update index: each update re-seeds the
  trainer's generator (a CUDA ``torch.Generator`` on the card) from (seed,
  update index) and draws its T steps in order, the contract of JAX's
  ``fold_in(key(seed), update_index)`` then ``fold_in(., t)``: K
  dispatches of 1 and a resume continue the same stream.  The draws are
  not JAX's threefry bits.
- ``nan_grad`` (``runtime/faults.py``) is matched against the global
  update index (occurrence n poisons update n-1's rewards), not counted
  per evaluation, and not in ``faults/injected_total``.
- ``emit_trajectory`` hands each dispatch's trajectory to the replay slab
  and the numerics sentinel; it needs K = 1 (replayed updates and audits
  interleave between dispatches).

The profiler sees ``record_function`` ranges ``actor_inference`` and
``env_step`` around each rollout step and ``learner_update`` around the
update (the JAX named scopes); the tracer's ``learner/update`` span covers
a whole iteration, so the kernel table (``obs/kernels.py``) takes the
dispatch as its module, as the JAX ledger does.
"""

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.device.accounting import (
    env_telemetry_spec,
    record_episode_telemetry,
)
from scalable_agent_tpu_torch.models.agent import (
    ImpalaAgent,
    actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.obs import TelemetryPublisher, get_tracer
from scalable_agent_tpu_torch.obs.device_telemetry import (
    fetch_merged,
    merge_init,
)
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector
from scalable_agent_tpu_torch.runtime.learner import Learner, Trajectory
from scalable_agent_tpu_torch.types import AgentOutput, map_structure

__all__ = ["InGraphTrainer", "RolloutCarry", "TrainCarry", "update_seed"]


class RolloutCarry(NamedTuple):
    """What flows from one unroll into the next, all [B]."""

    env_state: Any
    env_output: Any  # StepOutput
    agent_output: AgentOutput
    core_state: Any  # AgentState


class TrainCarry(NamedTuple):
    """A dispatch's carry: the rollout's, the env telemetry's buffers
    (updated in place on the card, fetched at the log cadence; the
    learner keeps its own), and the worst non-finite streak seen since the
    host last acted on it (a float32 scalar on the card; the driver resets
    it to 0 on a rollback, the one action that forgives a breach)."""

    rollout: RolloutCarry
    telemetry: Dict[str, torch.Tensor]
    streak_peak: torch.Tensor


def update_seed(seed: int, update_index: int) -> int:
    """The rollout generator's seed for one update: (seed, update index)
    packed into 64 bits, one stream per update."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(update_index)
                                               & 0xFFFFFFFF)


def _stack_first(first, seq: List):
    """A [B] entry and T [B] entries -> [T+1, B], leaf by leaf."""
    return map_structure(
        lambda f, *rest: None if f is None else torch.stack((f,) + rest),
        first, *seq)


class InGraphTrainer:
    """The in-graph (rollout + update) dispatch for a device env.

    ``env`` follows the DeviceEnv protocol (``envs/device/protocol.py``):
    ``initial(seeds) -> (state, StepOutput[B])`` and ``step(state, action)
    -> (state, StepOutput[B])``, tensor operations on the seeds' device.
    The learner owns the parameters and the optimizer state; the trainer
    owns the rollout carry.
    """

    def __init__(self, agent: ImpalaAgent, learner: Learner, env,
                 unroll_length: int, batch: int, seed: int = 0,
                 emit_trajectory: bool = False,
                 updates_per_dispatch: int = 1):
        self._agent = agent
        self._learner = learner
        self._env = env
        self._unroll_length = int(unroll_length)
        self._batch = int(batch)
        self._seed = int(seed)
        self._updates_per_dispatch = int(updates_per_dispatch)
        if self._updates_per_dispatch < 1:
            raise ValueError(
                f"updates_per_dispatch must be >= 1, got "
                f"{updates_per_dispatch}")
        self._emit_trajectory = bool(emit_trajectory)
        if self._emit_trajectory and self._updates_per_dispatch > 1:
            raise ValueError(
                "emit_trajectory requires updates_per_dispatch == 1: "
                "replayed updates interleave with fresh ones on the "
                "host side, between dispatches")
        self._device = next(agent.parameters()).device
        self._generator = torch.Generator(device=self._device)
        self._env_tel_spec = env_telemetry_spec()
        self._tel_publisher = TelemetryPublisher([self._env_tel_spec])

    def rebind(self, agent: ImpalaAgent, learner: Learner) -> None:
        """Run on another agent and learner from the next dispatch (the
        numerics sentinel's demotion).  The rollout carry and the env
        telemetry ride on: the env state is not the learner's, and the
        rollout's draws are keyed by the update index."""
        self._agent, self._learner = agent, learner

    # -- initialization ----------------------------------------------------

    def init(self) -> TrainCarry:
        """The carry of a new run: envs seeded ``seed + i``, the agent's
        zero action and zero carry, zeroed telemetry."""
        seeds = np.arange(self._batch, dtype=np.int32) + self._seed
        env_state, env_output = self._env.initial(seeds,
                                                  device=self._device)
        agent_output = AgentOutput(
            action=self._agent.zero_actions(self._batch).to(self._device),
            policy_logits=torch.zeros(
                (self._batch, self._agent.num_logits), device=self._device),
            baseline=torch.zeros((self._batch,), device=self._device))
        core_state = initial_state(self._batch, self._agent.core_size,
                                   self._device)
        return TrainCarry(
            rollout=RolloutCarry(env_state, env_output, agent_output,
                                 core_state),
            telemetry=merge_init([self._env_tel_spec], self._device),
            streak_peak=torch.zeros((), device=self._device))

    # -- the dispatch ------------------------------------------------------

    def _rollout(self, carry: RolloutCarry, generator: torch.Generator):
        """T steps of inference and env transitions -> (the [T+1, B]
        trajectory, the carry of the next unroll)."""
        env_seq, agent_seq = [], []
        c = carry
        for _ in range(self._unroll_length):
            with torch.profiler.record_function("actor_inference"):
                out, core = actor_step(self._agent, generator,
                                       c.agent_output.action, c.env_output,
                                       c.core_state)
            with torch.profiler.record_function("env_step"):
                env_state, env_output = self._env.step(c.env_state,
                                                       out.action)
            c = RolloutCarry(env_state, env_output, out, core)
            env_seq.append(env_output)
            agent_seq.append(out)
        trajectory = Trajectory(
            agent_state=carry.core_state,
            env_outputs=_stack_first(carry.env_output, env_seq),
            agent_outputs=_stack_first(carry.agent_output, agent_seq))
        return trajectory, c

    def _one_update(self, rollout: RolloutCarry, telemetry,
                    update_index: int):
        """One iteration of the megaloop: the rollout under the current
        parameters, then the update.  ``update_index`` is the global
        update count (it keys the rollout's draws and ``nan_grad``)."""
        self._generator.manual_seed(update_seed(self._seed, update_index))
        with get_tracer().span("learner/update", cat="learner"):
            trajectory, rollout = self._rollout(rollout, self._generator)
            injector = get_fault_injector()
            if (injector.active
                    and update_index + 1 in injector.occurrences(
                        "nan_grad")):
                # Chaos: poison this batch's rewards, keyed on the global
                # update index (the host backend's hook lives in
                # Learner.update, which this call skips).
                env = trajectory.env_outputs
                trajectory = trajectory._replace(env_outputs=env._replace(
                    reward=env.reward * float("nan")))
            # The [1:] slice drops the overlap entry, the previous
            # unroll's last step, which was counted there.
            emitted = map_structure(
                lambda t: None if t is None else t[1:],
                trajectory.env_outputs)
            record_episode_telemetry(self._env_tel_spec, telemetry, emitted)
            with torch.profiler.record_function("learner_update"):
                metrics = self._learner.update(trajectory, ingraph=True)
        finished = emitted.done & (emitted.info.episode_step > 0)
        episode_sums = (
            finished.sum(),
            torch.where(finished, emitted.info.episode_return, 0.0).sum(),
            torch.where(finished, emitted.info.episode_step, 0).sum().to(
                torch.float32))
        return rollout, metrics, episode_sums, trajectory

    def train_step(self, carry: TrainCarry, counter: int):
        """One dispatch of K updates, the first at global update index
        ``counter``: ``(carry, metrics)``, and the trajectory with
        ``emit_trajectory``.  Nothing is read back to the host."""
        rollout, peak = carry.rollout, carry.streak_peak
        sums = []
        for k in range(self._updates_per_dispatch):
            rollout, metrics, episode_sums, trajectory = self._one_update(
                rollout, carry.telemetry, counter + k)
            # The tolerance contract: the monotone peak of the streak, so
            # a breach inside the dispatch is seen at its end.
            peak = torch.maximum(peak, metrics["nonfinite_streak"])
            sums.append(episode_sums)
        count, return_sum, frames_sum = (torch.stack(parts).sum()
                                         for parts in zip(*sums))
        denom = torch.clamp(count, min=1).to(torch.float32)
        metrics = dict(metrics, episodes_completed=count,
                       episode_return=return_sum / denom,
                       episode_frames=frames_sum / denom,
                       nonfinite_streak_peak=peak)
        out = TrainCarry(rollout, carry.telemetry, peak)
        if self._emit_trajectory:
            return out, metrics, trajectory
        return out, metrics

    def replay_step(self, trajectory: Trajectory) -> Dict[str, torch.Tensor]:
        """One replayed update (``env_frames`` and the target schedule
        held: ``Learner.update(fresh=False)``)."""
        return self._learner.update(trajectory, fresh=False, ingraph=True)

    # -- host loop ---------------------------------------------------------

    def run(self, carry: TrainCarry, num_updates: int,
            counter_start: int = 0, on_trajectory=None):
        """Issue ``num_updates`` updates in dispatches of K without a host
        sync; the caller decides when to read the metrics.  An
        ``emit_trajectory`` trainer hands each dispatch's trajectory to
        ``on_trajectory`` (e.g. ``replay.insert``) and refuses to run
        without one: dropping them silently would starve the replay."""
        if self._emit_trajectory and on_trajectory is None:
            raise ValueError(
                "this trainer emits trajectories (emit_trajectory=True) "
                "but run() was given no on_trajectory sink; pass one "
                "(e.g. replay.insert) or call train_step directly")
        k = self._updates_per_dispatch
        if num_updates % k:
            raise ValueError(
                f"num_updates {num_updates} not divisible by "
                f"updates_per_dispatch {k}")
        metrics: Optional[Dict[str, torch.Tensor]] = None
        for i in range(0, num_updates, k):
            result = self.train_step(carry, counter_start + i)
            carry, metrics = result[:2]
            if self._emit_trajectory:
                on_trajectory(result[2])
        return carry, metrics

    # -- telemetry (host side, at the log cadence) -------------------------

    def fetch_telemetry(self, carry: TrainCarry) -> Dict[str, np.ndarray]:
        """The env instruments riding ``carry`` and the learner's, on the
        host (one copy each; it waits for the work issued so far)."""
        fetched = fetch_merged([self._env_tel_spec], carry.telemetry)
        fetched.update(self._learner.fetch_device_telemetry())
        return fetched

    def publish_telemetry(self, carry: TrainCarry) -> Dict[str, np.ndarray]:
        """``fetch_telemetry`` folded into the metrics registry:
        ``devtel/env/*`` and the learner's ``devtel/*``."""
        fetched = self.fetch_telemetry(carry)
        self._tel_publisher.publish(fetched)
        self._learner.publish_device_telemetry(fetched)
        return fetched
