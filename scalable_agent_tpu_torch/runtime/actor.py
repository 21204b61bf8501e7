"""Actors: batched inference over a group of envs, packed into [T+1, B]
trajectories.

The counterpart of ``scalable_agent_tpu/runtime/actor.py::VectorActor``.
Each unroll starts with the previous unroll's last entry (the T+1 overlap,
reference: experiment.py:311-321), and the first-ever unroll bootstraps
from a zero action and a zero agent output (experiment.py:243-251).
Inference runs ``actor_step`` under ``torch.no_grad()``, so the LSTM core
takes its lean kernel.  ActorPool threads, prefetch and the service are
not ported yet (ROADMAP.md, queue 1).
"""

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.vector import MultiEnv
from scalable_agent_tpu_torch.models.agent import (
    ImpalaAgent,
    actor_step,
    initial_state,
)
from scalable_agent_tpu_torch.types import (
    ActorOutput,
    AgentOutput,
    AgentState,
    map_structure,
)


def to_numpy(tree):
    return map_structure(
        lambda t: None if t is None else t.detach().cpu().numpy(), tree)


def to_device(tree, device):
    """Host arrays -> tensors on ``device`` (None stays None)."""
    return map_structure(
        lambda a: None if a is None else torch.as_tensor(a, device=device),
        tree)


def _stack_time(entries):
    """List of [B, ...] tuples -> one [T, B, ...] tuple."""
    return map_structure(
        lambda *xs: None if xs[0] is None else np.stack(xs), *entries)


class VectorActor:
    """One env group: batched inference + trajectory accumulation."""

    def __init__(self, agent: ImpalaAgent, envs: MultiEnv,
                 unroll_length: int, level_name: str = "", seed: int = 0):
        self._agent = agent
        self._envs = envs
        self._unroll_length = unroll_length
        self.level_name = level_name
        self._device = next(agent.parameters()).device
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._last_env_output = None
        self._last_agent_output = None
        self._core_state = None

    def _bootstrap(self):
        batch = self._envs.num_envs
        self._last_env_output = self._envs.initial()
        self._core_state = initial_state(batch, self._agent.core_size,
                                         self._device)
        self._last_agent_output = AgentOutput(
            action=np.zeros((batch,), np.int64),
            policy_logits=np.zeros((batch, self._agent.num_logits),
                                   np.float32),
            baseline=np.zeros((batch,), np.float32))

    def run_unroll(self) -> ActorOutput:
        """Generate one [T+1, B] trajectory batch (numpy) under the agent's
        current weights."""
        if self._last_env_output is None:
            self._bootstrap()
        env_entries = [self._last_env_output]
        agent_entries = [self._last_agent_output]
        first_state = to_numpy(self._core_state)
        env_output = self._last_env_output
        agent_output = self._last_agent_output
        core_state = self._core_state
        for _ in range(self._unroll_length):
            out, core_state = actor_step(
                self._agent, self._generator,
                torch.as_tensor(agent_output.action, device=self._device),
                to_device(env_output, self._device), core_state)
            agent_output = to_numpy(out)
            self._envs.step_send(agent_output.action)
            env_output = self._envs.step_recv()
            env_entries.append(env_output)
            agent_entries.append(agent_output)
        self._last_env_output = env_output
        self._last_agent_output = agent_output
        self._core_state = core_state
        return ActorOutput(
            level_name=self.level_name,
            agent_state=AgentState(*first_state),
            env_outputs=_stack_time(env_entries),
            agent_outputs=_stack_time(agent_entries))

    def close(self):
        self._envs.close()
