"""Shared machinery of the hand-written device worlds.

The counterpart of ``scalable_agent_tpu/envs/device/world.py``.
``DeviceWorld`` is the chassis under the gridworld and MinAtar families.
Subclasses write three functions over ``[B]`` batched state (the JAX
package writes them for one env and vmaps them; here the batch axis is
written out): ``_reset(seed, episode) -> state``, ``_substep(state,
action) -> (state, reward, terminated)`` and ``_frame(state) -> uint8
[B, H, W, C]``.  The chassis supplies the rest of the protocol
(``envs/device/protocol.py``): the action-repeat loop (masked sub-steps,
summed rewards, early stop), the reset on done, the emitted-against-carried
episode accounting, and an ``initial`` whose tensors share no storage.

A state is a NamedTuple of tensors with the batch first; it carries the
five accounting fields the consumers read (``seed``, ``episode``, ``step``,
``episode_return``, ``episode_step``), int32 but for the float32 return.

Randomness is hashed, not carried: ``_mix``/``_rand_below``/``_uniform``
are counter-based draws (FNV-1a and a murmur avalanche in uint32), pure
functions of the (seed, episode, step, tag) terms the caller mixes.
torch has little uint32 arithmetic on CUDA, so the hash runs in int64 and
keeps the low 32 bits after every multiply (the largest product,
0xFFFFFFFF * 0x5BD1E995, is below 2**63): the draws equal the JAX
package's uint32 wraparound for the same terms, bit for bit.  Any int32
seed is valid (``max_seed`` is the whole int32 range).
"""

from typing import Tuple

import torch

from scalable_agent_tpu_torch.envs.device.protocol import DeviceEnvSpec
from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)

__all__ = ["DeviceWorld", "_mix", "_rand_below", "_uniform", "batch_where",
           "torch_dtype"]

_MASK = 0xFFFFFFFF


def _u32(term):
    """A term's uint32 value (two's complement for negatives) in int64."""
    if isinstance(term, torch.Tensor):
        return term.to(torch.int64) & _MASK
    return int(term) & _MASK


def _mix(*terms) -> torch.Tensor:
    """FNV-1a over the terms and a murmur-style avalanche: uint32 values
    in an int64 tensor."""
    h = 2166136261
    for term in terms:
        h = ((h ^ _u32(term)) * 16777619) & _MASK
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & _MASK
    return h ^ (h >> 15)


def _rand_below(n, *terms) -> torch.Tensor:
    """Hashed int32 in [0, n); ``n`` may be a tensor (>= 1)."""
    return (_mix(*terms) % _u32(n)).to(torch.int32)


def _uniform(*terms) -> torch.Tensor:
    """Hashed float32 in [0, 1)."""
    return (_mix(*terms) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def batch_where(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` leaf by leaf over two states of the
    same type, ``cond`` [B] broadcast over each leaf's trailing axes."""
    def pick(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
        return torch.where(c, a, b)

    return type(new)(*(pick(a, b) for a, b in zip(new, old)))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (a spec's)."""
    import numpy as np

    return torch.from_numpy(np.zeros((), dtype)).dtype


def as_seeds(seeds, max_seed: int, device=None) -> torch.Tensor:
    """Seeds as an int32 tensor; seeds given on the host (a sequence, an
    array or a CPU tensor) are checked against ``max_seed`` there, a card
    tensor is taken as it is (reading it would be a host sync)."""
    if isinstance(seeds, torch.Tensor) and seeds.device.type != "cpu":
        return seeds.to(torch.int32)
    host = torch.as_tensor(seeds).to(torch.int64)
    if bool((host.abs() > max_seed).any()):
        raise ValueError(
            f"device env seeds must stay below {max_seed} for exact "
            f"host-mirror arithmetic")
    return host.to(device=device, dtype=torch.int32)


class DeviceWorld:
    """Protocol chassis; see the module docstring.  Subclasses set
    ``num_actions``, ``action_space``, ``observation_spec``,
    ``episode_length``, ``num_action_repeats`` and ``max_seed``."""

    @property
    def spec(self) -> DeviceEnvSpec:
        return DeviceEnvSpec(
            observation_spec=self.observation_spec,
            action_space=self.action_space,
            num_actions=self.num_actions)

    def _effective_action(self, state, action):
        """Hook for action stochasticity (sticky actions); the identity
        by default."""
        return action

    def initial(self, seeds, device=None) -> Tuple[object, StepOutput]:
        """Reset every env (episode 0); ``seeds`` [B] int, on ``device``
        unless they are a tensor already."""
        seeds = as_seeds(seeds, self.max_seed, device)
        b = seeds.shape[0]
        state = self._reset(seeds, torch.zeros_like(seeds))
        # One tensor of its own per leaf: a reset builds equal constant
        # leaves from one value.
        state = type(state)(*(t.clone() for t in state))
        zero_i = lambda: torch.zeros((b,), dtype=torch.int32,
                                     device=seeds.device)
        zero_f = lambda: torch.zeros((b,), dtype=torch.float32,
                                     device=seeds.device)
        output = StepOutput(
            reward=zero_f(),
            info=StepOutputInfo(episode_return=zero_f(),
                                episode_step=zero_i()),
            done=torch.ones((b,), dtype=torch.bool, device=seeds.device),
            observation=Observation(frame=self._frame(state)))
        return state, output

    def step(self, state, action) -> Tuple[object, StepOutput]:
        """One agent step of every env: ``num_action_repeats`` masked
        sub-steps with summed rewards and early stop, then the reset where
        done and the episode accounting."""
        action = action.to(torch.int32)
        if action.dim() > 1:  # composite: component 0 drives the world
            action = action[:, 0]
        reward = torch.zeros_like(state.episode_return)
        done = torch.zeros_like(state.step, dtype=torch.bool)
        sim = state
        for _ in range(self.num_action_repeats):
            effective = self._effective_action(sim, action)
            nxt, r, term = self._substep(sim, effective)
            active = ~done
            # Masked sub-step: once done, later repeats change nothing.
            sim = batch_where(active, nxt, sim)
            reward = reward + torch.where(active, r, 0.0)
            done = done | (active & term)
        # Emitted info includes the final step; the carried state resets
        # on done (the ImpalaStream contract, envs/core.py).
        emitted_return = state.episode_return + reward
        emitted_step = state.episode_step + 1
        carried = sim._replace(episode_return=emitted_return,
                               episode_step=emitted_step)
        # After done the emitted observation is the next episode's first
        # frame (the StreamAdapter contract).
        reset = self._reset(state.seed, state.episode + 1)
        new_state = batch_where(done, reset, carried)
        output = StepOutput(
            reward=reward,
            info=StepOutputInfo(episode_return=emitted_return,
                                episode_step=emitted_step),
            done=done,
            observation=Observation(frame=self._frame(new_state)))
        return new_state, output
