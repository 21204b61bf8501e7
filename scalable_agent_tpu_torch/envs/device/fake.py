"""``DeviceFakeEnv``: the [B]-batched tensor mirror of ``envs/fake.py``.

The counterpart of ``scalable_agent_tpu/envs/device/fake.py``.  It mirrors
the host ``FakeEnv`` transition for transition: the same frames, rewards,
episode boundaries, resets and episode accounting as
``ImpalaStream(StreamAdapter(FakeEnv(...)))``, so its rollouts on the card
can stand in for the host's (``tests/test_torch_device_env.py`` holds them
step by step), and it is the in-graph backend's zero-simulator-cost
benchmark level.

Integer caveat, as in JAX: the host ``FakeEnv`` mixes seeds with Python
integers of any size, the mirror with int32.  The cue and frame arithmetic
reduce the seed modulo their modulus before multiplying, so they are exact
for any int32 seed; only the length jitter multiplies the raw seed, so a
jittered env takes ``seed <= (2**31 - 1) // 1000003`` (``max_seed``,
checked by ``initial`` for seeds given on the host).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch.envs.device.protocol import DeviceEnvSpec
from scalable_agent_tpu_torch.envs.device.world import as_seeds
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)

__all__ = ["DeviceEnvState", "DeviceFakeEnv"]


class DeviceEnvState(NamedTuple):
    """Per-env simulator and episode-accounting state, all [B]."""

    seed: torch.Tensor  # int32, fixed per env
    episode: torch.Tensor  # int32
    step: torch.Tensor  # int32, simulator step within the episode
    episode_return: torch.Tensor  # float32, ImpalaStream's accumulator
    episode_step: torch.Tensor  # int32, agent steps within the episode


class DeviceFakeEnv:
    """[B]-batched mirror of ``envs.fake.FakeEnv``: ``initial(seeds)`` and
    ``step(state, action)`` return ``(DeviceEnvState, StepOutput)`` with
    the host ``ImpalaStream``'s fields (rewards summed over the native
    action repeats, done folding termination, the observation after done
    the next episode's first frame, the emitted info including the final
    step while the carried accounting resets)."""

    def __init__(self, height: int = 72, width: int = 96, channels: int = 3,
                 num_actions: int = 9, episode_length: int = 10,
                 length_jitter: int = 0, num_action_repeats: int = 1,
                 reward_mode: str = "schedule"):
        self.height = height
        self.width = width
        self.channels = channels
        self.num_actions = num_actions
        self.episode_length = episode_length
        self.length_jitter = length_jitter
        self.num_action_repeats = max(1, int(num_action_repeats))
        if reward_mode not in ("schedule", "bandit", "memory"):
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        self.reward_mode = reward_mode
        self.action_space = Discrete(num_actions)
        self.observation_spec = Observation(
            frame=TensorSpec((height, width, channels), np.uint8, "frame"))
        # The seed bound for exact host-mirror arithmetic (module
        # docstring): only the length jitter multiplies the raw seed.
        self.max_seed = ((2**31 - 1) // 1000003 if length_jitter > 0
                         else 2**31 - 1)

    @property
    def spec(self) -> DeviceEnvSpec:
        return DeviceEnvSpec(
            observation_spec=self.observation_spec,
            action_space=self.action_space,
            num_actions=self.num_actions)

    # -- the transition arithmetic (FakeEnv's, term by term) ---------------

    def _episode_len(self, seed, episode):
        if self.length_jitter <= 0:
            return torch.full_like(episode, self.episode_length)
        # The host's (seed*1000003 + episode*7919) % m term by term:
        # int32-safe for any episode count (seed*1000003 is bounded by
        # max_seed).
        m = self.length_jitter + 1
        mix = ((seed * 1000003) % m + (episode % m) * (7919 % m)) % m
        return self.episode_length + mix

    def _cue(self, seed, episode, step):
        """The rewarded action [B]: the host's ``(seed*131 + episode*29
        [+ step*13]) % A`` term by term, the seed reduced before its
        multiply (``seed * 131`` overflows int32 above ~16.4M)."""
        a = self.num_actions
        mix = (seed % a) * (131 % a) + (episode % a) * (29 % a)
        if self.reward_mode == "bandit":
            mix = mix + (step % a) * (13 % a)
        return mix % a

    def _frame(self, seed, episode, step, action):
        """uint8 [B, H, W, C]: a constant fill with 3 encoded pixels
        (FakeEnv._frame); the bandit and memory modes fill with the scaled
        cue (FakeEnv._fill_value)."""
        if self.reward_mode == "schedule":
            base = ((seed % 251) * (131 % 251) + (episode % 251) * 17
                    + (step % 251) * 7) % 251
        else:
            scale = 255 // max(1, self.num_actions - 1)
            base = self._cue(seed, episode, step) * scale
            if self.reward_mode == "memory":
                base = torch.where(step == 0, base, 128)
        b = base.shape[0]
        frame = base.to(torch.uint8)[:, None, None, None].expand(
            b, self.height, self.width, self.channels).clone()
        frame[:, 0, 0, 0] = (episode % 256).to(torch.uint8)
        frame[:, 0, 1, 0] = (step % 256).to(torch.uint8)
        frame[:, 0, 2, 0] = (action % 256).to(torch.uint8)
        return frame

    def initial(self, seeds, device=None
                ) -> Tuple[DeviceEnvState, StepOutput]:
        """Reset every env to episode 0, step 0: reward 0, zero info,
        done=True (ImpalaStream.initial); ``seeds`` [B] on ``device``
        unless they are a tensor already."""
        seeds = as_seeds(seeds, self.max_seed, device)
        b = seeds.shape[0]
        # One tensor per leaf: none shares storage with another.
        zero_i = lambda: torch.zeros((b,), dtype=torch.int32,
                                     device=seeds.device)
        zero_f = lambda: torch.zeros((b,), dtype=torch.float32,
                                     device=seeds.device)
        state = DeviceEnvState(seed=seeds.clone(), episode=zero_i(),
                               step=zero_i(), episode_return=zero_f(),
                               episode_step=zero_i())
        output = StepOutput(
            reward=zero_f(),
            info=StepOutputInfo(episode_return=zero_f(),
                                episode_step=zero_i()),
            done=torch.ones((b,), dtype=torch.bool, device=seeds.device),
            observation=Observation(frame=self._frame(
                state.seed, state.episode, state.step, state.episode_step)))
        return state, output

    def step(self, state: DeviceEnvState, action
             ) -> Tuple[DeviceEnvState, StepOutput]:
        """One agent step: ``num_action_repeats`` masked simulator
        sub-steps with summed rewards and early stop on done, then the
        reset (StreamAdapter) and the episode accounting (ImpalaStream)."""
        action = action.to(torch.int32)
        if action.dim() > 1:  # composite: the frame encodes component 0
            action = action[:, 0]
        ep_len = self._episode_len(state.seed, state.episode)
        step = state.step
        reward = torch.zeros_like(state.episode_return)
        done = torch.zeros_like(step, dtype=torch.bool)
        for _ in range(self.num_action_repeats):
            active = ~done
            if self.reward_mode != "schedule":
                # The cue before the increment: the one the agent saw.
                cue = self._cue(state.seed, state.episode, step)
                reward = reward + torch.where(active & (action == cue),
                                              1.0, 0.0)
            step = step + active.to(torch.int32)
            sub_done = active & (step >= ep_len)
            if self.reward_mode == "schedule":
                reward = reward + torch.where(
                    active, 0.1 * (step % 3).to(torch.float32), 0.0)
                reward = reward + torch.where(sub_done, 1.0, 0.0)
            done = done | sub_done
        emitted_return = state.episode_return + reward
        emitted_step = state.episode_step + 1
        # The reset: a new episode at step 0 whose first frame encodes
        # action 0 (StreamAdapter.step -> FakeEnv.reset).
        new_episode = state.episode + done.to(torch.int32)
        new_step = torch.where(done, 0, step)
        obs_action = torch.where(done, 0, action)
        new_state = DeviceEnvState(
            seed=state.seed.clone(),
            episode=new_episode,
            step=new_step,
            episode_return=torch.where(done, 0.0, emitted_return),
            episode_step=torch.where(done, 0, emitted_step))
        output = StepOutput(
            reward=reward,
            info=StepOutputInfo(episode_return=emitted_return,
                                episode_step=emitted_step),
            done=done,
            observation=Observation(frame=self._frame(
                state.seed, new_episode, new_step, obs_action)))
        return new_state, output
