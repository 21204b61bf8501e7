"""Environment protocols: gym-like core, auto-reset stream, IMPALA stream.

A copy of ``scalable_agent_tpu/envs/core.py`` (reference:
environments.py:103-233):

1. ``Environment`` — the gym-like simulator API (reset/step/close).
2. ``StreamAdapter`` — auto-reset stream: after a done, the observation is
   the first one of the next episode.
3. ``ImpalaStream`` — adds episode_return/episode_step accounting and emits
   ``StepOutput`` tuples.

The random-action ``BenchmarkStream`` (``--benchmark_mode``) is not ported
yet (ROADMAP.md, queue 1).
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch.envs.spaces import Space
from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)


class Environment:
    """Gym-like simulator API; ``step`` returns (observation, reward, done,
    info-dict) with termination and truncation folded into ``done``."""

    action_space: Space
    observation_spec: Any  # Observation of TensorSpec

    def seed(self, seed: Optional[int]) -> None:
        pass

    def reset(self) -> Any:
        raise NotImplementedError

    def step(self, action) -> Tuple[Any, float, bool, Dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamAdapter:
    """Auto-reset stream over an ``Environment``: ``step`` returns (reward,
    done, observation); when done, the observation is the first one of the
    freshly reset next episode."""

    def __init__(self, env: Environment):
        self._env = env

    @property
    def observation_spec(self):
        return self._env.observation_spec

    @property
    def action_space(self):
        return self._env.action_space

    def initial(self):
        return self._env.reset()

    def step(self, action):
        observation, reward, done, _ = self._env.step(action)
        if done:
            observation = self._env.reset()
        return np.float32(reward), bool(done), observation

    def close(self):
        self._env.close()


class ImpalaStream:
    """StepOutput stream with episode accounting.

    ``initial()`` emits StepOutput(reward=0, info=(0, 0), done=True,
    observation) — done=True marks the start of an episode.  ``step``
    accumulates episode_return/episode_step in the emitted info and zeroes
    the carried counters after a done (reference: environments.py:179-233).
    """

    def __init__(self, stream):
        self._stream = stream
        self._info = StepOutputInfo(np.float32(0.0), np.int32(0))

    @property
    def observation_spec(self):
        return self._stream.observation_spec

    @property
    def action_space(self):
        return self._stream.action_space

    def initial(self) -> StepOutput:
        observation = self._stream.initial()
        self._info = StepOutputInfo(np.float32(0.0), np.int32(0))
        return StepOutput(
            reward=np.float32(0.0),
            info=self._info,
            done=np.bool_(True),
            observation=observation,
        )

    def step(self, action) -> StepOutput:
        reward, done, observation = self._stream.step(action)
        new_info = StepOutputInfo(
            episode_return=np.float32(self._info.episode_return + reward),
            episode_step=np.int32(self._info.episode_step + 1),
        )
        # Emitted info includes the final step; carried info resets on done.
        self._info = (StepOutputInfo(np.float32(0.0), np.int32(0))
                      if done else new_info)
        return StepOutput(
            reward=np.float32(reward),
            info=new_info,
            done=np.bool_(done),
            observation=observation,
        )

    def close(self):
        self._stream.close()


def make_observation(frame, instruction=None) -> Observation:
    """Wrap simulator outputs into the canonical Observation tuple."""
    return Observation(frame=frame, instruction=instruction)
