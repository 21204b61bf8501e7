"""A batch of envs stepped in this process.

A lean counterpart of ``scalable_agent_tpu/envs/vector.py::MultiEnv`` with
the API ``VectorActor`` calls (``num_envs``, ``initial()``,
``step_send``/``step_recv``).  The streams run in the calling process, one
after the other; subprocess env workers are not ported yet (ROADMAP.md,
queue 1).
"""

from collections import deque
from typing import Callable, Sequence

import numpy as np

from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)


class MultiEnv:
    """N ImpalaStream-protocol envs, batched into [N, ...] StepOutputs."""

    def __init__(self, make_stream_fns: Sequence[Callable], frame_spec,
                 stats_episodes: int = 100):
        self.num_envs = len(make_stream_fns)
        self._frame_spec = frame_spec
        self._streams = [fn() for fn in make_stream_fns]
        self._actions = None
        # (episode_return, episode_length) of finished episodes.
        self.episode_stats = deque(maxlen=stats_episodes)

    def _gather(self, outputs) -> StepOutput:
        frames = np.stack([self._frame_spec.validate(o.observation.frame)
                           for o in outputs])
        rewards = np.array([o.reward for o in outputs], np.float32)
        dones = np.array([o.done for o in outputs], bool)
        returns = np.array([o.info.episode_return for o in outputs],
                           np.float32)
        steps = np.array([o.info.episode_step for o in outputs], np.int32)
        for i in np.nonzero(dones)[0]:
            if steps[i] > 0:  # initial() marks done without an episode
                self.episode_stats.append((float(returns[i]), int(steps[i])))
        return StepOutput(
            reward=rewards,
            info=StepOutputInfo(episode_return=returns, episode_step=steps),
            done=dones,
            observation=Observation(frame=frames),
        )

    def initial(self) -> StepOutput:
        return self._gather([s.initial() for s in self._streams])

    def step_send(self, actions) -> None:
        actions = np.asarray(actions)
        if actions.shape[0] != self.num_envs:
            raise ValueError(
                f"got {actions.shape[0]} actions for {self.num_envs} envs")
        self._actions = actions

    def step_recv(self) -> StepOutput:
        if self._actions is None:
            raise RuntimeError("step_recv without step_send")
        actions, self._actions = self._actions, None
        return self._gather([s.step(a)
                             for s, a in zip(self._streams, actions)])

    def close(self):
        for stream in self._streams:
            stream.close()
