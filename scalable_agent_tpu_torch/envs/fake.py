"""Deterministic fake environment for hermetic tests and benchmarks.

A copy of ``scalable_agent_tpu/envs/fake.py``: transitions are a pure
function of (seed, episode, step); frames encode (episode, step, action)
in their first pixels.  Three reward modes:

- ``"schedule"`` (default): reward at step t (1-based) is ``0.1 * (t % 3)``
  plus 1 on the terminal step; not learnable.
- ``"bandit"``: every frame shows a per-step cue; the matching action
  earns +1.
- ``"memory"``: the cue is shown only in an episode's first frame, so the
  LSTM must latch it (the red test for the done-reset).

``with_instruction`` adds an int32 [instruction_len] instruction to every
observation: token 0 is ``1 + episode % 100``, the rest padding (0).

``action_space`` takes a composite ``TupleSpace`` (the hermetic stand-in
for Doom's composite spaces) under the ``"schedule"`` mode only: its
``step`` takes one index per component and encodes the first component
in the frame.
"""

from typing import Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment, make_observation
from scalable_agent_tpu_torch.envs.spaces import Discrete, Space
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation


class FakeEnv(Environment):
    """Deterministic episodic environment with native action repeats."""

    def __init__(
        self,
        height: int = 72,
        width: int = 96,
        channels: int = 3,
        num_actions: int = 9,
        episode_length: int = 10,
        length_jitter: int = 0,
        seed: int = 0,
        with_instruction: bool = False,
        instruction_len: int = 16,
        action_space: Optional[Space] = None,
        num_action_repeats: int = 1,
        reward_mode: str = "schedule",
    ):
        self._h, self._w, self._c = height, width, channels
        # Native action repeats: one ``step`` advances the simulator this
        # many sub-steps with summed rewards and early stop on done.
        self.native_action_repeats = max(1, int(num_action_repeats))
        self.action_space = action_space or Discrete(num_actions)
        if reward_mode not in ("schedule", "bandit", "memory"):
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        if reward_mode != "schedule" and not isinstance(
                self.action_space, Discrete):
            raise ValueError(
                f"reward_mode {reward_mode!r} needs a Discrete action "
                f"space (the cue is an action index)")
        self._reward_mode = reward_mode
        # Cues index the action space the env really has.
        self._num_actions = (self.action_space.n
                             if isinstance(self.action_space, Discrete)
                             else num_actions)
        self._episode_length = episode_length
        self._length_jitter = length_jitter
        self._seed = seed
        self._episode = -1
        self._step = 0
        self._with_instruction = with_instruction
        self._instruction_len = instruction_len
        self.observation_spec = Observation(
            frame=TensorSpec((height, width, channels), np.uint8, "frame"),
            instruction=(TensorSpec((instruction_len,), np.int32,
                                    "instruction")
                         if with_instruction else None))

    def seed(self, seed: Optional[int]):
        if seed is not None:
            self._seed = int(seed)

    def _episode_len(self) -> int:
        if self._length_jitter <= 0:
            return self._episode_length
        mix = (self._seed * 1000003 + self._episode * 7919) % (
            self._length_jitter + 1)
        return self._episode_length + mix

    def _cue(self, step: int) -> int:
        """The rewarded action for (seed, episode, step); memory mode has
        one cue per episode."""
        mix = self._seed * 131 + self._episode * 29
        if self._reward_mode == "bandit":
            mix += step * 13
        return mix % self._num_actions

    def _fill_value(self) -> int:
        """The frame's fill byte: the mode's learning signal."""
        if self._reward_mode == "schedule":
            return (self._seed * 131 + self._episode * 17
                    + self._step * 7) % 251
        scale = 255 // max(1, self._num_actions - 1)
        if self._reward_mode == "memory" and self._step != 0:
            return 128  # cue hidden after the first frame
        return self._cue(self._step) * scale

    def _frame(self, action: int) -> np.ndarray:
        frame = np.full((self._h, self._w, self._c), self._fill_value(),
                        dtype=np.uint8)
        frame[0, 0, 0] = self._episode % 256
        frame[0, 1, 0] = self._step % 256
        frame[0, 2, 0] = action % 256
        return frame

    def _observation(self, action: int) -> Observation:
        instruction = None
        if self._with_instruction:
            instruction = np.zeros((self._instruction_len,), np.int32)
            instruction[0] = 1 + (self._episode % 100)
        return make_observation(self._frame(action), instruction)

    def reset(self):
        self._episode += 1
        self._step = 0
        return self._observation(action=0)

    def step(self, action) -> Tuple[Observation, float, bool, dict]:
        arr = np.asarray(action)
        if arr.ndim == 0:
            action = int(arr)
        else:  # composite: one index per subspace
            action = tuple(int(a) for a in arr)
        if not self.action_space.contains(action):
            raise ValueError(f"action {action} outside {self.action_space}")
        if isinstance(action, tuple):
            action = action[0]  # the frame encodes the first component
        reward = 0.0
        done = False
        episode_len = self._episode_len()
        for _ in range(self.native_action_repeats):
            # Bandit/memory: the cue the agent SAW is the pre-increment
            # state's, so reward is computed before advancing.
            if self._reward_mode != "schedule":
                reward += 1.0 if action == self._cue(self._step) else 0.0
            self._step += 1
            done = self._step >= episode_len
            if self._reward_mode == "schedule":
                reward += 0.1 * (self._step % 3) + (1.0 if done else 0.0)
            if done:
                break
        return self._observation(action), np.float32(reward), done, {}
