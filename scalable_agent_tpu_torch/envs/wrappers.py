"""The generic env wrappers the Doom and Atari pipelines, the gym levels and
episode recording need.

Copies of ``scalable_agent_tpu/envs/wrappers.py``'s ``_resize_frame``,
``ObservationWrapper``, ``ResizeWrapper``, ``FrameStackWrapper``,
``SkipFramesWrapper``, ``SkipAndStackWrapper``, ``RewardScalingWrapper``,
``TimeLimitWrapper`` and ``RecordingWrapper`` (reference:
envs/env_wrappers.py — resize :208-267, frame stack :58-115, skip
:118-142, skip+stack :145-166, reward scaling :293-300, time limit
:303-334, episode recording :433-497).  They
act on the ``Observation`` tuple (frame plus optional instruction and
measurements), frames stay HWC, and a ``None`` observation (a lockstep
multiplayer tick that renders nothing) passes through untouched.

``_resize_frame`` is the reference's as it is: ``cv2.resize`` with
``INTER_AREA`` where ``cv2`` imports, a nearest-neighbour numpy path where
it does not (``resize_backend`` says which this process takes).  This
module imports no torch: env worker processes import it.
"""

import json
import os
from collections import deque

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment, Wrapper
from scalable_agent_tpu_torch.envs.spec import TensorSpec


def resize_backend() -> str:
    """``cv2`` when ``_resize_frame`` resizes with OpenCV's INTER_AREA in
    this process, ``numpy`` when it takes the nearest-neighbour path."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "numpy"
    return "cv2"


def _resize_frame(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    try:
        import cv2

        out = cv2.resize(frame, (width, height),
                         interpolation=cv2.INTER_AREA)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    except ImportError:
        # Nearest-neighbor numpy fallback.
        h, w = frame.shape[:2]
        rows = (np.arange(height) * h // height)
        cols = (np.arange(width) * w // width)
        return frame[rows][:, cols]


class ObservationWrapper(Wrapper):
    """Base for wrappers that only rewrite observations: subclasses
    implement ``_transform`` once and both reset/step stay consistent.

    A ``None`` observation passes through untouched — lockstep
    multiplayer envs emit (None, None, None, None) on non-update ticks
    (reference: env_wrappers.py:240-242, doom_multiagent.py:207-208).
    """

    def _transform(self, observation):
        raise NotImplementedError

    def reset(self):
        return self._transform(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:
            return obs, reward, done, info
        return self._transform(obs), reward, done, info


class ResizeWrapper(ObservationWrapper):
    """Resize frames (optionally grayscale, optionally add channel dim).

    (reference: envs/env_wrappers.py:208-267)
    """

    def __init__(self, env: Environment, height: int, width: int,
                 grayscale: bool = False):
        super().__init__(env)
        self._height, self._width = height, width
        self._grayscale = grayscale
        frame_spec = env.observation_spec.frame
        channels = 1 if grayscale else frame_spec.shape[-1]
        self._spec = env.observation_spec._replace(
            frame=TensorSpec((height, width, channels), frame_spec.dtype,
                             frame_spec.name))

    @property
    def observation_spec(self):
        return self._spec

    def _transform(self, observation):
        frame = observation.frame
        if self._grayscale and frame.shape[-1] == 3:
            frame = np.asarray(
                frame @ np.array([0.299, 0.587, 0.114]), frame.dtype
            )[..., None]
        if frame.shape[:2] != (self._height, self._width):
            frame = _resize_frame(frame, self._height, self._width)
        return observation._replace(frame=frame)


class FrameStackWrapper(Wrapper):
    """Stack the last k frames along the channel axis.

    (reference: envs/env_wrappers.py:58-115; channel-stacking instead of a
    list so the conv torso sees one [H, W, C*k] tensor)
    """

    def __init__(self, env: Environment, stack: int):
        super().__init__(env)
        self._stack = stack
        self._frames = deque(maxlen=stack)
        frame_spec = env.observation_spec.frame
        h, w, c = frame_spec.shape
        self._spec = env.observation_spec._replace(
            frame=TensorSpec((h, w, c * stack), frame_spec.dtype,
                             frame_spec.name))

    @property
    def observation_spec(self):
        return self._spec

    def _emit(self, observation):
        return observation._replace(
            frame=np.concatenate(list(self._frames), axis=-1))

    def reset(self):
        observation = self.env.reset()
        for _ in range(self._stack):
            self._frames.append(observation.frame)
        return self._emit(observation)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        self._frames.append(obs.frame)
        return self._emit(obs), reward, done, info


class SkipFramesWrapper(Wrapper):
    """Repeat each action k times, summing rewards.

    (reference: envs/env_wrappers.py:118-142)
    """

    def __init__(self, env: Environment, skip_frames: int):
        super().__init__(env)
        self._skip = skip_frames

    def step(self, action):
        total_reward, done, info = 0.0, False, {}
        obs = None
        for _ in range(self._skip):
            obs, reward, done, info = self.env.step(action)
            if obs is None:  # lockstep multiplayer non-update tick
                return obs, reward, done, info
            total_reward += float(reward)
            if done:
                break
        return obs, np.float32(total_reward), done, info


class SkipAndStackWrapper(Wrapper):
    """Frameskip + stack combined.
    (reference: envs/env_wrappers.py:145-166)"""

    def __init__(self, env: Environment, skip_frames: int = 4,
                 stack_frames: int = 3):
        super().__init__(FrameStackWrapper(
            SkipFramesWrapper(env, skip_frames), stack_frames))


class RewardScalingWrapper(Wrapper):
    """Multiply rewards by a constant.
    (reference: envs/env_wrappers.py:293-300)"""

    def __init__(self, env: Environment, scale: float):
        super().__init__(env)
        self._scale = float(scale)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        return obs, np.float32(reward * self._scale), done, info


class TimeLimitWrapper(Wrapper):
    """Terminate episodes after a step budget (+- deterministic variation).

    (reference: envs/env_wrappers.py:303-334; the reference randomizes the
    limit per episode to decorrelate resets across a vectorized batch)
    """

    TERMINATED_BY_TIMER = "timer"

    def __init__(self, env: Environment, limit: int, random_variation: int = 0,
                 seed: int = 0):
        super().__init__(env)
        self._limit = limit
        self._variation = random_variation
        self._rng = np.random.default_rng(seed)
        self._this_limit = limit
        self._steps = 0

    def _draw_limit(self):
        if self._variation <= 0:
            return self._limit
        return int(self._limit
                   + self._rng.integers(-self._variation, self._variation + 1))

    def reset(self):
        self._steps = 0
        self._this_limit = self._draw_limit()
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        self._steps += 1
        if not done and self._steps >= self._this_limit:
            done = True
            info[self.TERMINATED_BY_TIMER] = True
        return obs, reward, done, info


class RecordingWrapper(Wrapper):
    """Record episodes: frames as .npy + actions/rewards as JSON.

    (reference: envs/env_wrappers.py:433-497 records PNG frames +
    actions.json; .npy avoids an image-codec dependency)
    """

    def __init__(self, env: Environment, record_to: str):
        super().__init__(env)
        self._dir = record_to
        os.makedirs(record_to, exist_ok=True)
        # Continue numbering past any existing recordings: a respawned
        # env worker re-runs this constructor on the same directory, and
        # restarting at 0 would overwrite already-recorded episodes.
        existing = [
            int(name[len("episode_"):])
            for name in os.listdir(record_to)
            if name.startswith("episode_")
            and name[len("episode_"):].isdigit()
        ]
        self._episode = max(existing, default=-1)
        # Whether THIS instance has reset yet: the first reset must
        # always advance past ``_episode`` (which may point at a
        # previous worker's last recording), while later stepless
        # resets reuse their number.  Gating the advance on the episode
        # counter instead conflated the two and made a respawned worker
        # overwrite the last recorded episode.
        self._has_reset = False
        self._frames = []
        self._actions = []
        self._rewards = []

    def _flush(self):
        # Gate on recorded ACTIONS, not frames: a reset-reset sequence
        # with no steps between (multiplayer worker INIT reset followed
        # by the aggregator's initial()) leaves one lone reset frame,
        # and flushing it would pollute every stream with a degenerate
        # 0-action leading episode.
        if self._episode >= 0 and self._actions:
            ep_dir = os.path.join(self._dir, f"episode_{self._episode:05d}")
            os.makedirs(ep_dir, exist_ok=True)
            np.save(os.path.join(ep_dir, "frames.npy"),
                    np.stack(self._frames))
            with open(os.path.join(ep_dir, "episode.json"), "w") as f:
                json.dump({
                    "actions": [np.asarray(a).tolist()
                                for a in self._actions],
                    "rewards": [float(r) for r in self._rewards],
                }, f)

    def reset(self):
        # The first reset of THIS instance numbers past whatever is
        # already on disk (a respawned worker must not overwrite the
        # previous instance's last episode); after that, advance only
        # past episodes that actually stepped — a stepless reset (see
        # _flush) reuses its number, so recordings stay consecutive.
        if not self._has_reset:
            self._has_reset = True
            self._episode += 1
        elif self._actions:
            self._flush()
            self._episode += 1
        self._frames, self._actions, self._rewards = [], [], []
        observation = self.env.reset()
        self._frames.append(np.asarray(observation.frame))
        return observation

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        self._frames.append(np.asarray(obs.frame))
        self._actions.append(action)
        self._rewards.append(reward)
        return obs, reward, done, info

    def close(self):
        self._flush()
        return self.env.close()

