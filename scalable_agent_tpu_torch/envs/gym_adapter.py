"""Gymnasium bridge: run any gymnasium env inside this framework.

A copy of ``scalable_agent_tpu/envs/gym_adapter.py``; this module imports
no torch, and ``gymnasium`` only when an env is built by its id.
The reference's env zoo is built on gym-0.x envs consumed directly
(reference: envs/atari/atari_utils.py:39-55 ``gym.make`` + wrappers).
Here a single adapter maps the modern gymnasium API (5-tuple steps,
reset(seed=...)) onto the framework's ``Environment`` protocol, and the
``gym_*`` registry family makes every installed gymnasium env a usable
level name (e.g. ``gym_CartPole-v1``) — including vector-observation
envs, whose frames come from ``render()`` so the pixel-based IMPALA agent
can train on them.
"""

from typing import Optional

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation


def _is_image_space(space) -> bool:
    shape = getattr(space, "shape", None)
    dtype = getattr(space, "dtype", None)
    return (shape is not None and len(shape) == 3 and shape[-1] in (1, 3)
            and dtype is not None and np.dtype(dtype) == np.uint8)


class GymnasiumEnv(Environment):
    """Wrap a gymnasium env (instance or id) as a framework Environment.

    - 5-tuple steps fold (terminated, truncated) into one ``done`` (the
      gym-0.x contract the rest of the stack uses, envs/core.py).
    - Seeding follows the gymnasium idiom: the seed is applied on the next
      ``reset`` and cleared after, so later resets draw fresh episodes.
    - If the observation is not an image, frames come from
      ``render()`` (render_mode='rgb_array' is requested at make time).
    """

    def __init__(self, env, render_frames: Optional[bool] = None):
        if isinstance(env, str):
            import gymnasium

            try:
                env = gymnasium.make(env, render_mode="rgb_array")
            except TypeError:
                env = gymnasium.make(env)
        self._env = env
        if not hasattr(env.action_space, "n"):
            raise ValueError(
                f"only discrete action spaces are supported, got "
                f"{env.action_space}")
        self.action_space = Discrete(int(env.action_space.n))
        self._render_frames = (
            not _is_image_space(env.observation_space)
            if render_frames is None else render_frames)
        if self._render_frames:
            # Probe one render to learn the frame shape.
            self._env.reset(seed=0)
            frame = np.asarray(self._env.render())
            if frame.ndim != 3:
                raise ValueError(
                    f"render() must produce an [H, W, C] frame, got shape "
                    f"{frame.shape}")
            frame_shape = frame.shape
        else:
            frame_shape = tuple(env.observation_space.shape)
        self.observation_spec = Observation(
            frame=TensorSpec(frame_shape, np.uint8, "frame"),
            instruction=None)
        self._seed: Optional[int] = None

    def seed(self, seed: Optional[int]) -> None:
        self._seed = None if seed is None else int(seed)

    def _observe(self, obs) -> Observation:
        if self._render_frames:
            frame = np.asarray(self._env.render(), np.uint8)
        else:
            frame = np.asarray(obs, np.uint8)
        return Observation(frame=frame, instruction=None)

    def reset(self) -> Observation:
        if self._seed is not None:
            obs, _ = self._env.reset(seed=self._seed)
            self._seed = None
        else:
            obs, _ = self._env.reset()
        return self._observe(obs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(
            int(action))
        return (self._observe(obs), float(reward),
                bool(terminated or truncated), dict(info))

    def render(self, mode: str = "rgb_array"):
        return self._env.render()

    def close(self):
        self._env.close()


def make_gym_env(full_env_name: str, height: Optional[int] = None,
                 width: Optional[int] = None, **kwargs) -> Environment:
    """``gym_<gymnasium id>`` -> adapted env, resized if height/width
    given.  Registered under the ``gym_`` prefix (envs/registry.py)."""
    env_id = full_env_name[len("gym_"):]
    env = GymnasiumEnv(env_id)
    if height is not None and width is not None:
        from scalable_agent_tpu_torch.envs.wrappers import ResizeWrapper

        env = ResizeWrapper(env, height, width)
    return env
