"""Atari environment family (ALE via gymnasium, optional dependency).

A copy of ``scalable_agent_tpu/envs/atari/__init__.py``; this module
imports no torch, and ``gymnasium`` only when an env is built.
Role of the reference's Atari adapter (reference:
envs/atari/atari_utils.py:16-55): a spec table of benchmark games and the
canonical preprocessing pipeline — NoFrameskip base env, resize to 84x84
grayscale, skip-4 + stack-4.  Differences by design:

- Frames stay HWC (the agent's torso reads NHWC frames); the reference
  emits CHW.
- Frameskip is declared via ``native_action_repeats`` so
  ``make_impala_stream`` does not double-apply action repeats
  (envs/__init__.py).
- Works against either the legacy ``*NoFrameskip-v4`` ids (ale-py legacy
  registration) or the modern ``ALE/<Game>-v5`` ids (forced to
  deterministic no-skip, no-sticky-action settings so semantics match).
"""

import dataclasses
from typing import Optional

from scalable_agent_tpu_torch.envs.core import Environment

ATARI_W = ATARI_H = 84


@dataclasses.dataclass(frozen=True)
class AtariSpec:
    name: str
    env_id: str  # legacy NoFrameskip id
    default_timeout: Optional[int] = None

    @property
    def ale_v5_id(self) -> str:
        base = self.env_id.replace("NoFrameskip-v4", "")
        return f"ALE/{base}-v5"


# The reference's benchmark set (reference: envs/atari/atari_utils.py:16-28).
ATARI_ENVS = (
    AtariSpec("atari_montezuma", "MontezumaRevengeNoFrameskip-v4",
              default_timeout=18000),
    AtariSpec("atari_pong", "PongNoFrameskip-v4"),
    AtariSpec("atari_qbert", "QbertNoFrameskip-v4"),
    AtariSpec("atari_breakout", "BreakoutNoFrameskip-v4"),
    AtariSpec("atari_spaceinvaders", "SpaceInvadersNoFrameskip-v4"),
    AtariSpec("atari_asteroids", "AsteroidsNoFrameskip-v4"),
    AtariSpec("atari_gravitar", "GravitarNoFrameskip-v4"),
    AtariSpec("atari_mspacman", "MsPacmanNoFrameskip-v4"),
    # NB: the gym registry casing is "Seaquest", not "SeaQuest" (the
    # reference's table carries the unregistered spelling).
    AtariSpec("atari_seaquest", "SeaquestNoFrameskip-v4"),
)


def atari_env_by_name(name: str) -> AtariSpec:
    for spec in ATARI_ENVS:
        if spec.name == name:
            return spec
    raise ValueError(
        f"unknown Atari env {name!r}; known: "
        f"{[s.name for s in ATARI_ENVS]}")


def _make_base_env(spec: AtariSpec):
    """gymnasium env with NO environment-side frameskip (the pipeline owns
    skipping, as the reference asserts 'NoFrameskip' in the id)."""
    import gymnasium

    try:
        return gymnasium.make(spec.env_id)
    except gymnasium.error.Error:
        # Modern ALE namespace ids: default v5 settings use frameskip 4
        # and sticky actions — force deterministic no-skip semantics.
        return gymnasium.make(
            spec.ale_v5_id, frameskip=1, repeat_action_probability=0.0)


def make_atari_env(full_env_name: str, skip_frames: int = 4,
                   stack_frames: int = 4, height: int = ATARI_H,
                   width: int = ATARI_W, **kwargs) -> Environment:
    """Name -> preprocessed env: resize->grayscale->skip+stack.

    (reference: envs/atari/atari_utils.py:39-55)
    """
    from scalable_agent_tpu_torch.envs.gym_adapter import GymnasiumEnv
    from scalable_agent_tpu_torch.envs.wrappers import (
        ResizeWrapper,
        SkipAndStackWrapper,
        TimeLimitWrapper,
    )

    # The frameskip requested by the runtime is consumed natively here.
    skip_frames = int(kwargs.pop("num_action_repeats", skip_frames))
    spec = atari_env_by_name(full_env_name)
    env = GymnasiumEnv(_make_base_env(spec), render_frames=False)
    if spec.default_timeout is not None:
        # Counts raw simulator steps (pre-skip), like the reference's
        # _max_episode_steps override (atari_utils.py:44-45).
        env = TimeLimitWrapper(env, spec.default_timeout)
    env = ResizeWrapper(env, height, width, grayscale=True)
    env = SkipAndStackWrapper(env, skip_frames=skip_frames,
                              stack_frames=stack_frames)
    env.native_action_repeats = skip_frames
    return env
