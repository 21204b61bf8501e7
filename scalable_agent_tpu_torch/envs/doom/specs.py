"""Doom environment specs and the wrapper-assembly pipeline (a copy of
``scalable_agent_tpu/envs/doom/specs.py``).

The reference's ``DoomSpec`` table and ``make_doom_env_impl`` pipeline
(reference: envs/doom/doom_utils.py:19-130 table, :141-217 pipeline)
rebuilt over this framework's wrapper set.  Spec names, scenario files,
action spaces, reward scaling, timeouts, and agent/bot counts match the
reference exactly.
"""

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from scalable_agent_tpu_torch.envs.doom import action_space as asp
from scalable_agent_tpu_torch.envs.doom import wrappers as dw
from scalable_agent_tpu_torch.envs.doom.core import DoomEnv
from scalable_agent_tpu_torch.envs.spaces import Discrete, Space
from scalable_agent_tpu_torch.envs.wrappers import (
    RecordingWrapper,
    ResizeWrapper,
    RewardScalingWrapper,
    TimeLimitWrapper,
)


@dataclasses.dataclass
class DoomSpec:
    """(reference: doom_utils.py:19-40)"""

    name: str
    config_file: str
    action_space: Space
    reward_scaling: float = 1.0
    default_timeout: int = -1
    num_agents: int = 1
    num_bots: int = 0
    respawn_delay: int = 0
    # [(wrapper_factory, kwargs)] applied after the standard pipeline
    extra_wrappers: Sequence[Tuple[Callable, dict]] = ()


ADDITIONAL_INPUT = (dw.DoomAdditionalInput, {})
BATTLE_REWARD_SHAPING = (
    dw.DoomRewardShaping,
    dict(scheme=dw.REWARD_SHAPING_BATTLE, true_reward_func=None))
BOTS_REWARD_SHAPING = (
    dw.DoomRewardShaping,
    dict(scheme=dw.REWARD_SHAPING_DEATHMATCH_V0,
         true_reward_func=dw.true_reward_frags))
DEATHMATCH_REWARD_SHAPING = (
    dw.DoomRewardShaping,
    dict(scheme=dw.REWARD_SHAPING_DEATHMATCH_V1,
         true_reward_func=dw.true_reward_final_position))


# (reference: doom_utils.py:49-130; same names/files/spaces/constants)
DOOM_ENVS: List[DoomSpec] = [
    DoomSpec("doom_basic", "basic.cfg", Discrete(1 + 3), 0.01, 300),
    DoomSpec("doom_corridor", "deadly_corridor.cfg", Discrete(1 + 7),
             0.01, 2100),
    DoomSpec("doom_gathering", "health_gathering.cfg", Discrete(1 + 3),
             0.01, 2100),
    DoomSpec("doom_two_colors_easy", "two_colors_easy.cfg",
             asp.doom_action_space_basic(),
             extra_wrappers=[(dw.DoomGatheringRewardShaping, {})]),
    DoomSpec("doom_two_colors_hard", "two_colors_hard.cfg",
             asp.doom_action_space_basic(),
             extra_wrappers=[(dw.DoomGatheringRewardShaping, {})]),
    DoomSpec("doom_dm", "cig.cfg", asp.doom_action_space(), 1.0,
             int(1e9), num_agents=8,
             extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
    DoomSpec("doom_dwango5", "dwango5_dm.cfg", asp.doom_action_space(),
             1.0, int(1e9), num_agents=8,
             extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
    DoomSpec("doom_battle", "battle_continuous_turning.cfg",
             asp.doom_action_space_discretized_no_weap(), 1.0, 2100,
             extra_wrappers=[ADDITIONAL_INPUT, BATTLE_REWARD_SHAPING]),
    DoomSpec("doom_battle2", "battle2_continuous_turning.cfg",
             asp.doom_action_space_discretized_no_weap(), 1.0, 2100,
             extra_wrappers=[ADDITIONAL_INPUT, BATTLE_REWARD_SHAPING]),
    DoomSpec("doom_deathmatch_bots", "dwango5_dm_continuous_weap.cfg",
             asp.doom_action_space_full_discretized(), 1.0, int(1e9),
             num_agents=1, num_bots=7,
             extra_wrappers=[ADDITIONAL_INPUT, BOTS_REWARD_SHAPING]),
    DoomSpec("doom_duel", "ssl2.cfg",
             asp.doom_action_space_full_discretized(with_use=True), 1.0,
             int(1e9), num_agents=2, num_bots=0, respawn_delay=2,
             extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
    DoomSpec("doom_deathmatch_full", "freedm.cfg",
             asp.doom_action_space_full_discretized(with_use=True), 1.0,
             int(1e9), num_agents=4, num_bots=4, respawn_delay=2,
             extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
    # The throughput-benchmark convention: 128x72 agent input, 4-skip,
    # 160x120 native, simple Discrete(9) space
    # (reference: doom_utils.py:125-129)
    DoomSpec("doom_benchmark", "battle.cfg", Discrete(1 + 8), 1.0, 2100),
]

_BY_NAME = {spec.name: spec for spec in DOOM_ENVS}


def doom_spec_by_name(name: str) -> DoomSpec:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown Doom env {name!r}; known: {sorted(_BY_NAME)}"
        ) from None


def assemble_doom_env(
    spec: DoomSpec,
    skip_frames: int = 4,
    width: int = 128,
    height: int = 72,
    resolution: Optional[str] = None,
    wide_aspect_ratio: bool = False,
    episode_horizon: Optional[int] = None,
    record_to: Optional[str] = None,
    scenarios_dir: Optional[str] = None,
    async_mode: bool = False,
    env: Optional[DoomEnv] = None,
    num_bots: Optional[int] = None,
    coord_limits=None,
    show_automap: bool = False,
):
    """The single-player wrapper pipeline (reference:
    doom_utils.py:141-217): recording -> multiplayer stats -> bot
    difficulty -> native resolution -> resize -> time limit -> extra
    wrappers -> reward scaling.  ``env`` injects a pre-built base env
    (the multiplayer per-player factory uses this)."""
    if env is None:
        env = DoomEnv(spec.action_space, spec.config_file,
                      skip_frames=skip_frames,
                      scenarios_dir=scenarios_dir,
                      async_mode=async_mode,
                      coord_limits=coord_limits,
                      show_automap=show_automap)
    bots = spec.num_bots if num_bots is None else num_bots
    wrapped = env
    if record_to is not None:
        wrapped = RecordingWrapper(wrapped, record_to)
    wrapped = dw.MultiplayerStatsWrapper(wrapped)
    if bots > 0:
        wrapped = dw.BotDifficultyWrapper(wrapped)
    native = resolution or ("256x144" if wide_aspect_ratio else "160x120")
    dw.set_doom_resolution(wrapped, native)
    spec_shape = wrapped.observation_spec.frame.shape
    if (spec_shape[0], spec_shape[1]) != (height, width):
        wrapped = ResizeWrapper(wrapped, height, width, grayscale=False)
    timeout = spec.default_timeout
    if episode_horizon is not None and episode_horizon > 0:
        timeout = episode_horizon
    if timeout > 0:
        wrapped = TimeLimitWrapper(wrapped, limit=timeout)
    for wrapper_factory, kwargs in spec.extra_wrappers:
        wrapped = wrapper_factory(wrapped, **kwargs)
    if spec.reward_scaling != 1.0:
        wrapped = RewardScalingWrapper(wrapped, spec.reward_scaling)
    # Surface the base env's native frameskip on the OUTERMOST wrapper:
    # make_impala_stream reads this attribute to avoid stacking a second
    # SkipFramesWrapper on top of make_action's skip_frames (wrappers
    # don't forward arbitrary attributes).
    wrapped.native_action_repeats = env.native_action_repeats
    return wrapped
