"""DeepMind Lab environment family (optional ``deepmind_lab`` dependency).

A copy of ``scalable_agent_tpu/envs/dmlab/__init__.py``; this module
imports no torch (env worker processes import it), and ``deepmind_lab``
only when an env is built.  The level cache defaults to
``<tempdir>/dmlab_level_cache`` (``$TMPDIR``'s), or
``$DMLAB_LEVEL_CACHE``.

Role of the reference's two DMLab adapters in one module:

- ``PyProcessDmLab`` (reference: environments.py:66-140): production
  IMPALA adapter — [RGB_INTERLEAVED, INSTR] observations, seeded resets
  from a per-env RandomState, native action repeats via ``num_steps``,
  the 9-action DEFAULT_ACTION_SET, level cache.
- ``DmlabGymEnv`` (reference: envs/dmlab/dmlab_utils.py:50-135): the
  vendored Sample-Factory adapter — spec table (dmlab_sparse etc.),
  hardware renderer, 5-action classic set.

Differences by design:

- One ``DmLabEnv`` implements the framework ``Environment`` protocol;
  auto-reset/episode accounting live in the stream layer (envs/core.py),
  not in the adapter.
- The INSTR string is hashed host-side to fixed int32 token ids
  (``utils/text.py``) — the reference ships strings into the TF graph and
  hashes there (experiment.py:123-132).
- Benchmark-mode random actions are the stream layer's BenchmarkStream
  (envs/core.py), not an adapter flag (reference: environments.py:104-110).
"""

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation
from scalable_agent_tpu_torch.utils.text import (
    MAX_INSTRUCTION_LEN,
    hash_instruction,
)

# 7-dof native action vectors (look_lr, look_ud, strafe, forward, fire,
# jump, crouch).  Published calibration constants that must match the
# reference for parity (reference: environments.py:53-63).
DEFAULT_ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),    # Forward
    (0, 0, 0, -1, 0, 0, 0),   # Backward
    (0, 0, -1, 0, 0, 0, 0),   # Strafe Left
    (0, 0, 1, 0, 0, 0, 0),    # Strafe Right
    (-20, 0, 0, 0, 0, 0, 0),  # Look Left
    (20, 0, 0, 0, 0, 0, 0),   # Look Right
    (-20, 0, 0, 1, 0, 0, 0),  # Look Left + Forward
    (20, 0, 0, 1, 0, 0, 0),   # Look Right + Forward
    (0, 0, 0, 0, 1, 0, 0),    # Fire
)

# The vendored SF adapter's reduced set (reference: dmlab_utils.py:15-21).
CLASSIC_ACTION_SET = (
    (0, 0, 0, 0, 0, 0, 0),    # Idle
    (0, 0, 0, 1, 0, 0, 0),    # Forward
    (0, 0, 0, -1, 0, 0, 0),   # Backward
    (-20, 0, 0, 0, 0, 0, 0),  # Look Left
    (20, 0, 0, 0, 0, 0, 0),   # Look Right
)

DEFAULT_CACHE_DIR = os.environ.get(
    "DMLAB_LEVEL_CACHE",
    os.path.join(tempfile.gettempdir(), "dmlab_level_cache"))


class LevelCache:
    """Compiled-level cache handed to deepmind_lab.Lab: DMLab calls
    ``fetch(key, pk3_path)`` before compiling a level and ``write`` after
    (reference: environments.py:33-50, dmlab_utils.py:24-47)."""

    def __init__(self, cache_dir: str = DEFAULT_CACHE_DIR):
        self._cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def fetch(self, key: str, pk3_path: str) -> bool:
        path = os.path.join(self._cache_dir, key)
        if os.path.isfile(path):
            shutil.copyfile(path, pk3_path)
            return True
        return False

    def write(self, key: str, pk3_path: str) -> None:
        path = os.path.join(self._cache_dir, key)
        if not os.path.isfile(path):
            shutil.copyfile(pk3_path, path)


@dataclasses.dataclass(frozen=True)
class DmLabSpec:
    name: str
    level: str
    extra_cfg: Tuple[Tuple[str, str], ...] = ()


# The vendored SF spec table (reference: dmlab_utils.py:136-144).
DMLAB_ENVS = (
    DmLabSpec("dmlab_sparse",
              "contributed/dmlab30/explore_goal_locations_large"),
    DmLabSpec("dmlab_very_sparse",
              "contributed/dmlab30/explore_goal_locations_large",
              (("minGoalDistance", "10"),)),
    DmLabSpec("dmlab_sparse_doors",
              "contributed/dmlab30/explore_obstructed_goals_large"),
    DmLabSpec("dmlab_nonmatch",
              "contributed/dmlab30/rooms_select_nonmatching_object"),
    DmLabSpec("dmlab_watermaze",
              "contributed/dmlab30/rooms_watermaze"),
)


def resolve_level(full_env_name: str) -> Tuple[str, Dict[str, str]]:
    """``dmlab_*`` name -> (level path, extra config).

    Resolution order: the SF spec table, then any DMLab-30 level name
    (train or test variant, envs/dmlab30.py), then a raw level path after
    the prefix (e.g. ``dmlab_contributed/dmlab30/rooms_watermaze``).
    """
    for spec in DMLAB_ENVS:
        if spec.name == full_env_name:
            return spec.level, dict(spec.extra_cfg)
    short = full_env_name[len("dmlab_"):]
    from scalable_agent_tpu_torch.envs import dmlab30

    if short in dmlab30.ALL_LEVELS or short in dmlab30._BY_TEST_NAME:
        return f"contributed/dmlab30/{short}", {}
    if "/" in short:
        return short, {}
    raise ValueError(
        f"unknown DMLab env {full_env_name!r}: not an SF spec, a DMLab-30 "
        f"level, or a raw level path")


class DmLabEnv(Environment):
    """deepmind_lab.Lab behind the framework Environment protocol."""

    def __init__(
        self,
        level: str,
        width: int = 96,
        height: int = 72,
        action_set: Sequence[Tuple[int, ...]] = DEFAULT_ACTION_SET,
        num_action_repeats: int = 1,
        seed: int = 0,
        config: Optional[Dict[str, str]] = None,
        renderer: str = "hardware",
        level_cache: Optional[LevelCache] = None,
        with_instruction: bool = True,
        instruction_len: int = MAX_INSTRUCTION_LEN,
        runfiles_path: Optional[str] = None,
    ):
        import deepmind_lab

        if runfiles_path:
            deepmind_lab.set_runfiles_path(runfiles_path)
        self._obs_names = (["RGB_INTERLEAVED", "INSTR"] if with_instruction
                           else ["RGB_INTERLEAVED"])
        full_config = {"width": str(width), "height": str(height)}
        full_config.update(
            {k: str(v) for k, v in (config or {}).items()})
        self._lab = deepmind_lab.Lab(
            level=level,
            observations=self._obs_names,
            config=full_config,
            renderer=renderer,
            level_cache=(LevelCache() if level_cache is None
                         else level_cache),
        )
        self._action_list = np.array(action_set, dtype=np.intc)
        # Native repeats: one agent step = num_action_repeats simulator
        # steps through Lab's own num_steps (reference: environments.py:111)
        # — make_impala_stream sees this attribute and skips its wrapper.
        self.native_action_repeats = int(num_action_repeats)
        self._num_steps = int(num_action_repeats)
        self._random_state = np.random.RandomState(seed=seed)
        self._with_instruction = with_instruction
        self._instruction_len = instruction_len
        self.action_space = Discrete(len(self._action_list))
        self.observation_spec = Observation(
            frame=TensorSpec((height, width, 3), np.uint8, "frame"),
            instruction=(TensorSpec((instruction_len,), np.int32,
                                    "instruction")
                         if with_instruction else None))

    def seed(self, seed: Optional[int]) -> None:
        if seed is not None:
            self._random_state = np.random.RandomState(seed=int(seed))

    def _observe(self) -> Observation:
        obs = self._lab.observations()
        instruction = None
        if self._with_instruction:
            instr = obs.get("INSTR", "")
            if isinstance(instr, bytes):
                instr = instr.decode("utf-8", errors="replace")
            instruction = hash_instruction(
                str(instr), max_len=self._instruction_len)
        return Observation(
            frame=np.asarray(obs["RGB_INTERLEAVED"], np.uint8),
            instruction=instruction)

    def reset(self) -> Observation:
        # Seeded per-episode resets (reference: environments.py:92-93).
        self._lab.reset(seed=int(
            self._random_state.randint(0, 2 ** 31 - 1)))
        return self._observe()

    def step(self, action):
        reward = self._lab.step(
            self._action_list[int(action)], num_steps=self._num_steps)
        done = not self._lab.is_running()
        if done:
            # A finished Lab episode has no observations; emit the spec's
            # zero frame (the stream layer resets immediately after).
            observation = Observation(
                frame=np.zeros(self.observation_spec.frame.shape, np.uint8),
                instruction=(np.zeros((self._instruction_len,), np.int32)
                             if self._with_instruction else None))
        else:
            observation = self._observe()
        return observation, float(reward), bool(done), {
            "num_frames": self._num_steps}

    def render(self, mode: str = "rgb_array"):
        return np.asarray(
            self._lab.observations()["RGB_INTERLEAVED"], np.uint8)

    def close(self):
        self._lab.close()


def make_dmlab_env(full_env_name: str, width: int = 96, height: int = 72,
                   num_action_repeats: int = 1, seed: int = 0,
                   dataset_path: str = "", renderer: str = "hardware",
                   with_instruction: bool = True,
                   **kwargs) -> Environment:
    """Name -> DmLabEnv.  Registered under the ``dmlab_`` prefix.

    ``dataset_path`` feeds the psychlab datasets config key exactly as the
    reference threads it (reference: experiment.py:445-449).
    """
    level, extra_cfg = resolve_level(full_env_name)
    config = dict(extra_cfg)
    if dataset_path:
        config["datasetPath"] = dataset_path
    config.update({k: str(v) for k, v in kwargs.items()})
    return DmLabEnv(
        level=level, width=width, height=height,
        num_action_repeats=num_action_repeats, seed=seed, config=config,
        renderer=renderer, with_instruction=with_instruction)
