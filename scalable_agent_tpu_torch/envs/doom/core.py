"""The VizDoom simulator adapter, a copy of
``scalable_agent_tpu/envs/doom/core.py``.

The role of the reference's ``VizdoomEnv`` (reference:
envs/doom/doom_gym.py:52-562) on this framework's ``Environment``
protocol.  Behaviors reproduced:

- Lazy game construction: the ``vizdoom`` package imports on first
  ``reset``, and resolution/config may be adjusted by wrappers up until
  then (doom_gym.py:80-82, observation_space.py:10-48).
- Scenario configs load by file name; ``available_game_variables`` are
  parsed out of the .cfg so per-step info dicts carry named variables
  (doom_gym.py:200-223, 228-233).
- Composite action conversion: each Discrete subspace one-hots with
  index 0 as no-op, ``Discretized`` maps its index onto a continuous
  grid, ``Box`` components scale by the delta factor 7.5
  (doom_gym.py:277-308).
- ``skip_frames`` is passed to ``make_action`` — the simulator repeats
  natively, so this env declares ``native_action_repeats``
  (doom_gym.py:321-341, environments.py:111 for the DMLab analog).
- Black screen on the terminal step, info carried from the last live
  frame (doom_gym.py:223-226, 343-348).
- The VizDoom stale-variable bug workaround: DEATHCOUNT / HITCOUNT /
  DAMAGECOUNT don't reset on ``new_episode``; values from the previous
  episode are subtracted (doom_gym.py:310-319).

Scenario assets are NOT vendored: config files resolve against (in
order) an explicit ``scenarios_dir``, ``$DOOM_SCENARIOS_DIR``, the
installed ``vizdoom`` package's ``scenarios/`` directory, and a
``scenarios/`` directory next to this file, so the standard scenarios
work out of the box with a stock vizdoom install.
"""

import logging
import os
import re
from typing import Dict, Optional

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment, make_observation
from scalable_agent_tpu_torch.envs.spaces import (
    Box,
    Discrete,
    Discretized,
    TupleSpace,
)
from scalable_agent_tpu_torch.envs.spec import TensorSpec
from scalable_agent_tpu_torch.types import Observation

log = logging.getLogger("scalable_agent_tpu_torch")

# make_action delta-button scaling for Box components
# (reference: doom_gym.py:88)
DELTA_ACTIONS_SCALING_FACTOR = 7.5

_BUGGED_EPISODE_VARS = ("DEATHCOUNT", "HITCOUNT", "DAMAGECOUNT")


def resolve_scenario_path(config_file: str,
                          scenarios_dir: Optional[str] = None) -> str:
    """Find a scenario .cfg by name (see module docstring for order)."""
    candidates = []
    if scenarios_dir:
        candidates.append(os.path.join(scenarios_dir, config_file))
    env_dir = os.environ.get("DOOM_SCENARIOS_DIR")
    if env_dir:
        candidates.append(os.path.join(env_dir, config_file))
    try:
        import vizdoom

        candidates.append(os.path.join(
            os.path.dirname(vizdoom.__file__), "scenarios", config_file))
    except ImportError:
        pass
    candidates.append(os.path.join(
        os.path.dirname(__file__), "scenarios", config_file))
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"Doom scenario {config_file!r} not found; searched {candidates}. "
        f"Point scenarios_dir or $DOOM_SCENARIOS_DIR at a directory "
        f"containing the scenario .cfg/.wad files.")


def parse_variable_indices(config_path: str) -> Dict[str, int]:
    """available_game_variables = { A B C } -> {'A': 0, 'B': 1, 'C': 2}.

    (reference: doom_gym.py:200-223)
    """
    pattern = re.compile(r"available_game_variables\s*=\s*\{(.*)\}")
    indices: Dict[str, int] = {}
    with open(config_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            match = pattern.match(line)
            if match:
                names = match.group(1).split()
                indices.update({name: i for i, name in enumerate(names)})
                break
    return indices


def convert_actions(action_space, actions) -> list:
    """Composite gym-style action -> flattened VizDoom button list.

    (reference: doom_gym.py:277-308)
    """
    if isinstance(action_space, TupleSpace):
        spaces = action_space.spaces
    else:
        spaces = (action_space,)
        actions = (actions,)
    flattened = []
    for space, action in zip(spaces, actions):
        if isinstance(space, Box):
            flattened.extend(
                float(a) * DELTA_ACTIONS_SCALING_FACTOR
                for a in np.asarray(action).reshape(-1))
        elif isinstance(space, Discretized):
            flattened.append(space.to_continuous(action))
        elif isinstance(space, Discrete):
            one_hot = [0] * (space.n - 1)  # index 0 is the no-op
            if int(action) > 0:
                one_hot[int(action) - 1] = 1
            flattened.extend(one_hot)
        else:
            raise NotImplementedError(
                f"action subspace {space!r} is not supported")
    return flattened


class DoomEnv(Environment):
    """One VizDoom game instance behind the Environment protocol."""

    def __init__(
        self,
        action_space,
        config_file: str,
        skip_frames: int = 1,
        scenarios_dir: Optional[str] = None,
        async_mode: bool = False,
        record_to: Optional[str] = None,
        coord_limits=None,
        max_histogram_length: int = 200,
        show_automap: bool = False,
    ):
        self.action_space = action_space
        self.config_path = resolve_scenario_path(config_file, scenarios_dir)
        self.variable_indices = parse_variable_indices(self.config_path)
        self.skip_frames = max(1, int(skip_frames))
        # the simulator repeats natively via make_action(_, skip_frames)
        self.native_action_repeats = self.skip_frames
        self.async_mode = async_mode
        self.record_to = record_to
        self.game = None
        self._seed = 0
        self._rng = np.random.default_rng(0)
        # Adjustable until the first reset (SetDoomResolution wrapper).
        self.screen_w, self.screen_h, self.channels = 640, 480, 3
        self.screen_resolution_name = "RES_640X480"
        self._black = None
        self._prev_info: Dict[str, float] = {}
        self._last_episode_info: Optional[Dict[str, float]] = None
        self._num_episodes = 0
        # Multiplayer hooks (set by subclasses / wrappers).
        self.is_multiplayer = False
        self.bot_difficulty_mean = None
        self.bot_difficulty_std = 10

        # Positional-coverage histogram (reference: doom_gym.py:102-117,
        # 424-438): pass coord_limits=(x0, y0, x1, y1) to track where
        # the agent has been, aspect-scaled to max_histogram_length
        # bins on the longer side.  Needs POSITION_X/POSITION_Y among
        # available_game_variables.
        self.coord_limits = coord_limits
        self.max_histogram_length = int(max_histogram_length)
        self.current_histogram = self.previous_histogram = None
        if coord_limits:
            x = coord_limits[2] - coord_limits[0]
            y = coord_limits[3] - coord_limits[1]
            if x > y:
                len_x = self.max_histogram_length
                len_y = max(1, int(y / x * self.max_histogram_length))
            else:
                len_y = self.max_histogram_length
                len_x = max(1, int(x / y * self.max_histogram_length))
            self.current_histogram = np.zeros((len_x, len_y), np.int32)
            self.previous_histogram = np.zeros_like(self.current_histogram)

        # Engine top-down view (reference: doom_gym.py:171-189).
        self.show_automap = show_automap

    # -- spec --------------------------------------------------------------

    @property
    def observation_spec(self) -> Observation:
        return Observation(
            frame=TensorSpec(
                (self.screen_h, self.screen_w, self.channels),
                np.uint8, "frame"))

    def set_resolution(self, width: int, height: int, name: str):
        if self.game is not None:
            raise RuntimeError(
                "resolution must be set before the game initializes")
        self.screen_w, self.screen_h = width, height
        self.screen_resolution_name = name

    # -- lifecycle ---------------------------------------------------------

    def seed(self, seed: Optional[int]):
        if seed is not None:
            self._seed = int(seed)
            self._rng = np.random.default_rng(self._seed)

    def _make_game(self):
        """Build + init the DoomGame (reference: doom_gym.py:151-195)."""
        import vizdoom

        game = vizdoom.DoomGame()
        game.load_config(self.config_path)
        game.set_screen_resolution(
            getattr(vizdoom.ScreenResolution, self.screen_resolution_name))
        game.set_seed(int(self._rng.integers(0, 2**31 - 1)))
        game.set_window_visible(False)
        game.set_mode(vizdoom.Mode.ASYNC_PLAYER if self.async_mode
                      else vizdoom.Mode.PLAYER)
        if self.show_automap:
            # Object-level top-down map, centered, fixed orientation
            # (reference: doom_gym.py:171-189).
            game.set_automap_buffer_enabled(True)
            game.set_automap_mode(vizdoom.AutomapMode.OBJECTS)
            game.set_automap_rotate(False)
            game.set_automap_render_textures(False)
            game.add_game_args("+viz_am_center 1")
            game.add_game_args("+am_backcolor ffffff")
            game.add_game_args("+am_tswallcolor dddddd")
            game.add_game_args("+am_yourcolor ffffff")
            game.add_game_args("+am_cheat 0")
            game.add_game_args("+am_thingcolor 0000ff")
            game.add_game_args("+am_thingcolor_item 00ff00")
        self._customize_game(game)
        game.init()
        return game

    def _customize_game(self, game):
        """Subclass hook (multiplayer adds host/join args here)."""

    def _ensure_game(self):
        if self.game is None:
            self.game = self._init_serialized()

    def _init_serialized(self):
        """First game init, serialized ACROSS PROCESSES with a file
        lock: many workers initializing VizDoom simultaneously race on
        engine-side file extraction (reference: environments_doom.py:
        46-57 — FileLock + 10s-timeout retry loop).  fcntl.flock keeps
        it dependency-free.  Any environment where the lock cannot
        work — no fcntl (non-POSIX), unwritable lock path (another
        user's file), flock-unsupported filesystem — falls back to an
        UNLOCKED init, which is exactly the pre-lock behavior.
        """
        import errno
        import tempfile
        import time

        try:
            import fcntl
        except ImportError:
            return self._make_game()
        # Per-user path: /tmp is world-shared and another user's lock
        # file would be unwritable.
        lock_path = os.path.join(
            tempfile.gettempdir(),
            f"scalable_agent_tpu_doom_init_{os.getuid()}.lock")
        try:
            lock_file = open(lock_path, "a")
        except OSError:
            return self._make_game()
        attempt = 0
        with lock_file:
            while True:
                attempt += 1
                try:
                    fcntl.flock(lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError as exc:
                    if exc.errno not in (errno.EWOULDBLOCK, errno.EAGAIN,
                                         errno.EACCES):
                        # flock unsupported here (e.g. some NFS mounts):
                        # don't spin forever on an error that will never
                        # clear.
                        return self._make_game()
                    if attempt % 100 == 0:
                        log.info(
                            "another process holds the Doom init lock "
                            "(attempt %d)", attempt)
                    time.sleep(0.1)
                    continue
                try:
                    return self._make_game()
                finally:
                    fcntl.flock(lock_file, fcntl.LOCK_UN)

    # -- helpers -----------------------------------------------------------

    def _black_screen(self) -> np.ndarray:
        if self._black is None or self._black.shape[:2] != (
                self.screen_h, self.screen_w):
            self._black = np.zeros(
                (self.screen_h, self.screen_w, self.channels), np.uint8)
        return self._black

    def _frame_from_state(self, state) -> np.ndarray:
        buf = state.screen_buffer
        if buf is None:
            return self._black_screen()
        return np.transpose(np.asarray(buf), (1, 2, 0))

    def _variables_dict(self, state) -> Dict[str, float]:
        values = state.game_variables
        if values is None:
            return {}
        return {name: float(values[idx])
                for name, idx in self.variable_indices.items()}

    def get_info(self, variables: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
        """Latest game-variable info (wrappers read this on reset —
        reference: doom_gym.py:228-233, additional_input.py:88-91)."""
        if variables is None:
            return dict(self._prev_info)
        return dict(variables)

    def _update_histogram(self, info: Dict[str, float], eps: float = 1e-8):
        """Bin the agent's (x, y) into the coverage histogram
        (reference: doom_gym.py:424-438)."""
        if self.current_histogram is None:
            return
        if "POSITION_X" not in info or "POSITION_Y" not in info:
            return
        x0, y0, x1, y1 = self.coord_limits
        dx = (info["POSITION_X"] - x0) / (x1 - x0)
        dy = (info["POSITION_Y"] - y0) / (y1 - y0)
        ix = int((dx - eps) * self.current_histogram.shape[0])
        iy = int((dy - eps) * self.current_histogram.shape[1])
        ix = min(max(ix, 0), self.current_histogram.shape[0] - 1)
        iy = min(max(iy, 0), self.current_histogram.shape[1] - 1)
        self.current_histogram[ix, iy] += 1

    def get_automap_buffer(self) -> Optional[np.ndarray]:
        """HWC automap frame, or None once the episode finished
        (reference: doom_gym.py:415-422)."""
        if self.game is None or self.game.is_episode_finished():
            return None
        state = self.game.get_state()
        if state is None or state.automap_buffer is None:
            return None
        return np.transpose(np.asarray(state.automap_buffer), (1, 2, 0))

    def _fix_bugged_variables(self, info: Dict[str, float]):
        """Subtract previous-episode values of counters VizDoom fails to
        reset on new_episode (reference: doom_gym.py:310-319)."""
        if self._last_episode_info is None:
            return
        for name in _BUGGED_EPISODE_VARS:
            if name in info:
                info[name] -= self._last_episode_info.get(name, 0.0)

    # -- protocol ----------------------------------------------------------

    def reset(self):
        self._ensure_game()
        if self.record_to is not None and not self.is_multiplayer:
            os.makedirs(self.record_to, exist_ok=True)
            demo = os.path.join(
                self.record_to, f"ep_{self._num_episodes:03d}_rec.lmp")
            self.game.new_episode(demo)
        else:
            self.game.new_episode()
        state = self.game.get_state()
        self._last_episode_info = dict(self._prev_info)
        self._prev_info = {}
        self._num_episodes += 1
        if self.current_histogram is not None:
            self.previous_histogram = self.current_histogram.copy()
            self.current_histogram.fill(0)
        frame = (self._frame_from_state(state) if state is not None
                 else self._black_screen())
        return make_observation(frame)

    def _post_action(self, reward, num_frames: int):
        """Shared bookkeeping after the game advanced (by make_action
        OR by a human in spectator mode): frame/info assembly, info
        carry, histogram, stale-variable fix."""
        done = self.game.is_episode_finished()
        info: Dict[str, float] = {"num_frames": num_frames}
        if not done:
            state = self.game.get_state()
            frame = self._frame_from_state(state)
            variables = self._variables_dict(state)
            info.update(self.get_info(variables))
            self._prev_info = dict(info)
            self._update_histogram(info)
        else:
            frame = self._black_screen()
            # done=True forbids get_state; report the last live info
            # (reference: doom_gym.py:343-348)
            info.update(self._prev_info)
        self._fix_bugged_variables(info)
        return (make_observation(frame), np.float32(reward), bool(done),
                info)

    def step(self, action):
        flattened = convert_actions(self.action_space, action)
        reward = self.game.make_action(flattened, self.skip_frames)
        return self._post_action(reward, self.skip_frames)

    def step_human(self):
        """One transition driven by the human's own input (game in a
        SPECTATOR mode); same bookkeeping as a policy step.  In ASYNC
        modes the engine runs on its own clock, so num_frames is the
        MEASURED tic delta, not an assumed 1."""
        before_tic = self.game.get_episode_time()
        before_reward = self.game.get_total_reward()
        self.game.advance_action()
        # Total-reward delta, not get_last_reward(): in ASYNC modes
        # several tics elapse per poll and last-reward only covers the
        # final one.
        reward = self.game.get_total_reward() - before_reward
        elapsed = max(1, int(self.game.get_episode_time())
                      - int(before_tic))
        return self._post_action(reward, elapsed)

    def render(self, mode: str = "rgb_array"):
        state = self.game.get_state() if self.game is not None else None
        if state is None:
            return self._black_screen()
        return self._frame_from_state(state)

    def close(self):
        if self.game is not None:
            try:
                self.game.close()
            finally:
                self.game = None
