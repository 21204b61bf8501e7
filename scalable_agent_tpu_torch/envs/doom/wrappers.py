"""Doom-specific wrappers: measurements input, reward shaping, bot
curriculum, multiplayer standings, resolution control.  A copy of
``scalable_agent_tpu/envs/doom/wrappers.py``.

Re-designs of the reference wrapper set over this framework's
``Environment``/``Observation`` protocol (reference: envs/doom/wrappers/
additional_input.py:7-96, reward_shaping.py:38-246, bot_difficulty.py:
6-57, multiplayer_stats.py:7-60, scenario_wrappers/
gathering_reward_shaping.py:4-33, observation_space.py:10-48).  All
shaping constants match the reference exactly — they are calibration
values the learned policies depend on.
"""

import logging
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment, Wrapper
from scalable_agent_tpu_torch.envs.spec import TensorSpec

log = logging.getLogger("scalable_agent_tpu_torch")

EPS = 1e-5
NUM_WEAPONS = 8

# Weapon preferences bias pickup/ammo/selection shaping toward stronger
# guns (reference: reward_shaping.py:10-34).
WEAPON_PREFERENCE = {2: 1, 3: 5, 4: 5, 5: 5, 6: 10, 7: 10}


def _weapon_delta_rewards() -> Dict[str, tuple]:
    rewards = {}
    for weapon in range(NUM_WEAPONS):
        pref = WEAPON_PREFERENCE.get(weapon, 1)
        rewards[f"WEAPON{weapon}"] = (+0.02 * pref, -0.01 * pref)
        rewards[f"AMMO{weapon}"] = (+0.0002 * pref, -0.0001 * pref)
    return rewards


def _selected_weapon_rewards() -> Dict[str, float]:
    return {f"SELECTED{w}": 0.0002 * WEAPON_PREFERENCE.get(w, 1)
            for w in range(NUM_WEAPONS)}


def _scheme(delta_overrides: Dict[str, tuple]) -> Dict[str, dict]:
    """A shaping scheme: per-variable (reward-per-unit-up, per-unit-down)
    deltas plus selected-weapon persistence rewards."""
    delta = dict(
        FRAGCOUNT=(+1, -1.5),
        DEATHCOUNT=(-0.75, +0.75),
        HITCOUNT=(+0.01, -0.01),
        DAMAGECOUNT=(+0.003, -0.003),
        HEALTH=(+0.005, -0.003),
        ARMOR=(+0.005, -0.001),
        **_weapon_delta_rewards(),
    )
    delta.update(delta_overrides)
    return dict(delta=delta, selected_weapon=_selected_weapon_rewards())


# (reference: reward_shaping.py:38-67)
REWARD_SHAPING_DEATHMATCH_V0 = _scheme({})
REWARD_SHAPING_DEATHMATCH_V1 = _scheme(dict(
    FRAGCOUNT=(+1, -0.001),
    DEATHCOUNT=(-1, +1),
    HITCOUNT=(0, 0),
    DAMAGECOUNT=(+0.01, -0.01),
    HEALTH=(+0.01, -0.01),
))
REWARD_SHAPING_BATTLE = _scheme(dict(AMMO2=(+0.02, -0.001)))


def true_reward_final_position(info: Dict) -> float:
    """Win = 1, anything else (incl. ties) = 0.
    (reference: reward_shaping.py:70-79)"""
    if info["LEADER_GAP"] == 0:
        return 0.0
    if info["FINAL_PLACE"] > 1:
        return 0.0
    return 1.0


def true_reward_frags(info: Dict) -> float:
    return float(info["FRAGCOUNT"])


class DoomRewardShaping(Wrapper):
    """Game-variable deltas -> shaped scalar reward; reports the
    unshaped "true" episode reward in ``info['true_reward']``.

    (reference: reward_shaping.py:86-246)
    """

    # caps so BFG/shotgun multi-hits don't dominate
    # (reference: reward_shaping.py:97)
    DELTA_LIMITS = dict(DAMAGECOUNT=200, HITCOUNT=5)

    def __init__(self, env: Environment, scheme: Optional[dict] = None,
                 true_reward_func: Optional[Callable] = None):
        super().__init__(env)
        self.scheme = scheme
        self.true_reward_func = true_reward_func
        self._prev_vars: Dict[str, float] = {}
        self._prev_dead = True
        self._orig_reward = 0.0
        self._selected_weapon = deque([], maxlen=5)
        self.reward_structure: Dict[str, float] = {}

    def _delta_rewards(self, info: Dict) -> float:
        reward = 0.0
        for name, (up, down) in self.scheme["delta"].items():
            if name not in self._prev_vars:
                continue
            delta = info.get(name, 0.0) - self._prev_vars[name]
            if name in self.DELTA_LIMITS:
                delta = min(delta, self.DELTA_LIMITS[name])
            if abs(delta) > EPS:
                shaped = delta * up if delta > EPS else -delta * down
                reward += shaped
                self.reward_structure[name] = (
                    self.reward_structure.get(name, 0.0) + shaped)
        return reward

    def _weapon_reward(self, selected: int, ammo: float) -> float:
        # reward keeping one weapon unholstered for 5 consecutive steps
        # (reference: reward_shaping.py:140-155)
        unholstered = (len(self._selected_weapon) > 4 and all(
            w == selected for w in self._selected_weapon))
        if ammo <= 0 or not unholstered:
            return 0.0
        reward = self.scheme["selected_weapon"].get(
            f"SELECTED{selected}", 0.0)
        key = f"weapon{selected}"
        self.reward_structure[key] = (
            self.reward_structure.get(key, 0.0) + reward)
        return reward

    def _shaping_reward(self, info: Dict, done: bool) -> float:
        if self.scheme is None:
            return 0.0
        selected = int(max(0, info.get("SELECTED_WEAPON", 0.0)))
        ammo = float(max(0.0, info.get("SELECTED_WEAPON_AMMO", 0.0)))
        self._selected_weapon.append(selected)
        just_respawned = self._prev_dead and not info.get("DEAD", 0.0)
        reward = 0.0
        if not done and not just_respawned:
            reward = self._delta_rewards(info)
            reward += self._weapon_reward(selected, ammo)
        return reward

    def reset(self):
        obs = self.env.reset()
        self._prev_vars = {}
        self._prev_dead = True
        self._orig_reward = 0.0
        self._selected_weapon.clear()
        self.reward_structure = {}
        return obs

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        self._orig_reward += float(reward)
        reward = np.float32(reward + self._shaping_reward(info, done))
        if self.scheme is not None:
            for name in self.scheme["delta"]:
                self._prev_vars[name] = info.get(name, 0.0)
        self._prev_dead = bool(info.get("DEAD", 0.0))
        if done:
            info["true_reward"] = (
                self._orig_reward if self.true_reward_func is None
                else self.true_reward_func(info))
        return obs, reward, done, info


class DoomAdditionalInput(Wrapper):
    """Expose DFP-scaled game-variable measurements as the observation's
    ``measurements`` vector (reference: additional_input.py:7-96; the
    reference uses a Dict obs space — here measurements are a first-class
    Observation field).
    """

    NUM_MEASUREMENTS = 7 + 2 * NUM_WEAPONS

    def __init__(self, env: Environment):
        super().__init__(env)
        self._vec = np.zeros((self.NUM_MEASUREMENTS,), np.float32)

    @property
    def observation_spec(self):
        return self.env.observation_spec._replace(
            measurements=TensorSpec(
                (self.NUM_MEASUREMENTS,), np.float32, "measurements"))

    def _measure(self, info: Dict) -> np.ndarray:
        v = self._vec
        selected = round(max(0, info.get("SELECTED_WEAPON", 0.0)))
        ammo = min(max(0.0, info.get("SELECTED_WEAPON_AMMO", 0.0)) / 15.0,
                   5.0)
        health = max(0.0, info.get("HEALTH", 0.0)) / 30.0
        v[0] = float(selected)
        v[1] = float(ammo)
        v[2] = float(health)
        v[3] = info.get("ARMOR", 0.0) / 30.0
        v[4] = info.get("USER2", 0.0) / 10.0  # kills (battle scenarios)
        v[5] = info.get("ATTACK_READY", 0.0)
        v[6] = info.get("PLAYER_COUNT", 1) / 5.0
        for w in range(NUM_WEAPONS):
            v[7 + w] = max(0.0, info.get(f"WEAPON{w}", 0.0))
            v[7 + NUM_WEAPONS + w] = min(
                max(0.0, info.get(f"AMMO{w}", 0.0)) / 15.0, 5.0)
        return v.copy()

    def reset(self):
        obs = self.env.reset()
        info = self.unwrapped.get_info()
        return obs._replace(measurements=self._measure(info))

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        return (obs._replace(measurements=self._measure(info)), reward,
                done, info)


class BotDifficultyWrapper(Wrapper):
    """Adaptive bot-skill curriculum from match standings.

    (reference: bot_difficulty.py:6-57.)  Note: like the reference,
    reset always publishes ``bot_difficulty_mean`` to the base env, so
    whenever this wrapper is in the pipeline (any bots>0 spec) the
    multiplayer env's named-bot fallback never fires — bots are always
    difficulty-sampled.  The named path only applies to bare
    DoomMultiplayerEnv usage.
    """

    MIN, MAX, STEP = 0, 150, 10

    def __init__(self, env: Environment,
                 initial_difficulty: Optional[int] = None):
        super().__init__(env)
        self.difficulty = (20 if initial_difficulty is None
                          else initial_difficulty)
        self._std = 10
        self._adaptive = initial_difficulty != self.MAX

    def _analyze_standings(self, info: Dict):
        if "FINAL_PLACE" not in info:
            return
        if info["FINAL_PLACE"] <= 1 and info.get("LEADER_GAP", 0.0) < 0:
            self.difficulty = min(self.difficulty + self.STEP, self.MAX)
        elif info["FINAL_PLACE"] >= int(info.get("PLAYER_COUNT", 1)) - 1:
            self.difficulty = max(self.difficulty - self.STEP, self.MIN)

    def reset(self):
        base = self.unwrapped
        if hasattr(base, "bot_difficulty_mean"):
            base.bot_difficulty_mean = self.difficulty
            base.bot_difficulty_std = self._std
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        if done and self._adaptive:
            self._analyze_standings(info)
        info["BOT_DIFFICULTY"] = self.difficulty
        return obs, reward, done, info


class MultiplayerStatsWrapper(Wrapper):
    """Derive KDR / FINAL_PLACE / LEADER_GAP from per-player fragcounts,
    refreshed every 20 steps and on done (reference:
    multiplayer_stats.py:7-60).
    """

    def __init__(self, env: Environment):
        super().__init__(env)
        self._timestep = 0
        self._extra: Dict[str, float] = {}

    def _update(self, info: Dict, done: bool):
        if (self._timestep % 20 == 0 or done) and "FRAGCOUNT" in info:
            extra = {"KDR": float(
                info.get("FRAGCOUNT", 0.0)
                / (info.get("DEATHCOUNT", 0.0) + 1))}
            player_count = int(info.get("PLAYER_COUNT", 1))
            player_num = int(info.get("PLAYER_NUM", 1))
            frags = [int(info.get(f"PLAYER{p}_FRAGCOUNT", -100000))
                     for p in range(1, player_count + 1)]
            order = list(np.argsort(frags))
            place = player_count - order.index(player_num - 1)
            extra["FINAL_PLACE"] = place
            if place > 1:
                extra["LEADER_GAP"] = (
                    max(frags) - frags[player_num - 1])
            elif player_count > 1:
                top_two = sorted(frags, reverse=True)
                extra["LEADER_GAP"] = top_two[1] - top_two[0]  # <= 0
            else:
                extra["LEADER_GAP"] = 0
            self._extra = extra
        info.update(self._extra)

    def reset(self):
        self._timestep = 0
        self._extra = {}
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        self._update(info, done)
        self._timestep += 1
        return obs, reward, done, info


class DoomGatheringRewardShaping(Wrapper):
    """+1 whenever health increases (gathering scenarios).

    (reference: scenario_wrappers/gathering_reward_shaping.py:4-33)
    """

    def __init__(self, env: Environment):
        super().__init__(env)
        self._prev_health = None

    def reset(self):
        self._prev_health = None
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if obs is None:  # lockstep multiplayer non-update tick
            return obs, reward, done, info
        if info is not None and not done:
            health = info.get("HEALTH", 0.0)
            if (self._prev_health is not None
                    and health > self._prev_health):
                reward = np.float32(reward + 1.0)
            self._prev_health = health
        return obs, reward, done, info


# VizDoom's supported render resolutions (reference:
# observation_space.py:3-7 — names match vizdoom.ScreenResolution).
RESOLUTIONS = (
    "160x120", "200x125", "200x150", "256x144", "256x160", "256x192",
    "320x180", "320x200", "320x240", "320x256", "400x225", "400x250",
    "400x300", "512x288", "512x320", "512x384", "640x360", "640x400",
    "640x480", "800x450", "800x500", "800x600", "1024x576", "1024x640",
    "1024x768", "1280x720", "1280x800", "1280x960", "1280x1024",
    "1400x787", "1400x875", "1400x1050", "1600x900", "1600x1000",
    "1600x1200", "1920x1080",
)


def set_doom_resolution(env: DoomRewardShaping, resolution: str):
    """Configure the native render resolution before game init
    (reference: observation_space.py:10-48 — a wrapper there; a plain
    call here since our spec is a property of the base env)."""
    if resolution not in RESOLUTIONS:
        raise ValueError(
            f"unsupported VizDoom resolution {resolution!r}")
    width, height = (int(part) for part in resolution.split("x"))
    env.unwrapped.set_resolution(width, height, f"RES_{width}X{height}")
    log.debug("Doom native resolution set to %s", resolution)


class DoomExplorationWrapper(Wrapper):
    """Landmark-based exploration bonus (reference: wrappers/
    exploration.py:10-58): a pose (x, y, view angle) farther than
    ``threshold`` from every stored landmark — Euclidean distance plus
    half the wrapped angular difference — earns ``bonus`` intrinsic
    reward and becomes a landmark itself.  The bonus is surfaced via
    ``info['intrinsic_reward']`` and NOT added to the env reward,
    matching the reference; landmarks are randomly evicted past
    ``max_landmarks`` and cleared on reset.
    """

    def __init__(self, env: Environment, max_landmarks: int = 200,
                 threshold: float = 75.0, bonus: float = 0.1,
                 seed: int = 0):
        super().__init__(env)
        self.max_landmarks = int(max_landmarks)
        self.threshold = float(threshold)
        self.bonus = float(bonus)
        self._landmarks = []
        self._rng = np.random.default_rng(seed)

    def _intrinsic_reward(self, info: Dict) -> float:
        if "POSITION_X" not in info or "POSITION_Y" not in info:
            return 0.0
        x, y = info["POSITION_X"], info["POSITION_Y"]
        angle = info.get("ANGLE", 0.0)
        for lx, ly, la in self._landmarks:
            angle_diff = abs(angle - la)
            angle_diff = min(angle_diff, 360.0 - angle_diff)
            distance = np.hypot(x - lx, y - ly) + angle_diff / 2.0
            if distance < self.threshold:
                return 0.0
        self._landmarks.append((x, y, angle))
        while len(self._landmarks) > self.max_landmarks:
            del self._landmarks[int(self._rng.integers(
                0, len(self._landmarks)))]
        return self.bonus

    def reset(self):
        self._landmarks = []
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        info["intrinsic_reward"] = (
            info.get("intrinsic_reward", 0.0) + self._intrinsic_reward(info))
        return obs, reward, done, info


def _null_action(space):
    """A well-formed no-op for any composite action space (the human
    step ignores it, but intermediate wrappers see a valid action)."""
    from scalable_agent_tpu_torch.envs.spaces import Box, TupleSpace

    if isinstance(space, TupleSpace):
        return tuple(_null_action(s) for s in space.spaces)
    if isinstance(space, Box):
        return np.zeros(space.shape, np.float32)
    return 0


class StepHumanInput(Wrapper):
    """Human-driven stepping: the policy's action is IGNORED and the
    game advances on the human's own input (the underlying DoomGame is
    re-initialized into SPECTATOR mode with a visible window on first
    use).  The human transition is substituted at the BASE env and then
    flows out through the full wrapper chain, so resize / measurements /
    reward shaping all apply exactly as they do to policy steps.
    (reference: wrappers/step_human_input.py:7-38 — there via
    mode='human' and a raw screen-buffer observation that bypassed the
    pipeline; SPECTATOR is VizDoom's native mechanism.)
    """

    def __init__(self, env: Environment):
        super().__init__(env)
        self._spectator = False

    def _ensure_spectator(self):
        import vizdoom

        base = self.unwrapped
        # A closed/recreated game (base.game is None) loses the mode —
        # re-arm spectator rather than trusting the stale flag.
        if self._spectator and base.game is not None:
            return
        base._ensure_game()
        game = base.game
        game.close()
        game.set_window_visible(True)
        # ASYNC: the engine runs at real-time 35 tics/s on its own
        # clock — sync SPECTATOR would only advance when the step loop
        # polls, freezing the game under the human's hands.
        game.set_mode(vizdoom.Mode.ASYNC_SPECTATOR)
        game.init()
        self._spectator = True

    def reset(self):
        self._ensure_spectator()
        return self.env.reset()

    def step(self, action):
        del action  # input comes from the human at the game window
        self._ensure_spectator()
        base = self.unwrapped
        # Substitute the human transition at the base env so it flows
        # out through the whole wrapper chain; the bookkeeping itself
        # lives in DoomEnv.step_human (shared with policy steps).
        base.step = lambda _action: base.step_human()
        try:
            return self.env.step(_null_action(base.action_space))
        finally:
            del base.step  # restore the class method
