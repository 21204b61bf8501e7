"""Networked multiplayer Doom: per-player games over VizDoom's UDP
netcode, lockstep stepping, and a vectorized multi-agent adapter.  A copy
of ``scalable_agent_tpu/envs/doom/multiplayer.py``; ``MultiAgentVectorEnv``
adds ``resync`` for the port's actor retry path.

Re-design of the reference multiplayer layer (reference:
envs/doom/multiplayer/doom_multiagent.py:25-220 per-player env,
doom_multiagent_wrapper.py:33-389 worker orchestration,
algorithms/utils/multi_agent.py:4-25 single-agent shim) for this
framework:

- ``DoomMultiplayerEnv`` extends ``DoomEnv`` with host/join game args
  (player 0 hosts ``-host N`` on a probed UDP port, others ``-join``),
  named or difficulty-sampled bots re-added every reset, and — in
  true multi-agent lockstep mode — ``set_action``/``advance_action``
  stepping where only the designated update step renders state.
- ``MultiAgentEnv`` runs one worker (thread) per player with a task
  protocol; game init is retried up to 25 attempts on a fresh port
  because VizDoom's UDP handshake wedges nondeterministically
  (reference: doom_multiagent_wrapper.py:225-273).
- ``MultiAgentVectorEnv`` is the aggregator (reference:
  multi_env.py:345-389): K lockstep games x A agents presented as one
  ``MultiEnv``-shaped batch of K*A ImpalaStream-accounted envs, so the
  ActorPool consumes multiplayer Doom exactly like any other env batch.
"""

import logging
import os
import queue as queue_lib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from scalable_agent_tpu_torch.envs.doom.core import DoomEnv, convert_actions
from scalable_agent_tpu_torch.types import (
    Observation,
    StepOutput,
    StepOutputInfo,
)
from scalable_agent_tpu_torch.utils.net import (
    find_available_udp_port,
    is_udp_port_available,
)

log = logging.getLogger("scalable_agent_tpu_torch")

DEFAULT_UDP_PORT = int(os.environ.get("DOOM_DEFAULT_UDP_PORT", 40300))

# consistent bot names (reference: doom_multiagent.py:52-61)
BOT_NAMES = (
    "Blazkowicz", "PerfectBlue", "PerfectRed", "PerfectGreen",
    "PerfectPurple", "PerfectYellow", "PerfectWhite", "PerfectLtGreen",
)


class DoomMultiplayerEnv(DoomEnv):
    """One player's view of a networked deathmatch."""

    def __init__(
        self,
        action_space,
        config_file: str,
        player_id: int,
        num_agents: int,
        max_num_players: int,
        num_bots: int,
        skip_frames: int = 1,
        respawn_delay: int = 0,
        port: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(action_space, config_file,
                         skip_frames=skip_frames, **kwargs)
        self.player_id = player_id
        self.num_agents = num_agents
        self.max_num_players = max_num_players
        self.num_bots = num_bots
        self.respawn_delay = respawn_delay
        self.port = port if port is not None else DEFAULT_UDP_PORT
        self.update_state = True
        self.is_multiplayer = True
        self.hardest_bot = 100
        self.easiest_bot = 10

    def _is_server(self) -> bool:
        return self.player_id == 0

    def _customize_game(self, game):
        """Host/join args (reference: doom_multiagent.py:75-141)."""
        if self._is_server():
            if not is_udp_port_available(self.port):
                raise RuntimeError(f"UDP port {self.port} unavailable")
            game.add_game_args(" ".join([
                f"-host {self.max_num_players}",
                f"-port {self.port}",
                "-deathmatch",
                "+timelimit 4.0",
                "+sv_forcerespawn 1",
                "+sv_noautoaim 1",
                "+sv_respawnprotect 1",
                "+sv_spawnfarthest 1",
                "+sv_nocrouch 1",
                "+sv_nojump 1",
                "+sv_nofreelook 1",
                "+sv_noexit 1",
                f"+viz_respawn_delay {self.respawn_delay}",
                "+viz_connect_timeout 4",
            ]))
            game.add_game_args(
                f"+name AI{self.player_id}_host +colorset 0")
        else:
            game.add_game_args(
                f"-join 127.0.0.1:{self.port} +viz_connect_timeout 4 ")
            game.add_game_args(f"+name AI{self.player_id} +colorset 0")

    def _add_bots(self):
        """Fresh bots every episode — named, or difficulty-sampled when
        a curriculum set bot_difficulty_mean (reference:
        doom_multiagent.py:143-188)."""
        self.game.send_game_command("removebots")
        names = list(BOT_NAMES)
        self._rng.shuffle(names)
        used = set()
        for i in range(self.num_bots):
            if self.bot_difficulty_mean is None:
                suffix = f" {names[i]}" if i < len(names) else ""
                self.game.send_game_command(f"addbot{suffix}")
            else:
                diff = self._rng.normal(self.bot_difficulty_mean,
                                        self.bot_difficulty_std)
                diff = int(round(diff, -1))
                diff = min(self.hardest_bot,
                           max(self.easiest_bot, diff))
                while True:
                    name = f"BOT_{diff}_{self._rng.integers(0, max(1, self.num_bots))}"
                    if name not in used:
                        used.add(name)
                        break
                self.game.send_game_command(f"addbot {name}")

    def reset(self):
        obs = super().reset()
        if self._is_server() and self.num_bots > 0:
            self._add_bots()
        self.update_state = True
        return obs

    def step(self, action):
        if self.skip_frames > 1 or self.num_agents == 1:
            # single agent (+ maybe bots): plain make_action stepping
            # (reference: doom_multiagent.py:190-195)
            return super().step(action)
        # Lockstep multi-agent: every player advances exactly one tic;
        # only the final (update) tic renders state
        # (reference: doom_multiagent.py:197-220).
        self._ensure_game()
        self.game.set_action(convert_actions(self.action_space, action))
        self.game.advance_action(1, self.update_state)
        if not self.update_state:
            return None, None, None, None
        state = self.game.get_state()
        reward = self.game.get_last_reward()
        done = self.game.is_episode_finished()
        info: Dict[str, float] = {}
        if not done:
            frame = self._frame_from_state(state)
            info.update(self.get_info(self._variables_dict(state)))
            self._prev_info = dict(info)
        else:
            frame = self._black_screen()
            info.update(self._prev_info)
        self._fix_bugged_variables(info)
        return (Observation(frame=frame), np.float32(reward), bool(done),
                info)

    def _ensure_game(self):
        # DELIBERATELY bypasses the base class's cross-process init
        # lock (core.py _init_serialized): a multiplayer match's games
        # MUST initialize concurrently — the host's game.init() blocks
        # until every joiner connects, so serializing them would
        # deadlock the rendezvous.  Init races are covered by the
        # wrapper's retry-with-kill loop instead (the reference makes
        # the same trade: doom_multiagent_wrapper.py:225-273 retries,
        # no FileLock on the multiplayer path).
        if self.game is None:
            try:
                self.game = self._make_game()
            except Exception:
                log.warning("multiplayer game.init() failed "
                            "(player %d, port %d)", self.player_id,
                            self.port)
                raise


class _TaskType:
    INIT, TERMINATE, RESET, STEP, STEP_UPDATE, INFO = range(6)


class _PlayerWorker:
    """One thread driving one player's env (reference:
    doom_multiagent_wrapper.py:57-141).  Threads, not processes: the
    VizDoom games synchronize over UDP, and each game instance already
    runs its engine off-thread, so player workers mostly block."""

    def __init__(self, player_id: int, make_env_fn: Callable):
        self.player_id = player_id
        self.make_env_fn = make_env_fn
        self.task_queue: queue_lib.Queue = queue_lib.Queue()
        self.result_queue: queue_lib.Queue = queue_lib.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = None
        while True:
            data, task = self.task_queue.get()
            try:
                if task == _TaskType.INIT:
                    env = self.make_env_fn(player_id=self.player_id,
                                           port=data)
                    env.reset()
                    self.result_queue.put(None)
                    continue
                if task == _TaskType.TERMINATE:
                    if env is not None:
                        env.close()
                    self.result_queue.put(None)
                    return
                if task == _TaskType.RESET:
                    self.result_queue.put(env.reset())
                elif task == _TaskType.INFO:
                    self.result_queue.put(
                        env.unwrapped.get_info())
                elif task in (_TaskType.STEP, _TaskType.STEP_UPDATE):
                    env.unwrapped.update_state = (
                        task == _TaskType.STEP_UPDATE)
                    self.result_queue.put(env.step(data))
                else:
                    raise ValueError(f"unknown task {task}")
            except Exception as exc:  # surface to the orchestrator
                self.result_queue.put(exc)
                if task == _TaskType.INIT:
                    continue


class MultiAgentEnv:
    """A agents in one networked match, stepped in lockstep.

    ``step(actions)`` takes a list of A actions and returns
    ``(obs_list, reward_list, done_list, info_list)``; when ALL agents
    are done the match resets and obs are the next episode's first
    frames (reference: doom_multiagent_wrapper.py:285-300).
    """

    INIT_ATTEMPTS = 25

    def __init__(self, num_agents: int, make_env_fn: Callable,
                 skip_frames: int = 4, port_base: Optional[int] = None,
                 port_increment: int = 1000):
        self.num_agents = num_agents
        self.skip_frames = skip_frames
        self._make_env_fn = make_env_fn
        self._port_base = port_base or DEFAULT_UDP_PORT
        self._port_increment = port_increment
        self._workers: Optional[List[_PlayerWorker]] = None
        # Spaces probed from a throwaway player env — construction is
        # cheap because the game itself initializes lazily (reference
        # queries a player_id=-1 temp env, doom_multiagent_wrapper.py:
        # 151-160).
        probe = make_env_fn(player_id=-1, port=None)
        self.action_space = probe.action_space
        self.observation_spec = probe.observation_spec
        probe.close()

    # -- init with retry ---------------------------------------------------

    def _try_init_once(self) -> bool:
        port = find_available_udp_port(self._port_base,
                                       increment=self._port_increment)
        self._workers = [
            _PlayerWorker(i, self._make_env_fn)
            for i in range(self.num_agents)
        ]
        for worker in self._workers:
            worker.task_queue.put((port, _TaskType.INIT))
            time.sleep(0.01)  # host must bind before joins arrive
        deadline = time.monotonic() + 15.0
        for worker in self._workers:
            try:
                result = worker.result_queue.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue_lib.Empty:
                return False
            if isinstance(result, Exception):
                log.warning("player %d init failed: %r",
                            worker.player_id, result)
                return False
        return True

    def _ensure_initialized(self):
        if self._workers is not None:
            return
        for attempt in range(self.INIT_ATTEMPTS):
            if self._try_init_once():
                log.debug("multiplayer env up after %d attempt(s)",
                          attempt + 1)
                return
            self._teardown_workers()
            time.sleep(0.5)
        raise RuntimeError(
            f"multiplayer env failed to initialize after "
            f"{self.INIT_ATTEMPTS} attempts")

    def _teardown_workers(self):
        if self._workers is None:
            return
        for worker in self._workers:
            worker.task_queue.put((None, _TaskType.TERMINATE))
        # Await the terminations: the TERMINATE task runs env.close(),
        # which now includes RecordingWrapper's final-episode flush —
        # fire-and-forget on daemon threads would race that write with
        # process exit (or with a caller reading recordings right after
        # close()).  Bounded join so a wedged VizDoom can't hang
        # teardown.
        for worker in self._workers:
            worker.thread.join(timeout=10.0)
        self._workers = None

    # -- lockstep protocol -------------------------------------------------

    def _await(self, data, task, timeout: float = 60.0):
        assert self._workers is not None
        if data is None:
            data = [None] * self.num_agents
        for worker, item in zip(self._workers, data):
            worker.task_queue.put((item, task))
        results = []
        for worker in self._workers:
            result = worker.result_queue.get(timeout=timeout)
            if isinstance(result, Exception):
                raise result
            results.append(result)
        return results

    def reset(self) -> List[Observation]:
        self._ensure_initialized()
        return self._await(None, _TaskType.RESET)

    def step(self, actions: List):
        self._ensure_initialized()
        # frameskip: repeat the action skip-1 times without state
        # updates, then one rendering step
        # (reference: doom_multiagent_wrapper.py:285-300)
        for _ in range(self.skip_frames - 1):
            self._await(actions, _TaskType.STEP)
        stepped = self._await(actions, _TaskType.STEP_UPDATE)
        obs = [s[0] for s in stepped]
        rewards = [float(s[1]) for s in stepped]
        dones = [bool(s[2]) for s in stepped]
        infos = [dict(s[3]) for s in stepped]
        for info in infos:
            info["num_frames"] = self.skip_frames
        if all(dones):
            obs = self._await(None, _TaskType.RESET)
        return obs, rewards, dones, infos

    def close(self):
        self._teardown_workers()


class MultiAgentWrapper:
    """1-agent shim so single-player code can drive a MultiAgentEnv
    (reference: algorithms/utils/multi_agent.py:4-25)."""

    def __init__(self, env: MultiAgentEnv):
        if env.num_agents != 1:
            raise ValueError("MultiAgentWrapper wraps 1-agent envs only")
        self.env = env

    def reset(self):
        return self.env.reset()[0]

    def step(self, action):
        obs, rewards, dones, infos = self.env.step([action])
        return obs[0], rewards[0], dones[0], infos[0]

    def close(self):
        self.env.close()


class MultiAgentVectorEnv:
    """K lockstep matches x A agents as one MultiEnv-shaped batch.

    The aggregator role (reference: multi_env.py:345-389): the ActorPool
    sees ``num_envs = K * A`` independent ImpalaStream-accounted envs;
    internally actions route to each match in lockstep.  Matches step
    sequentially in ``step_recv`` — each match's players already run on
    their own threads, so the games themselves overlap.
    """

    def __init__(self, make_multi_env_fns: List[Callable],
                 stats_episodes: int = 100):
        self._envs = [make() for make in make_multi_env_fns]
        self.num_agents = self._envs[0].num_agents
        self.num_envs = sum(e.num_agents for e in self._envs)
        self.episode_stats = deque(maxlen=stats_episodes)
        self._returns = np.zeros((self.num_envs,), np.float64)
        self._steps = np.zeros((self.num_envs,), np.int64)
        self._pending_actions = None
        # Known at construction (probed specs), so consumers that size
        # buffers up front — ActorPool's accum mode reads
        # frame_slab().shape in __init__ — work before any reset.
        self._frame_shape = tuple(
            self._envs[0].observation_spec.frame.shape)

    def _batch(self, obs_list, rewards, dones, emitted_info):
        frames = np.stack([np.asarray(o.frame) for o in obs_list])
        measurements = None
        if obs_list and obs_list[0].measurements is not None:
            measurements = np.stack(
                [np.asarray(o.measurements) for o in obs_list])
        returns, steps = emitted_info
        return StepOutput(
            reward=np.asarray(rewards, np.float32),
            info=StepOutputInfo(
                episode_return=np.asarray(returns, np.float32),
                episode_step=np.asarray(steps, np.int32)),
            done=np.asarray(dones, bool),
            observation=Observation(frame=frames, instruction=None,
                                    measurements=measurements),
        )

    def initial(self) -> StepOutput:
        obs = []
        for env in self._envs:
            obs.extend(env.reset())
        self._returns[:] = 0.0
        self._steps[:] = 0
        return self._batch(
            obs, np.zeros((self.num_envs,)),
            np.ones((self.num_envs,), bool),
            (self._returns.copy(), self._steps.copy()))

    def step_send(self, actions) -> None:
        actions = np.asarray(actions)
        if actions.shape[0] != self.num_envs:
            raise ValueError(
                f"got {actions.shape[0]} actions for {self.num_envs}")
        self._pending_actions = actions

    def step_recv(self) -> StepOutput:
        if self._pending_actions is None:
            raise RuntimeError("step_recv without step_send")
        actions = self._pending_actions
        self._pending_actions = None
        obs_all, rew_all, done_all = [], [], []
        index = 0
        for env in self._envs:
            per_agent = [actions[index + a] for a in range(env.num_agents)]
            obs, rewards, dones, _ = env.step(per_agent)
            obs_all.extend(obs)
            rew_all.extend(rewards)
            done_all.extend(dones)
            index += env.num_agents
        # ImpalaStream accounting: emitted info includes the final step;
        # carried accumulators reset on done (envs/core.py ImpalaStream).
        self._returns += np.asarray(rew_all)
        self._steps += 1
        emitted = (self._returns.copy(), self._steps.copy())
        for i, done in enumerate(done_all):
            if done:
                self.episode_stats.append(
                    (float(self._returns[i]), int(self._steps[i])))
                self._returns[i] = 0.0
                self._steps[i] = 0
        return self._batch(obs_all, rew_all, done_all, emitted)

    def step(self, actions) -> StepOutput:
        self.step_send(actions)
        return self.step_recv()

    def resync(self) -> None:
        """Drop a pending step after an exception of unknown provenance
        (the actor retry path, ``runtime/actor.py``); the next
        ``initial()`` resets every match."""
        self._pending_actions = None

    def frame_slab(self) -> np.ndarray:
        return np.zeros((self.num_envs,) + self._frame_shape, np.uint8)

    def avg_episode_return(self) -> float:
        if not self.episode_stats:
            return float("nan")
        return float(np.mean([r for r, _ in self.episode_stats]))

    def close(self):
        for env in self._envs:
            env.close()


def make_doom_multiplayer_env(
    spec,
    skip_frames: int = 4,
    width: int = 128,
    height: int = 72,
    num_agents: Optional[int] = None,
    num_bots: Optional[int] = None,
    num_humans: int = 0,
    port_base: Optional[int] = None,
    port_increment: int = 1000,
    seed: Optional[int] = None,
    **kwargs,
):
    """Multiplayer routing (reference: doom_utils.py:220-258): >1 agent
    builds the lockstep MultiAgentEnv (frameskip handled by the
    wrapper, so per-player envs run skip=1); exactly one agent (vs
    bots) hosts a normal game and steps natively.  ``seed`` decorrelates
    matches: player seeds derive from it, so two matches built with
    different seeds play different games."""
    from scalable_agent_tpu_torch.envs.doom.specs import assemble_doom_env

    agents = spec.num_agents if num_agents is None else num_agents
    bots = spec.num_bots if num_bots is None else num_bots
    max_players = agents + num_humans
    is_multiagent = agents > 1

    def make_player_env(player_id: int, port: Optional[int] = None):
        base = DoomMultiplayerEnv(
            spec.action_space, spec.config_file,
            player_id=player_id, num_agents=agents,
            max_num_players=max_players, num_bots=bots,
            skip_frames=1 if is_multiagent else skip_frames,
            respawn_delay=spec.respawn_delay, port=port,
        )
        if player_id >= 0:  # probe envs (player_id=-1) skip seeding
            # seed=0 is a valid explicit seed (only None means unset),
            # and the per-player field is wide enough (1000) that no
            # realistic num_agents can alias the match-seed digits.
            match_seed = 0 if seed is None else seed
            base.seed(match_seed * 1000 + player_id + 1)
        player_kwargs = dict(kwargs)
        # Per-player recording: every player writes its own episode
        # stream into <record_to>/player_NN — a shared directory would
        # interleave concurrent player threads' episode numbering
        # (role of the reference's record path,
        # envs/env_wrappers.py:433-497, which is single-agent only).
        # The wrapper goes OUTSIDE the assembled pipeline so recordings
        # carry what the policy saw (resized frames, shaped rewards) —
        # the same convention as single-agent eval recording
        # (envs/__init__.py make_impala_stream).  Probe envs
        # (player_id=-1) never record.
        record_to = player_kwargs.pop("record_to", None)
        assembled = assemble_doom_env(
            spec, width=width, height=height, env=base, num_bots=bots,
            **player_kwargs)
        if record_to and player_id >= 0:
            from scalable_agent_tpu_torch.envs.wrappers import RecordingWrapper

            inner = assembled
            assembled = RecordingWrapper(
                inner, os.path.join(record_to, f"player_{player_id:02d}"))
            # assemble_doom_env pins native_action_repeats on its
            # outermost wrapper (wrappers don't forward arbitrary
            # attributes, specs.py) — re-establish the invariant on the
            # new outermost layer.
            assembled.native_action_repeats = getattr(
                inner, "native_action_repeats", 1)
        return assembled

    if is_multiagent:
        return MultiAgentEnv(agents, make_player_env,
                             skip_frames=skip_frames,
                             port_base=port_base,
                             port_increment=port_increment)
    port = find_available_udp_port(port_base or DEFAULT_UDP_PORT)
    return make_player_env(0, port=port)
