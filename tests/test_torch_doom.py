"""The port's Doom family (``scalable_agent_tpu_torch/envs/doom/``), its
generic wrappers and multi-agent training and eval, under the fake VizDoom
of ``tests/fakes/vizdoom.py``: torch twins of ``tests/test_doom.py``'s
classes (action spaces, the env core, the battle pipeline and its reward
shaping, the native repeats, multiplayer host/join arguments and the duel
lockstep, per-player recording, the aggregator feeding the pool and the
learner, the histogram and automap, the exploration wrapper, the init
lock, the human-input step, the driver on ``doom_benchmark`` and
``doom_duel``), and the port's env outputs against the JAX package's, bit
for bit, over the same seeded steps: single-agent streams (frames,
rewards, dones, episode info, measurements), lockstep matches and the
recorded episode files.

``TestAccumMeasurements`` holds the accum actor against the structural one
on a measurements level.  ``TestTools`` and ``TestDoomRenderGrid`` twin
``tests/test_doom.py::TestTools`` and
``tests/test_utils_algo.py::TestDoomRenderGrid`` (``envs/doom/tools.py``),
the grid bit for bit with the JAX one.  The twins of the JAX tests
marked slow keep the mark.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

FAKES_DIR = os.path.join(os.path.dirname(__file__), "fakes")


@pytest.fixture(scope="module", autouse=True)
def fake_vizdoom(tmp_path_factory):
    """Shadow ``vizdoom`` with the deterministic fake and generate
    scenario .cfg files (sys.path is inherited by spawned env worker
    subprocesses; DOOM_SCENARIOS_DIR rides os.environ), as
    ``tests/test_doom.py`` does."""
    scenarios = tmp_path_factory.mktemp("scenarios")
    single = ("HEALTH ARMOR SELECTED_WEAPON SELECTED_WEAPON_AMMO "
              "FRAGCOUNT DEATHCOUNT HITCOUNT DAMAGECOUNT DEAD "
              "POSITION_X POSITION_Y")
    multi = (single + " PLAYER_NUM PLAYER_COUNT PLAYER1_FRAGCOUNT "
             "PLAYER2_FRAGCOUNT")
    cfgs = {
        "basic.cfg": single,
        "battle.cfg": single,
        "battle_continuous_turning.cfg": single,
        "health_gathering.cfg": "HEALTH",
        "two_colors_easy.cfg": "HEALTH",
        "ssl2.cfg": multi,
        "dwango5_dm_continuous_weap.cfg": multi,
    }
    for name, variables in cfgs.items():
        (scenarios / name).write_text(
            "# fake scenario for hermetic tests\n"
            f"doom_scenario_path = {name.replace('.cfg', '.wad')}\n"
            f"available_game_variables = {{ {variables} }}\n")
    sys.path.insert(0, FAKES_DIR)
    os.environ["DOOM_SCENARIOS_DIR"] = str(scenarios)
    sys.modules.pop("vizdoom", None)
    yield
    sys.path.remove(FAKES_DIR)
    sys.modules.pop("vizdoom", None)
    os.environ.pop("DOOM_SCENARIOS_DIR", None)


DUEL_ACTION = (0, 0, 0, 0, 0, 0, 10)


class TestActionSpaces:
    def test_variant_shapes(self):
        from scalable_agent_tpu_torch.envs import doom as d
        from scalable_agent_tpu_torch.envs.spaces import calc_num_logits
        from scalable_agent_tpu_torch.ops.distributions import (
            spec_for_space)

        num_actions = lambda space: spec_for_space(space).num_components
        assert num_actions(d.doom_action_space_basic()) == 2
        assert calc_num_logits(d.doom_action_space_basic()) == 6
        assert num_actions(d.doom_action_space_discretized_no_weap()) == 5
        assert calc_num_logits(
            d.doom_action_space_discretized_no_weap()) == 3 + 3 + 2 + 2 + 11
        full = d.doom_action_space_full_discretized(with_use=True)
        assert num_actions(full) == 7
        assert calc_num_logits(full) == 3 + 3 + 8 + 2 + 2 + 2 + 21

    def test_convert_one_hot_noop(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import convert_actions

        space = doom_action_space_basic()
        assert convert_actions(space, (0, 0)) == [0, 0, 0, 0]
        assert convert_actions(space, (1, 2)) == [1, 0, 0, 1]

    def test_convert_discretized_grid(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_discretized_no_weap)
        from scalable_agent_tpu_torch.envs.doom.core import convert_actions

        space = doom_action_space_discretized_no_weap()
        assert convert_actions(space, (0, 0, 0, 0, 0))[-1] == -10.0
        assert convert_actions(space, (0, 0, 0, 0, 10))[-1] == 10.0
        assert convert_actions(space, (0, 0, 0, 0, 5))[-1] == 0.0

    def test_convert_box_scaling(self):
        from scalable_agent_tpu_torch.envs.doom import doom_action_space
        from scalable_agent_tpu_torch.envs.doom.core import convert_actions

        flat = convert_actions(
            doom_action_space(),
            (0, 0, 0, 0, 0, np.asarray([0.5], np.float32)))
        assert flat[-1] == pytest.approx(0.5 * 7.5)  # delta scaling

    def test_convert_plain_discrete(self):
        from scalable_agent_tpu_torch.envs.doom.core import convert_actions
        from scalable_agent_tpu_torch.envs.spaces import Discrete

        assert convert_actions(Discrete(9), 3) == [0, 0, 1, 0, 0, 0, 0, 0]

    @pytest.mark.parametrize("name", [
        "doom_action_space_basic", "doom_action_space",
        "doom_action_space_discretized",
        "doom_action_space_discretized_no_weap",
        "doom_action_space_continuous_no_weap",
        "doom_action_space_discrete", "doom_action_space_discrete_no_weap",
        "doom_action_space_full_discretized"])
    def test_spaces_and_conversions_match_jax(self, name):
        """Each variant's components and its button lists over seeded
        samples equal the JAX package's."""
        from scalable_agent_tpu.envs.doom import action_space as jax_spaces
        from scalable_agent_tpu.envs.doom.core import (
            convert_actions as jax_convert)
        from scalable_agent_tpu_torch.envs.doom import action_space
        from scalable_agent_tpu_torch.envs.doom.core import convert_actions

        ours = getattr(action_space, name)()
        theirs = getattr(jax_spaces, name)()
        assert repr(ours) == repr(theirs)
        rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(20):
            a, b = ours.sample(rng_a), theirs.sample(rng_b)
            assert convert_actions(ours, a) == jax_convert(theirs, b)


class TestDoomEnvCore:
    def test_benchmark_env_lifecycle(self):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("doom_benchmark", num_action_repeats=4)
        try:
            assert env.observation_spec.frame.shape == (72, 128, 3)
            obs = env.reset()
            assert obs.frame.shape == (72, 128, 3)
            total_steps, done = 0, False
            while not done:
                obs, reward, done, info = env.step(3)
                total_steps += 1
                assert isinstance(float(reward), float)
            assert total_steps == 16  # 64 fake tics / 4-skip
            assert "HEALTH" in info
            assert not obs.frame.any()  # the black terminal screen
        finally:
            env.close()

    def test_game_variable_info_and_bug_workaround(self):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("doom_benchmark", num_action_repeats=4)
        try:
            env.reset()
            _, _, done, info = env.step(0)
            assert info["HEALTH"] == pytest.approx(100.0 - 4)
            while not done:
                _, _, done, info1 = env.step(0)
            env.reset()
            _, _, _, info2 = env.step(0)
            raw_hit = 4 // 4  # fake: HITCOUNT = tic // 4 at tic 4
            assert info2["HITCOUNT"] == pytest.approx(
                raw_hit - info1["HITCOUNT"])
        finally:
            env.close()

    def test_missing_scenario_errors_clearly(self):
        from scalable_agent_tpu_torch.envs.doom.core import (
            resolve_scenario_path)

        with pytest.raises(FileNotFoundError, match="nope.cfg"):
            resolve_scenario_path("nope.cfg")

    def test_other_families_still_raise(self):
        """Every family of the JAX package is ported (``device_`` was the
        last): none is left unported, ``device_grid_small`` builds its
        host twin, the ``atari_``, ``dmlab_`` and ``gym_`` names resolve
        to their factories, and an unknown prefix still raises."""
        from scalable_agent_tpu_torch.envs import create_env, registry

        assert registry.UNPORTED_FAMILIES == ()
        env = create_env("device_grid_small")
        assert env.observation_spec.frame.shape == (15, 15, 3)
        for name in ("atari_pong", "dmlab_nav", "gym_CartPole-v1"):
            assert registry._lookup(name)[0] is not registry._make_fake
        with pytest.raises(ValueError, match="unknown env name"):
            create_env("nope_level")


class TestDoomPipeline:
    def test_battle_composite_pipeline(self):
        from scalable_agent_tpu_torch.envs import create_env
        from scalable_agent_tpu_torch.envs.spaces import TupleSpace

        env = create_env("doom_battle", num_action_repeats=4)
        try:
            assert isinstance(env.action_space, TupleSpace)
            obs = env.reset()
            assert obs.measurements.shape == (23,)
            assert env.observation_spec.measurements.shape == (23,)
            obs, reward, done, info = env.step((1, 0, 1, 0, 5))
            assert obs.measurements[2] == pytest.approx(
                info["HEALTH"] / 30.0)
            assert "true_reward" not in info  # only set on done
        finally:
            env.close()

    def test_battle_reward_shaping_applies(self):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("doom_battle", num_action_repeats=4)
        try:
            env.reset()
            env.step((0, 0, 0, 0, 5))  # the first step primes prev_vars
            _, reward2, _, _ = env.step((0, 0, 0, 0, 5))
            raw = sum((t % 5) * 0.1 for t in (5, 6, 7, 8))
            assert float(reward2) != pytest.approx(raw)
        finally:
            env.close()

    def test_impala_stream_native_repeats(self):
        from scalable_agent_tpu_torch.envs import make_impala_stream

        stream = make_impala_stream("doom_benchmark", seed=3,
                                    num_action_repeats=4)
        try:
            stream.initial()
            steps_to_done, done = 0, False
            while not done:
                done = bool(stream.step(1).done)
                steps_to_done += 1
                assert steps_to_done <= 16, "episode ended late"
            assert steps_to_done == 16, steps_to_done
        finally:
            stream.close()


def _stream_outputs(make_impala_stream, name, seed, steps, action_fn,
                    **kwargs):
    """``steps`` outputs of a seeded stream after its initial one, each a
    flat tuple of numpy leaves, stepped by ``action_fn(t)``."""
    stream = make_impala_stream(name, seed=seed, num_action_repeats=4,
                                **kwargs)
    try:
        outs = [stream.initial()]
        outs += [stream.step(action_fn(t)) for t in range(steps)]
    finally:
        stream.close()
    return [_leaves(out) for out in outs]


def _leaves(out):
    obs = out.observation
    return (np.asarray(out.reward), np.asarray(out.done),
            np.asarray(out.info.episode_return),
            np.asarray(out.info.episode_step), np.asarray(obs.frame),
            None if obs.measurements is None
            else np.asarray(obs.measurements))


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for t, (a, b) in enumerate(zip(ours, theirs)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x is None or y is None:
                assert x is None and y is None, (t, i)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (t, i)
            np.testing.assert_array_equal(x, y, err_msg=f"step {t} leaf {i}")


class TestAccumMeasurements:
    def test_accum_matches_structural_on_battle(self):
        """Accum == structural on a measurements-carrying Doom level: the
        ``DoomAdditionalInput`` float32 vector rides the per-step upload
        into its own buffer (reference:
        envs/doom/wrappers/additional_input.py:7-96)."""
        from scalable_agent_tpu_torch.envs import (
            MultiEnv,
            TensorSpec,
            create_env,
            make_impala_stream,
        )
        from scalable_agent_tpu_torch.models import ImpalaAgent
        from scalable_agent_tpu_torch.runtime import VectorActor
        from scalable_agent_tpu_torch.runtime.accum_actor import (
            AccumPrograms,
            AccumVectorActor,
        )
        from scalable_agent_tpu_torch.runtime.actor import to_numpy

        t, b = 4, 2
        probe = create_env("doom_battle", num_action_repeats=4, width=64,
                           height=36)
        try:
            spec = probe.observation_spec
            action_space = probe.action_space
        finally:
            probe.close()
        assert spec.measurements is not None
        frame = TensorSpec(tuple(spec.frame.shape), np.uint8, "frame")
        agent = ImpalaAgent(frame_shape=frame.shape,
                            action_space=action_space, core_size=16,
                            generator=torch.Generator().manual_seed(0))

        def make_group():
            fns = [functools.partial(
                make_impala_stream, "doom_battle", seed=100 + i,
                num_action_repeats=4, width=64, height=36)
                for i in range(b)]
            return MultiEnv(fns, frame, num_workers=1)

        envs_a, envs_b = make_group(), make_group()
        try:
            structural = VectorActor(agent, envs_a, t, seed=5)
            programs = AccumPrograms(
                agent, t, b, frame.shape,
                measurements_shape=tuple(spec.measurements.shape))
            accum = AccumVectorActor(programs, envs_b, seed=5)
            for unroll in range(2):
                s = structural.run_unroll()
                a = to_numpy(accum.run_unroll())
                msg = f"unroll {unroll}"
                assert a.env_outputs.observation.measurements.dtype == (
                    np.float32)
                np.testing.assert_allclose(
                    s.env_outputs.observation.measurements,
                    a.env_outputs.observation.measurements, rtol=1e-6,
                    err_msg=msg)
                np.testing.assert_array_equal(
                    s.env_outputs.observation.frame,
                    a.env_outputs.observation.frame, err_msg=msg)
                # A composite policy: actions [T+1, B, K].
                assert a.agent_outputs.action.shape == (
                    s.agent_outputs.action.shape)
                np.testing.assert_array_equal(
                    s.agent_outputs.action, a.agent_outputs.action,
                    err_msg=msg)
                np.testing.assert_allclose(
                    s.agent_outputs.policy_logits,
                    a.agent_outputs.policy_logits, rtol=1e-5, atol=1e-6,
                    err_msg=msg)
        finally:
            envs_a.close()
            envs_b.close()


class TestOutputsMatchJax:
    """The port's env outputs equal the JAX package's bit for bit."""

    @pytest.mark.parametrize("name", ["doom_benchmark", "doom_battle",
                                      "doom_deathmatch_bots"])
    def test_streams_match_jax(self, name):
        """40 seeded random-action steps, past episode boundaries."""
        from scalable_agent_tpu.envs import create_env as jax_create
        from scalable_agent_tpu.envs import make_impala_stream as jax_stream
        from scalable_agent_tpu_torch.envs import make_impala_stream

        probe = jax_create(name, num_action_repeats=4)
        space = probe.action_space
        probe.close()
        rng = np.random.default_rng(11)
        actions = [space.sample(rng) for _ in range(40)]
        ours = _stream_outputs(make_impala_stream, name, 5, 40,
                               actions.__getitem__)
        theirs = _stream_outputs(jax_stream, name, 5, 40,
                                 actions.__getitem__)
        _assert_same(ours, theirs)
        assert any(bool(o[1]) for o in ours[1:])  # an episode ended

    def test_lockstep_matches_match_jax(self):
        """Two doom_duel matches as one batch of 4 agent slots: 40 steps
        of seeded actions, every field of the batched outputs."""
        from scalable_agent_tpu.envs import create_env as jax_create
        from scalable_agent_tpu.envs.doom.multiplayer import (
            MultiAgentVectorEnv as JaxVector)
        from scalable_agent_tpu_torch.envs import create_env
        from scalable_agent_tpu_torch.envs.doom.multiplayer import (
            MultiAgentVectorEnv)

        def run(vector_cls, create, port):
            vec = vector_cls([functools.partial(
                create, "doom_duel", num_action_repeats=4, seed=3 + m,
                port_base=port + 7 * m, port_increment=50)
                for m in range(2)])
            rng = np.random.default_rng(2)
            space = create("doom_duel").action_space
            try:
                outs = [vec.initial()]
                for _ in range(40):
                    outs.append(vec.step(np.stack(
                        [np.asarray(space.sample(rng)) for _ in range(4)])))
            finally:
                vec.close()
            return [_leaves(out) for out in outs], list(vec.episode_stats)

        ours, our_stats = run(MultiAgentVectorEnv, create_env, 41300)
        theirs, their_stats = run(JaxVector, jax_create, 42300)
        _assert_same(ours, theirs)
        assert our_stats == their_stats and our_stats

    def test_recordings_match_jax(self, tmp_path):
        """``record_to`` writes the same episode files in both packages."""
        from scalable_agent_tpu.envs import make_impala_stream as jax_stream
        from scalable_agent_tpu_torch.envs import make_impala_stream

        for stream_fn, sub in ((make_impala_stream, "ours"),
                               (jax_stream, "theirs")):
            _stream_outputs(stream_fn, "doom_battle", 9, 20,
                            lambda t: (t % 3, 1, 0, 1, t % 11),
                            record_to=str(tmp_path / sub))
        ours = sorted(p.relative_to(tmp_path / "ours")
                      for p in (tmp_path / "ours").rglob("*.*"))
        theirs = sorted(p.relative_to(tmp_path / "theirs")
                        for p in (tmp_path / "theirs").rglob("*.*"))
        assert ours == theirs and len(ours) >= 2
        for rel in ours:
            assert ((tmp_path / "ours" / rel).read_bytes()
                    == (tmp_path / "theirs" / rel).read_bytes()), rel


class TestMultiplayer:
    def test_bots_host_setup(self):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("doom_deathmatch_bots", num_action_repeats=4)
        try:
            env.reset()
            game = env.unwrapped.game
            assert any("-host 1" in a for a in game.args)
            assert "removebots" in game.commands
            assert sum(1 for c in game.commands
                       if c.startswith("addbot")) == 7
            obs, _, _, _ = env.step((0, 0, 0, 0, 0, 10))
            assert obs.measurements is not None
        finally:
            env.close()

    def test_duel_lockstep_two_agents(self):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("doom_duel", num_action_repeats=4)
        try:
            assert env.num_agents == 2
            assert len(env.reset()) == 2
            obs, rewards, dones, _ = env.step([DUEL_ACTION, DUEL_ACTION])
            assert len(obs) == len(rewards) == len(dones) == 2
            assert not any(dones)
            # 4-frameskip via lockstep: 3 silent ticks + 1 update tick
            for _ in range(15):
                obs, rewards, dones, _ = env.step([DUEL_ACTION,
                                                   DUEL_ACTION])
            assert all(dones)
            assert obs[0].frame.shape == (72, 128, 3)  # the auto-reset's
        finally:
            env.close()

    def test_per_player_recording(self, tmp_path):
        from scalable_agent_tpu_torch.envs import create_env

        record_dir = tmp_path / "rec"
        env = create_env("doom_duel", num_action_repeats=4,
                         record_to=str(record_dir))
        try:
            env.reset()
            for _ in range(16):  # past one episode boundary
                env.step([DUEL_ACTION, DUEL_ACTION])
        finally:
            env.close()  # flushes the episode in flight
        for player in ("player_00", "player_01"):
            episodes = sorted((record_dir / player).glob("episode_*"))
            assert episodes, f"no recordings for {player}"
            assert episodes[0].name == "episode_00000"
            frames = np.load(episodes[0] / "frames.npy")
            meta = json.loads((episodes[0] / "episode.json").read_text())
            assert len(meta["actions"]) >= 1
            assert len(meta["actions"]) == len(meta["rewards"])
            assert frames.shape[0] == len(meta["actions"]) + 1
            assert frames.ndim == 4 and frames.shape[-1] == 3

    def test_host_and_join_args(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.multiplayer import (
            DoomMultiplayerEnv)

        host = DoomMultiplayerEnv(
            doom_action_space_basic(), "ssl2.cfg", player_id=0,
            num_agents=2, max_num_players=2, num_bots=0, port=40655)
        join = DoomMultiplayerEnv(
            doom_action_space_basic(), "ssl2.cfg", player_id=1,
            num_agents=2, max_num_players=2, num_bots=0, port=40655)
        try:
            host.reset()
            join.reset()
            assert any("-host 2" in a for a in host.game.args)
            assert any("-join 127.0.0.1:40655" in a
                       for a in join.game.args)
        finally:
            host.close()
            join.close()


class TestAggregator:
    def test_aggregator_feeds_actor_pool_and_learner(self):
        """Two doom_duel matches as one group of 4 slots through the
        port's ActorPool, then one learner update over the trajectory."""
        from scalable_agent_tpu_torch.envs import create_env
        from scalable_agent_tpu_torch.envs.doom.multiplayer import (
            MultiAgentVectorEnv)
        from scalable_agent_tpu_torch.models import ImpalaAgent
        from scalable_agent_tpu_torch.runtime import (
            ActorPool,
            Learner,
            LearnerHyperparams,
        )
        from scalable_agent_tpu_torch.runtime.actor import to_device
        from scalable_agent_tpu_torch.runtime.transport import (
            host_trajectory)

        T = 4
        vec = MultiAgentVectorEnv([
            functools.partial(create_env, "doom_duel", num_action_repeats=4,
                              seed=m, port_base=43300 + 11 * m)
            for m in range(2)])
        assert vec.num_envs == 4
        probe = create_env("doom_duel", num_action_repeats=4)
        space = probe.action_space  # cheap: no game starts
        probe.close()
        agent = ImpalaAgent(frame_shape=(72, 128, 3), action_space=space,
                            core_size=16,
                            generator=torch.Generator().manual_seed(0))
        pool = ActorPool(agent, [vec], unroll_length=T, seed=5)
        pool.set_params(agent)
        pool.start()
        try:
            out = pool.get_trajectory(timeout=120)
        finally:
            pool.stop()
        assert out.agent_outputs.action.shape == (T + 1, 4, 7)
        assert out.env_outputs.observation.measurements.shape == (
            T + 1, 4, 23)
        learner = Learner(agent, LearnerHyperparams(), T * 4 * 4)
        metrics = learner.update(to_device(host_trajectory(out),
                                           torch.device("cpu")))
        assert np.isfinite(float(metrics["total_loss"]))


def _driver_config(tmp_path, **fields):
    from scalable_agent_tpu_torch.config import Config

    base = dict(mode="train", logdir=str(tmp_path / "logs"), num_actors=4,
                batch_size=2, unroll_length=3, num_action_repeats=4,
                compute_dtype="float32", checkpoint_interval_s=1e9,
                device="cpu")
    base.update(fields)
    return Config(**base)


class TestDriverDoom:
    def test_driver_trains_on_doom_benchmark(self, tmp_path):
        """The driver builds and trains --level_name=doom_benchmark at
        Doom's 72x128 frames (the family's defaults) under the fake
        simulator, its env workers in subprocesses."""
        from scalable_agent_tpu_torch.config import Config
        from scalable_agent_tpu_torch.driver import train

        config = _driver_config(
            tmp_path, level_name="doom_benchmark",
            num_env_workers_per_group=2,
            total_environment_frames=3 * 2 * 3 * 4)
        metrics = train(config)
        assert np.isfinite(metrics["total_loss"])
        assert metrics["env_frames"] == config.total_environment_frames
        saved = Config.load(str(tmp_path / "logs" / "config.json"))
        assert (saved.height, saved.width) == (72, 128)


class TestDriverMultiAgent:
    @pytest.mark.slow
    def test_driver_trains_on_multiagent_level(self, tmp_path):
        """driver --level_name=doom_duel end to end: make_env_groups routes
        the 2-agent level into MultiAgentVectorEnv groups."""
        from scalable_agent_tpu_torch.driver import train

        config = _driver_config(tmp_path, level_name="doom_duel",
                                total_environment_frames=2 * 3 * 2 * 4)
        metrics = train(config)
        assert np.isfinite(metrics["total_loss"])
        assert metrics["env_frames"] == config.total_environment_frames

    @pytest.mark.slow
    def test_multiagent_eval_after_train(self, tmp_path):
        """--mode=test on a multi-agent level: self-play over lockstep
        matches, recorded per match and player."""
        _train_then_eval(tmp_path, num_episodes=4)

    def test_duel_trains_then_records_per_match_and_player(self,
                                                           tmp_path):
        """The two runs above in one short pass (1 update, 2 episodes),
        so that tier-1 drives the multi-agent train and eval paths."""
        _train_then_eval(tmp_path, num_episodes=2, updates=1)

    def test_actor_service_refuses_lockstep_matches(self, tmp_path):
        """A multi-agent level's groups step their matches in lockstep and
        have no per-worker API: --actor=service raises, naming the flag,
        before any env starts."""
        from scalable_agent_tpu_torch.driver import train

        config = _driver_config(tmp_path, level_name="doom_duel",
                                actor="service")
        with pytest.raises(ValueError, match="--actor=service"):
            train(config)

    def test_batch_size_must_divide_by_agents(self, tmp_path):
        from scalable_agent_tpu_torch.driver import make_env_groups
        from scalable_agent_tpu_torch.envs.spec import TensorSpec

        config = _driver_config(tmp_path, level_name="doom_duel",
                                num_actors=3, batch_size=3)
        with pytest.raises(ValueError, match="num_agents"):
            make_env_groups(config, TensorSpec((72, 128, 3), np.uint8),
                            num_agents=2)

    def test_multiagent_refuses_benchmark_mode(self, tmp_path):
        from scalable_agent_tpu_torch.driver import make_env_groups
        from scalable_agent_tpu_torch.envs.spec import TensorSpec

        config = _driver_config(tmp_path, level_name="doom_duel",
                                benchmark_mode=True)
        with pytest.raises(ValueError, match="benchmark_mode"):
            make_env_groups(config, TensorSpec((72, 128, 3), np.uint8),
                            num_agents=2)

    def test_match_port_scheme_matches_jax(self):
        from scalable_agent_tpu import driver as jax_driver
        from scalable_agent_tpu_torch.driver import match_port_scheme

        for total in (1, 2, 8, 64, 400):
            assert match_port_scheme(total) == (
                jax_driver.match_port_scheme(total))
        with pytest.raises(ValueError, match="UDP"):
            match_port_scheme(100000)


def _train_then_eval(tmp_path, num_episodes, updates=2):
    import dataclasses

    from scalable_agent_tpu_torch.driver import test as run_test
    from scalable_agent_tpu_torch.driver import train

    config = _driver_config(tmp_path, level_name="doom_duel",
                            checkpoint_interval_s=0.0,
                            total_environment_frames=updates * 3 * 2 * 4)
    train(config)
    record_dir = tmp_path / "recordings"
    returns = run_test(dataclasses.replace(
        config, mode="test", test_num_episodes=num_episodes,
        test_batch_size=4, record_to=str(record_dir)))
    assert list(returns) == ["doom_duel"]
    assert len(returns["doom_duel"]) == num_episodes
    assert all(np.isfinite(r) for r in returns["doom_duel"])
    match_dirs = sorted((record_dir / "doom_duel").glob("match_*"))
    assert [m.name for m in match_dirs] == ["match_00", "match_01"]
    for match in match_dirs:
        players = sorted(match.glob("player_*"))
        assert [p.name for p in players] == ["player_00", "player_01"]
        for player in players:
            episodes = sorted(player.glob("episode_*"))
            assert episodes, f"no episodes recorded in {player}"
            assert (episodes[0] / "frames.npy").exists()
            assert (episodes[0] / "episode.json").exists()


class TestHistogramAndAutomap:
    def test_position_histogram_tracks_and_rolls_over(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv

        env = DoomEnv(doom_action_space_basic(), "battle.cfg",
                      coord_limits=(0.0, 0.0, 100.0, 50.0),
                      max_histogram_length=20)
        try:
            assert env.current_histogram.shape == (20, 10)  # aspect 2:1
            env.reset()
            for _ in range(5):
                env.step((0, 0))
            assert env.current_histogram.sum() == 5
            env.reset()
            assert env.current_histogram.sum() == 0
            assert env.previous_histogram.sum() == 5
        finally:
            env.close()

    def test_automap_buffer(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv

        env = DoomEnv(doom_action_space_basic(), "battle.cfg",
                      show_automap=True)
        try:
            env.reset()
            env.step((0, 0))
            automap = env.get_automap_buffer()
            assert automap is not None and automap.shape[2] == 3
            assert env.game.automap_mode == "OBJECTS"
        finally:
            env.close()

    def test_no_histogram_without_coord_limits(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv

        env = DoomEnv(doom_action_space_basic(), "battle.cfg")
        try:
            assert env.current_histogram is None
            env.reset()
            env.step((0, 0))  # no crash without the histogram
        finally:
            env.close()


class TestExplorationWrapper:
    def test_landmark_bonus_then_silence(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv
        from scalable_agent_tpu_torch.envs.doom.wrappers import (
            DoomExplorationWrapper)

        env = DoomExplorationWrapper(
            DoomEnv(doom_action_space_basic(), "battle.cfg"),
            threshold=75.0, bonus=0.1)
        try:
            env.reset()
            _, _, _, info = env.step((0, 0))
            assert info["intrinsic_reward"] == pytest.approx(0.1)
            # fake positions advance by (13, 29) per tic: within the
            # threshold of the first landmark, so no new bonus
            _, _, _, info = env.step((0, 0))
            assert info["intrinsic_reward"] == pytest.approx(0.0)
            env.reset()  # clears the landmarks
            _, _, _, info = env.step((0, 0))
            assert info["intrinsic_reward"] == pytest.approx(0.1)
        finally:
            env.close()


class TestInitLock:
    def test_concurrent_init_critical_sections_do_not_overlap(self):
        """Concurrent first inits serialize on the file lock: the
        ``_make_game`` critical sections are disjoint in time."""
        import threading
        import time
        from unittest import mock

        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv

        spans = []
        orig = DoomEnv._make_game

        def slow_make(self):
            start = time.monotonic()
            time.sleep(0.3)
            game = orig(self)
            spans.append((start, time.monotonic()))
            return game

        envs = [DoomEnv(doom_action_space_basic(), "basic.cfg")
                for _ in range(2)]
        errors = []

        def init(env):
            try:
                env.reset()
            except Exception as exc:  # noqa: BLE001 - collected for assert
                errors.append(exc)

        threads = [threading.Thread(target=init, args=(e,)) for e in envs]
        try:
            with mock.patch.object(DoomEnv, "_make_game", slow_make):
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
            assert not errors, errors
            assert all(e.game is not None for e in envs)
            assert len(spans) == 2
            first, second = sorted(spans)
            assert second[0] >= first[1] - 0.01, (
                f"init critical sections overlapped: {spans}")
        finally:
            for e in envs:
                e.close()


class TestStepHumanInput:
    def test_ignores_policy_action_and_advances(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv
        from scalable_agent_tpu_torch.envs.doom.wrappers import (
            StepHumanInput)

        env = StepHumanInput(DoomEnv(doom_action_space_basic(), "basic.cfg"))
        try:
            env.reset()
            game = env.unwrapped.game
            assert game.mode == "ASYNC_SPECTATOR"
            assert game.window_visible
            tic_before = game.tic
            obs, _, _, info = env.step("not-even-an-action")
            assert game.tic == tic_before + 1
            assert (obs.frame.shape
                    == env.unwrapped.observation_spec.frame.shape)
            assert info["num_frames"] == 1
            assert "step" not in vars(env.unwrapped)  # restored
        finally:
            env.close()

    def test_human_step_flows_through_wrapper_pipeline(self):
        from scalable_agent_tpu_torch.envs.doom.specs import (
            assemble_doom_env,
            doom_spec_by_name,
        )
        from scalable_agent_tpu_torch.envs.doom.wrappers import (
            StepHumanInput)

        env = StepHumanInput(
            assemble_doom_env(doom_spec_by_name("doom_battle")))
        try:
            obs0 = env.reset()
            obs, _, _, _ = env.step(None)
            assert obs.frame.shape == obs0.frame.shape  # resized alike
            assert obs.measurements is not None
            assert obs.measurements.shape == obs0.measurements.shape
        finally:
            env.close()

    def test_spectator_rearmed_after_game_recreation(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv
        from scalable_agent_tpu_torch.envs.doom.wrappers import (
            StepHumanInput)

        env = StepHumanInput(DoomEnv(doom_action_space_basic(), "basic.cfg"))
        try:
            env.reset()
            env.unwrapped.close()  # game -> None
            env.reset()
            assert env.unwrapped.game.mode == "ASYNC_SPECTATOR"
        finally:
            env.close()

    def test_human_steps_update_position_histogram(self):
        from scalable_agent_tpu_torch.envs.doom import (
            doom_action_space_basic)
        from scalable_agent_tpu_torch.envs.doom.core import DoomEnv
        from scalable_agent_tpu_torch.envs.doom.wrappers import (
            StepHumanInput)

        env = StepHumanInput(
            DoomEnv(doom_action_space_basic(), "battle.cfg",
                    coord_limits=(0.0, 0.0, 100.0, 50.0)))
        try:
            env.reset()
            for _ in range(4):
                env.step(None)
            assert env.unwrapped.current_histogram.sum() == 4
        finally:
            env.close()


class TestTools:
    def test_sample_cli_converts_numeric_args(self):
        """main() int()-converts the numeric CLI args before they reach
        range() and the env (the JAX package's regression: '500' crashed
        sample_env)."""
        from scalable_agent_tpu_torch.envs.doom import tools

        tools.main(["sample", "doom_basic", "8", "2", "3"])

    def test_concat_grid(self):
        from scalable_agent_tpu_torch.envs.doom import tools

        frames = [np.full((4, 6, 3), i, np.uint8) for i in range(3)]
        grid = tools.concat_grid(frames)
        assert grid.shape == (8, 12, 3)
        assert (grid[:4, :6] == 0).all() and (grid[:4, 6:] == 1).all()

    def test_cli_rejects_bad_commands(self):
        from scalable_agent_tpu_torch.envs.doom import tools

        with pytest.raises(SystemExit, match="unknown command"):
            tools.main(["fly"])
        with pytest.raises(SystemExit, match="usage: replay"):
            tools.main(["replay", "doom_basic"])


class TestDoomRenderGrid:
    def test_concat_grid_tiles(self):
        from scalable_agent_tpu_torch.envs.doom.tools import concat_grid

        frames = [np.full((4, 6, 3), i, np.uint8) for i in range(3)]
        grid = concat_grid(frames)
        assert grid.shape == (8, 12, 3)  # 2x2 grid for 3 frames
        assert (grid[:4, :6] == 0).all()
        assert (grid[:4, 6:12] == 1).all()
        assert (grid[4:, :6] == 2).all()
        assert (grid[4:, 6:] == 0).all()  # empty cell

    @pytest.mark.parametrize("count", [1, 2, 5, 9, 10])
    def test_concat_grid_matches_jax(self, count):
        from scalable_agent_tpu.envs.doom.tools import (
            concat_grid as jax_concat_grid,
        )
        from scalable_agent_tpu_torch.envs.doom.tools import concat_grid

        rng = np.random.default_rng(count)
        frames = [rng.integers(0, 256, (3, 5, 3), dtype=np.uint8)
                  for _ in range(count)]
        np.testing.assert_array_equal(concat_grid(frames),
                                      jax_concat_grid(frames))
        with pytest.raises(ValueError, match="no frames"):
            concat_grid([])
