"""The port's device worlds (``scalable_agent_tpu_torch/envs/device/``)
held against the JAX package's.

The twins of ``tests/test_device_worlds.py``: the game rules on
hand-made states (key pickup, the door and the wall, the goal, the paddle,
bricks, gold and enemies, sticky actions), the host twin (the ``device_``
registry family) against the device stream, ``probe_env`` on a device
level, and the driver's in-graph runs on the real worlds.  Beside them,
each world's ``initial``/``step`` against the JAX world's on the same seeds
(the conformance seeds, ``max_seed`` included) and actions, bitwise, and
the hashed randomness against JAX's uint32 arithmetic.

Tolerances: none but where the JAX file states one (rewards and returns
summed in float32 on both sides are compared bitwise here; the host
twin's rewards at rtol 1e-6, as JAX holds them).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs.device import make_device_env as jax_make
from scalable_agent_tpu.envs.device import world as jax_world
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs.device import conformance, make_device_env
from scalable_agent_tpu_torch.envs.device import world
from scalable_agent_tpu_torch.envs.device.gridworld import (
    DeviceGridState,
    DeviceGridWorld,
)
from scalable_agent_tpu_torch.obs import get_registry


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU work here is small: one intra-op thread, so that the
    module does not fight the test runner's other workers for the cores
    (restored after the module)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


WORLDS = ("device_grid_small", "device_grid_large",
          "device_minatar_breakout", "device_minatar_asterix")


def _batched(value, dtype=torch.int32):
    return torch.tensor([value], dtype=dtype)


def _leaves(tree):
    return [t.numpy() for t in conformance.leaves(tree)]


# -- the worlds against JAX's, bitwise --------------------------------------


def test_hash_matches_jax_uint32():
    """``_mix``/``_rand_below``/``_uniform`` in int64 with 32-bit masks
    equal JAX's uint32 wraparound, negative terms and the int32 edges
    included."""
    rng = np.random.default_rng(0)
    terms = [rng.integers(-2**31, 2**31, size=64, dtype=np.int64).astype(
        np.int32) for _ in range(4)]
    terms[0][:3] = [2**31 - 1, -2**31, 0]
    for count in (1, 2, 4):
        want = np.asarray(jax_world._mix(*terms[:count]))
        got = world._mix(*(torch.from_numpy(t) for t in terms[:count]))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for n in (1, 2, 7, 100003):
        np.testing.assert_array_equal(
            world._rand_below(n, torch.from_numpy(terms[0]), 5).numpy(),
            np.asarray(jax_world._rand_below(n, terms[0], 5)))
    np.testing.assert_array_equal(
        world._uniform(torch.from_numpy(terms[1]), 3, 101).numpy(),
        np.asarray(jax_world._uniform(terms[1], 3, 101)))


@pytest.mark.parametrize("repeats", [1, 3])
@pytest.mark.parametrize("level", WORLDS)
def test_world_matches_jax_bitwise(level, repeats):
    """Every leaf of (state, output) after ``initial`` and each of 120
    steps equals the JAX world's, at the conformance seeds (the last one
    ``max_seed``)."""
    ours = make_device_env(level, num_action_repeats=repeats)
    theirs = jax_make(level, num_action_repeats=repeats)
    seeds = conformance.conformance_seeds(ours, 6)
    assert seeds[-1] == ours.max_seed == 2**31 - 1
    state, out = ours.initial(seeds)
    jstate, jout = theirs.initial(seeds)
    step = jax.jit(theirs.step)
    rng = np.random.default_rng(3)
    for t in range(121):
        for got, want in zip(_leaves((state, out)),
                             jax.tree_util.tree_leaves((jstate, jout))):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{level} t={t}")
        actions = rng.integers(0, ours.num_actions, size=6)
        state, out = ours.step(state, torch.as_tensor(actions))
        jstate, jout = step(jstate, jnp.asarray(actions, jnp.int32))


def test_sticky_breakout_matches_jax_bitwise():
    ours = make_device_env("device_minatar_breakout", sticky_prob=0.4)
    theirs = jax_make("device_minatar_breakout", sticky_prob=0.4)
    seeds = conformance.conformance_seeds(ours, 4)
    state, out = ours.initial(seeds)
    jstate, jout = theirs.initial(seeds)
    step = jax.jit(theirs.step)
    rng = np.random.default_rng(9)
    for _ in range(60):
        actions = rng.integers(0, 3, size=4)
        state, out = ours.step(state, torch.as_tensor(actions))
        jstate, jout = step(jstate, jnp.asarray(actions, jnp.int32))
    for got, want in zip(_leaves((state, out)),
                         jax.tree_util.tree_leaves((jstate, jout))):
        np.testing.assert_array_equal(got, np.asarray(want))


# -- gridworld dynamics ------------------------------------------------------


class TestGridWorld:
    SEED = 4

    def make(self):
        return make_device_env("device_grid_small")

    def layout(self, env, seed, episode=0):
        return [int(v) for v in env._layout(_batched(seed),
                                            _batched(episode))]

    def state_at(self, env, seed, row, col, has_key=0, door_open=0,
                 step=0):
        return DeviceGridState(
            seed=_batched(seed), episode=_batched(0), step=_batched(step),
            episode_return=_batched(0.0, torch.float32),
            episode_step=_batched(step), row=_batched(row),
            col=_batched(col), has_key=_batched(has_key),
            door_open=_batched(door_open))

    def step(self, env, state, action):
        return env.step(state, _batched(action))

    def toward(self, fr, fc, tr, tc):
        """The action moving one cell from (fr, fc) to (tr, tc)."""
        if tr == fr - 1:
            return 0
        if tr == fr + 1:
            return 1
        if tc == fc - 1:
            return 2
        assert tc == fc + 1
        return 3

    def key_neighbor(self, env, seed):
        wall, door, ar, ac, kr, kc, gr, gc = self.layout(env, seed)
        g = env.grid_size
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            r, c = kr + dr, kc + dc
            if 0 <= r < g and 0 <= c < wall:
                return (r, c), (kr, kc)
        raise AssertionError("key has no free near-side neighbor")

    def test_key_pickup_rewards_and_disappears(self):
        env = self.make()
        (r, c), (kr, kc) = self.key_neighbor(env, self.SEED)
        frame_before = env.step(self.state_at(env, self.SEED, r, c),
                                _batched(0))[1].observation.frame[0]
        state, out = self.step(env, self.state_at(env, self.SEED, r, c),
                               self.toward(r, c, kr, kc))
        assert float(out.reward[0]) == pytest.approx(0.5)
        assert int(state.has_key[0]) == 1
        assert int(state.row[0]) == kr and int(state.col[0]) == kc
        frame_after = out.observation.frame[0]
        assert bool((frame_before[..., 1] == 255).any())
        assert not bool((frame_after[..., 1] == 255).any())
        assert bool((frame_after[..., 1] == 192).any())
        state, out = self.step(env, state, self.toward(kr, kc, r, c))
        assert float(out.reward[0]) == 0.0
        state, out = self.step(env, state, self.toward(r, c, kr, kc))
        assert float(out.reward[0]) == 0.0

    def test_wall_blocks_and_door_needs_key(self):
        env = self.make()
        wall, door, *_ = self.layout(env, self.SEED)
        row = (door + 1) % env.grid_size
        state, out = self.step(env, self.state_at(env, self.SEED, row,
                                                  wall - 1), 3)
        assert int(state.col[0]) == wall - 1, "wall must block"
        assert float(out.reward[0]) == 0.0
        state, out = self.step(env, self.state_at(env, self.SEED, door,
                                                  wall - 1), 3)
        assert int(state.col[0]) == wall - 1, "locked door must block"
        state, out = self.step(env, self.state_at(
            env, self.SEED, door, wall - 1, has_key=1), 3)
        assert int(state.col[0]) == wall
        assert float(out.reward[0]) == pytest.approx(0.5)
        assert int(state.door_open[0]) == 1
        state, out = self.step(env, state, 2)
        state, out = self.step(env, state, 3)
        assert int(state.col[0]) == wall
        assert float(out.reward[0]) == 0.0

    def test_goal_terminates_with_bonus_and_autoresets(self):
        env = self.make()
        wall, door, ar, ac, kr, kc, gr, gc = self.layout(env, self.SEED)
        g = env.grid_size
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            r, c = gr + dr, gc + dc
            if 0 <= r < g and wall < c < g:
                break
        else:
            raise AssertionError("goal has no far-side neighbor")
        state, out = self.step(env, self.state_at(
            env, self.SEED, r, c, has_key=1, door_open=1),
            self.toward(r, c, gr, gc))
        assert float(out.reward[0]) == pytest.approx(1.0)
        assert bool(out.done[0])
        assert float(out.info.episode_return[0]) == pytest.approx(1.0)
        assert int(out.info.episode_step[0]) == 1
        assert int(state.episode[0]) == 1
        assert int(state.step[0]) == 0
        assert int(state.has_key[0]) == 0

    def test_horizon_truncates_without_bonus(self):
        env = self.make()
        wall, door, ar, ac, *_ = self.layout(env, self.SEED)
        state, out = self.step(env, self.state_at(
            env, self.SEED, ar, ac, step=env.episode_length - 1), 0)
        assert bool(out.done[0])
        assert float(out.reward[0]) < 1.0
        assert int(state.episode[0]) == 1

    def test_layouts_vary_by_episode_and_stay_solvable(self):
        env = DeviceGridWorld(grid_size=11, view=5, episode_length=96)
        layouts = {tuple(self.layout(env, 9, ep)) for ep in range(16)}
        assert len(layouts) > 8, "layout hash is not varying by episode"
        g = env.grid_size
        for wall, door, ar, ac, kr, kc, gr, gc in layouts:
            assert 2 <= wall <= g - 3
            assert 0 <= door < g
            assert ac < wall and kc < wall, "agent+key on the near side"
            assert gc > wall, "goal behind the wall"
            assert (ar, ac) != (kr, kc)


# -- minatar breakout dynamics -----------------------------------------------


class TestBreakout:
    def make(self, **kwargs):
        return make_device_env("device_minatar_breakout", **kwargs)

    def base_state(self, env, **overrides):
        state, _ = env.initial(np.asarray([2], np.int32))
        fields = {}
        for name, value in overrides.items():
            if name == "bricks":
                fields[name] = torch.as_tensor(value[None],
                                               dtype=torch.int32)
            else:
                fields[name] = _batched(value)
        return state._replace(**fields)

    def step(self, env, state, action):
        return env.step(state, _batched(action))

    def test_paddle_moves_and_clamps(self):
        env = self.make()
        state = self.base_state(env, paddle_c=0, ball_r=3, dir_r=1)
        state, _ = self.step(env, state, 1)
        assert int(state.paddle_c[0]) == 0
        state, _ = self.step(env, state, 2)
        assert int(state.paddle_c[0]) == 1

    def test_paddle_saves_the_ball(self):
        env = self.make()
        state = self.base_state(env, ball_r=8, ball_c=4, dir_r=1, dir_c=1,
                                paddle_c=5)
        state, out = self.step(env, state, 0)
        assert not bool(out.done[0])
        assert int(state.dir_r[0]) == -1, "save must bounce upward"
        assert int(state.ball_r[0]) == 8

    def test_missed_ball_ends_the_episode(self):
        env = self.make()
        state = self.base_state(env, ball_r=8, ball_c=4, dir_r=1, dir_c=1,
                                paddle_c=0)
        state, out = self.step(env, state, 0)
        assert bool(out.done[0])
        assert int(state.episode[0]) == 1

    def test_brick_hit_scores_and_bounces(self):
        env = self.make()
        state = self.base_state(env, ball_r=4, ball_c=4, dir_r=-1, dir_c=1)
        before = int(state.bricks[0].sum())
        state, out = self.step(env, state, 0)
        assert float(out.reward[0]) == pytest.approx(1.0)
        assert int(state.bricks[0].sum()) == before - 1
        assert int(state.dir_r[0]) == 1, "brick hit bounces downward"

    def test_cleared_wall_respawns(self):
        env = self.make()
        bricks = np.zeros((3, 10), np.int32)
        bricks[2, 5] = 1
        state = self.base_state(env, ball_r=4, ball_c=4, dir_r=-1, dir_c=1,
                                bricks=bricks)
        state, out = self.step(env, state, 0)
        assert float(out.reward[0]) == pytest.approx(1.0)
        assert int(state.bricks[0].sum()) == 30, "next wave"

    def test_sticky_actions_change_the_trajectory(self):
        seeds = np.asarray([3, 5, 9, 12], np.int32)
        actions = torch.as_tensor(np.random.default_rng(0).integers(
            0, 3, size=(40, 4)))

        def frames(env):
            state, _ = env.initial(seeds)
            return conformance.rollout(env, state,
                                       actions)[1].observation.frame

        assert bool((frames(self.make())
                     != frames(self.make(sticky_prob=0.7))).any()), (
            "sticky_prob=0.7 never repeated an action over 160 steps")


# -- minatar asterix dynamics ------------------------------------------------


class TestAsterix:
    def make(self):
        return make_device_env("device_minatar_asterix")

    def with_entity(self, env, gold, player=(5, 5), ent=(5, 4),
                    direction=1):
        state, _ = env.initial(np.asarray([2], np.int32))
        slots = lambda value, first: torch.tensor(
            [[first] + [value] * 7], dtype=torch.int32)
        return state._replace(
            player_r=_batched(player[0]), player_c=_batched(player[1]),
            ent_active=slots(0, 1), ent_r=slots(0, ent[0]),
            ent_c=slots(0, ent[1]), ent_dir=slots(1, direction),
            ent_gold=slots(0, gold))

    def test_gold_scores_and_frees_the_slot(self):
        env = self.make()
        state, out = env.step(self.with_entity(env, gold=1), _batched(0))
        assert float(out.reward[0]) == pytest.approx(1.0)
        assert not bool(out.done[0])
        assert int(state.ent_active[0, 0]) == 0

    def test_enemy_ends_the_episode(self):
        env = self.make()
        state, out = env.step(self.with_entity(env, gold=0), _batched(0))
        assert bool(out.done[0])
        assert float(out.reward[0]) == 0.0
        assert int(state.episode[0]) == 1

    def test_swap_collision_does_not_phase_through(self):
        env = self.make()
        state, out = env.step(self.with_entity(
            env, gold=0, player=(5, 6), ent=(5, 5), direction=1),
            _batched(3))
        assert bool(out.done[0]), "swap with an enemy must terminate"
        state, out = env.step(self.with_entity(
            env, gold=1, player=(5, 6), ent=(5, 5), direction=1),
            _batched(3))
        assert float(out.reward[0]) == pytest.approx(1.0)
        assert int(state.ent_active[0, 0]) == 0

    def test_converging_golds_pay_per_entity(self):
        env = self.make()
        state = self.with_entity(env, gold=1)
        fields = {}
        for name, value in (("ent_active", 1), ("ent_r", 5), ("ent_c", 6),
                            ("ent_dir", -1), ("ent_gold", 1)):
            arr = getattr(state, name).clone()
            arr[0, 1] = value
            fields[name] = arr
        state, out = env.step(state._replace(**fields), _batched(0))
        assert float(out.reward[0]) == pytest.approx(2.0)
        assert int(state.ent_active[0, :2].sum()) == 0

    def test_entities_stream_and_despawn_at_the_edge(self):
        env = self.make()
        state, out = env.step(self.with_entity(
            env, gold=0, player=(1, 0), ent=(5, 9), direction=1),
            _batched(0))
        assert int(state.ent_active[0, 0]) == 0, (
            "entity leaving the grid must free its slot")


# -- host twins (the device_ registry family) --------------------------------


class TestHostTwin:
    @pytest.mark.parametrize("level", ["device_grid_small",
                                       "device_minatar_breakout"])
    def test_impala_stream_matches_device_rollout(self, level):
        """ImpalaStream(StreamAdapter(HostDeviceEnv)) equals the device
        env's own [B=1] stream, bit for bit, and both equal the JAX
        world's stream."""
        from scalable_agent_tpu_torch.envs import make_impala_stream

        seed = 6
        stream = make_impala_stream(level, seed=seed)
        env = make_device_env(level)
        jenv = jax_make(level)
        state, out = env.initial(np.asarray([seed], np.int32))
        jstate, jout = jenv.initial(np.asarray([seed], np.int32))
        jstep = jax.jit(jenv.step)
        try:
            host = stream.initial()
            rng = np.random.default_rng(1)
            for t in range(60):
                np.testing.assert_array_equal(
                    out.observation.frame[0].numpy(),
                    np.asarray(host.observation.frame),
                    err_msg=f"frame mismatch at t={t}")
                np.testing.assert_array_equal(
                    np.asarray(jout.observation.frame[0]),
                    np.asarray(host.observation.frame))
                assert bool(out.done[0]) == bool(host.done), t
                np.testing.assert_allclose(
                    float(out.reward[0]), float(host.reward), rtol=1e-6)
                np.testing.assert_allclose(
                    float(out.info.episode_return[0]),
                    float(host.info.episode_return), rtol=1e-6)
                assert (int(out.info.episode_step[0])
                        == int(host.info.episode_step)), t
                action = int(rng.integers(0, env.num_actions))
                state, out = env.step(state, _batched(action))
                jstate, jout = jstep(jstate, np.asarray([action], np.int32))
                host = stream.step(action)
        finally:
            stream.close()

    def test_probe_env_serves_device_levels(self):
        config = Config(device="cpu", level_name="device_minatar_asterix")
        observation_spec, action_space, num_agents = driver.probe_env(config)
        env = make_device_env("device_minatar_asterix")
        assert tuple(observation_spec.frame.shape) == tuple(
            env.observation_spec.frame.shape)
        assert action_space.n == env.num_actions
        assert num_agents == 1

    def test_registry_defaults_come_from_device_levels(self):
        """The fake family's host defaults read the DEVICE_LEVELS entries:
        change the entry, and the host factory follows."""
        from scalable_agent_tpu_torch.envs.device.protocol import (
            DEVICE_LEVELS,
        )
        from scalable_agent_tpu_torch.envs.registry import create_env

        entry = DEVICE_LEVELS["fake_small"]
        original = dict(entry.defaults)
        try:
            entry.defaults["height"] = 24
            env = create_env("fake_small")
            assert env.observation_spec.frame.shape[0] == 24
        finally:
            entry.defaults.clear()
            entry.defaults.update(original)


# -- the driver on the real worlds -------------------------------------------


def _ingraph_config(tmp_path, level, **overrides):
    base = dict(
        mode="train", device="cpu", logdir=str(tmp_path / "run"),
        level_name=level, train_backend="ingraph", num_actors=4,
        batch_size=4, unroll_length=5, num_action_repeats=1,
        total_environment_frames=160,  # 8 updates of 20 frames
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, seed=7)
    base.update(overrides)
    return Config(**base)


def _prom_values(path):
    out = {}
    for line in open(path):
        if line.startswith("#") or " " not in line:
            continue
        key, _, value = line.rpartition(" ")
        try:
            out[key] = float(value)
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("level,updates_per_dispatch", [
    ("device_grid_small", 2),
    ("device_minatar_breakout", 4),
])
def test_ingraph_driver_trains_device_world(tmp_path, level,
                                            updates_per_dispatch):
    """A real device world trains end to end through
    ``--train_backend=ingraph`` under the megaloop: one ledger record a
    dispatch, all retired; ``devtel/env/*`` episodes > 0; metrics rows."""
    config = _ingraph_config(tmp_path, level,
                             updates_per_dispatch=updates_per_dispatch)

    def counters():
        snap = get_registry().snapshot()
        return {key: snap.get(f"ledger/trajectories_{key}_total", 0.0)
                for key in ("opened", "retired", "discarded",
                            "abandoned")}

    before = counters()
    metrics = driver.train(config)
    assert metrics["env_frames"] == 160
    assert np.isfinite(metrics["total_loss"])
    delta = {key: value - before[key] for key, value in counters().items()}
    assert delta["opened"] == 8 // updates_per_dispatch
    assert delta["opened"] == (delta["retired"] + delta["discarded"]
                               + delta["abandoned"])
    paths = glob.glob(os.path.join(config.logdir, "ledger.p0.json"))
    assert len(paths) == 1, paths
    assert json.load(open(paths[0]))["open_records"] == []
    values = _prom_values(os.path.join(config.logdir, "metrics.prom"))
    assert values["impala_devtel_env_episodes"] > 0
    assert values["impala_devtel_env_steps"] == 160.0
    assert values["impala_devtel_learner_updates"] == 8.0
    rows = [json.loads(line) for line in
            open(os.path.join(config.logdir, "metrics.jsonl"))]
    assert any("total_loss" in r for r in rows)


@pytest.mark.slow
def test_ingraph_driver_megaloop_resume_is_deterministic(tmp_path):
    """The same interrupted 4+4-update schedule (K=2) run twice ends
    bit-identical: checkpoint and resume continue the update-keyed draws.
    (A resumed run is not the uninterrupted one: the envs restart from new
    episodes on restore.)"""
    def interrupted(logdir):
        for total_frames in (80.0, 160.0):
            metrics = driver.train(_ingraph_config(
                tmp_path, "device_grid_small", logdir=str(logdir),
                updates_per_dispatch=2,
                total_environment_frames=total_frames,
                checkpoint_interval_s=0.0))
        assert metrics["env_frames"] == 160
        return metrics

    m_a = interrupted(tmp_path / "a")
    m_b = interrupted(tmp_path / "b")
    assert m_a["total_loss"] == m_b["total_loss"]
    assert m_a["grad_norm"] == m_b["grad_norm"]


def test_driver_rejects_megaloop_on_host_backend():
    from scalable_agent_tpu_torch.models import ImpalaAgent

    config = Config(device="cpu", train_backend="host",
                    updates_per_dispatch=2)
    with pytest.raises(ValueError, match="updates_per_dispatch"):
        driver.build_learner(config, ImpalaAgent(num_actions=4))


def test_driver_rejects_megaloop_with_replay(tmp_path):
    config = _ingraph_config(tmp_path, "device_grid_small",
                             updates_per_dispatch=2, replay_ratio=1)
    with pytest.raises(ValueError, match="updates_per_dispatch"):
        driver.train(config)


def test_device_grid_learning_improves():
    """A short real training run on device_grid_small (CNN+LSTM from
    pixels, sparse key/door/goal rewards) lifts the mean episode return
    clear of the random policy's: the JAX test's run and thresholds
    (early 0.45 -> late 0.66 measured there; the thresholds sit at about
    half that margin), the port's trainer and draws."""
    from scalable_agent_tpu_torch.models import ImpalaAgent
    from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
    from scalable_agent_tpu_torch.runtime.ingraph import InGraphTrainer

    unroll, batch, updates, k = 16, 32, 160, 8
    env = make_device_env("device_grid_small")
    torch.manual_seed(3)
    agent = ImpalaAgent(num_actions=env.num_actions, frame_shape=(15, 15, 3),
                        generator=torch.Generator().manual_seed(3))
    hp = LearnerHyperparams(
        total_environment_frames=float(4 * updates * unroll * batch),
        learning_rate=0.003, entropy_cost=0.006, discounting=0.95)
    learner = Learner(agent, hp, frames_per_update=unroll * batch)
    trainer = InGraphTrainer(agent, learner, env, unroll, batch, seed=3,
                             updates_per_dispatch=k)
    carry = trainer.init()
    returns = []
    for u in range(0, updates, k):
        carry, m = trainer.run(carry, k, counter_start=u)
        if int(m["episodes_completed"]) > 0:
            returns.append(float(m["episode_return"]))
    third = len(returns) // 3
    early = float(np.mean(returns[:third]))
    late = float(np.mean(returns[-third:]))
    assert late >= early + 0.10, (
        f"return did not improve on device_grid_small: early "
        f"{early:.3f} late {late:.3f}")
    assert late >= 0.55, (
        f"final return {late:.3f} stayed near the random policy's")
