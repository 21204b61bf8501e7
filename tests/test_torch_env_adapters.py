"""The port's simulator adapters (``envs/dmlab/``, ``envs/atari/``,
``envs/gym_adapter.py``, the frame-stack wrappers) against mock simulators:
torch twins of ``tests/test_env_adapters.py``'s ``TestDmLabAdapter``,
``TestAtariAdapter`` and ``TestGymnasiumBridge``, and the port's env
outputs against the JAX package's, bit for bit, over the same seeded
steps.  Then the Atari and gym levels through the port's driver on the
CPU, and the shallow agent on Atari's [84, 84, 4] frames against the JAX
agent.

DMLab runs under an in-process ``deepmind_lab`` stand-in (the JAX tests'
``FakeLab``), Atari under ``gymnasium.make`` patched to a NoFrameskip
stand-in (``FakeALE``), gym levels under the real gymnasium.  The driver
runs, whose env workers are other processes, take ``chip_smoke.py``'s
stand-in ``gymnasium`` module.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU work here is small: one intra-op thread, so that the
    module does not fight the test runner's other workers for the cores
    (restored after the module)."""
    import torch

    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


class FakeLab:
    """Duck-typed deepmind_lab.Lab recording calls (as the JAX tests')."""

    instances = []

    def __init__(self, level, observations, config, renderer, level_cache):
        self.level = level
        self.observation_names = observations
        self.config = config
        self.renderer = renderer
        self.level_cache = level_cache
        self.reset_seeds = []
        self.step_calls = []
        self._steps = 0
        self._episode_len = 3
        self.width = int(config["width"])
        self.height = int(config["height"])
        FakeLab.instances.append(self)

    def reset(self, seed=None):
        self.reset_seeds.append(seed)
        self._steps = 0

    def observations(self):
        obs = {"RGB_INTERLEAVED": np.full(
            (self.height, self.width, 3), self._steps, np.uint8)}
        if "INSTR" in self.observation_names:
            obs["INSTR"] = b"go to the red door"
        return obs

    def step(self, action, num_steps=1):
        assert action.dtype == np.intc
        self.step_calls.append((tuple(int(a) for a in action), num_steps))
        self._steps += 1
        return 0.5 * num_steps * (1 + int(action[3] == 1))

    def is_running(self):
        return self._steps < self._episode_len

    def close(self):
        pass


@pytest.fixture
def fake_deepmind_lab(monkeypatch):
    module = types.ModuleType("deepmind_lab")
    module.Lab = FakeLab
    module.set_runfiles_path = lambda path: None
    monkeypatch.setitem(sys.modules, "deepmind_lab", module)
    FakeLab.instances.clear()
    yield module


class FakeALE:
    """Duck-typed gymnasium NoFrameskip Atari env (as the JAX tests')."""

    def __init__(self):
        import gymnasium

        self.observation_space = gymnasium.spaces.Box(
            0, 255, (210, 160, 3), np.uint8)
        self.action_space = gymnasium.spaces.Discrete(4)
        self.steps = 0

    def _obs(self):
        frame = np.full((210, 160, 3), self.steps % 256, np.uint8)
        frame[:, :, 1] = (self.steps * 7) % 256
        return frame

    def reset(self, seed=None, options=None):
        self.steps = 0
        return self._obs(), {}

    def step(self, action):
        self.steps += 1
        return self._obs(), 1.0 + int(action), False, False, {}

    def close(self):
        pass


class FakeGrayALE(FakeALE):
    """The same game observed as one channel, [210, 160, 1] uint8 (a
    gymnasium env with a grayscale observation kept 3-D)."""

    def __init__(self):
        import gymnasium

        super().__init__()
        self.observation_space = gymnasium.spaces.Box(
            0, 255, (210, 160, 1), np.uint8)

    def _obs(self):
        frame = np.zeros((210, 160, 1), np.uint8)
        frame[::3] = (self.steps * 11) % 256
        frame[:, ::5] = 255 - self.steps % 256
        return frame


@pytest.fixture
def fake_gym_make(monkeypatch):
    import gymnasium

    made = []

    def fake_make(env_id, **kwargs):
        made.append((env_id, kwargs))
        return FakeGrayALE() if env_id == "BreakoutGray-v0" else FakeALE()

    monkeypatch.setattr(gymnasium, "make", fake_make)
    return made


def _stream_outputs(make_impala_stream, name, seed, steps, actions,
                    **kwargs):
    """The initial output and ``steps`` more of a seeded stream, each a
    flat tuple of numpy leaves (reward, done, episode info, frame,
    instruction)."""
    stream = make_impala_stream(name, seed=seed, **kwargs)
    try:
        outs = [stream.initial()]
        outs += [stream.step(actions[t]) for t in range(steps)]
    finally:
        stream.close()
    return [(np.asarray(o.reward), np.asarray(o.done),
             np.asarray(o.info.episode_return),
             np.asarray(o.info.episode_step),
             np.asarray(o.observation.frame),
             None if o.observation.instruction is None
             else np.asarray(o.observation.instruction)) for o in outs]


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for t, (a, b) in enumerate(zip(ours, theirs)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x is None or y is None:
                assert x is None and y is None, (t, i)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (t, i)
            np.testing.assert_array_equal(x, y, err_msg=f"step {t} leaf {i}")


def _both_streams(name, steps, num_actions, **kwargs):
    from scalable_agent_tpu.envs import make_impala_stream as jax_stream
    from scalable_agent_tpu_torch.envs import make_impala_stream

    actions = np.random.default_rng(7).integers(0, num_actions, steps)
    ours = _stream_outputs(make_impala_stream, name, 5, steps, actions,
                           **kwargs)
    theirs = _stream_outputs(jax_stream, name, 5, steps, actions, **kwargs)
    return ours, theirs


# -- DMLab ---------------------------------------------------------------------


class TestDmLabAdapter:
    def test_level_resolution(self, fake_deepmind_lab):
        from scalable_agent_tpu.envs.dmlab import resolve_level as jax_resolve
        from scalable_agent_tpu_torch.envs.dmlab import resolve_level

        level, cfg = resolve_level("dmlab_very_sparse")
        assert level == "contributed/dmlab30/explore_goal_locations_large"
        assert cfg == {"minGoalDistance": "10"}
        level, _ = resolve_level("dmlab_explore_goal_locations_small")
        assert level == "contributed/dmlab30/explore_goal_locations_small"
        level, _ = resolve_level("dmlab_contributed/dmlab30/rooms_watermaze")
        assert level == "contributed/dmlab30/rooms_watermaze"
        with pytest.raises(ValueError, match="unknown DMLab env"):
            resolve_level("dmlab_not_a_level")
        for name in ("dmlab_sparse", "dmlab_rooms_watermaze",
                     "dmlab_rooms_collect_good_objects_test",
                     "dmlab_contributed/dmlab30/natlab_fixed_large_map"):
            assert resolve_level(name) == jax_resolve(name)

    def test_env_contract(self, fake_deepmind_lab):
        from scalable_agent_tpu_torch.envs import create_env
        from scalable_agent_tpu_torch.utils.text import hash_instruction

        env = create_env("dmlab_watermaze", width=32, height=24,
                         num_action_repeats=4, seed=7)
        lab = FakeLab.instances[-1]
        assert lab.config["width"] == "32"
        assert env.native_action_repeats == 4
        obs = env.reset()
        assert obs.frame.shape == (24, 32, 3)
        np.testing.assert_array_equal(
            obs.instruction, hash_instruction("go to the red door"))
        env2 = create_env("dmlab_watermaze", width=32, height=24,
                          num_action_repeats=4, seed=7)
        env2.reset()
        assert FakeLab.instances[-1].reset_seeds == lab.reset_seeds
        obs, reward, done, info = env.step(1)
        assert lab.step_calls[-1] == ((0, 0, 0, -1, 0, 0, 0), 4)  # Backward
        assert reward == 2.0 and not done and info["num_frames"] == 4
        env.step(0)
        obs, reward, done, _ = env.step(0)
        assert done
        assert obs.frame.sum() == 0
        env.close(), env2.close()

    def test_dataset_path_and_renderer_reach_the_lab(self,
                                                     fake_deepmind_lab):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("dmlab_rooms_watermaze", width=16, height=16,
                         dataset_path="/data/brady", renderer="hardware")
        lab = FakeLab.instances[-1]
        assert lab.config["datasetPath"] == "/data/brady"
        assert lab.renderer == "hardware"
        env.close()

    def test_stream_does_not_double_wrap(self, fake_deepmind_lab):
        from scalable_agent_tpu_torch.envs import make_impala_stream

        stream = make_impala_stream("dmlab_watermaze", seed=3,
                                    num_action_repeats=4, width=16,
                                    height=16)
        stream.initial()
        lab = FakeLab.instances[-1]
        stream.step(0)
        assert len(lab.step_calls) == 1
        assert lab.step_calls[0][1] == 4
        stream.close()

    def test_level_cache_roundtrip(self, tmp_path):
        from scalable_agent_tpu_torch.envs.dmlab import LevelCache

        cache = LevelCache(str(tmp_path / "cache"))
        src = tmp_path / "compiled.pk3"
        src.write_bytes(b"level-bytes")
        assert not cache.fetch("key1", str(tmp_path / "out.pk3"))
        cache.write("key1", str(src))
        out = tmp_path / "out.pk3"
        assert cache.fetch("key1", str(out))
        assert out.read_bytes() == b"level-bytes"

    @pytest.mark.parametrize("with_instruction", [True, False])
    def test_outputs_match_jax(self, fake_deepmind_lab, with_instruction):
        """20 seeded steps over several episodes: rewards, dones, episode
        info, frames and the hashed instructions equal the JAX stream's."""
        ours, theirs = _both_streams(
            "dmlab_rooms_watermaze", 20, 9, num_action_repeats=4,
            width=16, height=12, with_instruction=with_instruction)
        assert (ours[1][5] is not None) == with_instruction
        _assert_same(ours, theirs)


# -- Atari ---------------------------------------------------------------------


class TestAtariAdapter:
    def test_pipeline(self, fake_gym_make):
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("atari_breakout", num_action_repeats=4)
        assert fake_gym_make[0][0] == "BreakoutNoFrameskip-v4"
        assert env.observation_spec.frame.shape == (84, 84, 4)
        assert env.native_action_repeats == 4
        assert env.action_space.n == 4
        obs = env.reset()
        assert obs.frame.shape == (84, 84, 4)
        obs, reward, done, _ = env.step(0)
        assert reward == 4.0  # summed over the 4 skipped frames
        env.close()

    def test_unknown_game(self, fake_gym_make):
        from scalable_agent_tpu_torch.envs import create_env

        with pytest.raises(ValueError, match="unknown Atari env"):
            create_env("atari_notagame")

    def test_montezuma_timeout_wrapped(self, fake_gym_make):
        from scalable_agent_tpu_torch.envs import create_env
        from scalable_agent_tpu_torch.envs.wrappers import TimeLimitWrapper

        env = create_env("atari_montezuma", num_action_repeats=4)
        layer, seen_limit = env, None
        while hasattr(layer, "env"):
            if isinstance(layer, TimeLimitWrapper):
                seen_limit = layer._limit
            layer = layer.env
        assert seen_limit == 18000
        env.close()

    def test_specs_match_jax(self):
        from scalable_agent_tpu.envs import atari as jax_atari
        from scalable_agent_tpu_torch.envs import atari

        assert [dataclasses.astuple(s) for s in atari.ATARI_ENVS] == [
            dataclasses.astuple(s) for s in jax_atari.ATARI_ENVS]
        assert [s.ale_v5_id for s in atari.ATARI_ENVS] == [
            s.ale_v5_id for s in jax_atari.ATARI_ENVS]

    def test_outputs_match_jax(self, fake_gym_make):
        """The grayscale 84x84 skip-4 stack-4 pipeline over 12 seeded
        steps equals the JAX one bit for bit."""
        ours, theirs = _both_streams("atari_breakout", 12, 4,
                                     num_action_repeats=4, height=84,
                                     width=84)
        assert ours[0][4].shape == (84, 84, 4)
        _assert_same(ours, theirs)


class TestFrameStack:
    @pytest.mark.parametrize("skip,stack", [(4, 4), (2, 3)])
    def test_skip_and_stack_match_jax(self, skip, stack):
        """SkipAndStackWrapper (and the FrameStackWrapper inside it) over a
        counter env: the stacked frames and summed rewards equal the JAX
        wrappers'."""
        from scalable_agent_tpu.envs.fake import FakeEnv as JaxFake
        from scalable_agent_tpu.envs.wrappers import (
            SkipAndStackWrapper as JaxSkipAndStack,
        )
        from scalable_agent_tpu_torch.envs.fake import FakeEnv
        from scalable_agent_tpu_torch.envs.wrappers import (
            SkipAndStackWrapper,
        )

        outs = []
        for fake, wrapper in ((FakeEnv, SkipAndStackWrapper),
                              (JaxFake, JaxSkipAndStack)):
            env = wrapper(fake(height=8, width=8, episode_length=7,
                               num_actions=3), skip, stack)
            env.seed(3)
            assert env.observation_spec.frame.shape == (8, 8, 3 * stack)
            seq = [env.reset().frame]
            for t in range(9):
                obs, reward, done, _ = env.step(t % 3)
                seq += [obs.frame, np.float32(reward), done]
                if done:
                    seq.append(env.reset().frame)
            outs.append(seq)
        for a, b in zip(*outs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- gymnasium -------------------------------------------------------------------


class TestGymnasiumBridge:
    def test_cartpole_rendered_frames(self):
        from scalable_agent_tpu_torch.envs import create_env

        try:
            env = create_env("gym_CartPole-v1", height=72, width=96)
        except Exception as exc:  # headless render not available
            pytest.skip(f"gymnasium render unavailable: {exc}")
        assert env.observation_spec.frame.shape == (72, 96, 3)
        env.seed(5)
        obs = env.reset()
        assert obs.frame.shape == (72, 96, 3)
        assert obs.frame.dtype == np.uint8
        obs, reward, done, _ = env.step(0)
        assert reward == 1.0
        env.close()

    def test_full_stream_with_repeats(self):
        from scalable_agent_tpu_torch.envs import make_impala_stream

        try:
            stream = make_impala_stream(
                "gym_CartPole-v1", seed=2, num_action_repeats=2,
                height=32, width=32)
        except Exception as exc:
            pytest.skip(f"gymnasium render unavailable: {exc}")
        out = stream.initial()
        assert out.done and out.observation.frame.shape == (32, 32, 3)
        out = stream.step(1)
        assert out.info.episode_step == 1
        stream.close()

    def test_outputs_match_jax(self):
        """40 seeded steps of rendered CartPole frames with 2 repeats, past
        episode ends, equal the JAX bridge's bit for bit."""
        try:
            ours, theirs = _both_streams("gym_CartPole-v1", 40, 2,
                                         num_action_repeats=2, height=24,
                                         width=32)
        except Exception as exc:
            pytest.skip(f"gymnasium render unavailable: {exc}")
        assert any(out[1] for out in ours[1:])  # an episode ended
        _assert_same(ours, theirs)


    def test_one_channel_outputs_match_jax(self, fake_gym_make):
        """A gym env with [H, W, 1] uint8 observations, resized to the
        driver's 72x96: 12 seeded steps with 4 repeats keep the one
        channel and equal the JAX bridge's bit for bit."""
        from scalable_agent_tpu_torch.envs import create_env

        env = create_env("gym_BreakoutGray-v0", height=72, width=96)
        assert env.observation_spec.frame.shape == (72, 96, 1)
        env.close()
        ours, theirs = _both_streams("gym_BreakoutGray-v0", 12, 4,
                                     num_action_repeats=4, height=72,
                                     width=96)
        assert ours[0][4].shape == (72, 96, 1)
        assert len({out[4].tobytes() for out in ours}) > 2
        _assert_same(ours, theirs)


# -- the driver on the CPU, and the agent at Atari's frames -----------------------


@pytest.fixture
def gymnasium_standin(tmp_path, monkeypatch):
    """``chip_smoke.py``'s stand-in ``gymnasium`` first on ``sys.path`` (the
    env worker processes inherit it) and in ``sys.modules``."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    for name in [m for m in sys.modules
                 if m == "gymnasium" or m.startswith("gymnasium.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "path", list(sys.path))
    where = chip_smoke.gymnasium_standin(str(tmp_path))
    yield where
    sys.modules.pop("gymnasium", None)


def _config(tmp_path, **fields):
    from scalable_agent_tpu_torch.config import Config

    base = dict(mode="train", logdir=str(tmp_path / "logs"), num_actors=2,
                batch_size=2, unroll_length=3, compute_dtype="float32",
                checkpoint_interval_s=1e9, num_env_workers_per_group=1,
                test_num_workers=1, device="cpu")
    base.update(fields)
    return Config(**base)


@pytest.mark.parametrize("level,frame,fields", [
    ("atari_breakout", (84, 84, 4), {}),
    ("gym_CartPole-v1", (16, 16, 3), dict(height=16, width=16)),
    ("gym_BreakoutGray-v0", (16, 16, 1), dict(height=16, width=16)),
    ("atari_breakout", (84, 84, 4), dict(torso_type="resnet")),
])
def test_driver_trains_and_tests(tmp_path, gymnasium_standin, level, frame,
                                 fields):
    """``driver.train`` for 2 updates and ``driver.test`` for 2 episodes
    on an Atari level (the family's 84x84 grayscale stack of 4 and 4
    repeats; through the shallow torso and the ResNet torso), a gym level
    and a one-channel gym level, under the stand-in gymnasium."""
    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.driver import probe_env
    from scalable_agent_tpu_torch.driver import test as run_test
    from scalable_agent_tpu_torch.driver import train

    config = _config(tmp_path, level_name=level, **fields)
    config = dataclasses.replace(
        config, total_environment_frames=2 * config.frames_per_update())
    metrics = train(config)
    assert np.isfinite(metrics["total_loss"])
    assert metrics["env_frames"] == config.total_environment_frames
    saved = Config.load(str(tmp_path / "logs" / "config.json"))
    spec = probe_env(saved)[0]
    assert tuple(spec.frame.shape) == frame
    assert saved.torso_type == fields.get("torso_type", "shallow")
    returns = run_test(dataclasses.replace(config, mode="test",
                                           test_num_episodes=2,
                                           test_batch_size=2))
    assert list(returns) == [level]
    assert len(returns[level]) == 2
    assert all(np.isfinite(r) for r in returns[level])


A, H = 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)


def _shallow_agent_matches_jax(frame_shape, compute_dtype):
    """The shallow agent on ``frame_shape`` frames (the stem's grad-W at
    the frames' channel count, the Pallas kernel in interpret mode) against
    the JAX agent with the same weights (``convert.py``): logits,
    baseline, final carry and every parameter gradient; float32 at 1e-5,
    bf16 in the 2e-2 band."""
    import jax
    import jax.numpy as jnp

    from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
    from scalable_agent_tpu.types import AgentState as JaxState
    from scalable_agent_tpu.types import Observation as JaxObservation
    from scalable_agent_tpu.types import StepOutput as JaxStepOutput
    from scalable_agent_tpu.types import StepOutputInfo as JaxInfo
    from scalable_agent_tpu_torch import convert
    from scalable_agent_tpu_torch.models import ImpalaAgent
    from scalable_agent_tpu_torch.types import (
        AgentState,
        Observation,
        StepOutput,
        StepOutputInfo,
    )

    bf16 = compute_dtype == "bfloat16"
    T, B = 1, 2
    rng = np.random.default_rng(84)
    d = dict(actions=rng.integers(0, A, (T, B)),
             reward=rng.standard_normal((T, B)).astype(np.float32),
             done=rng.random((T, B)) < 0.3,
             frame=rng.integers(0, 256, (T, B) + frame_shape,
                                dtype=np.uint8),
             c=(rng.standard_normal((B, H)) * 0.5).astype(np.float32),
             h=np.tanh(rng.standard_normal((B, H))).astype(np.float32))
    zeros = np.zeros((T, B), np.float32)
    jargs = (jnp.asarray(d["actions"], jnp.int32),
             JaxStepOutput(reward=jnp.asarray(d["reward"]),
                           info=JaxInfo(zeros, zeros.astype(np.int32)),
                           done=jnp.asarray(d["done"]),
                           observation=JaxObservation(
                               frame=jnp.asarray(d["frame"]))),
             JaxState(c=jnp.asarray(d["c"]), h=jnp.asarray(d["h"])))
    jax_agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                         conv_backend="pallas",
                         compute_dtype=jnp.dtype(compute_dtype),
                         core_matmul_dtype=compute_dtype)
    # The port's seeded weights, converted (``convert.py`` is exact both
    # ways: tests/test_torch_agent.py), spare the JAX init's trace.
    agent = ImpalaAgent(A, frame_shape, core_size=H,
                        generator=torch.Generator().manual_seed(3),
                        compute_dtype=getattr(torch, compute_dtype),
                        core_matmul_dtype=compute_dtype)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.state_dict_to_flax(agent.state_dict()))

    def loss_j(p):
        (logits, baseline), state = jax_agent.apply(p, *jargs)
        loss = (jnp.sum(logits ** 2) + jnp.sum(baseline)
                + jnp.sum(state.c) + jnp.sum(state.h ** 2))
        return loss, (logits, baseline, state.c, state.h)

    (_, want_outs), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(params)
    zeros_t = torch.zeros((T, B))
    (logits, baseline), state = agent(
        torch.tensor(d["actions"]),
        StepOutput(reward=torch.tensor(d["reward"]),
                   info=StepOutputInfo(zeros_t, zeros_t),
                   done=torch.tensor(d["done"]),
                   observation=Observation(frame=torch.tensor(d["frame"]))),
        AgentState(c=torch.tensor(d["c"]), h=torch.tensor(d["h"])))
    loss = (logits.square().sum() + baseline.sum() + state.c.sum()
            + state.h.square().sum())
    names = [name for name, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, list(agent.parameters()))
    tol = BAND if bf16 else TOL
    for got, want in zip((logits, baseline, state.c, state.h), want_outs):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    want_grads = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(want_grads) == sorted(names)
    assert agent.state_dict()["convnet.conv_0.weight"].shape == (
        32, frame_shape[-1], 8, 8)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.float().numpy(),
                                   want_grads[name].float().numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_shallow_agent_on_atari_frames_matches_jax(compute_dtype):
    """On Atari's [84, 84, 4] frames: the stem's grad-W at C = 4."""
    _shallow_agent_matches_jax((84, 84, 4), compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_shallow_agent_on_one_channel_frames_matches_jax(compute_dtype):
    """On a one-channel gym level's [72, 96, 1] frames: the stem's
    grad-W at C = 1."""
    _shallow_agent_matches_jax((72, 96, 1), compute_dtype)
