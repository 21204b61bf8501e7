"""The port's small utilities (``scalable_agent_tpu_torch/utils/``): torch
twins of ``tests/test_utils_algo.py`` (running statistics, discounted
sums, GAE, frame counting) and of ``tests/test_utils_misc.py``'s
``TestLinearDecay`` and ``test_encode_gif_produces_gif_bytes`` (skipped
without ``ffmpeg``, as the JAX test is), and each function held against
the live JAX one on the same seeded inputs: bitwise (the arithmetic is
the same numpy in the same order)."""

import logging
import shutil

import numpy as np
import pytest

from scalable_agent_tpu.utils import algo as jax_algo
from scalable_agent_tpu.utils import decay as jax_decay
from scalable_agent_tpu.utils import misc as jax_misc
from scalable_agent_tpu_torch.utils import gifs
from scalable_agent_tpu_torch.utils import AttrDict, LinearDecay, log
from scalable_agent_tpu_torch.utils.algo import (
    RunningMeanStd,
    calculate_gae,
    discounted_sums,
    num_env_steps,
)
from scalable_agent_tpu_torch.utils.misc import memory_consumption_mb


class TestRunningMeanStd:
    def test_matches_batch_statistics(self):
        rng = np.random.default_rng(0)
        data = rng.standard_normal((500, 3)) * 2.5 + 1.0
        rms = RunningMeanStd(shape=(3,))
        for chunk in np.split(data, 10):
            rms.update(chunk)
        np.testing.assert_allclose(rms.mean, data.mean(axis=0), atol=1e-2)
        np.testing.assert_allclose(rms.var, data.var(axis=0), rtol=1e-2)

    def test_normalize(self):
        rms = RunningMeanStd()
        rms.update(np.asarray([10.0, 12.0, 8.0, 10.0]))
        normalized = rms.normalize(np.asarray([10.0]))
        assert abs(float(normalized[0])) < 0.5

    def test_matches_jax_bitwise(self):
        rng = np.random.default_rng(1)
        ours, theirs = RunningMeanStd((4,)), jax_algo.RunningMeanStd((4,))
        for _ in range(5):
            chunk = rng.standard_normal((37, 4)) * 3.0 - 1.0
            ours.update(chunk)
            theirs.update(chunk)
        np.testing.assert_array_equal(ours.mean, theirs.mean)
        np.testing.assert_array_equal(ours.var, theirs.var)
        assert ours.count == theirs.count
        x = rng.standard_normal((6, 4))
        np.testing.assert_array_equal(ours.normalize(x),
                                      theirs.normalize(x))


class TestDiscounting:
    def test_discounted_sums_literal(self):
        out = discounted_sums([1.0, 1.0, 1.0], gamma=0.5)
        np.testing.assert_allclose(out, [1.75, 1.5, 1.0])

    def test_gae_against_literal_expansion(self):
        rewards = [1.0, 0.0, 2.0]
        dones = [False, False, False]
        values = [0.5, 0.4, 0.3, 0.2]
        gamma, lam = 0.9, 0.8
        adv, rets = calculate_gae(rewards, dones, values, gamma, lam)
        deltas = [rewards[t] + gamma * values[t + 1] - values[t]
                  for t in range(3)]
        expected2 = deltas[2]
        expected1 = deltas[1] + gamma * lam * expected2
        expected0 = deltas[0] + gamma * lam * expected1
        np.testing.assert_allclose(adv, [expected0, expected1, expected2])
        np.testing.assert_allclose(rets, adv + np.asarray(values[:3]))

    def test_gae_resets_at_done(self):
        adv_nodone, _ = calculate_gae(
            [1.0, 1.0], [False, False], [0.0, 0.0, 5.0], 0.9, 0.95)
        adv_done, _ = calculate_gae(
            [1.0, 1.0], [True, False], [0.0, 0.0, 5.0], 0.9, 0.95)
        assert adv_done[0] == pytest.approx(1.0)
        assert adv_nodone[0] > adv_done[0]

    def test_gae_shape_validation(self):
        with pytest.raises(ValueError, match="len\\(rewards\\)\\+1"):
            calculate_gae([1.0], [False], [0.0], 0.9, 0.95)
        with pytest.raises(ValueError, match="len\\(rewards\\)\\+1"):
            jax_algo.calculate_gae([1.0], [False], [0.0], 0.9, 0.95)

    def test_num_env_steps(self):
        infos = [{"num_frames": 4}, {}, {"num_frames": 2}]
        assert num_env_steps(infos) == 7 == jax_algo.num_env_steps(infos)

    def test_discounts_and_gae_match_jax_bitwise(self):
        rng = np.random.default_rng(2)
        rewards = rng.standard_normal(50)
        dones = rng.random(50) < 0.1
        values = rng.standard_normal(51)
        np.testing.assert_array_equal(
            discounted_sums(rewards, 0.97),
            jax_algo.discounted_sums(rewards, 0.97))
        for ours, theirs in zip(
                calculate_gae(rewards, dones, values, 0.99, 0.95),
                jax_algo.calculate_gae(rewards, dones, values, 0.99, 0.95)):
            np.testing.assert_array_equal(ours, theirs)


class TestLinearDecay:
    def test_interpolation_and_clamping(self):
        decay = LinearDecay([(0, 1.0), (100, 0.0)])
        assert decay.at(-5) == 1.0
        assert decay.at(0) == 1.0
        assert decay.at(50) == pytest.approx(0.5)
        assert decay.at(100) == 0.0
        assert decay.at(1000) == 0.0

    def test_multiple_segments(self):
        decay = LinearDecay([(0, 0.0), (10, 1.0), (30, 0.5)])
        assert decay.at(5) == pytest.approx(0.5)
        assert decay.at(20) == pytest.approx(0.75)

    def test_staircase_quantizes(self):
        decay = LinearDecay([(0, 0.0), (100, 1.0)], staircase=4)
        assert decay.at(10) == pytest.approx(0.0)
        assert decay.at(30) == pytest.approx(0.25)
        assert decay.at(99) == pytest.approx(0.75)

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            LinearDecay([])

    @pytest.mark.parametrize("staircase", [0, 3])
    def test_matches_jax(self, staircase):
        milestones = [(30, 0.2), (0, 1.0), (70, 0.9), (100, 0.0)]
        ours = LinearDecay(milestones, staircase=staircase)
        theirs = jax_decay.LinearDecay(milestones, staircase=staircase)
        for step in range(-5, 110, 3):
            assert ours.at(step) == theirs.at(step), step


class TestMisc:
    def test_attrdict_matches_jax(self):
        for cls in (AttrDict, jax_misc.AttrDict):
            d = cls(a=1)
            d.b = 2
            assert d.a == 1 and d["b"] == 2
            with pytest.raises(AttributeError):
                d.missing

    def test_log_is_the_package_logger_and_memory_is_positive(self):
        assert isinstance(log, logging.Logger)
        assert log.name == "scalable_agent_tpu_torch"
        assert memory_consumption_mb() > 0.0

    def test_encode_gif_without_ffmpeg_raises_as_jax(self, monkeypatch):
        from scalable_agent_tpu.utils import gifs as jax_gifs

        monkeypatch.setattr(shutil, "which", lambda name: None)
        frames = [np.zeros((4, 4, 3), np.uint8)]
        for encode in (gifs.encode_gif, jax_gifs.encode_gif):
            with pytest.raises(RuntimeError, match="ffmpeg"):
                encode(frames)
            with pytest.raises(ValueError, match="no frames"):
                encode([])
            with pytest.raises(ValueError, match="RGB"):
                encode([np.zeros((4, 4, 1), np.uint8)])


@pytest.mark.skipif(shutil.which("ffmpeg") is None,
                    reason="ffmpeg not installed")
def test_encode_gif_produces_gif_bytes():
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(4)]
    data = gifs.encode_gif(frames, fps=5)
    assert data[:6] in (b"GIF87a", b"GIF89a")
