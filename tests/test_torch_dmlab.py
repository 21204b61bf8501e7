"""The port's DMLab-30 surface against the JAX package: the level tables
and the human-normalized score (``envs/dmlab30.py``), the driver's
``env_kwargs``, ``training_level_names`` and slot-to-level assignment
(``make_env_groups``), the training scores, multi-task training (the twin
of ``tests/test_driver.py::TestMultiTaskTraining``), the suite eval (twins
of ``tests/test_suite_eval.py``) and the level-cache CLI, under the fake
DeepMind Lab of ``tests/fakes/deepmind_lab.py``.

The fake's returns do not depend on the actions (a per-level constant a
step), so two policies score the same: the live JAX suite eval, whose
``eval_scores.json`` the port's must equal, is ``-m slow`` as the JAX
original is; the tier-1 suite test holds the port's file against the JAX
``compute_human_normalized_score`` on the port's returns, with the eval
fleets stepped in the test's process.
"""

import dataclasses
import functools
import json
import logging
import os
import sys

import numpy as np
import pytest

FAKES_DIR = os.path.join(os.path.dirname(__file__), "fakes")


@pytest.fixture(scope="module", autouse=True)
def fake_lab():
    """The fake ``deepmind_lab`` first on sys.path (spawned env workers
    inherit it), as tests/test_suite_eval.py sets it up."""
    sys.path.insert(0, FAKES_DIR)
    sys.modules.pop("deepmind_lab", None)
    yield
    sys.path.remove(FAKES_DIR)
    sys.modules.pop("deepmind_lab", None)


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


def _configs(tmp_path, **fields):
    """The port's and the JAX package's Config with the same fields."""
    from scalable_agent_tpu.config import Config as JaxConfig
    from scalable_agent_tpu_torch.config import Config

    base = dict(mode="train", logdir=str(tmp_path / "run"),
                compute_dtype="float32", checkpoint_interval_s=1e9)
    base.update(fields)
    return Config(device="cpu", **base), JaxConfig(**base)


# -- tables and scores -------------------------------------------------------


def test_tables_match_jax():
    from scalable_agent_tpu.envs import dmlab as jax_dmlab
    from scalable_agent_tpu.envs import dmlab30 as jax_dmlab30
    from scalable_agent_tpu_torch.envs import dmlab, dmlab30

    assert dmlab30.LEVELS == jax_dmlab30.LEVELS
    assert dmlab30.TRAIN_LEVELS == jax_dmlab30.TRAIN_LEVELS
    assert dmlab30.TEST_LEVELS == jax_dmlab30.TEST_LEVELS
    assert dmlab30.ALL_LEVELS == jax_dmlab30.ALL_LEVELS
    assert len(dmlab30.TRAIN_LEVELS) == 30
    assert dmlab.DEFAULT_ACTION_SET == jax_dmlab.DEFAULT_ACTION_SET
    assert dmlab.CLASSIC_ACTION_SET == jax_dmlab.CLASSIC_ACTION_SET
    assert [dataclasses.astuple(s) for s in dmlab.DMLAB_ENVS] == [
        dataclasses.astuple(s) for s in jax_dmlab.DMLAB_ENVS]


@pytest.mark.parametrize("variant", ["train", "test"])
@pytest.mark.parametrize("cap", [None, 100.0])
def test_human_normalized_score_matches_jax(variant, cap):
    from scalable_agent_tpu.envs import dmlab30 as jax_dmlab30
    from scalable_agent_tpu_torch.envs import dmlab30

    rng = np.random.default_rng(30)
    names = (dmlab30.TRAIN_LEVELS if variant == "train"
             else dmlab30.TEST_LEVELS)
    returns = {name: list(rng.uniform(-5, 400, rng.integers(1, 4)))
               for name in names}
    returns["not_a_suite_level"] = [1e6]
    assert dmlab30.compute_human_normalized_score(returns, cap) == (
        jax_dmlab30.compute_human_normalized_score(returns, cap))
    del returns[names[0]]
    with pytest.raises(ValueError, match="missing levels"):
        dmlab30.compute_human_normalized_score(returns, cap)


def test_training_scores_match_jax():
    """``_level_metrics`` over three intervals: per-level means, no score
    until every train level has reported, then the two scores the JAX
    ``compute_human_normalized_score`` gives on the same returns, and the
    lists start over."""
    from scalable_agent_tpu.envs import dmlab30 as jax_dmlab30
    from scalable_agent_tpu_torch.driver import _level_metrics
    from scalable_agent_tpu_torch.envs import dmlab30

    rng = np.random.default_rng(1)
    suite = {name: [] for name in dmlab30.TRAIN_LEVELS}
    half = dmlab30.TRAIN_LEVELS[:15]
    first = {f"dmlab_{n}": [(float(rng.uniform(0, 50)), 6)] for n in half}
    row = {}
    _level_metrics(row, first, 4, suite)
    assert "dmlab30/training_no_cap" not in row
    assert row[f"dmlab_{half[0]}/episode_frames"] == 24.0
    second = {f"dmlab_{n}": [(float(rng.uniform(0, 300)), 6),
                             (float(rng.uniform(0, 300)), 3)]
              for n in dmlab30.TRAIN_LEVELS}
    row = {}
    _level_metrics(row, second, 4, suite)
    returns = {n: [r for r, _ in first.get(f"dmlab_{n}", [])]
               + [r for r, _ in second[f"dmlab_{n}"]]
               for n in dmlab30.TRAIN_LEVELS}
    for key, cap in (("dmlab30/training_no_cap", None),
                     ("dmlab30/training_cap_100", 100.0)):
        assert row[key] == jax_dmlab30.compute_human_normalized_score(
            returns, per_level_cap=cap)
    level = f"dmlab_{dmlab30.TRAIN_LEVELS[3]}"
    assert row[f"{level}/episode_return"] == np.mean(
        [r for r, _ in second[level]])
    assert row[f"{level}/episode_frames"] == 18.0
    assert all(v == [] for v in suite.values())
    row = {}
    _level_metrics(row, {"fake_small": [(1.0, 2)]}, 4, {})
    assert row == {"fake_small/episode_return": 1.0,
                   "fake_small/episode_frames": 8.0}


# -- the driver's level plumbing ---------------------------------------------


@pytest.mark.parametrize("name", [
    "dmlab_rooms_watermaze", "dmlab30", "atari_pong", "gym_CartPole-v1",
    "doom_battle", "fake_small"])
def test_env_kwargs_and_levels_match_jax(tmp_path, name):
    from scalable_agent_tpu import driver as jax_driver
    from scalable_agent_tpu.config import apply_env_overrides as jax_over
    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch.config import apply_env_overrides

    ours, theirs = _configs(tmp_path, level_name=name,
                            dataset_path="/data/brady",
                            renderer="hardware")
    ours, theirs = apply_env_overrides(ours), jax_over(theirs)
    for field in ("width", "height", "num_action_repeats",
                  "use_instruction"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert driver.training_level_names(ours) == (
        jax_driver.training_level_names(theirs))
    for level in driver.training_level_names(ours)[:2]:
        assert driver.env_kwargs(ours, level) == jax_driver.env_kwargs(
            theirs, level)


class _Recorded:
    """A stand-in MultiEnv recording what it was built with."""

    def __init__(self, fns, frame_spec, num_workers=None, env_labels=None,
                 **_):
        self.fns, self.num_workers = fns, num_workers
        self.env_labels = env_labels

    def close(self):
        pass


def _call(fn):
    return (fn.func.__name__, fn.args,
            {k: v for k, v in fn.keywords.items()})


def test_slot_to_level_assignment_matches_jax(tmp_path, monkeypatch):
    """``make_env_groups`` on dmlab30 (64 actors in 2 groups of 32): every
    slot's level label, factory arguments and seed equal the JAX
    ``make_env_groups``' (its MultiEnv replaced by a recorder in both
    packages); slot e runs train level e mod 30."""
    from scalable_agent_tpu import driver as jax_driver
    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch.envs import dmlab30
    from scalable_agent_tpu_torch.envs.spec import TensorSpec

    monkeypatch.setattr(driver, "MultiEnv", _Recorded)
    monkeypatch.setattr(jax_driver, "MultiEnv", _Recorded)
    ours, theirs = _configs(tmp_path, level_name="dmlab30",
                            num_env_workers_per_group=4,
                            benchmark_mode=True)
    spec = TensorSpec((72, 96, 3), np.uint8)
    got = driver.make_env_groups(ours, spec, 1,
                                 driver.training_level_names(ours))
    want = jax_driver.make_env_groups(
        theirs, spec, 1, level_names=jax_driver.training_level_names(theirs))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.env_labels == w.env_labels
        assert [_call(f) for f in g.fns] == [_call(f) for f in w.fns]
        assert g.num_workers == w.num_workers == 4
    labels = got[0].env_labels + got[1].env_labels
    assert labels == [f"dmlab_{dmlab30.TRAIN_LEVELS[e % 30]}"
                      for e in range(64)]


def test_multi_agent_refuses_multi_task(tmp_path):
    from scalable_agent_tpu_torch.driver import make_env_groups
    from scalable_agent_tpu_torch.envs.spec import TensorSpec

    ours, _ = _configs(tmp_path, level_name="doom_duel", num_actors=4,
                       batch_size=2)
    with pytest.raises(ValueError, match="multi-task"):
        make_env_groups(ours, TensorSpec((72, 128, 3), np.uint8), 2,
                        ["doom_duel", "doom_dm"])


def test_level_labels_follow_the_slot_not_the_worker():
    """A MultiEnv of 6 labelled envs over 4 worker processes attributes
    each finished episode to its slot's level, and the pool's drain
    hands each episode over once."""
    from scalable_agent_tpu_torch.envs import MultiEnv, make_impala_stream
    from scalable_agent_tpu_torch.envs.spec import TensorSpec
    from scalable_agent_tpu_torch.runtime.actor import drain_level_stats

    names = ["dmlab_rooms_watermaze", "dmlab_rooms_keys_doors_puzzle",
             "dmlab_lasertag_one_opponent_small"]
    labels = [names[i % 3] for i in range(6)]
    fns = [functools.partial(make_impala_stream, labels[i], seed=i,
                             num_action_repeats=2, width=8, height=8,
                             with_instruction=False) for i in range(6)]
    envs = MultiEnv(fns, TensorSpec((8, 8, 3), np.uint8), num_workers=4,
                    env_labels=labels)
    try:
        envs.initial()
        for _ in range(7):  # the fake's episodes are 6 steps
            envs.step(np.zeros(6, np.int64))
    finally:
        envs.close()
    drained = drain_level_stats([envs])
    assert sorted(drained) == sorted(names)
    for name in names:
        assert len(drained[name]) == 2
        (ret, length), _ = drained[name]
        assert length == 6
        # The fake's reward: num_steps * (0.25 + a per-level bias).
        level = "contributed/dmlab30/" + name[len("dmlab_"):]
        bias = (sum(level.encode()) % 7) * 0.1
        assert ret == pytest.approx(6 * 2 * (0.25 + bias))
    assert drain_level_stats([envs]) == {}
    with pytest.raises(ValueError, match="env_labels"):
        MultiEnv(fns[:2], TensorSpec((8, 8, 3), np.uint8),
                 env_labels=labels)


# -- training and eval through the driver ------------------------------------


def test_dmlab30_train_emits_per_level_and_suite_scores(tmp_path):
    """The twin of tests/test_driver.py::TestMultiTaskTraining: 30 actors
    over the 30 train levels, per-level episode metrics, and the training
    scores in the metrics rows."""
    from scalable_agent_tpu_torch.config import apply_env_overrides
    from scalable_agent_tpu_torch.driver import train, training_level_names
    from scalable_agent_tpu_torch.envs import dmlab30

    config, _ = _configs(tmp_path, level_name="dmlab30", num_actors=30,
                         batch_size=30, unroll_length=6,
                         num_action_repeats=2, num_env_workers_per_group=3,
                         height=24, width=32, log_interval_s=0.0,
                         total_environment_frames=2 * 360)
    resolved = apply_env_overrides(config)
    assert resolved.use_instruction
    levels = training_level_names(resolved)
    assert levels[0] == f"dmlab_{dmlab30.TRAIN_LEVELS[0]}"
    metrics = train(config)
    assert np.isfinite(metrics["total_loss"])
    rows = [json.loads(line) for line in
            open(os.path.join(config.logdir, "metrics.jsonl"))]
    per_level = {k for r in rows for k in r
                 if k.startswith("dmlab_") and k.endswith("/episode_return")}
    assert len(per_level) == 30, per_level
    assert {k for r in rows for k in r if k.endswith("/episode_frames")}
    assert any("dmlab30/training_cap_100" in r for r in rows)
    assert any("dmlab30/training_no_cap" in r for r in rows)


@pytest.fixture(scope="module")
def trained_logdir(tmp_path_factory):
    """A checkpoint of 2 updates on one DMLab level without an instruction
    stream (so the suite eval must adopt the checkpoint's architecture),
    as tests/test_suite_eval.py's fixture, at 24x32 frames."""
    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.driver import train

    logdir = str(tmp_path_factory.mktemp("suite_eval") / "run")
    train(Config(mode="train", logdir=logdir,
                 level_name="dmlab_explore_goal_locations_small",
                 num_actors=2, batch_size=2, unroll_length=3,
                 num_action_repeats=2, num_env_workers_per_group=1,
                 total_environment_frames=2 * 2 * 3 * 2, height=24,
                 width=32, compute_dtype="float32",
                 checkpoint_interval_s=1e9, device="cpu"))
    return logdir


def _eval_config(logdir, level_name, episodes):
    from scalable_agent_tpu_torch.config import Config

    return Config(mode="test", logdir=logdir, level_name=level_name,
                  num_action_repeats=2, test_num_episodes=episodes,
                  test_batch_size=2, test_num_workers=1, width=32,
                  height=24, compute_dtype="float32", device="cpu")


def test_suite_eval_writes_scores(trained_logdir, monkeypatch):
    """The twin of tests/test_suite_eval.py::test_suite_eval_emits_scores
    with the eval fleets stepped in this process: every test level
    evaluated for the asked episodes, and ``eval_scores.json`` holding the
    JAX ``compute_human_normalized_score`` of those returns under the JAX
    keys."""
    from scalable_agent_tpu.envs import dmlab30 as jax_dmlab30
    from scalable_agent_tpu_torch import driver

    monkeypatch.setattr(driver, "worker_processes", lambda *_: 0)
    level_returns = driver.test(_eval_config(trained_logdir, "dmlab30", 2))
    assert sorted(level_returns) == sorted(
        f"dmlab_{n}" for n in jax_dmlab30.TEST_LEVELS)
    assert all(len(r) == 2 for r in level_returns.values())
    with open(os.path.join(trained_logdir, "eval_scores.json")) as f:
        scores = json.load(f)
    bare = {k[len("dmlab_"):]: v for k, v in level_returns.items()}
    assert scores == {
        "human_normalized_no_cap":
            jax_dmlab30.compute_human_normalized_score(bare, None),
        "human_normalized_cap_100":
            jax_dmlab30.compute_human_normalized_score(bare, 100.0),
        "episodes_per_level": 2,
        "mean_returns": {k: float(np.mean(v)) for k, v in bare.items()},
    }
    assert scores["human_normalized_cap_100"] <= scores[
        "human_normalized_no_cap"] + 1e-9


def test_single_level_eval_still_works(trained_logdir, monkeypatch, caplog):
    """The twin of tests/test_suite_eval.py's single-level test: three
    returns, and the level's human-normalized score logged."""
    from scalable_agent_tpu_torch import driver

    monkeypatch.setattr(driver, "worker_processes", lambda *_: 0)
    with caplog.at_level(logging.INFO, logger="scalable_agent_tpu_torch"):
        level_returns = driver.test(_eval_config(
            trained_logdir, "dmlab_explore_goal_locations_small", 3))
    returns = level_returns["dmlab_explore_goal_locations_small"]
    assert len(returns) == 3 and all(np.isfinite(r) for r in returns)
    assert any("human-normalized" in r.getMessage() for r in caplog.records)


@pytest.mark.slow
def test_suite_eval_matches_jax_live(tmp_path, trained_logdir):
    """The live JAX suite eval (a JAX checkpoint of the same size, its
    ``--mode=test --level_name=dmlab30`` with env worker processes) and
    the port's give the same ``eval_scores.json``."""
    from scalable_agent_tpu.config import Config as JaxConfig
    from scalable_agent_tpu.driver import test as jax_test
    from scalable_agent_tpu.driver import train as jax_train
    from scalable_agent_tpu_torch import driver

    jax_logdir = str(tmp_path / "jax_run")
    jax_train(JaxConfig(mode="train", logdir=jax_logdir,
                        level_name="dmlab_explore_goal_locations_small",
                        num_actors=2, batch_size=2, unroll_length=3,
                        num_action_repeats=2, num_env_workers_per_group=1,
                        total_environment_frames=2 * 2 * 3 * 2,
                        height=24, width=32, compute_dtype="float32",
                        checkpoint_interval_s=1e9))
    eval_fields = dict(mode="test", level_name="dmlab30",
                       num_action_repeats=2, test_num_episodes=2,
                       test_batch_size=2, test_num_workers=1, width=32,
                       height=24)
    jax_test(JaxConfig(logdir=jax_logdir, **eval_fields))
    driver.test(_eval_config(trained_logdir, "dmlab30", 2))
    scores = []
    for logdir in (jax_logdir, trained_logdir):
        with open(os.path.join(logdir, "eval_scores.json")) as f:
            scores.append(json.load(f))
    assert scores[0] == scores[1]


def test_populate_cache_cli(tmp_path, monkeypatch, caplog):
    """``python -m scalable_agent_tpu_torch.envs.dmlab.populate_cache``'s
    main: 2 worker processes, each resetting its env, counted."""
    from scalable_agent_tpu_torch.envs.dmlab import populate_cache

    monkeypatch.setenv("DMLAB_LEVEL_CACHE", str(tmp_path / "cache"))
    with caplog.at_level(logging.INFO, logger="scalable_agent_tpu_torch"):
        assert populate_cache.main([
            "--level_name=dmlab_watermaze", "--num_envs=4",
            "--num_workers=2", "--width=8", "--height=8"]) == 0
    assert any("generated 4 environments" in r.getMessage()
               for r in caplog.records)
