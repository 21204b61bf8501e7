"""The port's env copies, actor and driver on the CPU.

- The fake env family is a copy, not an import: the same actions give the
  same StepOutputs as the JAX package's streams, exactly.
- The actor packs [T+1, B] trajectories with the T+1 overlap, and the
  learner's unroll over one reproduces the actor's behaviour outputs.
- ``driver.train`` runs end to end with exact env-frame accounting, through
  the ActorPool, env worker processes and the prefetch thread, writes
  metric rows and checkpoints to ``--logdir``, resumes from them, and
  ``driver.test`` evaluates the newest checkpoint.
- The env worker flags keep the JAX meaning (0 is one worker per env), and
  the CLI's spawned workers never import torch.
- A torch twin of ``tests/test_learning.py::test_host_driver_learns_bandit``
  (slow, like its original).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import VectorActor

ROOT = Path(__file__).resolve().parents[1]
T, B, A = 4, 3, 9
# The first seed chip_smoke.py's learning phase tries (PERF.md, Findings).
BANDIT_SEED = 2
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")


@pytest.mark.parametrize("level,repeats", [("fake_small", 4),
                                           ("fake_bandit", 1),
                                           ("fake_memory", 2)])
def test_fake_streams_are_exact_copies(level, repeats):
    ours = make_impala_stream(level, seed=7, num_action_repeats=repeats)
    ref = jax_stream(level, seed=7, num_action_repeats=repeats)
    rng = np.random.default_rng(0)
    outputs = [(ours.initial(), ref.initial())]
    n = ours.action_space.n
    for action in rng.integers(0, n, 40):
        outputs.append((ours.step(action), ref.step(action)))
    for got, want in outputs:
        assert float(got.reward) == float(want.reward)
        assert bool(got.done) == bool(want.done)
        assert got.info == want.info
        np.testing.assert_array_equal(got.observation.frame,
                                      want.observation.frame)


def _actor(seed=0):
    fns = [functools.partial(make_impala_stream, "fake_small", seed=i)
           for i in range(B)]
    agent = ImpalaAgent(A, (16, 16, 3), core_size=32,
                        generator=torch.Generator().manual_seed(seed))
    return agent, VectorActor(agent, MultiEnv(fns, FRAME), T, seed=seed)


def test_unrolls_chain_with_the_t_plus_1_overlap():
    _, actor = _actor()
    first, second = actor.run_unroll(), actor.run_unroll()
    assert first.env_outputs.observation.frame.shape == (T + 1, B, 16, 16, 3)
    assert first.agent_outputs.policy_logits.shape == (T + 1, B, A)
    np.testing.assert_array_equal(first.env_outputs.observation.frame[-1],
                                  second.env_outputs.observation.frame[0])
    np.testing.assert_array_equal(first.agent_outputs.action[-1],
                                  second.agent_outputs.action[0])
    # The first-ever entry is the bootstrap: initial() marks every env
    # done.
    assert first.env_outputs.done[0].all()


def test_learner_unroll_reproduces_behaviour_outputs():
    """With the same weights, the learner's unroll over a trajectory gives
    the actor's behaviour logits/baselines one step later (the T+1
    layout and the carried state line up).  Both run the same float32
    ops, T=1 steps vs one T+1 unroll: 1e-5."""
    agent, actor = _actor(1)
    for _ in range(2):
        out = actor.run_unroll()
        traj = driver.to_trajectory(out, torch.device("cpu"))
        with torch.no_grad():
            (logits, baseline), _ = agent(traj.agent_outputs.action,
                                          traj.env_outputs,
                                          traj.agent_state)
        np.testing.assert_allclose(logits[:-1].numpy(),
                                   out.agent_outputs.policy_logits[1:],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(baseline[:-1].numpy(),
                                   out.agent_outputs.baseline[1:],
                                   rtol=1e-5, atol=1e-5)


def test_train_end_to_end_on_cpu(tmp_path):
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=4, batch_size=2, unroll_length=3,
                    num_action_repeats=4, log_interval_s=0.0,
                    total_environment_frames=2 * 2 * 3 * 4,
                    logdir=str(tmp_path), num_env_workers_per_group=0)
    metrics = driver.train(config)
    assert metrics["env_frames"] == 2 * config.frames_per_update()
    for key in ("total_loss", "policy_gradient_loss", "baseline_loss",
                "entropy_loss", "grad_norm", "learning_rate"):
        assert np.isfinite(metrics[key]), key
    assert metrics["nonfinite_skips"] == 0.0


def test_main_parses_the_jax_flag_names(tmp_path):
    metrics = driver.main([
        "--mode=train", "--device=cpu", "--level_name=fake_small",
        "--height=16", "--width=16", "--num_actors=2", "--batch_size=2",
        "--unroll_length=2", "--total_environment_frames=8",
        f"--logdir={tmp_path}", "--num_env_workers_per_group=0"])
    assert metrics["env_frames"] == 16.0


@pytest.mark.parametrize("requested,num_envs,want", [(0, 3, 3), (8, 32, 8),
                                                     (8, 4, 4), (2, 5, 2)])
def test_env_worker_flags_read_as_in_the_jax_package(requested, num_envs,
                                                     want):
    """--num_env_workers_per_group and --test_num_workers mean what the
    JAX MultiEnv makes of them: min(n or num_envs, num_envs) processes,
    so 0 is one per env."""
    assert driver.worker_processes(requested, num_envs) == want
    if requested == 0:
        config = Config(device="cpu", level_name="fake_small", height=16,
                        width=16, num_actors=num_envs, batch_size=num_envs,
                        num_env_workers_per_group=0)
        groups = driver.make_env_groups(config, FRAME)
        try:
            assert [envs.num_workers for envs in groups] == [want]
        finally:
            for envs in groups:
                envs.close()


def test_cli_env_workers_never_import_torch(tmp_path):
    """``python -m scalable_agent_tpu_torch.driver`` as a user runs it:
    the spawned env workers must not re-run the CLI module (which imports
    torch).  PYTHONPROFILEIMPORTTIME makes every process, the workers
    included, print one stderr line per module it imports: torch may show
    once (the driver's own process), numpy once per process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.run([
        sys.executable, "-m", "scalable_agent_tpu_torch.driver",
        "--device=cpu", "--level_name=fake_small", "--height=16",
        "--width=16", "--num_actors=2", "--batch_size=2",
        "--unroll_length=2", "--total_environment_frames=8",
        f"--logdir={tmp_path}", "--num_env_workers_per_group=2",
        "--log_interval_s=0"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert imported.count("numpy") >= 3  # the driver and its 2 workers
    assert imported.count("torch") == 1
    assert [r["step"] for r in _rows(str(tmp_path))] == [1]


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """fake_small 16x16, 2 groups each stepped by 1 worker process,
    3 updates of the fused V-trace path into a fresh logdir."""
    logdir = str(tmp_path_factory.mktemp("run"))
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=4, batch_size=2, unroll_length=3,
                    num_action_repeats=4, log_interval_s=0.0,
                    total_environment_frames=3 * 24, logdir=logdir,
                    num_env_workers_per_group=1, scan_impl="pallas",
                    checkpoint_interval_s=3600.0)
    return config, driver.train(config)


def test_train_writes_metric_rows_and_checkpoints(trained):
    config, metrics = trained
    assert metrics["env_frames"] == 3 * config.frames_per_update()
    rows = _rows(config.logdir)
    assert [r["step"] for r in rows] == [1, 2, 3]
    for row in rows:
        for key in ("total_loss", "env_frames", "fps", "actor_fps",
                    "timing/update", "timing/wait_batch", "time"):
            assert np.isfinite(row[key]), key
    assert any("episode_return" in r for r in rows)
    assert rows[-1]["env_frames"] == metrics["env_frames"]
    steps = sorted(os.listdir(os.path.join(config.logdir, "checkpoints")))
    assert steps == ["1.pt", "3.pt", "manifests"]
    saved = Config.load(os.path.join(config.logdir, "config.json"))
    assert saved == config


def test_resume_restores_env_frames_exactly(trained):
    config, _ = trained
    more = Config(**{**config.__dict__,
                     "total_environment_frames": 5 * 24})
    metrics = driver.train(more)
    assert metrics["env_frames"] == 5 * 24
    rows = _rows(config.logdir)
    # The resumed run's first update is update 4, at 4 x 24 frames.
    assert [r["step"] for r in rows][-2:] == [4, 5]
    assert rows[-2]["env_frames"] == 4 * 24


def test_test_mode_returns_the_episode_quota(trained):
    config, _ = trained
    returns = driver.main([
        "--mode=test", "--device=cpu", f"--logdir={config.logdir}",
        "--level_name=fake_small", "--height=16", "--width=16",
        "--test_num_episodes=5", "--test_batch_size=2",
        "--test_num_workers=1"])
    assert len(returns["fake_small"]) == 5
    assert all(np.isfinite(r) for r in returns["fake_small"])


def test_test_mode_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        driver.test(Config(mode="test", device="cpu", logdir=str(tmp_path),
                           level_name="fake_small", height=16, width=16))


def test_actor_failure_ends_the_run(tmp_path, monkeypatch):
    """An actor's terminal exception reaches the training loop through the
    queue and the prefetch stage, and the threads are still joined."""

    def broken(self, params=None):
        raise RuntimeError("simulator crashed")

    monkeypatch.setattr(VectorActor, "run_unroll", broken)
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=2, batch_size=2, unroll_length=2,
                    total_environment_frames=16, logdir=str(tmp_path),
                    num_env_workers_per_group=0, actor_max_restarts=0)
    with pytest.raises(RuntimeError, match="simulator crashed"):
        driver.train(config)


def _bandit_config(logdir, **overrides):
    """tests/test_learning.py's fake_bandit settings (200 updates)."""
    t, b, updates = 16, 16, 200
    base = dict(
        device="cpu", level_name="fake_bandit", logdir=str(logdir),
        height=16, width=16, num_actors=32, batch_size=b, unroll_length=t,
        num_action_repeats=1, total_environment_frames=float(
            updates * t * b), learning_rate=0.002, entropy_cost=0.003,
        num_env_workers_per_group=2, log_interval_s=0.2,
        checkpoint_interval_s=3600.0)
    base.update(overrides)
    return Config(**base)


def _assert_learned(logdir):
    """test_learning.py's curve: early rows near the random floor 4, late
    rows at least 8 and at least 4 above early."""
    returns = [r["episode_return"] for r in _rows(str(logdir))
               if "episode_return" in r]
    early, late = np.mean(returns[:3]), np.mean(returns[-5:])
    print(f"episode_return early {early:.3f} late {late:.3f} over "
          f"{len(returns)} rows; every 10th: "
          f"{[round(r, 2) for r in returns[::10]]}")
    assert len(returns) >= 8, returns
    assert early < 1.6 * 4.0, early
    assert late >= 2.0 * 4.0, late
    assert late - early >= 4.0, (early, late)


@pytest.mark.slow
def test_host_driver_learns_bandit(tmp_path):
    """tests/test_learning.py's bandit proof through the port's pool:
    fake_bandit return rises from ~4 (random) to >= 8 in 200 updates."""
    driver.train(_bandit_config(tmp_path, seed=BANDIT_SEED))
    _assert_learned(tmp_path)
