"""The port's self-healing host loop on the CPU: fault injection
(scalable_agent_tpu_torch/runtime/faults.py), the non-finite tracker and
rollback, checkpoint tearing and save failures, actor retry and worker
respawn, and the SIGTERM preemption grace (runtime/fleet.py).

- Every grammar case of ``tests/test_chaos.py::TestFaultInjector`` and
  ``TestTriggerForms`` is parsed, and fired, by both packages with the
  same result.
- ``TestRuntimeChannel``: the twins of ``tests/test_chaos.py``'s class of
  that name (the ``chaos_inject.jsonl`` channel: one firing a line,
  ``count``, stale lines, ``proc``, torn and garbage lines), each channel
  file also fired through the JAX injector with the same result.
- ``NonFiniteTracker``: ``TestNonFiniteTracker``'s three cases.
- The driver rolls back after ``nonfinite_tolerance`` consecutive skips
  and completes, or exits 71 under ``--no_rollback`` (the twins of
  ``TestDriverRollback`` on ``fake_small``).
- A ``python -m scalable_agent_tpu_torch.driver`` subprocess that
  SIGTERMs itself (``preempt_sigterm``) exits 0 with a verified final
  checkpoint, and the same command resumes from exactly that step.
"""

import dataclasses
import functools
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_agent_tpu.runtime import faults as jax_faults
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import (
    ActorPool,
    CheckpointManager,
    Learner,
    LearnerHyperparams,
)
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.runtime.exit_codes import (
    EXIT_CODES,
    NONFINITE_EXIT_CODE,
)
from scalable_agent_tpu_torch.runtime.fleet import (
    GraceWindow,
    PreemptionMonitor,
    install_preemption_handler,
)
from scalable_agent_tpu_torch.runtime.learner import NonFiniteTracker

ROOT = Path(__file__).resolve().parents[1]
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")
SUBPROCESS_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean_faults():
    """No spec may leak between tests: the injector is process-global."""
    faults.configure_faults("")
    jax_faults.configure_faults("")
    yield
    faults.configure_faults("")
    jax_faults.configure_faults("")


# ---------------------------------------------------------------------------
# The grammar and the injector, against the JAX package's
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    "nan_grad@7;actor_raise@3:12;ckpt_torn@1;worker_kill@20",
    "p@1;p@3", "", " ; ",
    "nan_grad@7;ckpt_torn@t=5s;worker_kill@t=1.5;actor_raise@p=0.25",
    "p@t=5;p@t=2s", "p@t=5;q@p=0.5;r@3",
]
BAD_SPECS = ["p", "p@", "p@0", "p@1:,2", "@3", "p@x", "p@1 2",
             "p@t=", "p@p=", "p@t=5x", "p@p=0", "p@p=1.5"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_grammar_parses_as_in_jax(spec):
    ours = faults.parse_chaos_spec_full(spec)
    theirs = jax_faults.parse_chaos_spec_full(spec)
    assert ours.occurrences == theirs.occurrences
    assert ours.at_times == theirs.at_times
    assert ours.probs == theirs.probs
    assert faults.parse_chaos_spec(spec) == jax_faults.parse_chaos_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_raise_in_both(spec):
    with pytest.raises(ValueError, match="chaos_spec"):
        jax_faults.parse_chaos_spec_full(spec)
    with pytest.raises(ValueError, match="chaos_spec"):
        faults.parse_chaos_spec_full(spec)


@pytest.mark.parametrize("spec,seed,evals", [
    ("p@2:4", 0, 6), ("p@t=0", 0, 3), ("p@t=9999", 0, 3),
    ("p@t=0;p@t=0s", 0, 3), ("p@p=0.5", 7, 32), ("p@p=1.0", 3, 5),
    ("other@1", 0, 3)])
def test_firing_sequences_match_jax(spec, seed, evals):
    ours = faults.FaultInjector(spec, seed=seed)
    theirs = jax_faults.FaultInjector(spec, seed=seed)
    got = [ours.should_fire("p") for _ in range(evals)]
    assert got == [theirs.should_fire("p") for _ in range(evals)]
    # A fresh injector with the same spec and seed replays it.
    again = faults.FaultInjector(spec, seed=seed)
    assert [again.should_fire("p") for _ in range(evals)] == got


def test_maybe_raise_counts_every_evaluation():
    injector = faults.FaultInjector("boom@1")
    with pytest.raises(faults.InjectedFault, match="boom"):
        injector.maybe_raise("boom")
    injector.maybe_raise("boom")  # occurrence 2: no raise
    assert injector.counts() == {"boom": 2}
    assert injector.occurrences("boom") == frozenset({1})


def test_disabled_injector_is_inert():
    injector = faults.configure_faults("")
    assert not injector.active
    assert not injector.should_fire("nan_grad")
    assert injector.counts() == {}


def test_configure_installs_the_global_injector():
    injector = faults.configure_faults("nan_grad@1", seed=3)
    assert faults.get_fault_injector() is injector and injector.active
    faults.configure_faults("")
    assert not faults.get_fault_injector().active


def test_registry_is_the_jax_one():
    assert faults.CHAOS_POINTS == jax_faults.CHAOS_POINTS
    assert faults.UNPORTED_POINTS < set(faults.CHAOS_POINTS)


@pytest.mark.parametrize("spec,match", [
    ("peer_exit@1", "ROADMAP.md"), ("nan_grad@1;peer_hang@t=3", "ROADMAP"),
    ("peer_hang@p=0.5", "ROADMAP.md"), ("nan_gard@1", "unknown")])
def test_points_that_cannot_fire_are_refused(spec, match):
    with pytest.raises(ValueError, match=match):
        faults.configure_faults(spec)
    assert not faults.get_fault_injector().active


def test_service_stall_is_ported(monkeypatch):
    """The actor service's point arms and fires like the others, and its
    stall reads ``$SCALABLE_AGENT_SERVICE_STALL_S`` when it fires."""
    from scalable_agent_tpu.runtime import service as jax_service
    from scalable_agent_tpu_torch.runtime import service

    assert "service_stall" not in faults.UNPORTED_POINTS
    injector = faults.configure_faults("service_stall@2")
    try:
        assert [injector.should_fire("service_stall")
                for _ in range(3)] == [False, True, False]
    finally:
        faults.configure_faults("")
    assert service.SERVICE_STALL_S == jax_service.SERVICE_STALL_S
    monkeypatch.delenv("SCALABLE_AGENT_SERVICE_STALL_S", raising=False)
    assert service._stall_seconds() == service.SERVICE_STALL_S
    for value, want in (("0.25", 0.25), ("soon", service.SERVICE_STALL_S)):
        monkeypatch.setenv("SCALABLE_AGENT_SERVICE_STALL_S", value)
        assert service._stall_seconds() == want
        assert jax_service._stall_seconds() == want


@pytest.mark.parametrize("spec", ["param_bitflip@1",
                                  "kernel_miscompute@p=0.5",
                                  "replica_diverge@t=3"])
def test_sentinel_points_arm_with_the_sentinel(spec):
    """The sentinel's points are ported: they arm, but only in a run whose
    sentinel can fire them."""
    assert faults.configure_faults(spec).active
    config = Config(device="cpu", chaos_spec=spec)
    with pytest.raises(ValueError, match="sentinel_interval"):
        driver.arm_faults(config)
    driver.arm_faults(dataclasses.replace(config, sentinel_interval=2))
    assert faults.get_fault_injector().active


def test_preempt_sigterm_needs_the_grace_protocol():
    config = Config(device="cpu", chaos_spec="preempt_sigterm@1",
                    preemption_grace_s=0.0)
    with pytest.raises(ValueError, match="preemption_grace_s"):
        driver.arm_faults(config)
    driver.arm_faults(dataclasses.replace(config, preemption_grace_s=30.0))
    assert faults.get_fault_injector().active


def test_exit_codes_are_the_jax_ones():
    from scalable_agent_tpu.runtime import exit_codes as jax_codes

    assert EXIT_CODES == jax_codes.EXIT_CODES
    assert NONFINITE_EXIT_CODE == 71


class TestRuntimeChannel:
    """The ``<logdir>/chaos_inject.jsonl`` runtime injection channel:
    faults landing in an already-running process."""

    @staticmethod
    def _arm(path, point, **extra):
        payload = {"point": point, "t_unix": time.time(), **extra}
        with open(path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    @pytest.fixture
    def channel(self, tmp_path):
        return str(tmp_path / faults.CHANNEL_NAME)

    @staticmethod
    def _both(channel, **kwargs):
        return (faults.FaultInjector("", channel_path=channel, **kwargs),
                jax_faults.FaultInjector("", channel_path=channel,
                                         **kwargs))

    def test_channel_only_injector_is_active(self, channel):
        assert faults.FaultInjector("", channel_path=channel).active
        assert faults.CHANNEL_NAME == jax_faults.CHANNEL_NAME
        assert faults.CHANNEL_POLL_S == jax_faults.CHANNEL_POLL_S

    def test_line_arms_exactly_one_firing(self, channel):
        both = self._both(channel)
        self._arm(channel, "nan_grad")
        for injector in both:
            assert injector.should_fire("nan_grad")
            assert not injector.should_fire("nan_grad")

    def test_count_field_arms_multiple_firings(self, channel):
        both = self._both(channel)
        self._arm(channel, "nan_grad", count=3)
        for injector in both:
            assert [injector.should_fire("nan_grad") for _ in range(4)] == [
                True, True, True, False]

    def test_stale_line_from_a_dead_epoch_is_skipped(self, channel):
        both = self._both(channel)
        self._arm(channel, "nan_grad")
        with open(channel, "w") as f:
            f.write(json.dumps(
                {"point": "nan_grad", "t_unix": time.time() - 100.0})
                + "\n")
        for injector in both:
            assert not injector.should_fire("nan_grad")

    def test_proc_targeting_matches_process_id(self, channel):
        both = self._both(channel, process_id=1)
        self._arm(channel, "nan_grad", proc=0)
        self._arm(channel, "nan_grad", proc=1)
        for injector in both:
            assert injector.should_fire("nan_grad")
            assert not injector.should_fire("nan_grad")

    def test_torn_final_line_is_deferred_not_dropped(self, channel):
        both = self._both(channel)
        payload = json.dumps({"point": "nan_grad", "t_unix": time.time()})
        with open(channel, "w") as f:
            f.write(payload[:10])  # a crash-mid-append stand-in
        for injector in both:
            assert not injector.should_fire("nan_grad")
        with open(channel, "a") as f:
            f.write(payload[10:] + "\n")
        time.sleep(faults.CHANNEL_POLL_S + 0.05)  # past the poll gate
        for injector in both:
            assert injector.should_fire("nan_grad")

    def test_garbage_lines_are_ignored(self, channel):
        both = self._both(channel)
        with open(channel, "w") as f:
            f.write("not json\n")
            f.write(json.dumps({"nope": 1}) + "\n")
        self._arm(channel, "nan_grad")
        for injector in both:
            assert injector.should_fire("nan_grad")
            assert not injector.should_fire("nan_grad")

    def test_unported_points_are_skipped(self, channel, caplog):
        """A line naming a point this package cannot fire is skipped with
        a warning, never held pending."""
        injector = faults.FaultInjector("", channel_path=channel)
        self._arm(channel, "peer_exit")
        self._arm(channel, "nan_grad")
        with caplog.at_level(logging.WARNING, "scalable_agent_tpu_torch"):
            assert injector.should_fire("nan_grad")
        assert "peer_exit" in caplog.text
        assert not injector.should_fire("peer_exit")

    def test_driver_arms_the_channel_under_chaos_channel(self, tmp_path):
        config = Config(device="cpu", logdir=str(tmp_path),
                        chaos_channel=True)
        driver.arm_faults(config)
        injector = faults.get_fault_injector()
        assert injector.active
        self._arm(str(tmp_path / faults.CHANNEL_NAME), "throughput_sag")
        assert injector.should_fire("throughput_sag")
        driver.arm_faults(dataclasses.replace(config, chaos_channel=False))
        assert not faults.get_fault_injector().active


# ---------------------------------------------------------------------------
# The non-finite tracker
# ---------------------------------------------------------------------------


def test_tracker_counts_deltas_and_exhaustion():
    tracker = NonFiniteTracker(tolerance=3)
    assert not tracker.observe({"nonfinite_skips": 2.0,
                                "nonfinite_streak": 2.0})
    assert tracker.skips_total == 2.0
    # The same cumulative value again: no double count.
    assert not tracker.observe({"nonfinite_skips": 2.0,
                                "nonfinite_streak": 2.0})
    assert tracker.skips_total == 2.0
    assert tracker.observe({"nonfinite_skips": 3.0, "nonfinite_streak": 3.0})


def test_tracker_rebase_after_rollback():
    tracker = NonFiniteTracker(tolerance=2)
    tracker.observe({"nonfinite_skips": 5.0, "nonfinite_streak": 2.0})
    tracker.rebase(1.0)  # the restored checkpoint carries 1 skip
    tracker.observe({"nonfinite_skips": 2.0, "nonfinite_streak": 1.0})
    assert tracker.skips_total == 6.0


def test_tracker_zero_tolerance_disables_the_policy():
    tracker = NonFiniteTracker(tolerance=0)
    assert not tracker.observe({"nonfinite_skips": 99.0,
                                "nonfinite_streak": 99.0})


# ---------------------------------------------------------------------------
# Checkpoints: torn steps and failed saves
# ---------------------------------------------------------------------------


@pytest.fixture
def learner():
    agent = ImpalaAgent(3, (16, 16, 3), core_size=8,
                        generator=torch.Generator().manual_seed(0))
    return Learner(agent, LearnerHyperparams(), 8)


def test_torn_checkpoint_walks_back(tmp_path, learner):
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0)
    faults.configure_faults("ckpt_torn@2")
    assert ckpt.maybe_save(1, learner.state_dict())
    learner.state.env_frames = 8.0
    assert ckpt.maybe_save(2, learner.state_dict())  # saved, then torn
    step, saved = CheckpointManager(str(tmp_path)).restore()
    assert step == 1 and saved["env_frames"] == 0.0
    assert ckpt.all_steps() == [1]  # the torn step was deleted


def test_failed_save_degrades_and_a_forced_one_raises(tmp_path, learner):
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0)
    faults.configure_faults("ckpt_save_fail@1:3")
    assert not ckpt.maybe_save(1, learner.state_dict())
    assert ckpt.save_failures == 1 and ckpt.all_steps() == []
    assert ckpt.maybe_save(2, learner.state_dict())
    with pytest.raises(faults.InjectedFault):
        ckpt.maybe_save(3, learner.state_dict(), force=True)
    assert ckpt.all_steps() == [2]


# ---------------------------------------------------------------------------
# Actors: retry and worker respawn
# ---------------------------------------------------------------------------


def _pool(num_workers, **kwargs):
    """One group of 2 fake_small envs, stepped in this process
    (``num_workers=0``) or by worker processes, unroll 3."""
    fns = [functools.partial(make_impala_stream, "fake_small", seed=i)
           for i in range(2)]
    envs = MultiEnv(fns, FRAME, num_workers=num_workers)
    agent = ImpalaAgent(9, (16, 16, 3), core_size=8,
                        generator=torch.Generator().manual_seed(0))
    pool = ActorPool(agent, [envs], 3, restart_backoff_s=0.01, **kwargs)
    pool.set_params(agent)
    return pool, envs


def test_actor_raise_is_retried():
    pool, _ = _pool(0, max_restarts=2)
    faults.configure_faults("actor_raise@1")
    pool.start()
    try:
        out = pool.get_trajectory(timeout=60)
        assert out.env_outputs.reward.shape == (4, 2)
        assert pool.restarts == 1
    finally:
        pool.stop()


def test_actor_raise_past_the_budget_ends_the_run():
    pool, _ = _pool(0, max_restarts=0)
    faults.configure_faults("actor_raise@1")
    pool.start()
    try:
        with pytest.raises(faults.InjectedFault):
            pool.get_trajectory(timeout=60)
    finally:
        pool.stop()


def test_worker_kill_is_respawned():
    pool, envs = _pool(1)
    faults.configure_faults("worker_kill@2")
    pool.start()
    try:
        for _ in range(3):
            pool.get_trajectory(timeout=60)
        assert envs.total_respawns == 1
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# The driver: rollback and exit 71
# ---------------------------------------------------------------------------


def _chaos_config(tmp_path, **overrides) -> Config:
    """tests/test_chaos.py's driver settings (5 updates of 8 frames)."""
    defaults = dict(
        device="cpu", logdir=str(tmp_path / "run"), level_name="fake_small",
        num_actors=4, batch_size=2, unroll_length=4, num_action_repeats=1,
        total_environment_frames=40, height=16, width=16,
        num_env_workers_per_group=2, compute_dtype="float32",
        checkpoint_interval_s=0.0, log_interval_s=0.0, seed=5)
    defaults.update(overrides)
    return Config(**defaults)


def test_consecutive_skips_roll_back_and_training_completes(tmp_path,
                                                             caplog):
    config = _chaos_config(tmp_path, total_environment_frames=48,
                           chaos_spec="nan_grad@3:4", nonfinite_tolerance=2)
    with caplog.at_level(logging.WARNING, "scalable_agent_tpu_torch"):
        metrics = driver.train(config)
    assert metrics["env_frames"] == 48
    assert np.isfinite(metrics["total_loss"])
    assert metrics["nonfinite_skips"] == 2.0
    assert metrics["nonfinite_streak"] == 0.0
    rollbacks = [r for r in caplog.messages
                 if "rolled back to checkpoint step" in r]
    assert len(rollbacks) == 1, caplog.messages
    assert not faults.get_fault_injector().active  # disarmed at the end


def test_no_rollback_exits_71(tmp_path):
    config = _chaos_config(tmp_path, chaos_spec="nan_grad@2:3",
                           nonfinite_tolerance=2, no_rollback=True)
    with pytest.raises(SystemExit) as excinfo:
        driver.train(config)
    assert excinfo.value.code == NONFINITE_EXIT_CODE


# ---------------------------------------------------------------------------
# Preemption: the grace window, the monitor, the handler, a real SIGTERM
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_grace_window_anchors_at_the_first_observation():
    clock = _Clock()
    window = GraceWindow(30.0, clock=clock)
    assert not window.opened and window.remaining() == float("inf")
    assert window.open("signal:SIGTERM")
    clock.now += 10
    assert not window.open("decision")  # never extended
    assert window.remaining() == 20.0 and window.reason == "signal:SIGTERM"
    clock.now += 20.5
    assert window.expired() and window.remaining() == 0.0


def test_expired_grace_exits_72():
    clock = _Clock()
    codes = []
    monitor = PreemptionMonitor(5.0, clock=clock, on_fatal=codes.append)
    monitor.monitor_once()
    assert not monitor.preemption_requested() and codes == []
    monitor.request_preemption("signal:SIGTERM")
    monitor.monitor_once()
    assert monitor.preemptions == 1 and codes == []
    clock.now += 6.0
    monitor.monitor_once()
    monitor.monitor_once()
    assert codes == [72]


def test_disabled_monitor_takes_no_signal():
    before = signal.getsignal(signal.SIGTERM)
    monitor = PreemptionMonitor(0.0).start()
    assert signal.getsignal(signal.SIGTERM) is before
    monitor.stop()


def test_second_sigterm_escalates():
    """The first SIGTERM only raises the flag; the second exits 143.  The
    handler is called directly: a real signal would end this process if
    the handler were not installed."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers can be installed only from the main "
                    "thread")
    monitor = PreemptionMonitor(30.0)
    before = signal.getsignal(signal.SIGTERM)
    uninstall = install_preemption_handler(monitor)
    try:
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before
        handler(signal.SIGTERM, None)
        assert monitor.preemption_requested()
        if not callable(before):
            with pytest.raises(SystemExit) as excinfo:
                handler(signal.SIGTERM, None)
            assert excinfo.value.code == 128 + signal.SIGTERM
    finally:
        uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


FPU = 2 * 4 * 1  # batch * unroll * action repeats


def _cli(logdir, frames, *extra):
    return [sys.executable, "-m", "scalable_agent_tpu_torch.driver",
            "--device=cpu", "--level_name=fake_small", f"--logdir={logdir}",
            "--num_actors=2", "--batch_size=2", "--unroll_length=4",
            "--num_action_repeats=1", f"--total_environment_frames={frames}",
            "--height=16", "--width=16", "--num_env_workers_per_group=1",
            "--compute_dtype=float32", "--checkpoint_interval_s=3600",
            "--log_interval_s=0", "--seed=3", *extra]


def test_sigterm_drains_to_a_verified_checkpoint_and_resumes_exactly(
        tmp_path):
    logdir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    first = subprocess.run(
        _cli(logdir, 10**9, "--chaos_spec=preempt_sigterm@2",
             "--preemption_grace_s=30"),
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=SUBPROCESS_TIMEOUT_S)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "preemption drain: stopping at update" in first.stderr
    ckpt = CheckpointManager(str(logdir))
    step, saved = ckpt.restore()
    assert ckpt.verify(step, saved)[0]
    assert step >= 1 and saved["env_frames"] == step * FPU

    target = (step + 2) * FPU
    second = subprocess.run(_cli(logdir, target), env=env,
                            cwd=str(tmp_path), capture_output=True,
                            text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert second.returncode == 0, second.stderr[-3000:]
    restored = re.search(r"restored checkpoint at update (\d+)",
                         second.stderr)
    assert restored and int(restored.group(1)) == step
    final_step, final = CheckpointManager(str(logdir)).restore()
    assert final_step == step + 2 and final["env_frames"] == target
