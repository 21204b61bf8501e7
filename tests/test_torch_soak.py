"""The port's chaos soak (``scalable_agent_tpu_torch/runtime/soak.py``):
torch twins of ``tests/test_soak.py``, held against the live JAX module.

- Schedule sampling: the JAX twins (seeded determinism, the middle of
  the budget, fleet-only points, weights, unknown points), and
  ``sample_schedule`` equal to the JAX one for the same arguments.
- The pure invariant checker: the JAX twins, and ``check_invariants``
  equal to the JAX one on the same synthetic streams.
- Report I/O: the atomic write, torn and missing reports.
- ``TestMiniSoak``: one real seeded single-process soak for the whole
  class (a ``python -m scalable_agent_tpu_torch.driver`` subprocess on the
  CPU fed through the runtime channel, >= 3 distinct points), the JAX
  class's seven checks.  The JAX pair that asserts the faults landed and
  the drain left exact frames fails when its driver starts slowly (under
  a loaded test run): its engine times the schedule from the launch, so
  the injector, armed later, skips early lines as stale, and a SIGTERM
  before the preemption handler is installed kills the run without a
  checkpoint.  The port's engine starts the schedule at the run's first
  update and SIGTERMs once every injected fault is counted, so the twin
  grades what landed (ROADMAP.md, queue 3).
- The fleet branch raises the port's unported-flag error; the JAX
  ``TestFleetSoak`` (slow, multi-process) waits for the fleet.
"""

import json
import os

import pytest

from scalable_agent_tpu.runtime import soak as jax_soak
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.runtime import soak
from scalable_agent_tpu_torch.runtime.faults import CHANNEL_NAME, CHAOS_POINTS

pytestmark = pytest.mark.chaos


class TestSampleSchedule:
    def test_deterministic_in_seed(self):
        a = soak.sample_schedule(7, 6, 120.0)
        b = soak.sample_schedule(7, 6, 120.0)
        assert a == b
        assert a != soak.sample_schedule(8, 6, 120.0)

    def test_events_land_in_the_middle_of_the_budget(self):
        events = soak.sample_schedule(1, 50, 100.0)
        lo = 100.0 * soak.SCHEDULE_WARMUP_FRAC
        hi = 100.0 * (1.0 - soak.SCHEDULE_COOLDOWN_FRAC)
        assert all(lo <= e["t_s"] <= hi for e in events)
        assert [e["t_s"] for e in events] == sorted(
            e["t_s"] for e in events)

    def test_single_process_excludes_fleet_only_points(self):
        events = soak.sample_schedule(2, 200, 100.0, num_processes=1)
        points = {e["point"] for e in events}
        assert points and not (points & set(soak.FLEET_ONLY_POINTS))
        assert all(e["proc"] is None for e in events)

    def test_fleet_schedule_targets_sampled_processes(self):
        events = soak.sample_schedule(2, 50, 100.0, num_processes=3)
        assert all(e["proc"] in (0, 1, 2) for e in events)
        assert {e["point"] for e in events} & {"peer_exit"}

    def test_zero_weight_points_are_never_sampled(self):
        events = soak.sample_schedule(3, 300, 100.0, num_processes=3)
        assert "preempt_sigterm" not in {e["point"] for e in events}

    def test_unknown_point_raises(self):
        with pytest.raises(ValueError, match="bogus"):
            soak.sample_schedule(0, 1, 10.0, points=["bogus"])

    def test_every_default_weight_key_is_a_registry_point(self):
        assert set(soak.DEFAULT_WEIGHTS) == set(CHAOS_POINTS)
        assert set(soak.DEFAULT_RECOVERY_S) == set(CHAOS_POINTS)

    def test_recovery_window_rides_the_event(self):
        events = soak.sample_schedule(
            4, 10, 100.0, points=["nan_grad"],
            recovery_s={"nan_grad": 7.5})
        assert all(e["recovery_s"] == 7.5 for e in events)

    @pytest.mark.parametrize("args,kwargs", [
        ((1, 5, 25.0), {}), ((7, 6, 120.0), {}), ((2, 200, 100.0), {}),
        ((2, 50, 100.0), {"num_processes": 3}),
        ((35, 5, 120.0), {"points": ["peer_exit", "nan_grad",
                                     "throughput_sag", "actor_raise"],
                          "weights": {"peer_exit": 3.0},
                          "num_processes": 3}),
        ((4, 10, 100.0), {"points": ["nan_grad"],
                          "recovery_s": {"nan_grad": 7.5}}),
        ((9, 12, 20.0), {"points": ["nan_grad", "param_bitflip",
                                    "throughput_sag"]})])
    def test_matches_jax(self, args, kwargs):
        assert soak.sample_schedule(*args, **kwargs) == (
            jax_soak.sample_schedule(*args, **kwargs))
        for name in ("DEFAULT_WEIGHTS", "DEFAULT_RECOVERY_S",
                     "FLEET_ONLY_POINTS", "SENTINEL_POINTS",
                     "SCHEDULE_WARMUP_FRAC", "SCHEDULE_COOLDOWN_FRAC",
                     "SOAK_REPORT_NAME", "SOAK_SCHEMA_VERSION"):
            assert getattr(soak, name) == getattr(jax_soak, name), name


def _rows(fps_list, t0=1000.0, dt=2.0):
    return [{"step": i, "time": t0 + dt * i, "fps": fps}
            for i, fps in enumerate(fps_list)]


def _good_ckpt(step=9, fpu=32):
    return {"verified": True, "step": step,
            "env_frames": float(step * fpu)}


def _check(**kwargs):
    """The port's verdict, held equal to the JAX one on the same rows."""
    ours = soak.check_invariants(**kwargs)
    assert ours == jax_soak.check_invariants(**kwargs)
    return ours


class TestCheckInvariants:
    def test_healthy_run_passes_everything(self):
        inv = _check(
            metrics_rows=_rows([100.0] * 10),
            mttr_events=[{"mttr_s": 12.0}],
            anomalies=[], injected=[], ckpt=_good_ckpt(),
            frames_per_update=32, mttr_ceiling_s=30.0)
        assert all(v["ok"] for v in inv.values()), inv
        assert set(inv) == {
            "throughput_floor", "mttr_ceiling", "frame_exactness",
            "final_checkpoint", "quiet_outside_windows"}

    def test_floor_breach_outside_windows_fails(self):
        fps = [100.0] * 10
        fps[7] = 10.0
        inv = _check(
            metrics_rows=_rows(fps), mttr_events=[], anomalies=[],
            injected=[], ckpt=_good_ckpt(), frames_per_update=32)
        verdict = inv["throughput_floor"]
        assert not verdict["ok"]
        assert verdict["worst_frac"] < 0.8
        assert verdict["baseline_fps"] == 100.0

    def test_sag_inside_a_declared_window_is_excluded(self):
        fps = [100.0] * 10
        fps[5] = 10.0
        injected = [{"point": "worker_kill", "t_unix": 1000.0 + 8.5,
                     "recovery_s": 3.0}]
        inv = _check(
            metrics_rows=_rows(fps), mttr_events=[], anomalies=[],
            injected=injected, ckpt=_good_ckpt(), frames_per_update=32)
        verdict = inv["throughput_floor"]
        assert verdict["ok"], verdict
        assert verdict["rows_excluded"] >= 2

    def test_warmup_rows_are_excluded(self):
        fps = [5.0, 20.0, 100.0, 100.0, 100.0, 100.0]
        inv = _check(
            metrics_rows=_rows(fps), mttr_events=[], anomalies=[],
            injected=[], ckpt=_good_ckpt(), frames_per_update=32,
            warmup_until_unix=1000.0 + 4.5)
        assert inv["throughput_floor"]["ok"]
        assert inv["throughput_floor"]["rows_graded"] == 2

    def test_no_healthy_rows_is_an_explicit_fail(self):
        inv = _check(
            metrics_rows=[], mttr_events=[], anomalies=[],
            injected=[], ckpt=_good_ckpt(), frames_per_update=32)
        assert not inv["throughput_floor"]["ok"]
        assert "no healthy-window" in inv["throughput_floor"]["detail"]

    def test_mttr_breach_fails_and_vacuous_passes(self):
        breach = _check(
            metrics_rows=_rows([100.0] * 4),
            mttr_events=[{"mttr_s": 45.0}, {"mttr_s": 200.0}],
            anomalies=[], injected=[], ckpt=_good_ckpt(),
            frames_per_update=32, mttr_ceiling_s=180.0)
        assert not breach["mttr_ceiling"]["ok"]
        assert breach["mttr_ceiling"]["worst_s"] == 200.0
        vacuous = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[], injected=[], ckpt=_good_ckpt(),
            frames_per_update=32)
        assert vacuous["mttr_ceiling"]["ok"]
        assert vacuous["mttr_ceiling"]["events"] == 0

    def test_frame_mismatch_fails(self):
        ckpt = {"verified": True, "step": 9, "env_frames": 289.0}
        inv = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[], injected=[], ckpt=ckpt, frames_per_update=32)
        assert not inv["frame_exactness"]["ok"]
        assert inv["frame_exactness"]["expected"] == 288.0

    def test_missing_checkpoint_fails_both_ckpt_invariants(self):
        inv = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[], injected=[],
            ckpt={"verified": False, "step": None, "env_frames": None,
                  "error": "no checkpoint on disk"},
            frames_per_update=32)
        assert not inv["final_checkpoint"]["ok"]
        assert not inv["frame_exactness"]["ok"]

    def test_stray_anomaly_fails_windowed_anomaly_passes(self):
        injected = [{"point": "actor_raise", "t_unix": 2000.0,
                     "recovery_s": 20.0}]
        windowed = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[{"id": "a001-x", "ts_unix": 2010.0}],
            injected=injected, ckpt=_good_ckpt(), frames_per_update=32)
        assert windowed["quiet_outside_windows"]["ok"]
        stray = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[{"id": "a001-x", "ts_unix": 2100.0,
                        "detector": "throughput"}],
            injected=injected, ckpt=_good_ckpt(), frames_per_update=32)
        verdict = stray["quiet_outside_windows"]
        assert not verdict["ok"]
        assert verdict["stray_anomalies"][0]["id"] == "a001-x"

    def test_sentinel_trips_beyond_the_injected_budget_fail(self):
        injected = [{"point": "param_bitflip", "t_unix": 2000.0,
                     "recovery_s": 30.0}]
        within = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[], injected=injected, ckpt=_good_ckpt(),
            frames_per_update=32, sentinel_trips=1)
        assert within["quiet_outside_windows"]["ok"]
        beyond = _check(
            metrics_rows=_rows([100.0] * 4), mttr_events=[],
            anomalies=[], injected=injected, ckpt=_good_ckpt(),
            frames_per_update=32, sentinel_trips=2)
        assert not beyond["quiet_outside_windows"]["ok"]

    def test_never_injected_events_declare_no_window(self):
        planned_only = [{"point": "worker_kill", "recovery_s": 1000.0}]
        inv = _check(
            metrics_rows=_rows([100.0] * 6), mttr_events=[],
            anomalies=[{"id": "a001-x", "ts_unix": 1004.0}],
            injected=planned_only, ckpt=_good_ckpt(),
            frames_per_update=32)
        assert not inv["quiet_outside_windows"]["ok"]


class TestReportIO:
    def test_atomic_write_then_read_roundtrip(self, tmp_path):
        report = {"schema_version": soak.SOAK_SCHEMA_VERSION,
                  "pass": True, "invariants": {}}
        path = soak.write_report(str(tmp_path), report)
        assert os.path.basename(path) == soak.SOAK_REPORT_NAME
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
        assert soak.read_soak_report(str(tmp_path)) == report
        assert jax_soak.read_soak_report(str(tmp_path)) == report

    def test_unreadable_report_reads_as_none(self, tmp_path):
        assert soak.read_soak_report(str(tmp_path)) is None
        (tmp_path / soak.SOAK_REPORT_NAME).write_text("{torn")
        assert soak.read_soak_report(str(tmp_path)) is None


@pytest.mark.parametrize("flag", ["--elastic=true",
                                  "--distributed_num_processes=3"])
def test_fleet_soak_is_unported(flag, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        soak.main(["run", f"--logdir={tmp_path}", "--device=cpu", flag])


def test_recovery_overrides_parse():
    got = soak._recovery_overrides("nan_grad=2,param_bitflip=3.5")
    assert got["nan_grad"] == 2.0 and got["param_bitflip"] == 3.5
    assert got["worker_kill"] == soak.DEFAULT_RECOVERY_S["worker_kill"]
    assert soak._recovery_overrides("") is None
    with pytest.raises(ValueError, match="soak_recovery_s"):
        soak._recovery_overrides("nan_gard=2")


_INVARIANT_NAMES = {"throughput_floor", "mttr_ceiling",
                    "frame_exactness", "final_checkpoint",
                    "quiet_outside_windows"}


def _soak_config(tmp_path, **overrides):
    defaults = dict(
        mode="train", logdir=str(tmp_path / "run"), device="cpu",
        level_name="fake_small", num_actors=4, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=10_000_000,  # the budget ends the run
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=1.0,
        log_interval_s=0.25, preemption_grace_s=30.0, seed=5)
    defaults.update(overrides)
    return Config(**defaults)


class TestMiniSoak:
    """A real seeded single-process soak, >= 3 distinct points through the
    runtime channel, one complete graded report: one driver subprocess
    for the whole class.  The budget counts from the run's first update,
    so it can be shorter than the JAX twin's 25 s."""

    SEED = 1  # schedule spans 4 distinct single-process points
    BUDGET_S = 10.0

    @pytest.fixture(scope="class")
    def report_and_logdir(self, tmp_path_factory):
        tmp_path = tmp_path_factory.mktemp("mini_soak")
        config = _soak_config(tmp_path)
        report = soak.run_soak(
            config, seed=self.SEED, num_faults=5, budget_s=self.BUDGET_S,
            drain_grace_s=90.0)
        return report, config.logdir

    def test_schedule_spans_three_distinct_points(self):
        events = soak.sample_schedule(self.SEED, 5, self.BUDGET_S)
        assert len({e["point"] for e in events}) >= 3

    def test_report_is_complete_and_graded(self, report_and_logdir):
        report, logdir = report_and_logdir
        assert report["schema_version"] == soak.SOAK_SCHEMA_VERSION
        assert set(report["invariants"]) == _INVARIANT_NAMES
        assert all(isinstance(v["ok"], bool)
                   for v in report["invariants"].values())
        assert isinstance(report["pass"], bool)
        assert soak.read_soak_report(logdir) == report

    def test_at_least_three_distinct_points_injected(
            self, report_and_logdir):
        report, logdir = report_and_logdir
        assert len(report["injected"]) >= 3
        assert len(report["points"]) >= 3
        with open(os.path.join(logdir, CHANNEL_NAME)) as f:
            lines = f.read().splitlines()
        assert len(lines) == len(report["injected"])
        assert [json.loads(line)["point"] for line in lines] == [
            e["point"] for e in report["injected"]]

    def test_faults_actually_landed_in_the_worker(
            self, report_and_logdir):
        report, _ = report_and_logdir
        assert report["counters"]["faults_injected_total"] >= 3
        assert report["counters"]["faults_injected_total"] == len(
            report["injected"])

    def test_injected_events_are_not_reported_as_skipped(
            self, report_and_logdir):
        report, _ = report_and_logdir
        injected = {(e["point"], e["t_s"]) for e in report["injected"]}
        skipped = {(e["point"], e["t_s"])
                   for e in report["planned_not_injected"]}
        assert injected, "the mini soak injected nothing"
        assert not injected & skipped
        assert all(e.get("t_unix") for e in report["injected"])

    def test_drain_left_exact_frames_and_a_verified_checkpoint(
            self, report_and_logdir):
        report, _ = report_and_logdir
        assert report["worker_rc"] == 0
        assert report["drained"] is True
        assert report["invariants"]["final_checkpoint"]["ok"]
        assert report["invariants"]["frame_exactness"]["ok"]

    def test_cli_report_renders_the_verdict(self, report_and_logdir,
                                            capsys):
        report, logdir = report_and_logdir
        rc = soak.main(["report", f"--logdir={logdir}"])
        out = capsys.readouterr().out
        assert "chaos soak:" in out
        for name in _INVARIANT_NAMES:
            assert name in out
        assert rc == (0 if report["pass"] else 1)
