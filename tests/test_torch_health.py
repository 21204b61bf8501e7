"""The port's run-health plane (``obs/health.py``, the flight recorder's
pin, ``driver._HealthPlane``) held against the live JAX package.

- Twins of ``tests/test_health.py``'s ``TestDetectorGoldens``,
  ``TestRecordSchemaAndArtifact`` and ``TestWindowArbitration``: each
  scenario (a synthetic stream on a fake clock, with a stub flight
  recorder) runs against the JAX monitor and the port's, the JAX test's
  assertions hold for the port's records, and the two packages' records
  and counters are equal exactly but for the wall-clock ``ts_unix``.
  ``test_prime_from_committed_rounds`` has no twin: the port refuses
  ``--health_baseline_dir=auto`` and a path (the committed rounds are TPU
  readings), and the primed-baseline golden primes the port through
  ``HealthMonitor.prime`` with the numbers the JAX monitor parses.
- ``reason_pin``: the port's ``FlightRecorder`` dumps a pinned reason as
  the JAX one does.
- Driver runs on the CPU (chaos): ``throughput_sag`` drives the whole
  anomaly protocol (record, pinned dump, exactly one profile window with
  its ``kernels.<id>.json``) and the same run without chaos stays
  anomaly-free, as ``tests/test_health.py``'s acceptance pair, and the
  port's ``obs.watch --once --json`` and ``obs.report --json`` surface
  both alike; an oversized learning rate with an inverted entropy bonus
  trips ``entropy_collapse`` with a pinned dump that ``obs.diagnose``
  names (exit 1), and the sane twin stays clean (exit 0)
  (``tests/test_learning_dynamics.py``'s ``TestChaosEntropyCollapse``).
"""

import copy
import glob
import json
import os
import time

import pytest

from scalable_agent_tpu.obs import flightrec as jax_flightrec
from scalable_agent_tpu.obs import health as jax_health
from scalable_agent_tpu.obs.registry import MetricsRegistry as JaxRegistry
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.obs import (
    diagnose,
    flightrec,
    health,
    report,
    watch,
)
from scalable_agent_tpu_torch.obs import registry as registry_lib
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.runtime.faults import configure_faults

PACKAGES = {"jax": (jax_health, JaxRegistry), "torch": (health,
                                                         MetricsRegistry)}


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


class _StubRecorder:
    """Flight-recorder stand-in: the pin/dump protocol without the
    process-global ring."""

    def __init__(self, pin=None):
        self.reason_pin = pin
        self.last_dump_reason = None
        self.events = []

    def record(self, kind, name, payload=None):
        self.events.append((kind, name, payload))

    def dump_all(self, reason):
        if self.reason_pin is not None:
            reason = self.reason_pin
        self.last_dump_reason = reason


class _Side:
    """One package's monitor in a scenario, with its clock, stub
    recorder and registry."""

    def __init__(self, package, logdir=None, pin=None, **kwargs):
        self.h, registry_cls = package
        self.clock = _FakeClock()
        self.recorder = _StubRecorder(pin)
        self.registry = registry_cls()
        self.logdir = logdir
        self._kwargs = kwargs

    def monitor(self, detectors):
        mon = self.h.HealthMonitor(
            detectors, logdir=self.logdir, clock=self.clock,
            registry=self.registry, recorder=self.recorder, **self._kwargs)
        # Records as of their step: the monitor goes on updating an open
        # one in place.
        step = mon.step
        mon.step = lambda *args, **kwargs: copy.deepcopy(
            step(*args, **kwargs))
        return mon

    def health_counters(self):
        return {k: v for k, v in self.registry.snapshot().items()
                if k.startswith("health/")}


def _wallclock_free(value):
    if isinstance(value, dict):
        return {k: _wallclock_free(v) for k, v in value.items()
                if k != "ts_unix"}
    if isinstance(value, (list, tuple)):
        return [_wallclock_free(v) for v in value]
    return value


def _twin(scenario, tmp_path=None, **side_kwargs):
    """Run ``scenario(side)`` for both packages (each in its own logdir
    when ``tmp_path`` is given); their results must be equal but for
    ``ts_unix``.  Returns the port's side and result."""
    results = {}
    for name, package in PACKAGES.items():
        logdir = str(tmp_path / name) if tmp_path is not None else None
        side = _Side(package, logdir=logdir, **side_kwargs)
        results[name] = (side, scenario(side))
    assert (_wallclock_free(results["torch"][1])
            == _wallclock_free(results["jax"][1]))
    return results["torch"]


def _default_detectors(side, *names, **kwargs):
    return [spec for spec in side.h.default_detectors(**kwargs)
            if not names or spec.name in names]


def test_default_detectors_are_the_jax_set():
    for backend in ("host", "ingraph"):
        ours = health.default_detectors(backend=backend, warmup=3)
        theirs = jax_health.default_detectors(backend=backend, warmup=3)
        strip = lambda spec: {k: v for k, v in vars(spec).items()
                              if k != "value_fn"}
        assert [strip(s) for s in ours] == [strip(s) for s in theirs]
        assert [s.value_fn is None for s in ours] == [
            s.value_fn is None for s in theirs]
    # The derived values on the same snapshots.
    snaps = [{"ledger/rho/unroll": 0.2, "ledger/rho/device": 3.0},
             {"devtel/learn/rho_clip_fraction": 0.95,
              "devtel/learn/log_rho_p95": 0.05},
             {"devtel/learn/rho_clip_fraction": 0.95}, {}]
    for ours, theirs in zip(health.default_detectors(),
                            jax_health.default_detectors()):
        if ours.value_fn is not None:
            assert ([ours.value_fn(s) for s in snaps]
                    == [theirs.value_fn(s) for s in snaps])


class TestDetectorGoldens:
    def test_step_change_trips_ewma_after_warmup(self):
        def scenario(side):
            mon = side.monitor([side.h.DetectorSpec(name="fps", metric="m",
                                                    warmup=3)])
            quiet = []
            for _ in range(4):
                side.clock.advance(10.0)
                quiet += mon.step({"m": 1000.0})
            side.clock.advance(10.0)
            return quiet, mon.step({"m": 250.0}, update=5)

        _, (quiet, fired) = _twin(scenario)
        assert quiet == [] and len(fired) == 1
        record = fired[0]
        assert record["detector"] == "fps"
        assert record["observed"] == 250.0
        assert record["baseline"] == pytest.approx(1000.0)
        assert record["rel"] >= 0.6
        assert record["primed"] is False

    def test_warmup_gates_an_early_drop(self):
        def scenario(side):
            mon = side.monitor([side.h.DetectorSpec(name="fps", metric="m",
                                                    warmup=3)])
            side.clock.advance(10.0)
            first = mon.step({"m": 1000.0})
            side.clock.advance(10.0)
            return first, mon.step({"m": 100.0})

        _, (first, second) = _twin(scenario)
        assert first == [] and second == []

    def test_slow_drift_trips_cusum_but_not_ewma(self):
        def scenario(side):
            spec = side.h.DetectorSpec
            mon = side.monitor([
                spec(name="spike", metric="loss", kind="ewma",
                     direction="high", warmup=4, z_threshold=5.0,
                     rel_threshold=None, min_rel=0.0, sigma_floor_rel=0.05),
                spec(name="drift", metric="loss", kind="cusum",
                     direction="high", warmup=4, sigma_floor_rel=0.05)])
            fired, value = [], 1.0
            for i in range(30):
                side.clock.advance(10.0)
                if i >= 5:
                    value += 0.04
                fired += mon.step({"loss": value})
            return fired

        _, fired = _twin(scenario, cooldown_s=0.0)
        names = [r["detector"] for r in fired]
        assert "drift" in names and "spike" not in names

    def test_flapping_is_suppressed_by_cooldown(self):
        def scenario(side):
            mon = side.monitor([side.h.DetectorSpec(name="fps", metric="m",
                                                    warmup=3)])
            for _ in range(4):
                side.clock.advance(10.0)
                mon.step({"m": 1000.0})
            fired = []
            for i in range(6):
                side.clock.advance(10.0)
                fired += mon.step({"m": 100.0 if i % 2 == 0 else 1000.0})
            counters = side.health_counters()
            side.clock.advance(200.0)
            return fired, counters, mon.step({"m": 100.0})

        _, (fired, counters, again) = _twin(scenario, cooldown_s=120.0)
        assert len(fired) == 1
        assert counters["health/anomalies_total"] == 1.0
        assert counters["health/suppressed_total"] >= 2.0
        assert len(again) == 1

    def test_primed_baseline_fires_inside_warmup(self, tmp_path):
        """The JAX monitor primes from a committed round; the port
        primes from the same numbers (it parses no round)."""
        artifact = {"metric": "x", "value": 1, "unit": "fps",
                    "vs_baseline": 1.0, "e2e_env_frames_per_sec": 50_000.0}
        (tmp_path / "BENCH_r07.json").write_text(json.dumps(artifact))

        def scenario(side):
            mon = side.monitor(side.h.default_detectors(warmup=8))
            if side.h is jax_health:
                source = mon.prime_from_bench(str(tmp_path))
            else:
                source = mon.prime(artifact, "BENCH_r07.json")
            side.clock.advance(10.0)
            return source, mon.step({"learner/fps": 20_000.0}, update=1)

        _, (source, fired) = _twin(scenario)
        assert source == "BENCH_r07.json"
        assert [r["detector"] for r in fired] == ["throughput"]
        record = fired[0]
        assert record["primed"] is True
        assert record["baseline"] == 50_000.0
        assert record["baseline_source"] == "BENCH_r07.json"
        assert record["z"] is None

    def test_priming_from_rounds_is_refused(self, tmp_path):
        """The counterpart of ``test_prime_from_committed_rounds``: no TPU
        round primes the port, by the flag or by the method."""
        for value in ("auto", str(tmp_path)):
            with pytest.raises(ValueError, match="ROADMAP.md"):
                Config.from_argv([f"--health_baseline_dir={value}"])
        mon = health.HealthMonitor(health.default_detectors(),
                                   registry=MetricsRegistry(),
                                   recorder=_StubRecorder())
        with pytest.raises(ValueError, match="ROADMAP.md"):
            mon.prime_from_bench(str(tmp_path))
        assert mon.prime({"unrelated": 1.0}, "x") is None
        assert mon.baseline_source is None

    def test_nonfinite_rate_detector(self):
        def scenario(side):
            mon = side.monitor(_default_detectors(side, "nonfinite"))
            out = []
            for value in (0.0, 0.0, 2.0):
                side.clock.advance(10.0)
                out.append(mon.step(
                    {"learner/nonfinite_skips_total": value}))
            return out

        _, (first, second, fired) = _twin(scenario)
        assert first == [] and second == []
        assert [r["detector"] for r in fired] == ["nonfinite"]
        assert fired[0]["observed"] == pytest.approx(0.2)
        assert fired[0]["flightrec"]["pinned"] is False

    def test_peers_alive_learns_fleet_size_from_first_sample(self):
        def scenario(side):
            mon = side.monitor(_default_detectors(side, "peers_alive"))
            out = []
            for value in (2.0, 2.0, 1.0):
                side.clock.advance(10.0)
                out.append(mon.step({"fleet/peers_alive": value}))
            return out

        _, (first, second, fired) = _twin(scenario)
        assert first == [] and second == []
        assert [r["detector"] for r in fired] == ["peers_alive"]
        assert fired[0]["baseline"] == 2.0

    @pytest.mark.parametrize("name,metrics,fires", [
        ("entropy_collapse", {"devtel/learn/entropy_frac": 0.01}, True),
        ("entropy_collapse", {"devtel/learn/entropy_frac": 0.2}, False),
        ("clip_saturation", {"devtel/learn/rho_clip_fraction": 0.95,
                             "devtel/learn/log_rho_p95": 0.5}, True),
        ("clip_saturation", {"devtel/learn/rho_clip_fraction": 0.95,
                             "devtel/learn/log_rho_p95": 0.01}, False),
        ("segment_rho", {"ledger/rho/unroll": 1.0}, False)])
    def test_learning_and_ledger_detectors(self, name, metrics, fires):
        def scenario(side):
            mon = side.monitor(_default_detectors(side, name))
            side.clock.advance(10.0)
            return mon.step(metrics, update=3)

        _, fired = _twin(scenario)
        assert [r["detector"] for r in fired] == ([name] if fires else [])


class TestRecordSchemaAndArtifact:
    @staticmethod
    def _trip(side):
        mon = side.monitor([side.h.DetectorSpec(name="fps", metric="m",
                                                warmup=2)])
        for _ in range(3):
            side.clock.advance(10.0)
            mon.step({"m": 1000.0})
        side.clock.advance(10.0)
        (record,) = mon.step({"m": 100.0}, update=7, verdict="env_bound",
                             evidence={"ledger_dominant": "unroll",
                                       "ledger_dominant_share": 0.8})
        return record, side.recorder.reason_pin, side.recorder.events, (
            side.h.read_anomalies(side.logdir))

    def test_record_schema_and_pin_protocol(self, tmp_path):
        _, (record, pin, events, reread) = _twin(self._trip, tmp_path)
        assert record["schema_version"] == 1
        assert record["id"] == "a001-fps"
        assert record["kind"] == "ewma"
        assert record["metric"] == "m"
        assert record["update"] == 7
        assert record["verdict"] == "env_bound"
        assert record["dominant_segment"] == "unroll"
        assert record["dominant_share"] == 0.8
        assert record["flightrec"] == {"pinned": True,
                                       "dump": "health:a001-fps"}
        assert pin == "health:a001-fps"
        assert ("anomaly", "fps", {"id": "a001-fps", "metric": "m"}) \
            in events
        (reread,) = reread
        assert reread["id"] == record["id"]
        assert reread["window"]["status"] == "armed"

    def test_existing_pin_is_never_demoted(self, tmp_path):
        _, (record, pin, _, _) = _twin(self._trip, tmp_path,
                                       pin="nonfinite:no_rollback")
        assert pin == "nonfinite:no_rollback"
        assert record["flightrec"]["pinned"] is False
        assert record["flightrec"]["dump"] == "nonfinite:no_rollback"

    def test_read_anomalies_skips_torn_tail(self, tmp_path):
        (tmp_path / health.ANOMALIES_JSONL).write_text(
            json.dumps({"id": "a001-x", "detector": "x"})
            + "\n" + '{"id": "a002-y", "detec')
        records = health.read_anomalies(str(tmp_path))
        assert records == jax_health.read_anomalies(str(tmp_path))
        assert [r["id"] for r in records] == ["a001-x"]

    def test_last_record_per_id_wins(self, tmp_path):
        (tmp_path / health.ANOMALIES_JSONL).write_text(
            json.dumps({"id": "a001-x", "window": {"status": "armed"}})
            + "\n"
            + json.dumps({"id": "a001-x", "window": {"status": "done"}})
            + "\n")
        (record,) = health.read_anomalies(str(tmp_path))
        assert [record] == jax_health.read_anomalies(str(tmp_path))
        assert record["window"]["status"] == "done"
        assert health.read_anomalies(str(tmp_path / "none")) == []

    def test_nonfinite_values_stay_parseable(self, tmp_path):
        def scenario(side):
            mon = side.monitor([side.h.DetectorSpec(
                name="loss", metric="m", kind="threshold",
                direction="high", limit=1.0, warmup=0)])
            side.clock.advance(10.0)
            mon.step({"m": 2.0}, evidence={"x": float("inf")})
            return side.h.read_anomalies(side.logdir)

        _, (record,) = _twin(scenario, tmp_path)
        assert record["evidence"] == {"x": "inf"}


class TestWindowArbitration:
    @staticmethod
    def _specs(side):
        return [side.h.DetectorSpec(name="a", metric="ma", warmup=2),
                side.h.DetectorSpec(name="b", metric="mb", warmup=2)]

    @staticmethod
    def _warm(side, mon, steps=3):
        for _ in range(steps):
            side.clock.advance(10.0)
            mon.step({"ma": 1000.0, "mb": 1000.0})

    def test_busy_budget_and_cooldown(self, tmp_path):
        def scenario(side):
            mon = side.monitor(self._specs(side))
            self._warm(side, mon)
            side.clock.advance(10.0)
            (rec_a,) = mon.step({"ma": 100.0, "mb": 1000.0})
            polls = [mon.poll_window(), mon.poll_window()]
            mon.note_window_open(rec_a["id"], trace_dir="/t")
            side.clock.advance(10.0)
            (rec_b,) = mon.step({"ma": 100.0, "mb": 100.0})
            mon.note_window_result(
                rec_a["id"],
                {"worst_kernel": "f.1", "worst_kernel_mfu": 0.3,
                 "dominant_kernel": "f.1", "kernels": [
                     {"name": "f.1", "mfu": 0.3, "time_us": 180.0}]},
                kernels_json="k.json")
            side.clock.advance(170.0)
            (rec_b2,) = mon.step({"ma": 1000.0, "mb": 100.0})
            mon.note_window_open(rec_b2["id"])
            mon.note_window_result(rec_b2["id"], None)
            side.clock.advance(170.0)
            (rec_a2,) = mon.step({"ma": 100.0, "mb": 1000.0})
            return (rec_a, polls, rec_b, rec_b2, rec_a2,
                    side.h.read_anomalies(side.logdir),
                    side.health_counters())

        _, (rec_a, polls, rec_b, rec_b2, rec_a2, final, counters) = _twin(
            scenario, tmp_path, cooldown_s=120.0, max_windows=2)
        assert rec_a["window"]["status"] == "armed"
        assert polls == [rec_a["id"]] * 2  # poll does not consume
        assert rec_b["window"]["status"] == "skipped:busy"
        assert rec_b2["window"]["status"] == "armed"
        assert rec_a2["window"]["status"] == "skipped:budget"
        by_id = {r["id"]: r for r in final}
        assert by_id[rec_a["id"]]["window"]["status"] == "done"
        assert by_id[rec_b2["id"]]["window"]["status"] == "empty"
        assert counters["health/profile_windows_total"] == 2.0

    def test_window_cooldown_skips(self, tmp_path):
        def scenario(side):
            mon = side.monitor(self._specs(side))
            self._warm(side, mon)
            side.clock.advance(10.0)
            (rec_a,) = mon.step({"ma": 100.0, "mb": 1000.0})
            mon.note_window_open(rec_a["id"])
            mon.note_window_result(rec_a["id"], None)
            side.clock.advance(60.0)
            return mon.step({"ma": 1000.0, "mb": 100.0})

        _, (rec_b,) = _twin(scenario, tmp_path, cooldown_s=120.0,
                            max_windows=5)
        assert rec_b["window"]["status"] == "skipped:cooldown"

    def test_result_carries_worst_kernel_delta(self, tmp_path):
        def scenario(side):
            mon = side.monitor(self._specs(side))
            mon.note_baseline_kernels(
                {"worst_kernel": "f.1", "worst_kernel_mfu": 0.5,
                 "kernels": [{"name": "f.1", "mfu": 0.5,
                              "time_us": 100.0}]})
            self._warm(side, mon)
            side.clock.advance(10.0)
            (record,) = mon.step({"ma": 100.0, "mb": 1000.0})
            mon.note_window_open(record["id"], trace_dir="/t")
            mon.note_window_result(
                record["id"],
                {"worst_kernel": "f.1", "worst_kernel_mfu": 0.3,
                 "dominant_kernel": "f.1",
                 "kernels": [{"name": "f.1", "mfu": 0.3,
                              "time_us": 180.0}]},
                kernels_json="kernels.a001-a.json")
            return side.h.read_anomalies(side.logdir)

        _, (final,) = _twin(scenario, tmp_path, cooldown_s=0.0,
                            max_windows=1)
        window = final["window"]
        assert window["status"] == "done"
        assert window["kernels_json"] == "kernels.a001-a.json"
        assert window["worst_kernel"] == "f.1"
        assert window["baseline_worst_kernel"] == "f.1"
        assert window["worst_kernel_mfu_delta"] == pytest.approx(-0.2)
        assert window["worst_kernel_time_delta_us"] == pytest.approx(80.0)

    def test_flush_finalizes_open_records(self, tmp_path):
        def scenario(side):
            mon = side.monitor(self._specs(side))
            self._warm(side, mon)
            side.clock.advance(10.0)
            (rec_a,) = mon.step({"ma": 100.0, "mb": 1000.0})
            mon.note_window_open(rec_a["id"])
            side.clock.advance(130.0)
            (rec_b,) = mon.step({"ma": 1000.0, "mb": 100.0})
            mon.flush()
            return rec_a, rec_b, side.h.read_anomalies(side.logdir)

        _, (rec_a, rec_b, final) = _twin(scenario, tmp_path,
                                         cooldown_s=0.0, max_windows=2)
        assert rec_b["window"]["status"] == "skipped:busy"
        by_id = {r["id"]: r for r in final}
        assert by_id[rec_a["id"]]["window"]["status"] == "aborted:run_ended"

    def test_flush_skips_never_opened_armed_window(self, tmp_path):
        def scenario(side):
            mon = side.monitor(self._specs(side))
            self._warm(side, mon)
            side.clock.advance(10.0)
            (record,) = mon.step({"ma": 100.0, "mb": 1000.0})
            mon.flush()
            return (record, side.h.read_anomalies(side.logdir),
                    mon.poll_window())

        _, (record, (final,), poll) = _twin(scenario, tmp_path,
                                            cooldown_s=0.0)
        assert record["window"]["status"] == "armed"
        assert final["window"]["status"] == "skipped:run_ended"
        assert poll is None


@pytest.mark.parametrize("pin", [None, "health:a001-fps"])
def test_flight_recorder_pin_matches_the_jax_recorder(tmp_path, pin):
    """A pinned reason survives a later dump, whose own reason becomes
    ``secondary_reason``; a dump under the pinned reason has none."""
    payloads = []
    for name, module, registry in (
            ("jax", jax_flightrec, JaxRegistry()),
            ("torch", flightrec, MetricsRegistry())):
        recorder = module.FlightRecorder(logdir=str(tmp_path / name),
                                         registry=registry)
        recorder.reason_pin = pin
        recorder.record("anomaly", "fps", {"id": "a001-fps"})
        first = json.loads(open(recorder.dump("signal:SIGTERM")).read())
        second = json.loads(open(recorder.dump(
            pin or "exception:X")).read())
        payloads.append([
            {k: v for k, v in p.items()
             if k in ("reason", "secondary_reason", "dump_count")}
            for p in (first, second)] + [recorder.last_dump_reason])
    assert payloads[0] == payloads[1]
    first, second, last = payloads[1]
    assert first["reason"] == (pin or "signal:SIGTERM")
    assert first.get("secondary_reason") == (
        "signal:SIGTERM" if pin else None)
    assert "secondary_reason" not in second
    assert last == (pin or "exception:X")


# -- driver runs on the CPU --------------------------------------------------


def _health_config(tmp_path, **overrides):
    base = dict(
        device="cpu", mode="train", logdir=str(tmp_path / "run"),
        level_name="fake_small", num_actors=2, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=96,  # 12 updates of 8 frames
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, seed=5,
        # One actor group (the JAX pair runs two): the data, and so the
        # loss and grad-norm streams, do not depend on thread timing, and
        # under _PipelineClock each interval hands over exactly one
        # unroll, so actor/fps is not a 0-or-2 count and no fps depends on
        # the machine's load.  As the JAX pair: 6 warm-up intervals build the
        # baselines, the z floor rides above the batch-2 run's loss
        # swings, and the sag's relative fps drop trips on its own.
        health_warmup_intervals=6, health_z_threshold=6.0,
        health_max_windows=1, health_window_updates=2)
    base.update(overrides)
    return Config(**base)


class _PipelineClock:
    """The loop's clock for the CPU driver runs (``driver.train(clock=)``):
    the rows' fps and actor fps, which the throughput detectors read, come
    from it instead of the wall clock.

    Each reading first waits until the actor has filled the pipeline
    behind the updates taken so far: the trajectory queue, the prefetch
    thread's hand and the staging slot hold ``AHEAD`` unrolls, so after
    update k exactly k + AHEAD have been published.  Every interval then
    hands over exactly one unroll, whatever the load on the machine.  Each
    reading advances the time by ``STEP_S``; ``sleep`` (the
    ``throughput_sag`` pause) advances it without sleeping."""

    STEP_S = 0.1
    AHEAD = 3
    TIMEOUT_S = 120.0

    def __init__(self, registry, config):
        self._steps = registry.counter("actor/agent_steps_total")
        self._per_unroll = config.unroll_length * config.batch_size
        self._readings = 0
        self._now = 0.0

    def monotonic(self) -> float:
        want = (self._readings + self.AHEAD) * self._per_unroll
        deadline = time.monotonic() + self.TIMEOUT_S
        while self._steps.value < want:
            assert time.monotonic() < deadline, (
                f"the actor published {self._steps.value} of {want} agent "
                f"steps")
            time.sleep(0.002)
        self._readings += 1
        self._now += self.STEP_S
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += seconds


@pytest.fixture
def registry(monkeypatch):
    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    configure_faults("")
    yield registry
    configure_faults("")


def _consoles(capsys, logdir):
    """``obs.watch --once --json`` and ``obs.report --json`` on a run's
    logdir, in process: (payload, report), both exiting 0."""
    assert watch.main([logdir, "--once", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert report.main(["--json", logdir]) == 0
    return payload, json.loads(capsys.readouterr().out)


@pytest.mark.chaos
def test_throughput_sag_drives_the_full_anomaly_protocol(
        tmp_path, monkeypatch, registry, capsys):
    monkeypatch.setenv("SCALABLE_AGENT_LEDGER_MFU_PEAK", "1e12")
    config = _health_config(tmp_path, chaos_spec="throughput_sag@8:11")
    metrics = driver.train(config, clock=_PipelineClock(registry, config))
    assert metrics["env_frames"] == 96

    records = health.read_anomalies(config.logdir)
    throughput = [r for r in records if r["detector"] == "throughput"]
    assert len(throughput) == 1, records  # the second sag: cooldown
    record = throughput[0]
    assert record["observed"] < record["baseline"]
    assert record["rel"] >= 0.6
    assert (record["verdict"] is not None
            or record["dominant_segment"] is not None), record

    assert record["flightrec"]["pinned"] is True
    assert record["flightrec"]["dump"] == f"health:{record['id']}"
    (dump,) = glob.glob(os.path.join(config.logdir, "flightrec.*.json"))
    assert json.load(open(dump))["reason"] == f"health:{record['id']}"

    assert record["window"]["status"] == "done", record
    kernels_json = record["window"]["kernels_json"]
    assert os.path.basename(kernels_json) \
        == f"kernels.{record['id']}.json"
    table = json.load(open(kernels_json))
    assert table["kernels"] and table["dominant_kernel"]
    assert record["window"]["worst_kernel"]
    assert len(glob.glob(os.path.join(config.logdir,
                                      "health_profile.*"))) == 1

    prom = open(os.path.join(config.logdir, "metrics.prom")).read()
    assert "impala_health_profile_windows_total 1.0" in prom
    assert "impala_health_anomalies_total" in prom
    assert "impala_kernel_matched_time_frac" in prom
    assert registry.snapshot()["health/profile_windows_total"] == 1.0
    assert registry.snapshot()["health/suppressed_total"] >= 1.0

    payload, machine = _consoles(capsys, config.logdir)
    assert payload["health"]["anomalies"] >= 1
    assert any(r["detector"] == "throughput"
               for r in payload["health"]["recent"])
    assert machine["anomalies"] is not None
    assert any(a["id"] == record["id"] for a in machine["anomalies"])


@pytest.mark.chaos
def test_clean_run_stays_anomaly_free(tmp_path, registry, capsys):
    config = _health_config(tmp_path)
    metrics = driver.train(config, clock=_PipelineClock(registry, config))
    assert metrics["env_frames"] == 96
    assert health.read_anomalies(str(tmp_path / "run")) == []
    prom = (tmp_path / "run" / "metrics.prom").read_text()
    assert "impala_health_anomalies_total 0.0" in prom
    assert not glob.glob(str(tmp_path / "run" / "health_profile.*"))
    payload, machine = _consoles(capsys, str(tmp_path / "run"))
    assert payload["health"]["anomalies"] == 0
    assert payload["health"]["recent"] == []
    assert machine["anomalies"] is None


@pytest.mark.chaos
def test_oversized_lr_trips_entropy_collapse_sane_twin_clean(tmp_path,
                                                              registry,
                                                              capsys):
    """A divergence-scale lr with an inverted entropy bonus collapses the
    policy: an ``entropy_collapse`` record with a pinned flight-recorder
    dump, which ``obs.diagnose`` names (exit 1); the identical sane config
    writes no learning anomaly and diagnoses clean (exit 0)."""
    common = dict(total_environment_frames=80, checkpoint_interval_s=0.0,
                  health_warmup_intervals=8, health_z_threshold=4.0,
                  health_max_windows=2, health_window_updates=5)
    bad = _health_config(tmp_path / "bad", learning_rate=0.5,
                         entropy_cost=-5.0, **common)
    driver.train(bad)
    records = health.read_anomalies(bad.logdir)
    collapse = [r for r in records if r["detector"] == "entropy_collapse"]
    assert collapse, [r["detector"] for r in records]
    assert collapse[-1]["flightrec"]["dump"]
    assert collapse[-1]["observed"] < 0.05
    diagnosis = diagnose.build_diagnosis(bad.logdir)
    names = [v["name"] for v in diagnosis["verdicts"]]
    assert "entropy_collapse" in names
    verdict = diagnosis["verdicts"][names.index("entropy_collapse")]
    assert any(a.get("flightrec", {}).get("dump")
               for a in verdict["anomalies"])
    assert diagnose.main([bad.logdir]) == 1

    sane = _health_config(tmp_path / "sane", **common)
    driver.train(sane)
    sane_diagnosis = diagnose.build_diagnosis(sane.logdir)
    assert sane_diagnosis["clean"], sane_diagnosis["verdicts"]
    assert not [r for r in health.read_anomalies(sane.logdir)
                if r["detector"] in ("entropy_collapse", "clip_saturation")]
    assert diagnose.main([sane.logdir]) == 0
    capsys.readouterr()


def test_health_off_arms_nothing(tmp_path, registry):
    config = _health_config(tmp_path, health=False,
                            total_environment_frames=24)
    plane = driver._HealthPlane(config, driver.resolve_device("cpu"))
    assert not plane.active and not plane.window_open
    assert plane.maybe_open_window(3) is False
    plane.step({"learner/fps": 1.0}, update=1)
    plane.finalize()
    driver.train(config)
    assert not os.path.exists(os.path.join(config.logdir,
                                           health.ANOMALIES_JSONL))
    assert "health/anomalies_total" not in registry.snapshot()
