"""The port's obs producers (scalable_agent_tpu_torch/obs/) held against the
live JAX ones: the same inputs through the JAX class and the port's.

- Registry and exporters: one sequence of inc/set/observe gives equal
  ``snapshot()`` dicts and equal ``metrics.prom`` text; the writer's rows
  are the JAX rows.
- Tracer: one span sequence gives the same event names, categories and
  phases, each thread on its own track; the event budget ends in the
  truncation marker; ``set_annotate`` opens ``torch.profiler`` ranges.
- Stall attributor: one stream of interval sums and actor histograms
  gives the same categories and ``stall/*`` gauges to 1e-12.
- Watchdog: the twin of
  ``tests/test_obs_failure.py::TestWatchdog::
  test_injected_actor_stall_trips_within_timeout``, run on both.
- Flight recorder: the dump's fields, the crash handlers' dump-then-chain,
  and uninstalls that restore only what is still theirs, so the
  preemption handler layered over them is never clobbered.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu import obs as jax_obs
from scalable_agent_tpu_torch import obs
from scalable_agent_tpu_torch.runtime.fleet import (
    PreemptionMonitor,
    install_preemption_handler,
)


@pytest.fixture(autouse=True)
def _restore_globals():
    yield
    for package in (obs, jax_obs):
        package.configure_watchdog(None)
        package.configure_flight_recorder(None)
        package.configure_tracer(None)


def _drive_registry(package):
    """One sequence of instrument operations on a fresh registry."""
    registry = package.MetricsRegistry()
    registry.counter("actor/agent_steps_total", "steps").inc(3200)
    registry.counter("actor/agent_steps_total").inc(0.5)
    registry.gauge("actor_pool/queue_depth", "depth").set(2)
    registry.gauge("learner/fps", "").set(float("nan"))
    registry.gauge("9lives", "digit-led name").set(float("inf"))
    registry.gauge("callback", "sampled", fn=lambda: 7.25)
    hist = registry.histogram("actor/env_step_s", "env seconds", window=64)
    for v in np.random.default_rng(0).exponential(0.01, 100):
        hist.observe(v)
    registry.histogram("empty_s", "never observed")
    return registry


def test_registry_snapshot_and_prometheus_text_match_jax(tmp_path):
    ours, theirs = _drive_registry(obs), _drive_registry(jax_obs)
    got, want = ours.snapshot(), theirs.snapshot()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key] or (
            got[key] != got[key] and want[key] != want[key]), key
    ours_path, theirs_path = tmp_path / "ours.prom", tmp_path / "jax.prom"
    obs.PrometheusExporter(ours, str(ours_path)).dump()
    jax_obs.PrometheusExporter(theirs, str(theirs_path)).dump()
    assert ours_path.read_text() == theirs_path.read_text()
    assert "impala__9lives +Inf" in ours_path.read_text()


def test_writer_rows_match_jax(tmp_path):
    rows = {}
    for name, package in (("ours", obs), ("jax", jax_obs)):
        logdir = tmp_path / name
        with package.MetricsWriter(
                str(logdir), registry=_drive_registry(package)) as writer:
            writer.write(7, {"total_loss": 1.5, "fps": 3}, wall_time=0.0)
            writer.write_registry(7, wall_time=0.0)
        rows[name] = (logdir / "metrics.jsonl").read_text()
    assert rows["ours"] == rows["jax"]
    first, second = map(json.loads, rows["ours"].splitlines())
    assert first == {"step": 7, "time": 0.0, "total_loss": 1.5, "fps": 3.0}
    assert second["obs/actor/agent_steps_total"] == 3200.5


def _drive_tracer(package, path):
    """Nested spans on two threads, an instant and a counter sample."""
    tracer = package.Tracer(path=str(path))
    with tracer.span("learner/update", cat="learner"):
        with tracer.span("transport/upload", cat="h2d",
                         args={"bytes": 64}):
            pass
    tracer.instant("marker")
    tracer.counter("queue", {"depth": 2})

    def actor():
        with tracer.span("actor/inference", cat="actor"):
            pass
        with tracer.span("actor/env_step", cat="actor"):
            pass

    thread = threading.Thread(target=actor, name="actor-0")
    thread.start()
    thread.join()
    tracer.close()
    return list(package.load_trace_events(str(path)))


def test_tracer_events_match_jax(tmp_path):
    ours = _drive_tracer(obs, tmp_path / "ours.json")
    theirs = _drive_tracer(jax_obs, tmp_path / "jax.json")
    key = lambda e: (e["name"], e.get("cat"), e["ph"])
    meta = {"process_name"}  # the package's name is the process name
    assert ([key(e) for e in ours if e["name"] not in meta]
            == [key(e) for e in theirs if e["name"] not in meta])
    tids = {e["name"]: e["tid"] for e in ours if e["ph"] == "X"}
    assert tids["actor/inference"] == tids["actor/env_step"]
    assert tids["actor/inference"] != tids["learner/update"]
    names = {e["args"]["name"] for e in ours if e["name"] == "thread_name"}
    assert names == {"MainThread", "actor-0"}
    # The file is an unclosed JSON array that loads once closed.
    raw = (tmp_path / "ours.json").read_text()
    json.loads(raw.rstrip().rstrip(",") + "]")


def test_tracer_budget_ends_in_a_truncation_marker(tmp_path):
    tracer = obs.Tracer(path=str(tmp_path / "t.json"), max_events=10)
    for _ in range(20):
        with tracer.span("s"):
            pass
    assert not tracer.enabled
    tracer.close()
    events = list(obs.load_trace_events(str(tmp_path / "t.json")))
    assert len(events) == 11 and events[-1]["name"] == "trace_truncated"


def test_annotate_opens_profiler_ranges(tmp_path):
    tracer = obs.configure_tracer(str(tmp_path / "t.json"))
    tracer.set_annotate(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("learner/update"):
            torch.ones(4).sum()
    assert "learner/update" in {e.key for e in prof.key_averages()}


# One stream of (wait_batch, update, retire) interval sums and the actor
# seconds added to the histograms before each: every category.
STALL_STREAM = [
    ((0.05, 0.9, 0.0), (0.1, 0.3)),    # device_bound
    ((0.6, 0.1, 0.05), (0.5, 0.2)),    # env_bound
    ((0.7, 0.2, 0.0), (0.1, 0.4)),     # learner_starved
    ((0.0, 0.0, 0.0), (0.0, 0.0)),     # an empty interval
    ((0.484, 0.092, 0.0006), (0.199, 0.186)),
]


def _drive_stall(package):
    registry = package.MetricsRegistry()
    env = registry.histogram("actor/env_step_s")
    infer = registry.histogram("actor/inference_s")
    env.observe(5.0)  # an earlier run's seconds must not count
    stall = package.StallAttributor(registry)
    out = []
    for (wait, update, retire), (env_s, infer_s) in STALL_STREAM:
        env.observe(env_s)
        infer.observe(infer_s)
        category, evidence = stall.attribute(wait, update, retire_s=retire)
        out.append((category, evidence,
                    {k: v for k, v in registry.snapshot().items()
                     if k.startswith("stall/")},
                    package.StallAttributor.describe(category, evidence)))
    out.append(stall.report_stalled({"actor-0": 3.5, "learner": 1.0}))
    return out


def test_stall_attributor_matches_jax():
    ours, theirs = _drive_stall(obs), _drive_stall(jax_obs)
    categories = [c for c, *_ in ours[:-1]]
    assert categories == [c for c, *_ in theirs[:-1]]
    assert set(categories) == {"device_bound", "env_bound",
                               "learner_starved"}
    for (_, got, got_g, got_line), (_, want, want_g, want_line) in zip(
            ours[:-1], theirs[:-1]):
        assert got.keys() == want.keys() and got_g.keys() == want_g.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k
        for k in want_g:
            assert abs(got_g[k] - want_g[k]) <= 1e-12, k
        assert got_line == want_line
    assert ours[-1] == theirs[-1]


def _stall_drill(package, logdir):
    """tests/test_obs_failure.py's injected actor stall, for ``package``."""
    registry = package.MetricsRegistry()
    rec = package.FlightRecorder(logdir=str(logdir), registry=registry)
    fired = []
    wd = package.Watchdog(timeout_s=0.3, registry=registry,
                          poll_interval_s=0.05, on_stall=fired.append,
                          flight_recorder=rec).start()
    try:
        wedge = threading.Event()

        def actor_loop():
            wd.touch()
            wedge.wait(5)  # the env never answers: no further touch

        thread = threading.Thread(target=actor_loop, name="actor-0")
        thread.start()
        deadline = time.monotonic() + 2.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        in_time = time.monotonic() < deadline
        wedge.set()
        thread.join()
    finally:
        wd.stop()
    assert in_time, "the watchdog did not fire within 2 s"
    snap = registry.snapshot()
    payload = json.load(open(rec.dump_path()))
    return (fired, {k: snap[k] for k in snap
                    if k.startswith(("stall/is_", "stall/intervals_",
                                     "watchdog/"))},
            payload, os.path.getsize(rec.stacks_path()))


def test_injected_actor_stall_trips_within_timeout(tmp_path):
    fired, counters, payload, stacks = _stall_drill(obs, tmp_path / "ours")
    j_fired, j_counters, j_payload, _ = _stall_drill(jax_obs,
                                                     tmp_path / "jax")
    (stale,) = fired
    assert stale[0][0] == "actor-0" == j_fired[0][0][0]
    assert stale[0][1] >= 0.3
    assert counters == j_counters
    assert counters["stall/is_stalled_thread"] == 1.0
    assert counters["watchdog/stalls_total"] == 1.0
    assert payload["reason"] == j_payload["reason"] == "watchdog:actor-0"
    assert payload.keys() == j_payload.keys()
    assert any(e["kind"] == "stalled_thread" for e in payload["events"])
    assert stacks > 0


def test_suspended_heartbeat_is_not_flagged():
    wd = obs.Watchdog(timeout_s=0.05, registry=obs.MetricsRegistry(),
                      flight_recorder=obs.FlightRecorder())
    wd.touch("learner")
    wd.suspend("learner")  # waiting for a batch, not wedged
    time.sleep(0.1)
    assert wd.check_once() == []
    wd.touch("learner")
    time.sleep(0.1)
    assert [name for name, _ in wd.check_once()] == ["learner"]


def test_flight_recorder_dump_has_the_jax_fields(tmp_path):
    payloads = []
    for name, package in (("ours", obs), ("jax", jax_obs)):
        registry = package.MetricsRegistry()
        registry.counter("frames_total").inc(7)
        rec = package.FlightRecorder(capacity=4, logdir=str(tmp_path / name),
                                     registry=registry)
        for i in range(6):
            rec.record("unroll", f"e{i}", {"i": i})
        payloads.append(json.load(open(rec.dump("unit"))))
    ours, theirs = payloads
    assert ours.keys() == theirs.keys()
    assert ours["reason"] == "unit"
    assert [e["name"] for e in ours["events"]] == ["e2", "e3", "e4", "e5"]
    assert ours["metrics"] == theirs["metrics"] == {"frames_total": 7.0}


def test_thread_exception_dumps_then_chains(tmp_path):
    rec = obs.configure_flight_recorder(str(tmp_path))
    seen = []
    prev = threading.excepthook
    threading.excepthook = lambda args: seen.append(args.exc_type)
    uninstall = obs.install_crash_handlers(rec)
    try:
        thread = threading.Thread(target=lambda: 1 / 0, name="actor-3")
        thread.start()
        thread.join()
    finally:
        uninstall()
        threading.excepthook = prev
    assert seen == [ZeroDivisionError]
    payload = json.load(open(rec.dump_path()))
    assert payload["reason"] == "exception:ZeroDivisionError:actor-3"


def test_sigterm_dumps_then_raises_systemexit(tmp_path):
    rec = obs.configure_flight_recorder(str(tmp_path))
    uninstall = obs.install_crash_handlers(rec)
    try:
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(1)
        assert exc.value.code == 128 + signal.SIGTERM
    finally:
        uninstall()
    assert rec.pending_dump_reason == "signal:SIGTERM"
    assert json.load(open(rec.dump_path()))["reason"] == "signal:SIGTERM"


def test_uninstalls_unwind_the_preemption_layer_without_leaks(tmp_path):
    """The driver's order: crash handlers, then the preemption handler
    over them; torn down in reverse, SIGTERM's handler is the original
    again.  An uninstall never clobbers a handler layered over its own."""
    original = signal.getsignal(signal.SIGTERM)
    rec = obs.configure_flight_recorder(str(tmp_path))
    uninstall_crash = obs.install_crash_handlers(rec)
    crash_handler = signal.getsignal(signal.SIGTERM)
    monitor = PreemptionMonitor(30.0)
    uninstall_preempt = install_preemption_handler(monitor)
    preempt_handler = signal.getsignal(signal.SIGTERM)
    assert preempt_handler is not crash_handler
    try:
        # The first SIGTERM only raises the flag; the second chains to
        # the flight recorder's dump and SystemExit(143).
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert monitor.preemption_requested()
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(1)
        assert exc.value.code == 143
        assert json.load(open(rec.dump_path()))["reason"] == "signal:SIGTERM"
    finally:
        uninstall_preempt()
        assert signal.getsignal(signal.SIGTERM) is crash_handler
        uninstall_crash()
    assert signal.getsignal(signal.SIGTERM) is original
    # Out of order, the crash layer leaves the handler above it alone.
    uninstall_crash = obs.install_crash_handlers(rec)
    uninstall_preempt = install_preemption_handler(PreemptionMonitor(30.0))
    layered = signal.getsignal(signal.SIGTERM)
    uninstall_crash()
    assert signal.getsignal(signal.SIGTERM) is layered
    # ...which is why the driver unwinds in reverse: this order would
    # leave the crash handler behind.
    uninstall_preempt()
    signal.signal(signal.SIGTERM, original)
