"""The port's obs consumers (``obs/aggregate.py``, ``report.py``,
``diagnose.py``, ``watch.py`` and ``MetricsHTTPServer``) held against the
live JAX ones.

Every twin below names the JAX test it mirrors.  The same synthetic prom
text, traces and logdirs go through the JAX function and the port's, the
JAX test's assertions hold for the port's result, and the two results are
equal exactly (both do the same Python float arithmetic), but for paths,
the wall-clock ``generated_unix`` and the recommendation prose, which
names the port's flags (``_same``).  The JAX report and console are always
called with ``bench_dir`` set to an empty directory, so neither side reads
a round: the port's ``bench_dir`` takes no directory, since the committed
rounds are TPU readings (``test_bench_dir_raises_and_the_clis_exit_2``
replaces the JAX tests that read them).

Then the port's own: a CPU driver run with a profile window whose logdir
both packages' CLIs read alike, scraped live over ``--metrics_http_port``,
and a run whose port is already bound, which logs the JAX error and
finishes.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from scalable_agent_tpu.obs import aggregate as jax_aggregate
from scalable_agent_tpu.obs import diagnose as jax_diagnose
from scalable_agent_tpu.obs import exporters as jax_exporters
from scalable_agent_tpu.obs import report as jax_report
from scalable_agent_tpu.obs import watch as jax_watch
from scalable_agent_tpu.obs.registry import MetricsRegistry as JaxRegistry
from scalable_agent_tpu.obs.trace import Tracer as JaxTracer
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.obs import (
    aggregate,
    diagnose,
    learning,
    report,
    watch,
)
from scalable_agent_tpu_torch.obs import registry as registry_lib
from scalable_agent_tpu_torch.obs.exporters import (
    MetricsHTTPServer,
    PrometheusExporter,
    render_prometheus,
)
from scalable_agent_tpu_torch.obs.health import ANOMALIES_JSONL
from scalable_agent_tpu_torch.obs.kernels import write_kernels_json
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.obs.trace import Tracer, load_trace_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Keys that may differ: the wall clock, and the recommendation prose.
VOLATILE = ("generated_unix", "recommendation")


@pytest.fixture
def nobench(tmp_path):
    path = tmp_path / "nobench"
    path.mkdir()
    return str(path)


def _same(got, want):
    """Port and JAX results equal but for ``VOLATILE`` keys, at any
    depth."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (
            sorted(set(got) ^ set(want)))
        for key in want:
            if key not in VOLATILE:
                _same(got[key], want[key])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        assert got == want or (got != got and want != want), (got, want)


def _reports(logdir, nobench):
    """(port, JAX) ``build_report`` of one logdir, asserted equal."""
    got = report.build_report(logdir)
    want = jax_report.build_report(logdir, bench_dir=nobench)
    _same(got, want)
    return got, want


def _payloads(logdir, nobench):
    got = watch.build_payload(logdir)
    want = jax_watch.build_payload(logdir, bench_dir=nobench)
    _same(got, want)
    return got, want


def _diagnoses(logdir):
    got = diagnose.build_diagnosis(logdir)
    want = jax_diagnose.build_diagnosis(logdir)
    _same(got, want)
    return got, want


def _run_main(capsys, module, jax_module, argv, jax_argv=None):
    """One CLI ``main`` of each package (the JAX one on ``jax_argv`` when
    given): (rc, port stdout, port stderr, JAX stdout), the two exit
    codes asserted equal."""
    rc = module.main(argv)
    out, err = capsys.readouterr()
    jax_rc = jax_module.main(jax_argv or argv)
    jax_out, jax_err = capsys.readouterr()
    assert rc == jax_rc, (rc, jax_rc, err, jax_err)
    return rc, out, err, jax_out


# The text report's pointers that name the port's module and ROADMAP.md's
# queue where the JAX report names its own (the recommendation prose).
POINTERS = (("scalable_agent_tpu.obs.diagnose",
             "scalable_agent_tpu_torch.obs.diagnose"),
            ("(ROADMAP item 3)", "(ROADMAP.md, queue 2)"))


def _text_report(capsys, logdir, nobench):
    """The port's text report (exit 0), held line for line against the
    JAX one's but for the recommendation's line and ``POINTERS``."""
    rc, out, _, jax_out = _run_main(capsys, report, jax_report, [logdir],
                                    [logdir, "--bench_dir", nobench])
    assert rc == 0
    for theirs, ours in POINTERS:
        jax_out = jax_out.replace(theirs, ours)
    prose = "top recommendation: "
    assert ([line for line in out.splitlines()
             if not line.startswith(prose)]
            == [line for line in jax_out.splitlines()
                if not line.startswith(prose)])
    return out


# -- tests/test_obs_failure.py::TestTraceMerging --------------------------


def _write_trace(path, process_index, unix_epoch_us, events):
    """Hand-rolled trace file in the tracer's unclosed-array format with a
    controlled clock epoch (``tests/test_obs_failure.py::_write_trace``)."""
    lines = ["["]
    lines.append(json.dumps({
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": f"proc{process_index}"}}) + ",")
    lines.append(json.dumps({
        "name": "trace_epoch", "ph": "i", "s": "g", "cat": "meta",
        "ts": 0, "pid": os.getpid(), "tid": 0,
        "args": {"unix_time_us": unix_epoch_us, "perf_time_us": 0,
                 "process_index": process_index}}) + ",")
    for event in events:
        lines.append(json.dumps(event) + ",")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _merge_both(paths, tmp_path):
    """merge_traces of both packages into two files: equal summaries but
    for the output path, byte-equal outputs; returns the port's."""
    out = str(tmp_path / "trace.merged.json")
    jax_out = str(tmp_path / "jax.merged.json")
    summary = aggregate.merge_traces(paths, out)
    jax_summary = jax_aggregate.merge_traces(paths, jax_out)
    assert summary.pop("out_path") == out
    assert jax_summary.pop("out_path") == jax_out
    assert summary == jax_summary
    with open(out) as f, open(jax_out) as g:
        assert f.read() == g.read()
    return summary, out


class TestTraceMerging:
    def test_merges_and_aligns_two_process_traces(self, tmp_path):
        """Twin of ``TestTraceMerging::
        test_merges_and_aligns_two_process_traces``."""
        a = str(tmp_path / "trace.p0.111.json")
        b = str(tmp_path / "trace.p1.222.json")
        _write_trace(a, 0, 5_000_000, [
            {"name": "learner/update", "ph": "X", "cat": "learner",
             "ts": 500, "dur": 100, "pid": os.getpid(), "tid": 1}])
        _write_trace(b, 1, 5_001_000, [
            {"name": "actor/unroll", "ph": "X", "cat": "actor",
             "ts": 500, "dur": 100, "pid": os.getpid(), "tid": 1}])
        summary, out = _merge_both([a, b], tmp_path)
        assert all(i["aligned"] for i in summary["inputs"])
        events = json.load(open(out))
        assert events == list(load_trace_events(out))
        spans = {e["name"]: e for e in events if e.get("ph") == "X"}
        assert spans["learner/update"]["pid"] != (
            spans["actor/unroll"]["pid"])
        assert (spans["actor/unroll"]["ts"]
                - spans["learner/update"]["ts"]) == 1000
        metas = [e for e in events if e.get("ph") == "M"]
        assert sum(e["name"] == "process_name" for e in metas) == 2
        assert sum(e["name"] == "process_sort_index" for e in metas) == 2

    def test_traces_from_different_runs_are_flagged(self, tmp_path):
        """Twin of ``TestTraceMerging::
        test_traces_from_different_runs_are_flagged``."""
        a = str(tmp_path / "trace.p0.111.json")
        b = str(tmp_path / "trace.p0.222.json")
        hour_us = 3600 * 1_000_000
        _write_trace(a, 0, 5_000_000_000, [])
        _write_trace(b, 0, 5_000_000_000 + hour_us, [])
        assert _merge_both([a, b], tmp_path)[0]["multi_run_suspect"]
        _write_trace(b, 1, 5_002_000_000, [])
        assert not _merge_both([a, b], tmp_path)[0]["multi_run_suspect"]

    def test_epochless_trace_merges_unaligned_and_is_flagged(
            self, tmp_path):
        """Twin of ``TestTraceMerging::
        test_epochless_trace_merges_unaligned_and_is_flagged``."""
        a = str(tmp_path / "trace.p0.1.json")
        with open(a, "w") as f:
            f.write("[\n" + json.dumps(
                {"name": "s", "ph": "X", "cat": "c", "ts": 10, "dur": 1,
                 "pid": 1, "tid": 1}) + ",\n")
        summary, out = _merge_both([a], tmp_path)
        assert summary["inputs"][0]["aligned"] is False
        assert json.load(open(out))

    def test_real_tracer_files_roundtrip_through_merge(self, tmp_path):
        """Twin of ``TestTraceMerging::
        test_real_tracer_files_roundtrip_through_merge``: one file of the
        port's tracer (one process) beside one of the JAX tracer's, whose
        ``trace_epoch`` records the port's merge aligns alike."""
        paths = [str(tmp_path / f"trace.p0.{os.getpid()}.json"),
                 str(tmp_path / f"trace.p1.{os.getpid()}.json")]
        tracer = Tracer(paths[0])
        with tracer.span("work0"):
            time.sleep(0.001)
        tracer.close()
        with JaxTracer(paths[1], process_index=1) as jax_tracer:
            with jax_tracer.span("work1"):
                time.sleep(0.001)
        summary, out = _merge_both(paths, tmp_path)
        assert all(i["aligned"] for i in summary["inputs"])
        names = {e["name"] for e in json.load(open(out))}
        assert {"work0", "work1"} <= names


# -- tests/test_obs_failure.py::TestPrometheusAggregation -----------------


def _fold_both(texts):
    """aggregate_prometheus of both packages: equal text; the port's."""
    text = aggregate.aggregate_prometheus(texts)
    assert text == jax_aggregate.aggregate_prometheus(texts)
    return text


class TestPrometheusAggregation:
    def _texts(self):
        a = (
            "# HELP impala_actor_fps frames/s\n"
            "# TYPE impala_actor_fps gauge\n"
            "impala_actor_fps 100.0\n"
            "# TYPE impala_actor_pool_queue_depth gauge\n"
            "impala_actor_pool_queue_depth 3.0\n"
            "# TYPE impala_batcher_occupancy gauge\n"
            "impala_batcher_occupancy 0.5\n"
            "# TYPE impala_frames_total counter\n"
            "impala_frames_total 1000.0\n"
            "# TYPE impala_lat_s summary\n"
            'impala_lat_s{quantile="0.5"} 0.1\n'
            "impala_lat_s_sum 5.0\n"
            "impala_lat_s_count 10\n"
        )
        b = a.replace("100.0", "50.0").replace(" 3.0", " 7.0") \
             .replace("0.5\n", "0.25\n").replace("1000.0", "500.0") \
             .replace("0.1\n", "0.3\n").replace("5.0\n", "2.0\n") \
             .replace(" 10\n", " 4\n")
        return {"0": a, "1": b}

    def test_process_labels_and_fleet_folds(self):
        """Twin of ``TestPrometheusAggregation::
        test_process_labels_and_fleet_folds``."""
        text = _fold_both(self._texts())
        assert 'impala_actor_fps{process="0"} 100.0' in text
        assert 'impala_actor_fps{process="1"} 50.0' in text
        assert 'impala_actor_fps{fold="sum"} 150.0' in text
        assert 'impala_actor_pool_queue_depth{fold="max"} 7.0' in text
        assert 'impala_batcher_occupancy{fold="min"} 0.25' in text
        assert 'impala_frames_total{fold="sum"} 1500.0' in text
        assert 'impala_lat_s_sum{fold="sum"} 7.0' in text
        assert 'impala_lat_s_count{fold="sum"} 14.0' in text
        assert ('impala_lat_s{fold="max",quantile="0.5"} 0.3' in text
                or 'impala_lat_s{quantile="0.5",fold="max"} 0.3' in text)

    def test_occupancy_summary_quantiles_fold_min(self):
        """Twin of ``TestPrometheusAggregation::
        test_occupancy_summary_quantiles_fold_min``."""
        a = ("# TYPE impala_native_batcher_occupancy summary\n"
             'impala_native_batcher_occupancy{quantile="0.5"} 0.9\n'
             "impala_native_batcher_occupancy_sum 9.0\n"
             "impala_native_batcher_occupancy_count 10\n")
        b = ("# TYPE impala_native_batcher_occupancy summary\n"
             'impala_native_batcher_occupancy{quantile="0.5"} 0.1\n'
             "impala_native_batcher_occupancy_sum 1.0\n"
             "impala_native_batcher_occupancy_count 10\n")
        text = _fold_both({"0": a, "1": b})
        assert ('impala_native_batcher_occupancy'
                '{fold="min",quantile="0.5"} 0.1' in text
                or 'impala_native_batcher_occupancy'
                '{quantile="0.5",fold="min"} 0.1' in text), text
        assert 'impala_native_batcher_occupancy_sum{fold="sum"} 10.0' \
            in text
        assert ('impala_native_batcher_occupancy_count{fold="sum"} 20.0'
                in text)

    def test_parser_tolerates_torn_tail(self):
        """Twin of ``TestPrometheusAggregation::
        test_parser_tolerates_torn_tail``."""
        text = "# TYPE impala_x counter\nimpala_x 3.0\nimpala_y 1"
        families = aggregate.parse_prometheus(text)
        assert families == jax_aggregate.parse_prometheus(text)
        assert families["impala_x"]["series"][("impala_x", ())] == 3.0


# -- tests/test_obs_failure.py::TestAggregateCLI --------------------------


class TestAggregateCLI:
    def test_end_to_end_logdir(self, tmp_path, capsys):
        """Twin of ``TestAggregateCLI::test_end_to_end_logdir``: the port's
        CLI first, then the JAX CLI over the same logdir into other
        files, byte-equal."""
        logdir = str(tmp_path)
        tracer = Tracer(os.path.join(logdir, "trace.p0.100.json"))
        with tracer.span("s"):
            pass
        tracer.close()
        with JaxTracer(os.path.join(logdir, "trace.p1.101.json"),
                       process_index=1) as jax_tracer:
            with jax_tracer.span("s"):
                pass
        for proc, name in ((0, "metrics.prom"), (1, "metrics.p1.prom")):
            registry = MetricsRegistry()
            registry.counter("frames_total").inc(10 * (proc + 1))
            PrometheusExporter(registry,
                               os.path.join(logdir, name)).dump()
        assert aggregate.main([logdir]) == 0
        merged = os.path.join(logdir, aggregate.MERGED_TRACE_NAME)
        fleet = os.path.join(logdir, aggregate.FLEET_PROM_NAME)
        assert json.load(open(merged))
        text = open(fleet).read()
        assert 'impala_frames_total{process="0"} 10.0' in text
        assert 'impala_frames_total{fold="sum"} 30.0' in text
        assert aggregate.main([logdir]) == 0
        traces, proms = aggregate.find_artifacts(logdir)
        assert (traces, proms) == jax_aggregate.find_artifacts(logdir)
        assert len(traces) == 2 and set(proms) == {"0", "1"}
        out = str(tmp_path / "jax")
        os.makedirs(out)
        assert jax_aggregate.main([
            logdir, "--out_trace", os.path.join(out, "t.json"),
            "--out_prom", os.path.join(out, "m.prom")]) == 0
        assert open(os.path.join(out, "m.prom")).read() == text
        assert (open(os.path.join(out, "t.json")).read()
                == open(merged).read())

    def test_empty_logdir_fails_cleanly(self, tmp_path, capsys):
        """Twin of ``TestAggregateCLI::test_empty_logdir_fails_cleanly``."""
        assert _run_main(capsys, aggregate, jax_aggregate,
                         [str(tmp_path)])[0] == 1


# -- tests/test_obs_failure.py::TestMetricsHTTPServer ---------------------


def _get(url):
    return urllib.request.urlopen(url, timeout=5).read().decode()


class TestMetricsHTTPServer:
    def test_serves_live_registry_text(self):
        """Twin of ``TestMetricsHTTPServer::
        test_serves_live_registry_text``, with the JAX server over a JAX
        registry driven alike serving the same text."""
        registry, jax_registry = MetricsRegistry(), JaxRegistry()
        counters = [r.counter("scrapes_ready") for r in (registry,
                                                         jax_registry)]
        for counter in counters:
            counter.inc(3)
        with MetricsHTTPServer(registry, port=0) as server, \
                jax_exporters.MetricsHTTPServer(jax_registry,
                                                port=0) as jax_server:
            assert server.port > 0
            url = f"http://127.0.0.1:{server.port}"
            jax_url = f"http://127.0.0.1:{jax_server.port}"
            body = _get(f"{url}/metrics")
            assert "impala_scrapes_ready 3.0" in body
            assert body == _get(f"{jax_url}/metrics")
            for counter in counters:
                counter.inc()
            body = _get(f"{url}/")
            assert "impala_scrapes_ready 4.0" in body
            assert body == _get(f"{jax_url}/")
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(f"{url}/nope")
            assert err.value.code == 404
        assert not server._thread.is_alive()


# -- tests/test_health.py ---------------------------------------------------


def _write_synthetic_logdir(logdir):
    """``tests/test_health.py::_write_synthetic_logdir``."""
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "metrics.prom"), "w") as f:
        f.write(
            "# TYPE impala_learner_fps gauge\n"
            "impala_learner_fps 1000.0\n"
            "# TYPE impala_actor_fps gauge\n"
            "impala_actor_fps 1200.0\n"
            "# TYPE impala_ledger_mfu gauge\n"
            "impala_ledger_mfu 0.12\n"
            "# TYPE impala_fleet_peers_alive gauge\n"
            "impala_fleet_peers_alive 2.0\n"
            "# TYPE impala_health_suppressed_total counter\n"
            "impala_health_suppressed_total 1.0\n"
            "# TYPE impala_health_profile_windows_total counter\n"
            "impala_health_profile_windows_total 1.0\n"
            "# TYPE impala_ledger_latency_share_device gauge\n"
            "impala_ledger_latency_share_device 0.6\n"
            "# TYPE impala_ledger_latency_share_unroll gauge\n"
            "impala_ledger_latency_share_unroll 0.2\n"
            "# TYPE impala_ledger_staleness_s summary\n"
            'impala_ledger_staleness_s{quantile="0.95"} 0.5\n')
    with open(os.path.join(logdir, ANOMALIES_JSONL), "w") as f:
        f.write(json.dumps({
            "id": "a001-throughput", "detector": "throughput",
            "metric": "learner/fps", "observed": 250.0,
            "baseline": 1000.0, "z": 6.1,
            "window": {"status": "done",
                       "worst_kernel": "loss_grad_fusion",
                       "worst_kernel_mfu": 0.11,
                       "worst_kernel_mfu_delta": -0.2}}) + "\n")
        f.write(json.dumps({
            "id": "a002-staleness", "detector": "staleness",
            "metric": "ledger/staleness_s/p95", "observed": 4.0,
            "baseline": 0.5, "z": 5.0,
            "window": {"status": "armed"}}) + "\n")


class TestFleetFold:
    @pytest.mark.parametrize("metric,kind,fold", [
        ("impala_health_fired_throughput", "gauge", "max"),
        ("impala_health_open_anomalies", "gauge", "max"),
        ("impala_health_anomalies_total", "counter", "sum")])
    def test_health_series_fold_rules(self, metric, kind, fold):
        """Twin of ``tests/test_health.py::TestFleetFold::
        test_health_series_fold_rules``."""
        got = aggregate._fleet_fold(metric, metric, kind, ())
        assert got == jax_aggregate._fleet_fold(metric, metric, kind, ())
        assert got == fold


class TestWatchConsole:
    def test_build_payload_on_synthetic_logdir(self, tmp_path, nobench):
        """Twin of ``TestWatchConsole::
        test_build_payload_on_synthetic_logdir``."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        payload, want = _payloads(logdir, nobench)
        assert payload["fps"]["learner"] == 1000.0
        assert payload["verdict"]["dominant_segment"] == "device"
        assert payload["staleness_p95_s"] == 0.5
        assert payload["health"]["anomalies"] == 2
        assert payload["health"]["open"] == 1
        assert payload["health"]["profile_windows"] == 1.0
        text = watch.render(payload)
        assert text == jax_watch.render(dict(
            want, generated_unix=payload["generated_unix"]))
        assert "a001-throughput" in text
        assert "loss_grad_fusion" in text
        assert "anomalies  2 total (1 open" in text

    def test_missing_logdir_exits_2_in_process(self, tmp_path, capsys):
        """Twin of ``TestWatchConsole::
        test_missing_logdir_exits_2_in_process``."""
        rc, _, err, _ = _run_main(capsys, watch, jax_watch,
                                  [str(tmp_path / "nope"), "--once"])
        assert rc == 2 and "obs.watch:" in err

    def test_metrics_free_logdir_exits_2_in_process(self, tmp_path,
                                                    capsys):
        """Twin of ``TestWatchConsole::
        test_metrics_free_logdir_exits_2_in_process``."""
        empty = tmp_path / "empty"
        empty.mkdir()
        rc, _, err, _ = _run_main(capsys, watch, jax_watch,
                                  [str(empty), "--once"])
        assert rc == 2
        assert "obs.watch:" in err and "metrics" in err

    def test_once_json_emits_payload(self, tmp_path, capsys, nobench):
        """Twin of ``TestWatchConsole::test_once_json_emits_payload``."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        rc, out, _, jax_out = _run_main(
            capsys, watch, jax_watch, [logdir, "--once", "--json"],
            [logdir, "--once", "--json", "--bench_dir", nobench])
        assert rc == 0
        payload = json.loads(out)
        _same(payload, json.loads(jax_out))
        assert payload["health"]["anomalies"] == 2


def _cli(package, name, *args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.obs.{name}", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))


class TestCLIExitCodes:
    """Twins of ``tests/test_health.py::TestCLIExitCodes``: each CLI of
    both packages as a subprocess, the way an operator runs it."""

    @pytest.mark.parametrize("name", ["watch", "report", "diagnose"])
    def test_subprocess_exit_2(self, tmp_path, name):
        """``test_watch_subprocess_exit_2`` and
        ``test_report_subprocess_exit_2`` (and diagnose, which shares the
        convention): a missing logdir for watch, a metrics-free one for
        the others."""
        if name == "watch":
            logdir = str(tmp_path / "missing")
        else:
            logdir = str(tmp_path / "empty")
            os.makedirs(logdir)
        args = [logdir, "--once"] if name == "watch" else [logdir]
        for package in ("scalable_agent_tpu_torch", "scalable_agent_tpu"):
            proc = _cli(package, name, *args)
            assert proc.returncode == 2, (package, proc.stderr)
            assert proc.stderr.strip().startswith(f"obs.{name}:")
            assert len(proc.stderr.strip().splitlines()) == 1

    def test_watch_subprocess_json_payload(self, tmp_path, nobench):
        """Twin of ``TestCLIExitCodes::test_watch_subprocess_json_payload``
        (run from another directory: the CLI needs only the package)."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        proc = _cli("scalable_agent_tpu_torch", "watch", logdir, "--once",
                    "--json", cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr
        payload = json.loads(proc.stdout)
        assert payload["logdir"] == logdir
        assert payload["health"]["anomalies"] == 2
        jax_proc = _cli("scalable_agent_tpu", "watch", logdir, "--once",
                        "--json", "--bench_dir", nobench)
        _same(payload, json.loads(jax_proc.stdout))


class TestReportAndRoundsSections:
    def test_report_carries_anomalies_section(self, tmp_path, capsys,
                                              nobench):
        """Twin of ``TestReportAndRoundsSections::
        test_report_carries_anomalies_section``."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        payload, _ = _reports(logdir, nobench)
        ids = [a["id"] for a in payload["anomalies"]]
        assert ids == ["a001-throughput", "a002-staleness"]
        out = _text_report(capsys, logdir, nobench)
        assert "anomalies (2 recorded" in out
        assert "a001-throughput" in out

    def test_report_without_anomalies_is_none(self, tmp_path, nobench):
        """Twin of ``TestReportAndRoundsSections::
        test_report_without_anomalies_is_none``."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        os.remove(os.path.join(logdir, ANOMALIES_JSONL))
        assert _reports(logdir, nobench)[0]["anomalies"] is None


def test_bench_dir_raises_and_the_clis_exit_2(tmp_path, capsys):
    """In place of ``tests/test_health.py::TestWatchConsole::
    test_vs_baseline_uses_committed_rounds``, ``TestReportAndRoundsSections
    ::test_rounds_trajectory_carries_anomalies`` and
    ``tests/test_kernel_ledger.py::TestReportKernels::
    test_report_names_conv0_gradw_from_bench_artifact``: the committed
    rounds are TPU readings, so no ``bench_dir`` is read; a directory
    raises and both CLIs exit 2 pointing at ROADMAP.md."""
    logdir = str(tmp_path / "run")
    _write_synthetic_logdir(logdir)
    assert report.build_report(logdir)["bench_kernels"] is None
    payload = watch.build_payload(logdir)
    assert payload["baseline"] is None
    assert payload["fps"]["vs_baseline"] is None
    with pytest.raises(ValueError, match="ROADMAP.md"):
        report.build_report(logdir, bench_dir=ROOT)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        watch.build_payload(logdir, bench_dir=ROOT)
    for module, argv in ((report, [logdir, "--bench_dir", ROOT]),
                         (report, ["--json", logdir, "--bench_dir", ROOT]),
                         (watch, [logdir, "--once", "--bench_dir", ROOT])):
        assert module.main(argv) == 2
        out, err = capsys.readouterr()
        assert not out
        assert "ROADMAP.md" in err and len(err.strip().splitlines()) == 1


class TestHTTPRoutes:
    def test_anomalies_and_health_routes(self, tmp_path, nobench):
        """Twin of ``TestHTTPRoutes::test_anomalies_and_health_routes``:
        ``/health`` is the port's ``build_payload`` and the JAX one's."""
        logdir = str(tmp_path / "run")
        _write_synthetic_logdir(logdir)
        registry = MetricsRegistry()
        registry.counter("scrapes").inc()
        with MetricsHTTPServer(registry, port=0,
                               logdir=logdir) as server:
            base = f"http://127.0.0.1:{server.port}"
            body = _get(f"{base}/anomalies")
            lines = [json.loads(line)
                     for line in body.splitlines() if line.strip()]
            assert [r["id"] for r in lines] \
                == ["a001-throughput", "a002-staleness"]
            health = json.loads(_get(f"{base}/health"))
            assert health["health"]["anomalies"] == 2
            _same(health, jax_watch.build_payload(logdir,
                                                  bench_dir=nobench))
            assert "impala_scrapes" in _get(f"{base}/metrics")

    def test_health_route_503_before_first_snapshot(self, tmp_path):
        """Twin of ``TestHTTPRoutes::
        test_health_route_503_before_first_snapshot``."""
        logdir = str(tmp_path / "empty")
        os.makedirs(logdir)
        with MetricsHTTPServer(MetricsRegistry(), port=0,
                               logdir=logdir) as server:
            base = f"http://127.0.0.1:{server.port}"
            assert urllib.request.urlopen(
                f"{base}/anomalies", timeout=5).read() == b""
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}/health", timeout=5)
            assert err.value.code == 503

    def test_routes_absent_without_logdir(self):
        """Twin of ``TestHTTPRoutes::test_routes_absent_without_logdir``."""
        with MetricsHTTPServer(MetricsRegistry(), port=0) as server:
            for route in ("anomalies", "health"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/{route}",
                        timeout=5)
                assert err.value.code == 404


# -- tests/test_ledger.py ---------------------------------------------------


class TestAggregatorFolds:
    def _proms(self):
        def render(rate, rho, stale_p99, frames):
            return "\n".join([
                "# TYPE impala_ledger_rate_transport_per_s gauge",
                f"impala_ledger_rate_transport_per_s {rate}",
                "# TYPE impala_ledger_rho_transport gauge",
                f"impala_ledger_rho_transport {rho}",
                "# TYPE impala_ledger_latency_share_transport gauge",
                f"impala_ledger_latency_share_transport {rho}",
                "# TYPE impala_ledger_staleness_s summary",
                f'impala_ledger_staleness_s{{quantile="0.99"}} '
                f"{stale_p99}",
                "# TYPE impala_ledger_frames_discarded_total counter",
                f"impala_ledger_frames_discarded_total {frames}",
                "# TYPE impala_ledger_mfu gauge",
                f"impala_ledger_mfu {rho}",
            ]) + "\n"

        return {"0": render(2.0, 0.25, 1.5, 100.0),
                "1": render(3.0, 0.75, 4.5, 50.0)}

    def test_ledger_fold_rules(self):
        """Twin of ``tests/test_ledger.py::TestAggregatorFolds::
        test_ledger_fold_rules``."""
        folded = aggregate.parse_prometheus(_fold_both(self._proms()))

        def fleet(family, metric=None, quantile=None):
            metric = metric or family
            for (name, labels), value in folded[family]["series"].items():
                ldict = dict(labels)
                if name == metric and "fold" in ldict and (
                        quantile is None
                        or ldict.get("quantile") == quantile):
                    return ldict["fold"], value
            raise KeyError((family, metric))

        assert fleet("impala_ledger_rate_transport_per_s") == ("sum", 5.0)
        assert fleet("impala_ledger_rho_transport") == ("max", 0.75)
        assert fleet("impala_ledger_latency_share_transport") == (
            "max", 0.75)
        assert fleet("impala_ledger_mfu") == ("max", 0.75)
        assert fleet("impala_ledger_staleness_s",
                     quantile="0.99") == ("max", 4.5)
        assert fleet("impala_ledger_frames_discarded_total") == (
            "sum", 150.0)


class TestReportCli:
    """Twins of ``tests/test_ledger.py::TestReportCli``: the JAX report's
    text and the port's agree line for line but for the recommendation."""

    def _write_prom(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        lines = []
        rows = {
            "unroll": (4.0, 0.4, 0.1),
            "backpressure": (4.0, 0.1, 0.02),
            "queue_wait": (4.0, 8.0, 0.70),
            "transport": (4.0, 0.2, 0.05),
            "staged_wait": (4.0, 0.3, 0.08),
            "device": (4.0, 0.2, 0.05),
        }
        for name, (rate, rho, share) in rows.items():
            lines += [
                f"# TYPE impala_ledger_rate_{name}_per_s gauge",
                f"impala_ledger_rate_{name}_per_s {rate}",
                f"# TYPE impala_ledger_rho_{name} gauge",
                f"impala_ledger_rho_{name} {rho}",
                f"# TYPE impala_ledger_latency_share_{name} gauge",
                f"impala_ledger_latency_share_{name} {share}",
                f"# TYPE impala_ledger_stage_{name}_s summary",
                f'impala_ledger_stage_{name}_s{{quantile="0.95"}} '
                f"{rho / rate}",
                f"impala_ledger_stage_{name}_s_sum {rho * 10.0}",
                f"impala_ledger_stage_{name}_s_count {rate * 10.0}",
            ]
        lines += [
            "# TYPE impala_ledger_staleness_s summary",
            'impala_ledger_staleness_s{quantile="0.5"} 0.8',
            'impala_ledger_staleness_s{quantile="0.95"} 1.2',
            'impala_ledger_staleness_s{quantile="0.99"} 1.4',
            "# TYPE impala_ledger_mfu gauge",
            "impala_ledger_mfu 0.15",
            "# TYPE impala_stall_is_learner_starved gauge",
            "impala_stall_is_learner_starved 1.0",
            "# TYPE impala_ledger_trajectories_opened_total counter",
            "impala_ledger_trajectories_opened_total 40.0",
            "# TYPE impala_ledger_trajectories_retired_total counter",
            "impala_ledger_trajectories_retired_total 40.0",
            "# TYPE impala_ledger_frames_discarded_total counter",
            "impala_ledger_frames_discarded_total 0.0",
            "# TYPE impala_ledger_open_records gauge",
            "impala_ledger_open_records 0.0",
        ]
        with open(os.path.join(logdir, "metrics.prom"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _append_replay_series(self, logdir, replayed_p95):
        with open(os.path.join(logdir, "metrics.prom"), "a") as f:
            f.write("\n".join([
                "# TYPE impala_ledger_staleness_replayed_s summary",
                'impala_ledger_staleness_replayed_s{quantile="0.5"} '
                f"{replayed_p95 * 0.8}",
                'impala_ledger_staleness_replayed_s{quantile="0.95"} '
                f"{replayed_p95}",
                'impala_ledger_staleness_replayed_s{quantile="0.99"} '
                f"{replayed_p95 * 1.1}",
                "# TYPE impala_replay_occupancy gauge",
                "impala_replay_occupancy 0.5",
                "# TYPE impala_replay_insert_total counter",
                "impala_replay_insert_total 40.0",
                "# TYPE impala_replay_sampled_total counter",
                "impala_replay_sampled_total 80.0",
                "# TYPE impala_replay_target_update_interval gauge",
                "impala_replay_target_update_interval 100.0",
            ]) + "\n")

    def _text(self, capsys, logdir, nobench):
        _reports(logdir, nobench)
        return _text_report(capsys, logdir, nobench)

    def test_report_names_dominant_stage(self, tmp_path, capsys, nobench):
        """Twin of ``test_report_names_dominant_stage``."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        out = self._text(capsys, logdir, nobench)
        assert "queue_wait" in out
        assert "dominant stage: queue_wait (70% of frame latency" in out
        assert "top recommendation:" in out
        assert "staleness" in out and "p99 1.400s" in out
        assert "mfu: 0.15" in out
        assert "stall verdict: learner_starved" in out

    def test_report_errors_without_artifacts(self, tmp_path, capsys):
        """Twin of ``test_report_errors_without_artifacts``."""
        rc, _, err, _ = _run_main(capsys, report, jax_report,
                                  [str(tmp_path)])
        assert rc == 2 and "no metrics" in err

    def test_report_renders_staleness_split_and_replay(self, tmp_path,
                                                      capsys, nobench):
        """Twin of ``test_report_renders_staleness_split_and_replay``
        (the port publishes no replay series; the report reads them
        alike when a logdir has them)."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        self._append_replay_series(logdir, replayed_p95=5.0)
        out = self._text(capsys, logdir, nobench)
        assert "staleness (FRESH frame age" in out
        assert "staleness (REPLAYED frame age" in out
        assert "p95 5.000s" in out
        assert "replay slab: occupancy 0.50, 40 inserted, 80 sampled" \
            in out
        assert "replay recommendation:" not in out

    def test_report_recommends_when_replayed_staleness_exceeds_clip(
            self, tmp_path, capsys, nobench):
        """Twin of ``test_report_recommends_when_replayed_staleness_
        exceeds_clip``."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        self._append_replay_series(logdir, replayed_p95=60.0)
        out = self._text(capsys, logdir, nobench)
        assert "replay recommendation:" in out
        assert "exceeds the IMPACT clip's useful range" in out
        assert "--replay_ratio" in out

    def test_report_without_replay_is_unchanged(self, tmp_path, capsys,
                                                nobench):
        """Twin of ``test_report_without_replay_is_unchanged``."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        out = self._text(capsys, logdir, nobench)
        assert "REPLAYED" not in out
        assert "replay slab:" not in out

    def test_impact_without_replay_draws_no_slab_section(
            self, tmp_path, capsys, nobench):
        """Twin of ``test_impact_without_replay_draws_no_slab_section``."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        with open(os.path.join(logdir, "metrics.prom"), "a") as f:
            f.write(
                "# TYPE impala_replay_target_update_interval gauge\n"
                "impala_replay_target_update_interval 100.0\n")
        out = self._text(capsys, logdir, nobench)
        assert "replay slab:" not in out
        assert "replay recommendation:" not in out

    @pytest.mark.parametrize("stage", ["unroll", "backpressure",
                                       "queue_wait", "transport",
                                       "staged_wait", "device"])
    def test_recommendation_names_what_the_port_runs(self, tmp_path,
                                                     nobench, stage):
        """The one deliberate difference in the text: the dominant stage
        (the key) is the JAX report's, its prose names the port's flags
        and never a JAX module or flag the port does not run, save with
        ROADMAP.md's queue item."""
        logdir = str(tmp_path / "run")
        self._write_prom(logdir)
        with open(os.path.join(logdir, "metrics.prom"), "a") as f:
            f.write(f"# TYPE impala_ledger_latency_share_{stage} gauge\n"
                    f"impala_ledger_latency_share_{stage} 0.99\n")
        got, want = _reports(logdir, nobench)
        assert got["dominant_stage"] == want["dominant_stage"]
        assert got["dominant_stage"]["name"] == stage
        text = got["recommendation"]
        assert text == report.RECOMMENDATIONS[stage]
        for jax_only in ("core_impl", "mesh", "service_max_batch"):
            assert jax_only not in text
        if "linktune" in text or "not ported" in text:
            assert "ROADMAP.md, queue" in text


# -- tests/test_kernel_ledger.py::TestReportKernels -----------------------


class TestReportKernels:
    def _write_minimal_prom(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "metrics.prom"), "w") as f:
            f.write("# TYPE impala_ledger_mfu gauge\n"
                    "impala_ledger_mfu 0.1\n")

    def test_report_json_names_dominant_kernel(self, tmp_path, capsys,
                                               nobench):
        """Twin of ``TestReportKernels::
        test_report_json_names_dominant_kernel``, on a table the port's
        ``write_kernels_json`` wrote."""
        logdir = str(tmp_path / "run")
        self._write_minimal_prom(logdir)
        write_kernels_json(logdir, {
            "schema_version": 1,
            "flops_total": 1e9,
            "matched_time_frac": 0.9,
            "kernels": [
                {"name": "loss_grad_fusion", "time_us": 900.0,
                 "time_share": 0.9, "calls": 5, "flops": 9e8,
                 "intensity": 12.0, "mfu": 0.11},
                {"name": "optimizer_fusion", "time_us": 100.0,
                 "time_share": 0.1, "calls": 5, "flops": 1e8,
                 "intensity": 3.0, "mfu": 0.55},
            ],
            "worst_kernel": "loss_grad_fusion",
            "worst_kernel_mfu": 0.11,
            "dominant_kernel": "loss_grad_fusion",
            "dominant_time_share": 0.9,
        })
        rc, out, _, jax_out = _run_main(
            capsys, report, jax_report, ["--json", logdir],
            ["--json", logdir, "--bench_dir", nobench])
        assert rc == 0
        payload = json.loads(out)
        _same(payload, json.loads(jax_out))
        assert payload["kernels"]["dominant"] == "loss_grad_fusion"
        assert payload["kernels"]["worst"] == "loss_grad_fusion"
        assert payload["kernels"]["rows"][0]["mfu"] == 0.11
        out = _text_report(capsys, logdir, nobench)
        assert "worst kernels (this run's profile window)" in out
        assert "loss_grad_fusion" in out
        assert "worst kernel: loss_grad_fusion" in out

    def test_bench_kernels_absent_outside_a_checkout(self, tmp_path,
                                                     nobench):
        """Twin of ``TestReportKernels::
        test_bench_kernels_absent_outside_a_checkout``: no round, no
        section, in both."""
        logdir = str(tmp_path / "run")
        self._write_minimal_prom(logdir)
        assert _reports(logdir, nobench)[0]["bench_kernels"] is None


# -- tests/test_learning_dynamics.py ----------------------------------------


def _fold_value(texts, metric):
    families = aggregate.parse_prometheus(_fold_both(texts))
    for data in families.values():
        for (name, labels), value in data["series"].items():
            if name == metric and dict(labels).get("fold"):
                return value, dict(labels)["fold"]
    raise AssertionError(f"no fleet series for {metric}")


class TestLearnFleetFolds:
    def _fold(self, metric, values, mtype="gauge"):
        return _fold_value({str(i): f"# TYPE {metric} {mtype}\n"
                                    f"{metric} {v}\n"
                            for i, v in enumerate(values)}, metric)

    @pytest.mark.parametrize("metric", [
        "impala_devtel_learn_entropy_frac", "impala_devtel_learn_ess_frac",
        "impala_devtel_learn_explained_variance"])
    def test_low_is_bad_gauges_fold_min(self, metric):
        """Twin of ``TestLearnFleetFolds::
        test_low_is_bad_gauges_fold_min``."""
        assert self._fold(metric, [0.9, 0.2]) == (0.2, "min")

    @pytest.mark.parametrize("metric", [
        "impala_devtel_learn_rho_clip_fraction", "impala_devtel_learn_kl",
        "impala_devtel_learn_dead_torso_frac",
        "impala_devtel_learn_update_ratio_core"])
    def test_high_is_bad_gauges_fold_max(self, metric):
        """Twin of ``TestLearnFleetFolds::
        test_high_is_bad_gauges_fold_max``."""
        assert self._fold(metric, [0.1, 0.7]) == (0.7, "max")

    def test_impact_bucket_counters_sum(self):
        """Twin of ``TestLearnFleetFolds::
        test_impact_bucket_counters_sum``."""
        metric = "impala_devtel_learn_impact_ratio_bucket_le_1_total"
        assert self._fold(metric, [3.0, 5.0], mtype="counter") == (
            8.0, "sum")


HEALTHY = {
    "entropy_frac": 0.7, "kl": 0.01, "ess_frac": 0.9,
    "explained_variance": 0.5, "rho_clip_fraction": 0.1,
    "dead_torso_frac": 0.05, "update_ratio_torso": 1e-3,
    "update_ratio_core": 1e-3, "update_ratio_heads": 1e-3,
}


def _write_snapshot(logdir, overrides=(), extra=None):
    """``tests/test_learning_dynamics.py::_write_snapshot``, through the
    port's registry and exporter."""
    os.makedirs(logdir, exist_ok=True)
    readings = {**HEALTHY,
                "cs_clip_fraction": 0.1, "pg_rho_clip_fraction": 0.1,
                "log_rho_mean": 0.02, "log_rho_p95": 0.3,
                "grad_norm_torso": 1.0, "grad_norm_core": 1.0,
                "grad_norm_heads": 1.0, "param_norm_torso": 20.0,
                "param_norm_core": 40.0, "param_norm_heads": 3.0,
                **dict(overrides)}
    registry = MetricsRegistry()
    for short, value in readings.items():
        registry.gauge(learning.LEARNING_GAUGES[short], "test").set(value)
    for name, value in (extra or {}).items():
        registry.gauge(name, "test").set(value)
    with open(os.path.join(logdir, "metrics.prom"), "w") as f:
        f.write(render_prometheus(registry))
    return readings


class TestDiagnoseCLI:
    def test_clean_run_exits_zero(self, tmp_path, capsys):
        """Twin of ``TestDiagnoseCLI::test_clean_run_exits_zero``."""
        _write_snapshot(tmp_path)
        rc, out, _, jax_out = _run_main(capsys, diagnose, jax_diagnose,
                                        [str(tmp_path)])
        assert rc == 0 and out == jax_out
        assert "verdict: clean" in out
        assert "entropy (normalized)" in out
        assert "layer group" in out and "update/param" in out

    def test_collapsed_run_exits_one_and_names_the_anomaly(
            self, tmp_path, capsys):
        """Twin of ``TestDiagnoseCLI::
        test_collapsed_run_exits_one_and_names_the_anomaly``."""
        _write_snapshot(tmp_path, overrides={"entropy_frac": 0.004})
        record = {"id": "a001-entropy_collapse",
                  "detector": "entropy_collapse", "update": 12,
                  "observed": 0.004,
                  "flightrec": {"dump": "health:a001-entropy_collapse"},
                  "window": {"status": "closed"}}
        (tmp_path / "anomalies.jsonl").write_text(
            json.dumps(record) + "\n")
        rc, out, _, jax_out = _run_main(capsys, diagnose, jax_diagnose,
                                        [str(tmp_path)])
        assert rc == 1 and out == jax_out
        assert "entropy_collapse" in out
        assert "a001-entropy_collapse" in out
        assert "flightrec dump: health:a001-entropy_collapse" in out
        assert "raise --entropy_cost" in out

    def test_missing_logdir_exits_two(self, tmp_path, capsys):
        """Twin of ``TestDiagnoseCLI::test_missing_logdir_exits_two``."""
        rc, _, err, _ = _run_main(capsys, diagnose, jax_diagnose,
                                  [str(tmp_path / "nope")])
        assert rc == 2 and "obs.diagnose" in err

    def test_json_payload_round_trips(self, tmp_path, capsys):
        """Twin of ``TestDiagnoseCLI::test_json_payload_round_trips``."""
        _write_snapshot(tmp_path, overrides={"ess_frac": 0.02})
        rc, out, _, jax_out = _run_main(capsys, diagnose, jax_diagnose,
                                        [str(tmp_path), "--json"])
        assert rc == 1
        payload = json.loads(out)
        assert payload == json.loads(jax_out)
        assert payload["clean"] is False
        assert [v["name"] for v in payload["verdicts"]] == [
            "off_policy_saturated"]

    def test_impact_anchor_line_renders(self, tmp_path):
        """Twin of ``TestDiagnoseCLI::test_impact_anchor_line_renders``."""
        _write_snapshot(tmp_path, extra={
            "devtel/learn/impact_ratio/mean": 1.01,
            "devtel/learn/impact_ratio/count": 64.0,
            "devtel/learn/impact_clip_fraction/mean": 0.12,
            "devtel/learn/impact_log_ratio_p95": 0.2,
            "devtel/learn/impact_ess_frac": 0.95})
        diagnosis, want = _diagnoses(str(tmp_path))
        assert diagnosis["impact"]["updates_observed"] == 64.0
        text = diagnose.render_diagnosis(diagnosis)
        assert text == jax_diagnose.render_diagnosis(want)
        assert "IMPACT anchor: ratio mean 1.0100" in text
        assert "over 64 updates" in text

    def test_staleness_clip_statement_from_interval_rows(self, tmp_path):
        """Twin of ``TestDiagnoseCLI::
        test_staleness_clip_statement_from_interval_rows``."""
        _write_snapshot(tmp_path)
        rows = [
            {"step": i,
             "obs/ledger/staleness_replayed_s/p95": 0.1 * i,
             "obs/devtel/learn/rho_clip_fraction": 0.05 + 0.08 * i}
            for i in range(1, 6)]
        (tmp_path / "metrics.jsonl").write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n")
        diagnosis, _ = _diagnoses(str(tmp_path))
        relation = diagnosis["staleness_clip"]
        assert relation["intervals"] == 5
        assert relation["pearson_r"] == pytest.approx(1.0, abs=1e-6)
        assert "staleness→clipping:" in diagnose.render_diagnosis(
            diagnosis)

    def test_sentinel_trip_is_a_verdict(self, tmp_path, capsys):
        """The sentinel's verdict of ``build_diagnosis`` (no JAX test of
        its own): a logdir with the sentinel's series is diagnosed alike,
        but for the remedy's prose, which names the port's module where
        the JAX one names its docs."""
        _write_snapshot(tmp_path, extra={"sentinel/trips_total": 2.0,
                                         "sentinel/rung": 1.0})
        diagnosis = diagnose.build_diagnosis(str(tmp_path))
        want = jax_diagnose.build_diagnosis(str(tmp_path))
        remedy = diagnosis["verdicts"][-1].pop("remedy")
        want["verdicts"][-1].pop("remedy")
        assert diagnosis == want
        assert diagnosis["verdicts"][-1]["name"] == "sentinel_tripped"
        assert "runtime/sentinel.py" in remedy
        assert diagnose.main([str(tmp_path)]) == 1


class TestReportAndWatchSections:
    def test_report_carries_learning_section(self, tmp_path, nobench):
        """Twin of ``TestReportAndWatchSections::
        test_report_carries_learning_section``."""
        _write_snapshot(tmp_path, overrides={"entropy_frac": 0.004})
        got, _ = _reports(str(tmp_path), nobench)
        section = got["learning"]
        assert section["snapshot"]["entropy_frac"] == pytest.approx(0.004)
        assert [v["name"] for v in section["verdicts"]] == [
            "entropy_collapse"]
        text = report.render_report(str(tmp_path))
        assert "learning dynamics" in text
        assert "entropy_collapse" in text
        assert "scalable_agent_tpu_torch.obs.diagnose" in text

    def test_watch_payload_carries_learning_panel(self, tmp_path, nobench):
        """Twin of ``TestReportAndWatchSections::
        test_watch_payload_carries_learning_panel``."""
        _write_snapshot(tmp_path, overrides={"rho_clip_fraction": 0.97})
        payload, want = _payloads(str(tmp_path), nobench)
        panel = payload["learning"]
        assert panel["snapshot"]["rho_clip_fraction"] == pytest.approx(
            0.97)
        assert [v["name"] for v in panel["verdicts"]] == [
            "off_policy_saturated"]
        text = watch.render(payload)
        assert text == jax_watch.render(dict(
            want, generated_unix=payload["generated_unix"]))
        assert "!! off_policy_saturated" in text

    def test_runs_without_the_plane_render_none(self, tmp_path, nobench):
        """Twin of ``TestReportAndWatchSections::
        test_runs_without_the_plane_render_none``."""
        registry = MetricsRegistry()
        registry.gauge("learner/fps", "t").set(100.0)
        (tmp_path / "metrics.prom").write_text(render_prometheus(registry))
        assert _reports(str(tmp_path), nobench)[0]["learning"] is None
        assert _payloads(str(tmp_path), nobench)[0]["learning"] is None


# -- tests/test_device_telemetry.py::TestFleetFolds -----------------------


class TestDevtelFleetFolds:
    def test_devtel_counter_sums_gauge_maxes(self):
        """Twin of ``tests/test_device_telemetry.py::TestFleetFolds::
        test_devtel_counter_sums_gauge_maxes``."""
        p0 = ("# TYPE impala_devtel_env_episodes_total counter\n"
              "impala_devtel_env_episodes_total 10.0\n"
              "# TYPE impala_devtel_env_episode_return_mean gauge\n"
              "impala_devtel_env_episode_return_mean 2.0\n")
        p1 = ("# TYPE impala_devtel_env_episodes_total counter\n"
              "impala_devtel_env_episodes_total 32.0\n"
              "# TYPE impala_devtel_env_episode_return_mean gauge\n"
              "impala_devtel_env_episode_return_mean 3.5\n")
        texts = {"0": p0, "1": p1}
        assert _fold_value(texts, "impala_devtel_env_episodes_total") == (
            42.0, "sum")
        assert _fold_value(
            texts, "impala_devtel_env_episode_return_mean") == (3.5, "max")

    def test_kernel_series_take_max(self):
        """Twin of ``tests/test_device_telemetry.py::TestFleetFolds::
        test_kernel_series_take_max``."""
        p0 = ("# TYPE impala_kernel_conv0_gradw_mfu gauge\n"
              "impala_kernel_conv0_gradw_mfu 0.107\n"
              "# TYPE impala_kernel_worst_mfu gauge\n"
              "impala_kernel_worst_mfu 0.107\n"
              "# TYPE impala_kernel_dominant_time_share gauge\n"
              "impala_kernel_dominant_time_share 0.4\n")
        p1 = ("# TYPE impala_kernel_conv0_gradw_mfu gauge\n"
              "impala_kernel_conv0_gradw_mfu 0.09\n"
              "# TYPE impala_kernel_worst_mfu gauge\n"
              "impala_kernel_worst_mfu 0.09\n"
              "# TYPE impala_kernel_dominant_time_share gauge\n"
              "impala_kernel_dominant_time_share 0.6\n")
        for metric, want in (
                ("impala_kernel_conv0_gradw_mfu", 0.107),
                ("impala_kernel_worst_mfu", 0.107),
                ("impala_kernel_dominant_time_share", 0.6)):
            value, fold = _fold_value({"0": p0, "1": p1}, metric)
            assert fold == "max"
            assert value == pytest.approx(want)


# -- the port's driver: its own logdir, and the live endpoint ------------


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _driver_config(logdir, **overrides):
    base = dict(
        device="cpu", mode="train", logdir=logdir,
        level_name="fake_small", num_actors=2, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=48,  # 6 updates of 8 frames
        height=16, width=16, num_env_workers_per_group=1,
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, seed=5, scan_impl="pallas", trace=True,
        profile_dir=os.path.join(logdir, "profile"),
        profile_start_update=1, profile_num_updates=2)
    base.update(overrides)
    return Config(**base)


@pytest.fixture
def registry(monkeypatch):
    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    return registry


class _Scraper(threading.Thread):
    """Scrapes the three routes every 20 ms until stopped; keeps each
    answer's status and body."""

    def __init__(self, port):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.answers = {"/metrics": [], "/health": [], "/anomalies": []}
        self.halt = threading.Event()

    def run(self):
        while not self.halt.is_set():
            for route, answers in self.answers.items():
                try:
                    with urllib.request.urlopen(self.base + route,
                                                timeout=5) as reply:
                        answers.append((reply.status, reply.read()))
                except urllib.error.HTTPError as exc:
                    answers.append((exc.code, b""))
                except OSError:
                    pass  # not listening yet, or closed at teardown
            self.halt.wait(0.02)


def test_driver_logdir_reads_alike_and_is_served_live(tmp_path, registry,
                                                      capsys, nobench,
                                                      monkeypatch):
    """A CPU run of the port's driver with a profile window, the tracer
    and ``--metrics_http_port``: the endpoint answers all three routes
    while the run lasts and is closed (its thread gone, its port free)
    when ``train`` returns; both packages' report, watch and diagnose
    read its logdir alike, and ``aggregate``'s one-process fold equals
    the process's own series."""
    monkeypatch.setenv("SCALABLE_AGENT_LEDGER_MFU_PEAK", "1e12")
    logdir = str(tmp_path / "run")
    port = _free_port()
    config = _driver_config(logdir, metrics_http_port=port)
    scraper = _Scraper(port)
    scraper.start()
    try:
        metrics = driver.train(config)
    finally:
        scraper.halt.set()
        scraper.join(timeout=30)
    assert not scraper.is_alive()
    assert metrics["env_frames"] == 48
    assert not [t for t in threading.enumerate()
                if t.name == "metrics-http"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=5)

    scrapes = scraper.answers
    assert scrapes["/metrics"] and all(
        status == 200 for status, _ in scrapes["/metrics"])
    assert all(status == 200 for status, _ in scrapes["/anomalies"])
    statuses = [status for status, _ in scrapes["/health"]]
    assert 200 in statuses and set(statuses) <= {200, 503}
    assert 503 not in statuses[statuses.index(200):]
    families = aggregate.parse_prometheus(
        scrapes["/metrics"][-1][1].decode())
    final = aggregate.parse_prometheus(
        open(os.path.join(logdir, "metrics.prom")).read())
    prefixes = {name.split("_")[1] for name in final}
    assert prefixes <= {name.split("_")[1] for name in families}
    health = json.loads(scrapes["/health"][-1][1])
    assert health["logdir"] == logdir and "verdict" in health

    got, _ = _reports(logdir, nobench)
    assert got["kernels"]["rows"] and got["stall_verdict"]
    shares = {name: got["stages"][name]["latency_share"]
              for name in got["stages"]}
    assert got["dominant_stage"]["name"] == max(shares, key=shares.get)
    _payloads(logdir, nobench)
    _diagnoses(logdir)
    out = _text_report(capsys, logdir, nobench)
    assert "worst kernels (this run's profile window)" in out

    assert aggregate.main([logdir]) == 0
    capsys.readouterr()
    fleet = aggregate.parse_prometheus(open(os.path.join(
        logdir, aggregate.FLEET_PROM_NAME)).read())
    for family, data in final.items():
        for (metric, labels), value in data["series"].items():
            folded = [v for (m, ls), v in fleet[family]["series"].items()
                      if m == metric and dict(ls).get("process") in
                      (None, "0") and {k: v2 for k, v2 in ls
                                       if k not in ("process", "fold")}
                      == dict(labels)]
            assert len(folded) == 2, (metric, labels)
            assert all(v == value or (v != v and value != value)
                       for v in folded), (metric, folded, value)
    events = json.load(open(os.path.join(logdir,
                                         aggregate.MERGED_TRACE_NAME)))
    assert any(e.get("name") == "learner/update" for e in events)


def test_driver_with_a_taken_port_logs_and_finishes(tmp_path, registry,
                                                    caplog):
    """``--metrics_http_port`` on a port another socket holds: the JAX
    driver's error line, and the run goes on to its end."""
    with socket.socket() as taken:
        taken.bind(("0.0.0.0", 0))
        taken.listen()
        port = taken.getsockname()[1]
        config = _driver_config(str(tmp_path / "run"),
                                metrics_http_port=port, trace=False,
                                profile_dir="",
                                total_environment_frames=16)
        with caplog.at_level(logging.ERROR, "scalable_agent_tpu_torch"):
            metrics = driver.train(config)
    assert metrics["env_frames"] == 16
    assert any(f"metrics HTTP endpoint unavailable on port {port}"
               in r.getMessage() for r in caplog.records)
    assert not [t for t in threading.enumerate()
                if t.name == "metrics-http"]
