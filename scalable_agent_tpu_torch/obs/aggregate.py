"""Multi-process observability aggregation: N disjoint artifacts -> one.

A copy of ``scalable_agent_tpu/obs/aggregate.py``.  A P-process run leaves
``P`` Chrome traces (``trace.p<i>.<pid>.json``) on per-process clocks and
``P`` Prometheus snapshots (``metrics.prom`` + ``metrics.p<i>.prom``).  The
port runs one process, but this tool folds whatever logdir it is given, as
the JAX one does:

- ``merge_traces``: one Perfetto-loadable trace.  Each input's events
  are shifted onto a shared wall-clock timeline using the per-process
  ``trace_epoch`` record the tracer writes (a back-to-back unix-time /
  span-clock pair; without it a file merges unshifted, flagged in the
  summary), pids are remapped to be unique across files, and
  ``process_name``/``process_sort_index`` metadata label every process
  track.  The output is a STRICT closed JSON array written one event
  per line — both ``json.load`` and ``obs.load_trace_events`` parse it.
- ``aggregate_prometheus``: one exposition text where every per-process
  series carries a ``process="<i>"`` label, plus fleet-total series
  (no ``process`` label) folded per family: counters and summary
  ``_sum``/``_count`` SUM over processes (total FPS, total frames);
  gauges SUM by default but depth/memory-style gauges take the MAX
  (worst queue) and occupancy-style gauges the MIN (most-starved
  consumer); summary quantiles take the MAX (worst-case latency).
  Pipeline-ledger series (obs/ledger.py) fold the same way the
  questions read: per-stage rates SUM to fleet throughput, ρ/latency
  shares/MFU take the busiest process (MAX), and the staleness
  quantiles ride the worst-case quantile rule (MAX).

CLI::

    python -m scalable_agent_tpu_torch.obs.aggregate <logdir>

writes ``<logdir>/trace.merged.json`` and ``<logdir>/metrics.fleet.prom``
and prints a one-line summary.  It imports neither torch nor jax, so it
runs on a laptop against logdirs copied off the card.
"""

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from scalable_agent_tpu_torch.obs.trace import load_trace_events

__all__ = [
    "aggregate_prometheus",
    "merge_traces",
    "parse_prometheus",
    "main",
]

MERGED_TRACE_NAME = "trace.merged.json"
FLEET_PROM_NAME = "metrics.fleet.prom"


# -- trace merging -----------------------------------------------------------


def _epoch_record(events: List[dict]
                  ) -> Tuple[Optional[int], Optional[int]]:
    """(offset_us, start_unix_us) from the file's ``trace_epoch``
    record: adding ``offset_us`` (unix_us - perf_us) to an event ``ts``
    converts the process-local span clock to wall time;
    ``start_unix_us`` is when that tracer came up (used to flag inputs
    that belong to DIFFERENT runs sharing a logdir)."""
    for event in events:
        if event.get("name") == "trace_epoch":
            args = event.get("args") or {}
            if "unix_time_us" in args and "perf_time_us" in args:
                unix = int(args["unix_time_us"])
                return unix - int(args["perf_time_us"]), unix
    return None, None


# Tracers of ONE multi-process run come up within seconds of each
# other; inputs whose epochs are further apart than this are almost
# certainly artifacts of different runs left in a shared logdir.
MULTI_RUN_SPREAD_US = 10 * 60 * 1_000_000


def merge_traces(paths: Sequence[str], out_path: str) -> Dict[str, object]:
    """Merge per-process trace files into one Perfetto-loadable file.

    Returns a summary dict: per-input event counts, the epoch offsets
    used, and which inputs lacked an epoch record (merged unshifted)."""
    per_file = []
    starts = []
    for path in paths:
        events = list(load_trace_events(path))
        offset, start_unix = _epoch_record(events)
        per_file.append((path, events, offset))
        if start_unix is not None:
            starts.append(start_unix)

    # Shared timeline: every aligned file's ts becomes wall-clock us;
    # subtract the earliest aligned wall time so Perfetto's axis starts
    # near zero.  Files without an epoch keep their raw ts (flagged).
    aligned_starts = [
        min((e["ts"] + offset) for e in events if "ts" in e)
        for _, events, offset in per_file
        if offset is not None and any("ts" in e for e in events)
    ]
    base_us = min(aligned_starts) if aligned_starts else 0

    out_events: List[str] = []
    summary = {"inputs": [], "out_path": out_path}
    for index, (path, events, offset) in enumerate(per_file):
        new_pid = index  # unique across files even when os pids collide
        orig_pids = sorted(e.get("pid") for e in events if "pid" in e)
        orig_pid = orig_pids[0] if orig_pids else "?"
        shift = (offset - base_us) if offset is not None else 0
        name = os.path.basename(path)
        # Fresh process metadata so the merged view names every track.
        out_events.append(json.dumps({
            "name": "process_name", "ph": "M", "pid": new_pid, "tid": 0,
            "args": {"name": f"{name} (pid {orig_pid})"}}))
        out_events.append(json.dumps({
            "name": "process_sort_index", "ph": "M", "pid": new_pid,
            "tid": 0, "args": {"sort_index": index}}))
        count = 0
        for event in events:
            if event.get("ph") == "M" and event.get("name") in (
                    "process_name", "process_sort_index"):
                continue  # replaced above
            event = dict(event)
            event["pid"] = new_pid
            if "ts" in event:
                event["ts"] = int(event["ts"]) + shift
            out_events.append(json.dumps(event))
            count += 1
        summary["inputs"].append({
            "path": path, "events": count,
            "epoch_offset_us": offset,
            "aligned": offset is not None,
        })

    # Flag a probable multi-run merge: the pid suffix keeps a previous
    # run's trace alive in a reused logdir, and silently merging it
    # would point the hang playbook at the wrong (long-dead) process.
    summary["multi_run_suspect"] = bool(
        starts and max(starts) - min(starts) > MULTI_RUN_SPREAD_US)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        # Strict closed array, one event per line: json.load-able AND
        # line-parseable by load_trace_events.
        f.write("[\n")
        f.write(",\n".join(out_events))
        f.write("\n]\n")
    os.replace(tmp, out_path)
    summary["total_events"] = len(out_events)
    return summary


# -- prometheus aggregation --------------------------------------------------

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>[^"]*)"')


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Exposition text -> ``{family: {"type", "help", "series"}}`` where
    ``series`` maps ``(metric_name, labels_tuple) -> value`` (metric
    name includes any ``_sum``/``_count`` suffix)."""
    families: Dict[str, dict] = {}

    def family_of(metric_name: str) -> str:
        for suffix in ("_sum", "_count"):
            if metric_name.endswith(suffix) and metric_name[: -len(
                    suffix)] in families:
                return metric_name[: -len(suffix)]
        return metric_name

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": "untyped", "help": "",
                                       "series": {}})
            families[name]["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            families.setdefault(name, {"type": "untyped", "help": "",
                                       "series": {}})
            families[name]["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        match = _SERIES_RE.match(line)
        if not match:
            continue  # torn line (crash mid-write): skip, keep parsing
        metric = match.group("name")
        labels = tuple(sorted(
            (m.group("key"), m.group("val"))
            for m in _LABEL_RE.finditer(match.group("labels") or "")))
        try:
            value = float(match.group("value"))
        except ValueError:
            continue
        fam = family_of(metric)
        families.setdefault(fam, {"type": "untyped", "help": "",
                                  "series": {}})
        families[fam]["series"][(metric, labels)] = value
    return families


def _fleet_fold(family: str, metric: str, kind: str,
                labels: Tuple) -> str:
    """Which fold a fleet-total series takes.  Counters (and summary
    _sum/_count) add up; 'how full is this queue' gauges take the worst
    (max); 'how busy is this consumer' gauges take the most-starved
    (min); summary quantiles report the worst-case latency (max);
    fleet-health gauges (runtime/fleet.py peers_alive) take the MIN —
    the fleet question is 'what does the most-pessimistic process
    see', and a process that noticed a dead peer must not be averaged
    away by ones that haven't polled yet."""
    if kind == "counter":
        return "sum"
    # Device telemetry (obs/device_telemetry.py): the counter series
    # (devtel/..._total, bucket counters) are real Counters and SUM via
    # the kind rule above; EVERY remaining devtel series (run-cumulative
    # readings, last loss, exact histogram sum/count/mean gauges)
    # answers "what does the most-telling process show" — MAX, checked
    # BEFORE the generic _sum/_count summary rule so the fleet
    # sum/count/mean triple stays one process's consistent reading
    # instead of a sum-of-sums paired with a max-of-means.
    # Kernel-ledger series (obs/kernels.py kernel/<name>/mfu, time
    # shares, worst/dominant verdicts) likewise take the MAX: per-
    # kernel MFU folds to the busiest process's reading and the worst-
    # kernel label rides the per-kernel series NAME, so the max fold
    # keeps the named verdict.
    # Learning-dynamics plane (devtel/learn/*, runtime/learner.py
    # learning_telemetry_spec) BEFORE the generic devtel max: the
    # health-of-learning gauges where LOW is bad (normalized entropy,
    # importance-weight ESS, value explained-variance) fold to the
    # most-pessimistic process — MIN — so one collapsing process can't
    # hide behind its healthy peers.  Every other learn series (clip
    # fractions, KL, log-rho drift, dead units, grad/update norms —
    # high is bad) takes the generic devtel MAX below.
    if metric.startswith("impala_devtel_learn_") and any(
            token in metric for token in
            ("entropy_frac", "ess_frac", "explained_variance")):
        return "min"
    if metric.startswith(("impala_devtel_", "impala_kernel_")):
        return "max"
    # Run-health plane (obs/health.py): the counters (anomalies/
    # suppressed/windows totals) are real Counters and SUM above; the
    # remaining health series are verdict one-hots (fired/<detector>,
    # open_anomalies) — "did ANY process see it" — MAX, so one
    # process's trip survives the fold instead of averaging away.
    if metric.startswith("impala_health_"):
        return "max"
    if metric.endswith(("_sum", "_count")):
        return "sum"
    if "peers_alive" in metric:
        return "min"
    # Pipeline ledger (obs/ledger.py): per-stage rates are per-process
    # throughputs (counters in spirit — they SUM to the fleet rate,
    # the default below), but utilization/occupancy ρ, latency shares,
    # MFU, and the truncation flag answer "what does the worst/busiest
    # process look like" — MAX.  Staleness quantiles take the generic
    # worst-case quantile rule further down.
    if "ledger" in metric and ("_rho_" in metric or "latency_share"
                               in metric or metric.endswith("_mfu")
                               or metric.endswith("_truncated")):
        return "max"
    # Elastic membership (runtime/elastic.py): the epoch gauge is a
    # fleet-wide cursor — mid-relaunch, a straggler's stale snapshot
    # still shows the OLD epoch, and summing epochs is meaningless;
    # the newest (max) epoch is the membership truth.  MTTR (and its
    # compile segment, fleet_mttr_compile_s) likewise reports the
    # worst (max) observed recovery.
    if "fleet_epoch" in metric or "fleet_mttr" in metric:
        return "max"
    # The IMPACT anchor cadence (runtime/learner.py) is one config
    # value replicated on every process — summing it would inflate the
    # report's staleness budget N-fold.
    if metric.endswith("target_update_interval"):
        return "max"
    # Occupancy BEFORE the quantile rule: the runtime's occupancy
    # instruments are histograms (quantile-labelled summaries), and the
    # fleet question is "who is most starved" — min — for every series
    # of the family, quantiles included.
    if "occupancy" in metric:
        return "min"
    if any(("quantile" == k) for k, _ in labels):
        return "max"
    if "depth" in metric or "memory" in metric:
        return "max"
    return "sum"


def _fmt_labels(labels: Tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def aggregate_prometheus(texts: Dict[str, str]) -> str:
    """Per-process exposition texts (key = process label value, e.g.
    ``"0"``, ``"1"``) -> one text with ``process``-labelled series plus
    fleet-total series (fold rules: ``_fleet_fold``)."""
    merged: Dict[str, dict] = {}
    for proc in sorted(texts):
        for fam, data in parse_prometheus(texts[proc]).items():
            entry = merged.setdefault(
                fam, {"type": data["type"], "help": data["help"],
                      "per_proc": {}, "fleet": {}})
            if entry["type"] == "untyped":
                entry["type"] = data["type"]
            entry["help"] = entry["help"] or data["help"]
            for (metric, labels), value in data["series"].items():
                entry["per_proc"][
                    (metric, labels + (("process", proc),))] = value
                fold = _fleet_fold(fam, metric, entry["type"], labels)
                key = (metric, labels)
                if key not in entry["fleet"]:
                    entry["fleet"][key] = (fold, value, 1)
                else:
                    _, acc, n = entry["fleet"][key]
                    acc = (acc + value if fold == "sum"
                           else max(acc, value) if fold == "max"
                           else min(acc, value))
                    entry["fleet"][key] = (fold, acc, n + 1)

    lines: List[str] = []
    for fam in sorted(merged):
        entry = merged[fam]
        if entry["help"]:
            lines.append(f"# HELP {fam} {entry['help']}")
        lines.append(f"# TYPE {fam} {entry['type']}")
        for (metric, labels) in sorted(entry["per_proc"]):
            lines.append(f"{metric}{_fmt_labels(labels)} "
                         f"{entry['per_proc'][(metric, labels)]!r}")
        for (metric, labels) in sorted(entry["fleet"]):
            fold, value, _ = entry["fleet"][(metric, labels)]
            fleet_labels = labels + (("fold", fold),)
            lines.append(f"{metric}{_fmt_labels(fleet_labels)} "
                         f"{value!r}")
    return "\n".join(lines) + "\n"


# -- logdir discovery + CLI --------------------------------------------------


def find_artifacts(logdir: str) -> Tuple[List[str], Dict[str, str]]:
    """(trace file paths, {process_label: prom path}) for one logdir,
    excluding this module's own outputs."""
    traces = sorted(
        p for p in glob.glob(os.path.join(logdir, "trace*.json"))
        if os.path.basename(p) != MERGED_TRACE_NAME)
    proms: Dict[str, str] = {}
    for path in sorted(glob.glob(os.path.join(logdir, "metrics*.prom"))):
        name = os.path.basename(path)
        if name == FLEET_PROM_NAME:
            continue
        if name == "metrics.supervisor.prom":
            # The elastic supervisor's own snapshot
            # (runtime/elastic.py): folded alongside the workers under
            # a human-readable process label.
            proms["supervisor"] = path
            continue
        match = re.match(r"metrics\.p(\d+)\.prom$", name)
        proms["0" if name == "metrics.prom"
              else (match.group(1) if match else name)] = path
    return traces, proms


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Merge per-process traces and Prometheus snapshots "
                    "from a (possibly multi-process) run logdir.")
    parser.add_argument("logdir", help="run log directory")
    parser.add_argument("--out_trace", default=None,
                        help=f"merged trace path (default "
                             f"<logdir>/{MERGED_TRACE_NAME})")
    parser.add_argument("--out_prom", default=None,
                        help=f"fleet metrics path (default "
                             f"<logdir>/{FLEET_PROM_NAME})")
    args = parser.parse_args(argv)

    traces, proms = find_artifacts(args.logdir)
    wrote = []
    if traces:
        out_trace = args.out_trace or os.path.join(
            args.logdir, MERGED_TRACE_NAME)
        summary = merge_traces(traces, out_trace)
        unaligned = [os.path.basename(i["path"])
                     for i in summary["inputs"] if not i["aligned"]]
        wrote.append(f"{out_trace} ({summary['total_events']} events "
                     f"from {len(traces)} trace(s)"
                     + (f"; UNALIGNED: {','.join(unaligned)}"
                        if unaligned else "") + ")")
        if summary["multi_run_suspect"]:
            print("WARNING: input trace epochs are >10 min apart — the "
                  "logdir likely holds traces from MORE THAN ONE run; "
                  "the merged timeline mixes them (delete the stale "
                  "trace.p*.json and re-run to aggregate one run)")
    if proms:
        out_prom = args.out_prom or os.path.join(
            args.logdir, FLEET_PROM_NAME)
        texts = {proc: open(path).read()
                 for proc, path in proms.items()}
        text = aggregate_prometheus(texts)
        tmp = out_prom + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, out_prom)
        wrote.append(f"{out_prom} ({len(proms)} snapshot(s))")
    if not wrote:
        print(f"no trace*.json or metrics*.prom artifacts under "
              f"{args.logdir}")
        return 1
    for line in wrote:
        print("wrote", line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
