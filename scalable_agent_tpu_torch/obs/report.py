"""The pipeline gap report: the document a human reads before writing
the next performance change.

A copy of ``scalable_agent_tpu/obs/report.py``::

    python -m scalable_agent_tpu_torch.obs.report <logdir>
    python -m scalable_agent_tpu_torch.obs.report --json <logdir>

renders, from a run's on-disk artifacts (``metrics*.prom``,
``ledger.p*.json``, ``kernels.json``, ``anomalies.jsonl``; it imports
neither torch nor jax, so run it on a laptop against files copied off the
card):

- the **stage table**: per ledger segment (obs/ledger.py SEGMENTS), the
  arrival rate, mean/p95 latency, occupancy ρ (Little's-law L for wait
  stages), and its share of mean birth→retire frame latency;
- the **staleness histogram** (``ledger/staleness_s`` p50/p95/p99 —
  frame age at consumption);
- the **live MFU** gauge and actor-vs-learner FPS;
- the stall verdict and a **top recommendation** keyed on the
  dominant-latency stage — the same attribution the verdict log line
  carries, expanded into the concrete next fix;
- the learning-dynamics verdicts, the run's anomaly records and the
  **worst kernels** section (obs/kernels.py): the per-kernel table from
  the run's ``kernels.json`` when a ``--profile_dir`` window captured one.

``--json`` emits the same verdicts as one machine-readable object
(``build_report``), with the JAX report's keys.  The replay slab's
section, the replayed half of the staleness split and the replay
recommendation read a ``--replay_ratio`` run's live values (and
``--loss=impact``'s anchor cadence).  Sections whose families the port
does not publish yet (the dynamic-batching inference service's stage,
the numerics sentinel) read ``None`` or empty, as the JAX report's do on
a run without those subsystems; the actor service's stages read a
``--actor=service`` run's live values.

Two differences from the JAX report, both deliberate.  ``bench_kernels``
is ``None``: the JAX report reads the committed ``BENCH_r*.json``, which
are TPU rounds, and the port has no rounds of its own yet, so
``--bench_dir`` takes no directory (``ValueError``; the CLI exits 2;
ROADMAP.md, queue 1, item 2).  And the recommendations name only what the
port runs, with ROADMAP.md's queue item for what it does not.

Multi-process logdirs are folded on the fly with obs/aggregate.py's
fold rules (rates sum, ρ max, staleness quantiles max) when
``metrics.fleet.prom`` is absent, so the report always covers the whole
fleet.
"""

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from scalable_agent_tpu_torch.config import _not_ported
from scalable_agent_tpu_torch.obs.aggregate import (
    FLEET_PROM_NAME,
    aggregate_prometheus,
    find_artifacts,
    parse_prometheus,
)
from scalable_agent_tpu_torch.obs.exporters import _prom_name
from scalable_agent_tpu_torch.obs.kernels import KERNELS_JSON_NAME
from scalable_agent_tpu_torch.obs.ledger import (
    SEGMENT_LABELS,
    SEGMENTS,
    SERVICE_STAGES,
    SERVICE_UTILIZATION_STAGES,
)

__all__ = ["build_report", "main", "render_report"]

# Dominant-latency stage -> the concrete next fix: name the stage that
# holds the frames, then act on that stage.  The keys and the rules that
# pick one are the JAX report's; each text names what the port runs, and
# ROADMAP.md's queue item for what it does not run yet.
RECOMMENDATIONS = {
    "unroll": (
        "the actor side (env stepping + inference) holds the frames: "
        "raise --num_env_workers_per_group or split the envs into more "
        "actor groups (--num_actors over --batch_size), or take the "
        "group lockstep away with --actor=service (one "
        "continuous-batching inference thread over the env workers' "
        "slices as they arrive); the actor step as one CUDA graph is the "
        "first known gap (ROADMAP.md, queue 2), and the dynamic and "
        "accum batchers and device-resident rollouts are not ported yet "
        "(ROADMAP.md, queue 1, items 7b-8)"),
    "backpressure": (
        "actors block on a full trajectory queue: the learner side "
        "consumes slower than actors produce — read the device/"
        "transport rows; if those are idle, raise queue capacity"),
    "queue_wait": (
        "trajectories sit in the trajectory queue waiting for the "
        "prefetch/transport stage: speed up put_trajectory "
        "(--transport=packed, the default) or add prefetch depth; the "
        "JAX link probe (runtime/linktune.py) is not ported yet "
        "(ROADMAP.md, queue 1, item 7c)"),
    "transport": (
        "host->device transport dominates: --transport=packed (the "
        "default), check transport/h2d_bytes_total against the card's "
        "link rate, or eliminate the upload with device-resident "
        "rollouts (not ported yet: ROADMAP.md, queue 1, item 8)"),
    "staged_wait": (
        "staged batches wait on a busy learner — the device is the "
        "constraint (healthy); raise --inflight_updates or feed a "
        "bigger batch (--batch_size)"),
    "device": (
        "device execution dominates — the pipeline is healthy and the "
        "card is the constraint: faster kernels (--compute_dtype="
        "bfloat16, --scan_impl=pallas; ROADMAP.md, queue 2 lists the "
        "hand-written kernels' known gaps), a larger batch — profile a "
        "window (--profile_dir) and read the worst-kernels section below"),
    "inference_service": (
        "the dynamic-batching inference service saturates: the port "
        "does not run it yet (ROADMAP.md, queue 1, item 7b)"),
    "service_wait": (
        "requests park waiting for the actor service's inference "
        "thread (rho here is Little's-law L, the parked count): raise "
        "--service_max_batch so one step drains more of the ring, check "
        "service/batch_s for slow buckets (the ladder bounds the batch "
        "sizes the step kernel sees), or split the envs into more actor "
        "groups (--num_actors over --batch_size)"),
    "service_batch": (
        "the actor service's single inference thread runs near 100% "
        "busy: raise --service_max_batch (bigger batches amortize the "
        "per-step host work), shrink the observation (--height/--width), "
        "or take the actor step off the host's critical path: the step "
        "as one CUDA graph (ROADMAP.md, queue 2) or device-resident "
        "rollouts (not ported yet: ROADMAP.md, queue 1, item 8)"),
}


def _load_families(logdir: str) -> Tuple[Dict[str, dict], str]:
    """Parsed prometheus families for the logdir, folding multi-process
    snapshots on the fly; returns (families, source description)."""
    fleet_path = os.path.join(logdir, FLEET_PROM_NAME)
    if os.path.exists(fleet_path):
        return (parse_prometheus(open(fleet_path).read()),
                FLEET_PROM_NAME)
    _, proms = find_artifacts(logdir)
    if not proms:
        raise FileNotFoundError(
            f"no metrics*.prom under {logdir} — run the driver with a "
            f"logdir (the snapshot is always on) or aggregate first")
    if len(proms) == 1:
        (label, path), = proms.items()
        return (parse_prometheus(open(path).read()),
                os.path.basename(path))
    texts = {label: open(path).read() for label, path in proms.items()}
    return (parse_prometheus(aggregate_prometheus(texts)),
            f"{len(proms)} snapshots (folded)")


def _value(families: Dict[str, dict], registry_name: str,
           quantile: Optional[str] = None,
           suffix: str = "") -> Optional[float]:
    """One series value by REGISTRY name (prom sanitization applied
    here).  Fleet-folded families hold both per-process and fold-
    labelled series — the fold one (the fleet total) wins; a plain
    single-process snapshot has exactly the unlabelled series."""
    family = _prom_name(registry_name)
    data = families.get(family)
    if data is None:
        return None
    metric = family + suffix
    want_q = quantile
    best = None
    for (name, labels), value in data["series"].items():
        if name != metric:
            continue
        ldict = dict(labels)
        if want_q is not None and ldict.get("quantile") != want_q:
            continue
        if want_q is None and "quantile" in ldict:
            continue
        if "fold" in ldict:
            return value  # fleet total: authoritative
        if "process" not in ldict:
            best = value  # plain snapshot series
        elif best is None:
            best = value  # fall back to any per-process series
    return best


def _ledger_artifacts(logdir: str) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "ledger.p*.json"))):
        try:
            out.append(json.load(open(path)))
        except (OSError, json.JSONDecodeError):
            continue
    return out


# -- kernel sections ---------------------------------------------------------


def _run_kernels(logdir: str) -> Optional[dict]:
    """The run's own per-kernel roofline table (``kernels.json``,
    written by a --profile_dir window — obs/kernels.py)."""
    path = os.path.join(logdir, KERNELS_JSON_NAME)
    if not os.path.exists(path):
        return None
    try:
        table = json.load(open(path))
    except (OSError, json.JSONDecodeError):
        return None
    rows = [
        {"name": row.get("name"),
         "time_us": row.get("time_us"),
         "time_share": row.get("time_share"),
         "calls": row.get("calls"),
         "flops": row.get("flops"),
         "intensity": row.get("intensity"),
         "mfu": row.get("mfu")}
        for row in table.get("kernels", [])
    ]
    return {
        "source": KERNELS_JSON_NAME,
        "rows": rows,
        "flops_total": table.get("flops_total"),
        "matched_time_frac": table.get("matched_time_frac"),
        "dominant": table.get("dominant_kernel"),
        "dominant_time_share": table.get("dominant_time_share"),
        "worst": table.get("worst_kernel"),
        "worst_mfu": table.get("worst_kernel_mfu"),
        "scope_time_shares": table.get("scope_time_shares") or None,
    }


def _rounds(bench_dir: Optional[str]) -> None:
    """What the JAX report (its per-kernel readings) and console (its fps
    baseline) read from the newest committed bench round.  Those rounds
    are TPU readings and the port has none of its own yet: ``None``
    without a ``bench_dir``, and a directory raises."""
    if bench_dir is not None:
        raise _not_ported(
            f"--bench_dir={bench_dir} (the committed BENCH_r*.json are TPU "
            f"rounds; the port's own rounds come with its benchmark, "
            f"ROADMAP.md queue 1, item 2)")
    return None


# -- the machine-readable report ---------------------------------------------


def build_report(logdir: str,
                 bench_dir: Optional[str] = None) -> dict:
    """Everything the text report says, as one JSON-able object — the
    ``--json`` payload CI and the bench tooling consume."""
    families, source = _load_families(logdir)
    report: dict = {"logdir": logdir, "source": source}

    stages = {}
    shares = {}
    for name, _, _ in SEGMENTS:
        total = _value(families, f"ledger/stage/{name}_s", suffix="_sum")
        count = _value(families, f"ledger/stage/{name}_s",
                       suffix="_count")
        share = _value(families, f"ledger/latency_share/{name}")
        if share is not None:
            shares[name] = share
        stages[name] = {
            "rate_per_s": _value(families, f"ledger/rate/{name}_per_s"),
            "rho": _value(families, f"ledger/rho/{name}"),
            "mean_s": ((total / count)
                       if total is not None and count else None),
            "p95_s": _value(families, f"ledger/stage/{name}_s",
                            quantile="0.95"),
            "latency_share": share,
            "label": SEGMENT_LABELS[name],
        }
    report["stages"] = stages

    service = {}
    for name in SERVICE_STAGES:
        rate = _value(families, f"ledger/rate/{name}_per_s")
        rho = _value(families, f"ledger/rho/{name}")
        if not rate and not rho:
            continue
        service[name] = {"rate_per_s": rate, "rho": rho,
                         "label": SEGMENT_LABELS[name]}
    report["service_stages"] = service

    report["staleness_s"] = {
        q: _value(families, "ledger/staleness_s", quantile=q)
        for q in ("0.5", "0.95", "0.99")}
    # The replayed half of the staleness split (runtime/replay.py):
    # present only when --replay_ratio > 0 fed the slab.
    report["staleness_replayed_s"] = {
        q: _value(families, "ledger/staleness_replayed_s", quantile=q)
        for q in ("0.5", "0.95", "0.99")}
    replay = {
        "occupancy": _value(families, "replay/occupancy"),
        "inserted": _value(families, "replay/insert_total"),
        "sampled": _value(families, "replay/sampled_total"),
        "target_update_interval": _value(
            families, "replay/target_update_interval"),
    }
    # Keyed on the SLAB's own series, not target_update_interval: an
    # --loss=impact run with replay off still publishes the anchor
    # cadence gauge, and must not draw a phantom slab section.
    report["replay"] = (
        replay if any(replay[key] is not None
                      for key in ("occupancy", "inserted", "sampled"))
        else None)

    # The off-policy dial's own recommendation: the IMPACT clip anchors
    # on a target net refreshed every target_update_interval updates,
    # so replayed data older than ~one refresh period (interval /
    # update rate) predates the anchor — its importance weights clip
    # away and the replayed updates stop buying learning.
    replay_rec = None
    replayed_p95 = report["staleness_replayed_s"]["0.95"]
    interval = replay["target_update_interval"]
    update_rate = (report["stages"].get("device") or {}).get(
        "rate_per_s")
    if replayed_p95 and interval and update_rate:
        budget_s = interval / update_rate
        if replayed_p95 > budget_s:
            replay_rec = (
                f"replayed staleness p95 {replayed_p95:.3f}s exceeds "
                f"the IMPACT clip's useful range (~{budget_s:.3f}s = "
                f"target_update_interval {interval:.0f} / "
                f"{update_rate:.2f} updates/s): lower --replay_ratio "
                f"or --replay_capacity, or raise "
                f"--target_update_interval so the anchor outlives the "
                f"slab")
    report["replay_recommendation"] = replay_rec
    report["mfu"] = _value(families, "ledger/mfu")
    report["learner_fps"] = _value(families, "learner/fps")
    report["actor_fps"] = _value(families, "actor/fps")
    report["trajectories"] = {
        "opened": _value(families, "ledger/trajectories_opened_total"),
        "retired": _value(families, "ledger/trajectories_retired_total"),
        "frames_discarded": _value(families,
                                   "ledger/frames_discarded_total"),
        "open": _value(families, "ledger/open_records"),
    }

    verdict = None
    for category in ("device_bound", "env_bound", "learner_starved",
                     "stalled_thread"):
        flag = _value(families, f"stall/is_{category}")
        if flag == 1.0:
            verdict = category
    report["stall_verdict"] = verdict

    dominant = max(shares, key=shares.get) if shares else None
    report["dominant_stage"] = (
        {"name": dominant, "share": shares[dominant]}
        if dominant else None)
    report["recommendation"] = (
        RECOMMENDATIONS.get(dominant, "inspect the stage table")
        if dominant else None)
    pressure = None
    if dominant == "unroll":
        util = {
            name: _value(families, f"ledger/rho/{name}")
            for name in SERVICE_UTILIZATION_STAGES
        }
        util = {k: v for k, v in util.items() if v is not None}
        if util:
            busiest = max(util, key=util.get)
            if util[busiest] >= 0.5:
                pressure = {"name": busiest, "rho": util[busiest]}
    report["service_pressure"] = pressure

    report["ledger_artifacts"] = [
        {"process_index": a.get("process_index"),
         "opened": a.get("counters", {}).get("opened", 0),
         "abandoned": a.get("counters", {}).get("abandoned", 0),
         "truncated": bool(a.get("ring_truncated")
                           or a.get("counters", {}).get("dropped"))}
        for a in _ledger_artifacts(logdir)]

    # Device telemetry headline (devtel/* gauges published by the
    # driver's log-interval fetch): surfaced so the fused backend's
    # episode stream is part of the verdict document.
    devtel = {}
    for key, registry_name in (
            ("env_episodes", "devtel/env/episodes"),
            ("env_episode_return_mean", "devtel/env/episode_return/mean"),
            ("env_episode_length_mean", "devtel/env/episode_length/mean"),
            ("learner_updates", "devtel/learner/updates"),
            ("learner_skipped", "devtel/learner/skipped"),
            ("learner_loss", "devtel/learner/loss")):
        value = _value(families, registry_name)
        if value is not None:
            devtel[key] = value
    report["devtel"] = devtel or None

    # The learning-dynamics plane (obs/learning.py over the
    # devtel/learn/* gauges): metric snapshot, rule verdicts, and the
    # measured staleness→clipping relationship from the per-interval
    # metrics.jsonl rows.
    from scalable_agent_tpu_torch.obs import learning
    learn_snapshot = learning.extract_snapshot({
        name: _value(families, name)
        for name in learning.LEARNING_GAUGES.values()})
    report["learning"] = {
        "snapshot": learn_snapshot,
        "verdicts": learning.derive_verdicts(learn_snapshot),
        "staleness_clip": learning.staleness_clip_relationship(
            learning.read_interval_rows(logdir)),
    } if learn_snapshot else None

    # The run's incident timeline (obs/health.py anomalies.jsonl):
    # the report narrates what the health plane caught, with the
    # auto-profiled kernel verdict when a window completed.
    from scalable_agent_tpu_torch.obs.health import read_anomalies
    anomalies = read_anomalies(logdir)
    report["anomalies"] = [
        {"id": a.get("id"), "detector": a.get("detector"),
         "metric": a.get("metric"), "update": a.get("update"),
         "observed": a.get("observed"), "baseline": a.get("baseline"),
         "z": a.get("z"), "verdict": a.get("verdict"),
         "dominant_segment": a.get("dominant_segment"),
         "window": a.get("window")}
        for a in anomalies] or None
    report["health"] = {
        "anomalies_total": _value(families, "health/anomalies_total"),
        "suppressed_total": _value(families, "health/suppressed_total"),
        "profile_windows_total": _value(
            families, "health/profile_windows_total"),
    } if any(_value(families, f"health/{k}") is not None
             for k in ("anomalies_total", "suppressed_total",
                       "profile_windows_total")) else None

    # The numerics sentinel (runtime/sentinel.py): shadow-audit and
    # fingerprint outcomes.  A trip with no matching explanation is a
    # blocking finding — the r06 checklist's "sentinel quiet" gate
    # (docs/benchmarking.md) reads this section.
    sentinel = {}
    for key, registry_name in (
            ("audits", "devtel/sentinel/audits_total"),
            ("breaches", "devtel/sentinel/breaches_total"),
            ("max_deviation", "devtel/sentinel/max_deviation"),
            ("trips", "sentinel/trips_total"),
            ("demotions", "sentinel/demotions_total"),
            ("fingerprint_mismatches",
             "sentinel/fingerprint_mismatch_total"),
            ("rung", "sentinel/rung")):
        value = _value(families, registry_name)
        if value is not None:
            sentinel[key] = value
    report["sentinel"] = sentinel or None

    report["kernels"] = _run_kernels(logdir)
    report["bench_kernels"] = _rounds(bench_dir)
    # The device_bound split: which stage owns the profiled device time
    # (obs/kernels.py scope_time_shares, from the same profile window).
    report["device_attribution"] = (
        (report["kernels"] or {}).get("scope_time_shares"))
    return report


# -- the human-readable report -----------------------------------------------


def _fmt(value: Optional[float], spec: str = "8.3f") -> str:
    if value is None:
        width = spec.split(".")[0]
        return " " * (int(width) - 1 if width else 0) + "-"
    return format(value, spec)


def _render_kernel_section(lines: List[str], section: dict,
                           heading: str):
    lines.append("")
    lines.append(f"{heading} — source: {section['source']}")
    header = (f"  {'kernel':<28}{'time_us':>12}{'share':>8}"
              f"{'mfu':>8}")
    lines.append(header)
    lines.append("  " + "-" * (len(header) - 2))
    for row in section["rows"][:10]:
        share = row.get("time_share")
        lines.append(
            f"  {str(row['name'])[:28]:<28}"
            f"{_fmt(row.get('time_us'), '12.1f')}"
            f"{_fmt(share * 100 if share is not None else None, '7.1f')}%"
            f"{_fmt(row.get('mfu'), '8.3f')}")
    if section.get("worst"):
        lines.append(
            f"  worst kernel: {section['worst']} "
            f"(mfu {_fmt(section.get('worst_mfu'), '.3f')}) — the "
            f"roofline target (ROADMAP.md, queue 2)")
    if section.get("dominant"):
        lines.append(f"  dominant kernel: {section['dominant']}")


def render_report(logdir: str, bench_dir: Optional[str] = None) -> str:
    report = build_report(logdir, bench_dir=bench_dir)
    lines = [f"Pipeline ledger report — {logdir}",
             f"source: {report['source']}", ""]

    header = (f"{'stage':<18}{'rate/s':>9}{'mean_s':>10}{'p95_s':>10}"
              f"{'rho(L)':>9}{'share':>8}  where")
    lines.append(header)
    lines.append("-" * len(header))
    for name, _, _ in SEGMENTS:
        stage = report["stages"][name]
        share = stage["latency_share"]
        lines.append(
            f"{name:<18}{_fmt(stage['rate_per_s'], '9.2f')}"
            f"{_fmt(stage['mean_s'], '10.4f')}"
            f"{_fmt(stage['p95_s'], '10.4f')}"
            f"{_fmt(stage['rho'], '9.3f')}"
            f"{_fmt(share * 100 if share is not None else None, '7.1f')}%"
            f"  {SEGMENT_LABELS[name]}")
    for name in SERVICE_STAGES:
        stage = report["service_stages"].get(name)
        if stage is None:
            continue
        lines.append(
            f"{name:<18}{_fmt(stage['rate_per_s'], '9.2f')}"
            f"{'-':>10}{'-':>10}"
            f"{_fmt(stage['rho'], '9.3f')}{'-':>7}   "
            f"{SEGMENT_LABELS[name]}")
    lines.append("")

    staleness = report["staleness_s"]
    labels = {"0.5": "p50", "0.95": "p95", "0.99": "p99"}
    if any(v is not None for v in staleness.values()):
        lines.append(
            "staleness (FRESH frame age at consumption): "
            + "  ".join(f"{labels[q]} {_fmt(staleness[q], '.3f')}s"
                        for q in ("0.5", "0.95", "0.99")))
    replayed = report["staleness_replayed_s"]
    if any(v is not None for v in replayed.values()):
        lines.append(
            "staleness (REPLAYED frame age at sample): "
            + "  ".join(f"{labels[q]} {_fmt(replayed[q], '.3f')}s"
                        for q in ("0.5", "0.95", "0.99")))
    replay = report["replay"]
    if replay:
        lines.append(
            f"replay slab: occupancy "
            f"{_fmt(replay['occupancy'], '.2f')}, "
            f"{_fmt(replay['inserted'], '.0f')} inserted, "
            f"{_fmt(replay['sampled'], '.0f')} sampled")
    if report["replay_recommendation"]:
        lines.append(
            "replay recommendation: " + report["replay_recommendation"])
    mfu = report["mfu"]
    lines.append(
        f"mfu: {_fmt(mfu, '.4g') if mfu is not None else 'n/a'}   "
        f"learner fps: {_fmt(report['learner_fps'], '.0f')}   "
        f"actor fps: {_fmt(report['actor_fps'], '.0f')}")

    trajectories = report["trajectories"]
    lines.append(
        f"trajectories: {_fmt(trajectories['opened'], '.0f')} opened, "
        f"{_fmt(trajectories['retired'], '.0f')} retired, "
        f"{_fmt(trajectories['frames_discarded'], '.0f')} frames "
        f"discarded, "
        f"{_fmt(trajectories['open'], '.0f')} open")

    if report["stall_verdict"]:
        lines.append(f"stall verdict: {report['stall_verdict']}")
    attribution = report.get("device_attribution")
    if attribution:
        split = "  ".join(
            f"{name} {share:.0%}"
            for name, share in sorted(attribution.items(),
                                      key=lambda kv: -kv[1]))
        prefix = ("device_bound split"
                  if report["stall_verdict"] == "device_bound"
                  else "device-time split")
        lines.append(
            f"{prefix} (matched kernel time by stage, kernels.json): "
            f"{split}")

    dominant = report["dominant_stage"]
    if dominant:
        lines.append(
            f"dominant stage: {dominant['name']} "
            f"({dominant['share']:.0%} of frame latency in "
            f"{SEGMENT_LABELS[dominant['name']]})")
        lines.append("top recommendation: " + report["recommendation"])
        # The inference service runs INSIDE the unroll segment, so a
        # saturated service reads as "unroll" in the latency shares —
        # its ρ names the real constraint (runtime/service.py).
        pressure = report["service_pressure"]
        if pressure:
            lines.append(
                f"service-dominated: {pressure['name']} rho "
                f"{pressure['rho']:.2f} — "
                + RECOMMENDATIONS.get(
                    pressure["name"], "inspect the service rows"))
    else:
        lines.append(
            "dominant stage: n/a (no closed ledger records published — "
            "did the run retire any updates?)")

    devtel = report["devtel"]
    if devtel:
        parts = []
        if "learner_updates" in devtel:
            parts.append(f"updates {devtel['learner_updates']:.0f}")
        if "learner_skipped" in devtel:
            parts.append(f"skipped {devtel['learner_skipped']:.0f}")
        if "env_episodes" in devtel:
            parts.append(f"episodes {devtel['env_episodes']:.0f}")
        if "env_episode_return_mean" in devtel:
            parts.append(
                f"mean return {devtel['env_episode_return_mean']:.3f}")
        if "env_episode_length_mean" in devtel:
            parts.append(
                f"mean length {devtel['env_episode_length_mean']:.1f}")
        lines.append("device telemetry: " + ", ".join(parts))

    learning_section = report.get("learning")
    if learning_section:
        snapshot = learning_section["snapshot"]
        lines.append("")
        lines.append("learning dynamics (devtel/learn/*, "
                     "obs/learning.py — full table via "
                     "`python -m scalable_agent_tpu_torch.obs.diagnose`)")
        headline = []
        for key, label in (("entropy_frac", "entropy"),
                           ("kl", "KL"),
                           ("ess_frac", "ESS"),
                           ("explained_variance", "EV"),
                           ("rho_clip_fraction", "rho-clip"),
                           ("dead_torso_frac", "dead-torso")):
            if key in snapshot:
                headline.append(f"{label} {snapshot[key]:.3f}")
        if headline:
            lines.append("  " + "  ".join(headline))
        ratios = [f"{group} {snapshot[f'update_ratio_{group}']:.3g}"
                  for group in ("torso", "core", "heads")
                  if f"update_ratio_{group}" in snapshot]
        if ratios:
            lines.append("  update/param ratios: " + "  ".join(ratios))
        relation = learning_section.get("staleness_clip")
        if relation:
            lines.append("  staleness→clipping: "
                         + relation["statement"])
        for verdict in learning_section["verdicts"]:
            lines.append(
                f"  [{verdict['severity']}] {verdict['name']}: "
                f"observed {verdict['observed']:.4g} vs limit "
                f"{verdict['limit']:.4g} — {verdict['remedy']}")

    for artifact in report["ledger_artifacts"]:
        extra = " [TRUNCATED window]" if artifact["truncated"] else ""
        lines.append(
            f"ledger artifact p{artifact['process_index']}: "
            f"{artifact['opened']:.0f} records, "
            f"{artifact['abandoned']:.0f} abandoned at shutdown{extra}")

    anomalies = report.get("anomalies")
    if anomalies:
        lines.append("")
        lines.append(f"anomalies ({len(anomalies)} recorded — "
                     f"obs/health.py, anomalies.jsonl)")
        for a in anomalies:
            z = a.get("z")
            detail = (f" z {z:.1f}" if isinstance(z, (int, float))
                      else "")
            window = a.get("window") or {}
            wline = window.get("status", "-")
            if window.get("kernels_json"):
                wline += f" → {os.path.basename(window['kernels_json'])}"
                if window.get("worst_kernel"):
                    wline += (f" worst {window['worst_kernel']} mfu "
                              f"{_fmt(window.get('worst_kernel_mfu'), '.3f')}")
                delta = window.get("worst_kernel_mfu_delta")
                if isinstance(delta, (int, float)):
                    wline += f" (Δ {delta:+.3f})"
            lines.append(
                f"  {a.get('id', '?'):<22} {a.get('metric', '?')} "
                f"{_fmt(a.get('observed'), '.4g')} vs "
                f"{_fmt(a.get('baseline'), '.4g')}{detail}  "
                f"[{a.get('dominant_segment') or a.get('verdict') or '-'}]"
                f"  window {wline}")

    sentinel = report.get("sentinel")
    if sentinel:
        lines.append("")
        trips = sentinel.get("trips", 0) or 0
        status = ("QUIET" if not trips
                  else f"{trips:.0f} trip(s) — explain each before "
                       f"accepting the round")
        lines.append(f"numerics sentinel: {status}")
        lines.append(
            f"  audits {sentinel.get('audits', 0):.0f}  "
            f"breaches {sentinel.get('breaches', 0):.0f}  "
            f"max deviation "
            f"{_fmt(sentinel.get('max_deviation'), '.3g')}  "
            f"demotions {sentinel.get('demotions', 0):.0f}  "
            f"fingerprint mismatches "
            f"{sentinel.get('fingerprint_mismatches', 0):.0f}  "
            f"ladder rung {sentinel.get('rung', 0):.0f}")

    if report["kernels"]:
        _render_kernel_section(
            lines, report["kernels"],
            "worst kernels (this run's profile window)")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Render the pipeline-ledger gap report (stage "
                    "table, staleness, MFU, worst kernels, top "
                    "recommendation) from a run logdir's prom/ledger/"
                    "kernel artifacts.  Imports neither torch nor jax.")
    parser.add_argument("logdir", help="run log directory")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report object "
                             "instead of text")
    parser.add_argument("--bench_dir", default=None,
                        help="a directory of the port's benchmark rounds: "
                             "there are none yet (ROADMAP.md, queue 1, "
                             "item 2), so a directory exits 2")
    args = parser.parse_args(argv)
    try:
        if args.json:
            print(json.dumps(build_report(args.logdir,
                                          bench_dir=args.bench_dir),
                             indent=1))
        else:
            print(render_report(args.logdir, bench_dir=args.bench_dir),
                  end="")
    except (FileNotFoundError, ValueError) as exc:
        # A missing or metrics-free logdir is an operator typo, and a
        # --bench_dir asks for rounds the port does not have: one
        # diagnostic line on stderr, exit 2 (obs.watch shares the
        # convention).
        print(f"obs.report: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
