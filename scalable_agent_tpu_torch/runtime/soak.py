"""The chaos soak: a seeded fault schedule injected into a running
training process through the runtime channel, graded against invariants.

The counterpart of ``scalable_agent_tpu/runtime/soak.py``, single-process:
a **seeded schedule** sampled from the chaos registry by weight
(``sample_schedule``), appended as lines of ``<logdir>/chaos_inject.jsonl``
to a ``python -m scalable_agent_tpu_torch.driver`` run under
``--chaos_channel``, SIGTERMed at the budget (the preemption grace
protocol drains it to one final verified checkpoint), then graded by the
pure ``check_invariants`` into an atomically written
``soak_report.json``.  The invariants, each graded on its own (the soak
passes when every one holds):

- ``throughput_floor``: every healthy-window fps reading stays >=
  ``floor`` (0.8) of the run's own healthy-window median (rows whose
  interval touches no injected fault's recovery window, after the
  warm-up fraction; the first row is always out);
- ``mttr_ceiling``: every ``mttr`` event of ``fleet_epochs.jsonl`` stays
  under the ceiling (a single process writes none, so it holds vacuously
  until the elastic supervisor is ported);
- ``frame_exactness``: the final verified checkpoint's ``env_frames ==
  updates * frames_per_update`` exactly;
- ``final_checkpoint``: the walk-back restore finds a checkpoint that
  verifies against its manifest;
- ``quiet_outside_windows``: no health-plane anomaly outside the
  injected windows, and no more sentinel trips than injected
  sentinel-class faults.

Where this engine differs from the JAX one, which times the schedule
from the launch of the process and SIGTERMs at the budget whatever
happened: the schedule's clock starts at the run's first update (the
first ``metrics.prom`` that counts one), and the SIGTERM waits (up to
``land_timeout_s``) until ``faults/injected_total`` counts every injected
line.  Launched from the process start, a loaded host that takes longer
than the schedule's first times to import, build and start has its
injector armed after those lines were written, so it skips them as stale
(the channel's epoch rule), and a SIGTERM that lands before the
preemption handler is installed kills the run with no checkpoint.

CLI::

    python -m scalable_agent_tpu_torch.runtime.soak run \\
        --soak_seed=1 --soak_faults=6 --soak_budget_s=120 \\
        --logdir=/tmp/soak --level_name=fake_small --device=cpu ...
    python -m scalable_agent_tpu_torch.runtime.soak report --logdir=/tmp/soak

``run`` takes the driver's flags after its own ``--soak_*`` flags and
forces ``--chaos_channel``.  The JAX engine's fleet branch (the elastic
supervisor for ``--distributed_num_processes > 1`` or ``--elastic``)
waits for the multi-process fleet (ROADMAP.md, queue 1): those flags
raise the port's unported-flag error.  The schedule is deterministic in
(seed, faults, budget, points): ``sample_schedule`` drives one
``random.Random(seed)``, exactly as the JAX one does.
"""

import argparse
import dataclasses
import json
import os
import random
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from scalable_agent_tpu_torch.runtime.faults import (
    CHANNEL_NAME,
    CHAOS_POINTS,
    SENTINEL_POINTS,
)
from scalable_agent_tpu_torch.utils import log

SOAK_REPORT_NAME = "soak_report.json"
SOAK_SCHEMA_VERSION = 1

# Schedule sampling weights over the chaos registry, the JAX package's.
# Weight-0 points are left out of random schedules: service_stall needs
# --actor=service, replay_corrupt --replay_ratio > 0, the sentinel's
# points --sentinel_interval.  ``run_soak``'s callers pass weights for
# those; the CLI opts in the points its --soak_points names.
DEFAULT_WEIGHTS: Dict[str, float] = {
    "nan_grad": 3.0,
    "throughput_sag": 3.0,
    "actor_raise": 2.0,
    "worker_kill": 2.0,
    "ckpt_torn": 1.0,
    "ckpt_save_fail": 1.0,
    "peer_exit": 2.0,
    "preempt_sigterm": 0.0,   # ends the run: opt-in only
    "peer_hang": 0.0,         # wedges a peer until peer_timeout_s
    "service_stall": 0.0,
    "replay_corrupt": 0.0,
    "param_bitflip": 0.0,
    "kernel_miscompute": 0.0,
    "replica_diverge": 0.0,
}

# Points that only make sense in a multi-process fleet.
FLEET_ONLY_POINTS = ("peer_exit", "peer_hang", "preempt_sigterm",
                     "replica_diverge")

# Declared recovery window per point (seconds after the injection during
# which throughput readings and anomaly records are expected and left out
# of the grading), the JAX package's.
DEFAULT_RECOVERY_S: Dict[str, float] = {
    "peer_exit": 120.0,
    "peer_hang": 150.0,
    "preempt_sigterm": 120.0,
    "worker_kill": 30.0,
    "actor_raise": 20.0,
    "ckpt_torn": 10.0,
    "ckpt_save_fail": 10.0,
    "service_stall": 30.0,
    "throughput_sag": 15.0,
    "nan_grad": 15.0,
    "replay_corrupt": 15.0,
    "param_bitflip": 30.0,
    "kernel_miscompute": 30.0,
    "replica_diverge": 60.0,
}
_FALLBACK_RECOVERY_S = 30.0

# The fraction of the budget kept free of faults at each end: the start
# (and its first rows) and the drain's final checkpoint.
SCHEDULE_WARMUP_FRAC = 0.25
SCHEDULE_COOLDOWN_FRAC = 0.25


def sample_schedule(seed: int, num_faults: int, budget_s: float,
                    points: Optional[Sequence[str]] = None,
                    weights: Optional[Dict[str, float]] = None,
                    num_processes: int = 1,
                    recovery_s: Optional[Dict[str, float]] = None,
                    ) -> List[dict]:
    """A deterministic schedule: ``num_faults`` events sampled from
    ``points`` by weight, at times uniform over the middle of the budget,
    sorted.  Each event is ``{"t_s", "point", "proc", "recovery_s"}``
    (``proc`` None single-process, else a sampled process id)."""
    weights = dict(DEFAULT_WEIGHTS if weights is None else weights)
    if points is None:
        points = [p for p, w in weights.items() if w > 0]
        if num_processes <= 1:
            points = [p for p in points if p not in FLEET_ONLY_POINTS]
    unknown = sorted(set(points) - set(CHAOS_POINTS))
    if unknown:
        raise ValueError(
            f"unknown chaos point(s) {unknown} — the registry is "
            f"runtime/faults.py CHAOS_POINTS")
    if not points:
        raise ValueError("no chaos points to sample from")
    recovery_s = dict(DEFAULT_RECOVERY_S if recovery_s is None
                      else recovery_s)
    rng = random.Random(seed)
    lo = budget_s * SCHEDULE_WARMUP_FRAC
    hi = budget_s * (1.0 - SCHEDULE_COOLDOWN_FRAC)
    point_weights = [max(weights.get(p, 1.0), 1e-9) for p in points]
    events = []
    for _ in range(max(0, int(num_faults))):
        point = rng.choices(list(points), weights=point_weights)[0]
        events.append({
            "t_s": round(rng.uniform(lo, hi), 3),
            "point": point,
            "proc": (rng.randrange(num_processes)
                     if num_processes > 1 else None),
            "recovery_s": float(recovery_s.get(point,
                                               _FALLBACK_RECOVERY_S)),
        })
    events.sort(key=lambda e: (e["t_s"], e["point"]))
    return events


# -- the invariant checker (pure) ----------------------------------------


def _windows(injected: Sequence[dict]) -> List[tuple]:
    """[(start_unix, end_unix)] recovery windows of the injected events
    (an event that never landed has no ``t_unix`` and no window)."""
    out = []
    for event in injected:
        t = event.get("t_unix")
        if t is None:
            continue
        out.append((float(t),
                    float(t) + float(event.get("recovery_s",
                                               _FALLBACK_RECOVERY_S))))
    return out


def _in_windows(t: float, windows: Sequence[tuple]) -> bool:
    return any(lo <= t <= hi for lo, hi in windows)


def _overlaps(lo: float, hi: float, windows: Sequence[tuple]) -> bool:
    return any(lo <= whi and wlo <= hi for wlo, whi in windows)


def check_invariants(*, metrics_rows: Sequence[dict],
                     mttr_events: Sequence[dict],
                     anomalies: Sequence[dict],
                     injected: Sequence[dict],
                     ckpt: dict,
                     frames_per_update: int,
                     throughput_floor: float = 0.8,
                     mttr_ceiling_s: float = 180.0,
                     sentinel_trips: int = 0,
                     warmup_until_unix: Optional[float] = None,
                     ) -> Dict[str, dict]:
    """Grade every invariant against the run's parsed streams:
    ``{invariant: {"ok": bool, ...evidence...}}``, every invariant always
    present.  Throughput rows whose interval starts before
    ``warmup_until_unix`` are left out (the schedule keeps that fraction
    free of faults because the start is not steady state)."""
    windows = _windows(injected)

    fps_rows = [r for r in metrics_rows
                if isinstance(r.get("fps"), (int, float))
                and isinstance(r.get("time"), (int, float))]
    graded, excluded = [], 0
    for i, row in enumerate(fps_rows):
        if i == 0:
            excluded += 1  # the first interval holds the start
            continue
        interval = (float(fps_rows[i - 1]["time"]), float(row["time"]))
        if warmup_until_unix is not None \
                and interval[0] < warmup_until_unix:
            excluded += 1
            continue
        if _overlaps(interval[0], interval[1], windows):
            excluded += 1
            continue
        graded.append(float(row["fps"]))
    if graded:
        ordered = sorted(graded)
        baseline = ordered[len(ordered) // 2]
        worst = min(graded)
        frac = (worst / baseline) if baseline > 0 else 0.0
        throughput = {
            "ok": bool(baseline > 0 and frac >= throughput_floor),
            "floor": throughput_floor,
            "baseline_fps": round(baseline, 3),
            "worst_fps": round(worst, 3),
            "worst_frac": round(frac, 4),
            "rows_graded": len(graded),
            "rows_excluded": excluded,
        }
    else:
        throughput = {
            "ok": False,
            "floor": throughput_floor,
            "rows_graded": 0,
            "rows_excluded": excluded,
            "detail": "no healthy-window throughput rows to grade",
        }

    mttrs = [float(e["mttr_s"]) for e in mttr_events
             if isinstance(e.get("mttr_s"), (int, float))]
    mttr = {
        "ok": bool(all(m <= mttr_ceiling_s for m in mttrs)),
        "ceiling_s": mttr_ceiling_s,
        "events": len(mttrs),
        "worst_s": round(max(mttrs), 3) if mttrs else None,
    }

    step = ckpt.get("step")
    env_frames = ckpt.get("env_frames")
    if step is None or env_frames is None:
        exactness = {"ok": False,
                     "detail": "no verified checkpoint to account "
                               "against"}
    else:
        expected = float(step) * float(frames_per_update)
        exactness = {
            "ok": bool(abs(float(env_frames) - expected) < 0.5),
            "updates": int(step),
            "frames_per_update": int(frames_per_update),
            "env_frames": float(env_frames),
            "expected": expected,
        }

    final = {"ok": bool(ckpt.get("verified")), "step": step}
    if ckpt.get("error"):
        final["error"] = ckpt["error"]

    # A sentinel trip is "quiet" only if the schedule injected at least
    # that many sentinel-class faults.
    stray = [a for a in anomalies
             if isinstance(a.get("ts_unix"), (int, float))
             and not _in_windows(float(a["ts_unix"]), windows)]
    sentinel_budget = sum(1 for e in injected
                          if e.get("t_unix") is not None
                          and e.get("point") in SENTINEL_POINTS)
    quiet = {
        "ok": bool(not stray and sentinel_trips <= sentinel_budget),
        "stray_anomalies": [
            {"id": a.get("id"), "detector": a.get("detector"),
             "ts_unix": a.get("ts_unix")} for a in stray],
        "anomalies_total": len(anomalies),
        "sentinel_trips": sentinel_trips,
        "sentinel_trip_budget": sentinel_budget,
    }

    return {
        "throughput_floor": throughput,
        "mttr_ceiling": mttr,
        "frame_exactness": exactness,
        "final_checkpoint": final,
        "quiet_outside_windows": quiet,
    }


# -- the run's artifacts (torn-line tolerant) -----------------------------


def _read_jsonl(path: str) -> List[dict]:
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    rows = []
    for line in lines:
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict):
            rows.append(row)
    return rows


def _read_anomalies(logdir: str) -> List[dict]:
    """The last record of each anomaly id (``anomalies.jsonl`` is event
    sourced)."""
    by_id: Dict[str, dict] = {}
    for row in _read_jsonl(os.path.join(logdir, "anomalies.jsonl")):
        anomaly_id = row.get("id")
        if isinstance(anomaly_id, str):
            by_id[anomaly_id] = row
    return list(by_id.values())


_PROM_LINE = re.compile(
    r"^impala_([A-Za-z0-9_]+?)(?:\{[^}]*\})?\s+([0-9eE+.\-]+)\s*$")


def _read_prom_counters(logdir: str) -> Dict[str, float]:
    """{bare metric name: max value over its label variants} from the
    run's newest ``metrics.prom`` snapshot."""
    out: Dict[str, float] = {}
    try:
        with open(os.path.join(logdir, "metrics.prom")) as f:
            lines = f.read().splitlines()
    except OSError:
        return out
    for line in lines:
        match = _PROM_LINE.match(line.strip())
        if not match:
            continue
        try:
            value = float(match.group(2))
        except ValueError:
            continue
        name = match.group(1)
        out[name] = max(out.get(name, value), value)
    return out


def _inspect_final_checkpoint(logdir: str) -> dict:
    """The walk-back restore of the run's newest verified checkpoint
    (``runtime/checkpoint.py``): {"verified", "step", "env_frames",
    "error"}."""
    from scalable_agent_tpu_torch.runtime.checkpoint import (
        CheckpointIntegrityError,
        CheckpointManager,
    )

    info = {"verified": False, "step": None, "env_frames": None,
            "error": None}
    try:
        restored = CheckpointManager(logdir).restore()
    except CheckpointIntegrityError as exc:
        info["error"] = str(exc)
        return info
    except Exception as exc:  # grade it, do not crash the grader
        info["error"] = f"{type(exc).__name__}: {exc}"
        return info
    if restored is None:
        info["error"] = "no checkpoint on disk"
        return info
    step, state = restored
    info.update(verified=True, step=int(step),
                env_frames=float(state["env_frames"]))
    return info


# -- grading and the report ------------------------------------------------


def grade_soak(logdir: str, *, injected: Sequence[dict],
               planned: Sequence[dict], frames_per_update: int,
               throughput_floor: float = 0.8,
               mttr_ceiling_s: float = 180.0,
               warmup_until_unix: Optional[float] = None,
               meta: Optional[dict] = None) -> dict:
    """Read the run's artifacts (``metrics.jsonl``, ``fleet_epochs.jsonl``,
    ``anomalies.jsonl``, ``metrics.prom``, the checkpoints), grade every
    invariant and return the report."""
    metrics_rows = _read_jsonl(os.path.join(logdir, "metrics.jsonl"))
    epoch_events = _read_jsonl(os.path.join(logdir, "fleet_epochs.jsonl"))
    mttr_events = [e for e in epoch_events if e.get("event") == "mttr"]
    anomalies = _read_anomalies(logdir)
    counters = _read_prom_counters(logdir)
    ckpt = _inspect_final_checkpoint(logdir)
    invariants = check_invariants(
        metrics_rows=metrics_rows,
        mttr_events=mttr_events,
        anomalies=anomalies,
        injected=injected,
        ckpt=ckpt,
        frames_per_update=frames_per_update,
        throughput_floor=throughput_floor,
        mttr_ceiling_s=mttr_ceiling_s,
        sentinel_trips=int(counters.get("sentinel_trips_total", 0)),
        warmup_until_unix=warmup_until_unix)
    report = {
        "schema_version": SOAK_SCHEMA_VERSION,
        "logdir": os.path.abspath(logdir),
        "pass": bool(all(v["ok"] for v in invariants.values())),
        "invariants": invariants,
        "injected": list(injected),
        "planned_not_injected": [e for e in planned
                                 if e.get("t_unix") is None],
        "points": sorted({e["point"] for e in injected
                          if e.get("t_unix") is not None}),
        "counters": {
            "faults_injected_total": counters.get(
                "faults_injected_total", 0.0),
            "sentinel_trips_total": counters.get(
                "sentinel_trips_total", 0.0),
            "watchdog_stalls_total": counters.get(
                "watchdog_stalls_total", 0.0),
        },
        "mttr_events": mttr_events,
        "checkpoint": ckpt,
    }
    report.update(meta or {})
    return report


def write_report(logdir: str, report: dict,
                 path: Optional[str] = None) -> str:
    """Write ``soak_report.json`` atomically (a temporary file, then a
    rename): a killed grader leaves no torn report."""
    path = path or os.path.join(logdir, SOAK_REPORT_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_soak_report(logdir: str) -> Optional[dict]:
    try:
        with open(os.path.join(logdir, SOAK_REPORT_NAME)) as f:
            report = json.load(f)
    except (OSError, ValueError):
        return None
    return report if isinstance(report, dict) else None


# -- the engine ------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker_command(config) -> List[str]:
    """The process the soak drives: the port's single-process driver."""
    return ([sys.executable, "-m", "scalable_agent_tpu_torch.driver"]
            + config.to_argv())


def _append_channel_line(logdir: str, event: dict) -> float:
    """Arm one injection in the running process; returns the stamped
    ``t_unix``."""
    t_unix = time.time()
    line = {"point": event["point"], "t_unix": t_unix}
    if event.get("proc") is not None:
        line["proc"] = int(event["proc"])
    with open(os.path.join(logdir, CHANNEL_NAME), "a") as f:
        f.write(json.dumps(line) + "\n")
        f.flush()
    return t_unix


def _updates_counted(logdir: str, since_unix: float) -> float:
    """The run's ``learner/updates_total`` in a ``metrics.prom`` written
    at or after ``since_unix`` (0 before the first)."""
    try:
        if os.path.getmtime(os.path.join(logdir, "metrics.prom")) \
                < since_unix:
            return 0.0
    except OSError:
        return 0.0
    return _read_prom_counters(logdir).get("learner_updates_total", 0.0)


def run_soak(config, *, seed: int = 0, num_faults: int = 6,
             budget_s: float = 120.0,
             points: Optional[Sequence[str]] = None,
             weights: Optional[Dict[str, float]] = None,
             throughput_floor: float = 0.8,
             mttr_ceiling_s: float = 180.0,
             recovery_s: Optional[Dict[str, float]] = None,
             drain_grace_s: float = 60.0,
             poll_s: float = 0.2,
             env: Optional[Dict[str, str]] = None,
             report_path: Optional[str] = None,
             start_timeout_s: float = 600.0,
             land_timeout_s: float = 60.0) -> dict:
    """Run one seeded soak of ``config`` (a ``--mode=train`` run) and
    return the graded report (also written to
    ``<logdir>/soak_report.json``).

    The schedule's clock starts at the run's first update (waited for up
    to ``start_timeout_s``).  The run ends at its
    ``total_environment_frames`` or, ``budget_s`` later, at a SIGTERM
    sent once ``faults/injected_total`` counts every injected line (or
    ``land_timeout_s`` after the budget); the drain then has
    ``drain_grace_s`` before a kill.  Events not injected by then are
    reported under ``planned_not_injected``."""
    config = dataclasses.replace(config, chaos_channel=True)
    schedule = sample_schedule(seed, num_faults, budget_s, points=points,
                               weights=weights, recovery_s=recovery_s)
    os.makedirs(config.logdir, exist_ok=True)
    cmd = _worker_command(config)
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, run_env.get("PYTHONPATH")) if p)
    run_env.update(env or {})
    log.info("soak: launching %s (seed=%d, %d scheduled fault(s), "
             "budget %.0fs)", " ".join(cmd[:3]), seed, len(schedule),
             budget_s)
    launched_unix = time.time()
    proc = subprocess.Popen(cmd, env=run_env)
    pending = list(schedule)
    injected: List[dict] = []
    drain_sent = False
    started_unix = started = landed_s = None
    deadline = time.monotonic() + start_timeout_s
    try:
        while proc.poll() is None:
            now = time.monotonic()
            if started is None:
                if _updates_counted(config.logdir, launched_unix) >= 1:
                    started, started_unix = now, time.time()
                    log.info("soak: the run's first update landed %.1fs "
                             "after launch; the schedule starts",
                             started_unix - launched_unix)
                elif now > deadline:
                    log.error("soak: no update within %.0fs — killing",
                              start_timeout_s)
                    proc.kill()
                    break
                time.sleep(poll_s)
                continue
            elapsed = now - started
            while pending and pending[0]["t_s"] <= elapsed:
                # Stamp the schedule entry itself: grade_soak tells the
                # events never injected apart by the missing t_unix.
                event = pending.pop(0)
                event["t_unix"] = _append_channel_line(config.logdir,
                                                       event)
                injected.append(event)
                log.info("soak: t=%.1fs injected %r", elapsed,
                         event["point"])
            if not drain_sent and elapsed >= budget_s:
                landed = _read_prom_counters(config.logdir).get(
                    "faults_injected_total", 0.0) >= len(injected)
                if landed or elapsed >= budget_s + land_timeout_s:
                    if not landed:
                        log.error("soak: %d injected fault(s) did not all "
                                  "land in %.0fs", len(injected),
                                  land_timeout_s)
                    drain_sent = True
                    landed_s = round(elapsed - budget_s, 3)
                    log.info("soak: budget reached — draining the run to "
                             "its final checkpoint")
                    try:
                        proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
            if drain_sent and elapsed >= budget_s + landed_s \
                    + drain_grace_s:
                log.error("soak: drain grace exhausted — killing")
                proc.kill()
                break
            time.sleep(poll_s)
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    finished_unix = time.time()
    report = grade_soak(
        config.logdir, injected=injected, planned=schedule,
        frames_per_update=config.frames_per_update(),
        throughput_floor=throughput_floor, mttr_ceiling_s=mttr_ceiling_s,
        warmup_until_unix=(None if started_unix is None else
                           started_unix + budget_s * SCHEDULE_WARMUP_FRAC),
        meta={
            "seed": seed,
            "num_faults": num_faults,
            "budget_s": budget_s,
            "num_processes": 1,
            "mode": "single",
            "worker_rc": rc,
            "drained": drain_sent,
            "launched_unix": round(launched_unix, 3),
            "started_unix": (None if started_unix is None
                             else round(started_unix, 3)),
            "land_wait_s": landed_s,
            "wall_s": round(finished_unix - launched_unix, 3),
        })
    path = write_report(config.logdir, report, path=report_path)
    log.info("soak: %s — report at %s",
             "PASS" if report["pass"] else "FAIL", path)
    return report


# -- CLI -------------------------------------------------------------------


def _format_report(report: dict) -> str:
    lines = [
        f"chaos soak: {'PASS' if report.get('pass') else 'FAIL'} "
        f"(seed={report.get('seed')}, mode={report.get('mode')}, "
        f"wall {report.get('wall_s')}s, worker rc "
        f"{report.get('worker_rc')})",
        f"  injected: {len(report.get('injected', []))} event(s) "
        f"across points {report.get('points')}",
    ]
    for name, verdict in sorted(report.get("invariants", {}).items()):
        evidence = {k: v for k, v in verdict.items() if k != "ok"}
        lines.append(
            f"  [{'ok' if verdict.get('ok') else 'FAIL'}] {name}: "
            f"{json.dumps(evidence, sort_keys=True)}")
    skipped = report.get("planned_not_injected") or []
    if skipped:
        lines.append(f"  note: {len(skipped)} scheduled event(s) "
                     f"never injected (run ended first)")
    return "\n".join(lines)


def _recovery_overrides(text: str) -> Optional[Dict[str, float]]:
    """``point=seconds,...`` over ``DEFAULT_RECOVERY_S``; None for ""."""
    if not text:
        return None
    recovery = dict(DEFAULT_RECOVERY_S)
    for item in text.split(","):
        point, _, seconds = item.partition("=")
        if point.strip() not in CHAOS_POINTS or not seconds:
            raise ValueError(f"--soak_recovery_s entry {item!r}: expected "
                             f"point=seconds over the chaos registry")
        recovery[point.strip()] = float(seconds)
    return recovery


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m scalable_agent_tpu_torch.runtime.soak run|report``."""
    import logging

    from scalable_agent_tpu_torch.config import Config

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="python -m scalable_agent_tpu_torch.runtime.soak",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        allow_abbrev=False)
    parser.add_argument("command", choices=("run", "report"))
    parser.add_argument("--soak_seed", type=int, default=0)
    parser.add_argument("--soak_faults", type=int, default=6)
    parser.add_argument("--soak_budget_s", type=float, default=120.0)
    parser.add_argument(
        "--soak_points", type=str, default="",
        help="comma-separated chaos points to sample, each at its default "
             "weight or 1 where that is 0 (default: every positive-weight "
             "single-process point)")
    parser.add_argument(
        "--soak_recovery_s", type=str, default="",
        help="comma-separated point=seconds recovery windows over the "
             "defaults (the JAX package's, sized for a TPU re-jit)")
    parser.add_argument("--soak_floor", type=float, default=0.8)
    parser.add_argument("--soak_mttr_ceiling_s", type=float,
                        default=180.0)
    parser.add_argument("--soak_report", type=str, default="",
                        help="report path (default "
                             "<logdir>/soak_report.json)")
    parser.add_argument("--logdir", type=str, default="",
                        help="(report) the soaked run's logdir")
    args, rest = parser.parse_known_args(argv)

    if args.command == "report":
        logdir = args.logdir or (rest[0] if rest else "")
        if not logdir:
            parser.error("report needs --logdir")
        report = read_soak_report(logdir)
        if report is None:
            print(f"no {SOAK_REPORT_NAME} under {logdir}")
            return 1
        print(_format_report(report))
        return 0 if report.get("pass") else 1

    if args.logdir:
        rest = [f"--logdir={args.logdir}"] + rest
    config = Config.from_argv(
        rest, description="chaos soak run config (the driver's flags)")
    if config.mode != "train":
        raise ValueError("the soak engine drives --mode=train runs")
    points = ([p.strip() for p in args.soak_points.split(",")
               if p.strip()] or None)
    # A point named in --soak_points is opted in: the weight-0 points
    # (the sentinel's, service_stall, replay_corrupt) take weight 1 there,
    # where the JAX CLI keeps their 0 and never samples them.
    weights = (None if points is None else
               {p: DEFAULT_WEIGHTS.get(p) or 1.0 for p in points})
    report = run_soak(
        config, seed=args.soak_seed, num_faults=args.soak_faults,
        budget_s=args.soak_budget_s, points=points, weights=weights,
        throughput_floor=args.soak_floor,
        mttr_ceiling_s=args.soak_mttr_ceiling_s,
        recovery_s=_recovery_overrides(args.soak_recovery_s),
        report_path=args.soak_report or None)
    print(_format_report(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
