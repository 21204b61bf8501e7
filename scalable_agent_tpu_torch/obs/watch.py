"""The live run-health console: one refreshing screen per logdir.

A copy of ``scalable_agent_tpu/obs/watch.py``::

    python -m scalable_agent_tpu_torch.obs.watch <logdir>
    python -m scalable_agent_tpu_torch.obs.watch <logdir> --once --json

Tails the run's on-disk artifacts — ``metrics*.prom`` (folded across
processes with obs/aggregate.py's rules when no fleet snapshot
exists), ``anomalies.jsonl`` (obs/health.py), ``fleet_epochs.jsonl``
(written by the JAX package's elastic fleet, read when present) — and
renders a one-screen health summary: fps, the stall verdict + dominant
stage, staleness, MFU, open anomalies, fleet size.  ``--once --json``
emits the same payload as one machine-readable object (the ``/health``
HTTP endpoint serves it too).

The JAX console also sets fps against the newest committed BENCH round;
those are TPU rounds and the port has none of its own yet, so
``baseline`` is ``None`` and ``--bench_dir`` takes no directory (exit 2;
ROADMAP.md, queue 1, item 2).

It imports neither torch nor jax: it runs on a laptop against logdirs
copied off the card, or next to a live run (the driver's prom snapshot
and anomaly log are append/replace-atomic, so tailing mid-run is safe).
"""

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence

from scalable_agent_tpu_torch.obs.health import read_anomalies
from scalable_agent_tpu_torch.obs.ledger import SEGMENT_LABELS, SEGMENTS
from scalable_agent_tpu_torch.obs.report import (
    _load_families,
    _rounds,
    _value,
)
from scalable_agent_tpu_torch.obs.stall import CATEGORIES

__all__ = ["build_payload", "main", "render"]

SCHEMA_VERSION = 1
FLEET_EPOCHS_JSONL = "fleet_epochs.jsonl"


def _last_fleet_event(logdir: str) -> Optional[dict]:
    path = os.path.join(logdir, FLEET_EPOCHS_JSONL)
    try:
        lines = open(path).read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if not line:
            continue
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail line
    return None


def build_payload(logdir: str,
                  bench_dir: Optional[str] = None,
                  tail: int = 5) -> dict:
    """Everything the console renders, as one JSON-able object.
    Raises ``FileNotFoundError`` on a missing or metrics-free logdir
    (the CLI turns that into exit 2)."""
    if not os.path.isdir(logdir):
        raise FileNotFoundError(f"no such logdir: {logdir}")
    families, source = _load_families(logdir)

    verdict = None
    for category in CATEGORIES:
        if _value(families, f"stall/is_{category}") == 1.0:
            verdict = category
    shares = {}
    for name, _, _ in SEGMENTS:
        share = _value(families, f"ledger/latency_share/{name}")
        if share is not None:
            shares[name] = share
    dominant = max(shares, key=shares.get) if shares else None

    anomalies = read_anomalies(logdir)
    open_anomalies = [
        a for a in anomalies
        if (a.get("window") or {}).get("status") in ("armed", "open")]

    learner_fps = _value(families, "learner/fps")
    baseline = _rounds(bench_dir)

    payload = {
        "schema_version": SCHEMA_VERSION,
        "logdir": logdir,
        "source": source,
        "generated_unix": time.time(),
        "fps": {
            "learner": learner_fps,
            "actor": _value(families, "actor/fps"),
            "env_frames_total": _value(families,
                                       "learner/env_frames_total"),
            "vs_baseline": None,
        },
        "baseline": baseline,
        "verdict": {
            "category": verdict,
            "dominant_segment": dominant,
            "dominant_share": shares.get(dominant) if dominant else None,
        },
        "staleness_p95_s": _value(families, "ledger/staleness_s",
                                  quantile="0.95"),
        "mfu": _value(families, "ledger/mfu"),
        "nonfinite_skips": _value(families,
                                  "learner/nonfinite_skips_total"),
        "fleet": {
            "peers_alive": _value(families, "fleet/peers_alive"),
            "last_event": _last_fleet_event(logdir),
        },
        "health": {
            "anomalies": len(anomalies),
            "open": len(open_anomalies),
            "suppressed": _value(families, "health/suppressed_total"),
            "profile_windows": _value(families,
                                      "health/profile_windows_total"),
            "recent": anomalies[-tail:],
        },
    }
    # The learning panel (obs/learning.py over devtel/learn/*):
    # snapshot + live rule verdicts; None when the run predates the
    # plane or disabled it.
    from scalable_agent_tpu_torch.obs import learning
    learn_snapshot = learning.extract_snapshot({
        name: _value(families, name)
        for name in learning.LEARNING_GAUGES.values()})
    payload["learning"] = {
        "snapshot": learn_snapshot,
        "verdicts": learning.derive_verdicts(learn_snapshot),
    } if learn_snapshot else None
    return payload


def _fmt(value, spec: str = ".0f", unit: str = "") -> str:
    if value is None:
        return "-"
    return format(value, spec) + unit


def render(payload: dict) -> str:
    """The one-screen text view of ``build_payload``'s object."""
    lines: List[str] = []
    stamp = time.strftime("%H:%M:%S",
                          time.localtime(payload["generated_unix"]))
    lines.append(f"run health — {payload['logdir']}  "
                 f"[{payload['source']} @ {stamp}]")
    fps = payload["fps"]
    fps_line = (f"fps        learner {_fmt(fps['learner'])}   "
                f"actor {_fmt(fps['actor'])}   "
                f"frames {_fmt(fps['env_frames_total'])}")
    lines.append(fps_line)
    verdict = payload["verdict"]
    if verdict["category"] or verdict["dominant_segment"]:
        where = ""
        if verdict["dominant_segment"]:
            label = SEGMENT_LABELS.get(verdict["dominant_segment"],
                                       verdict["dominant_segment"])
            share = verdict["dominant_share"]
            where = (f" — {share:.0%} of frame latency in {label}"
                     if share is not None else f" — {label}")
        lines.append(f"verdict    {verdict['category'] or 'n/a'}{where}")
    lines.append(
        f"pipeline   staleness p95 {_fmt(payload['staleness_p95_s'], '.3f', 's')}"
        f"   mfu {_fmt(payload['mfu'], '.3f')}"
        f"   nonfinite skips {_fmt(payload['nonfinite_skips'])}")
    fleet = payload["fleet"]
    if fleet["peers_alive"] is not None or fleet["last_event"]:
        event = fleet["last_event"] or {}
        extra = ""
        if event:
            extra = (f"   epoch {event.get('epoch', '-')}"
                     f" ({event.get('event', event.get('kind', '?'))})")
        lines.append(
            f"fleet      peers {_fmt(fleet['peers_alive'])}{extra}")
    learning_panel = payload.get("learning")
    if learning_panel:
        snapshot = learning_panel["snapshot"]
        parts = []
        for key, label, spec in (("entropy_frac", "entropy", ".3f"),
                                 ("kl", "KL", ".4f"),
                                 ("ess_frac", "ESS", ".3f"),
                                 ("explained_variance", "EV", ".3f"),
                                 ("rho_clip_fraction", "rho-clip", ".3f"),
                                 ("dead_torso_frac", "dead", ".3f")):
            if key in snapshot:
                parts.append(f"{label} {format(snapshot[key], spec)}")
        if parts:
            lines.append("learning   " + "   ".join(parts))
        ratios = [f"{group} {snapshot[f'update_ratio_{group}']:.2g}"
                  for group in ("torso", "core", "heads")
                  if f"update_ratio_{group}" in snapshot]
        if ratios:
            lines.append("           update/param " + "  ".join(ratios))
        for verdict in learning_panel["verdicts"]:
            lines.append(
                f"  !! {verdict['name']} [{verdict['severity']}]: "
                f"{_fmt(verdict['observed'], '.4g')} vs limit "
                f"{_fmt(verdict['limit'], '.4g')}")
    health = payload["health"]
    lines.append(
        f"anomalies  {health['anomalies']} total"
        f" ({health['open']} open,"
        f" {_fmt(health['suppressed'])} suppressed,"
        f" {_fmt(health['profile_windows'])} profile windows)")
    for record in health["recent"]:
        window = record.get("window") or {}
        status = window.get("status", "-")
        line = (f"  {record.get('id', '?'):<22} "
                f"{record.get('metric', '?')} "
                f"{_fmt(record.get('observed'), '.4g')} vs "
                f"{_fmt(record.get('baseline'), '.4g')}")
        z = record.get("z")
        if isinstance(z, (int, float)):
            line += f" (z {z:.1f})"
        line += f"  window {status}"
        if window.get("worst_kernel"):
            line += (f" → {window['worst_kernel']} mfu "
                     f"{_fmt(window.get('worst_kernel_mfu'), '.3f')}")
            delta = window.get("worst_kernel_mfu_delta")
            if isinstance(delta, (int, float)):
                line += f" (Δ {delta:+.3f})"
        lines.append(line)
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Live one-screen run-health console over a logdir's "
                    "prom/anomaly/fleet artifacts.  Imports neither torch "
                    "nor jax.")
    parser.add_argument("logdir", help="run log directory")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds")
    parser.add_argument("--once", action="store_true",
                        help="render one frame and exit")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable payload "
                             "(implies --once)")
    parser.add_argument("--bench_dir", default=None,
                        help="a directory of the port's benchmark rounds: "
                             "there are none yet (ROADMAP.md, queue 1, "
                             "item 2), so a directory exits 2")
    parser.add_argument("--tail", type=int, default=5,
                        help="recent anomaly records shown")
    args = parser.parse_args(argv)

    def frame() -> str:
        payload = build_payload(args.logdir, bench_dir=args.bench_dir,
                                tail=args.tail)
        if args.json:
            return json.dumps(payload, indent=1) + "\n"
        return render(payload)

    try:
        if args.once or args.json:
            sys.stdout.write(frame())
            return 0
        while True:
            text = frame()
            sys.stdout.write("\x1b[2J\x1b[H" + text)
            sys.stdout.flush()
            time.sleep(args.interval)
    except (FileNotFoundError, ValueError) as exc:
        print(f"obs.watch: {exc}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
