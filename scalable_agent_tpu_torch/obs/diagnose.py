"""``python -m scalable_agent_tpu_torch.obs.diagnose <logdir>`` — the
learning-dynamics verdict.

A copy of ``scalable_agent_tpu/obs/diagnose.py``.  Reads a run's on-disk
artifacts (``metrics*.prom`` snapshots, ``metrics.jsonl`` interval rows,
``anomalies.jsonl``) — it imports neither torch nor jax, so run it on a
laptop — and answers the question the loss curve can't: is the
POLICY healthy?  Renders the learning-dynamics metric table
(off-policy clip fractions, importance-weight ESS, entropy, KL, value
explained-variance, per-layer update ratios), applies the
obs/learning.py rules, names any anomaly records the health plane
already wrote for the same failure, and states the measured
staleness→clipping relationship when replay ran.  Its ``impact`` section
reads a ``--loss=impact`` run's ``devtel/learn/impact_*`` families.

Exit status: 0 when every rule passes, 1 when any verdict fired (CI
can gate on a clean diagnosis), 2 on operator error (missing logdir /
no metrics snapshot — the obs.report convention).
"""

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from scalable_agent_tpu_torch.obs import learning
from scalable_agent_tpu_torch.obs.health import read_anomalies
from scalable_agent_tpu_torch.obs.report import _load_families, _value

__all__ = ["build_diagnosis", "main", "render_diagnosis"]

# Metric-table rows: (short key, label, format).
_TABLE = (
    ("entropy_frac", "entropy (normalized)", ".3f"),
    ("kl", "KL(behaviour || learner)", ".4f"),
    ("ess_frac", "importance-weight ESS", ".3f"),
    ("explained_variance", "value explained-variance", ".3f"),
    ("rho_clip_fraction", "rho clip fraction", ".3f"),
    ("cs_clip_fraction", "c-bar clip fraction", ".3f"),
    ("pg_rho_clip_fraction", "pg-rho clip fraction", ".3f"),
    ("log_rho_mean", "log importance ratio (mean)", "+.4f"),
    ("log_rho_p95", "log importance ratio (p95)", "+.4f"),
    ("dead_torso_frac", "dead torso units", ".3f"),
)

# The health-plane detectors that mirror diagnose verdicts: a verdict
# plus its anomaly record is the full story (device trips live, the
# CLI re-derives it from artifacts).
_DETECTOR_FOR_VERDICT = {
    "entropy_collapse": "entropy_collapse",
    "off_policy_saturated": "clip_saturation",
}


def build_diagnosis(logdir: str) -> dict:
    """The machine-readable diagnosis (the ``--json`` payload)."""
    families, source = _load_families(logdir)
    readings: Dict[str, Optional[float]] = {
        name: _value(families, name)
        for name in learning.LEARNING_GAUGES.values()}
    snapshot = learning.extract_snapshot(readings)
    verdicts = learning.derive_verdicts(snapshot)
    anomalies = read_anomalies(logdir)
    by_detector = {}
    for record in anomalies:
        by_detector.setdefault(record.get("detector"), []).append(
            {"id": record.get("id"), "update": record.get("update"),
             "observed": record.get("observed"),
             "flightrec": record.get("flightrec")})
    for verdict in verdicts:
        detector = _DETECTOR_FOR_VERDICT.get(verdict["name"])
        verdict["anomalies"] = by_detector.get(detector) or []
    # The numerics sentinel (runtime/sentinel.py) reports through the
    # same verdict channel: a trip means the shadow audit or the
    # cross-process fingerprint caught the optimized hot path producing
    # silently-wrong numbers — a run can look healthy on every
    # learning-dynamics rule and still be poisoned, so a trip is never
    # ignorable.
    sentinel = {}
    for short, name in (
            ("trips", "sentinel/trips_total"),
            ("demotions", "sentinel/demotions_total"),
            ("fingerprint_mismatches",
             "sentinel/fingerprint_mismatch_total"),
            ("rung", "sentinel/rung"),
            ("audits", "devtel/sentinel/audits_total"),
            ("breaches", "devtel/sentinel/breaches_total"),
            ("max_deviation", "devtel/sentinel/max_deviation")):
        value = _value(families, name)
        if value is not None:
            sentinel[short] = value
    if sentinel.get("trips"):
        verdicts.append({
            "name": "sentinel_tripped", "severity": "critical",
            "observed": sentinel["trips"], "limit": 0.0,
            "evidence": dict(sentinel),
            "remedy": (
                "the numerics sentinel caught silent corruption on "
                "the optimized hot path: read the pinned flight "
                "recorder dump (reason sentinel_trip:*), check "
                "sentinel/rung for where the degradation ladder "
                "settled, and requalify the demoted backend "
                "(runtime/sentinel.py, the ladder) before promoting it "
                "back"),
            "anomalies": []})
    impact = {}
    for short, name in (
            ("ratio_mean", "devtel/learn/impact_ratio/mean"),
            ("clip_fraction_mean",
             "devtel/learn/impact_clip_fraction/mean"),
            ("updates_observed", "devtel/learn/impact_ratio/count"),
            ("log_ratio_p95", "devtel/learn/impact_log_ratio_p95"),
            ("ess_frac", "devtel/learn/impact_ess_frac")):
        value = _value(families, name)
        if value is not None:
            impact[short] = value
    rows = learning.read_interval_rows(logdir)
    return {
        "logdir": logdir,
        "source": source,
        "snapshot": snapshot,
        "impact": impact or None,
        "sentinel": sentinel or None,
        "verdicts": verdicts,
        "clean": not verdicts,
        "staleness_clip": learning.staleness_clip_relationship(rows),
    }


def render_diagnosis(diagnosis: dict) -> str:
    lines = [f"Learning-dynamics diagnosis — {diagnosis['logdir']}",
             f"source: {diagnosis['source']}", ""]
    snapshot = diagnosis["snapshot"]
    if not snapshot:
        lines.append(
            "no devtel/learn/* readings in the snapshot — the run "
            "predates the learning-dynamics plane or ran with "
            "--learn_telemetry=false")
        if not diagnosis["verdicts"]:
            return "\n".join(lines) + "\n"
        # A sentinel trip must surface even without the learning
        # plane's table — fall through to the verdict section.
        lines.append("")
    for key, label, fmt in _TABLE:
        if key in snapshot:
            lines.append(f"  {label:<32}{format(snapshot[key], fmt)}")
    groups = [g for g in learning.LAYER_GROUPS
              if f"update_ratio_{g}" in snapshot]
    if groups:
        lines.append("")
        header = (f"  {'layer group':<14}{'grad norm':>12}"
                  f"{'param norm':>12}{'update/param':>14}")
        lines.append(header)
        lines.append("  " + "-" * (len(header) - 2))
        for group in groups:
            lines.append(
                f"  {group:<14}"
                f"{snapshot.get(f'grad_norm_{group}', float('nan')):>12.4g}"
                f"{snapshot.get(f'param_norm_{group}', float('nan')):>12.4g}"
                f"{snapshot[f'update_ratio_{group}']:>14.3g}")
    impact = diagnosis.get("impact")
    if impact:
        lines.append("")
        parts = []
        if "ratio_mean" in impact:
            parts.append(f"ratio mean {impact['ratio_mean']:.4f}")
        if "clip_fraction_mean" in impact:
            parts.append(
                f"clip fraction {impact['clip_fraction_mean']:.3f}")
        if "updates_observed" in impact:
            parts.append(
                f"over {impact['updates_observed']:.0f} updates")
        lines.append("  IMPACT anchor: " + ", ".join(parts))
    sentinel = diagnosis.get("sentinel")
    if sentinel:
        lines.append("")
        lines.append(
            "  numerics sentinel: "
            f"audits {sentinel.get('audits', 0):.0f}, "
            f"breaches {sentinel.get('breaches', 0):.0f}, "
            f"trips {sentinel.get('trips', 0):.0f}, "
            f"ladder rung {sentinel.get('rung', 0):.0f}")
    relation = diagnosis.get("staleness_clip")
    if relation:
        lines.append("")
        lines.append("  staleness→clipping: " + relation["statement"])
    lines.append("")
    verdicts = diagnosis["verdicts"]
    if not verdicts:
        lines.append("verdict: clean — every learning-dynamics rule "
                     "passes")
    else:
        lines.append(f"verdict: {len(verdicts)} rule(s) fired")
        for verdict in verdicts:
            lines.append(
                f"  [{verdict['severity']}] {verdict['name']}: "
                f"observed {verdict['observed']:.4g} vs limit "
                f"{verdict['limit']:.4g}")
            lines.append(f"      remedy: {verdict['remedy']}")
            for anomaly in verdict.get("anomalies") or []:
                dump = (anomaly.get("flightrec") or {}).get("dump")
                lines.append(
                    f"      anomaly {anomaly.get('id')} at update "
                    f"{anomaly.get('update')}"
                    + (f" (flightrec dump: {dump})" if dump else ""))
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Diagnose a run's learning dynamics (clip "
                    "fractions, ESS, entropy, KL, explained variance, "
                    "per-layer update ratios) from its logdir "
                    "artifacts and apply the obs/learning.py verdict "
                    "rules.  Imports neither torch nor jax.  Exits 1 when a "
                    "verdict fired.")
    parser.add_argument("logdir", help="run log directory")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable diagnosis")
    args = parser.parse_args(argv)
    try:
        diagnosis = build_diagnosis(args.logdir)
    except FileNotFoundError as exc:
        print(f"obs.diagnose: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(diagnosis, indent=1))
    else:
        print(render_diagnosis(diagnosis), end="")
    return 0 if diagnosis["clean"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
