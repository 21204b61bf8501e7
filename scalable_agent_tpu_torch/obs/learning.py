"""The learning-dynamics rules: devtel/learn/* readings -> verdicts.

A copy of ``scalable_agent_tpu/obs/learning.py``.  The learner
(``runtime/learner.py`` ``learning_telemetry_spec``) keeps the off-policy
clip diagnostics, policy entropy and KL, value explained variance and
per-group optimizer health on the card; this module holds the host-side
rules over the published numbers: ``derive_verdicts`` over a snapshot
(``extract_snapshot``), the interval rows of ``metrics.jsonl``
(``read_interval_rows``) and the measured staleness->clipping
relationship.  The health plane (``obs/health.py``) reads its
``MATERIAL_LOG_RHO``; ``LAYER_GROUPS`` is the port's one list of
parameter groups (``convert.layer_group`` sorts parameters into it).

Verdict rules (the thresholds are module constants):

- ``entropy_collapse``: normalized entropy < 5%: the policy is
  near-deterministic.
- ``value_divergence``: explained variance < -0.5: the baseline predicts
  the V-trace targets worse than their mean.
- ``off_policy_saturated``: rho clip fraction > 90% (with material drift:
  log_rho_p95 >= 0.1) or importance-weight ESS < 10%.
- ``update_ratio_out_of_band``: a layer group's |update|/|param| ratio
  above 0.1 (only the upper edge: the lr schedule anneals the ratio to
  zero at the end of a run).
- ``dead_torso``: > 90% of conv-torso output units dead across the batch.
"""

import json
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence

__all__ = [
    "DEAD_TORSO_LIMIT",
    "ENTROPY_COLLAPSE_LIMIT",
    "ESS_FLOOR",
    "LAYER_GROUPS",
    "LEARNING_GAUGES",
    "MATERIAL_LOG_RHO",
    "RHO_CLIP_SATURATION_LIMIT",
    "UPDATE_RATIO_BAND",
    "derive_verdicts",
    "extract_snapshot",
    "read_interval_rows",
    "staleness_clip_relationship",
]

# Registry names of the learning-dynamics plane, keyed by short name
# (runtime/learner.py learning_telemetry_spec gauges).
LAYER_GROUPS = ("torso", "core", "heads")
LEARNING_GAUGES: Dict[str, str] = {
    "entropy_frac": "devtel/learn/entropy_frac",
    "kl": "devtel/learn/kl",
    "ess_frac": "devtel/learn/ess_frac",
    "explained_variance": "devtel/learn/explained_variance",
    "rho_clip_fraction": "devtel/learn/rho_clip_fraction",
    "cs_clip_fraction": "devtel/learn/cs_clip_fraction",
    "pg_rho_clip_fraction": "devtel/learn/pg_rho_clip_fraction",
    "log_rho_mean": "devtel/learn/log_rho_mean",
    "log_rho_p95": "devtel/learn/log_rho_p95",
    "dead_torso_frac": "devtel/learn/dead_torso_frac",
    **{f"{stat}_{group}": f"devtel/learn/{stat}_{group}"
       for group in LAYER_GROUPS
       for stat in ("grad_norm", "param_norm", "update_ratio")},
}

# Verdict thresholds (the JAX package's docs/observability.md documents
# each; obs/health.py's entropy_collapse/clip_saturation detectors use
# the same limits).
ENTROPY_COLLAPSE_LIMIT = 0.05
VALUE_DIVERGENCE_LIMIT = -0.5
RHO_CLIP_SATURATION_LIMIT = 0.9
# Clip-fraction alarms additionally require the drift to be MATERIAL:
# log_rho_p95 >= 0.1 (p95 ratio >= ~1.105).  The clip fraction counts
# strictly-above-threshold rhos, so a near-on-policy batch whose
# ratios all sit at 1.0001 reads clip fraction 1.0 while the clip
# removes essentially nothing (observed in a healthy tiny-batch run);
# the p95 gate separates that rounding artifact from real drift.
MATERIAL_LOG_RHO = 0.1
ESS_FLOOR = 0.1
# The healthy |update|/|param| band; only breaching the UPPER edge is
# a verdict (see the module docstring).
UPDATE_RATIO_BAND = (1e-6, 0.1)
DEAD_TORSO_LIMIT = 0.9


def _finite(value) -> Optional[float]:
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if math.isfinite(value) else None


def extract_snapshot(metrics: Mapping[str, float]) -> Dict[str, float]:
    """Pull the learning-dynamics readings out of any flat metric
    mapping (a registry snapshot, or a metrics.jsonl ``obs/`` row with
    the prefix stripped), short-keyed."""
    out: Dict[str, float] = {}
    for short, name in LEARNING_GAUGES.items():
        value = _finite(metrics.get(name))
        if value is not None:
            out[short] = value
    return out


def derive_verdicts(snapshot: Mapping[str, float]) -> List[dict]:
    """The rule pass: learning-dynamics readings → zero or more
    verdict records ``{name, severity, observed, limit, evidence,
    remedy}``.  A reading that is absent simply cannot fire its rule —
    a run without the plane diagnoses clean, not broken."""
    verdicts: List[dict] = []

    def fire(name, severity, observed, limit, evidence, remedy):
        verdicts.append({
            "name": name, "severity": severity,
            "observed": observed, "limit": limit,
            "evidence": evidence, "remedy": remedy})

    entropy_frac = snapshot.get("entropy_frac")
    if entropy_frac is not None and entropy_frac < ENTROPY_COLLAPSE_LIMIT:
        fire("entropy_collapse", "critical", entropy_frac,
             ENTROPY_COLLAPSE_LIMIT,
             {"entropy_frac": entropy_frac, "kl": snapshot.get("kl")},
             "the policy is near-deterministic: raise --entropy_cost, "
             "lower --learning_rate, and check the run's "
             "anomalies.jsonl for the collapse onset")
    explained = snapshot.get("explained_variance")
    if explained is not None and explained < VALUE_DIVERGENCE_LIMIT:
        fire("value_divergence", "critical", explained,
             VALUE_DIVERGENCE_LIMIT,
             {"explained_variance": explained},
             "the baseline predicts V-trace targets worse than their "
             "mean: lower --learning_rate or --baseline_cost; a "
             "diverging critic poisons the pg advantages next")
    rho_clip = snapshot.get("rho_clip_fraction")
    ess = snapshot.get("ess_frac")
    log_p95 = snapshot.get("log_rho_p95")
    # The clip arm needs the drift to be material (see MATERIAL_LOG_RHO)
    # — a missing p95 cannot prove immateriality, so it does not gate.
    clip_fired = (rho_clip is not None
                  and rho_clip > RHO_CLIP_SATURATION_LIMIT
                  and (log_p95 is None or log_p95 >= MATERIAL_LOG_RHO))
    if clip_fired or (ess is not None and ess < ESS_FLOOR):
        fire("off_policy_saturated", "critical",
             rho_clip if clip_fired else ess,
             RHO_CLIP_SATURATION_LIMIT if clip_fired else ESS_FLOOR,
             {"rho_clip_fraction": rho_clip, "ess_frac": ess,
              "log_rho_p95": snapshot.get("log_rho_p95")},
             "V-trace is discarding most of the data as too "
             "off-policy: lower --replay_ratio, shorten "
             "--target_update_interval (IMPACT), or feed fresher "
             "batches")
    _, ratio_high = UPDATE_RATIO_BAND
    for group in LAYER_GROUPS:
        ratio = snapshot.get(f"update_ratio_{group}")
        if ratio is not None and ratio > ratio_high:
            fire("update_ratio_out_of_band", "warn", ratio, ratio_high,
                 {"group": group, "update_ratio": ratio,
                  "grad_norm": snapshot.get(f"grad_norm_{group}"),
                  "param_norm": snapshot.get(f"param_norm_{group}")},
                 f"the {group} group's step/|param| ratio is "
                 "divergence-scale: lower --learning_rate")
    dead = snapshot.get("dead_torso_frac")
    if dead is not None and dead > DEAD_TORSO_LIMIT:
        fire("dead_torso", "critical", dead, DEAD_TORSO_LIMIT,
             {"dead_torso_frac": dead},
             "nearly every conv-torso unit is a dead ReLU: the "
             "representation collapsed — lower --learning_rate "
             "(usually follows an lr spike); recovery typically "
             "needs a rollback to a pre-collapse checkpoint")
    return verdicts


# -- the per-interval series (metrics.jsonl) ---------------------------------


def read_interval_rows(logdir: str) -> List[Dict[str, float]]:
    """The per-interval registry rows out of ``metrics.jsonl`` (the
    driver's ``writer.write_registry`` appends one ``obs/``-prefixed
    row per log interval, both backends).  Returns rows with the
    prefix stripped, torn trailing lines skipped."""
    path = os.path.join(logdir, "metrics.jsonl")
    try:
        lines = open(path).read().splitlines()
    except OSError:
        return []
    rows: List[Dict[str, float]] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue
        row = {key[len("obs/"):]: value
               for key, value in record.items()
               if key.startswith("obs/")}
        if row:
            row["step"] = record.get("step")
            rows.append(row)
    return rows


def staleness_clip_relationship(
        rows: Sequence[Mapping[str, float]],
        staleness_key: str = "ledger/staleness_replayed_s/p95",
        clip_key: str = "devtel/learn/rho_clip_fraction",
        min_points: int = 3) -> Optional[dict]:
    """The measured staleness→clipping relationship over a run's
    per-interval rows: Pearson r between replayed-frame staleness and
    the V-trace rho clip fraction, plus the least-squares slope (clip
    fraction per second of staleness).  None when fewer than
    ``min_points`` intervals carry both series, or either series is
    constant (r undefined)."""
    pairs = []
    for row in rows:
        staleness = _finite(row.get(staleness_key))
        clip = _finite(row.get(clip_key))
        if staleness is not None and clip is not None:
            pairs.append((staleness, clip))
    if len(pairs) < min_points:
        return None
    n = float(len(pairs))
    xs = [p[0] for p in pairs]
    ys = [p[1] for p in pairs]
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    var_x = sum((x - mean_x) ** 2 for x in xs)
    var_y = sum((y - mean_y) ** 2 for y in ys)
    if var_x <= 0.0 or var_y <= 0.0:
        return None
    cov = sum((x - mean_x) * (y - mean_y) for x, y in pairs)
    r = cov / math.sqrt(var_x * var_y)
    slope = cov / var_x
    return {
        "intervals": len(pairs),
        "staleness_key": staleness_key,
        "clip_key": clip_key,
        "pearson_r": r,
        "clip_per_staleness_s": slope,
        "staleness_mean_s": mean_x,
        "clip_mean": mean_y,
        "statement": (
            f"over {len(pairs)} intervals, replayed staleness and the "
            f"rho clip fraction correlate at r={r:+.2f}; each +1s of "
            f"staleness adds {slope:+.4f} clip fraction "
            f"(means: {mean_x:.3f}s staleness, {mean_y:.3f} clipped)"),
    }
