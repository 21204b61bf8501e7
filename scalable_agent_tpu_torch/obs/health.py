"""The run-health plane: online anomaly detection at log-interval cadence.

A copy of ``scalable_agent_tpu/obs/health.py``.  A ``HealthMonitor`` of
declarative online detectors runs at the driver's log cadence over the
registry's stream and the interval's metrics (env frames/s, update fps,
loss, grad norm, ``ledger/staleness_s`` p95, segment rho, the non-finite
skip rate, the learning gauges), and a tripped detector

1. appends a machine-readable record to ``<logdir>/anomalies.jsonl``
   (detector, metric, baseline, observed, z, the stall verdict and the
   ledger's dominant segment at trip time),
2. pins the flight recorder (``reason_pin``) and dumps it on a bounded
   helper thread, and
3. arms a bounded profile window: the driver (``driver._HealthPlane``)
   opens a ``torch.profiler`` window of ``--health_window_updates``
   updates, rate-limited by the cooldown and ``--health_max_windows``,
   and its kernel table ``kernels.<anomaly_id>.json`` (``obs/kernels.py``)
   and the worst kernel's delta against the run's scheduled
   ``--profile_dir`` window are written back into the record.

Three detector kinds:

- ``ewma``: EWMA mean/variance z-score, for level shifts (a throughput
  sag, a loss spike).  Trips on a large z with a material relative
  deviation, or on a decisive relative shift alone.
- ``cusum``: one-sided standardized CUSUM over the same EWMA baseline,
  for slow drifts.
- ``threshold``: hard invariants (non-finite skips at zero rate, the
  entropy and clip limits of ``obs/learning.py``).

Every detector is warm-up gated.  ``prime`` arms a baseline before the
warm-up ends from a round's numbers; the JAX package reads them from its
committed ``BENCH_r*.json`` (``prime_from_bench``), which are TPU rounds,
so the port does not (``--health_baseline_dir`` takes only ``""``).

The file is event-sourced: one JSON object per line, the last record per
``id`` wins (a second record is appended when the window completes, and
``flush()`` appends the final state of still-open records at teardown);
``read_anomalies`` reads it so.
"""

import dataclasses
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from scalable_agent_tpu_torch.obs.flightrec import get_flight_recorder
from scalable_agent_tpu_torch.obs.learning import MATERIAL_LOG_RHO
from scalable_agent_tpu_torch.obs.ledger import get_ledger
from scalable_agent_tpu_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
)

__all__ = [
    "ANOMALIES_JSONL",
    "DetectorSpec",
    "HealthMonitor",
    "default_detectors",
    "read_anomalies",
]

ANOMALIES_JSONL = "anomalies.jsonl"
SCHEMA_VERSION = 1

# The ledger segments whose occupancy ρ the segment_rho detector
# watches (obs/ledger.py SEGMENTS names).
_RHO_SEGMENTS = ("unroll", "backpressure", "queue_wait", "transport",
                 "staged_wait", "device")


@dataclasses.dataclass
class DetectorSpec:
    """One declarative online detector.

    ``metric`` is a registry-snapshot key (histograms expand to
    ``<name>/p95`` etc.), or a derived value via ``value_fn`` over the
    whole snapshot.  ``direction`` names the anomalous side.  With
    ``rate=True`` the cumulative counter is differentiated into a
    per-second rate before detection (the first sample only sets the
    reference)."""

    name: str
    metric: str
    kind: str = "ewma"              # ewma | cusum | threshold
    direction: str = "low"          # which side is anomalous
    warmup: int = 8                 # intervals before the detector arms
    alpha: float = 0.35             # EWMA smoothing for mean/variance
    z_threshold: float = 4.0
    # A relative deviation this large trips on its own (None = z only);
    # the z path additionally requires rel >= min_rel so a tiny-sigma
    # baseline can't alarm on noise.
    rel_threshold: Optional[float] = 0.6
    min_rel: float = 0.15
    sigma_floor_rel: float = 0.10   # sigma floor as a fraction of |mean|
    drift_k: float = 0.5            # CUSUM slack (sigmas)
    cusum_h: float = 6.0            # CUSUM decision threshold (sigmas)
    limit: Optional[float] = None   # threshold kind: fixed invariant
    limit_from_first: bool = False  # ... or learned from sample 1
    rate: bool = False
    window: bool = True             # a trip may arm an auto-profile window
    pin: bool = True                # a trip pins the flight recorder
    baseline_key: Optional[str] = None  # BENCH metric key for priming
    prime_ratio: float = 0.5        # primed trip when value < ratio*baseline
    value_fn: Optional[Callable[[Mapping[str, float]],
                                Optional[float]]] = None


class _OnlineDetector:
    """EWMA/CUSUM/threshold state machine behind one ``observe()``."""

    def __init__(self, spec: DetectorSpec):
        self.spec = spec
        self._n = 0
        self._mean: Optional[float] = None
        self._var = 0.0
        self._cusum = 0.0
        self._limit = spec.limit
        self._primed: Optional[float] = None

    def prime(self, baseline: float):
        """Arm the pre-warm-up baseline from a committed BENCH round."""
        self._primed = float(baseline)

    @property
    def primed_baseline(self) -> Optional[float]:
        return self._primed

    def _deviation(self, value: float, reference: float) -> float:
        """Signed deviation toward the anomalous side (> 0 = worse)."""
        if self.spec.direction == "low":
            return reference - value
        return value - reference

    def observe(self, value: float) -> Optional[dict]:
        """Feed one sample; a trip payload (baseline/z/rel/...) or
        None.  Statistics update on every sample, trip or not — the
        monitor adapts to a sustained new level instead of alarming
        forever (the cooldown handles the flap in between)."""
        spec = self.spec
        self._n += 1
        if spec.kind == "threshold":
            return self._observe_threshold(value)
        trip = None
        # Primed pre-warm-up check: the committed baseline stands in
        # for the not-yet-settled EWMA, catching a run that STARTS slow.
        if (self._primed is not None and self._n <= spec.warmup
                and spec.direction == "low"
                and value < spec.prime_ratio * self._primed):
            trip = {"baseline": self._primed, "observed": value,
                    "z": None,
                    "rel": self._deviation(value, self._primed)
                    / max(abs(self._primed), 1e-12),
                    "primed": True}
        mean = self._mean
        if mean is None:
            self._mean = float(value)
            return trip
        sigma = math.sqrt(max(self._var, 0.0))
        sigma_eff = max(sigma, spec.sigma_floor_rel * abs(mean), 1e-12)
        dev = self._deviation(value, mean)
        z = dev / sigma_eff
        rel = dev / max(abs(mean), 1e-12)
        warm = self._n > spec.warmup
        if trip is None and warm and dev > 0.0:
            if spec.kind == "ewma":
                fired = ((spec.rel_threshold is not None
                          and rel >= spec.rel_threshold)
                         or (z >= spec.z_threshold
                             and rel >= spec.min_rel))
                if fired:
                    trip = {"baseline": mean, "observed": value,
                            "z": z, "rel": rel, "primed": False}
        if spec.kind == "cusum":
            self._cusum = max(
                0.0, self._cusum + (z - spec.drift_k))
            if trip is None and warm and self._cusum >= spec.cusum_h:
                trip = {"baseline": mean, "observed": value,
                        "z": z, "rel": rel, "primed": False,
                        "cusum": self._cusum}
                self._cusum = 0.0  # re-arm: one trip per excursion
        # EWMA update (mean first, then variance of the residual).
        delta = value - mean
        self._mean = mean + spec.alpha * delta
        self._var = (1.0 - spec.alpha) * (
            self._var + spec.alpha * delta * delta)
        return trip

    def _observe_threshold(self, value: float) -> Optional[dict]:
        spec = self.spec
        if self._limit is None and spec.limit_from_first:
            self._limit = float(value)  # the invariant is "never worse
            return None                 # than first seen"
        if self._limit is None or self._n <= spec.warmup:
            return None
        breached = (value < self._limit if spec.direction == "low"
                    else value > self._limit)
        if not breached:
            return None
        return {"baseline": self._limit, "observed": value, "z": None,
                "rel": None, "primed": False}


def default_detectors(backend: str = "host",
                      warmup: int = 8,
                      alpha: float = 0.35,
                      z_threshold: float = 4.0,
                      rel_threshold: float = 0.6) -> List[DetectorSpec]:
    """The stock detector set over the registry stream both driver
    backends publish.  ``backend`` picks the BENCH baseline key the
    throughput detector primes from (the two backends report different
    fps metrics in committed rounds)."""

    def max_rho(snapshot: Mapping[str, float]) -> Optional[float]:
        values = [snapshot[f"ledger/rho/{seg}"] for seg in _RHO_SEGMENTS
                  if f"ledger/rho/{seg}" in snapshot]
        return max(values) if values else None

    def _material_clip_fraction(
            snapshot: Mapping[str, float]) -> Optional[float]:
        clip = snapshot.get("devtel/learn/rho_clip_fraction")
        if clip is None:
            return None
        p95 = snapshot.get("devtel/learn/log_rho_p95")
        # A missing p95 cannot prove immateriality, so it does not gate.
        if p95 is not None and p95 < MATERIAL_LOG_RHO:
            return 0.0
        return clip

    fps_key = ("ingraph_env_frames_per_sec" if backend == "ingraph"
               else "e2e_env_frames_per_sec")
    detectors = [
        # Level shifts in learner-side throughput: the r06 headline
        # metric.  Primed from the newest committed round so a run that
        # STARTS 2x slower than r05 trips before its own warm-up.
        DetectorSpec(
            name="throughput", metric="learner/fps", kind="ewma",
            direction="low", warmup=warmup, alpha=alpha,
            z_threshold=z_threshold, rel_threshold=rel_threshold,
            baseline_key=fps_key),
        # Loss spike (level shift) and divergence (slow drift).  Loss
        # crosses zero, so the relative path is meaningless — z only.
        DetectorSpec(
            name="loss_spike", metric="total_loss", kind="ewma",
            direction="high", warmup=warmup, alpha=alpha,
            z_threshold=max(z_threshold, 5.0), rel_threshold=None,
            min_rel=0.0, sigma_floor_rel=0.05),
        # The drift detector arms at DOUBLE warm-up: early training
        # loss legitimately climbs (value/entropy terms growing into
        # the objective), and a CUSUM armed against the first
        # intervals' baseline would faithfully flag that expected
        # movement.  Slow-drift detection can afford the patience.
        DetectorSpec(
            name="loss_drift", metric="total_loss", kind="cusum",
            direction="high", warmup=2 * warmup, alpha=alpha,
            sigma_floor_rel=0.05, window=False),
        DetectorSpec(
            name="grad_norm", metric="grad_norm", kind="ewma",
            direction="high", warmup=warmup, alpha=alpha,
            z_threshold=max(z_threshold, 5.0), rel_threshold=4.0,
            min_rel=0.5, window=False),
        # Pipeline decay: frames aging in flight, or one segment's
        # occupancy blowing up (ρ is Little's-law L for wait stages).
        # Both arm at DOUBLE warm-up like loss_drift: queue occupancy
        # and staleness baselines settle slowly — early intervals mix
        # compile-era backlog with steady state, and which segment
        # dominates the ρ max flips between scales — so a single
        # warm-up EWMA faithfully flags ordinary settling.
        DetectorSpec(
            name="staleness", metric="ledger/staleness_s/p95",
            kind="ewma", direction="high", warmup=2 * warmup,
            alpha=alpha, z_threshold=z_threshold, rel_threshold=2.0,
            min_rel=0.5),
        DetectorSpec(
            name="segment_rho", metric="segment_rho", kind="ewma",
            direction="high", warmup=2 * warmup, alpha=alpha,
            z_threshold=z_threshold, rel_threshold=2.0, min_rel=0.5,
            value_fn=max_rho),
        # Invariants.  The non-finite detector must NOT pin the flight
        # recorder: the nonfinite guard's own rollback/exit-71 path
        # sets its verdict reason, and health must not demote it.
        DetectorSpec(
            name="nonfinite", metric="learner/nonfinite_skips_total",
            kind="threshold", direction="high", limit=0.0, rate=True,
            warmup=0, window=False, pin=False),
        # The fleet monitor owns the peer-loss verdict (it pins and
        # exits 72 itself) — health records the anomaly for the
        # timeline without fighting over the pin.
        DetectorSpec(
            name="peers_alive", metric="fleet/peers_alive",
            kind="threshold", direction="low", limit_from_first=True,
            warmup=0, window=False, pin=False),
        # Learning-dynamics invariants over the devtel/learn gauges
        # (runtime/learner.py learning_telemetry_spec).  Hard
        # thresholds, not EWMA: an EWMA baseline ADAPTS to a policy
        # that collapses before warm-up completes and never trips.
        # entropy_frac is entropy normalized by the uniform policy's
        # (~1.0 at init); < 5% means the policy is near-deterministic —
        # the collapse the oversized-LR chaos run reproduces.
        DetectorSpec(
            name="entropy_collapse", metric="devtel/learn/entropy_frac",
            kind="threshold", direction="low", limit=0.05, warmup=0),
        # rho clip fraction > 0.9: V-trace is truncating nearly every
        # importance weight — the learner has drifted so far off the
        # behaviour data that updates are mostly thrown away (lower
        # --replay_ratio, or shorten --target_update_interval under
        # IMPACT).  The clip fraction counts strictly-above-threshold
        # rhos, so a near-on-policy batch whose ratios all sit at
        # 1.0001 reads 1.0 while the clip removes nothing — the
        # detector therefore requires MATERIAL drift (log_rho_p95 >=
        # learning.MATERIAL_LOG_RHO) before reading the fraction.
        DetectorSpec(
            name="clip_saturation",
            metric="devtel/learn/rho_clip_fraction",
            kind="threshold", direction="high", limit=0.9, warmup=0,
            window=False, value_fn=_material_clip_fraction),
    ]
    if backend == "host":
        detectors.insert(1, DetectorSpec(
            name="actor_throughput", metric="actor/fps", kind="ewma",
            direction="low", warmup=warmup, alpha=alpha,
            z_threshold=z_threshold, rel_threshold=rel_threshold,
            window=False))
    return detectors


def _jsonable(obj):
    """Best-effort conversion of numpy scalars / odd floats for the
    JSONL record (NaN/inf become strings — the file must stay parseable
    line-by-line)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, Mapping):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    try:
        value = float(obj)  # numpy scalars
        return value if math.isfinite(value) else repr(value)
    except (TypeError, ValueError):
        return str(obj)


class HealthMonitor:
    """Evaluates the detector set each log interval and runs the trip
    protocol (record → pin+dump → arm window).  The profiling window
    itself is the DRIVER's machinery — the monitor only arbitrates
    (budget, cooldown, one window at a time) through ``poll_window`` /
    ``note_window_open`` / ``note_window_result``."""

    def __init__(self,
                 detectors: Sequence[DetectorSpec],
                 logdir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 cooldown_s: float = 120.0,
                 max_windows: int = 2,
                 recorder=None,
                 dump_join_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self._registry = registry if registry is not None else get_registry()
        self._detectors = [(spec, _OnlineDetector(spec))
                           for spec in detectors]
        self._logdir = logdir
        self._path = (os.path.join(logdir, ANOMALIES_JSONL)
                      if logdir else None)
        self._cooldown_s = float(cooldown_s)
        self._max_windows = int(max_windows)
        self._recorder = recorder
        self._dump_join_s = float(dump_join_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_trip: Dict[str, float] = {}
        self._last_rate: Dict[str, Tuple[float, float]] = {}
        self._open: Dict[str, dict] = {}    # id -> live record
        self._pending_window: Optional[str] = None
        self._open_window: Optional[str] = None
        self._windows_opened = 0
        self._last_window_at: Optional[float] = None
        self._baseline_kernels: Optional[dict] = None
        self._baseline_source: Optional[str] = None
        reg = self._registry
        self._anomalies_total = reg.counter(
            "health/anomalies_total", "detector trips recorded")
        self._suppressed_total = reg.counter(
            "health/suppressed_total",
            "detector trips swallowed by the per-detector cooldown")
        self._windows_total = reg.counter(
            "health/profile_windows_total",
            "anomaly-triggered profiling windows opened")
        self._fired_gauges = {
            spec.name: reg.gauge(
                f"health/fired/{spec.name}",
                f"1 while detector {spec.name} fired this interval")
            for spec, _ in self._detectors}
        reg.gauge("health/open_anomalies",
                  "anomaly records not yet finalized",
                  fn=lambda: float(len(self._open)))

    # -- baseline priming --------------------------------------------------

    def prime(self, metrics: Mapping[str, float],
              source: str) -> Optional[str]:
        """Prime every detector that names a ``baseline_key`` from
        ``metrics`` (a round's parsed numbers, by key).  Returns
        ``source`` when one primed, else None."""
        primed = False
        for spec, det in self._detectors:
            key = spec.baseline_key
            if not key:
                continue
            value = metrics.get(key)
            if value is None:
                continue
            try:
                det.prime(float(value))
                primed = True
            except (TypeError, ValueError):
                continue
        if primed:
            self._baseline_source = source
            return source
        return None

    def prime_from_bench(self,
                         bench_dir: Optional[str] = None
                         ) -> Optional[str]:
        """Prime from the newest committed BENCH round, as the JAX
        monitor does through its ``obs/rounds.py``.  The port has no
        rounds of its own yet, and the committed ones are TPU readings
        (``--health_baseline_dir`` takes only ``""``), so this raises."""
        raise ValueError(
            "priming the health detectors from committed rounds is not "
            "ported to scalable_agent_tpu_torch yet; ROADMAP.md (queue 1) "
            "lists what the port runs and what comes next")

    @property
    def baseline_source(self) -> Optional[str]:
        return self._baseline_source

    def note_baseline_kernels(self, table: Optional[dict]):
        """The run's scheduled ``--profile_dir`` window's kernel table:
        the reference the anomaly window's worst-kernel delta is
        computed against."""
        if table:
            self._baseline_kernels = table

    # -- the per-interval step ---------------------------------------------

    def step(self,
             metrics: Optional[Mapping[str, float]] = None,
             update: Optional[int] = None,
             verdict: Optional[str] = None,
             evidence: Optional[Mapping[str, float]] = None
             ) -> List[dict]:
        """Evaluate every detector against ``metrics`` (default: a
        fresh registry snapshot).  Returns the anomaly records opened
        this step (usually empty)."""
        if metrics is None:
            metrics = self._registry.snapshot()
        now = self._clock()
        fired: List[dict] = []
        for spec, det in self._detectors:
            self._fired_gauges[spec.name].set(0.0)
            value = self._resolve(spec, metrics)
            if value is None:
                continue
            trip = det.observe(value)
            if trip is None:
                continue
            last = self._last_trip.get(spec.name)
            if last is not None and now - last < self._cooldown_s:
                self._suppressed_total.inc()
                continue
            self._last_trip[spec.name] = now
            record = self._open_anomaly(
                spec, trip, update, verdict, evidence, metrics)
            self._fired_gauges[spec.name].set(1.0)
            fired.append(record)
        return fired

    def _resolve(self, spec: DetectorSpec,
                 metrics: Mapping[str, float]) -> Optional[float]:
        if spec.value_fn is not None:
            raw = spec.value_fn(metrics)
        else:
            raw = metrics.get(spec.metric)
        if raw is None:
            return None
        try:
            value = float(raw)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(value):
            return None
        if not spec.rate:
            return value
        now = self._clock()
        last = self._last_rate.get(spec.name)
        self._last_rate[spec.name] = (value, now)
        if last is None:
            return None  # first sample: reference only
        last_value, last_t = last
        dt = now - last_t
        if dt <= 0.0:
            return None
        return (value - last_value) / dt

    # -- the trip protocol -------------------------------------------------

    def _open_anomaly(self, spec: DetectorSpec, trip: dict,
                      update: Optional[int], verdict: Optional[str],
                      evidence: Optional[Mapping[str, float]],
                      metrics: Mapping[str, float]) -> dict:
        with self._lock:
            self._seq += 1
            anomaly_id = f"a{self._seq:03d}-{spec.name}"
        dominant = self._dominant_segment(evidence)
        record = {
            "schema_version": SCHEMA_VERSION,
            "id": anomaly_id,
            "detector": spec.name,
            "kind": spec.kind,
            "metric": spec.metric,
            "direction": spec.direction,
            "ts_unix": time.time(),
            "update": update,
            "observed": trip.get("observed"),
            "baseline": trip.get("baseline"),
            "z": trip.get("z"),
            "rel": trip.get("rel"),
            "primed": bool(trip.get("primed")),
            "baseline_source": (self._baseline_source
                                if trip.get("primed") else None),
            "verdict": verdict,
            "evidence": dict(evidence) if evidence else {},
            "dominant_segment": dominant[0] if dominant else None,
            "dominant_share": dominant[1] if dominant else None,
            "flightrec": {"pinned": False, "dump": None},
            "window": {"status": "disabled"},
        }
        if "cusum" in trip:
            record["cusum"] = trip["cusum"]
        self._pin_and_dump(spec, anomaly_id, record)
        record["window"] = {"status": self._window_decision(spec)}
        if record["window"]["status"] == "armed":
            self._pending_window = anomaly_id
        self._anomalies_total.inc()
        self._open[anomaly_id] = record
        self._append(record)
        # Terminal states leave nothing to finalize at flush().
        if record["window"]["status"] != "armed":
            self._open.pop(anomaly_id, None)
        return record

    def _dominant_segment(self, evidence) -> Optional[Tuple[str, float]]:
        if evidence:
            name = evidence.get("ledger_dominant")
            share = evidence.get("ledger_dominant_share")
            if name:
                return str(name), float(share or 0.0)
        ledger = get_ledger()
        # Same registry-identity gate the stall attributor uses: a
        # foreign test registry must not read the global ledger.
        if getattr(ledger, "registry", None) is self._registry:
            return ledger.dominant_segment()
        return None

    def _pin_and_dump(self, spec: DetectorSpec, anomaly_id: str,
                      record: dict):
        rec = self._recorder
        if rec is None:
            rec = get_flight_recorder()
        reason = f"health:{anomaly_id}"
        rec.record("anomaly", spec.name,
                   {"id": anomaly_id, "metric": spec.metric})
        if spec.pin and getattr(rec, "reason_pin", None) is None:
            rec.reason_pin = reason
            record["flightrec"]["pinned"] = True
        # Dump on the bounded helper thread (the crash-handler idiom):
        # a slow disk can't wedge the driver's log interval, and the
        # join bound keeps a later dump from racing this one through
        # dump_all's non-blocking lock.
        dumper = threading.Thread(
            target=rec.dump_all, args=(reason,), daemon=True,
            name="health-dump")
        dumper.start()
        dumper.join(timeout=self._dump_join_s)
        record["flightrec"]["dump"] = getattr(
            rec, "last_dump_reason", None)

    def _window_decision(self, spec: DetectorSpec) -> str:
        if not spec.window:
            return "disabled"
        if self._max_windows <= 0:
            return "disabled"
        if self._windows_opened >= self._max_windows:
            return "skipped:budget"
        if self._pending_window is not None or self._open_window:
            return "skipped:busy"
        if (self._last_window_at is not None
                and self._clock() - self._last_window_at
                < self._cooldown_s):
            return "skipped:cooldown"
        return "armed"

    # -- the window protocol (driven by the driver) ------------------------

    def poll_window(self) -> Optional[str]:
        """The anomaly id whose profiling window the driver should open
        now, or None.  Does NOT consume — the driver may be unable to
        open this interval (a scheduled --profile_dir window is live)
        and asks again next interval."""
        return self._pending_window

    def note_window_open(self, anomaly_id: str,
                         trace_dir: Optional[str] = None):
        """The driver opened the window: consume the pending slot,
        spend budget, start the window cooldown."""
        if self._pending_window == anomaly_id:
            self._pending_window = None
        self._open_window = anomaly_id
        self._windows_opened += 1
        self._last_window_at = self._clock()
        self._windows_total.inc()
        record = self._open.get(anomaly_id)
        if record is not None:
            record["window"] = {"status": "open", "trace_dir": trace_dir}

    def note_window_result(self, anomaly_id: str,
                           table: Optional[dict],
                           kernels_json: Optional[str] = None):
        """The window closed and the harvest ran: finalize the record
        with the kernel verdict and its delta vs the run's baseline
        window, and append the final record (last-per-id wins)."""
        if self._open_window == anomaly_id:
            self._open_window = None
        record = self._open.pop(anomaly_id, None)
        if record is None:
            return
        window = dict(record.get("window") or {})
        if not table:
            window["status"] = "empty"
        else:
            window["status"] = "done"
            window["kernels_json"] = kernels_json
            worst = table.get("worst_kernel")
            worst_mfu = table.get("worst_kernel_mfu")
            window["worst_kernel"] = worst
            window["worst_kernel_mfu"] = worst_mfu
            window["dominant_kernel"] = table.get("dominant_kernel")
            base = self._baseline_kernels
            if base:
                window["baseline_worst_kernel"] = base.get("worst_kernel")
                window["baseline_worst_kernel_mfu"] = base.get(
                    "worst_kernel_mfu")
                rows = {row.get("name"): row
                        for row in base.get("kernels", [])}
                same = rows.get(worst)
                if (same and worst_mfu is not None
                        and same.get("mfu") is not None):
                    window["worst_kernel_mfu_delta"] = (
                        worst_mfu - same["mfu"])
                if (same and same.get("time_us") is not None):
                    anomaly_row = {
                        row.get("name"): row
                        for row in table.get("kernels", [])}.get(worst)
                    if (anomaly_row
                            and anomaly_row.get("time_us") is not None):
                        window["worst_kernel_time_delta_us"] = (
                            anomaly_row["time_us"] - same["time_us"])
        record["window"] = window
        self._append(record)

    def flush(self):
        """Teardown: finalize every still-open record (a window that
        never got to open, or was open when the run ended)."""
        with self._lock:
            open_records = list(self._open.items())
            self._open.clear()
        for anomaly_id, record in open_records:
            window = dict(record.get("window") or {})
            status = window.get("status")
            window["status"] = ("aborted:run_ended"
                                if status == "open"
                                else "skipped:run_ended")
            record["window"] = window
            self._append(record)
        self._pending_window = None
        self._open_window = None

    # -- the artifact ------------------------------------------------------

    def _append(self, record: dict):
        if self._path is None:
            return
        try:
            os.makedirs(self._logdir, exist_ok=True)
            with open(self._path, "a") as handle:
                handle.write(json.dumps(_jsonable(record)) + "\n")
                handle.flush()
        except OSError:
            pass  # health must never take the run down


def read_anomalies(logdir: str) -> List[dict]:
    """Parse ``<logdir>/anomalies.jsonl`` into the LAST record per id,
    in first-seen order (the event-sourced read every consumer —
    watch, report, rounds, the HTTP endpoint — shares).  Torn trailing
    lines (crash mid-append) are skipped."""
    path = os.path.join(logdir, ANOMALIES_JSONL)
    try:
        lines = open(path).read().splitlines()
    except OSError:
        return []
    by_id: Dict[str, dict] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue
        anomaly_id = record.get("id")
        if not isinstance(anomaly_id, str):
            continue
        by_id[anomaly_id] = record  # dict preserves insertion order
    return list(by_id.values())
