"""Pipeline ledger: each trajectory's provenance, and the queueing-model
account of where along the actor -> queue -> transport -> learner path
its frames spend their time.

A copy of ``scalable_agent_tpu/obs/ledger.py`` for the port's host loop.
Every trajectory gets a record: its birth (the unroll's start, with the
actor thread and env group), then a stamp at each stage boundary it
crosses:

    birth -> unroll_done -> queue_put -> queue_get ->
    [transport_pack -> transport_upload -> transport_unpack] ->
    put_done -> dispatch -> retire

Consecutive stamps partition its life into ``SEGMENTS`` (unroll,
backpressure, queue_wait, transport, staged_wait, device).  From the
records closed in each interval, ``publish`` derives, into the registry:

- ``ledger/rate/<seg>_per_s`` and ``ledger/rho/<seg>`` (busy seconds per
  wall second: utilization for a single-server stage, Little's-law L for
  a wait stage);
- ``ledger/stage/<seg>_s`` latency histograms and
  ``ledger/latency_share/<seg>`` (the stall verdict's dominant segment);
- ``ledger/staleness_s``: frame age at consumption (birth -> retire);
- ``ledger/mfu``: FLOPs per update x retire rate / peak (one card),
  armed by ``configure_mfu`` (the driver passes the analytic count of
  ``runtime/learner.py`` ``update_flops`` and this card's peak; see
  ``peak_flops``).

Every record is closed: ``retire`` (its update finished), ``discard``
(the rollback's ``InflightWindow.discard``: counted into
``ledger/frames_discarded_total``) or ``abandoned`` (still in the
pipeline at shutdown; ``finalize`` sweeps these), so a clean run ends
with no open record.  ``stamp`` takes no lock (a dict store and an
atomic deque append per stage crossing); the rest takes one small lock
at trajectory cadence, and the derivation runs at the log interval.

Beside the trajectory path, ``note_service`` feeds stages with
arrivals and busy seconds, published as ``ledger/rate/<stage>_per_s`` and
``ledger/rho/<stage>``:

- the continuous-batching actor service's two halves
  (``runtime/service.py``, ``--actor=service``), each executed batch:
  ``service_wait`` (request submission -> batch formation; its busy
  seconds are the summed waits, so its rho is Little's-law L, the parked
  requests) and ``service_batch`` (the one inference thread's batched
  step; its rho is that thread's utilization);
- the replay slab's two dispatch points (``runtime/replay.py``),
  ``replay_insert`` and ``replay_sample``: a replayed batch re-enters the
  learner without a record of its own (its frames were counted when it
  was consumed fresh), and its age goes to
  ``ledger/staleness_replayed_s`` (``observe_replay_staleness``);
- the dynamic-batching inference service (``runtime/batcher.py``,
  ``runtime/native_batcher.py``; ``--inference_mode=service``),
  ``inference_service``: each executed batch's requests and busy seconds,
  its rho the consumer thread's utilization.

The JAX ``PEAK_FLOPS`` table lists TPU peaks only, none of which applies
here.
"""

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "PEAK_FLOPS",
    "SEGMENT_LABELS",
    "SEGMENTS",
    "SERVICE_STAGES",
    "SERVICE_UTILIZATION_STAGES",
    "STAGES",
    "TIMING_STAGE_MAP",
    "PipelineLedger",
    "configure_ledger",
    "get_ledger",
    "now_us",
    "peak_flops",
]

_SCHEMA_VERSION = 1
# Capacity bounds: open records, closed records awaiting derivation,
# the stamp ring, and queue bindings.  Past one, the oldest entry goes
# and ``ledger/truncated`` reads 1.
OPEN_CAPACITY = CLOSED_CAPACITY = BIND_CAPACITY = 8192
RING_CAPACITY = 65536

# The stage boundaries a trajectory crosses, in pipeline order; the
# transport_* stamps only on the packed transport.
STAGES = (
    "birth",             # unroll start (first env step of the unroll)
    "unroll_done",       # the actor finished the T-step unroll
    "queue_put",         # entered the ActorPool trajectory queue
    "queue_get",         # left it (prefetch thread)
    "transport_pack",    # packed into the staging buffer
    "transport_upload",  # host-to-card copy issued
    "transport_unpack",  # unpacked on the card as views
    "put_done",          # placed on the card (any transport)
    "dispatch",          # learner update issued
    "retire",            # update finished (InflightWindow.retire)
)

# Consecutive stamp pairs partitioning birth -> retire.  Durations clamp
# at zero: queue_put and queue_get race across threads by design.
SEGMENTS = (
    ("unroll", "birth", "unroll_done"),
    ("backpressure", "unroll_done", "queue_put"),
    ("queue_wait", "queue_put", "queue_get"),
    ("transport", "queue_get", "put_done"),
    ("staged_wait", "put_done", "dispatch"),
    ("device", "dispatch", "retire"),
)

# The stages beside the trajectory path, fed by note_service (arrivals
# and busy seconds): the dynamic-batching inference service's, the actor
# service's two halves and the replay slab's two dispatch points.  SERVICE_UTILIZATION_STAGES are those whose rho is one
# server's utilization in [0, 1].
SERVICE_STAGES = ("inference_service", "service_wait", "service_batch",
                  "replay_insert", "replay_sample")
SERVICE_UTILIZATION_STAGES = ("inference_service", "service_batch")
# The service stages this port publishes: all of them.
PORTED_SERVICE_STAGES = SERVICE_STAGES

SEGMENT_LABELS = {
    "unroll": "actor unroll (env stepping + inference)",
    "backpressure": "actor backpressure (trajectory queue full)",
    "queue_wait": "batcher wait (trajectory queue)",
    "transport": "host->device transport",
    "staged_wait": "staging wait (learner busy)",
    "device": "device execution (in-flight window)",
    "inference_service": "dynamic-batching inference service",
    "service_wait": "actor-service request wait (batch formation)",
    "service_batch": "actor-service batched inference execution",
    "replay_insert": "replay slab insert dispatch (device-side write)",
    "replay_sample": "replay slab sample dispatch (gather + unpack)",
}

# Each timing histogram the port registers (names ending in _s) by the
# ledger stage whose span it measures, as the JAX map has it.
TIMING_STAGE_MAP = {
    "actor/env_step_s": "unroll",
    "actor/inference_s": "unroll",
    "batcher/request_latency_s": "inference_service",
    "native_batcher/request_latency_s": "inference_service",
    "learner/put_trajectory_s": "transport",
    "transport/pack_s": "transport",
    "transport/upload_s": "transport",
    "transport/unpack_s": "transport",
    "learner/retire_s": "device",
    "service/wait_s": "service_wait",
    "service/batch_s": "service_batch",
    # submission -> action spans the wait and the batch; under load the
    # wait dominates, so the latency reads with the wait stage.
    "service/request_latency_s": "service_wait",
    "replay/insert_s": "replay_insert",
    "replay/sample_s": "replay_sample",
}

# Peak dense FLOP/s of the cards the live MFU gauge knows, by
# torch.cuda.get_device_name() prefix and compute dtype: NVIDIA H100 SXM5,
# 989.4 TFLOP/s bf16 on the tensor cores, 66.9 TFLOP/s float32 (the
# peaks of PERF.md's bounds).
PEAK_FLOPS = [
    ("NVIDIA H100 80GB HBM3", {"bfloat16": 989.4e12, "float32": 66.9e12}),
]


def peak_flops(device_name: str, compute_dtype: str) -> Optional[float]:
    """The card's peak for ``compute_dtype``; None for any other device
    (the MFU gauge then stays at 0)."""
    for prefix, peaks in PEAK_FLOPS:
        if device_name.startswith(prefix):
            return peaks.get(compute_dtype)
    return None


def now_us() -> int:
    """Monotonic microseconds, the tracer's and flight recorder's
    clock."""
    return time.perf_counter_ns() // 1000


class _Record:
    """One trajectory's provenance: identity and stage stamps."""

    __slots__ = ("tid", "actor", "group", "frames", "stamps", "fate")

    def __init__(self, tid: int, actor: str, group: str, frames: float,
                 birth_us: int):
        self.tid = tid
        self.actor = actor
        self.group = group
        self.frames = frames
        self.stamps: Dict[str, int] = {"birth": birth_us}
        self.fate: Optional[str] = None  # retired | discarded | abandoned

    def as_dict(self) -> dict:
        return {"tid": self.tid, "actor": self.actor, "group": self.group,
                "frames": self.frames, "fate": self.fate,
                "stamps": dict(self.stamps)}


class PipelineLedger:
    """Provenance records, their derivation, and the ledger artifact
    (``<logdir>/ledger.p0.json``)."""

    def __init__(self, registry=None, frames_per_trajectory: float = 0.0,
                 logdir: Optional[str] = None):
        from scalable_agent_tpu_torch.obs.registry import get_registry

        self.registry = registry or get_registry()
        self.frames_per_trajectory = float(frames_per_trajectory)
        self.logdir = logdir
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_tid = 0
        self._open: Dict[int, _Record] = {}
        self._closed: deque = deque()
        # One atomic append per stamp; dumped with the artifact.
        self._ring: deque = deque(maxlen=RING_CAPACITY)
        self._stamps_total = 0
        self._bindings: Dict[int, int] = {}
        # note_service's accumulators: stage -> [arrivals, busy seconds].
        self._service: Dict[str, List[float]] = {}
        # Each service stage's rho in the last interval that fed it
        # (service_pressure).
        self._last_service_rho: Dict[str, float] = {}
        self._mfu_flops = 0.0
        self._mfu_peak = 0.0
        self._epoch_unix_us = int(time.time() * 1e6)
        self._epoch_perf_us = now_us()
        self._last_publish_us = now_us()
        self._last_stats: Dict[str, object] = {}
        self._last_shares: Dict[str, float] = {}

        reg = self.registry
        self._c_opened = reg.counter(
            "ledger/trajectories_opened_total",
            "trajectory provenance records opened")
        self._c_retired = reg.counter(
            "ledger/trajectories_retired_total",
            "records closed by a materialized update (clean retire)")
        self._c_discarded = reg.counter(
            "ledger/trajectories_discarded_total",
            "records closed retired=False by InflightWindow.discard "
            "(rollback) — their frames never advanced training")
        self._c_abandoned = reg.counter(
            "ledger/trajectories_abandoned_total",
            "records still in-pipeline at shutdown, swept by finalize()")
        self._c_frames_discarded = reg.counter(
            "ledger/frames_discarded_total",
            "env frames in discarded/abandoned trajectories")
        self._c_dropped = reg.counter(
            "ledger/records_dropped_total",
            "records evicted by capacity bounds before derivation "
            "(open-table or closed-window overflow)")
        self._c_late = reg.counter(
            "ledger/late_stamps_total",
            "stamps arriving for an already-closed/evicted record")
        self._g_truncated = reg.gauge(
            "ledger/truncated",
            "1 when any ledger ring/table hit its capacity bound "
            "(derived stats then cover a truncated window)")
        self_ref = weakref.ref(self)
        reg.gauge(
            "ledger/open_records",
            "trajectories currently in flight between birth and close",
            fn=lambda: (len(led._open)
                        if (led := self_ref()) is not None else 0.0))
        self._h_staleness = reg.histogram(
            "ledger/staleness_s",
            "FRESH frame age at consumption: unroll birth -> update "
            "retire (the staleness metric IMPACT-style replay tunes "
            "against; replayed consumptions read the _replayed series "
            "so this histogram stays honest when replay_ratio > 0)")
        self._h_staleness_replayed = reg.histogram(
            "ledger/staleness_replayed_s",
            "REPLAYED frame age at consumption: unroll birth -> replay "
            "sample (runtime/replay.py's deterministic slot mirror — "
            "the dial obs.report judges the IMPACT clip's useful range "
            "against)")
        self._g_mfu = reg.gauge(
            "ledger/mfu",
            "live model FLOPs utilization: flops_per_update x retire "
            "rate / (peak x devices); 0 until configure_mfu ran")
        self._seg_hists = {
            name: reg.histogram(
                f"ledger/stage/{name}_s",
                f"per-trajectory seconds in {SEGMENT_LABELS[name]}")
            for name, _, _ in SEGMENTS
        }
        self._seg_rate = {
            name: reg.gauge(
                f"ledger/rate/{name}_per_s",
                f"trajectories/s completing {name} (last interval)")
            for name, _, _ in SEGMENTS
        }
        self._seg_rho = {
            name: reg.gauge(
                f"ledger/rho/{name}",
                "busy seconds per wall second in this stage over the "
                "last interval (utilization for a service stage; "
                "Little's-law L for a wait stage)")
            for name, _, _ in SEGMENTS
        }
        for name in PORTED_SERVICE_STAGES:
            self._seg_rate[name] = reg.gauge(
                f"ledger/rate/{name}_per_s",
                f"requests/s served by {SEGMENT_LABELS[name]}")
            self._seg_rho[name] = reg.gauge(
                f"ledger/rho/{name}",
                f"utilization of {SEGMENT_LABELS[name]} (busy s / s)")
        self._seg_share = {
            name: reg.gauge(
                f"ledger/latency_share/{name}",
                "this stage's share of mean birth->retire latency "
                "(last interval with closed records)")
            for name, _, _ in SEGMENTS
        }

    # -- record lifecycle (trajectory cadence) -----------------------------

    def open(self, actor: str, group: str,
             birth_us: Optional[int] = None,
             frames: Optional[float] = None) -> int:
        """Create a provenance record; returns its trajectory id."""
        birth = int(birth_us) if birth_us is not None else now_us()
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            record = _Record(
                tid, actor, group,
                float(frames) if frames is not None
                else self.frames_per_trajectory, birth)
            self._open[tid] = record
            if len(self._open) > OPEN_CAPACITY:
                # A stamp source died without closing: evict the oldest
                # open record, counted and flagged.
                self._open.pop(next(iter(self._open)))
                self._c_dropped.inc()
                self._g_truncated.set(1.0)
        self._c_opened.inc()
        self._ring.append((birth, tid, "birth"))
        self._stamps_total += 1
        return tid

    def stamp(self, tid: int, stage: str,
              ts_us: Optional[int] = None) -> None:
        """Lock-free stage stamp: one dict store and one ring append."""
        ts = int(ts_us) if ts_us is not None else now_us()
        record = self._open.get(tid)
        if record is None:
            self._c_late.inc()
            return
        record.stamps[stage] = ts
        self._ring.append((ts, tid, stage))
        self._stamps_total += 1

    def close(self, tid: int, retired: bool,
              fate: Optional[str] = None) -> None:
        """Finish a record.  ``retired=True`` stamps ``retire`` (unless
        the caller did) and feeds the staleness histogram; False counts
        its frames into ``ledger/frames_discarded_total``."""
        ts = now_us()
        with self._lock:
            record = self._open.pop(tid, None)
            if record is None:
                self._c_late.inc()
                return
            record.fate = fate or ("retired" if retired else "discarded")
            if retired and "retire" not in record.stamps:
                record.stamps["retire"] = ts
            self._closed.append(record)
            if len(self._closed) > CLOSED_CAPACITY:
                self._closed.popleft()
                self._c_dropped.inc()
                self._g_truncated.set(1.0)
        if retired:
            self._c_retired.inc()
            self._h_staleness.observe(
                max(0.0, (record.stamps["retire"]
                          - record.stamps["birth"]) / 1e6))
        else:
            (self._c_abandoned if record.fate == "abandoned"
             else self._c_discarded).inc()
            self._c_frames_discarded.inc(record.frames)
        self._ring.append((ts, tid, f"close:{record.fate}"))
        self._stamps_total += 1

    # -- hand-off plumbing -------------------------------------------------

    def bind(self, key: int, tid: int) -> None:
        """Attach a record to an object crossing a queue (``id(obj)``)."""
        with self._lock:
            self._bindings[key] = tid
            if len(self._bindings) > BIND_CAPACITY:
                self._bindings.pop(next(iter(self._bindings)))

    def lookup(self, key: int) -> Optional[int]:
        """Pop the record bound to ``key``: one-shot, so a reused object
        id can never be misattributed (and popping drops a binding)."""
        with self._lock:
            return self._bindings.pop(key, None)

    def set_current(self, tid: Optional[int]) -> None:
        """The calling thread's current record (the prefetch thread sets
        it at queue_get; the transport stamps it)."""
        self._tls.tid = tid

    def current(self) -> Optional[int]:
        return getattr(self._tls, "tid", None)

    def stamp_current(self, stage: str) -> None:
        tid = self.current()
        if tid is not None:
            self.stamp(tid, stage)

    # -- MFU ---------------------------------------------------------------

    def birth_us(self, tid: int) -> Optional[int]:
        """An open record's birth stamp (the replay insert tags its slot
        with it); None once the record has closed."""
        record = self._open.get(tid)
        return None if record is None else record.stamps.get("birth")

    def observe_replay_staleness(self, age_s: float) -> None:
        """One replayed consumption's frame age (``runtime/replay.py``'s
        host-side slot mirror): the replayed half of the staleness
        split."""
        self._h_staleness_replayed.observe(max(0.0, float(age_s)))

    def note_service(self, name: str, n: int, busy_s: float) -> None:
        """``n`` requests served in ``busy_s`` seconds by the service
        stage ``name`` (the actor service's wait and batch halves, the
        replay slab's insert and sample)."""
        with self._lock:
            acc = self._service.setdefault(name, [0.0, 0.0])
            acc[0] += n
            acc[1] += busy_s

    def configure_mfu(self, flops_per_update: float,
                      peak_flops: float) -> None:
        """Arm the live MFU gauge (one card)."""
        self._mfu_flops = float(flops_per_update)
        self._mfu_peak = float(peak_flops)

    # -- derivation --------------------------------------------------------

    def publish(self, interval_s: Optional[float] = None
                ) -> Dict[str, object]:
        """Derive and export the stage stats of the records closed since
        the last publish; ``interval_s`` overrides the measured wall
        interval."""
        with self._lock:
            records = list(self._closed)
            self._closed.clear()
            service = {k: tuple(v) for k, v in self._service.items()}
            self._service.clear()
        ts = now_us()
        if interval_s is None:
            interval_s = max(1e-9, (ts - self._last_publish_us) / 1e6)
        self._last_publish_us = ts

        busy = {name: 0.0 for name, _, _ in SEGMENTS}
        counts = {name: 0 for name, _, _ in SEGMENTS}
        retired = 0
        seg_table = [(name, start, end, self._seg_hists[name].observe)
                     for name, start, end in SEGMENTS]
        for record in records:
            if record.fate == "retired":
                retired += 1
            get = record.stamps.get
            for name, start, end, observe in seg_table:
                t0, t1 = get(start), get(end)
                if t0 is not None and t1 is not None:
                    dur = (t1 - t0) / 1e6 if t1 > t0 else 0.0
                    busy[name] += dur
                    counts[name] += 1
                    observe(dur)

        stats: Dict[str, object] = {
            "interval_s": interval_s,
            "records": len(records),
            "retired": retired,
            "segments": {},
        }
        total_busy = 0.0
        for name, _, _ in SEGMENTS:
            rate = counts[name] / interval_s
            rho = busy[name] / interval_s
            mean = busy[name] / counts[name] if counts[name] else 0.0
            self._seg_rate[name].set(rate)
            self._seg_rho[name].set(rho)
            stats["segments"][name] = {
                "rate_per_s": rate, "rho": rho, "mean_s": mean,
                "count": counts[name]}
            total_busy += busy[name]
        if records and total_busy > 0.0:
            shares = {name: busy[name] / total_busy
                      for name, _, _ in SEGMENTS}
            self._last_shares = shares
            for name, share in shares.items():
                self._seg_share[name].set(share)
        stats["latency_shares"] = dict(self._last_shares)
        for name, (n, busy_s) in service.items():
            if name in self._seg_rate:
                self._seg_rate[name].set(n / interval_s)
                self._seg_rho[name].set(busy_s / interval_s)
            self._last_service_rho[name] = busy_s / interval_s
            stats["segments"][name] = {
                "rate_per_s": n / interval_s, "rho": busy_s / interval_s}

        if self._mfu_flops and self._mfu_peak:
            mfu = self._mfu_flops * retired / interval_s / self._mfu_peak
            stats["mfu"] = mfu
            # Keep the last interval that retired updates: the shutdown
            # drain's empty interval must not zero the final reading.
            if retired:
                self._g_mfu.set(mfu)
        self._last_stats = stats
        return stats

    def dominant_segment(self) -> Optional[Tuple[str, float]]:
        shares = self._last_shares
        if not shares:
            return None
        name = max(shares, key=shares.get)
        return name, shares[name]

    def service_pressure(self, threshold: float = 0.5
                         ) -> Optional[Tuple[str, float]]:
        """The busiest utilization-type service stage's ``(name, rho)``
        when it reached ``threshold`` in the last interval that fed it:
        the actor service's inference runs inside the unroll segment, so
        the latency shares alone cannot name it."""
        candidates = {name: rho
                      for name, rho in self._last_service_rho.items()
                      if name in SERVICE_UTILIZATION_STAGES}
        if not candidates:
            return None
        name = max(candidates, key=candidates.get)
        rho = candidates[name]
        return (name, rho) if rho >= threshold else None

    # -- shutdown ----------------------------------------------------------

    def finalize(self) -> Optional[str]:
        """Close the records still open as ``abandoned``, publish once
        more and dump the artifact.  Never raises on the dump."""
        with self._lock:
            leftover = list(self._open)
        for tid in leftover:
            self.close(tid, retired=False, fate="abandoned")
        self.publish()
        try:
            return self.dump()
        except Exception:
            return None

    def snapshot(self) -> dict:
        """The ledger's state as one JSON-able dict (the dump payload).
        Copies retry when a live stamper mutates what they iterate."""

        def _copy(make, fallback):
            for _ in range(5):
                try:
                    return make()
                except RuntimeError:  # mutated during iteration
                    continue
            return fallback

        with self._lock:
            open_records = _copy(
                lambda: [r.as_dict() for r in self._open.values()], [])
            ring = _copy(lambda: list(self._ring), [])
        return {
            "schema_version": _SCHEMA_VERSION,
            "process_index": 0,
            "pid": os.getpid(),
            "epoch_unix_us": self._epoch_unix_us,
            "epoch_perf_us": self._epoch_perf_us,
            "frames_per_trajectory": self.frames_per_trajectory,
            "stamps_total": self._stamps_total,
            "ring_truncated": bool(
                (maxlen := self._ring.maxlen or 0)
                and (self._stamps_total > maxlen
                     or len(ring) >= maxlen)),
            "open_records": open_records,
            "last_stats": self._last_stats,
            "counters": {
                "opened": self._c_opened.value,
                "retired": self._c_retired.value,
                "discarded": self._c_discarded.value,
                "abandoned": self._c_abandoned.value,
                "frames_discarded": self._c_frames_discarded.value,
                "dropped": self._c_dropped.value,
                "late_stamps": self._c_late.value,
            },
            "ring_tail": [
                {"ts_us": ts, "tid": tid, "stage": stage}
                for ts, tid, stage in ring[-2048:]
            ],
        }

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write ``<logdir>/ledger.p0.json``."""
        if path is None:
            if self.logdir is None:
                return None
            path = os.path.join(self.logdir, "ledger.p0.json")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, path)
        return path


# Always live, like the flight recorder: an unconfigured ledger records
# into the global registry and has nowhere to dump.
_ledger = PipelineLedger()
_ledger_lock = threading.Lock()


def get_ledger() -> PipelineLedger:
    return _ledger


def configure_ledger(registry=None, frames_per_trajectory: float = 0.0,
                     logdir: Optional[str] = None) -> PipelineLedger:
    """Install (and return) a fresh process-global ledger for one run, so
    one run's records never leak into the next."""
    global _ledger
    with _ledger_lock:
        _ledger = PipelineLedger(
            registry=registry,
            frames_per_trajectory=frames_per_trajectory, logdir=logdir)
        return _ledger
