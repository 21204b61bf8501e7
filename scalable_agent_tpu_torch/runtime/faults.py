"""Deterministic fault injection: named points in the runtime's
failure-prone seams, armed by ``--chaos_spec``, so the recovery paths run
on purpose.

The counterpart of ``scalable_agent_tpu/runtime/faults.py``: the same
``CHAOS_POINTS`` registry, the same ``--chaos_spec`` grammar and the same
seeded, per-point firing decisions.  The points this package places:

- ``nan_grad`` (``runtime/learner.py``): multiply one update's rewards
  by NaN, so the non-finite guard must skip it.
- ``replay_corrupt`` (``runtime/replay.py``): multiply one sampled replay
  batch's rewards by NaN, so the guard must skip the replayed update.
- ``actor_raise`` (``runtime/actor.py``): raise ``InjectedFault`` from an
  actor thread's unroll loop (the bounded-respawn retry).
- ``worker_kill`` (``runtime/actor.py``): SIGKILL one env worker process
  (``MultiEnv``'s respawn).
- ``ckpt_save_fail`` (``runtime/checkpoint.py``): raise inside a cadenced
  save (the log-and-continue degrade).
- ``ckpt_torn`` (``runtime/checkpoint.py``): corrupt the just-written
  step on disk (the manifest check and walk-back restore).
- ``preempt_sigterm`` (``runtime/fleet.py``): the process SIGTERMs
  itself from the preemption monitor's cycle (the grace protocol).
- ``throughput_sag`` (``driver.train``): the loop sleeps
  ``throughput_sag_s()`` inside the update's timing (a mid-run slowdown
  for the stall attributor and the watchdog).
- ``service_stall`` (``runtime/service.py``): the actor service's
  inference thread sleeps ``SERVICE_STALL_S`` (or
  ``$SCALABLE_AGENT_SERVICE_STALL_S``, read when it fires) before a
  batch, so its heartbeat goes stale.

The other points of the registry belong to subsystems this package does
not port yet (``UNPORTED_POINTS``).  Their names still parse, so a spec
reads the same in both packages, but ``configure_faults`` refuses to arm
one: no point is ever armed and silently inert.  The runtime injection
channel (``--chaos_channel``) is not ported either.

The grammar is ``;``-joined entries, each one of three trigger forms:

- ``point@i[:j:k...]``: 1-based occurrence indices; the Nth evaluation
  of the point fires;
- ``point@t=30s``: the first evaluation at or after 30 s of injector
  lifetime fires (once per trigger; the ``s`` is optional);
- ``point@p=0.01``: every evaluation fires with probability 0.01, drawn
  from a per-point RNG seeded from the injector's ``seed``.

Occurrence counting is per point and process-global (thread-safe).  With
no spec the injector is inert: a hot path pays one attribute read.  A
fault that fires is logged, recorded in the flight recorder and counted
in ``faults/injected_total``.
"""

import logging
import os
import random
import re
import threading
import time
from typing import Dict, FrozenSet, List, NamedTuple, Tuple

from scalable_agent_tpu_torch.obs import get_flight_recorder, get_registry

log = logging.getLogger("scalable_agent_tpu_torch")

# Every injection point of the JAX package, name -> what firing it
# simulates.
CHAOS_POINTS = {
    "nan_grad": "poison one update's rewards with NaN",
    "replay_corrupt": "poison one sampled replay batch's rewards",
    "actor_raise": "raise from an actor thread's unroll loop",
    "worker_kill": "SIGKILL one env worker process",
    "ckpt_torn": "corrupt the just-written checkpoint on disk",
    "ckpt_save_fail": "raise inside a cadenced checkpoint save",
    "service_stall": "wedge the continuous-batching inference thread",
    "throughput_sag": "sleep inside the update loop (mid-run slowdown)",
    "peer_exit": "sudden peer process death (os._exit from monitor)",
    "peer_hang": "heartbeat publisher falls silent (wedged peer)",
    "preempt_sigterm": "self-SIGTERM driving the preemption protocol",
    "param_bitflip": "flip a mantissa bit in a param leaf (SDC)",
    "kernel_miscompute": "scale audited hot-path grads 2x (bad kernel)",
    "replica_diverge": "corrupt this process's param fingerprint",
}

# Points whose subsystem (the multi-process fleet, the sentinel) is not
# ported yet.
UNPORTED_POINTS = frozenset({
    "peer_exit", "peer_hang",
    "param_bitflip", "kernel_miscompute", "replica_diverge"})

# How long ``throughput_sag`` sleeps when it fires, as in the JAX package.
THROUGHPUT_SAG_S = 0.45


def throughput_sag_s() -> float:
    """The sag's duration: ``$SCALABLE_AGENT_THROUGHPUT_SAG_S`` when set to
    a number (as in the JAX package), else ``THROUGHPUT_SAG_S``."""
    try:
        return float(os.environ.get("SCALABLE_AGENT_THROUGHPUT_SAG_S",
                                    THROUGHPUT_SAG_S))
    except ValueError:
        return THROUGHPUT_SAG_S

_ENTRY_RE = re.compile(r"([A-Za-z_][\w.]*)@(\d+(?::\d+)*)\Z")
_TIME_RE = re.compile(r"([A-Za-z_][\w.]*)@t=(\d+(?:\.\d+)?)s?\Z")
_PROB_RE = re.compile(r"([A-Za-z_][\w.]*)@p=(\d+(?:\.\d+)?)\Z")


class InjectedFault(RuntimeError):
    """An intentionally injected fault.  Recovery code treats it like any
    other transient failure: the generic paths, not a special case, must
    absorb it."""


class ChaosSpec(NamedTuple):
    """A parsed ``--chaos_spec``: occurrence sets, time triggers (seconds
    of injector lifetime, each fires once) and per-evaluation firing
    probabilities."""

    occurrences: Dict[str, FrozenSet[int]]
    at_times: Dict[str, Tuple[float, ...]]
    probs: Dict[str, float]


def parse_chaos_spec_full(spec: str) -> ChaosSpec:
    """Parse every trigger form of the grammar (module docstring).  A
    malformed entry raises ``ValueError`` with the grammar: a typo that
    was ignored would make a chaos run vacuously green."""
    occurrences: Dict[str, FrozenSet[int]] = {}
    at_times: Dict[str, Tuple[float, ...]] = {}
    probs: Dict[str, float] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        match = _ENTRY_RE.match(entry)
        if match is not None:
            name, occs = match.group(1), {
                int(x) for x in match.group(2).split(":")}
            if 0 in occs:
                raise ValueError(
                    f"chaos_spec entry {entry!r}: occurrence indices "
                    f"are 1-based")
            occurrences[name] = frozenset(occs) | occurrences.get(
                name, frozenset())
            continue
        match = _TIME_RE.match(entry)
        if match is not None:
            name = match.group(1)
            at_times[name] = tuple(sorted(
                at_times.get(name, ()) + (float(match.group(2)),)))
            continue
        match = _PROB_RE.match(entry)
        if match is not None:
            name, p = match.group(1), float(match.group(2))
            if not 0.0 < p <= 1.0:
                raise ValueError(
                    f"chaos_spec entry {entry!r}: probability must be "
                    f"in (0, 1]")
            probs[name] = p
            continue
        raise ValueError(
            f"malformed chaos_spec entry {entry!r}: expected "
            f"'point@i[:j...]' (1-based occurrence indices), "
            f"'point@t=30s' (time trigger), or 'point@p=0.01' "
            f"(per-evaluation probability), e.g. "
            f"'nan_grad@7;actor_raise@3:12;ckpt_torn@t=5s'")
    return ChaosSpec(occurrences, at_times, probs)


def parse_chaos_spec(spec: str) -> Dict[str, FrozenSet[int]]:
    """``'nan_grad@7;actor_raise@3:12'`` -> {point: {occurrences}}: the
    occurrence view of the grammar.  Time and probability entries are
    validated but contribute no indices."""
    return parse_chaos_spec_full(spec).occurrences


def armed_points(spec: str) -> FrozenSet[str]:
    """Every point a spec arms, under any trigger form."""
    parsed = parse_chaos_spec_full(spec)
    return frozenset(parsed.occurrences) | frozenset(parsed.at_times) | (
        frozenset(parsed.probs))


class FaultInjector:
    """Trigger-evaluating injection registry.  Deterministic: the Nth
    evaluation of a point fires iff N is in the spec's occurrence list, a
    not-yet-consumed time trigger is due, or a seeded per-point RNG draw
    lands under the point's probability."""

    def __init__(self, spec: str = "", seed: int = 0):
        parsed = parse_chaos_spec_full(spec)
        self._points = parsed.occurrences
        self._at_times: Dict[str, List[float]] = {
            point: sorted(times)
            for point, times in parsed.at_times.items()}
        self._probs = parsed.probs
        self._rngs = {point: random.Random(f"{seed}:{point}")
                      for point in parsed.probs}
        self._armed_monotonic = time.monotonic()
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        """False for the inert injector: hot paths gate on this."""
        return bool(self._points or self._at_times or self._probs)

    def should_fire(self, point: str) -> bool:
        """Count one evaluation of ``point``; True when a trigger is armed
        for this evaluation."""
        if not self.active:
            return False
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            fired = None
            if n in self._points.get(point, ()):
                fired = "occurrence"
            if fired is None:
                due = self._at_times.get(point)
                if due and due[0] <= (time.monotonic()
                                      - self._armed_monotonic):
                    self._at_times[point] = due[1:]
                    fired = "time"
            if fired is None and point in self._probs:
                if self._rngs[point].random() < self._probs[point]:
                    fired = "probability"
        if fired is None:
            return False
        log.warning("chaos: fault %r fired (occurrence %d, %s trigger)",
                    point, n, fired)
        get_flight_recorder().record(
            "fault", point, {"occurrence": n, "trigger": fired})
        get_registry().counter(
            "faults/injected_total",
            "faults fired by the chaos injection registry").inc()
        return True

    def maybe_raise(self, point: str):
        """Raise ``InjectedFault`` when this occurrence of ``point`` is
        armed; otherwise just count it."""
        if self.should_fire(point):
            raise InjectedFault(
                f"injected fault at {point!r} "
                f"(occurrence {self._counts[point]})")

    def occurrences(self, point: str) -> FrozenSet[int]:
        """The armed 1-based occurrence set of ``point``, without counting
        an evaluation."""
        return self._points.get(point, frozenset())

    def counts(self) -> Dict[str, int]:
        """Evaluations seen per point."""
        with self._lock:
            return dict(self._counts)


_DISABLED = FaultInjector("")
_injector = _DISABLED
_injector_lock = threading.Lock()


def get_fault_injector() -> FaultInjector:
    return _injector


def configure_faults(spec: str = "", seed: int = 0) -> FaultInjector:
    """Install (and return) the process-global injector; an empty spec
    restores the inert one (the driver does so when a run ends, so one
    run's spec cannot leak into the next).  A spec arming a point that is
    not in ``CHAOS_POINTS``, or one whose subsystem is not ported, raises
    ``ValueError``."""
    global _injector
    points = armed_points(spec)
    unknown = sorted(points - set(CHAOS_POINTS))
    if unknown:
        raise ValueError(
            f"chaos_spec arms unknown points {unknown}; the points are "
            f"{sorted(CHAOS_POINTS)}")
    unported = sorted(points & UNPORTED_POINTS)
    if unported:
        raise ValueError(
            f"chaos_spec arms {unported}, whose subsystems are not ported "
            f"to scalable_agent_tpu_torch yet; ROADMAP.md (queue 1) lists "
            f"what the port runs and what comes next")
    with _injector_lock:
        _injector = FaultInjector(spec, seed=seed) if spec else _DISABLED
        return _injector
