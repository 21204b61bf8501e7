"""Stall attribution: name the pipeline's binding constraint each log
interval.

A copy of ``scalable_agent_tpu/obs/stall.py``.  Each interval falls into
one of three categories, published as metrics and as a log line:

- ``device_bound``: the learner's update (dispatch plus the in-flight
  window's retire) fills the interval; the card is the constraint.
- ``env_bound``: the learner waits for batches (``wait_batch`` above the
  threshold) and the actor threads spend more time stepping envs than in
  inference.
- ``learner_starved``: the learner waits, and env stepping does not
  dominate the actors: inference, the transport or the queue hand-off is
  the gap.
- ``stalled_thread`` is the watchdog's verdict (``obs/watchdog.py``
  calls ``report_stalled``): a pipeline thread missed its heartbeat.

Inputs: the driver's per-interval ``wait_batch``/``update``/``retire``
seconds, and the actors' ``actor/env_step_s`` and ``actor/inference_s``
histograms, whose cumulative sums are differenced per interval.  When
the pipeline ledger (``obs/ledger.py``) of the same registry has
published latency shares, the verdict also names the segment that holds
the most frame latency, and the actor service's inference stage when its
utilization reached half (``PipelineLedger.service_pressure``: that
service runs inside the unroll segment); a ``device_bound`` verdict names
the worst kernel of the last kernel table published against the same
registry (``obs/kernels.py``).
"""

from typing import Dict, Optional, Tuple

from scalable_agent_tpu_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
)

__all__ = ["StallAttributor", "CATEGORIES"]

CATEGORIES = ("device_bound", "env_bound", "learner_starved",
              "stalled_thread")

# An interval whose wait_batch share is at most this is device_bound.
STARVATION_THRESHOLD = 0.15

# The actors' per-step histograms (runtime/actor.py); sums are
# cumulative seconds across threads.
_ENV_HIST = "actor/env_step_s"
_INFER_HIST = "actor/inference_s"


class StallAttributor:
    """Classify intervals; set the gauges and counters; render the log
    line."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry or get_registry()
        # Baseline the actor sums now: a registry that served an earlier
        # run must not charge its seconds to this run's first interval.
        self._last_env_sum = self._registry.histogram(_ENV_HIST).sum
        self._last_infer_sum = self._registry.histogram(_INFER_HIST).sum
        self._frac_wait = self._registry.gauge(
            "stall/frac_wait_batch",
            "fraction of the learner interval spent waiting for a batch")
        self._frac_update = self._registry.gauge(
            "stall/frac_update",
            "fraction of the learner interval spent in the update")
        self._frac_retire = self._registry.gauge(
            "stall/frac_retire",
            "fraction of the learner interval blocked retiring the "
            "in-flight update window")
        self._category_gauges = {
            name: self._registry.gauge(
                f"stall/is_{name}",
                f"1 when the last interval classified as {name}")
            for name in CATEGORIES
        }
        self._category_counters = {
            name: self._registry.counter(
                f"stall/intervals_{name}_total",
                f"intervals classified as {name}")
            for name in CATEGORIES
        }

    def _actor_interval(self) -> Tuple[float, float]:
        """(env_s, infer_s) accumulated since the previous call."""
        env_sum = self._registry.histogram(_ENV_HIST).sum
        infer_sum = self._registry.histogram(_INFER_HIST).sum
        env_d = max(0.0, env_sum - self._last_env_sum)
        infer_d = max(0.0, infer_sum - self._last_infer_sum)
        self._last_env_sum, self._last_infer_sum = env_sum, infer_sum
        return env_d, infer_d

    def attribute(self, wait_batch_s: float, update_s: float,
                  retire_s: float = 0.0) -> Tuple[str, Dict[str, float]]:
        """Classify one interval; returns ``(category, evidence)``.
        ``retire_s`` (waiting for the oldest in-flight update) counts on
        the device side with ``update_s``."""
        device_s = update_s + retire_s
        learner_total = wait_batch_s + device_s
        wait_frac = (wait_batch_s / learner_total) if learner_total else 0.0
        retire_frac = (retire_s / learner_total) if learner_total else 0.0
        env_s, infer_s = self._actor_interval()
        actor_total = env_s + infer_s
        env_frac = (env_s / actor_total) if actor_total else 0.0

        if wait_frac <= STARVATION_THRESHOLD:
            category = "device_bound"
        elif env_s >= infer_s and actor_total > 0.0:
            category = "env_bound"
        else:
            category = "learner_starved"

        self._frac_wait.set(wait_frac)
        # The three frac_* gauges partition the learner interval.
        self._frac_update.set(
            max(0.0, 1.0 - wait_frac - retire_frac)
            if learner_total else 0.0)
        self._frac_retire.set(retire_frac)
        for name, gauge in self._category_gauges.items():
            gauge.set(1.0 if name == category else 0.0)
        self._category_counters[category].inc()
        evidence = {
            "wait_frac": wait_frac,
            "retire_frac": retire_frac,
            "actor_env_frac": env_frac,
            "actor_env_s": env_s,
            "actor_infer_s": infer_s,
        }
        # Only a ledger on this attributor's registry describes the same
        # run (a private registry must not read another run's ledger).
        from scalable_agent_tpu_torch.obs.ledger import get_ledger

        ledger = get_ledger()
        if ledger.registry is self._registry:
            dominant = ledger.dominant_segment()
            if dominant is not None:
                evidence["ledger_dominant"] = dominant[0]
                evidence["ledger_dominant_share"] = dominant[1]
            # The actor service's inference runs inside the unroll
            # segment, so a saturated service reads as "unroll" in the
            # shares; its rho names the real constraint.
            pressure = ledger.service_pressure()
            if pressure is not None:
                evidence["ledger_service"] = pressure[0]
                evidence["ledger_service_rho"] = pressure[1]
        if category == "device_bound":
            # The next step of a device-bound verdict is a kernel: the
            # worst of the last table a profile window published here.
            from scalable_agent_tpu_torch.obs import kernels as kernels_lib

            worst = kernels_lib.last_worst(self._registry)
            if worst is not None:
                evidence["kernel_worst"] = worst[0]
                evidence["kernel_worst_mfu"] = worst[1]
        return category, evidence

    def report_stalled(self, stalled: Dict[str, float],
                       count: bool = True) -> str:
        """The watchdog's path: ``stalled`` maps thread name -> heartbeat
        age in seconds.  One-hots ``stalled_thread`` through the interval
        gauges, counts it (``count=False`` only re-asserts the gauges
        while the wedge persists) and returns the log line."""
        for name, gauge in self._category_gauges.items():
            gauge.set(1.0 if name == "stalled_thread" else 0.0)
        if count:
            self._category_counters["stalled_thread"].inc()
        return ("pipeline stalled_thread ("
                + ", ".join(f"{name} silent {age:.1f}s"
                            for name, age in sorted(
                                stalled.items(),
                                key=lambda item: -item[1]))
                + ")")

    @staticmethod
    def describe(category: str, fractions: Dict[str, float]) -> str:
        """One log line: the verdict and the numbers behind it."""
        retire = fractions.get("retire_frac", 0.0)
        retire_part = (f"; inflight retire {retire:.0%}"
                       if retire else "")
        ledger_part = ""
        dominant = fractions.get("ledger_dominant")
        if dominant:
            from scalable_agent_tpu_torch.obs.ledger import SEGMENT_LABELS

            share = fractions.get("ledger_dominant_share", 0.0)
            ledger_part = (
                f"; {share:.0%} of frame latency in "
                f"{SEGMENT_LABELS.get(dominant, dominant)}")
        service = fractions.get("ledger_service")
        if service:
            rho = fractions.get("ledger_service_rho", 0.0)
            ledger_part += f"; service {service} rho {rho:.2f}"
        worst_kernel = fractions.get("kernel_worst")
        if worst_kernel:
            ledger_part += (
                f"; worst kernel {worst_kernel} mfu "
                f"{fractions.get('kernel_worst_mfu', 0.0):.3f}")
        return (f"pipeline {category} "
                f"(wait_batch {fractions['wait_frac']:.0%} of learner "
                f"interval; actor env share "
                f"{fractions['actor_env_frac']:.0%}{retire_part}"
                f"{ledger_part})")
