"""Watchdog: detect a wedged pipeline thread instead of hanging forever.

A copy of ``scalable_agent_tpu/obs/watchdog.py``: a heartbeat registry and
one monitor thread.

- Pipeline threads ``touch()`` on progress (each actor per env step, the
  prefetch thread per loop, the learner per update); a touch is one dict
  store.
- A thread about to block on work that may legitimately never come (the
  learner on the staged queue), or on a long healthy pause (a first-use
  kernel build, a checkpoint), ``suspend()``s first; its next touch
  re-arms it.
- The monitor flags every armed heartbeat older than ``timeout_s``: the
  ``stalled_thread`` verdict through ``StallAttributor``'s gauges, a log
  line with the threads and their ages, the flight recorder's dump
  (ring, every thread's stack, a final metrics snapshot), and with
  ``abort=True`` the end of the process with exit code 70
  (``runtime/exit_codes.py``).

``--watchdog_timeout_s`` (0 disables) and ``--watchdog_abort`` drive it;
code reaches the process-global instance through ``get_watchdog()``,
disabled by default, where ``touch()`` is one no-op call.
"""

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from scalable_agent_tpu_torch.obs.flightrec import get_flight_recorder
from scalable_agent_tpu_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
)
from scalable_agent_tpu_torch.obs.stall import StallAttributor

__all__ = ["Watchdog", "configure_watchdog", "get_watchdog"]

log = logging.getLogger("scalable_agent_tpu_torch")


class Watchdog:
    """Heartbeat registry and stale-thread monitor.  ``on_stall(stale)``
    gets ``[(name, age_s), ...]`` each time a thread newly goes stale; a
    thread that touches again re-arms and can be reported again."""

    enabled = True

    def __init__(self, timeout_s: float,
                 registry: Optional[MetricsRegistry] = None,
                 poll_interval_s: Optional[float] = None,
                 on_stall: Optional[Callable] = None,
                 abort: bool = False,
                 flight_recorder=None):
        if timeout_s <= 0:
            raise ValueError("timeout_s must be > 0 (use "
                             "configure_watchdog(0) to disable)")
        self.timeout_s = float(timeout_s)
        self._poll_s = poll_interval_s or max(0.05,
                                              min(1.0, timeout_s / 4.0))
        self._on_stall = on_stall
        self._abort = abort
        self._recorder = flight_recorder
        registry = registry or get_registry()
        self._stall = StallAttributor(registry)
        self._stalls_counter = registry.counter(
            "watchdog/stalls_total",
            "threads that missed their heartbeat deadline")
        self._threads_gauge = registry.gauge(
            "watchdog/threads", "heartbeats currently armed")
        self._threads_gauge.set_fn(self._armed_count)
        registry.gauge("watchdog/timeout_s",
                       "configured heartbeat deadline").set(self.timeout_s)
        # name -> (last touch, armed): plain dict stores, atomic in
        # CPython; the monitor iterates over a copy.
        self._beats: Dict[str, Tuple[float, bool]] = {}
        self._reported: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- hot path ----------------------------------------------------------

    def touch(self, name: Optional[str] = None):
        """Record progress for (and arm) this heartbeat."""
        self._beats[name or threading.current_thread().name] = (
            time.monotonic(), True)

    def suspend(self, name: Optional[str] = None):
        """Disarm before a wait that is not a wedge."""
        self._beats[name or threading.current_thread().name] = (
            time.monotonic(), False)

    # -- monitor -----------------------------------------------------------

    def _armed_count(self) -> float:
        return float(sum(1 for _, armed in list(self._beats.values())
                         if armed))

    def stale_threads(self, now: Optional[float] = None
                      ) -> List[Tuple[str, float]]:
        """Armed heartbeats older than the deadline, worst first."""
        now = time.monotonic() if now is None else now
        stale = [(name, now - last)
                 for name, (last, armed) in list(self._beats.items())
                 if armed and now - last > self.timeout_s]
        stale.sort(key=lambda item: -item[1])
        return stale

    def check_once(self) -> List[Tuple[str, float]]:
        """One monitor pass: fire for heartbeats newly stale since the
        last pass; re-assert the verdict's gauges while a wedge
        persists (the driver's interval attribution clears them)."""
        stale = self.stale_threads()
        stale_names = {name for name, _ in stale}
        new = stale_names - self._reported
        self._reported &= stale_names
        if new:
            self._reported |= new
            self._fire(stale, new_count=len(new))
        elif stale:
            self._stall.report_stalled(dict(stale), count=False)
        return stale

    def _fire(self, stale: List[Tuple[str, float]], new_count: int):
        self._stalls_counter.inc(new_count)
        verdict = self._stall.report_stalled(dict(stale))
        log.error("watchdog: %s (deadline %.1fs) — dumping flight "
                  "recorder + thread stacks", verdict, self.timeout_s)
        recorder = self._recorder or get_flight_recorder()
        recorder.record("stalled_thread", ",".join(n for n, _ in stale),
                        {"ages_s": {n: round(a, 3) for n, a in stale}})
        # A bounded dump on a helper thread: the dump needs the tracer's
        # lock and the logdir, either of which may be what wedged.
        dumper = threading.Thread(
            target=recorder.dump_all,
            args=("watchdog:" + ",".join(name for name, _ in stale),),
            daemon=True, name="flightrec-dump")
        dumper.start()
        dumper.join(timeout=15.0)
        if self._on_stall is not None:
            try:
                self._on_stall(stale)
            except Exception:
                log.exception("watchdog on_stall callback failed")
        if self._abort:
            # Imported here: the runtime package imports obs.
            from scalable_agent_tpu_torch.runtime.exit_codes import (
                WATCHDOG_EXIT_CODE,
            )

            log.error("watchdog: aborting the run (exit %d) — artifacts "
                      "in %s", WATCHDOG_EXIT_CODE,
                      recorder.logdir or "<no logdir>")
            os._exit(WATCHDOG_EXIT_CODE)

    def _monitor_loop(self):
        while not self._stop.wait(self._poll_s):
            try:
                self.check_once()
                (self._recorder or get_flight_recorder()).record(
                    "heartbeat_scan", "watchdog",
                    {"armed": int(self._armed_count())})
            except Exception:  # the monitor must never die silently
                log.exception("watchdog monitor pass failed")

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor_loop, daemon=True, name="watchdog")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # Unbind the callback: the process-global registry must not keep a
        # stopped watchdog alive or report its frozen count.
        self._threads_gauge.set(0.0)


class _DisabledWatchdog:
    """Null object: ``touch()`` is one no-op call."""

    enabled = False
    timeout_s = 0.0

    def touch(self, name: Optional[str] = None):
        pass

    def suspend(self, name: Optional[str] = None):
        pass

    def stop(self):
        pass


_DISABLED = _DisabledWatchdog()
_watchdog = _DISABLED
_watchdog_lock = threading.Lock()


def get_watchdog():
    return _watchdog


def configure_watchdog(timeout_s: Optional[float], **kwargs):
    """Install (and return) the process-global watchdog; ``None``/``0``
    stops a live monitor and restores the disabled one."""
    global _watchdog
    with _watchdog_lock:
        old, _watchdog = _watchdog, _DISABLED
        old.stop()
        if timeout_s and timeout_s > 0:
            _watchdog = Watchdog(timeout_s, **kwargs).start()
        return _watchdog
