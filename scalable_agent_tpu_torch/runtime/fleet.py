"""Preemption grace for a single-process run: SIGTERM drains the loop to
one verified final checkpoint and a clean exit instead of killing it.

The single-process part of ``scalable_agent_tpu/runtime/fleet.py``:

- ``GraceWindow``: the grace deadline, anchored at the first observation
  of the preemption, with an injectable clock.
- ``PreemptionMonitor``, cut down from ``FleetMonitor``: the preemption
  flag (``preemption_requested``, ``request_preemption``,
  ``note_preempt_decision``), the SIGTERM handler (installed only when
  ``preemption_grace_s > 0``), and a monitor thread whose cycle hosts the
  ``preempt_sigterm`` fault point (the process SIGTERMs itself) and
  enforces the deadline: a drain still running when the grace expires
  exits 72 (``runtime/exit_codes.py``).
- ``install_preemption_handler``: the first SIGTERM only sets the flag
  and opens the window (the driver acts at its next decision point); a
  second one escalates to an immediate exit (the previous handler, or
  ``SystemExit(143)``).

The handler is a Python signal handler of the main thread; the env
worker processes are started with ``spawn`` and do not inherit it.
Peers, heartbeats over a KV store and collective deadlines are not
ported yet (ROADMAP.md, queue 1).
"""

import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional

from scalable_agent_tpu_torch.runtime.exit_codes import FLEET_EXIT_CODE
from scalable_agent_tpu_torch.runtime.faults import get_fault_injector

log = logging.getLogger("scalable_agent_tpu_torch")

# The monitor's cycle: the grace deadline is checked, and the
# preempt_sigterm point evaluated, once per cycle.  The JAX monitor polls
# at most once a second.
POLL_INTERVAL_S = 1.0


class GraceWindow:
    """Preemption-grace deadline accounting, injectable clock.

    ``open()`` is idempotent: the deadline is anchored at the FIRST
    observation of the preemption, so observing it again can never
    extend the window.
    """

    def __init__(self, grace_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.grace_s = float(grace_s)
        self._clock = clock
        self._opened_at: Optional[float] = None
        self.reason = ""

    @property
    def opened(self) -> bool:
        return self._opened_at is not None

    def open(self, reason: str = "") -> bool:
        """Anchor the window now (first call only).  True when this call
        newly opened it."""
        if self._opened_at is not None:
            return False
        self._opened_at = self._clock()
        self.reason = reason
        return True

    def remaining(self) -> float:
        """Seconds left before the hard deadline (inf while closed,
        clamped at 0 once blown)."""
        if self._opened_at is None:
            return float("inf")
        return max(0.0, self._opened_at + self.grace_s - self._clock())

    def expired(self) -> bool:
        return (self._opened_at is not None
                and self._clock() - self._opened_at > self.grace_s)


class PreemptionMonitor:
    """The preemption flag, its grace deadline and the SIGTERM handler.

    With ``preemption_grace_s <= 0`` the monitor is inert: ``start``
    installs no handler and starts no thread, so SIGTERM keeps its default
    action.  ``on_fatal(code)`` ends the process when the grace expires
    (``os._exit`` unless a test injects another).
    """

    def __init__(self, preemption_grace_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_fatal: Optional[Callable[[int], None]] = None):
        self.preemption_grace_s = float(preemption_grace_s)
        self._grace = GraceWindow(self.preemption_grace_s, clock=clock)
        self._on_fatal = on_fatal or (lambda code: os._exit(code))
        # Hot-path flag: one attribute read per driver iteration.
        self._preempt = False
        self._preempt_reason = ""
        self._announce_needed = False
        self._fatal_fired = False
        # Preemptions this run acted on or observed (at most 1).
        self.preemptions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._uninstall_signal: Optional[Callable[[], None]] = None

    @property
    def enabled(self) -> bool:
        return self.preemption_grace_s > 0

    def preemption_requested(self) -> bool:
        return self._preempt

    def request_preemption(self, reason: str):
        """Raise the flag (the SIGTERM handler's path).  Safe in a signal
        handler: flag stores and a clock read only; the log line comes
        from the monitor thread."""
        newly = self._grace.open(reason)
        self._preempt = True
        self._preempt_reason = self._preempt_reason or reason
        if newly:
            self._announce_needed = True

    def note_preempt_decision(self, update: int):
        """The driver committed to the drain at ``update``: anchor the
        window if nothing else has, and count the preemption."""
        self._grace.open("decision")
        self._preempt = True
        self.preemptions = 1
        log.warning("preemption drain at update %d (%.1fs of grace left)",
                    update, self._grace.remaining())

    def monitor_once(self):
        """One monitor pass: the fault point, the deferred announcement,
        the grace deadline."""
        if self._fatal_fired:
            return
        injector = get_fault_injector()
        if injector.active and injector.should_fire("preempt_sigterm"):
            log.warning("chaos: preempt_sigterm — SIGTERMing self")
            os.kill(os.getpid(), signal.SIGTERM)
        if self._announce_needed:
            self._announce_needed = False
            self.preemptions = 1
            log.warning("preemption requested (%s): draining to a final "
                        "checkpoint within %.0fs", self._preempt_reason,
                        self.preemption_grace_s)
        if self._grace.expired():
            self._fatal_fired = True
            log.error("preemption grace of %.0fs expired before the drain "
                      "finished (%s); exiting %d (a restart resumes from "
                      "the last checkpoint)", self.preemption_grace_s,
                      self._grace.reason, FLEET_EXIT_CODE)
            self._on_fatal(FLEET_EXIT_CODE)

    def _monitor_loop(self):
        while not self._stop.wait(POLL_INTERVAL_S):
            try:
                self.monitor_once()
            except Exception:  # must never die silently
                log.exception("preemption monitor pass failed")

    def start(self) -> "PreemptionMonitor":
        """Take over SIGTERM and start the monitor thread (when
        enabled)."""
        if not self.enabled:
            return self
        if self._uninstall_signal is None:
            self._uninstall_signal = install_preemption_handler(self)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="preemption-monitor")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._uninstall_signal is not None:
            self._uninstall_signal()
            self._uninstall_signal = None


def install_preemption_handler(monitor: PreemptionMonitor,
                               handled_signals=(signal.SIGTERM,)
                               ) -> Callable[[], None]:
    """SIGTERM -> preemption grace instead of the default termination.

    The first SIGTERM records the request and returns: the run keeps
    control and drains to its final checkpoint, bounded by the grace
    deadline.  A second one chains to the previous handler, or raises
    ``SystemExit(128 + signum)``, for an operator who wants out now.
    Handlers need the main thread; elsewhere nothing is installed.
    Returns the function that restores the previous handlers.
    """
    prev: Dict[int, object] = {}
    installed: Dict[int, object] = {}
    signalled = set()
    try:
        for sig in handled_signals:
            def _on_signal(signum, frame):
                if signum in signalled:
                    handler = prev.get(signum)
                    if callable(handler):
                        handler(signum, frame)
                        return
                    raise SystemExit(128 + signum)
                signalled.add(signum)
                monitor.request_preemption(
                    f"signal:{signal.Signals(signum).name}")

            prev[sig] = signal.signal(sig, _on_signal)
            installed[sig] = _on_signal
    except ValueError:  # not the main thread
        prev.clear()
        installed.clear()

    def uninstall():
        # Identity-checked: restore only what is still ours.
        for sig, handler in prev.items():
            try:
                if signal.getsignal(sig) is installed.get(sig):
                    signal.signal(sig, handler)
            except ValueError:
                pass

    return uninstall
