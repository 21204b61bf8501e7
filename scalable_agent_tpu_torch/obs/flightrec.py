"""Flight recorder: the failure-path record of a run.

A copy of ``scalable_agent_tpu/obs/flightrec.py``.  ``FlightRecorder`` is
an always-on ring of the last ~64k structured runtime events (unrolls,
queue hand-offs, update numbers, watchdog scans, faults, completed spans
while tracing); an event is one ``deque.append``, atomic in CPython, so
recording takes no lock.  ``dump_all`` writes what a post-mortem needs:

- ``<logdir>/flightrec.<pid>.json``: the ring, the registry snapshot and
  the clock epochs (tmp + rename);
- ``<logdir>/stacks.<pid>.txt``: a ``faulthandler`` dump of every
  thread's Python stack;
- a final ``metrics.prom`` through the attached exporter, and the
  tracer's buffered tail.

``reason_pin`` keeps the root cause on top: once a verdict sets it (the
health plane's trip, ``obs/health.py``), every later dump still rewrites
the file with the newer events but keeps the pinned reason, and its own
becomes ``secondary_reason``.

``install_crash_handlers`` wires the dump to SIGTERM/SIGINT (dump, then
``SystemExit(128 + signum)`` / ``KeyboardInterrupt``, so the driver's
``finally`` still runs), to ``sys.excepthook`` and to
``threading.excepthook`` (dump, then chain to the previous hook).  The
watchdog (``obs/watchdog.py``) calls the same dump on a stale heartbeat.
"""

import faulthandler
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "configure_flight_recorder",
    "get_flight_recorder",
    "install_crash_handlers",
]

_SCHEMA_VERSION = 1


def _perf_us() -> int:
    return time.perf_counter_ns() // 1000


class FlightRecorder:
    """Ring buffer of ``(ts_us, kind, name, thread, args)`` events, on the
    tracer's ``perf_counter`` microsecond clock (a dump and a trace of one
    process align directly; the unix-time epoch pair aligns processes)."""

    def __init__(self, capacity: int = 65536,
                 logdir: Optional[str] = None,
                 registry=None):
        self.capacity = capacity
        self.logdir = logdir
        self.exporter = None  # a PrometheusExporter, set by the driver
        self._registry = registry
        self._events = deque(maxlen=capacity)
        self._thread_names: Dict[int, str] = {}
        self._epoch_unix_us = int(time.time() * 1e6)
        self._epoch_perf_us = _perf_us()
        self._dump_lock = threading.Lock()
        self._dump_all_lock = threading.Lock()
        self.dump_count = 0
        self.last_dump_reason: Optional[str] = None
        # Set by the signal handler, so the driver's teardown (on a clean
        # stack) can complete the dump when the handler's own attempt was
        # abandoned.
        self.pending_dump_reason: Optional[str] = None
        # The root cause's reason, kept by every later dump (None: each
        # dump states its own).
        self.reason_pin: Optional[str] = None

    # -- recording (hot path) ----------------------------------------------

    def _thread_name(self) -> str:
        ident = threading.get_ident()
        tname = self._thread_names.get(ident)
        if tname is None:
            tname = threading.current_thread().name
            self._thread_names[ident] = tname
        return tname

    def record(self, kind: str, name: str, args: Optional[dict] = None):
        """Append one event: a dict hit for the thread name and one atomic
        deque append."""
        self._events.append(
            (_perf_us(), kind, name, self._thread_name(), args))

    def record_span(self, name: str, cat: str, ts_us: int, dur_us: int):
        """A completed span, fed by the tracer while it traces."""
        self._events.append(
            (ts_us, "span", name, self._thread_name(),
             {"cat": cat, "dur_us": dur_us}))

    def snapshot(self) -> List[dict]:
        """The ring's contents, oldest first, as dicts."""
        return [
            {"ts_us": ts, "kind": kind, "name": name, "thread": thread,
             **({"args": args} if args else {})}
            for ts, kind, name, thread, args in list(self._events)
        ]

    # -- dumping (failure path) --------------------------------------------

    def dump_path(self) -> Optional[str]:
        if self.logdir is None:
            return None
        return os.path.join(self.logdir, f"flightrec.{os.getpid()}.json")

    def stacks_path(self) -> Optional[str]:
        if self.logdir is None:
            return None
        return os.path.join(self.logdir, f"stacks.{os.getpid()}.txt")

    def dump(self, reason: str, path: Optional[str] = None
             ) -> Optional[str]:
        """Write the recorder's JSON atomically, under ``reason_pin`` when
        one is set; the path, or None without a logdir.  A dump already
        in progress (a signal landing mid-dump on the same thread) makes
        this one a no-op instead of a deadlock."""
        path = path or self.dump_path()
        if path is None:
            return None
        if not self._dump_lock.acquire(blocking=False):
            return None
        try:
            secondary = None
            if self.reason_pin is not None and reason != self.reason_pin:
                secondary, reason = reason, self.reason_pin
            self.dump_count += 1
            self.last_dump_reason = reason
            try:
                metrics = self._registry_snapshot()
            except Exception:
                metrics = {}
            payload = {
                "schema_version": _SCHEMA_VERSION,
                "reason": reason,
                **({"secondary_reason": secondary} if secondary else {}),
                "pid": os.getpid(),
                "process_index": 0,
                "dump_count": self.dump_count,
                "epoch_unix_us": self._epoch_unix_us,
                "epoch_perf_us": self._epoch_perf_us,
                "dumped_at_unix_us": int(time.time() * 1e6),
                "capacity": self.capacity,
                "metrics": metrics,
                "events": self.snapshot(),
            }
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        finally:
            self._dump_lock.release()
        return path

    def dump_stacks(self, path: Optional[str] = None) -> Optional[str]:
        """``faulthandler`` dump of every thread's Python stack."""
        path = path or self.stacks_path()
        if path is None:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(f"# all-thread stack dump pid={os.getpid()} "
                    f"reason={self.last_dump_reason}\n")
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
        return path

    def dump_all(self, reason: str) -> Optional[str]:
        """The whole forensic drop: the ring's JSON, every thread's stack,
        a final Prometheus snapshot and the tracer's buffered tail.  Never
        raises.  One writer at a time: a concurrent caller skips, the dump
        in flight is current enough."""
        if not self._dump_all_lock.acquire(blocking=False):
            return None
        try:
            try:
                path = self.dump(reason)
            except Exception:
                path = None
            try:
                self.dump_stacks()
            except Exception:
                pass
            if self.exporter is not None:
                try:
                    self.exporter.dump()
                except Exception:
                    pass
            try:
                # The watchdog's abort exits with os._exit: nothing else
                # would flush the most recent spans.  (Imported here:
                # trace.py imports this module.)
                from scalable_agent_tpu_torch.obs.trace import get_tracer

                get_tracer().flush()
            except Exception:
                pass
        finally:
            self._dump_all_lock.release()
        return path

    def _registry_snapshot(self) -> Dict[str, float]:
        registry = self._registry
        if registry is None:
            from scalable_agent_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        return registry.snapshot()


# Always live: a recorder without a logdir still records, and its dumps go
# nowhere until the driver configures one.
_recorder = FlightRecorder()
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def configure_flight_recorder(logdir: Optional[str],
                              registry=None) -> FlightRecorder:
    """Install (and return) a fresh process-global recorder dumping into
    ``logdir``; ``None`` restores one without a destination."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder(logdir=logdir, registry=registry)
        return _recorder


def install_crash_handlers(recorder: Optional[FlightRecorder] = None
                           ) -> Callable[[], None]:
    """Dump the flight recorder on the ways a run dies.

    - SIGTERM/SIGINT: dump on a helper thread joined for at most 5 s (the
      handler may have interrupted a frame holding the tracer's or an
      instrument's lock, which an inline dump would deadlock on), then
      raise ``SystemExit(128 + signum)`` / ``KeyboardInterrupt``; the
      driver's teardown completes the dump from ``pending_dump_reason``.
      Handlers need the main thread; elsewhere this layer is skipped.
    - ``sys.excepthook`` / ``threading.excepthook``: dump, then chain to
      the previous hook.

    Returns ``uninstall()``, which restores each previous hook only where
    this call's hook is still the installed one, so handlers layered on
    top later (the preemption handler, ``runtime/fleet.py``) are never
    clobbered, and must be unwound first.
    """
    rec = recorder or get_flight_recorder()
    prev_signal = {}
    installed_signal = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            def _on_signal(signum, frame):
                name = signal.Signals(signum).name
                rec.record("signal", name)
                rec.pending_dump_reason = f"signal:{name}"
                dumper = threading.Thread(
                    target=rec.dump_all, args=(f"signal:{name}",),
                    daemon=True, name="flightrec-dump")
                dumper.start()
                dumper.join(timeout=5.0)
                if signum == signal.SIGINT:
                    raise KeyboardInterrupt
                raise SystemExit(128 + signum)

            prev_signal[sig] = signal.signal(sig, _on_signal)
            installed_signal[sig] = _on_signal
    except ValueError:  # not the main thread
        prev_signal.clear()
        installed_signal.clear()

    prev_sys_hook = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        rec.record("exception", exc_type.__name__, {"where": "main"})
        rec.dump_all(f"exception:{exc_type.__name__}")
        prev_sys_hook(exc_type, exc, tb)

    sys.excepthook = _sys_hook

    prev_thread_hook = threading.excepthook

    def _thread_hook(args):
        name = getattr(args.exc_type, "__name__", "Exception")
        thread_name = getattr(args.thread, "name", "?")
        rec.record("exception", name, {"where": thread_name})
        rec.dump_all(f"exception:{name}:{thread_name}")
        prev_thread_hook(args)

    threading.excepthook = _thread_hook

    def uninstall():
        for sig, prev in prev_signal.items():
            try:
                if signal.getsignal(sig) is installed_signal[sig]:
                    signal.signal(sig, prev)
            except ValueError:
                pass
        if sys.excepthook is _sys_hook:
            sys.excepthook = prev_sys_hook
        if threading.excepthook is _thread_hook:
            threading.excepthook = prev_thread_hook

    return uninstall
