"""Host-side span tracing, written as Chrome trace events.

A copy of ``scalable_agent_tpu/obs/trace.py``.  The pipeline's stages live
on host threads (actor unrolls, the prefetch thread's transport, the
learner loop); a ``Tracer`` records their nested spans per (process,
thread) and writes them in the Chrome trace-event format, one JSON event
per line, which Perfetto (https://ui.perfetto.dev) and chrome://tracing
load.  Each thread gets its own ``tid`` and a ``thread_name`` metadata
event.

While a ``--profile_dir`` window records, the driver turns on
``set_annotate(True)``: every span then also opens a
``torch.profiler.record_function`` range of the same name, so the
profiler's timeline shows the host spans beside the kernels they
launched (the JAX package opens a ``jax.profiler.TraceAnnotation``).  The
ranges open whether or not the tracer writes a file: the kernel table
(``obs/kernels.py``) finds the learner's update by its
``learner/update`` range, where the JAX table reads the update's HLO
module.  The range costs far more than the span, so it is off otherwise.

A disabled tracer's ``span()`` returns one shared no-op context manager
(a range only, while it annotates).
The file's first line is ``[`` and every event line ends with a comma:
the Trace Event format allows the unclosed array, so the file is
appendable and still loadable after a crash.  At most ``max_events``
events are written; the last is a ``trace_truncated`` marker, and the
tracer disables itself.  ``load_trace_events`` parses a file back.
"""

import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from scalable_agent_tpu_torch.obs.flightrec import (
    get_flight_recorder as _flight_recorder,
)

__all__ = [
    "Tracer",
    "configure_tracer",
    "get_tracer",
    "load_trace_events",
    "span",
]

# The event budget (~100 bytes an event, so ~200 MB of file), and how
# many buffered events are written at once.
MAX_EVENTS = 2_000_000
FLUSH_EVERY_EVENTS = 8192


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_start_us",
                 "_annotation")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._annotation = None

    def __enter__(self):
        tracer = self._tracer
        if tracer._annotate:
            try:
                import torch.profiler

                self._annotation = torch.profiler.record_function(
                    self._name)
                self._annotation.__enter__()
            except Exception:  # profiler unavailable: spans still record
                tracer._annotate = False
        self._start_us = time.perf_counter_ns() // 1000
        return self

    def __exit__(self, *exc_info):
        end_us = time.perf_counter_ns() // 1000
        if self._annotation is not None:
            self._annotation.__exit__(*exc_info)
        if self._tracer.enabled:
            self._tracer._complete(
                self._name, self._cat, self._start_us,
                end_us - self._start_us, self._args)
        return False


class Tracer:
    """Collects spans and writes Chrome trace events to ``path``; spans on
    one (pid, tid) track nest by their intervals."""

    def __init__(self, path: Optional[str] = None,
                 max_events: int = MAX_EVENTS):
        self.path = path
        self.enabled = path is not None
        self._annotate = False
        self._remaining_events = max_events
        self._lock = threading.Lock()
        self._events: List[str] = []  # preformatted JSON event lines
        self._file = None
        self._named_tids: Dict[int, str] = {}
        self._pid = os.getpid()
        if self.enabled:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._file = open(path, "w")
            self._file.write("[\n")
            self._meta("process_name", {"name": "scalable_agent_tpu_torch"})
            self._meta("process_sort_index", {"sort_index": 0})
            # The clock epoch: event timestamps are this process's
            # perf_counter microseconds; this (unix, perf) pair maps them
            # onto wall time.
            perf_us = time.perf_counter_ns() // 1000
            unix_us = int(time.time() * 1e6)
            self._push(json.dumps({
                "name": "trace_epoch", "ph": "i", "s": "g", "cat": "meta",
                "ts": perf_us, "pid": self._pid, "tid": 0,
                "args": {"unix_time_us": unix_us,
                         "perf_time_us": perf_us,
                         "process_index": 0}}))

    def set_annotate(self, flag: bool):
        """Open a ``torch.profiler.record_function`` range per span (on
        only while a profiler window records), with or without a file."""
        self._annotate = bool(flag)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "pipeline",
             args: Optional[dict] = None):
        """Context manager timing one nested span."""
        if not self.enabled:
            return _Span(self, name, cat, args) if self._annotate else (
                _NULL_SPAN)
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "pipeline",
                args: Optional[dict] = None):
        """A zero-duration marker."""
        if not self.enabled:
            return
        self._push(json.dumps({
            "name": name, "ph": "i", "cat": cat, "s": "t",
            "ts": time.perf_counter_ns() // 1000,
            "pid": self._pid, "tid": self._tid(), "args": args or {}}))

    def counter(self, name: str, values: Dict[str, float]):
        """A Chrome counter-track sample."""
        if not self.enabled:
            return
        self._push(json.dumps({
            "name": name, "ph": "C",
            "ts": time.perf_counter_ns() // 1000,
            "pid": self._pid, "tid": 0,
            "args": {k: float(v) for k, v in values.items()}}))

    def _complete(self, name, cat, ts, dur, args):
        # The flight recorder's ring keeps the spans an unflushed trace
        # tail would lose in a crash.
        _flight_recorder().record_span(name, cat, ts, dur)
        # Span names and categories are code literals: format the line
        # directly, and take json.dumps only for a quote or backslash.
        if '"' in name or "\\" in name or '"' in cat or "\\" in cat:
            event = {"name": name, "ph": "X", "cat": cat, "ts": ts,
                     "dur": dur, "pid": self._pid, "tid": self._tid()}
            if args:
                event["args"] = args
            self._push(json.dumps(event))
            return
        suffix = (", \"args\": %s}" % json.dumps(args)) if args else "}"
        self._push(
            '{"name": "%s", "ph": "X", "cat": "%s", "ts": %d, '
            '"dur": %d, "pid": %d, "tid": %d%s'
            % (name, cat, ts, dur, self._pid, self._tid(), suffix))

    def _tid(self) -> int:
        tid = threading.get_ident()
        if tid not in self._named_tids:
            name = threading.current_thread().name
            self._named_tids[tid] = name
            self._meta("thread_name", {"name": name}, tid=tid)
        return tid

    def _meta(self, name: str, args: dict, tid: int = 0):
        self._push(json.dumps({"name": name, "ph": "M", "pid": self._pid,
                               "tid": tid, "args": args}))

    def _push(self, line: str):
        with self._lock:
            if self._remaining_events <= 0:
                return
            self._remaining_events -= 1
            self._events.append(line)
            if self._remaining_events == 0:
                self._events.append(json.dumps({
                    "name": "trace_truncated", "ph": "i", "s": "g",
                    "cat": "pipeline",
                    "ts": time.perf_counter_ns() // 1000,
                    "pid": self._pid, "tid": 0,
                    "args": {"reason": "max_events budget exhausted"}}))
                self.enabled = False
            if len(self._events) >= FLUSH_EVERY_EVENTS:
                self._flush_locked()

    # -- lifecycle ---------------------------------------------------------

    def _flush_locked(self):
        if self._file is None or not self._events:
            self._events.clear()
            return
        self._file.write(",\n".join(self._events) + ",\n")
        self._events.clear()
        self._file.flush()

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None
            self.enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()


# Instrumented modules call ``span(...)`` against this process-global
# tracer; the driver installs a file-backed one under --trace and the
# disabled one again at the end of the run.
_tracer = Tracer(path=None)
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _tracer


def configure_tracer(path: Optional[str], **kwargs) -> Tracer:
    """Install (and return) the process-global tracer; ``path=None``
    restores the disabled one.  The previous file-backed tracer is closed
    (its tail flushed)."""
    global _tracer
    with _tracer_lock:
        old, _tracer = _tracer, Tracer(path=path, **kwargs)
        # On the file, not on ``enabled``: a tracer past its event budget
        # is disabled but still holds its tail and the open file.
        if old._file is not None:
            old.close()
        return _tracer


def span(name: str, cat: str = "pipeline", args: Optional[dict] = None):
    """``with obs.span('learner/update'):`` against the global tracer."""
    return _tracer.span(name, cat=cat, args=args)


def load_trace_events(path: str) -> Iterator[dict]:
    """Parse a trace file written by ``Tracer``, tolerating the unclosed
    array and a torn last line."""
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
