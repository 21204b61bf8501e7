"""Exporters: the Prometheus text snapshot and the scalar JSONL/TensorBoard
writer, both over one registry (``obs/registry.py``).

The part of ``scalable_agent_tpu/obs/exporters.py`` a run arms:

- ``render_prometheus`` / ``PrometheusExporter``: the text exposition
  format (version 0.0.4) with the JAX package's names (``impala_`` plus
  the registry name with every character outside ``[a-zA-Z0-9_:]`` made
  ``_``), written atomically to ``<logdir>/metrics.prom``.  Histograms
  render as summaries.
- ``MetricsWriter``: one JSON object per row in ``<logdir>/metrics.jsonl``
  (``{"step": int, "time": unix seconds, <name>: float, ...}``, the
  reference's metric names), and the same scalars to TensorBoard under
  ``<logdir>/summaries`` when ``tensorboardX`` imports.
  ``write_registry`` appends the registry snapshot as one more row, its
  names prefixed ``obs/``.

- ``MetricsHTTPServer`` (``--metrics_http_port``): the registry's live
  exposition text on ``/metrics``, and, with a logdir, the tail of
  ``anomalies.jsonl`` on ``/anomalies`` and ``obs.watch``'s payload on
  ``/health``, beside the ``aggregate``, ``report``, ``diagnose`` and
  ``watch`` CLIs that read the same files off disk.
"""

import json
import os
import re
import threading
import time
from typing import Dict, Optional

from scalable_agent_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = ["MetricsHTTPServer", "MetricsWriter", "PrometheusExporter",
           "render_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "impala_"
# Rows are flushed to disk at most this often, and at close().
FLUSH_EVERY_S = 5.0


def _prom_name(name: str) -> str:
    """Registry name (slash-namespaced) -> Prometheus metric name."""
    sanitized = _NAME_RE.sub("_", name)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return _PREFIX + sanitized


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    return repr(float(value))


def render_prometheus(registry: MetricsRegistry) -> str:
    """Registry -> Prometheus text exposition format (version 0.0.4)."""
    lines = []
    for instrument in registry.instruments():
        name = _prom_name(instrument.name)
        if instrument.help:
            lines.append(f"# HELP {name} {instrument.help}")
        if isinstance(instrument, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(instrument.value)}")
        elif isinstance(instrument, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(instrument.value)}")
        elif isinstance(instrument, Histogram):
            lines.append(f"# TYPE {name} summary")
            for q, value in instrument.quantiles().items():
                lines.append(
                    f'{name}{{quantile="{q:g}"}} {_fmt(value)}')
            lines.append(f"{name}_sum {_fmt(instrument.sum)}")
            lines.append(f"{name}_count {instrument.count}")
    return "\n".join(lines) + "\n"


class PrometheusExporter:
    """``dump()`` atomically rewrites ``path`` with the current exposition
    text (tmp + rename, so a scraper never reads a torn file)."""

    def __init__(self, registry: MetricsRegistry, path: str):
        self._registry = registry
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def dump(self) -> str:
        text = render_prometheus(self._registry)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, self.path)
        return text


class MetricsHTTPServer:
    """A stdlib Prometheus scrape endpoint (``--metrics_http_port``).

    Serves the registry's CURRENT exposition text on ``/metrics`` (and
    ``/``) so scrapers don't have to poll ``<logdir>/metrics.prom`` off
    disk.  With a ``logdir``, two run-health routes ride the same
    already-open port so a remote rig needs no extra listener:
    ``/anomalies`` (the tail of ``anomalies.jsonl``, NDJSON — empty
    200 when the run has none) and ``/health`` (the ``obs.watch
    --once --json`` payload; 503 until the first prom snapshot lands).
    ``http.server.ThreadingHTTPServer`` on a daemon thread — rendering
    happens per request, never on the training hot path.  ``port=0``
    binds an ephemeral port (tests); read ``.port`` for the bound
    value.
    """

    ANOMALIES_TAIL_LINES = 64

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0", logdir: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                route = self.path.split("?")[0]
                if route == "/anomalies" and outer._logdir:
                    self._send(outer._anomalies_body(),
                               "application/x-ndjson")
                    return
                if route == "/health" and outer._logdir:
                    try:
                        payload = outer._health_payload()
                    except FileNotFoundError as exc:
                        # Detail goes in the body: the status line is
                        # latin-1 only and the diagnosis may not be.
                        self.send_error(503, "no metrics snapshot yet",
                                        str(exc))
                        return
                    except Exception as exc:
                        self.send_error(500, "health payload failed",
                                        str(exc))
                        return
                    self._send(json.dumps(payload).encode() + b"\n",
                               "application/json")
                    return
                if route not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(outer._registry).encode()
                except Exception as exc:  # a dying gauge must 500, not die
                    self.send_error(500, str(exc))
                    return
                self._send(
                    body, "text/plain; version=0.0.4; charset=utf-8")

            def _send(self, body: bytes, content_type: str):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no per-scrape stdout spam
                pass

        self._registry = registry
        self._logdir = logdir
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-http")
        self._thread.start()

    def _anomalies_body(self) -> bytes:
        """The anomalies.jsonl tail as NDJSON; an absent file is an
        empty (valid) stream, not an error — the run has no anomalies
        yet."""
        from scalable_agent_tpu_torch.obs.health import ANOMALIES_JSONL

        path = os.path.join(self._logdir, ANOMALIES_JSONL)
        try:
            lines = open(path).read().splitlines()
        except OSError:
            return b""
        tail = lines[-self.ANOMALIES_TAIL_LINES:]
        return ("\n".join(tail) + "\n").encode() if tail else b""

    def _health_payload(self) -> dict:
        # Lazy import: watch pulls the report's parsing, none of which
        # belongs on the exporter's import path for plain scrapes.
        from scalable_agent_tpu_torch.obs.watch import build_payload

        return build_payload(self._logdir)

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


class MetricsWriter:
    """Scalar metrics to ``metrics.jsonl`` (and TensorBoard when
    ``tensorboardX`` imports); rows are flushed at most every
    ``FLUSH_EVERY_S`` and at ``close()``.  A context manager."""

    def __init__(self, logdir: str,
                 registry: Optional[MetricsRegistry] = None):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._last_flush = 0.0
        self._registry = registry
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(os.path.join(logdir, "summaries"))
        except ImportError:
            self._tb = None

    def write(self, step: int, scalars: Dict[str, float],
              wall_time: Optional[float] = None):
        if wall_time is None:
            wall_time = time.time()
        record = {"step": int(step), "time": wall_time}
        for key, value in scalars.items():
            value = float(value)
            record[key] = value
            if self._tb is not None:
                self._tb.add_scalar(key, value, global_step=step,
                                    walltime=wall_time)
        self._jsonl.write(json.dumps(record) + "\n")
        now = time.monotonic()
        if now - self._last_flush > FLUSH_EVERY_S:
            self.flush()
            self._last_flush = now

    def write_registry(self, step: int,
                       wall_time: Optional[float] = None):
        """Append the registry snapshot as one row, its names prefixed
        ``obs/`` so they never collide with the training metrics'."""
        if self._registry is None:
            return
        self.write(step,
                   {"obs/" + k: v
                    for k, v in self._registry.snapshot().items()},
                   wall_time=wall_time)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False
