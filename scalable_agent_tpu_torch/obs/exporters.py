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

``MetricsHTTPServer`` (``--metrics_http_port``) is not ported yet: its
``/health`` route serves ``obs.watch``'s payload, which comes with the
obs consumers (ROADMAP.md, queue 1).
"""

import json
import os
import re
import time
from typing import Dict, Optional

from scalable_agent_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = ["MetricsWriter", "PrometheusExporter", "render_prometheus"]

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
