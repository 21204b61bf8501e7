"""Scalar metrics to ``<logdir>/metrics.jsonl``.

The JSONL half of ``scalable_agent_tpu/obs/exporters.py::MetricsWriter``:
one JSON object per row, ``{"step": int, "time": unix seconds, <name>:
float, ...}``, under the reference's metric names (experiment.py:423-425,
:643-664).  The TensorBoard half, the metrics registry and the Prometheus
snapshot are not ported yet (ROADMAP.md, queue 1).
"""

import json
import os
import time
from typing import Dict

# Rows are flushed to disk at most this often, and at close().
FLUSH_EVERY_S = 5.0


class MetricsWriter:
    """Appends metric rows; ``close()`` flushes them."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._last_flush = 0.0

    def write(self, step: int, scalars: Dict[str, float]):
        record = {"step": int(step), "time": time.time()}
        record.update((key, float(value)) for key, value in scalars.items())
        self._jsonl.write(json.dumps(record) + "\n")
        now = time.monotonic()
        if now - self._last_flush > FLUSH_EVERY_S:
            self._jsonl.flush()
            self._last_flush = now

    def close(self):
        self._jsonl.flush()
        self._jsonl.close()
