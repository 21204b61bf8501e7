"""Moving-average timers: the part of ``scalable_agent_tpu/utils/timing.py``
(reference: utils/timing.py:8-64) the training loop uses, ``time_avg``."""

import time
from collections import deque
from typing import Dict

# Measurements each moving average keeps, as in the reference.
AVG_WINDOW = 50


class AvgTime:
    """Moving average over the last ``AVG_WINDOW`` measurements."""

    def __init__(self):
        self.values = deque(maxlen=AVG_WINDOW)

    def add(self, value: float):
        self.values.append(value)

    @property
    def value(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    def __str__(self):
        return f"{self.value:.4f}s (avg of {len(self.values)})"


class _AvgContext:
    def __init__(self, timing, key: str):
        self._timing = timing
        self._key = key

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc_info):
        elapsed = time.monotonic() - self._start
        self._timing.setdefault(self._key, AvgTime()).add(elapsed)


class Timing(dict):
    """``with timing.time_avg('x'):`` adds the elapsed seconds to the
    moving average under 'x'."""

    def time_avg(self, key: str):
        return _AvgContext(self, key)

    def summary(self) -> Dict[str, float]:
        """Flat ``{key: seconds}`` snapshot of the moving averages."""
        return {key: value.value for key, value in self.items()}

    def __str__(self):
        return ", ".join(f"{key}: {value}" for key, value in self.items())
