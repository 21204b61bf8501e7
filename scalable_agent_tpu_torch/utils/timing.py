"""Timers: the part of ``scalable_agent_tpu/utils/timing.py`` (reference:
utils/timing.py:8-64) the training loop uses: ``time_avg`` (moving
averages, for the log line) and ``add_time`` (sums, for the stall
attributor's interval)."""

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


class _TimingContext:
    def __init__(self, timing, key: str, add: bool):
        self._timing = timing
        self._key = key
        self._add = add

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc_info):
        elapsed = time.monotonic() - self._start
        if self._add:
            self._timing[self._key] = self._timing.get(self._key,
                                                       0.0) + elapsed
        else:
            self._timing.setdefault(self._key, AvgTime()).add(elapsed)


class Timing(dict):
    """``with timing.time_avg('x'):`` adds the elapsed seconds to the
    moving average under 'x'; ``with timing.add_time('x'):`` to the sum
    under 'x'."""

    def time_avg(self, key: str):
        return _TimingContext(self, key, add=False)

    def add_time(self, key: str):
        return _TimingContext(self, key, add=True)

    def summary(self) -> Dict[str, float]:
        """Flat ``{key: seconds}``: moving averages unwrapped, sums as
        they are."""
        return {key: value.value if isinstance(value, AvgTime)
                else float(value) for key, value in self.items()}

    def __str__(self):
        return ", ".join(
            f"{key}: {value}" if isinstance(value, AvgTime)
            else f"{key}: {value:.4f}s" for key, value in self.items())
