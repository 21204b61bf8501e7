"""Typed metrics registry: counters, gauges, streaming histograms.

A copy of ``scalable_agent_tpu/obs/registry.py``: one registry holds every
instrument the runtime exposes (queue gauges, actor and learner counters,
stage-latency histograms, device memory) and renders to every exporter
(``obs/exporters.py``: the Prometheus text snapshot, the JSONL and
TensorBoard writer) from one ``snapshot()``.

- ``Counter.inc`` / ``Gauge.set`` take one small lock.
- A ``Gauge`` can be backed by a callback (``registry.gauge(name,
  fn=...)``), sampled only when a snapshot is taken.
- ``Histogram`` keeps an exact ``count``/``sum`` and a bounded ring of
  recent observations; p50/p95/p99 are numpy percentiles over it at
  snapshot time.  The ring is a float64 array rather than the JAX
  class's deque: the percentiles of the same observations are the same,
  without a list-to-array conversion at every snapshot.

``install_torch_hooks`` takes the place of the JAX package's
``install_jax_hooks``: it registers the gauge ``device/memory_bytes_in_use``
under the same name, read from ``torch.cuda.memory_allocated``.  The
``jax/compile_count`` and ``jax/compile_time_s`` counters have no
counterpart: the port compiles nothing per step (its kernels are built
once, at first use, by ``ops/_build.py``).
"""

import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
]


class Counter:
    """Monotonically increasing float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: ``set()`` it, or back it with a callback so
    it is sampled only when a snapshot is taken."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float):
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_fn(self, fn: Callable[[], float]):
        """Rebind the sampling callback (a new owner re-registering the
        same gauge name takes it over)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")  # a dying queue must not kill a snapshot


class Histogram:
    """Streaming latency histogram: exact count/sum, quantiles over the
    most recent ``window`` observations."""

    kind = "histogram"
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", window: int = 2048):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # The newest ``window`` observations, the oldest overwritten.
        self._samples = np.zeros(window, np.float64)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float):
        value = float(value)
        with self._lock:
            self._samples[self._count % len(self._samples)] = value
            self._count += 1
            self._sum += value

    def time(self):
        """``with hist.time():`` observes the elapsed seconds."""
        return _HistTimer(self)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantiles(self) -> Dict[float, float]:
        with self._lock:
            samples = self._samples[:self._count].copy()
        if not samples.size:
            return {q: 0.0 for q in self.QUANTILES}
        values = np.percentile(samples, [q * 100.0 for q in self.QUANTILES])
        return dict(zip(self.QUANTILES, (float(v) for v in values)))


class _HistTimer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> instrument, idempotent registration: asking again for a
    name returns the existing instrument; asking for another kind under a
    taken name raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}")
                return existing
            instrument = cls(name, help, **kwargs)
            self._instruments[name] = instrument
            return instrument

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        gauge = self._get_or_create(Gauge, name, help)
        if fn is not None:
            gauge.set_fn(fn)
        return gauge

    def histogram(self, name: str, help: str = "",
                  window: int = 2048) -> Histogram:
        return self._get_or_create(Histogram, name, help, window=window)

    def instruments(self) -> List[Instrument]:
        with self._lock:
            return [self._instruments[k]
                    for k in sorted(self._instruments)]

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value dict: counters and gauges verbatim;
        histograms expand to ``<name>/p50|p95|p99|count|sum|mean``."""
        out: Dict[str, float] = {}
        for instrument in self.instruments():
            if isinstance(instrument, Histogram):
                count, total = instrument.count, instrument.sum
                for q, v in instrument.quantiles().items():
                    out[f"{instrument.name}/p{int(q * 100)}"] = v
                out[f"{instrument.name}/count"] = float(count)
                out[f"{instrument.name}/sum"] = total
                out[f"{instrument.name}/mean"] = (
                    total / count if count else 0.0)
            else:
                out[instrument.name] = instrument.value
        return out

    def install_torch_hooks(self) -> "MetricsRegistry":
        """Register the device-memory gauge on this registry: bytes of
        live tensors on the current card (0 while this process has not
        initialized CUDA, so a CPU run reads 0).  Idempotent."""
        if getattr(self, "_torch_hooks_installed", False):
            return self
        self._torch_hooks_installed = True

        def _memory_bytes() -> float:
            import torch

            if not torch.cuda.is_initialized():
                return 0.0
            return float(torch.cuda.memory_allocated())

        self.gauge("device/memory_bytes_in_use",
                   "live device bytes on the run's card", fn=_memory_bytes)
        return self


# The runtime instruments itself against this process-global registry, so
# the driver, the actor pool and the learner share one namespace without
# passing a registry through every constructor (constructors still take
# one, for tests).
_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry
