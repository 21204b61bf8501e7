"""Dynamic batching of single-sample calls, and the batch formation every
batching front end shares.

The counterpart of ``scalable_agent_tpu/runtime/batcher.py`` (reference:
batcher.cc:91-204, the batcher's state machine; dynamic_batching.py:65-162,
``batch_fn_with_options``):

- ``bucket_ladder`` and ``pad_to_bucket``: the power-of-two ladder a formed
  batch is padded up, so the inference step sees a small, fixed set of
  batch sizes.  ``DynamicBatcher``, ``NativeBatcher``
  (``runtime/native_batcher.py``), ``ActorPool``'s service mode and the
  actor service (``runtime/service.py``) all pad by it.
- ``DynamicBatcher``: callers (actor threads) submit single samples and
  block on a Future; a consumer thread forms batches under
  ``minimum_batch_size`` / ``maximum_batch_size`` / ``timeout_ms`` (it waits
  for the minimum, a timeout after the *first* pending request flushes a
  partial batch, and no batch exceeds the maximum), runs
  ``compute_fn(batched, n)`` and scatters the result rows back.  Several
  consumers may complete batches out of order.  ``close()`` cancels every
  pending caller with ``BatcherClosedError``.
- Observability: ``<name>/queue_depth`` (a gauge sampled by callback),
  ``<name>/batch_size``, ``<name>/occupancy``, ``<name>/request_latency_s``
  (the ledger's ``inference_service`` stage) and ``<name>/batches_total``;
  each executed batch feeds the ledger's ``inference_service`` stage
  (``note_service``) and the ``batcher/run_batch`` span.

Callers pass *unbatched* samples (trees of numpy arrays); a formed batch is
padded up ``pad_to_sizes`` with zero rows.
"""

import itertools
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from scalable_agent_tpu_torch.obs import (
    get_flight_recorder,
    get_ledger,
    get_registry,
    get_tracer,
    get_watchdog,
)
from scalable_agent_tpu_torch.types import map_structure

__all__ = ["BatcherClosedError", "DynamicBatcher", "bucket_ladder",
           "pad_to_bucket"]


class BatcherClosedError(RuntimeError):
    """Raised to callers whose requests were cancelled by close()."""


def bucket_ladder(maximum: int, minimum: int = 1) -> List[int]:
    """Power-of-two pad sizes ``[minimum, 2*minimum, ..., maximum]``.

    Padding formed batches up the ladder bounds the batch sizes the
    inference step sees to ~log2(maximum) (reference:
    dynamic_batching.py:125-128)."""
    if maximum < 1:
        raise ValueError(f"maximum must be >= 1, got {maximum}")
    sizes = [max(1, min(int(minimum), maximum))]
    while sizes[-1] < maximum:
        sizes.append(min(sizes[-1] * 2, maximum))
    return sizes


def pad_to_bucket(n: int, sizes: Optional[Sequence[int]]) -> int:
    """Smallest bucket in ascending ``sizes`` holding ``n`` valid rows
    (``n`` itself when no bucket fits or bucketing is disabled)."""
    if sizes is None:
        return n
    for size in sizes:
        if size >= n:
            return size
    return n


def check_batch_sizes(minimum: int, maximum: int,
                      pad_to_sizes: Optional[Sequence[int]]
                      ) -> Optional[List[int]]:
    """The batchers' argument checks; returns ``pad_to_sizes`` sorted."""
    if minimum > maximum:
        raise ValueError("minimum_batch_size > maximum_batch_size")
    if pad_to_sizes is None:
        return None
    pad_to_sizes = sorted(pad_to_sizes)
    if pad_to_sizes[-1] < maximum:
        raise ValueError("largest pad_to_sizes must cover maximum_batch_size")
    return pad_to_sizes


def batcher_instruments(metrics_name: str, depth_fn, registry=None):
    """The instruments every batcher registers under ``metrics_name``: the
    queue-depth gauge (``depth_fn`` sampled at snapshot time) and the
    batch-size, occupancy and request-latency histograms and the batch
    counter, returned in that order."""
    registry = registry or get_registry()
    registry.gauge(f"{metrics_name}/queue_depth",
                   "requests awaiting a batch", fn=depth_fn)
    return (
        registry.histogram(f"{metrics_name}/batch_size",
                           "valid rows per formed batch"),
        registry.histogram(f"{metrics_name}/occupancy",
                           "valid rows / maximum_batch_size per formed "
                           "batch"),
        registry.histogram(f"{metrics_name}/request_latency_s",
                           "enqueue -> result seconds per request"),
        registry.counter(f"{metrics_name}/batches_total",
                         "batches executed"),
    )


class _Request:
    __slots__ = ("sample", "future", "enqueued_at")

    def __init__(self, sample):
        self.sample = sample
        self.future = Future()
        self.enqueued_at = time.monotonic()


class DynamicBatcher:
    """Batch single-sample calls onto ``compute_fn``.

    ``compute_fn(batched_sample_tree, n) -> batched_result_tree``: every
    input leaf has a leading batch axis (padded up ``pad_to_sizes``), and
    so must every result leaf; ``n`` is the valid row count.  The
    arguments are ``batch_fn_with_options``'s (reference:
    dynamic_batching.py:65-102); ``pad_to_sizes`` (ascending) quantizes the
    batch shapes, None disables padding.
    """

    def __init__(self, compute_fn: Callable[[Any, int], Any],
                 minimum_batch_size: int = 1,
                 maximum_batch_size: int = 1024,
                 timeout_ms: Optional[float] = 100.0,
                 pad_to_sizes: Optional[Sequence[int]] = None,
                 num_consumers: int = 1, metrics_name: str = "batcher",
                 registry=None):
        self._pad_to_sizes = check_batch_sizes(
            minimum_batch_size, maximum_batch_size, pad_to_sizes)
        self._compute_fn = compute_fn
        self._min = minimum_batch_size
        self._max = maximum_batch_size
        self._timeout_s = None if timeout_ms is None else timeout_ms / 1000.0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending = deque()
        self._closed = False
        self._batch_ids = itertools.count()
        # A weak reference: the process-global registry must not keep a
        # closed batcher alive.
        pending_ref = weakref.ref(self._pending)
        (self._batch_size_hist, self._occupancy_hist, self._latency_hist,
         self._batches_total) = batcher_instruments(
            metrics_name,
            lambda: (len(p) if (p := pending_ref()) is not None else 0.0),
            registry)
        self._consumers = [
            threading.Thread(target=self._consume_loop, daemon=True,
                             name=f"batcher-consumer-{i}")
            for i in range(num_consumers)]
        for thread in self._consumers:
            thread.start()

    # -- caller side -------------------------------------------------------

    def compute(self, sample):
        """Submit one sample; block until its result row is ready."""
        return self.compute_async(sample).result()

    def compute_async(self, sample) -> Future:
        with get_tracer().span("batcher/enqueue"):
            with self._lock:
                if self._closed:
                    raise BatcherClosedError("batcher is closed")
                request = _Request(sample)
                self._pending.append(request)
                self._nonempty.notify()
        return request.future

    # -- consumer side -----------------------------------------------------

    def _take(self, n: int) -> List[_Request]:
        n = min(n, self._max)
        return [self._pending.popleft() for _ in range(n)]

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is ready (the minimum reached, or the
        timeout after the first pending request), at most the maximum.
        None at close."""
        with self._lock:
            deadline = None
            while True:
                if self._closed:
                    return None
                if len(self._pending) >= self._min:
                    return self._take(len(self._pending))
                if not self._pending:
                    deadline = None
                    self._nonempty.wait()
                elif self._timeout_s is None:
                    self._nonempty.wait()
                else:
                    if deadline is None:
                        deadline = time.monotonic() + self._timeout_s
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:  # flush a partial batch
                        return self._take(len(self._pending))
                    self._nonempty.wait(remaining)

    def _consume_loop(self):
        watchdog = get_watchdog()
        while True:
            # Idle waiting for requests is not a wedge; a batch's
            # execution is bounded work the heartbeat covers.
            watchdog.suspend()
            batch = self._take_batch()
            if batch is None:
                return
            watchdog.touch()
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]) -> None:
        n = len(batch)
        padded = pad_to_bucket(n, self._pad_to_sizes)
        self._batch_size_hist.observe(n)
        self._occupancy_hist.observe(n / self._max)
        self._batches_total.inc()
        try:
            started_at = time.monotonic()
            with get_tracer().span("batcher/run_batch",
                                   args={"n": n, "padded": padded}):
                stacked = map_structure(
                    lambda *rows: _stack_padded(rows, padded),
                    *[request.sample for request in batch])
                rows = _unstack(self._compute_fn(stacked, n), n)
            done_at = time.monotonic()
            # Arrivals and busy seconds of each executed batch: the
            # ledger's inference-service utilization.
            get_ledger().note_service("inference_service", n,
                                      done_at - started_at)
            for request, row in zip(batch, rows):
                self._latency_hist.observe(done_at - request.enqueued_at)
                request.future.set_result(row)
        except BaseException as exc:  # every caller of the batch gets it
            get_flight_recorder().record(
                "exception", type(exc).__name__,
                {"where": threading.current_thread().name})
            for request in batch:
                if not request.future.done():
                    request.future.set_exception(exc)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Cancel the pending requests and stop the consumers (reference:
        batcher.cc:393-431, close cascades an error to every waiting
        caller)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
            self._nonempty.notify_all()
        for request in pending:
            request.future.set_exception(
                BatcherClosedError("batcher closed while request pending"))
        for thread in self._consumers:
            thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()


def _stack_padded(rows, padded: int):
    """Rows -> one [padded, ...] array, zero rows after the valid ones
    (None rows stay None)."""
    if rows[0] is None:
        return None
    arr = np.stack([np.asarray(r) for r in rows])
    if padded > arr.shape[0]:
        pad_widths = [(0, padded - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_widths)
    return arr


def _unstack(tree, n: int):
    """A batched result tree -> its first ``n`` rows, one tree each."""
    return [map_structure(
        lambda leaf, i=i: None if leaf is None else np.asarray(leaf)[i],
        tree) for i in range(n)]
