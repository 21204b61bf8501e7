"""The native (C++) dynamic batcher's ctypes front end.

The counterpart of ``scalable_agent_tpu/runtime/native_batcher.py``: the
service contract of ``runtime.batcher.DynamicBatcher`` (min/max/timeout
batch formation, the error cascade on close, out-of-order batches), with
caller blocking, batch formation and the gather/scatter memcpy in
``native/batcher.cc`` with the GIL released (reference: batcher.cc's role
as the C++ half of dynamic_batching.py).  The library is built by ``g++``
at first use (``native/build.py``); a failed build raises.

Samples and results are fixed-layout trees of numpy arrays: the layout is
declared up front from example trees (``FlatRowLayout``), so every request
packs into one contiguous byte blob.  The Python consumer thread drives
``compute_fn`` as the reference's QueueRunner thread drives the batched
subgraph (dynamic_batching.py:131-144).
"""

import ctypes
import logging
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from scalable_agent_tpu_torch.native import load_library
from scalable_agent_tpu_torch.obs import (
    get_flight_recorder,
    get_ledger,
    get_tracer,
    get_watchdog,
)
from scalable_agent_tpu_torch.runtime.batcher import (
    BatcherClosedError,
    batcher_instruments,
    check_batch_sizes,
    pad_to_bucket,
)
from scalable_agent_tpu_torch.types import map_structure

_OK, _CLOSED, _TIMEOUT, _INVALID = 0, 1, 2, 3
# close(): how long the consumers and the callers get to leave the library.
_CLOSE_TIMEOUT_S = 5.0

log = logging.getLogger("scalable_agent_tpu_torch")


def _leaves(tree) -> List[Any]:
    leaves = []
    map_structure(leaves.append, tree)
    return leaves


def _unflatten(template, leaves):
    it = iter(leaves)
    return map_structure(lambda _: next(it), template)


class FlatRowLayout:
    """A tree's leaves packed densely, in ``map_structure`` order, each at
    (offset, shape, dtype); a None leaf takes no bytes and round-trips as
    None (the JAX ``transport.FlatRowLayout``)."""

    def __init__(self, example):
        self._template = map_structure(lambda _: None, example)
        self.fields: List[Optional[Tuple[int, Tuple[int, ...],
                                         np.dtype]]] = []
        offset = 0
        for leaf in _leaves(example):
            if leaf is None:
                self.fields.append(None)
                continue
            arr = np.asarray(leaf)
            self.fields.append((offset, arr.shape, arr.dtype))
            offset += arr.nbytes
        self.nbytes = offset

    def pack_into(self, buf: memoryview, tree) -> None:
        for field, leaf in zip(self.fields, _leaves(tree)):
            if field is None:
                continue
            offset, shape, dtype = field
            # tobytes() emits C-order bytes; ascontiguousarray would
            # promote a 0-d leaf to 1-d.
            arr = np.asarray(leaf, dtype=dtype)
            if arr.shape != shape:
                raise ValueError(
                    f"leaf shape {arr.shape} != declared {shape}")
            buf[offset:offset + arr.nbytes] = arr.tobytes()

    def unpack_rows(self, buf: memoryview, n: int):
        """[n, nbytes] packed rows -> a tree of [n, ...] arrays."""
        flat = np.frombuffer(buf, np.uint8,
                             count=n * self.nbytes).reshape(n, self.nbytes)
        leaves = []
        for field in self.fields:
            if field is None:
                leaves.append(None)
                continue
            offset, shape, dtype = field
            nbytes = int(np.prod(shape)) * dtype.itemsize
            chunk = np.ascontiguousarray(flat[:, offset:offset + nbytes])
            leaves.append(chunk.view(dtype).reshape((n,) + shape))
        return _unflatten(self._template, leaves)

    def pack_rows(self, buf: memoryview, tree, n: int) -> None:
        """A tree of [>=n, ...] arrays -> [n, nbytes] packed rows."""
        flat = np.frombuffer(buf, np.uint8,
                             count=n * self.nbytes).reshape(n, self.nbytes)
        for field, leaf in zip(self.fields, _leaves(tree)):
            if field is None:
                continue
            offset, shape, dtype = field
            arr = np.ascontiguousarray(np.asarray(leaf, dtype=dtype)[:n])
            nbytes = int(np.prod(shape)) * dtype.itemsize
            # View as bytes before the reshape: reshape counts elements.
            flat[:, offset:offset + nbytes] = (
                arr.view(np.uint8).reshape(n, nbytes))

    def unpack_one(self, buf: memoryview):
        leaves = []
        for field in self.fields:
            if field is None:
                leaves.append(None)
                continue
            offset, shape, dtype = field
            nbytes = int(np.prod(shape)) * dtype.itemsize
            arr = np.frombuffer(buf, np.uint8, count=nbytes,
                                offset=offset).view(dtype).reshape(shape)
            leaves.append(arr.copy())
        return _unflatten(self._template, leaves)


class NativeBatcher:
    """``DynamicBatcher``'s contract over the C++ core.

    ``example_sample`` / ``example_result``: trees fixing the layouts.
    ``compute_fn(batched_tree, n) -> batched_result_tree``.
    """

    def __init__(self, compute_fn: Callable[[Any, int], Any],
                 example_sample, example_result,
                 minimum_batch_size: int = 1,
                 maximum_batch_size: int = 1024,
                 timeout_ms: Optional[float] = 100.0,
                 pad_to_sizes: Optional[Sequence[int]] = None,
                 num_consumers: int = 1, variant: str = "opt",
                 metrics_name: str = "native_batcher", registry=None):
        self._pad_to_sizes = check_batch_sizes(
            minimum_batch_size, maximum_batch_size, pad_to_sizes)
        # The pending queue lives in C++; the callers inside compute()
        # are the depth the gauge samples (through a weak reference: the
        # registry must not keep a closed batcher alive).
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self_ref = weakref.ref(self)
        (self._batch_size_hist, self._occupancy_hist, self._latency_hist,
         self._batches_total) = batcher_instruments(
            metrics_name,
            lambda: (b._inflight if (b := self_ref()) is not None else 0.0),
            registry)
        self._lib = load_library(variant)
        self._compute_fn = compute_fn
        self._sample_layout = FlatRowLayout(example_sample)
        self._result_layout = FlatRowLayout(example_result)
        self._max = maximum_batch_size
        self._handle = ctypes.c_void_p(self._lib.batcher_create(
            self._sample_layout.nbytes, self._result_layout.nbytes,
            minimum_batch_size, maximum_batch_size,
            -1.0 if timeout_ms is None else float(timeout_ms)))
        self._closed = False
        self._compute_error = None
        self._consumers = [
            threading.Thread(target=self._consume_loop, daemon=True,
                             name=f"native-batcher-consumer-{i}")
            for i in range(num_consumers)]
        for thread in self._consumers:
            thread.start()

    # -- caller side -------------------------------------------------------

    def compute(self, sample):
        t0 = time.monotonic()
        # Checked under the lock close() sets it under: a caller that gets
        # past it is counted before close() reads the count.
        with self._inflight_lock:
            if self._closed:
                raise BatcherClosedError("batcher is closed")
            self._inflight += 1
        try:
            sample_buf = bytearray(self._sample_layout.nbytes)
            self._sample_layout.pack_into(memoryview(sample_buf), sample)
            result_buf = bytearray(self._result_layout.nbytes)
            sample_c = (ctypes.c_char * len(sample_buf)).from_buffer(
                sample_buf)
            result_c = (ctypes.c_char * len(result_buf)).from_buffer(
                result_buf)
            status = self._lib.batcher_compute(
                self._handle, ctypes.addressof(sample_c),
                ctypes.addressof(result_c))
        finally:
            with self._inflight_lock:
                self._inflight -= 1
        if status == _CLOSED:
            raise BatcherClosedError("batcher closed while request pending")
        if status != _OK:
            raise self._compute_error or RuntimeError(
                f"native batcher error status {status}")
        self._latency_hist.observe(time.monotonic() - t0)
        return self._result_layout.unpack_one(memoryview(result_buf))

    # -- consumer side -----------------------------------------------------

    def _consume_loop(self):
        sample_nbytes = self._sample_layout.nbytes
        batch_buf = bytearray(self._max * sample_nbytes)
        batch_c = (ctypes.c_char * len(batch_buf)).from_buffer(batch_buf)
        n_c = ctypes.c_int(0)
        id_c = ctypes.c_int64(0)
        watchdog = get_watchdog()
        while True:
            # Disarmed across the native wait (idle is not a wedge),
            # re-armed for the bounded batch execution.
            watchdog.suspend()
            status = self._lib.batcher_get_batch(
                self._handle, ctypes.addressof(batch_c),
                ctypes.byref(n_c), ctypes.byref(id_c))
            if status == _CLOSED:
                return
            watchdog.touch()
            n = n_c.value
            try:
                self._batch_size_hist.observe(n)
                self._occupancy_hist.observe(n / self._max)
                self._batches_total.inc()
                started_at = time.monotonic()
                with get_tracer().span("batcher/native_run_batch",
                                       args={"n": n}):
                    batched = self._sample_layout.unpack_rows(
                        memoryview(batch_buf), n)
                    padded = pad_to_bucket(n, self._pad_to_sizes)
                    if padded > n:
                        batched = map_structure(
                            lambda x: None if x is None else np.pad(
                                x, [(0, padded - n)]
                                + [(0, 0)] * (x.ndim - 1)),
                            batched)
                    result = self._compute_fn(batched, n)
                    result_buf = bytearray(n * self._result_layout.nbytes)
                    self._result_layout.pack_rows(
                        memoryview(result_buf), result, n)
                # The inference-service stage covers both cores.
                get_ledger().note_service(
                    "inference_service", n, time.monotonic() - started_at)
                result_c = (ctypes.c_char * len(result_buf)).from_buffer(
                    result_buf)
                self._lib.batcher_set_results(
                    self._handle, id_c.value, ctypes.addressof(result_c),
                    _OK)
            except BaseException as exc:
                # The error reaches the callers through the status code;
                # the flight recorder keeps the consumer's side.
                get_flight_recorder().record(
                    "exception", type(exc).__name__,
                    {"where": threading.current_thread().name})
                self._compute_error = exc
                self._lib.batcher_set_results(
                    self._handle, id_c.value, None, _INVALID)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        """Cancel every pending caller, then free the C++ batcher once no
        consumer and no caller is left inside the library.  A consumer
        still running ``compute_fn`` past ``_CLOSE_TIMEOUT_S`` (the first
        step may build the kernels) would call into a freed handle, so the
        handle is left allocated then: its late ``batcher_set_results``
        finds no batch and its next ``batcher_get_batch`` returns closed."""
        with self._inflight_lock:
            if self._closed:
                return
            self._closed = True
        self._lib.batcher_close(self._handle)
        deadline = time.monotonic() + _CLOSE_TIMEOUT_S
        for thread in self._consumers:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        while self._inflight and time.monotonic() < deadline:
            time.sleep(0.001)
        busy = sum(thread.is_alive() for thread in self._consumers)
        if busy or self._inflight:
            log.error("native batcher: %d consumer(s) and %d caller(s) "
                      "still inside the library %.0f s after close; its "
                      "handle is left allocated", busy, self._inflight,
                      _CLOSE_TIMEOUT_S)
            return
        self._lib.batcher_destroy(self._handle)
        self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
