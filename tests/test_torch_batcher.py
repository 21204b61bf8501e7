"""The port's ``DynamicBatcher`` (scalable_agent_tpu_torch/runtime/batcher.py)
on the CPU: the twins of ``tests/test_batcher.py``.

They cover the reference's batching semantics (reference:
dynamic_batching_test.py: co-batching :63-78, timeout :242-275, max-size
partitioning :277-298, error propagation :101-200, cancellation :202-240,
out-of-order completion :334-375), plus the ledger's
``inference_service`` stage and the ``batcher/`` instruments against the
live JAX batcher's.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from scalable_agent_tpu.obs.registry import MetricsRegistry as JaxRegistry
from scalable_agent_tpu.runtime import batcher as jax_batcher
from scalable_agent_tpu_torch.obs import ledger as ledger_lib
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.runtime.batcher import (
    BatcherClosedError,
    DynamicBatcher,
    _stack_padded,
    _unstack,
)


class TestDynamicBatcher:
    def test_single_call(self):
        with DynamicBatcher(lambda x, n: x * 2, timeout_ms=10) as b:
            np.testing.assert_array_equal(
                b.compute(np.array([1.0, 2.0])), [2.0, 4.0])

    def test_co_batching(self):
        seen_sizes = []

        def fn(x, n):
            seen_sizes.append(n)
            return x + 1

        with DynamicBatcher(fn, minimum_batch_size=4, timeout_ms=5000) as b:
            with ThreadPoolExecutor(8) as pool:
                results = list(pool.map(
                    lambda i: b.compute(np.float32(i)), range(8)))
        assert sorted(results) == [1, 2, 3, 4, 5, 6, 7, 8]
        # With min=4 and 8 concurrent callers nothing runs below 4.
        assert all(s >= 4 or sum(seen_sizes) == 8 for s in seen_sizes)

    def test_timeout_flushes_partial_batch(self):
        def fn(x, n):
            return x

        with DynamicBatcher(fn, minimum_batch_size=32, timeout_ms=50) as b:
            t0 = time.monotonic()
            result = b.compute(np.float32(7))
            elapsed = time.monotonic() - t0
        assert result == 7
        assert 0.03 <= elapsed < 2.0  # flushed by timeout, not min-batch

    def test_max_batch_size_partitions(self):
        sizes = []

        def fn(x, n):
            sizes.append(n)
            return x

        with DynamicBatcher(fn, minimum_batch_size=1, maximum_batch_size=2,
                            timeout_ms=100) as b:
            with ThreadPoolExecutor(6) as pool:
                list(pool.map(lambda i: b.compute(np.float32(i)), range(6)))
        assert max(sizes) <= 2

    def test_structured_samples(self):
        def fn(tree, n):
            a, b = tree
            return {"sum": a + b, "diff": a - b}

        with DynamicBatcher(fn, timeout_ms=10) as batcher:
            out = batcher.compute((np.float32(5), np.float32(3)))
        assert out["sum"] == 8 and out["diff"] == 2

    def test_error_propagates_to_all_callers(self):
        def fn(x, n):
            raise ValueError("compute exploded")

        with DynamicBatcher(fn, minimum_batch_size=2, timeout_ms=5000) as b:
            with ThreadPoolExecutor(2) as pool:
                futures = [pool.submit(b.compute, np.float32(i))
                           for i in range(2)]
                for f in futures:
                    with pytest.raises(ValueError, match="compute exploded"):
                        f.result()
        # Batcher survives a failing batch.

    def test_close_cancels_pending(self):
        release = threading.Event()

        def fn(x, n):
            release.wait(5)
            return x

        b = DynamicBatcher(fn, minimum_batch_size=64, timeout_ms=None)
        future = b.compute_async(np.float32(1))
        threading.Timer(0.05, b.close).start()
        with pytest.raises(BatcherClosedError):
            future.result(timeout=5)
        release.set()
        with pytest.raises(BatcherClosedError):
            b.compute(np.float32(2))

    def test_out_of_order_completion(self):
        """Two consumers; first batch stalls; second completes first.

        (reference: dynamic_batching_test.py:334-375)
        """
        first = threading.Event()
        order = []

        def fn(x, n):
            if float(np.ravel(x)[0]) == 0:
                first.wait(5)
            order.append(float(np.ravel(x)[0]))
            return x

        with DynamicBatcher(fn, minimum_batch_size=1, maximum_batch_size=1,
                            timeout_ms=1, num_consumers=2) as b:
            f0 = b.compute_async(np.float32(0))
            time.sleep(0.05)
            f1 = b.compute_async(np.float32(1))
            assert f1.result(timeout=5) == 1  # completes while f0 stalls
            first.set()
            assert f0.result(timeout=5) == 0
        assert order == [1.0, 0.0]

    def test_padding_quantizes_batch_shapes(self):
        shapes = []

        def fn(x, n):
            shapes.append(x.shape[0])
            return x

        with DynamicBatcher(fn, minimum_batch_size=1, maximum_batch_size=8,
                            timeout_ms=20, pad_to_sizes=[4, 8]) as b:
            with ThreadPoolExecutor(3) as pool:
                out = list(pool.map(
                    lambda i: b.compute(np.float32(i)), range(3)))
        assert sorted(out) == [0, 1, 2]
        assert set(shapes) <= {4, 8}  # never an odd shape

    def test_bad_config_raises(self):
        with pytest.raises(ValueError):
            DynamicBatcher(lambda x, n: x, minimum_batch_size=8,
                           maximum_batch_size=4)
        with pytest.raises(ValueError):
            DynamicBatcher(lambda x, n: x, maximum_batch_size=16,
                           pad_to_sizes=[4, 8])


def test_instruments_and_ledger_stage_match_the_jax_batcher(monkeypatch):
    """The same calls register the same ``batcher/`` names as the JAX
    batcher's, and each executed batch feeds the ledger's
    ``inference_service`` stage (its arrivals and busy seconds)."""
    ours, theirs = MetricsRegistry(), JaxRegistry()
    with DynamicBatcher(lambda x, n: x, timeout_ms=1,
                        registry=ours) as batcher:
        batcher.compute(np.float32(1))
    with jax_batcher.DynamicBatcher(lambda x, n: x, timeout_ms=1,
                                    registry=theirs) as batcher:
        batcher.compute(np.float32(1))
    names = lambda reg: {i.name for i in reg.instruments()}
    assert names(ours) == names(theirs)
    assert ledger_lib.TIMING_STAGE_MAP["batcher/request_latency_s"] == (
        "inference_service")
    ledger = ledger_lib.PipelineLedger(registry=MetricsRegistry(),
                                       frames_per_trajectory=1.0)
    monkeypatch.setattr(ledger_lib, "_ledger", ledger)
    with DynamicBatcher(lambda x, n: x, minimum_batch_size=3,
                        timeout_ms=5000, registry=MetricsRegistry()
                        ) as batcher:
        futures = [batcher.compute_async(np.float32(i)) for i in range(3)]
        assert [float(f.result(timeout=10)) for f in futures] == [
            0.0, 1.0, 2.0]
    served, busy_s = ledger._service["inference_service"]
    assert served == 3 and busy_s >= 0.0


def test_stack_and_unstack_match_the_jax_helpers():
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((2, 3)).astype(np.float32)
            for _ in range(3)]
    np.testing.assert_array_equal(_stack_padded(rows, 4),
                                  jax_batcher._stack_padded(rows, 4))
    tree = {"a": np.arange(8).reshape(4, 2), "b": np.arange(4.0)}
    for ours, theirs in zip(_unstack(tree, 3),
                            jax_batcher._unstack(tree, 3)):
        for key in tree:
            np.testing.assert_array_equal(ours[key], theirs[key])
