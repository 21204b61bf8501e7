"""The port's ``NativeBatcher`` (scalable_agent_tpu_torch/runtime/
native_batcher.py over native/batcher.cc) on the CPU: the twins of
``tests/test_native_batcher.py``.

The library is the port's own copy, built here by ``g++`` into
``scalable_agent_tpu_torch/_build/`` at first use and loaded for real.  The
tests cover the reference's batching semantics (reference:
dynamic_batching_test.py: co-batching :63-78, timeout wall-clock :242-275,
max-size partitioning :277-298, error propagation :101-200, cancellation on
close :202-240, out-of-order completion :334-375), tree layouts and
padding; the layout's packing is held against the JAX ``FlatRowLayout``
byte for byte; and the ThreadSanitizer variant runs in a subprocess
(``slow``, as its twin).
"""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from scalable_agent_tpu.runtime.transport import (
    FlatRowLayout as JaxFlatRowLayout,
)
from scalable_agent_tpu_torch.native import build as native_build
from scalable_agent_tpu_torch.native.build import build_library
from scalable_agent_tpu_torch.runtime import (
    native_batcher as native_batcher_mod,
)
from scalable_agent_tpu_torch.runtime.batcher import BatcherClosedError
from scalable_agent_tpu_torch.runtime.native_batcher import (
    FlatRowLayout,
    NativeBatcher,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scalar_batcher(fn, **kwargs):
    kwargs.setdefault("timeout_ms", 50.0)
    return NativeBatcher(
        fn, example_sample=np.float32(0), example_result=np.float32(0),
        **kwargs)


class TestNativeBatcherCore:
    def test_single_call_roundtrip(self):
        with scalar_batcher(lambda x, n: x * 2) as b:
            assert b.compute(np.float32(21)) == 42

    def test_multi_element_leaves(self):
        """Regression: result leaves with >1 element per row must scatter
        correctly (the round-1 wrapper crashed reshaping element counts to
        byte counts)."""
        example = {"vec": np.zeros(3, np.float32),
                   "mat": np.zeros((2, 2), np.int32)}

        def fn(batch, n):
            return {"vec": batch["vec"] + 1.0, "mat": batch["mat"] * 2}

        with NativeBatcher(fn, example, example, timeout_ms=20) as b:
            out = b.compute({"vec": np.arange(3, dtype=np.float32),
                             "mat": np.arange(4, dtype=np.int32).reshape(2, 2)})
        np.testing.assert_array_equal(out["vec"], [1.0, 2.0, 3.0])
        np.testing.assert_array_equal(out["mat"], [[0, 2], [4, 6]])

    def test_mixed_dtype_pytree(self):
        example_s = {"f": np.zeros((4,), np.float32),
                     "b": np.zeros((), np.bool_),
                     "u": np.zeros((2,), np.uint8)}
        example_r = {"sum": np.zeros((), np.float32)}

        def fn(batch, n):
            total = batch["f"].sum(-1) + batch["b"] + batch["u"].sum(-1)
            return {"sum": total.astype(np.float32)}

        with NativeBatcher(fn, example_s, example_r, timeout_ms=20) as b:
            out = b.compute({"f": np.full((4,), 0.5, np.float32),
                             "b": np.bool_(True),
                             "u": np.array([3, 4], np.uint8)})
        np.testing.assert_allclose(out["sum"], 2.0 + 1.0 + 7.0)

    def test_co_batching(self):
        sizes = []

        def fn(x, n):
            sizes.append(n)
            return x + 1

        with scalar_batcher(fn, minimum_batch_size=4,
                            timeout_ms=5000) as b:
            with ThreadPoolExecutor(8) as pool:
                results = list(pool.map(
                    lambda i: b.compute(np.float32(i)), range(8)))
        assert sorted(float(r) for r in results) == list(
            map(float, range(1, 9)))
        assert all(s >= 4 or sum(sizes) == 8 for s in sizes)

    def test_timeout_flushes_partial_batch(self):
        """(reference: dynamic_batching_test.py:242-275 wall-clock)"""
        with scalar_batcher(lambda x, n: x, minimum_batch_size=32,
                            timeout_ms=50) as b:
            t0 = time.monotonic()
            result = b.compute(np.float32(7))
            elapsed = time.monotonic() - t0
        assert result == 7
        assert 0.03 <= elapsed < 2.0

    def test_no_timeout_waits_for_min_batch(self):
        """timeout_ms=None means wait for min_batch however long."""
        with scalar_batcher(lambda x, n: x, minimum_batch_size=2,
                            timeout_ms=None) as b:
            got = []

            def call(v):
                got.append(float(b.compute(np.float32(v))))

            t = threading.Thread(target=call, args=(1.0,))
            t.start()
            time.sleep(0.2)
            assert not got  # still waiting for a partner
            assert float(b.compute(np.float32(2.0))) == 2.0
            t.join(timeout=5)
        assert got == [1.0]

    def test_max_batch_size_partitions(self):
        sizes = []

        def fn(x, n):
            sizes.append(n)
            return x

        with scalar_batcher(fn, minimum_batch_size=1, maximum_batch_size=2,
                            timeout_ms=100) as b:
            with ThreadPoolExecutor(6) as pool:
                list(pool.map(lambda i: b.compute(np.float32(i)), range(6)))
        assert max(sizes) <= 2 and sum(sizes) == 6

    def test_out_of_order_completion(self):
        """Two in-flight batches complete in reverse order; results still
        reach the right callers (reference: :334-375)."""
        release_first = threading.Event()
        started = threading.Event()

        def fn(x, n):
            if float(np.min(x)) == 0.0:  # first batch: stall
                started.set()
                assert release_first.wait(timeout=10)
            return x * 10

        with scalar_batcher(fn, minimum_batch_size=1, maximum_batch_size=1,
                            timeout_ms=5, num_consumers=2) as b:
            with ThreadPoolExecutor(2) as pool:
                f0 = pool.submit(b.compute, np.float32(0))
                assert started.wait(timeout=10)
                f1 = pool.submit(b.compute, np.float32(1))
                # Second batch completes while the first is stalled.
                assert float(f1.result(timeout=10)) == 10.0
                assert not f0.done()
                release_first.set()
                assert float(f0.result(timeout=10)) == 0.0

    def test_compute_error_cascades_to_callers(self):
        def fn(x, n):
            raise ValueError("deliberate compute failure")

        with scalar_batcher(fn, timeout_ms=10) as b:
            with pytest.raises(ValueError, match="deliberate"):
                b.compute(np.float32(1))

    def test_close_cancels_pending_callers(self):
        """(reference: :202-240, cancellation on close)"""
        b = scalar_batcher(lambda x, n: x, minimum_batch_size=16,
                           timeout_ms=None)
        errors = []

        def call():
            try:
                b.compute(np.float32(1))
            except BatcherClosedError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=call) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        b.close()
        for t in threads:
            t.join(timeout=5)
        assert len(errors) == 3

    def test_compute_after_close_raises(self):
        b = scalar_batcher(lambda x, n: x)
        b.close()
        with pytest.raises(BatcherClosedError):
            b.compute(np.float32(1))

    def test_close_while_compute_runs_keeps_the_handle(self, monkeypatch,
                                                       caplog):
        """A consumer still inside ``compute_fn`` when close() gives up
        waiting (a first step that builds the kernels) finishes into the
        still-allocated C++ batcher and exits: its caller is cancelled,
        nothing is freed under it, and the leak is logged."""
        monkeypatch.setattr(native_batcher_mod, "_CLOSE_TIMEOUT_S", 0.2)
        entered, release = threading.Event(), threading.Event()

        def slow(x, n):
            entered.set()
            release.wait(timeout=10)
            return x

        b = scalar_batcher(slow, timeout_ms=1.0)
        errors = []

        def call():
            try:
                b.compute(np.float32(1))
            except BatcherClosedError as exc:
                errors.append(exc)

        caller = threading.Thread(target=call)
        caller.start()
        assert entered.wait(timeout=10)
        with caplog.at_level("ERROR", logger="scalable_agent_tpu_torch"):
            b.close()
        assert "left allocated" in caplog.text
        assert b._handle is not None
        caller.join(timeout=5)
        assert len(errors) == 1
        (consumer,) = b._consumers
        assert consumer.is_alive()
        release.set()
        consumer.join(timeout=5)
        assert not consumer.is_alive()
        with pytest.raises(BatcherClosedError):
            b.compute(np.float32(1))

    def test_close_frees_the_handle_once_everyone_left(self):
        b = scalar_batcher(lambda x, n: x, timeout_ms=1.0)
        assert b.compute(np.float32(3)) == 3
        b.close()
        assert b._handle is None
        assert not any(t.is_alive() for t in b._consumers)

    def test_pad_to_sizes(self):
        seen = []

        def fn(x, n):
            seen.append((x.shape[0], n))
            return x[:n] + 1  # padded rows are dropped by pack_rows(n)

        with scalar_batcher(fn, minimum_batch_size=1, maximum_batch_size=8,
                            pad_to_sizes=[4, 8], timeout_ms=20) as b:
            assert float(b.compute(np.float32(1))) == 2.0
        padded_shape, n = seen[0]
        assert n == 1 and padded_shape == 4

    def test_padding_bounds_shapes_under_varying_arrival_counts(self):
        """Bursts of different sizes must all land on pad_to_sizes
        shapes — the property that bounds jit recompiles of the consumer
        computation to len(pad_to_sizes) regardless of arrival pattern
        (VERDICT r2 weak item 8)."""
        import threading

        seen = []

        def fn(x, n):
            seen.append((x.shape[0], n))
            return x[:n] * 10

        with scalar_batcher(fn, minimum_batch_size=1,
                            maximum_batch_size=8, pad_to_sizes=[2, 4, 8],
                            timeout_ms=30) as batcher:
            for burst in (1, 3, 5):
                results = [None] * burst
                def call(i):
                    results[i] = batcher.compute(np.float32(i))
                threads = [threading.Thread(target=call, args=(i,))
                           for i in range(burst)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                for i in range(burst):
                    assert float(results[i]) == i * 10.0
        padded_shapes = {shape for shape, _ in seen}
        assert padded_shapes <= {2, 4, 8}, padded_shapes
        # every batch's real count fits inside its padded shape
        assert all(n <= shape for shape, n in seen), seen

    def test_min_greater_than_max_rejected(self):
        with pytest.raises(ValueError):
            scalar_batcher(lambda x, n: x, minimum_batch_size=8,
                           maximum_batch_size=4)

    def test_shape_mismatch_raises(self):
        with NativeBatcher(lambda x, n: x, np.zeros(3, np.float32),
                           np.zeros(3, np.float32), timeout_ms=10) as b:
            with pytest.raises(ValueError, match="shape"):
                b.compute(np.zeros(4, np.float32))


class TestPortBuild:
    def test_builds_from_the_ports_copy_into_its_build_dir(self):
        path = build_library("opt")
        assert os.path.dirname(path) == os.path.join(
            REPO, "scalable_agent_tpu_torch", "_build")
        source = os.path.join(REPO, "scalable_agent_tpu_torch", "native",
                              "batcher.cc")
        assert native_build._SRC == source
        # The file name carries the source's hash: an edited source is a
        # new library.
        assert native_build.library_path("opt") == path
        assert os.path.exists(path)

    def test_build_failure_raises(self, tmp_path, monkeypatch):
        broken = tmp_path / "batcher.cc"
        broken.write_text("this is not C++")
        monkeypatch.setattr(native_build, "_SRC", str(broken))
        monkeypatch.setattr(native_build, "_BUILD_DIR", str(tmp_path))
        with pytest.raises(RuntimeError, match="native batcher build"):
            native_build.build_library("opt")

    def test_layout_packs_like_the_jax_layout(self):
        """Dict keys in sorted order: the JAX flatten sorts them, the
        port's ``map_structure`` keeps the dict's order."""
        rng = np.random.default_rng(0)
        tree = {"b": np.bool_(True),
                "f": rng.standard_normal((4,)).astype(np.float32),
                "i": np.int64(-7), "none": None,
                "u": rng.integers(0, 255, (2, 3), dtype=np.uint8)}
        ours, theirs = FlatRowLayout(tree), JaxFlatRowLayout(tree)
        assert ours.nbytes == theirs.nbytes
        a, b = bytearray(ours.nbytes), bytearray(theirs.nbytes)
        ours.pack_into(memoryview(a), tree)
        theirs.pack_into(memoryview(b), tree)
        assert a == b
        back = ours.unpack_one(memoryview(a))
        assert back["none"] is None
        for key in ("f", "b", "u", "i"):
            np.testing.assert_array_equal(back[key], tree[key])


def test_threads_under_a_short_switch_interval_lose_nothing():
    """More caller threads than cores, two consumers and a 1 us switch
    interval: every caller gets its own row back, and the batches' valid
    rows add up to the requests."""
    rows = []
    callers = 2 * (os.cpu_count() or 1) + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(x, n):
            rows.append(n)
            return x[:n] * 2

        with scalar_batcher(fn, minimum_batch_size=2, maximum_batch_size=8,
                            pad_to_sizes=[2, 4, 8], timeout_ms=2.0,
                            num_consumers=2) as b:
            with ThreadPoolExecutor(callers) as pool:
                out = list(pool.map(
                    lambda i: float(b.compute(np.float32(i))),
                    range(20 * callers)))
    finally:
        sys.setswitchinterval(interval)
    assert out == [2.0 * i for i in range(20 * callers)]
    assert sum(rows) == 20 * callers


@pytest.mark.slow
class TestSanitizers:
    """Actually RUN the sanitizer builds (SURVEY §5.2: the reference has
    compile-time annotations only).  The instrumented .so needs the TSan
    runtime preloaded, so the workload runs in a subprocess."""

    WORKLOAD = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from concurrent.futures import ThreadPoolExecutor
from scalable_agent_tpu_torch.runtime.native_batcher import NativeBatcher

with NativeBatcher(lambda x, n: x + 1, np.float32(0), np.float32(0),
                   minimum_batch_size=2, maximum_batch_size=8,
                   timeout_ms=5.0, num_consumers=2,
                   variant={variant!r}) as b:
    with ThreadPoolExecutor(16) as pool:
        out = list(pool.map(lambda i: float(b.compute(np.float32(i))),
                            range(200)))
assert sorted(out) == [float(i + 1) for i in range(200)], "wrong results"
print("WORKLOAD_OK")
"""

    def _runtime_lib(self, name):
        path = subprocess.run(
            ["g++", f"-print-file-name={name}"],
            capture_output=True, text=True).stdout.strip()
        return path if path and os.path.isabs(path) else None

    def test_tsan_concurrent_workload(self):
        tsan = self._runtime_lib("libtsan.so")
        if tsan is None:
            tsan = self._runtime_lib("libtsan.so.2")
        if tsan is None:
            pytest.skip("libtsan runtime not found")
        build_library("tsan")
        env = dict(os.environ, LD_PRELOAD=tsan,
                   TSAN_OPTIONS="exitcode=66 report_thread_leaks=0",
                   )
        proc = subprocess.run(
            [sys.executable, "-c",
             self.WORKLOAD.format(repo=REPO, variant="tsan")],
            capture_output=True, text=True, env=env, timeout=300)
        batcher_races = [
            line for line in proc.stderr.splitlines()
            if "WARNING: ThreadSanitizer" in line]
        # CPython itself is not TSan-clean; fail only on reports that
        # implicate the batcher library or wrapper.
        implicated = "batcher" in proc.stderr and batcher_races
        assert "WORKLOAD_OK" in proc.stdout, (
            f"workload failed rc={proc.returncode}:\n{proc.stderr[-2000:]}")
        assert not implicated, proc.stderr[-4000:]
