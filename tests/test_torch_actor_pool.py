"""The port's ActorPool (runtime/actor.py) on the CPU.

- With fixed weights, the pool's threaded trajectories are exactly the
  ones a sequential ``VectorActor`` with the same group and seed
  produces, unroll for unroll.
- An actor exception is retried within ``max_restarts``; past it, the
  exception surfaces from ``get_trajectory``.
- ``stop()`` joins every actor thread and every env worker process.
- ``set_params`` publishes a copy: later in-place updates of the learner's
  weights do not reach the actors until the next publish.
- Launch and step counters lose no increment under thread contention.
"""

import functools
import queue as queue_lib
import sys
import threading

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import _build
from scalable_agent_tpu_torch.runtime import ActorPool, VectorActor
from scalable_agent_tpu_torch.runtime.actor import (
    run_with_retry,
    snapshot_params_for_inference,
)
from scalable_agent_tpu_torch.types import map_structure

T, B, A, GROUPS, SEED = 3, 4, 9, 2, 5
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")


def _groups(num_workers=0):
    return [MultiEnv([functools.partial(make_impala_stream, "fake_small",
                                        seed=100 * g + i)
                      for i in range(B)], FRAME, num_workers=num_workers)
            for g in range(GROUPS)]


def _agent():
    return ImpalaAgent(A, (16, 16, 3), core_size=32,
                       generator=torch.Generator().manual_seed(0))


def _leaves(out):
    leaves = []
    map_structure(lambda x: leaves.append(x) if x is not None else None,
                  (out.agent_state, out.env_outputs, out.agent_outputs))
    return leaves


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _pool(agent, groups, **kw):
    pool = ActorPool(agent, groups, T, level_name="fake_small", seed=SEED,
                     restart_backoff_s=0.01, **kw)
    pool.set_params(agent)
    return pool


def test_pool_trajectories_equal_sequential_unrolls():
    agent = _agent()
    refs = []
    for g, envs in enumerate(_groups()):
        actor = VectorActor(agent, envs, T, level_name="fake_small",
                            seed=SEED + 1000 * g)
        # One group may deliver all 4 taken below while the other lags.
        refs.append([actor.run_unroll() for _ in range(4)])
        actor.close()
    pool = _pool(agent, _groups()).start()
    try:
        got = [pool.get_trajectory(timeout=30) for _ in range(4)]
    finally:
        pool.stop()
    seen = {g: [] for g in range(GROUPS)}
    for out in got:
        matches = [(g, k) for g in range(GROUPS) for k in range(4)
                   if _equal(out, refs[g][k])]
        assert len(matches) == 1, "a pool trajectory matches no unroll"
        g, k = matches[0]
        seen[g].append(k)
    # Each group's trajectories arrive in its own unroll order.
    for g, ks in seen.items():
        assert ks == list(range(len(ks))), (g, ks)


def test_failures_retry_within_budget_then_surface():
    pool = _pool(_agent(), _groups(), max_restarts=2)
    calls = {"n": 0}
    actor = pool.actors[0]
    real = actor.run_unroll

    def flaky(params=None):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient")
        return real(params)

    actor.run_unroll = flaky
    pool.start()
    try:
        for _ in range(4):
            pool.get_trajectory(timeout=30)
        assert pool.restarts == 2
    finally:
        pool.stop()

    pool = _pool(_agent(), _groups(), max_restarts=1)

    def broken(params=None):
        raise RuntimeError("env gone")

    pool.actors[1].run_unroll = broken
    pool.start()
    try:
        with pytest.raises(RuntimeError, match="env gone"):
            for _ in range(50):
                pool.get_trajectory(timeout=30)
        assert pool.restarts == 1
    finally:
        pool.stop()


def test_stop_joins_threads_and_worker_processes():
    groups = _groups(num_workers=1)
    procs = [p for envs in groups for p in envs._procs]
    pool = _pool(_agent(), groups).start()
    pool.get_trajectory(timeout=30)
    pool.stop()
    assert not any(t.is_alive() for t in pool.threads)
    assert not any(p.is_alive() for p in procs)


def test_set_params_publishes_a_copy():
    agent = _agent()
    snapshot = snapshot_params_for_inference(agent, version=7)
    before = [t.clone() for t in snapshot.tensors]
    with torch.no_grad():
        for p in agent.parameters():
            p.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, snapshot.tensors))
    pool = _pool(agent, _groups())
    try:
        private = pool.actors[0]._agent
        assert private is not agent
        pool.actors[0].load_params(pool._get_params())
        for mine, theirs in zip(private.parameters(), agent.parameters()):
            assert torch.equal(mine, theirs)
            assert not mine.requires_grad
    finally:
        pool.stop()


def test_run_with_retry_windowed_budget():
    failures = iter([RuntimeError("a"), RuntimeError("b"), None])
    delivered, resets = [], []

    def loop():
        exc = next(failures)
        if exc is not None:
            raise exc

    run_with_retry(loop, stop=threading.Event(), deliver=delivered.append,
                   reset=lambda: resets.append(1), max_restarts=2,
                   backoff_s=0.0)
    assert delivered == [] and len(resets) == 2
    run_with_retry(lambda: (_ for _ in ()).throw(ValueError("x")),
                   stop=threading.Event(), deliver=delivered.append,
                   max_restarts=0)
    assert [type(e) for e in delivered] == [ValueError]


def test_unported_inference_modes_raise():
    # Every JAX inference mode is ported; a mode the JAX package does not
    # know raises its error.
    with pytest.raises(ValueError, match="unknown inference_mode"):
        ActorPool(_agent(), _groups(), T, inference_mode="speculative")
    with pytest.raises(RuntimeError, match="set_params"):
        ActorPool(_agent(), _groups(), T).start()
    with pytest.raises(queue_lib.Empty):
        ActorPool(_agent(), _groups(), T).get_trajectory(timeout=0.01)


def test_launch_counts_survive_concurrent_increments():
    """Actor threads, the prefetch thread and the learner count kernel
    launches at once: no increment may be lost (16 threads, a 1 us switch
    interval)."""
    counts = {"k": 0}
    pool = ActorPool(_agent(), _groups(), T)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count_launch(counts, "k")
                pool._count("agent_steps", 1)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counts["k"] == 16 * 2000
    assert pool.agent_steps == 16 * 2000
