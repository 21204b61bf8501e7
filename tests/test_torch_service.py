"""The continuous-batching actor service of the port (runtime/service.py,
runtime/batcher.py, MultiEnv's per-worker API) on the CPU, the twins of
``tests/test_service.py`` and the slice's numbers against the JAX package:

- batch formation: the bucket ladder and the padding, equal to the JAX
  functions;
- the trajectory packer: bit-identical to the port's ``VectorActor`` when
  fed its rows in scrambled arrival order, and to the JAX packer on the
  same numpy entries; stragglers, protocol violations, reset;
- ``MultiEnv``'s per-worker protocol: slices, lockstep equality, a dead
  worker respawned on the per-worker path;
- the live service: learner-shaped trajectories, the max-batch check, an
  idle worker's death re-bootstrapping its lane alone, ``worker_kill`` and
  ``service_stall``, the groups it refuses, and the hand-off of the state
  rows from the inference stream (a spy that completes the host copy only
  when its event is waited on);
- ``service_actor_step`` (gather, ``actor_step``, scatter of the valid
  rows) against the JAX ``_service_actor_step`` over a sequence of 10
  interleaved, padded batches with episode resets, weights converted with
  ``convert.py``, both fed the JAX side's sampled actions: float32 at the
  agent's tolerance, bf16 at the bf16 band;
- ``--actor=service`` through ``driver.train`` with a complete ledger and
  the report naming the service stages.

``test_dynamic_batcher_uses_shared_policy`` waits for the dynamic batcher
(ROADMAP.md, queue 1, item 7b) and ``test_ingraph_rejects_actor_service``
for the in-graph backend (item 8).
"""

import functools
import glob
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.runtime import batcher as jax_batcher
from scalable_agent_tpu.runtime import service as jax_service
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import registry as registry_lib
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.runtime import VectorActor
from scalable_agent_tpu_torch.runtime import service as service_mod
from scalable_agent_tpu_torch.runtime.batcher import (
    bucket_ladder,
    pad_to_bucket,
)
from scalable_agent_tpu_torch.runtime.faults import configure_faults
from scalable_agent_tpu_torch.runtime.service import (
    ActorService,
    TrajectoryPacker,
    service_actor_step,
)
from scalable_agent_tpu_torch.types import (
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
    map_structure,
)

NUM_ACTIONS = 9  # fake_small's
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")
T = 5
B = 4
CORE = 32


def make_envs(n=B, workers=2, seed_base=0):
    fns = [functools.partial(make_impala_stream, "fake_small",
                             seed=seed_base + i)
           for i in range(n)]
    return MultiEnv(fns, FRAME, num_workers=workers)


def make_agent():
    return ImpalaAgent(NUM_ACTIONS, (16, 16, 3), core_size=CORE,
                       generator=torch.Generator().manual_seed(0))


def _leaves(tree):
    leaves = []
    map_structure(lambda x: leaves.append(x) if x is not None else None,
                  tree)
    return leaves


def assert_trees_equal(a, b, msg=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=msg)


# ---------------------------------------------------------------------------
# Shared batch formation
# ---------------------------------------------------------------------------


class TestBatchFormation:
    def test_bucket_ladder_powers_of_two(self):
        assert bucket_ladder(8) == [1, 2, 4, 8]
        assert bucket_ladder(6) == [1, 2, 4, 6]
        assert bucket_ladder(1) == [1]
        assert bucket_ladder(8, minimum=4) == [4, 8]
        for maximum in range(1, 70):
            for minimum in (1, 3, 4):
                assert bucket_ladder(maximum, minimum) == (
                    jax_batcher.bucket_ladder(maximum, minimum))

    def test_bucket_ladder_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            bucket_ladder(0)

    def test_pad_to_bucket(self):
        sizes = bucket_ladder(8)
        assert pad_to_bucket(1, sizes) == 1
        assert pad_to_bucket(3, sizes) == 4
        assert pad_to_bucket(8, sizes) == 8
        assert pad_to_bucket(9, sizes) == 9  # beyond the ladder
        assert pad_to_bucket(3, None) == 3  # bucketing disabled
        sizes = bucket_ladder(64)
        for n in range(1, 66):
            assert pad_to_bucket(n, sizes) == jax_batcher.pad_to_bucket(
                n, sizes)
        # The reference layout's slices of 4 envs reach the kernel at
        # these batch sizes.
        assert {pad_to_bucket(n, sizes) for n in range(4, 65, 4)} == {
            4, 8, 16, 32, 64}


# ---------------------------------------------------------------------------
# Per-lane trajectory packing
# ---------------------------------------------------------------------------


def _row(tree, t, e):
    """Entry (t, env e) of a [T+1, B, ...] tree as a width-1 lane row
    (``e`` a slice: those envs)."""
    envs = e if isinstance(e, slice) else slice(e, e + 1)
    return map_structure(
        lambda x: None if x is None else np.asarray(x)[t, envs], tree)


def _replay_order(num_steps, num_envs, rng):
    """Every env once per step, in a shuffled order: the arrival
    interleaving of continuous batching."""
    orders = []
    for _ in range(num_steps):
        order = list(range(num_envs))
        rng.shuffle(order)
        orders.append(order)
    return orders


@pytest.fixture(scope="module")
def reference_unrolls():
    """Three unrolls of a port ``VectorActor`` over 4 envs."""
    envs = make_envs()
    try:
        actor = VectorActor(make_agent(), envs, T, seed=7)
        return [actor.run_unroll() for _ in range(3)]
    finally:
        envs.close()


def _replay_into(packer_cls, reference):
    """Feed a packer the reference's per-step rows, one env at a time in
    scrambled order; returns its pops."""
    packer = packer_cls([1] * B, T)
    first = reference[0]
    for e in range(B):
        packer.bootstrap(
            e, _row(first.env_outputs, 0, e),
            _row(first.agent_outputs, 0, e),
            np.asarray(first.agent_state.c)[e:e + 1],
            np.asarray(first.agent_state.h)[e:e + 1])
    rng = np.random.RandomState(0)
    popped = []
    for k, traj in enumerate(reference):
        if k + 1 < len(reference):
            next_state = reference[k + 1].agent_state
        else:
            zeros = np.zeros((B, CORE), np.float32)
            next_state = AgentState(c=zeros, h=zeros)
        for t, order in enumerate(_replay_order(T, B, rng), start=1):
            for e in order:
                need_state = packer.stage_inference(
                    e, _row(traj.agent_outputs, t, e))
                assert need_state == (t == T)
                if need_state:
                    packer.stage_state(
                        e, np.asarray(next_state.c)[e:e + 1],
                        np.asarray(next_state.h)[e:e + 1])
                completed = packer.add_env(e, _row(traj.env_outputs, t, e))
                assert completed == (t == T)
        assert packer.ready()
        popped.append(packer.pop())
        assert not packer.ready()
    return popped


class TestTrajectoryPacker:
    def test_bit_identical_to_vector_actor(self, reference_unrolls):
        """The rows of a VectorActor run, one env at a time in scrambled
        arrival order, make bit-identical [T+1, B] trajectories: the
        overlap entry, the boundary agent_state, every leaf."""
        popped = _replay_into(TrajectoryPacker, reference_unrolls)
        for k, (birth, state, env_outputs, agent_outputs) in enumerate(
                popped):
            want = reference_unrolls[k]
            assert birth > 0
            assert_trees_equal(env_outputs, want.env_outputs,
                               msg=f"env_outputs diverge at unroll {k}")
            assert_trees_equal(agent_outputs, want.agent_outputs,
                               msg=f"agent_outputs diverge at unroll {k}")
            np.testing.assert_array_equal(state.c, want.agent_state.c)
            np.testing.assert_array_equal(state.h, want.agent_state.h)

    def test_bit_identical_to_the_jax_packer(self, reference_unrolls):
        """The port's packer and the JAX one, fed the same numpy entries in
        the same order, pop the same arrays bit for bit."""
        ours = _replay_into(TrajectoryPacker, reference_unrolls)
        theirs = _replay_into(jax_service.TrajectoryPacker,
                              reference_unrolls)
        for (_, state, env, agent), (_, jstate, jenv, jagent) in zip(
                ours, theirs):
            assert_trees_equal((state, env, agent),
                               (tuple(jstate), tuple(jenv), tuple(jagent)))

    def _synthetic_step(self, packer, lane, value):
        agent_row = np.full((1, 2), value, np.float32)
        if packer.stage_inference(lane, agent_row):
            packer.stage_state(lane, np.zeros((1, 3), np.float32),
                               np.zeros((1, 3), np.float32))
        return packer.add_env(lane, np.full((1,), value, np.float32))

    def test_straggler_buffers_without_stalling_siblings(self):
        """Lane 0 runs two unrolls ahead; its output waits until lane 1
        catches up, then batches pop oldest first."""
        packer = TrajectoryPacker([1, 1], unroll_length=2)
        for lane in (0, 1):
            packer.bootstrap(lane, np.full((1,), -1.0, np.float32),
                             np.full((1, 2), -1.0, np.float32),
                             np.zeros((1, 3), np.float32),
                             np.zeros((1, 3), np.float32))
        value = 0.0
        for _ in range(2):  # two full unrolls on lane 0 only
            for _ in range(2):
                value += 1.0
                self._synthetic_step(packer, 0, value)
        assert packer.completed_depth(0) == 2
        assert packer.completed_depth(1) == 0
        assert not packer.ready()
        for step in range(2):  # lane 1 catches up one unroll
            self._synthetic_step(packer, 1, 100.0 + step)
        assert packer.ready()
        _, _, env_outputs, _ = packer.pop()
        np.testing.assert_array_equal(
            env_outputs[:, 0], np.asarray([-1.0, 1.0, 2.0], np.float32))
        np.testing.assert_array_equal(
            env_outputs[:, 1], np.asarray([-1.0, 100.0, 101.0], np.float32))
        assert packer.completed_depth(0) == 1
        assert not packer.ready()

    def test_protocol_violations_raise(self):
        packer = TrajectoryPacker([1], unroll_length=2)
        packer.bootstrap(0, np.zeros((1,)), np.zeros((1, 2)),
                         np.zeros((1, 3)), np.zeros((1, 3)))
        with pytest.raises(RuntimeError, match="no staged inference"):
            packer.add_env(0, np.zeros((1,)))
        packer.stage_inference(0, np.zeros((1, 2)))
        with pytest.raises(RuntimeError, match="second inference"):
            packer.stage_inference(0, np.zeros((1, 2)))
        with pytest.raises(ValueError):
            TrajectoryPacker([1], unroll_length=0)

    def test_reset_drops_partials_and_buffered_unrolls(self):
        packer = TrajectoryPacker([1, 1], unroll_length=2)
        for lane in (0, 1):
            packer.bootstrap(lane, np.zeros((1,)), np.zeros((1, 2)),
                             np.zeros((1, 3)), np.zeros((1, 3)))
        self._synthetic_step(packer, 0, 1.0)
        packer.reset()
        assert packer.completed_depth(0) == 0
        assert packer.entry_count(0) == 0
        packer.bootstrap(0, np.zeros((1,)), np.zeros((1, 2)),
                         np.zeros((1, 3)), np.zeros((1, 3)))
        assert packer.entry_count(0) == 1


# ---------------------------------------------------------------------------
# MultiEnv's per-worker protocol
# ---------------------------------------------------------------------------


class TestWorkerAPI:
    def test_worker_slices_cover_the_batch(self):
        envs = make_envs(n=5, workers=2)
        try:
            slices = envs.worker_slices()
            assert envs.num_workers == 2
            assert [s.start for s in slices] == [0, 3]
            assert [s.stop for s in slices] == [3, 5]
            assert envs.worker_generation(1) == 0
            assert envs.worker_connection(0) is envs._conns[0]
        finally:
            envs.close()

    def test_per_worker_steps_match_lockstep(self):
        """The same seeds stepped per worker give the lockstep path's
        outputs, slice by slice."""
        lockstep = make_envs(seed_base=11)
        perworker = make_envs(seed_base=11)
        try:
            ref = lockstep.initial()
            outs = [perworker.worker_initial(w)
                    for w in range(perworker.num_workers)]
            for w, sl in enumerate(perworker.worker_slices()):
                np.testing.assert_array_equal(outs[w].observation.frame,
                                              ref.observation.frame[sl])
            actions = np.arange(B) % NUM_ACTIONS
            for step in range(12):  # past fake_small's 10-step episodes
                lockstep.step_send(actions)
                ref = lockstep.step_recv()
                for w, sl in enumerate(perworker.worker_slices()):
                    perworker.worker_send(w, actions[sl])
                for w, sl in enumerate(perworker.worker_slices()):
                    out = perworker.worker_recv(w)
                    for got, want in zip(_leaves(out), _leaves(ref)):
                        np.testing.assert_array_equal(
                            got, want[sl], err_msg=f"step {step} w {w}")
            assert list(perworker.episode_stats) == list(
                lockstep.episode_stats)
            with pytest.raises(ValueError, match="actions for worker"):
                perworker.worker_send(0, actions)
        finally:
            lockstep.close()
            perworker.close()

    def test_dead_worker_respawns_on_per_worker_path(self):
        envs = make_envs()
        try:
            for w in range(envs.num_workers):
                envs.worker_initial(w)
            envs._procs[0].kill()
            envs._procs[0].join(timeout=5)
            envs.worker_send(0, np.zeros((2,), np.int64))
            out = envs.worker_recv(0)
            # The respawned slice restarts: done=True marks the boundary,
            # and no episode stats are recorded.
            assert out.done.all()
            np.testing.assert_array_equal(out.info.episode_step,
                                          np.zeros((2,), np.int32))
            assert envs.worker_generation(0) == 1
            assert envs.worker_generation(1) == 0
        finally:
            envs.close()


# ---------------------------------------------------------------------------
# The live service
# ---------------------------------------------------------------------------


@pytest.fixture
def registry(monkeypatch):
    """A private process-global registry, so counters start at 0."""
    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    configure_faults("")
    yield registry
    configure_faults("")


def _make_service(agent, groups=2, max_batch=0, **kwargs):
    env_groups = [make_envs(seed_base=100 * g) for g in range(groups)]
    service = ActorService(agent, env_groups, T, level_name="fake_small",
                           seed=3, max_batch=max_batch,
                           restart_backoff_s=0.01, **kwargs)
    service.set_params(agent)
    return service


class TestActorService:
    def test_emits_learner_shaped_trajectories(self, registry):
        agent = make_agent()
        service = _make_service(agent).start()
        try:
            for _ in range(3):
                out = service.get_trajectory(timeout=120)
                assert out.env_outputs.observation.frame.shape == (
                    T + 1, B, 16, 16, 3)
                assert out.agent_outputs.policy_logits.shape == (
                    T + 1, B, NUM_ACTIONS)
                assert out.agent_state.c.shape == (B, CORE)
                assert out.agent_state.c.dtype == np.float32
                assert out.env_outputs.done.dtype == bool
                assert out.agent_outputs.action.dtype == np.int64
                assert np.isfinite(out.agent_outputs.policy_logits).all()
        finally:
            service.stop()
        assert not any(t.is_alive() for t in service.threads)
        snap = registry.snapshot()
        assert snap["service/batches_total"] >= 1
        assert service.agent_steps == snap["actor/agent_steps_total"] > 0
        assert snap["actor/trajectories_total"] >= 3

    def test_rejects_max_batch_below_widest_slice(self):
        with pytest.raises(ValueError, match="widest worker slice"):
            _make_service(make_agent(), groups=1, max_batch=1)

    def test_refuses_groups_without_worker_processes(self):
        envs = MultiEnv([functools.partial(make_impala_stream,
                                           "fake_small")] * 2, FRAME)
        try:
            with pytest.raises(ValueError, match="--actor=service"):
                ActorService(make_agent(), [envs], T)
        finally:
            envs.close()

    def test_idle_worker_death_rebootstraps_lane_only(self):
        """A reply with NO inference staged (the worker died idle, its
        request parked in the ring, and worker_recv respawned it) recovers
        the lane alone: the stale request is dropped by the lane
        generation, the lane re-bootstraps, its siblings are untouched."""
        service = _make_service(make_agent(), groups=1)
        try:
            group = service._groups[0]
            for w in range(group.envs.num_workers):
                service._bootstrap_lane(0, w, group.envs.worker_initial(w))
            gen_before = group.lane_gen[0]
            sibling_gen = group.lane_gen[1]
            ring_before = len(service._ring)
            assert not group.packer.has_staged(0)
            out = group.envs.worker_initial(0)  # the respawned reply
            service._handle_reply(0, 0, out)
            assert group.lane_gen[0] == gen_before + 1
            assert group.lane_gen[1] == sibling_gen
            assert group.packer.entry_count(0) == 1
            assert group.packer.entry_count(1) == 1
            assert len(service._ring) == ring_before + 1
            stale = service._ring[0]
            assert (stale.worker, stale.lane_gen) == (0, gen_before)
            assert stale.lane_gen != group.lane_gen[0]
        finally:
            service.stop()

    def test_worker_kill_chaos_respawns_midunroll(self, registry):
        """A worker SIGKILLed mid-unroll: the per-worker respawn gives its
        initial outputs (a done=True boundary), the packer keeps its
        layout, and trajectories keep coming."""
        configure_faults("worker_kill@2")
        service = _make_service(make_agent(), groups=1).start()
        try:
            for _ in range(4):
                out = service.get_trajectory(timeout=120)
                assert out.env_outputs.observation.frame.shape == (
                    T + 1, B, 16, 16, 3)
        finally:
            service.stop()
        snap = registry.snapshot()
        assert snap["env/worker_respawns_total"] >= 1
        assert snap["faults/injected_total"] >= 1

    def test_service_stall_chaos_trips_watchdog(self, registry, monkeypatch):
        """A wedged inference thread goes stale on the watchdog, and the
        run recovers once the stall ends."""
        from scalable_agent_tpu_torch.obs import configure_watchdog

        monkeypatch.setenv("SCALABLE_AGENT_SERVICE_STALL_S", "1.5")
        # The watchdog's own registry: its stall counter must not leak into
        # the process-global one.
        watchdog_registry = MetricsRegistry()
        stalls = watchdog_registry.counter("watchdog/stalls_total")
        configure_faults("service_stall@2")
        configure_watchdog(0.3, registry=watchdog_registry)
        try:
            service = _make_service(make_agent(), groups=1).start()
            try:
                out = service.get_trajectory(timeout=180)
                assert out.env_outputs.observation.frame.shape[0] == T + 1
                deadline = time.monotonic() + 30
                while stalls.value < 1 and time.monotonic() < deadline:
                    time.sleep(0.05)
                out = service.get_trajectory(timeout=180)
            finally:
                service.stop()
        finally:
            configure_watchdog(None)
        assert registry.snapshot()["faults/injected_total"] >= 1
        assert stalls.value >= 1

    def test_state_rows_are_read_after_the_inference_stream_wrote_them(
            self, registry, monkeypatch):
        """The unroll-boundary state rows cross from the inference thread's
        stream to the env thread that pops the trajectory.  Here the host
        copy completes only when its event is waited on (as a non-blocking
        copy on the card does): a pop that read the rows before waiting
        would read NaN."""
        waited = []

        class CopyEvent:
            def __init__(self, host, src):
                self._pending = [(host, src)]

            def synchronize(self):
                for host, src in self._pending:
                    host.copy_(src)
                self._pending = []
                waited.append(threading.current_thread().name)

        def deferred_copy(state, n):
            c, h = state.c[:n].clone(), state.h[:n].clone()
            host_c = torch.full_like(c, float("nan"))
            host_h = torch.full_like(h, float("nan"))
            event = CopyEvent(host_c, c)
            event._pending.append((host_h, h))
            return host_c, host_h, event

        monkeypatch.setattr(service_mod, "_host_copy", deferred_copy)
        service = _make_service(make_agent(), groups=1).start()
        try:
            outs = [service.get_trajectory(timeout=120) for _ in range(3)]
        finally:
            service.stop()
        for k, out in enumerate(outs):
            assert np.isfinite(out.agent_state.c).all(), k
            assert np.isfinite(out.agent_state.h).all(), k
        assert not outs[0].agent_state.h.any()  # the zero initial state
        assert outs[1].agent_state.h.any() and outs[2].agent_state.h.any()
        # Waited on by the env thread that popped, never the inference one.
        assert waited and set(waited) == {"service-env-0"}

    def test_reset_rebuilds_the_slabs_only_after_a_torn_write(self):
        service = _make_service(make_agent(), groups=1)
        try:
            service._slab_c.fill_(1.0)
            service._reset_inference()
            assert bool((service._slab_c == 1.0).all())
            service._writing_slabs = True
            service._reset_inference()
            assert not service._slab_c.any() and not service._slab_h.any()
            assert not service._writing_slabs
        finally:
            service.stop()


def test_threads_under_a_short_switch_interval_lose_nothing(registry,
                                                           monkeypatch):
    """Three groups on more env worker processes than the machine has
    cores, the inference thread and three env threads switching every
    10 microseconds: every batch row is counted once, and each group's
    trajectories chain (entry 0 of an unroll is entry T of the group's
    previous one, its agent half included)."""
    rows = []
    real_step = service_mod.service_actor_step

    def counting_step(agent, generator, ids, n, *rest):
        rows.append(n)
        return real_step(agent, generator, ids, n, *rest)

    monkeypatch.setattr(service_mod, "service_actor_step", counting_step)
    workers = max(2, (os.cpu_count() or 1) // 3 + 1)
    env_groups = [make_envs(n=workers, workers=workers, seed_base=100 * g)
                  for g in range(3)]
    agent = make_agent()
    service = ActorService(agent, env_groups, T, seed=3, max_batch=workers,
                           restart_backoff_s=0.01)
    service.set_params(agent)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        service.start()
        outs = [service.get_trajectory(timeout=120) for _ in range(6)]
    finally:
        service.stop()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in service.threads)
    assert service.agent_steps == sum(rows) == registry.snapshot()[
        "actor/agent_steps_total"]

    def entry(out, t):
        return _leaves((_row(out.env_outputs, t, slice(None)),
                        _row(out.agent_outputs, t, slice(None))))

    starts = 0
    for i, out in enumerate(outs):
        first = entry(out, 0)
        chained = [j for j in range(i) if all(
            np.array_equal(a, b) for a, b in zip(entry(outs[j], T), first))]
        if not chained:
            starts += 1
            assert out.env_outputs.done[0].all()  # a group's first unroll
        else:
            assert len(chained) == 1
    # At most one unchained unroll a group: its first.
    assert 1 <= starts <= 3


def test_service_actor_step_writes_only_the_valid_rows():
    agent = make_agent()
    slab_c = torch.zeros((5, CORE))
    slab_h = torch.zeros((5, CORE))
    ids = torch.tensor([2, 0, 4, 4])  # 2 valid rows, padded to 4
    rng = np.random.default_rng(0)
    env = StepOutput(
        reward=torch.zeros(4), info=StepOutputInfo(torch.zeros(4),
                                                   torch.zeros(4)),
        done=torch.zeros(4, dtype=torch.bool),
        observation=Observation(frame=torch.tensor(
            rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8))))
    out, state = service_actor_step(
        agent, torch.Generator().manual_seed(0), ids, 2,
        torch.zeros(4, dtype=torch.int64), env, slab_c, slab_h)
    assert out.action.shape == (4,)
    np.testing.assert_array_equal(slab_c[[2, 0]].numpy(),
                                  state.c[:2].numpy())
    np.testing.assert_array_equal(slab_h[[2, 0]].numpy(),
                                  state.h[:2].numpy())
    for row in (1, 3, 4):  # untouched, the dummy row included
        assert not slab_c[row].any() and not slab_h[row].any()


# ---------------------------------------------------------------------------
# service_actor_step against the JAX _service_actor_step
# ---------------------------------------------------------------------------

PARITY_A = 5
PARITY_H = 16
PARITY_SLICES = [(0, 2), (2, 3), (3, 6), (6, 7)]  # 7 envs over 4 workers
PARITY_ENVS = 7
PARITY_MAX_BATCH = 8
PARITY_BATCHES = 10
TOLERANCE = {"float32": dict(rtol=1e-4, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _parity_batches(seed=0):
    """Ten batches: each a random non-empty set of worker slices in random
    order, its rows' env outputs (about a quarter done) and ids padded up
    the [1, 2, 4, 8] ladder with the dummy row."""
    rng = np.random.default_rng(seed)
    ladder = bucket_ladder(PARITY_MAX_BATCH)
    batches = []
    for _ in range(PARITY_BATCHES):
        chosen = rng.permutation(len(PARITY_SLICES))[
            :rng.integers(1, len(PARITY_SLICES) + 1)]
        ids = np.concatenate([np.arange(*PARITY_SLICES[w]) for w in chosen])
        n = len(ids)
        padded = pad_to_bucket(n, ladder)
        pad = padded - n
        batches.append(dict(
            n=n,
            ids=np.concatenate([ids, np.full(pad, PARITY_ENVS)]),
            reward=np.pad((rng.standard_normal(n) * 2).astype(np.float32),
                          (0, pad)),
            done=np.pad(rng.random(n) < 0.25, (0, pad)),
            frame=np.pad(rng.integers(0, 256, (n, 16, 16, 3),
                                      dtype=np.uint8),
                         [(0, pad), (0, 0), (0, 0), (0, 0)])))
    return batches


def _jax_agent(dtype):
    bf16 = dtype == "bfloat16"
    return JaxAgent(num_actions=PARITY_A, core_size=PARITY_H,
                    core_impl="pallas", conv_backend="pallas",
                    compute_dtype=jnp.dtype(dtype),
                    core_matmul_dtype="bfloat16" if bf16 else "float32")


def _jax_env(batch):
    zeros = np.zeros(batch["reward"].shape, np.float32)
    return JaxStepOutput(
        reward=jnp.asarray(batch["reward"]),
        info=JaxStepOutputInfo(zeros, zeros.astype(np.int32)),
        done=jnp.asarray(batch["done"]),
        observation=JaxObservation(frame=jnp.asarray(batch["frame"])))


@pytest.fixture(scope="module")
def jax_service_run():
    """The JAX service step over the batch sequence, once per dtype: the
    params, and per batch the last actions fed in and the logits,
    baseline, new state and slabs that came out.  Each batch's sampled
    actions become its envs' next last actions."""
    batches = _parity_batches()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        agent = _jax_agent(dtype)
        init_env = _jax_env(dict(reward=np.zeros(1, np.float32),
                                 done=np.zeros(1, bool),
                                 frame=np.zeros((1, 16, 16, 3), np.uint8)))
        expand = lambda x: x[None]
        params = jax.jit(agent.init)(
            jax.random.key(0), jnp.zeros((1, 1), jnp.int32),
            jax.tree_util.tree_map(expand, init_env),
            JaxAgentState(c=jnp.zeros((1, PARITY_H)),
                          h=jnp.zeros((1, PARITY_H))))
        step = jax.jit(functools.partial(jax_service._service_actor_step,
                                         agent))
        slab_c = jnp.zeros((PARITY_ENVS + 1, PARITY_H), jnp.float32)
        slab_h = jnp.zeros((PARITY_ENVS + 1, PARITY_H), jnp.float32)
        last_actions = np.zeros(PARITY_ENVS + 1, np.int32)
        key = jax.random.key(1)
        outputs = []
        for i, batch in enumerate(batches):
            actions = last_actions[batch["ids"]].copy()
            out, new_state, slab_c, slab_h = step(
                params, jax.random.fold_in(key, i),
                jnp.asarray(batch["ids"], jnp.int32),
                jnp.asarray(actions), _jax_env(batch), slab_c, slab_h)
            n = batch["n"]
            outputs.append(dict(
                actions=actions,
                logits=np.asarray(out.policy_logits)[:n],
                baseline=np.asarray(out.baseline)[:n],
                c=np.asarray(new_state.c)[:n],
                h=np.asarray(new_state.h)[:n],
                slab_c=np.asarray(slab_c)[:PARITY_ENVS],
                slab_h=np.asarray(slab_h)[:PARITY_ENVS]))
            last_actions[batch["ids"][:n]] = np.asarray(out.action)[:n]
        runs[dtype] = (jax.tree_util.tree_map(np.asarray, params), outputs)
    return batches, runs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_service_step_matches_jax(jax_service_run, dtype):
    """Gather, ``actor_step`` and scatter over the same 10 batches, fed the
    JAX side's sampled actions: logits, baseline, the new state of the
    valid rows and every slab row but the dummy one after every batch."""
    batches, runs = jax_service_run
    params, outputs = runs[dtype]
    bf16 = dtype == "bfloat16"
    agent = ImpalaAgent(PARITY_A, (16, 16, 3), core_size=PARITY_H,
                        compute_dtype=torch.bfloat16 if bf16
                        else torch.float32,
                        core_matmul_dtype=dtype)
    agent.load_state_dict(convert.flax_to_state_dict(params))
    slab_c = torch.zeros((PARITY_ENVS + 1, PARITY_H))
    slab_h = torch.zeros((PARITY_ENVS + 1, PARITY_H))
    generator = torch.Generator().manual_seed(0)
    tol = TOLERANCE[dtype]
    for i, (batch, want) in enumerate(zip(batches, outputs)):
        zeros = torch.zeros(batch["reward"].shape)
        env = StepOutput(
            reward=torch.tensor(batch["reward"]),
            info=StepOutputInfo(zeros, zeros),
            done=torch.tensor(batch["done"]),
            observation=Observation(frame=torch.tensor(batch["frame"])))
        out, state = service_actor_step(
            agent, generator, torch.tensor(batch["ids"]), batch["n"],
            torch.tensor(want["actions"], dtype=torch.int64), env, slab_c,
            slab_h)
        n = batch["n"]
        for name, got in (("logits", out.policy_logits[:n]),
                          ("baseline", out.baseline[:n]),
                          ("c", state.c[:n]), ("h", state.h[:n]),
                          ("slab_c", slab_c[:PARITY_ENVS]),
                          ("slab_h", slab_h[:PARITY_ENVS])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want[name],
                                       err_msg=f"batch {i} {name}", **tol)


# ---------------------------------------------------------------------------
# --actor=service through the driver
# ---------------------------------------------------------------------------


def test_driver_smoke_actor_service_ledger_complete(tmp_path, registry,
                                                    monkeypatch, capsys):
    from scalable_agent_tpu_torch import driver
    from scalable_agent_tpu_torch.config import Config
    from scalable_agent_tpu_torch.obs import report
    from scalable_agent_tpu_torch.obs.ledger import SEGMENTS

    monkeypatch.setenv("SCALABLE_AGENT_LEDGER_MFU_PEAK", "1e12")
    config = Config(
        device="cpu", mode="train", logdir=str(tmp_path / "run"),
        level_name="fake_small", num_actors=4, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=32,  # 4 updates of 8 frames
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, seed=5, actor="service", scan_impl="pallas")
    metrics = driver.train(config)
    assert metrics["env_frames"] == 32
    snap = registry.snapshot()
    counts = {key: snap[f"ledger/trajectories_{key}_total"]
              for key in ("opened", "retired", "discarded", "abandoned")}
    assert counts["retired"] >= 4
    assert counts["opened"] == (counts["retired"] + counts["discarded"]
                                + counts["abandoned"])

    (path,) = glob.glob(os.path.join(config.logdir, "ledger.p0.json"))
    artifact = json.load(open(path))
    assert artifact["open_records"] == []
    stages_seen = {e["stage"] for e in artifact["ring_tail"]}
    for stage in ("birth", "unroll_done", "queue_put", "queue_get",
                  "put_done", "dispatch", "retire"):
        assert stage in stages_seen, stage

    text = open(os.path.join(config.logdir, "metrics.prom")).read()
    assert "impala_ledger_rho_service_batch" in text
    assert "impala_ledger_rho_service_wait" in text
    assert "impala_service_batch_s_count" in text
    values = {}
    for line in text.splitlines():
        if line.startswith("impala_") and " " in line:
            key, _, value = line.rpartition(" ")
            try:
                values[key] = float(value)
            except ValueError:
                pass
    assert values["impala_ledger_open_records"] == 0.0
    assert values["impala_service_batches_total"] > 0.0
    # Every service batch row is an agent step of the run.
    assert values["impala_actor_agent_steps_total"] >= 32
    shares = {name: values[f"impala_ledger_latency_share_{name}"]
              for name, _, _ in SEGMENTS}
    assert sum(shares.values()) == pytest.approx(1.0, abs=1e-6)

    assert report.main([config.logdir]) == 0
    out = capsys.readouterr().out
    assert "service_batch" in out
    assert "dominant stage:" in out
    assert "top recommendation:" in out
