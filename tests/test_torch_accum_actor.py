"""On-device trajectory accumulation in the port
(scalable_agent_tpu_torch/runtime/accum_actor.py, ``ActorPool``'s
``accum``, ``accum_fused`` and ``service`` modes) on the CPU: the twins of
``tests/test_accum_actor.py``, and the slice's holds against the structural
path and the JAX package.

- Accum against structural inside the port, for the same env seeds,
  weights and generator seed: frames, actions, dones and episode steps
  equal, rewards and returns within 1e-6, logits, baselines and the carried
  state within the JAX test's ``rtol=1e-5, atol=1e-6`` (float32), over
  three unrolls; the same on an instruction level.
- Fused against threaded accum (each group's generator seeded as its
  threaded twin's), and 1 shard against 2.
- The pool's accum modes feed ``Learner`` through the queue; a learner
  update on an accum trajectory, passed through as device tensors, equals
  the one on the same trajectory through the packed transport, bit for
  bit.
- The trajectory's hand-off from the actor's stream: a stand-in event that
  completes the unroll's last write only when waited on catches a consumer
  that reads first or an actor that records the event before the write.
- The port's pool against the live JAX pool in each of the four modes, the
  same weights through ``convert.py`` and the same env seeds, at the
  service parity's float32 tolerance (``rtol=1e-4, atol=1e-5``, the
  agent's; ``tests/test_torch_service.py``).  The samplers differ
  (``jax.random`` against ``torch.Generator``), so the port's sampler is
  replaced by one that returns the JAX side's sampled actions in step
  order: the policy is the unbiased one, the actions vary, and the port's
  last-action input (read from the device buffers under accum) is held
  against the JAX package's over two whole unrolls.
- ``--inference_mode=accum --replay_ratio=1``: the JAX driver replays
  nothing and says nothing (ROADMAP.md, queue 3, faults of the
  reference); the port refuses to start.
"""

import functools
import queue as queue_lib
import re
import threading

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import MultiEnv as JaxMultiEnv
from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu.envs.spec import TensorSpec as JaxTensorSpec
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.models import agent as jax_agent_mod
from scalable_agent_tpu.runtime import ActorPool as JaxActorPool
from scalable_agent_tpu.runtime import VectorActor as JaxVectorActor
from scalable_agent_tpu.runtime import accum_actor as jax_accum
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import registry as registry_lib
from scalable_agent_tpu_torch.obs.registry import MetricsRegistry
from scalable_agent_tpu_torch.ops import distributions
from scalable_agent_tpu_torch.runtime import (
    ActorPool,
    Learner,
    LearnerHyperparams,
    VectorActor,
)
from scalable_agent_tpu_torch.runtime import accum_actor as accum_mod
from scalable_agent_tpu_torch.runtime.accum_actor import (
    AccumPrograms,
    AccumVectorActor,
    GroupedAccumActor,
)
from scalable_agent_tpu_torch.runtime.actor import to_numpy
from scalable_agent_tpu_torch.runtime.transport import (
    PackedTransport,
    host_trajectory,
    tree_leaves,
)

NUM_ACTIONS = 5
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")
T = 6
B = 4
CORE = 32
CPU = torch.device("cpu")
# The JAX test's tolerance for accum against structural (float32).
TOL = dict(rtol=1e-5, atol=1e-6)
# The port against the JAX package: the agent's float32 tolerance.
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def make_envs(n=B, workers=2, seed_base=0, **kwargs):
    fns = [functools.partial(make_impala_stream, "fake_small",
                             seed=seed_base + i, num_actions=NUM_ACTIONS,
                             **kwargs)
           for i in range(n)]
    return MultiEnv(fns, FRAME, num_workers=workers)


def make_agent(**kwargs):
    return ImpalaAgent(NUM_ACTIONS, (16, 16, 3), core_size=CORE,
                       generator=torch.Generator().manual_seed(0),
                       **kwargs)


def programs_for(agent, **kwargs):
    return AccumPrograms(agent, T, B, FRAME.shape, **kwargs)


@pytest.fixture
def registry(monkeypatch):
    """A private process-global registry, so counters start at 0."""
    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    return registry


def assert_unrolls_match(s, a, msg=""):
    """A structural and an accum unroll (numpy), field by field."""
    se, ae = s.env_outputs, a.env_outputs
    np.testing.assert_array_equal(se.observation.frame,
                                  ae.observation.frame, err_msg=msg)
    np.testing.assert_array_equal(s.agent_outputs.action,
                                  a.agent_outputs.action, err_msg=msg)
    np.testing.assert_array_equal(se.done, ae.done, err_msg=msg)
    np.testing.assert_array_equal(se.info.episode_step,
                                  ae.info.episode_step, err_msg=msg)
    np.testing.assert_allclose(se.reward, ae.reward, rtol=1e-6, err_msg=msg)
    np.testing.assert_allclose(se.info.episode_return,
                               ae.info.episode_return, rtol=1e-6,
                               err_msg=msg)
    for got, want in ((a.agent_outputs.policy_logits,
                       s.agent_outputs.policy_logits),
                      (a.agent_outputs.baseline, s.agent_outputs.baseline),
                      (a.agent_state.c, s.agent_state.c),
                      (a.agent_state.h, s.agent_state.h)):
        np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


class TestEquivalence:
    def test_trajectories_match_structural_path(self):
        agent = make_agent()
        envs_a, envs_b = make_envs(), make_envs()
        try:
            structural = VectorActor(agent, envs_a, T, seed=7)
            accum = AccumVectorActor(programs_for(agent), envs_b, seed=7)
            for unroll in range(3):
                s = structural.run_unroll()
                a = accum.run_unroll()
                for leaf in tree_leaves((a.agent_state, a.env_outputs,
                                         a.agent_outputs)):
                    assert leaf is None or isinstance(leaf, torch.Tensor)
                a = to_numpy(a)
                for x, y in zip(tree_leaves(s.env_outputs),
                                tree_leaves(a.env_outputs)):
                    assert x is None or x.dtype == y.dtype
                assert s.agent_outputs.action.dtype == (
                    a.agent_outputs.action.dtype)
                assert_unrolls_match(s, a, f"unroll {unroll}")
        finally:
            envs_a.close()
            envs_b.close()

    def test_instruction_level_matches_structural_path(self):
        """Accum == structural on an instruction-carrying level: the int32
        instruction rides the per-step upload into its own buffer."""
        agent = make_agent(use_instruction=True)
        envs_a = make_envs(with_instruction=True)
        envs_b = make_envs(with_instruction=True)
        try:
            instr_shape = (16,)  # FakeEnv's instruction_len
            structural = VectorActor(agent, envs_a, T, seed=7)
            accum = AccumVectorActor(
                programs_for(agent, instruction_shape=instr_shape), envs_b,
                seed=7)
            for unroll in range(2):
                s = structural.run_unroll()
                a = to_numpy(accum.run_unroll())
                np.testing.assert_array_equal(
                    s.env_outputs.observation.instruction,
                    a.env_outputs.observation.instruction)
                assert a.env_outputs.observation.instruction.dtype == (
                    np.int32)
                assert_unrolls_match(s, a, f"unroll {unroll}")
        finally:
            envs_a.close()
            envs_b.close()

    def test_mismatched_instruction_config_is_clear_error(self):
        agent = make_agent()
        envs = make_envs(with_instruction=True)
        try:
            actor = AccumVectorActor(programs_for(agent), envs, seed=1)
            with pytest.raises(ValueError, match="instruction"):
                actor.run_unroll()
        finally:
            envs.close()

    def test_overlap_entry_carries_across_unrolls(self):
        """Entry 0 of unroll k+1 is entry T of unroll k (reference:
        experiment.py:311-321), its agent half included."""
        envs = make_envs()
        try:
            actor = AccumVectorActor(programs_for(make_agent()), envs,
                                     seed=3)
            first = to_numpy(actor.run_unroll())
            second = to_numpy(actor.run_unroll())
            for x, y in zip(tree_leaves((first.env_outputs,
                                         first.agent_outputs)),
                            tree_leaves((second.env_outputs,
                                         second.agent_outputs))):
                if x is not None:
                    np.testing.assert_array_equal(x[T], y[0])
            # The first-ever entry is the bootstrap.
            assert first.env_outputs.done[0].all()
            assert not first.agent_outputs.policy_logits[0].any()
        finally:
            envs.close()


class TestGroupedCoDispatch:
    def test_fused_matches_threaded_accum(self):
        """``GroupedAccumActor`` (one step on [k*B] rows and one fetch for
        all groups) gives each group the trajectories of a threaded
        ``AccumVectorActor`` with that group's seed."""
        agent = make_agent()
        k = 2
        fused_groups = [make_envs(seed_base=100 * g) for g in range(k)]
        solo_groups = [make_envs(seed_base=100 * g) for g in range(k)]
        try:
            programs = programs_for(agent)
            fused = GroupedAccumActor(programs, fused_groups,
                                      seeds=[1000 * i for i in range(k)])
            solos = [AccumVectorActor(programs, envs, seed=1000 * i)
                     for i, envs in enumerate(solo_groups)]
            for unroll in range(2):
                fused_outs = fused.run_unroll()
                assert len(fused_outs) == k
                for f, s in zip(fused_outs, [solo.run_unroll()
                                             for solo in solos]):
                    assert_unrolls_match(to_numpy(s), to_numpy(f),
                                         f"unroll {unroll}")
        finally:
            for envs in fused_groups + solo_groups:
                envs.close()

    def test_fused_shards_split_fleet_and_match(self):
        """``fused_shards=2`` over 3 groups: two lockstep drivers of 2 and
        1 groups, whose trajectories are the threaded path's; and 1 shard
        over the same groups gives the same."""
        agent = make_agent()
        outs = {}
        for shards in (2, 1):
            groups = [make_envs(workers=1, seed_base=100 * g)
                      for g in range(3)]
            pool = ActorPool(agent, groups, T, seed=11,
                             inference_mode="accum_fused",
                             fused_shards=shards)
            try:
                assert pool.fused_shards == shards and pool.link is None
                assert [len(a.envs_list) for a in pool.actors] == (
                    [2, 1] if shards == 2 else [3])
                pool.set_params(agent)
                outs[shards] = [
                    to_numpy(out) for actor in pool.actors
                    for out in actor.run_unroll(pool._get_params())]
            finally:
                pool.stop()
        solo_groups = [make_envs(workers=1, seed_base=100 * g)
                       for g in range(3)]
        try:
            programs = programs_for(agent)
            solos = [to_numpy(AccumVectorActor(
                programs, envs, seed=11 + 1000 * i).run_unroll())
                for i, envs in enumerate(solo_groups)]
        finally:
            for envs in solo_groups:
                envs.close()
        for two, one, solo in zip(outs[2], outs[1], solos):
            assert_unrolls_match(solo, two)
            assert_unrolls_match(solo, one)

    def test_pool_accum_fused_feeds_learner(self, registry):
        """ActorPool(accum_fused) -> Learner, per-group trajectories
        through the queue and the packed transport's pass-through."""
        agent = make_agent()
        learner_agent = make_agent()
        learner = Learner(learner_agent, LearnerHyperparams(
            total_environment_frames=1e6), T * B, scan_impl="pallas")
        groups = [make_envs(seed_base=100 * g) for g in range(2)]
        pool = ActorPool(agent, groups, T, seed=11,
                         inference_mode="accum_fused", fused_shards=1)
        pool.set_params(learner_agent)
        assert sum(envs.num_envs for envs in pool._all_envs()) == 2 * B
        transport = PackedTransport(CPU)
        pool.start()
        try:
            for _ in range(4):
                out = pool.get_trajectory(timeout=60)
                traj, _ = transport.put(host_trajectory(out),
                                        ready=out.ready)
                assert traj.agent_outputs.action.shape == (T + 1, B)
                metrics = learner.update(traj)
                pool.set_params(learner_agent)
            assert np.isfinite(float(metrics["total_loss"]))
            assert len(pool.episode_stats()) > 0
        finally:
            pool.stop()
        # Nothing was packed: the trajectories passed through.
        snapshot = registry.snapshot()
        assert snapshot.get("transport/pack_s_count", 0) == 0
        assert snapshot["transport/h2d_bytes_total"] > 0  # the actors'


class TestActorPoolAccumMode:
    def test_pool_accum_feeds_learner(self):
        agent = make_agent()
        learner_agent = make_agent()
        learner = Learner(learner_agent, LearnerHyperparams(
            total_environment_frames=1e6), T * B, scan_impl="pallas")
        groups = [make_envs(seed_base=100 * g) for g in range(2)]
        pool = ActorPool(agent, groups, T, seed=11, inference_mode="accum")
        pool.set_params(learner_agent)
        transport = PackedTransport(CPU)
        pool.start()
        try:
            for _ in range(3):
                out = pool.get_trajectory(timeout=60)
                traj, _ = transport.put(host_trajectory(out),
                                        ready=out.ready)
                assert traj.agent_outputs.action.shape == (T + 1, B)
                metrics = learner.update(traj)
                pool.set_params(learner_agent)
            assert np.isfinite(float(metrics["total_loss"]))
            assert float(metrics["env_frames"]) == 3 * T * B
        finally:
            pool.stop()

    def test_accum_rejects_ragged_groups(self):
        groups = [make_envs(2, workers=1), make_envs(3, workers=1)]
        try:
            for mode in ("accum", "accum_fused", "service"):
                with pytest.raises(ValueError,
                                   match="uniform group sizes"):
                    ActorPool(make_agent(), groups, T,
                              inference_mode=mode)
        finally:
            for envs in groups:
                envs.close()


class TestHandOff:
    def test_trajectory_is_read_after_the_actor_stream_wrote_it(
            self, monkeypatch):
        """The unroll's last writes (``_seal``: the trajectory's small
        fields unpacked from the buffers) cross from the actor's stream to
        the prefetch thread's.  Here they complete only when the actor's
        event is waited on, as on the card; until then slot T holds NaN
        rewards and step -1.  A consumer that read before
        waiting, or an actor that recorded its event before the write,
        would hand the learner those."""
        waited = []
        pending = []
        real_seal = accum_mod._seal

        class WriteEvent:
            def __init__(self, writes):
                self._writes = writes

            def synchronize(self):
                for write in self._writes:
                    write()
                self._writes = []
                waited.append(threading.current_thread().name)

        def deferred_seal(programs, bufs, groups):
            trajectories = real_seal(programs, bufs, groups)
            t = programs.unroll_length
            for env, _ in trajectories:
                reward, step = env.reward, env.info.episode_step
                saved = (reward[t].clone(), step[t].clone())
                reward[t] = float("nan")
                step[t] = -1

                def write(reward=reward, step=step, saved=saved):
                    reward[t], step[t] = saved

                pending.append(write)
            return trajectories

        def record(device):
            writes = list(pending)
            pending.clear()
            return WriteEvent(writes)

        monkeypatch.setattr(accum_mod, "_seal", deferred_seal)
        monkeypatch.setattr(accum_mod, "_record_ready", record)
        agent = make_agent()
        pool = ActorPool(agent, [make_envs()], T, seed=5,
                         inference_mode="accum")
        pool.set_params(agent)
        staged = queue_lib.Queue(maxsize=1)
        stop = threading.Event()
        pool.start()
        thread = driver.start_prefetch(pool, PackedTransport(CPU), CPU,
                                       staged, stop)
        try:
            outs = [driver._adopt(staged.get(timeout=60), CPU)
                    for _ in range(3)]
        finally:
            stop.set()
            pool.stop()
            thread.join(timeout=10)
        for k, out in enumerate(outs):
            assert np.isfinite(out.env_outputs.reward.numpy()).all(), k
            assert (out.env_outputs.info.episode_step >= 0).all(), k
        for first, second in zip(outs, outs[1:]):
            np.testing.assert_array_equal(
                first.env_outputs.observation.frame[T].numpy(),
                second.env_outputs.observation.frame[0].numpy())
            np.testing.assert_array_equal(
                first.env_outputs.reward[T].numpy(),
                second.env_outputs.reward[0].numpy())
        # Waited on by the consumer, never by the actor.
        assert waited and set(waited) == {"prefetch"}

    def test_reset_drops_a_half_written_unroll(self):
        """A failure mid-unroll leaves no buffer behind: the next unroll
        re-bootstraps from the envs' initial outputs."""
        envs = make_envs()
        actor = AccumVectorActor(programs_for(make_agent()), envs, seed=3)
        try:
            actor.run_unroll()
            real_recv, calls = envs.step_recv, [0]

            def failing_recv():
                calls[0] += 1
                if calls[0] == 3:
                    real_recv()
                    raise RuntimeError("env gone")
                return real_recv()

            envs.step_recv = failing_recv
            with pytest.raises(RuntimeError, match="env gone"):
                actor.run_unroll()
            assert actor._bufs is None
            envs.step_recv = real_recv
            actor.reset()
            out = to_numpy(actor.run_unroll())
            assert out.env_outputs.done[0].all()
            assert not out.agent_outputs.policy_logits[0].any()
            assert not out.agent_state.h.any()
            assert np.isfinite(out.agent_outputs.policy_logits).all()
        finally:
            envs.close()

    def test_learner_update_equals_the_packed_transports(self):
        """The same accum trajectories, passed through as tensors and
        packed from host copies, give the same losses bit for bit."""
        envs = make_envs()
        try:
            actor = AccumVectorActor(programs_for(make_agent()), envs,
                                     seed=3)
            outs = [actor.run_unroll() for _ in range(3)]
        finally:
            envs.close()
        losses = {}
        for name in ("device", "packed"):
            learner = Learner(make_agent(), LearnerHyperparams(
                total_environment_frames=1e3), T * B, scan_impl="pallas")
            transport = PackedTransport(CPU)
            losses[name] = []
            for out in outs:
                host = to_numpy(out) if name == "packed" else out
                traj, owners = transport.put(host_trajectory(host),
                                             ready=out.ready)
                if name == "device":
                    # The actor's own tensors: nothing was copied.
                    assert traj.env_outputs.observation.frame is (
                        out.env_outputs.observation.frame)
                else:
                    assert len(owners) == 1  # the packed buffer
                losses[name].append(
                    float(learner.update(traj)["total_loss"]))
        assert losses["device"] == losses["packed"]


# ---------------------------------------------------------------------------
# The port's pool against the JAX pool, mode by mode
# ---------------------------------------------------------------------------

MODES = ("structural", "service", "accum", "accum_fused")
PARITY_SEED = 7
PARITY_UNROLLS = 2


def _jax_envs():
    fns = [functools.partial(jax_stream, "fake_small", seed=i,
                             num_actions=NUM_ACTIONS) for i in range(B)]
    return JaxMultiEnv(fns, JaxTensorSpec((16, 16, 3), np.uint8, "frame"),
                       num_workers=1)


def _jax_unrolls(mode, agent, params):
    """Two unrolls of one group under the JAX package's ``mode``."""
    envs = _jax_envs()
    pool = None
    try:
        if mode == "structural":
            actor = JaxVectorActor(agent, envs, T, seed=PARITY_SEED)
        elif mode == "service":
            pool = JaxActorPool(agent, [envs], T, seed=PARITY_SEED,
                                inference_mode="service")
            pool.set_params(params)
            actor = pool._actors[0]
        else:
            programs = jax_accum.AccumPrograms(agent, T, B, FRAME.shape)
            actor = (jax_accum.AccumVectorActor(programs, envs,
                                                seed=PARITY_SEED)
                     if mode == "accum" else
                     jax_accum.GroupedAccumActor(programs, [envs],
                                                 seeds=[PARITY_SEED]))
        outs = []
        for _ in range(PARITY_UNROLLS):
            out = actor.run_unroll(params)
            out = out[0] if isinstance(out, list) else out
            outs.append(jax.tree_util.tree_map(
                lambda x: None if x is None else np.asarray(x), out,
                is_leaf=lambda x: x is None))
        return outs
    finally:
        if pool is not None:
            pool.stop()
        else:
            envs.close()


@pytest.fixture(scope="module")
def jax_pool_runs():
    """The JAX agent's weights and each mode's unrolls, computed once."""
    agent = JaxAgent(num_actions=NUM_ACTIONS, core_size=CORE)
    envs = _jax_envs()
    try:
        first = envs.initial()
    finally:
        envs.close()
    params = agent.init(
        jax.random.key(0), np.zeros((1, 1), np.int32),
        jax.tree_util.tree_map(
            lambda x: None if x is None else np.asarray(x)[None][:, :1],
            first, is_leaf=lambda x: x is None),
        jax_agent_mod.initial_state(1, CORE))
    params = jax.tree_util.tree_map(np.asarray, params)
    runs = {mode: _jax_unrolls(mode, agent, params) for mode in MODES}
    return params, runs


def _port_unrolls(mode, params, actions, monkeypatch):
    """The port's unrolls of one group under ``mode``, its sampler
    replaced by one that hands back ``actions`` ([B] rows, the JAX side's
    draws) in step order; every row is taken."""
    feed = iter(actions)

    def replay(generator, logits, spec):
        return torch.tensor(next(feed), dtype=torch.int64,
                            device=logits.device)

    monkeypatch.setattr(distributions, "sample", replay)
    agent = make_agent()
    agent.load_state_dict(convert.flax_to_state_dict(params))
    envs = make_envs(workers=1)
    pool = ActorPool(agent, [envs], T, seed=PARITY_SEED,
                     inference_mode=mode, fused_shards=1)
    pool.set_params(agent)
    try:
        (actor,) = pool.actors
        outs = []
        for _ in range(PARITY_UNROLLS):
            out = actor.run_unroll(pool._get_params())
            outs.append(to_numpy(out[0] if isinstance(out, list) else out))
    finally:
        pool.stop()
    assert next(feed, None) is None, "the port sampled fewer steps"
    return outs


@pytest.mark.parametrize("mode", MODES)
def test_pool_matches_the_jax_pool(jax_pool_runs, mode, monkeypatch):
    params, runs = jax_pool_runs
    actions = [row for want in runs[mode]
               for row in want.agent_outputs.action[1:]]
    # Varied actions, so the last-action input is not a constant.
    assert len(np.unique(actions)) > 1
    for unroll, (got, want) in enumerate(zip(
            _port_unrolls(mode, params, actions, monkeypatch), runs[mode])):
        msg = f"{mode} unroll {unroll}"
        np.testing.assert_array_equal(got.agent_outputs.action,
                                      want.agent_outputs.action, err_msg=msg)
        np.testing.assert_array_equal(got.env_outputs.observation.frame,
                                      want.env_outputs.observation.frame,
                                      err_msg=msg)
        np.testing.assert_array_equal(got.env_outputs.done,
                                      want.env_outputs.done, err_msg=msg)
        np.testing.assert_array_equal(got.env_outputs.reward,
                                      want.env_outputs.reward, err_msg=msg)
        for name, a, b in (
                ("logits", got.agent_outputs.policy_logits,
                 want.agent_outputs.policy_logits),
                ("baseline", got.agent_outputs.baseline,
                 want.agent_outputs.baseline),
                ("c", got.agent_state.c, want.agent_state.c),
                ("h", got.agent_state.h, want.agent_state.h)):
            np.testing.assert_allclose(a, b, err_msg=f"{msg} {name}",
                                       **JAX_TOL)


# ---------------------------------------------------------------------------
# Replay under accum: the JAX driver's silent zero, the port's refusal
# ---------------------------------------------------------------------------

REPLAY_RUN = dict(level_name="fake_small", num_actors=4, batch_size=2,
                  unroll_length=4, num_action_repeats=1, height=16,
                  width=16, loss="impact", replay_ratio=1,
                  replay_capacity=8, seed=5,
                  total_environment_frames=32,  # 4 updates of 8 frames
                  num_env_workers_per_group=1, checkpoint_interval_s=1e9,
                  log_interval_s=0.0, inference_mode="accum")


def test_accum_with_replay_refuses_where_the_jax_driver_replays_nothing(
        tmp_path):
    jax_driver.train(JaxConfig(logdir=str(tmp_path / "jax"), **REPLAY_RUN))
    prom = (tmp_path / "jax" / "metrics.prom").read_text()
    replayed = re.search(r"^impala_learner_replayed_updates_total (\S+)$",
                         prom, re.M)
    # The reference's fault, kept as it is: 4 updates with replay_ratio=1
    # and not one of them replayed.
    assert replayed is not None and float(replayed.group(1)) == 0.0
    for mode in ("accum", "accum_fused"):
        config = Config(device="cpu", logdir=str(tmp_path / mode),
                        **dict(REPLAY_RUN, inference_mode=mode))
        with pytest.raises(ValueError, match="packed upload"):
            driver.train(config)
        assert not (tmp_path / mode / "metrics.jsonl").exists()
