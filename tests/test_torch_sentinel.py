"""The port's numerics sentinel (``scalable_agent_tpu_torch/runtime/
sentinel.py``) and its driver wiring on the CPU, the torch twins of
``tests/test_sentinel.py``'s non-slow tests (the wiring and cadence, the
degradation ladder, fingerprints, the replay flush, the rollback flush and
the watchdog across an audit) and the slow twins of its host
``TestSentinelE2E`` runs, held against the live JAX package:

- the audit's deviation on the same converted parameters, optimizer state
  and batch, a live JAX ``NumericsSentinel`` against the port's, both
  auditing one update of their own learner: float32 clean within 1e-5 of
  each other (each ~1e-7: the hot and the reference routes differ only
  in the stem's weight-gradient route and the loss's two passes);
  ``kernel_miscompute`` 1.0 in both within 1e-5; ``param_bitflip`` the
  delta arm's, within 1e-3 relative (each side flips its own updated
  parameters); bf16 clean within ``BF16_BAND`` of each other and both in
  (1e-3, 0.3) (the bf16 rounding of the torso and heads, and of the core's
  operands, against float32);
- the bit flip and the fingerprint bitwise on the same parameters, and
  the flip in the JAX leaf order (the largest element of the first leaf
  wins a tie);
- ``_reference_config`` and each rung's overrides equal to the JAX ones.

The JAX in-graph tests (``test_ingraph_megaloop_with_sentinel_rejected``,
``test_ingraph_kernel_miscompute_detect_demote_finish``) have their twins
in ``tests/test_torch_ingraph.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.obs import get_registry as jax_get_registry
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime import TrainState as JaxTrainState
from scalable_agent_tpu.runtime import configure_faults as jax_configure
from scalable_agent_tpu.runtime import exit_codes as jax_exit_codes
from scalable_agent_tpu.runtime import sentinel as jax_sentinel
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import get_flight_recorder, get_registry
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
from scalable_agent_tpu_torch.runtime.faults import configure_faults
from scalable_agent_tpu_torch.runtime.exit_codes import (
    EXIT_CODES,
    SENTINEL_EXIT_CODE,
)
from scalable_agent_tpu_torch.runtime.replay import DeviceReplayBuffer
from scalable_agent_tpu_torch.runtime.sentinel import (
    _DIVERGE_MASK,
    LADDER,
    NumericsSentinel,
    _reference_config,
    check_fingerprints,
    flip_largest_bit,
    param_fingerprint,
)

import test_torch_learner as case

pytestmark = pytest.mark.chaos

# The bf16 audits of the two packages: each reads the bf16 policy's
# distance from float32 (~1e-2 here), rounded in other orders.
BF16_BAND = 0.05


def _counter_value(name: str) -> float:
    return float(get_registry().snapshot().get(name, 0.0))


@pytest.fixture(autouse=True)
def _clean_faults():
    configure_faults("")
    jax_configure("")
    yield
    configure_faults("")
    jax_configure("")


def _learner(compute_dtype="float32", conv_backend="pallas",
             fused_forward=True, state=None, core_impl="pallas"):
    agent = ImpalaAgent(case.A, (16, 16, 3), core_size=case.H,
                        generator=torch.Generator().manual_seed(0),
                        compute_dtype=getattr(torch, compute_dtype),
                        core_matmul_dtype=("bfloat16"
                                           if compute_dtype == "bfloat16"
                                           and core_impl == "pallas"
                                           else "float32"),
                        conv_backend=conv_backend, core_impl=core_impl)
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=1e3), case.FRAMES_PER_UPDATE,
        fused_forward=fused_forward)
    if state is not None:
        learner.load_state_dict(state)
    return agent, learner


@pytest.fixture(scope="module")
def learner_setup():
    agent, learner = _learner()
    return agent, learner


def _make_sentinel(agent, learner, rebuild=None, **config_overrides):
    overrides = dict(sentinel_interval=8, device="cpu")
    overrides.update(config_overrides)
    return NumericsSentinel(
        Config(**overrides), agent, learner,
        rebuild=rebuild or (lambda cfg: (agent, learner)))


def _sentinel_config(tmp_path, **overrides) -> Config:
    defaults = dict(
        mode="train", logdir=str(tmp_path / "run"), device="cpu",
        level_name="fake_small", num_actors=4, batch_size=2,
        unroll_length=4, num_action_repeats=1,
        total_environment_frames=48,  # 6 updates of 8 frames
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=0.0,
        log_interval_s=0.0, seed=5,
        sentinel_interval=2)  # audits after the 2nd, 4th, 6th updates
    defaults.update(overrides)
    return Config(**defaults)


# ---------------------------------------------------------------------------
# Wiring and cadence
# ---------------------------------------------------------------------------


class TestSentinelWiring:
    def test_constructor_rejects_sentinel_off(self, learner_setup):
        agent, learner = learner_setup
        with pytest.raises(ValueError, match="sentinel_interval"):
            NumericsSentinel(Config(device="cpu"), agent, learner,
                             rebuild=lambda cfg: (agent, learner))

    def test_build_sentinel_returns_none_when_off(self):
        assert Config().sentinel_interval == 0
        assert driver.build_sentinel(Config(), None, None, None, None,
                                     None) is None

    def test_audit_due_cadence(self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner, sentinel_interval=2)
        assert [sentinel.audit_due(u) for u in range(6)] == [
            False, True, False, True, False, True]

    def test_consume_swap_is_one_shot(self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        assert not sentinel.consume_swap()
        sentinel._on_breach(1.0, updates=0)
        assert sentinel.consume_swap()
        assert not sentinel.consume_swap()

    def test_reference_config_is_full_ladder(self):
        ref = _reference_config(Config())
        assert ref.conv_backend == "xla"
        assert ref.compute_dtype == "float32"
        assert ref.fused_forward is False

    def test_updates_per_dispatch_is_still_unported(self):
        """``--updates_per_dispatch`` is ported with the in-graph backend
        (the name is older): it parses, and the in-graph driver refuses
        the sentinel under the megaloop, as the JAX driver does
        (``tests/test_torch_ingraph.py`` runs it)."""
        config = Config.from_argv(["--sentinel_interval=2",
                                   "--updates_per_dispatch=8",
                                   "--train_backend=ingraph"])
        assert config.updates_per_dispatch == 8
        from scalable_agent_tpu_torch.driver import check_ingraph

        with pytest.raises(ValueError, match="sentinel"):
            check_ingraph(config)

    def test_exit_73_is_the_jax_sentinel_code(self):
        assert SENTINEL_EXIT_CODE == 73 == jax_exit_codes.SENTINEL_EXIT_CODE
        assert EXIT_CODES["sentinel"] == jax_exit_codes.EXIT_CODES[
            "sentinel"]


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


class TestDegradationLadder:
    def test_rungs_apply_cumulative_overrides(self, learner_setup):
        agent, learner = learner_setup
        seen = []

        def rebuild(cfg):
            seen.append(cfg)
            return agent, learner

        sentinel = _make_sentinel(agent, learner, rebuild=rebuild)
        sentinel._on_breach(1.0, updates=0)
        assert sentinel.rung == 1
        assert seen[-1].conv_backend == "xla"
        assert seen[-1].compute_dtype == Config().compute_dtype
        sentinel._on_breach(1.0, updates=1)
        assert sentinel.rung == 2
        assert seen[-1].compute_dtype == "float32"
        sentinel._on_breach(1.0, updates=2)
        assert sentinel.rung == 3
        assert seen[-1].fused_forward is False
        assert len(LADDER) == 3

    def test_exhaustion_rolls_back_once_then_exits_73(
            self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        trips_before = _counter_value("sentinel/trips_total")
        for updates in range(len(LADDER)):
            sentinel._on_breach(1.0, updates=updates)
        assert not sentinel.rollback_pending
        sentinel._on_breach(1.0, updates=3)
        assert sentinel.rollback_pending
        sentinel.note_rollback()
        assert not sentinel.rollback_pending
        with pytest.raises(SystemExit) as excinfo:
            sentinel._on_breach(1.0, updates=4)
        assert excinfo.value.code == SENTINEL_EXIT_CODE
        recorder = get_flight_recorder()
        names = {(e["kind"], e["name"]) for e in recorder.snapshot()}
        assert ("sentinel_trip", "exhausted") in names
        assert recorder.reason_pin.startswith("sentinel_trip")
        assert _counter_value("sentinel/trips_total") == trips_before + 5

    def test_demotion_hands_on_the_state_and_the_telemetry(self):
        """The rebuilt learner of a demotion takes the hot learner's state
        and its device telemetry: the published gauges keep their values
        (a fresh learner's read 0 until its first update, which the health
        plane's entropy_collapse detector took for a collapse) and no
        counter is published twice."""
        _, hot = _learner()
        hot.update(case._torch_traj(case._trajectory(0)))
        rebuilt = _learner("float32", "xla")
        sentinel = _make_sentinel(hot._agent, hot,
                                  rebuild=lambda cfg: rebuilt)
        want = hot.publish_device_telemetry()
        updates = _counter_value("devtel/learner/updates_total")
        sentinel._on_breach(1.0, updates=1)
        assert sentinel.consume_swap() and sentinel.learner is rebuilt[1]
        got = rebuilt[1].publish_device_telemetry()
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert _counter_value("devtel/learner/updates_total") == updates
        for name, tensor in hot.state_dict()["params"].items():
            assert torch.equal(rebuilt[1].state_dict()["params"][name],
                               tensor)

    def test_ladder_and_rungs_match_jax(self):
        assert LADDER == jax_sentinel.LADDER
        for compute_dtype in ("bfloat16", "float32"):
            ours = _reference_config(Config(compute_dtype=compute_dtype))
            theirs = jax_sentinel._reference_config(
                JaxConfig(compute_dtype=compute_dtype))
            for key in ("conv_backend", "compute_dtype",
                        "core_matmul_dtype", "fused_forward"):
                assert getattr(ours, key) == getattr(theirs, key), key
        seen = {"port": [], "jax": []}
        agent, learner = _learner()
        ours = _make_sentinel(agent, learner, rebuild=lambda cfg: (
            seen["port"].append(cfg), (agent, learner))[1])
        theirs = jax_sentinel.NumericsSentinel.__new__(
            jax_sentinel.NumericsSentinel)
        theirs._base_config = JaxConfig(sentinel_interval=8)
        theirs._rebuild = lambda cfg: (seen["jax"].append(cfg),
                                       (None, None))[1]
        theirs._rung, theirs._c_demotions = 0, _NullCounter()
        theirs._g_rung, theirs._rtol = _NullCounter(), 0.6
        for _ in LADDER:
            ours._demote(1.0, 0)
            theirs._demote(1.0, 0)
        for port_cfg, jax_cfg in zip(seen["port"], seen["jax"]):
            for key in ("conv_backend", "compute_dtype",
                        "core_matmul_dtype", "fused_forward"):
                assert getattr(port_cfg, key) == getattr(jax_cfg, key)


class _NullCounter:
    def inc(self, *args):
        pass

    def set(self, *args):
        pass


# ---------------------------------------------------------------------------
# Param fingerprints and the bit flip
# ---------------------------------------------------------------------------


def _params(learner):
    return learner.state_dict()["params"]


class TestFingerprints:
    def test_deterministic_and_published(self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        fp = sentinel.local_fingerprint(_params(learner))
        assert sentinel.local_fingerprint(_params(learner)) == fp
        assert 0 <= fp < 2 ** 32
        assert _counter_value("sentinel/param_fingerprint") == float(fp)

    def test_fingerprint_tracks_param_bits(self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        fp = sentinel.local_fingerprint(_params(learner))
        perturbed = {k: v.detach() + 1e-3 for k, v in
                     _params(learner).items()}
        assert sentinel.local_fingerprint(perturbed) != fp

    def test_replica_diverge_chaos_corrupts_fingerprint(
            self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        fp = sentinel.local_fingerprint(_params(learner))
        configure_faults("replica_diverge@1")
        assert sentinel.local_fingerprint(_params(learner)) == (
            fp ^ _DIVERGE_MASK)
        assert sentinel.local_fingerprint(_params(learner)) == fp

    def test_check_fingerprints_agreement_and_mismatch(
            self, learner_setup):
        agent, learner = learner_setup
        sentinel = _make_sentinel(agent, learner)
        mismatches_before = _counter_value(
            "sentinel/fingerprint_mismatch_total")
        for fps, want in (([[1234.0], [1234.0]], False),
                          ([[1234.0], [1235.0]], True)):
            assert check_fingerprints(np.asarray(fps)) is want
            assert jax_sentinel.NumericsSentinel.check_fingerprints(
                _jax_stub(), np.asarray(fps)) is want
        assert not sentinel.check_fingerprints(
            np.asarray([[1234.0], [1234.0]]))
        assert sentinel.check_fingerprints(
            np.asarray([[1234.0], [1235.0]]))
        assert _counter_value("sentinel/fingerprint_mismatch_total") == (
            mismatches_before + 1)
        kinds = {(e["kind"], e["name"])
                 for e in get_flight_recorder().snapshot()}
        assert ("sentinel_trip", "fingerprint") in kinds

    def test_fingerprint_and_bitflip_match_jax_bitwise(self, jax_cases):
        jax_params = jax_cases["params"]
        ours = convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jax_params))
        theirs = jax_sentinel.NumericsSentinel._build_checksum(None)(
            jax_params)
        assert int(param_fingerprint(ours)) == int(np.asarray(theirs))
        flipped = {k: v.clone() for k, v in ours.items()}
        flip_largest_bit(flipped)
        want = convert.flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray,
            jax_sentinel.NumericsSentinel._build_flip(None)(jax_params)))
        changed = [k for k in ours if not torch.equal(ours[k], flipped[k])]
        assert len(changed) == 1
        for name in ours:
            assert torch.equal(flipped[name].view(torch.int32),
                               want[name].view(torch.int32)), name

    def test_bitflip_takes_the_first_leaf_of_a_tie(self):
        """Two elements of the largest magnitude: the flip lands in the
        one whose flax leaf comes first (``baseline/kernel`` before
        ``policy_logits/kernel``), as ``jnp.argmax`` over the JAX leaves
        picks it."""
        agent, learner = _learner()
        params = {k: v.detach().clone() for k, v in
                  _params(learner).items()}
        big = float(max(p.abs().max() for p in params.values())) * 4
        params["policy_logits.weight"][0, 0] = big
        params["baseline.weight"][0, 3] = -big
        flipped = {k: v.clone() for k, v in params.items()}
        flip_largest_bit(flipped)
        assert torch.equal(flipped["policy_logits.weight"],
                           params["policy_logits.weight"])
        assert not torch.equal(flipped["baseline.weight"],
                               params["baseline.weight"])


def _jax_stub():
    stub = jax_sentinel.NumericsSentinel.__new__(
        jax_sentinel.NumericsSentinel)
    stub._c_fp_mismatch = stub._c_trips = _NullCounter()
    return stub


# ---------------------------------------------------------------------------
# The audit against the live JAX sentinel
# ---------------------------------------------------------------------------


def _jax_learner(compute_dtype, fused_forward):
    """The JAX CPU route, ``xla`` core and stem (the Pallas kernels'
    interpret mode costs ~20 s of compiles here): bf16 torso and heads,
    float32 core products."""
    agent = JaxAgent(num_actions=case.A, core_size=case.H,
                     core_impl="xla", conv_backend="xla",
                     compute_dtype=jax.numpy.dtype(compute_dtype),
                     core_matmul_dtype="float32")
    return agent, JaxLearner(
        agent, JaxHp(total_environment_frames=1e3),
        make_mesh(MeshSpec(data=1), devices=jax.devices()[:1]),
        case.FRAMES_PER_UPDATE, device_telemetry=False,
        learn_telemetry=False, fused_forward=fused_forward)


def _jax_max_dev(sentinel):
    sentinel.publish()
    return float(jax_get_registry().snapshot()[
        "devtel/sentinel/max_deviation"])


def _jax_start(hot):
    """The JAX state after one update of batch 0 from the port's seeded
    initial weights (the flax init runs ~120 op-by-op compiles here)."""
    params = jax.tree_util.tree_map(jax.numpy.asarray,
                                    convert.state_dict_to_flax(
                                        _params(_learner()[1])))
    zero = lambda: jax.numpy.zeros((), jax.numpy.float32)
    state = hot.place_state(JaxTrainState(
        params=params, opt_state=hot._tx.init(params), env_frames=zero(),
        nonfinite_skips=zero(), nonfinite_streak=zero()))
    state, _ = hot.update(state, case._jax_traj(case._trajectory(0)))
    return jax.tree_util.tree_map(np.asarray, state)


def _jax_audits(compute_dtype, specs, start=None):
    """The JAX sentinel's deviation for each chaos spec over the same
    start (``_jax_start``), auditing the update of batch 1.  The ladder's
    rebuilds hand back the same learners, and the compiled audit is
    reused across the specs."""
    hot_agent, hot = _jax_learner(compute_dtype, True)
    ref_pair = _jax_learner("float32", False)
    traj1 = case._jax_traj(case._trajectory(1))
    start = _jax_start(hot) if start is None else start
    sentinel = jax_sentinel.NumericsSentinel(
        JaxConfig(sentinel_interval=1, compute_dtype=compute_dtype),
        hot_agent, hot,
        rebuild=lambda cfg: (ref_pair if not cfg.fused_forward
                             else (hot_agent, hot)))
    devs = []
    for spec in specs:
        jax_configure(spec)
        audit_fn = sentinel._audit_fn
        before = jax.tree_util.tree_map(jax.numpy.asarray, start)
        snap = sentinel.snapshot(before)
        after, _ = hot.update(before, traj1)
        sentinel.audit(snap, traj1, after, updates=1)
        devs.append(_jax_max_dev(sentinel))
        # Back to rung 0 for the next spec (a breach demoted the ladder).
        sentinel._rung = 0
        sentinel._audit_fn = audit_fn or sentinel._audit_fn
    jax_configure("")
    return start, devs


F32_SPECS = ("", "kernel_miscompute@1", "param_bitflip@1")


@pytest.fixture(scope="module")
def jax_cases():
    start, f32 = _jax_audits("float32", F32_SPECS)
    _, bf16 = _jax_audits("bfloat16", ("",), start)
    return {"params": start.params, "start": start, "float32": f32,
            "bfloat16": bf16}


def _port_state(start):
    host = lambda tree: convert.flax_to_state_dict(tree)
    return {"params": host(start.params),
            "opt_state": host(start.opt_state[0].nu),
            "env_frames": float(start.env_frames),
            "nonfinite_skips": float(start.nonfinite_skips),
            "nonfinite_streak": float(start.nonfinite_streak)}


def _port_audits(start, compute_dtype, specs, core_impl="pallas"):
    state = _port_state(start)
    traj = case._torch_traj(case._trajectory(1))
    devs = []
    for spec in specs:
        configure_faults(spec)
        agent, hot = _learner(compute_dtype, state=state,
                              core_impl=core_impl)
        ref_pair = _learner("float32", "xla", False)
        sentinel = NumericsSentinel(
            Config(device="cpu", sentinel_interval=1,
                   compute_dtype=compute_dtype), agent, hot,
            rebuild=lambda cfg: (ref_pair if not cfg.fused_forward
                                 else (agent, hot)))
        snap = sentinel.snapshot()
        hot.update(traj)
        sentinel.audit(snap, traj, updates=1)
        grad_dev, delta_dev = sentinel.last_deviations
        devs.append(float(torch.maximum(grad_dev.max(), delta_dev.max())))
        assert len(sentinel.leaf_names) == len(grad_dev)
    return devs


class TestAuditMatchesJax:
    def test_float32_clean_miscompute_and_bitflip(self, jax_cases):
        ours = _port_audits(jax_cases["start"], "float32", F32_SPECS)
        theirs = jax_cases["float32"]
        clean, miscompute, bitflip = ours
        assert clean < 1e-5 and theirs[0] < 1e-5
        assert abs(clean - theirs[0]) < 1e-5
        assert abs(miscompute - 1.0) < 1e-5
        assert abs(theirs[1] - 1.0) < 1e-5
        assert bitflip > 10.0
        np.testing.assert_allclose(bitflip, theirs[2], rtol=1e-3)

    def test_bf16_clean_within_the_band(self, jax_cases):
        """The bf16 policy on the route both packages run here: bf16
        torso and heads, the core's products at float32 (``xla``)."""
        (ours,) = _port_audits(jax_cases["start"], "bfloat16", ("",),
                               core_impl="xla")
        (theirs,) = jax_cases["bfloat16"]
        assert 1e-3 < ours < 0.3 and 1e-3 < theirs < 0.3
        assert abs(ours - theirs) < BF16_BAND


# ---------------------------------------------------------------------------
# Replay slab lineage
# ---------------------------------------------------------------------------


class TestReplayFlush:
    def test_flush_empties_slab_counts_and_rearms(self):
        buf = DeviceReplayBuffer(capacity=4, seed=0)
        tree = {"reward": torch.ones((4, 2))}
        buf.insert(tree)
        buf.insert(tree)
        assert buf.size == 2
        flushes_before = _counter_value("replay/rollback_flushes_total")
        buf.flush()
        assert buf.size == 0
        assert _counter_value("replay/rollback_flushes_total") == (
            flushes_before + 1)
        buf.insert(tree)
        assert buf.size == 1
        np.testing.assert_array_equal(buf.sample()["reward"].numpy(),
                                      np.ones((4, 2), np.float32))

    def test_flush_before_first_insert_is_safe(self):
        buf = DeviceReplayBuffer(capacity=4, seed=0)
        buf.flush()
        assert buf.size == 0


# ---------------------------------------------------------------------------
# The driver: rollback lineage, the watchdog across an audit, and the slow
# end-to-end runs
# ---------------------------------------------------------------------------


def _sentinel_counters():
    return {name: _counter_value(name) for name in (
        "sentinel/trips_total",
        "sentinel/demotions_total",
        "devtel/sentinel/audits_total",
        "devtel/sentinel/breaches_total",
        "faults/injected_total",
    )}


class TestRollbackFlushesReplay:
    def test_nonfinite_rollback_flushes_slab_and_run_rewarns(
            self, tmp_path):
        config = _sentinel_config(
            tmp_path, total_environment_frames=64, sentinel_interval=0,
            chaos_spec="nan_grad@3:4:5:6", nonfinite_tolerance=2,
            replay_ratio=1, replay_capacity=8, loss="impact")
        before = {
            "flushes": _counter_value("replay/rollback_flushes_total"),
            "rollbacks": _counter_value("learner/rollbacks_total"),
        }
        metrics = driver.train(config)
        assert metrics["env_frames"] == 64
        assert np.isfinite(metrics["total_loss"])
        assert _counter_value("learner/rollbacks_total") == (
            before["rollbacks"] + 1)
        assert _counter_value("replay/rollback_flushes_total") >= (
            before["flushes"] + 1)


class TestWatchdogSuspendedAcrossRecovery:
    """An audit (and a demotion's rebuild) longer than the watchdog's
    deadline is recovery, not a wedge: the heartbeat is suspended across
    it."""

    def test_no_stalls_across_audit_and_rejit(self, tmp_path,
                                              monkeypatch):
        real_audit = NumericsSentinel.audit
        slept = []

        def slow_audit(self, snap, trajectory, updates):
            if not slept:
                slept.append(updates)
                import time as _time

                _time.sleep(6.0)
            return real_audit(self, snap, trajectory, updates)

        monkeypatch.setattr(NumericsSentinel, "audit", slow_audit)
        config = _sentinel_config(
            tmp_path, chaos_spec="param_bitflip@1",
            watchdog_timeout_s=4.0)
        stalls_before = _counter_value("watchdog/stalls_total")
        demotions_before = _counter_value("sentinel/demotions_total")
        metrics = driver.train(config)
        assert metrics["env_frames"] == 48
        assert slept, "the slow audit never ran"
        assert _counter_value("sentinel/demotions_total") == (
            demotions_before + 1)
        assert _counter_value("watchdog/stalls_total") == stalls_before


@pytest.mark.slow
class TestSentinelE2E:
    """Driver runs, slow like the JAX class."""

    @pytest.mark.parametrize("spec", ["param_bitflip@1",
                                      "kernel_miscompute@1"])
    def test_host_detect_demote_finish(self, tmp_path, spec):
        config = _sentinel_config(tmp_path, chaos_spec=spec)
        before = _sentinel_counters()
        metrics = driver.train(config)
        assert metrics["env_frames"] == 48
        assert np.isfinite(metrics["total_loss"])
        after = _sentinel_counters()
        # 6 updates at interval 2: 3 audits; the first breaches and
        # demotes one rung, the later ones run clean and the run finishes.
        for name, delta in (("devtel/sentinel/audits_total", 3),
                            ("devtel/sentinel/breaches_total", 1),
                            ("sentinel/trips_total", 1),
                            ("sentinel/demotions_total", 1),
                            ("faults/injected_total", 1)):
            assert after[name] == before[name] + delta, name
        assert _counter_value("sentinel/rung") == 1.0
        names = {(e["kind"], e["name"])
                 for e in get_flight_recorder().snapshot()}
        assert ("sentinel_trip", "audit") in names
        assert ("sentinel_trip", "demote") in names

    def test_sentinel_quiet_on_clean_run(self, tmp_path):
        config = _sentinel_config(tmp_path, total_environment_frames=32)
        before = _sentinel_counters()
        metrics = driver.train(config)
        assert metrics["env_frames"] == 32
        after = _sentinel_counters()
        assert after["devtel/sentinel/audits_total"] == (
            before["devtel/sentinel/audits_total"] + 2)
        assert after["devtel/sentinel/breaches_total"] == (
            before["devtel/sentinel/breaches_total"])
        assert after["sentinel/trips_total"] == (
            before["sentinel/trips_total"])


def test_snapshots_carry_the_dtype_policy_to_the_actors():
    """The float32 rung reaches the actors: a snapshot of a float32 agent
    loaded into a bf16 actor's private agent gives it the float32 policy
    with the weights; a snapshot without a policy leaves the loader's."""
    from scalable_agent_tpu_torch.runtime import actor as actor_lib

    bf16_agent, _ = _learner("bfloat16")
    f32_agent, _ = _learner("float32")
    snapshot = actor_lib.snapshot_params_for_inference(f32_agent, 3)
    assert snapshot.policy == (torch.float32, "float32")
    actor_lib.load_snapshot(bf16_agent, snapshot._replace(policy=None))
    assert bf16_agent.dtype_policy == (torch.bfloat16, "bfloat16")
    actor_lib.load_snapshot(bf16_agent, snapshot)
    assert bf16_agent.dtype_policy == (torch.float32, "float32")
    assert bf16_agent.convnet.dtype == torch.float32
    for got, want in zip(bf16_agent.parameters(), f32_agent.parameters()):
        assert torch.equal(got, want)


@pytest.mark.slow
def test_demotion_reaches_the_actors_dtype_policy(tmp_path):
    """A bf16 run demoted twice (rung 2: float32) hands its actors' agents
    the float32 policy with the next published weights."""
    from scalable_agent_tpu_torch.runtime import actor as actor_lib

    loaded = []
    real_load = actor_lib.load_snapshot

    def spy(agent, snapshot):
        real_load(agent, snapshot)
        loaded.append(agent.dtype_policy)

    config = _sentinel_config(
        tmp_path, compute_dtype="bfloat16", sentinel_interval=1,
        total_environment_frames=32,
        chaos_spec="kernel_miscompute@1;param_bitflip@2")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(actor_lib, "load_snapshot", spy)
        metrics = driver.train(config)
    assert metrics["env_frames"] == 32
    assert _counter_value("sentinel/rung") == 2.0
    assert loaded[0] == (torch.bfloat16, "bfloat16")
    assert loaded[-1] == (torch.float32, "float32")
