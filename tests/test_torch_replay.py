"""The port's replay slab (scalable_agent_tpu_torch/runtime/replay.py), the
off-policy driver loop, and the learner over many updates, held against
the live JAX package.

- Twins of JAX ``tests/test_replay.py::TestDeviceReplayBuffer`` on the
  CPU: the round trip, the ring, uniform draws over valid slots only,
  the errors, the counters and the occupancy gauge, the host mirror's
  slot equal to the draw's, the postprocess, and no host sync in
  ``insert`` or ``sample``: no tensor is read on the host (``item``,
  ``bool``, ``int``, ``float``, ``tolist``, ``numpy``) while they
  dispatch, the staleness mirror (host tensors by design) silenced as the
  JAX test silences it.  On the card, ``chip_smoke.py``'s phase 3o runs
  both under ``torch.cuda.set_sync_debug_mode("error")``.
- The slot draw (``slot_index``) equals JAX ``replay._slot_index`` over
  a grid of seeds, counters and fills, past 2**16 slots and 2**31 - 1.
- ``replay_corrupt`` makes the replayed update a guard skip; ``flush``
  empties the ring and keeps the draw counter running; inserts and
  samples from more threads than cores lose no update of the ring.
- The driver: a ``--loss=impact --replay_ratio=2`` run counts fresh frames
  once and publishes the replay and ledger families (the twin of JAX
  ``tests/test_replay_smoke.py``), a rollback flushes the slab,
  ``--transport=per_leaf`` with replay raises, and ``replay_ratio=0``
  builds nothing.
- The learner against the live JAX ``Learner`` (and, with replay, the
  live JAX ``DeviceReplayBuffer``) at small shapes: ``loss=vtrace`` over
  30 updates, and ``loss=impact`` with ``replay_ratio=1`` and
  ``target_update_interval=3`` over 10 fresh updates, each followed by a
  replayed one drawn from a ring of 4 by both packages' buffers (the same
  slots: the sampled batches are compared bitwise).  Losses, the IMPACT
  ratio and clip fraction, ``env_frames`` and the learning rate at every
  update at rtol 1e-4, atol 1e-6; the parameters' change from the start
  after every update within 1e-3 of each leaf's largest change
  (``tests/test_torch_learner.py``'s float32 tolerances).  Each live JAX
  case is computed once per module.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import DeviceReplayBuffer as JaxReplay
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime.replay import _slot_index as jax_slot_index
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import MetricsRegistry, get_registry
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.runtime.replay import (
    DeviceReplayBuffer,
    slot_index,
)
from scalable_agent_tpu_torch.runtime.transport import make_transport

import test_torch_transport as transport_case


def _tree(value: float):
    """A small tree (with a None leaf, the transport's convention) whose
    float leaf encodes ``value``."""
    return {"x": torch.full((3, 4), float(value)),
            "n": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "absent": None}


def _value(tree) -> float:
    return float(tree["x"][0, 0])


def _buffer(capacity, seed=0, **kwargs):
    return DeviceReplayBuffer(capacity, seed=seed,
                              registry=kwargs.pop("registry", None),
                              **kwargs)


# ---------------------------------------------------------------------------
# The slab
# ---------------------------------------------------------------------------


class TestDeviceReplayBuffer:
    """Twins of JAX ``tests/test_replay.py::TestDeviceReplayBuffer``."""

    def test_insert_sample_round_trip_bit_exact(self):
        buf = _buffer(4)
        buf.insert(_tree(7.5))
        out = buf.sample()
        assert out["absent"] is None
        assert torch.equal(out["x"], torch.full((3, 4), 7.5))
        assert torch.equal(out["n"], torch.arange(6, dtype=torch.int32)
                           .reshape(2, 3))

    def test_sample_is_a_copy_not_a_view(self):
        buf = _buffer(2)
        buf.insert(_tree(1.0))
        out = buf.sample()
        out["x"].fill_(9.0)
        assert _value(buf.sample()) == 1.0

    def test_ring_overwrites_oldest(self):
        buf = _buffer(2, seed=1)
        for value in (1.0, 2.0, 3.0):
            buf.insert(_tree(value))
        assert buf.size == 2
        seen = {_value(buf.sample()) for _ in range(32)}
        assert seen == {2.0, 3.0}

    def test_sampling_is_uniform_over_valid_slots_only(self):
        buf = _buffer(8, seed=2)
        for value in (1.0, 2.0, 3.0):
            buf.insert(_tree(value))
        assert {_value(buf.sample()) for _ in range(64)} == {1.0, 2.0, 3.0}

    def test_empty_sample_raises(self):
        with pytest.raises(RuntimeError, match="empty"):
            _buffer(4).sample()

    def test_structure_mismatch_raises(self):
        buf = _buffer(4)
        buf.insert(_tree(1.0))
        with pytest.raises(ValueError, match="structure"):
            buf.insert({"different": torch.zeros(2)})

    def test_capacity_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            DeviceReplayBuffer(0)

    def test_counters_and_occupancy_gauge(self):
        registry = MetricsRegistry()
        buf = _buffer(4, registry=registry)
        buf.insert(_tree(1.0))
        buf.insert(_tree(2.0))
        buf.sample()
        snap = registry.snapshot()
        assert snap["replay/insert_total"] == 2
        assert snap["replay/sampled_total"] == 1
        assert snap["replay/occupancy"] == 0.5
        assert snap["replay/insert_s/count"] == 2
        assert snap["replay/sample_s/count"] == 1
        assert buf.nbytes == 4 * (12 * 4 + 6 * 4)

    def test_device_slot_draw_matches_host_mirror(self):
        seed, capacity = 11, 4
        buf = _buffer(capacity, seed=seed)
        for value in range(capacity):
            buf.insert(_tree(float(value)))
        for counter in range(16):
            sampled = _value(buf.sample())
            assert sampled == buf.mirror_slot(counter, capacity)
            assert sampled == int(jax_slot_index(seed, counter, capacity))

    def test_insert_and_sample_read_nothing_on_the_host(self, monkeypatch):
        from torch.overrides import TorchFunctionMode

        reads = ("item", "__bool__", "__int__", "__float__", "__index__",
                 "tolist", "numpy")

        class Spy(TorchFunctionMode):
            def __init__(self):
                super().__init__()
                self.calls = []

            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, "__name__", "")
                if name in reads:
                    self.calls.append(name)
                return func(*args, **(kwargs or {}))

        buf = _buffer(4, seed=3)
        buf.insert(_tree(1.0))
        buf.sample()
        monkeypatch.setattr(DeviceReplayBuffer, "mirror_slot",
                            lambda self, counter, filled: 0)
        fresh = _tree(2.0)
        with Spy() as spy:
            buf.insert(fresh)
            out = buf.sample()
        assert spy.calls == [], spy.calls
        assert _value(out) in (1.0, 2.0)
        # The spy sees host reads: the mirror's own int() is one.
        monkeypatch.undo()
        with Spy() as spy:
            buf.mirror_slot(0, 2)
        assert spy.calls

    def test_postprocess_is_applied(self):
        buf = _buffer(2, postprocess=lambda tree: tree["x"] * 2.0)
        buf.insert(_tree(3.0))
        assert torch.equal(buf.sample(), torch.full((3, 4), 6.0))

    def test_flush_empties_the_ring_and_keeps_the_counter(self):
        registry = MetricsRegistry()
        seed = 4
        buf = _buffer(4, seed=seed, registry=registry)
        for value in (1.0, 2.0, 3.0):
            buf.insert(_tree(value))
        buf.sample()
        buf.flush()
        assert buf.size == 0
        assert registry.snapshot()["replay/rollback_flushes_total"] == 1
        assert registry.snapshot()["replay/occupancy"] == 0.0
        with pytest.raises(RuntimeError, match="empty"):
            buf.sample()
        for value in (5.0, 6.0):
            buf.insert(_tree(value))
        # The ring restarts at slot 0; the draw counter goes on at 1.
        draws = [_value(buf.sample()) for _ in range(8)]
        assert draws == [(5.0, 6.0)[buf.mirror_slot(c, 2)]
                         for c in range(1, 9)]
        assert set(draws) == {5.0, 6.0}


def test_inserts_and_samples_from_many_threads_lose_nothing():
    """More threads than cores insert and sample at once, with a short
    switch interval: the ring's host mirrors and device counters agree
    with the count of operations, and every sample is a whole inserted
    tree."""
    import os
    import sys
    import threading

    registry = MetricsRegistry()
    buf = _buffer(8, seed=9, registry=registry)
    buf.insert(_tree(0.0))
    writers = readers = max(4, os.cpu_count() or 1)
    per_thread = 20
    bad = []

    def write(k):
        for i in range(per_thread):
            buf.insert(_tree(1000.0 * (k + 1) + i))

    def read():
        for _ in range(per_thread):
            tree = buf.sample()
            if not (torch.all(tree["x"] == tree["x"][0, 0])
                    and torch.equal(tree["n"], _tree(0.0)["n"])):
                bad.append(tree)

    threads = ([threading.Thread(target=write, args=(k,))
                for k in range(writers)]
               + [threading.Thread(target=read) for _ in range(readers)])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert not bad
    inserts, samples = 1 + writers * per_thread, readers * per_thread
    snap = registry.snapshot()
    assert (snap["replay/insert_total"], snap["replay/sampled_total"]) == (
        inserts, samples)
    assert buf.size == int(buf._filled) == 8
    assert buf._host_cursor == int(buf._cursor) == inserts % 8
    assert buf._host_counter == int(buf._counter) == samples


@pytest.fixture(scope="module")
def jax_slots():
    grid = list(itertools.product(
        (0, 1, 5, 123456, 2 ** 31 - 1), (0, 1, 7, 65535, 2 ** 20 + 3),
        (0, 1, 3, 64, 70000, 2 ** 31 - 1)))
    return {case: int(jax_slot_index(*case)) for case in grid}


def test_slot_draw_is_jax_bit_for_bit(jax_slots):
    for (seed, counter, filled), want in jax_slots.items():
        got = int(slot_index(seed, torch.tensor(counter),
                             torch.tensor(filled)))
        assert got == want, (seed, counter, filled)
    assert len(set(jax_slots.values())) > 10


def test_replay_corrupt_is_taken_as_a_skip():
    torch.manual_seed(0)
    agent = ImpalaAgent(3, (16, 16, 3), core_size=16)
    learner = Learner(agent, LearnerHyperparams(), 80, loss="impact")
    buf = _buffer(2)
    traj = make_transport("per_leaf", "cpu").put(
        transport_case.example(num_actions=3, core=16, seed=3))[0]
    buf.insert(traj)
    before = {k: v.clone() for k, v in learner._params.items()}
    faults.configure_faults("replay_corrupt@1", seed=0)
    try:
        poisoned = buf.sample()
    finally:
        faults.configure_faults("")
    assert torch.isnan(poisoned.env_outputs.reward).all()
    metrics = learner.update(poisoned, fresh=False)
    assert float(metrics["update_skipped"]) == 1.0
    assert all(torch.equal(before[k], v) for k, v in learner._params.items())
    assert not torch.isnan(buf.sample().env_outputs.reward).any()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

FRESH_UPDATES, REPLAY_RATIO = 4, 2
TOTAL_FRAMES = 32


def _replay_config(tmp_path, **overrides) -> Config:
    """tests/test_replay_smoke.py's settings: 4 fresh updates of 8
    frames, each chased by 2 replayed ones."""
    defaults = dict(
        device="cpu", logdir=str(tmp_path / "run"), level_name="fake_small",
        num_actors=4, batch_size=2, unroll_length=4, num_action_repeats=1,
        total_environment_frames=TOTAL_FRAMES, height=16, width=16,
        num_env_workers_per_group=2, compute_dtype="float32",
        checkpoint_interval_s=1e9, log_interval_s=0.0, seed=5,
        replay_ratio=REPLAY_RATIO, loss="impact", replay_capacity=8)
    defaults.update(overrides)
    return Config(**defaults)


def _prom_values(logdir):
    out = {}
    with open(f"{logdir}/metrics.prom") as f:
        for line in f:
            if line.startswith("#") or " " not in line:
                continue
            key, _, value = line.rstrip().rpartition(" ")
            try:
                out[key] = float(value)
            except ValueError:
                pass
    return out


def test_replay_run_counts_fresh_frames_once(tmp_path, monkeypatch):
    from scalable_agent_tpu_torch.obs import registry as registry_lib

    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    config = _replay_config(tmp_path)
    metrics = driver.train(config)
    assert metrics["env_frames"] == TOTAL_FRAMES
    assert np.isfinite(metrics["total_loss"])
    snap = registry.snapshot()
    replayed = FRESH_UPDATES * REPLAY_RATIO
    assert snap["replay/insert_total"] >= FRESH_UPDATES
    assert snap["replay/sampled_total"] == replayed
    assert snap["learner/replayed_updates_total"] == replayed
    assert snap["learner/env_frames_total"] == TOTAL_FRAMES
    assert snap["ledger/staleness_replayed_s/count"] == replayed
    assert snap["ledger/trajectories_retired_total"] >= FRESH_UPDATES
    assert snap["ledger/open_records"] == 0.0
    assert snap["devtel/learner/updates"] == FRESH_UPDATES * (
        1 + REPLAY_RATIO)
    assert snap["devtel/learner/skipped"] == 0.0
    assert snap["devtel/learn/impact_ratio/count"] == FRESH_UPDATES * (
        1 + REPLAY_RATIO)
    values = _prom_values(config.logdir)
    assert values["impala_replay_occupancy"] == pytest.approx(
        min(snap["replay/insert_total"], 8) / 8)
    for key in ("impala_replay_insert_s_count",
                "impala_replay_sample_s_count",
                "impala_ledger_rate_replay_insert_per_s",
                "impala_ledger_rate_replay_sample_per_s",
                "impala_replay_target_update_interval"):
        assert key in values, key
    with open(f"{config.logdir}/metrics.prom") as f:
        assert 'impala_ledger_staleness_replayed_s{quantile="0.95"}' \
            in f.read()
    # The checkpoint holds the target network; --mode=test evaluates it.
    returns = driver.test(dataclasses.replace(config, mode="test",
                                              test_num_episodes=2))
    assert len(returns["fake_small"]) == 2


def test_rollback_flushes_the_slab(tmp_path, monkeypatch):
    from scalable_agent_tpu_torch.obs import registry as registry_lib

    registry = MetricsRegistry()
    monkeypatch.setattr(registry_lib, "_registry", registry)
    config = _replay_config(
        tmp_path, replay_ratio=1, total_environment_frames=40,
        checkpoint_interval_s=0.0, chaos_spec="nan_grad@3:4:5",
        nonfinite_tolerance=2)
    metrics = driver.train(config)
    assert metrics["env_frames"] == 40
    snap = registry.snapshot()
    assert snap["learner/rollbacks_total"] == 1
    assert snap["replay/rollback_flushes_total"] == 1
    assert snap["learner/env_frames_total"] >= 40


def test_replay_requires_the_packed_transport(tmp_path):
    with pytest.raises(ValueError, match="packed"):
        driver.train(_replay_config(tmp_path, transport="per_leaf"))


@pytest.mark.parametrize("overrides,match", [
    (dict(loss="ppo"), "loss"), (dict(replay_ratio=-1), "replay_ratio"),
    (dict(replay_ratio=1, replay_capacity=0), "replay_capacity")])
def test_off_policy_flags_are_checked(overrides, match):
    config = Config(device="cpu", **overrides)
    with pytest.raises(ValueError, match=match):
        driver.build_learner(config, None)


def test_replay_off_allocates_nothing():
    transport = make_transport("packed", "cpu")
    assert driver.build_replay(Config(device="cpu"), transport) is None
    assert transport._upload_sink is None
    with pytest.raises(ValueError, match="packed"):
        driver.build_replay(Config(device="cpu", replay_ratio=1),
                            make_transport("per_leaf", "cpu"))


# ---------------------------------------------------------------------------
# The learner against the live JAX Learner and DeviceReplayBuffer
# ---------------------------------------------------------------------------

A, H, CAPACITY, SEED = 3, 16, 4, 7
T, B = transport_case.T, transport_case.B
FPU = T * B * 4
TOTAL = 5e3
# name: (loss, replay_ratio, target_update_interval, fresh updates)
CASES = {"vtrace_30": ("vtrace", 0, 100, 30),
         "impact_replay_10": ("impact", 1, 3, 10)}
LOSS_KEYS = ("total_loss", "policy_gradient_loss", "baseline_loss",
             "entropy_loss", "learning_rate", "env_frames")


def _batches(n):
    out = []
    for i in range(n):
        host = transport_case.example(num_actions=A, core=H, seed=100 + i)
        jax_traj = transport_case.as_jax(host)
        jax_traj = jax_traj._replace(agent_outputs=jax_traj.agent_outputs
                                     ._replace(action=host.agent_outputs
                                               .action.astype(np.int32)))
        out.append((host, jax_traj))
    return out


def _jax_run(loss, ratio, interval, updates, batches):
    agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                     conv_backend="pallas")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    learner = JaxLearner(agent, JaxHp(total_environment_frames=TOTAL), mesh,
                         FPU, device_telemetry=False, learn_telemetry=False,
                         loss=loss, target_update_interval=interval)
    state = learner.init(jax.random.key(0), batches[0][1])
    start = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    replay = JaxReplay(CAPACITY, seed=SEED) if ratio else None
    keys = LOSS_KEYS + (("impact_ratio_mean", "impact_clip_fraction")
                        if loss == "impact" else ())
    steps = []

    def record(metrics, sampled=None):
        params = convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, state.params))
        steps.append(({k: float(metrics[k]) for k in keys}, params,
                      sampled))

    for _, traj in batches[:updates]:
        if replay is not None:
            replay.insert(jax.tree_util.tree_map(jnp.asarray, traj))
        state, metrics = learner.update(state, traj)
        record(metrics)
        for _ in range(ratio):
            sampled = replay.sample()
            state, metrics = learner.update(state, sampled, fresh=False)
            record(metrics, np.asarray(sampled.env_outputs.reward))
    return start, steps


@pytest.fixture(scope="module")
def parity_runs():
    """Each case's live JAX run, computed once, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            loss, ratio, interval, updates = CASES[name]
            batches = _batches(updates)
            cache[name] = (batches, _jax_run(loss, ratio, interval, updates,
                                             batches))
        return cache[name]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_learner_matches_jax_update_by_update(parity_runs, case):
    loss, ratio, interval, updates = CASES[case]
    batches, (start, jax_steps) = parity_runs(case)
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    agent.load_state_dict(start)
    learner = Learner(agent, LearnerHyperparams(total_environment_frames=TOTAL),
                      FPU, learn_telemetry=False, loss=loss,
                      target_update_interval=interval)
    replay = _buffer(CAPACITY, seed=SEED) if ratio else None
    put = make_transport("per_leaf", "cpu").put
    steps = []

    def check(metrics, sampled):
        """This update against JAX's: losses, the sampled batch, and every
        parameter's change from the start."""
        i = len(steps)
        want, want_params, want_sampled = jax_steps[i]
        steps.append(metrics)
        if want_sampled is not None:
            np.testing.assert_array_equal(sampled, want_sampled)
        for key, value in want.items():
            np.testing.assert_allclose(float(metrics[key]), value,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{key} at update {i}")
        for name, begin in start.items():
            want_change = (want_params[name] - begin).numpy()
            got_change = (learner._params[name].detach() - begin).numpy()
            scale = float(np.abs(want_change).max())
            np.testing.assert_allclose(got_change, want_change, rtol=0,
                                       atol=1e-3 * scale,
                                       err_msg=f"{name} at update {i}")

    for host, _ in batches[:updates]:
        traj = put(host)[0]
        if replay is not None:
            replay.insert(traj)
        check(learner.update(traj), None)
        for _ in range(ratio):
            sampled = replay.sample()
            check(learner.update(sampled, fresh=False),
                  sampled.env_outputs.reward.numpy())
    assert len(steps) == len(jax_steps) == updates * (1 + ratio)
    assert float(steps[-1]["env_frames"]) == updates * FPU
    if loss == "impact":
        # The schedule fired at fresh updates 3, 6 and 9: the ratio left 1.
        ratios = [float(m["impact_ratio_mean"]) for m in steps]
        assert max(abs(r - 1.0) for r in ratios) > 1e-4
