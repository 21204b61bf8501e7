"""The port's trajectory transport and in-flight window
(scalable_agent_tpu_torch/runtime/transport.py) held against the JAX
package's (scalable_agent_tpu/runtime/transport.py), on the CPU.

- ``PackedSpec`` lays a trajectory out exactly as the JAX one does: the
  same dtype order, offsets and ``shard_nbytes`` for the same numpy
  example.
- ``packed`` gives every leaf bit for bit as ``per_leaf`` does (the twin
  of ``tests/test_transport.py::TestPackedRoundTrip``), as views of the
  one uploaded buffer.
- ``InflightWindow`` (the twin of ``TestInflightWindow``).
- 10 updates of the port's learner through either transport give the
  same losses bit for bit, and those agree with the live JAX ``Learner``
  on the same weights and batches within the learner tests' tolerance
  (float32 losses, rtol 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime.learner import _TRAJ_BATCH_AXES
from scalable_agent_tpu.runtime.learner import Trajectory as JaxTrajectory
from scalable_agent_tpu.runtime.transport import PackedSpec as JaxPackedSpec
from scalable_agent_tpu.types import AgentOutput as JaxAgentOutput
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
from scalable_agent_tpu_torch.runtime.learner import Trajectory
from scalable_agent_tpu_torch.runtime.transport import (
    TRAJ_BATCH_AXES,
    InflightWindow,
    PackedSpec,
    PackedTransport,
    PerLeafTransport,
    make_transport,
    tree_leaves,
)
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

T, B = 5, 4
CPU = torch.device("cpu")


def example(t=T, b=B, h=16, w=16, num_actions=3, core=13,
            with_instruction=False, seed=0, action_dtype=np.int64):
    """A host trajectory with every dtype the pool emits (action int64,
    episode_step int32, done bool, frame uint8, the rest float32) and odd
    leaf sizes, so alignment padding falls between leaves; the port's
    namedtuples."""
    rng = np.random.default_rng(seed)
    t1 = t + 1
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    instruction = (rng.integers(0, 1000, (t1, b, 11)).astype(np.int32)
                   if with_instruction else None)
    return Trajectory(
        agent_state=AgentState(c=f32(b, core), h=f32(b, core)),
        env_outputs=StepOutput(
            reward=f32(t1, b),
            info=StepOutputInfo(
                episode_return=f32(t1, b),
                episode_step=rng.integers(0, 99, (t1, b)).astype(np.int32)),
            done=rng.random((t1, b)) < 0.3,
            observation=Observation(
                frame=rng.integers(0, 256, (t1, b, h, w, 3), dtype=np.uint8),
                instruction=instruction)),
        agent_outputs=AgentOutput(
            action=rng.integers(0, num_actions, (t1, b)).astype(action_dtype),
            policy_logits=f32(t1, b, num_actions),
            baseline=f32(t1, b)))


def as_jax(traj):
    """The same arrays in the JAX package's namedtuples."""
    s, e, a = traj
    return JaxTrajectory(
        agent_state=JaxAgentState(c=s.c, h=s.h),
        env_outputs=JaxStepOutput(
            reward=e.reward,
            info=JaxStepOutputInfo(e.info.episode_return,
                                   e.info.episode_step),
            done=e.done,
            observation=JaxObservation(frame=e.observation.frame,
                                       instruction=e.observation.instruction)),
        agent_outputs=JaxAgentOutput(
            action=a.action, policy_logits=a.policy_logits,
            baseline=a.baseline))


def assert_bitwise(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype
        assert x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards,with_instruction",
                         [(1, False), (1, True), (2, False)])
def test_packed_spec_is_the_jax_layout(num_shards, with_instruction):
    traj = example(with_instruction=with_instruction)
    ours = PackedSpec(traj, TRAJ_BATCH_AXES, num_shards=num_shards)
    theirs = JaxPackedSpec(as_jax(traj), _TRAJ_BATCH_AXES,
                           num_shards=num_shards)
    assert ours.shard_nbytes == theirs.shard_nbytes
    key = lambda s: None if s is None else (
        s.offset, s.nbytes, tuple(s.chunk_shape), np.dtype(s.dtype))
    assert [key(s) for s in ours.specs] == [key(s) for s in theirs.specs]
    order = lambda spec: [np.dtype(s.dtype).str for s in sorted(
        (s for s in spec.specs if s is not None), key=lambda s: s.offset)]
    assert order(ours) == order(theirs)
    assert all(s.offset % 128 == 0 for s in ours.specs if s is not None)
    # Odd leaf sizes force real padding between segments.
    assert any(s.nbytes % 128 for s in ours.specs if s is not None)


def test_indivisible_batch_raises():
    with pytest.raises(ValueError, match="not divisible"):
        PackedSpec(example(b=3), TRAJ_BATCH_AXES, num_shards=2)


def test_make_transport_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("bogus", CPU)
    assert isinstance(make_transport("packed", CPU), PackedTransport)
    assert isinstance(make_transport("per_leaf", CPU), PerLeafTransport)


# ---------------------------------------------------------------------------
# Packed against per_leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_instruction", [False, True])
def test_packed_equals_per_leaf_bitwise(with_instruction):
    traj = example(with_instruction=with_instruction)
    packed, owners = PackedTransport(CPU).put(traj)
    per_leaf, leaves = PerLeafTransport(CPU).put(traj)
    assert_bitwise(packed, per_leaf)
    # Every dtype comes back as itself, bool done included.
    assert packed.env_outputs.done.dtype == torch.bool
    assert packed.env_outputs.observation.frame.dtype == torch.uint8
    assert packed.env_outputs.info.episode_step.dtype == torch.int32
    assert packed.agent_outputs.action.dtype == torch.int64
    # The leaves are views of the one uploaded buffer, its only owner.
    (buf,) = owners
    base = buf.untyped_storage().data_ptr()
    for leaf in tree_leaves(packed):
        if leaf is not None:
            assert leaf.untyped_storage().data_ptr() == base
    assert len(leaves) == len([x for x in tree_leaves(traj)
                               if x is not None])


def test_sharded_layout_round_trips():
    """Two shards: each batch chunk goes to its row, and unpack merges
    them back."""
    traj = example()
    spec = PackedSpec(traj, TRAJ_BATCH_AXES, num_shards=2)
    buf = np.zeros((2, spec.shard_nbytes), np.uint8)
    spec.pack_into(buf, traj)
    assert_bitwise(spec.unpack(torch.from_numpy(buf)),
                   PerLeafTransport(CPU).put(traj)[0])


def test_staging_buffers_alternate_and_earlier_batches_survive():
    """Two staging buffers in turn, each upload into a fresh buffer: the
    third put reuses the first staging buffer without touching the first
    batch on the device."""
    transport = PackedTransport(CPU)
    first, _ = transport.put(example(seed=1))
    second, _ = transport.put(example(seed=2))
    third, _ = transport.put(example(seed=3))
    assert transport._staging[0] is not transport._staging[1]
    assert_bitwise(first, PerLeafTransport(CPU).put(example(seed=1))[0])
    assert_bitwise(second, PerLeafTransport(CPU).put(example(seed=2))[0])
    assert_bitwise(third, PerLeafTransport(CPU).put(example(seed=3))[0])


def test_layout_drift_raises():
    transport = PackedTransport(CPU)
    transport.put(example())
    with pytest.raises(ValueError, match="shape"):
        transport.put(example(b=2))
    with pytest.raises(ValueError, match="dtype"):
        transport.put(example(action_dtype=np.int32))


# ---------------------------------------------------------------------------
# The in-flight window
# ---------------------------------------------------------------------------


def _metrics(k, frames_per_update=8):
    return {"total_loss": torch.tensor(float(k)),
            "env_frames": torch.tensor(float((k + 1) * frames_per_update))}


def test_window_rejects_zero():
    with pytest.raises(ValueError, match=">= 1"):
        InflightWindow(0)


def test_lockstep_window_retires_immediately():
    window = InflightWindow(1)
    window.push(_metrics(0))
    assert window.full
    assert float(window.retire()["total_loss"]) == 0.0
    assert window.depth == 0


def test_window_is_fifo_with_exact_env_frames():
    fpu = 8
    window = InflightWindow(3)
    retired = []
    for k in range(7):
        window.push(_metrics(k, fpu))
        if window.full:
            retired.append(window.retire())
    assert window.depth == 2
    retired.append(window.drain())
    assert window.depth == 0
    losses = [float(m["total_loss"]) for m in retired]
    assert losses == [0.0, 1.0, 2.0, 3.0, 4.0, 6.0]
    for m in retired:
        assert float(m["env_frames"]) == (float(m["total_loss"]) + 1) * fpu


def test_drain_of_an_empty_window_is_none():
    assert InflightWindow(2).drain() is None


def test_discard_drops_pending_without_retiring():
    window = InflightWindow(4)
    for k in range(3):
        window.push(_metrics(k))
    assert window.discard() == 3
    assert window.depth == 0 and not window.full
    assert window.drain() is None


# ---------------------------------------------------------------------------
# The learner through either transport, against the JAX learner
# ---------------------------------------------------------------------------

A, H, UPDATES = 3, 16, 10


@pytest.fixture(scope="module")
def learner_runs():
    batches = [example(num_actions=A, core=H, seed=10 + i)
               for i in range(UPDATES)]
    total_frames = 1e3
    fpu = T * B * 4
    jax_agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                         conv_backend="pallas")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jax_learner = JaxLearner(
        jax_agent, JaxHp(total_environment_frames=total_frames), mesh, fpu,
        device_telemetry=False, learn_telemetry=False, scan_impl="pallas")
    jax_batches = [as_jax(b)._replace(agent_outputs=as_jax(b).agent_outputs
                                      ._replace(action=b.agent_outputs.action
                                                .astype(np.int32)))
                   for b in batches]
    state = jax_learner.init(jax.random.key(0), jax_batches[0])
    start = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    losses = {"jax": []}
    for traj in jax_batches:
        state, metrics = jax_learner.update(state, traj)
        losses["jax"].append(float(metrics["total_loss"]))
    for name in ("per_leaf", "packed"):
        agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
        agent.load_state_dict(start)
        learner = Learner(agent, LearnerHyperparams(
            total_environment_frames=total_frames), fpu, scan_impl="pallas")
        transport = make_transport(name, CPU)
        losses[name] = [float(learner.update(transport.put(b)[0])
                              ["total_loss"]) for b in batches]
    return losses


def test_packed_learner_losses_equal_per_leaf_bitwise(learner_runs):
    assert learner_runs["packed"] == learner_runs["per_leaf"]


def test_learner_through_the_transport_matches_jax(learner_runs):
    np.testing.assert_allclose(learner_runs["packed"], learner_runs["jax"],
                               rtol=1e-4, atol=1e-6)
