"""The port's CheckpointManager (runtime/checkpoint.py) on the CPU.

- A save and restore round-trips the learner's whole state bitwise, and
  the manifest carries the JAX package's fields.
- A torn newest step is walked back past (and deleted once an older step
  verifies); a missing manifest counts as torn.
- Keep-N rotation retains the newest N steps and their manifests.
- When steps exist but none verifies, restore raises.
- Params from a checkpoint, through ``convert.state_dict_to_flax``, make
  the JAX agent give the port agent's outputs (float32, rtol 1e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.models.agent import initial_state as jax_initial
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import (
    CheckpointIntegrityError,
    CheckpointManager,
    Learner,
    LearnerHyperparams,
)
from scalable_agent_tpu_torch.types import (
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

A, H = 5, 16


def _learner(seed=0):
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H,
                        generator=torch.Generator().manual_seed(seed))
    learner = Learner(agent, LearnerHyperparams(), 48)
    with torch.no_grad():
        for nu in learner.state.opt_state.values():
            nu.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(
                seed + 1))
    learner.state.env_frames = 12345.0
    learner.state.nonfinite_skips.fill_(3.0)
    return learner


def _assert_state_equal(got, want):
    for group in ("params", "opt_state"):
        assert list(got[group]) == list(want[group])
        for name, tensor in want[group].items():
            assert torch.equal(got[group][name].cpu(), tensor.cpu()), name
    assert float(got["env_frames"]) == float(want["env_frames"])
    for key in ("nonfinite_skips", "nonfinite_streak"):
        assert float(got[key]) == float(want[key])


def test_round_trip_is_exact(tmp_path):
    learner = _learner()
    ckpt = CheckpointManager(str(tmp_path), interval_s=1e9)
    assert ckpt.restore() is None
    assert ckpt.maybe_save(3, learner.state_dict())  # the first call saves
    assert not ckpt.maybe_save(4, learner.state_dict())  # not due yet
    step, saved = CheckpointManager(str(tmp_path)).restore()
    assert step == 3
    _assert_state_equal(saved, learner.state_dict())
    other = _learner(seed=9)
    other.load_state_dict(saved)
    _assert_state_equal(other.state_dict(), learner.state_dict())
    manifest = json.load(open(tmp_path / "checkpoints" / "manifests"
                              / "3.json"))
    assert set(manifest) == {"schema_version", "step", "topology",
                             "leaves"}
    assert manifest["step"] == 3
    n_params = len(list(learner.state_dict()["params"]))
    assert len(manifest["leaves"]) == 2 * n_params + 3
    assert set(manifest["leaves"][0]) == {"shape", "dtype", "crc32"}


@pytest.mark.filterwarnings("ignore:rmsprop_momentum")
def test_momentum_trace_round_trips_under_the_manifest(tmp_path):
    """At rmsprop_momentum != 0 the trace is one more group of leaves by
    parameter name, under the crc32 manifest, restored bit for bit; a
    checkpoint of either kind refuses the other kind of learner."""
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H,
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(rmsprop_momentum=0.9), 48)
    with torch.no_grad():
        for trace in learner.state.momentum.values():
            trace.normal_(generator=torch.Generator().manual_seed(2))
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0)
    assert ckpt.maybe_save(1, learner.state_dict())
    step, saved = CheckpointManager(str(tmp_path)).restore()
    n_params = len(saved["params"])
    manifest = json.load(open(tmp_path / "checkpoints" / "manifests"
                              / "1.json"))
    assert len(manifest["leaves"]) == 3 * n_params + 3
    other = Learner(ImpalaAgent(A, (16, 16, 3), core_size=H),
                    LearnerHyperparams(rmsprop_momentum=0.5), 48)
    other.load_state_dict(saved)
    for name, trace in learner.state.momentum.items():
        assert torch.equal(other.state.momentum[name], trace), name
    with pytest.raises(ValueError, match="holds a RMSProp momentum trace"):
        _learner().load_state_dict(saved)
    with pytest.raises(ValueError, match="holds no RMSProp momentum trace"):
        other.load_state_dict(_learner().state_dict())


def test_walk_back_past_a_torn_step(tmp_path):
    learner = _learner()
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0)
    for step in (1, 2, 3):
        learner.state.env_frames = 100.0 * step
        assert ckpt.maybe_save(step, learner.state_dict())
    path = tmp_path / "checkpoints" / "3.pt"
    data = bytearray(path.read_bytes())
    middle = len(data) // 2
    data[middle:middle + 64] = bytes(b ^ 0xFF for b in
                                     data[middle:middle + 64])
    path.write_bytes(bytes(data))
    os.remove(tmp_path / "checkpoints" / "manifests" / "2.json")
    fresh = CheckpointManager(str(tmp_path))
    step, saved = fresh.restore()
    assert step == 1 and saved["env_frames"] == 100.0
    assert fresh.restore_fallbacks == 2
    # The bad newer steps are gone, so later saves are not shadowed.
    assert fresh.all_steps() == [1]


def test_keep_n_rotation(tmp_path):
    learner = _learner()
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0, keep=2)
    for step in range(1, 6):
        ckpt.maybe_save(step, learner.state_dict())
    assert ckpt.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "checkpoints" / "manifests")) == [
        "4.json", "5.json"]


def test_nothing_verifies_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), interval_s=0.0)
    ckpt.maybe_save(1, _learner().state_dict())
    (tmp_path / "checkpoints" / "1.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(CheckpointIntegrityError, match="none restored"):
        CheckpointManager(str(tmp_path)).restore()
    assert (tmp_path / "checkpoints" / "1.pt").exists()


def test_checkpoint_params_drive_the_jax_agent(tmp_path):
    learner = _learner(seed=4)
    CheckpointManager(str(tmp_path)).maybe_save(
        1, learner.state_dict(), force=True)
    _, saved = CheckpointManager(str(tmp_path)).restore()
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    agent.load_state_dict(saved["params"])
    jax_agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                         conv_backend="pallas")
    params = convert.state_dict_to_flax(saved["params"])

    rng = np.random.default_rng(8)
    T, B = 4, 3
    frame = rng.integers(0, 256, (T, B, 16, 16, 3), dtype=np.uint8)
    reward = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.3
    actions = rng.integers(0, A, (T, B))
    zeros = np.zeros((T, B), np.float32)
    (logits, baseline), state = agent(
        torch.tensor(actions),
        StepOutput(torch.tensor(reward),
                   StepOutputInfo(torch.tensor(zeros), torch.tensor(zeros)),
                   torch.tensor(done), Observation(torch.tensor(frame))),
        AgentState(torch.zeros(B, H), torch.zeros(B, H)))
    (jax_logits, jax_baseline), jax_state = jax_agent.apply(
        params, jnp.asarray(actions, jnp.int32),
        JaxStepOutput(reward, JaxStepOutputInfo(zeros, zeros), done,
                      JaxObservation(frame=frame)),
        jax_initial(B, H))
    for got, want in ((logits, jax_logits), (baseline, jax_baseline),
                      (state.c, jax_state.c), (state.h, jax_state.h)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(jax.device_get(want)),
                                   rtol=1e-5, atol=1e-5)
