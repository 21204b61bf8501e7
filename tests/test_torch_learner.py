"""The port's learner (scalable_agent_tpu_torch/runtime/learner.py) held
against a live JAX ``Learner`` on a one-device CPU mesh: the same weights
(through ``convert.py``) and the same numpy trajectories, three updates,
the losses of every update and the parameter change of the whole run,
for ``scan_impl="auto"`` (the associative recurrence on both sides) and
``scan_impl="pallas"`` (the fused V-trace kernel: interpret mode on the
JAX side, the kernel's plain version here).

The parameter CHANGE is compared, not the parameters: the change is
where the optimizer's semantics show (optax's ``nu`` starting at 1.0 and
eps inside the root; ``torch.optim.RMSprop`` would give a step many times
larger), while the parameters themselves differ from their start by only
~lr.

Tolerances: float32 losses summed over T*B cells in another order, rtol
1e-4; parameter changes rtol 1e-3 of each leaf's largest change (they
are differences of nearly equal numbers, which costs digits).
"""

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime import Trajectory as JaxTrajectory
from scalable_agent_tpu.types import AgentOutput as JaxAgentOutput
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import (
    Learner,
    LearnerHyperparams,
    Trajectory,
)
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

A, H, T, B = 5, 16, 4, 3
FRAMES_PER_UPDATE = T * B * 4
UPDATES = 3


def _trajectory(seed):
    """One random [T+1, B] batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return dict(
        c=f32(B, H, scale=0.5), h=np.tanh(f32(B, H)),
        reward=f32(T + 1, B, scale=2.0),
        done=rng.random((T + 1, B)) < 0.25,
        frame=rng.integers(0, 256, (T + 1, B, 16, 16, 3), dtype=np.uint8),
        action=rng.integers(0, A, (T + 1, B)),
        logits=f32(T + 1, B, A),
        baseline=f32(T + 1, B))


def _jax_traj(d):
    zeros = np.zeros((T + 1, B), np.float32)
    return JaxTrajectory(
        agent_state=JaxAgentState(c=d["c"], h=d["h"]),
        env_outputs=JaxStepOutput(
            reward=d["reward"],
            info=JaxStepOutputInfo(zeros, zeros.astype(np.int32)),
            done=d["done"],
            observation=JaxObservation(frame=d["frame"])),
        agent_outputs=JaxAgentOutput(
            action=d["action"].astype(np.int32),
            policy_logits=d["logits"], baseline=d["baseline"]))


def _torch_traj(d):
    zeros = torch.zeros((T + 1, B))
    t = {k: torch.tensor(v) for k, v in d.items()}
    return Trajectory(
        agent_state=AgentState(c=t["c"], h=t["h"]),
        env_outputs=StepOutput(
            reward=t["reward"], info=StepOutputInfo(zeros, zeros),
            done=t["done"], observation=Observation(frame=t["frame"])),
        agent_outputs=AgentOutput(action=t["action"],
                                  policy_logits=t["logits"],
                                  baseline=t["baseline"]))


def _runs(scan_impl):
    batches = [_trajectory(seed) for seed in range(UPDATES)]
    total_frames = 1e3  # short enough that the lr decay shows

    jax_agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                         conv_backend="pallas")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jax_learner = JaxLearner(
        jax_agent, JaxHp(total_environment_frames=total_frames), mesh,
        FRAMES_PER_UPDATE, device_telemetry=False, learn_telemetry=False,
        scan_impl=scan_impl)
    state = jax_learner.init(jax.random.key(0), _jax_traj(batches[0]))
    start = jax.tree_util.tree_map(np.asarray, state.params)
    jax_losses = []
    for d in batches:
        state, metrics = jax_learner.update(state, _jax_traj(d))
        jax_losses.append({k: float(metrics[k]) for k in (
            "total_loss", "policy_gradient_loss", "baseline_loss",
            "entropy_loss", "learning_rate", "env_frames",
            "update_skipped")})
    jax_end = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))

    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    agent.load_state_dict(convert.flax_to_state_dict(start))
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=total_frames), FRAMES_PER_UPDATE,
        scan_impl=scan_impl)
    torch_losses = [
        {k: float(v) for k, v in learner.update(_torch_traj(d)).items()}
        for d in batches]
    return (convert.flax_to_state_dict(start), jax_end, jax_losses,
            {k: v.detach().clone() for k, v in agent.state_dict().items()},
            torch_losses)


@pytest.fixture(scope="module")
def runs():
    return _runs("auto")


@pytest.fixture(scope="module")
def pallas_runs():
    return _runs("pallas")


def _check_losses(runs):
    _, _, jax_losses, _, torch_losses = runs
    for want, got in zip(jax_losses, torch_losses):
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def _check_parameter_changes(runs):
    start, jax_end, _, torch_end, _ = runs
    for name, begin in start.items():
        want = (jax_end[name] - begin).numpy()
        got = (torch_end[name] - begin).numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_losses_match_every_update(runs):
    _check_losses(runs)


@pytest.mark.parametrize("check", [_check_losses, _check_parameter_changes],
                         ids=["losses", "parameter_changes"])
def test_pallas_scan_impl_matches_jax(pallas_runs, check):
    check(pallas_runs)


def test_scan_impl_resolution():
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    resolve = lambda impl: Learner(agent, LearnerHyperparams(),
                                   FRAMES_PER_UPDATE, scan_impl=impl)
    assert resolve("auto").scan_impl == "associative"
    assert resolve("pallas").scan_impl == "pallas"
    with pytest.raises(ValueError, match="ROADMAP"):
        resolve("time_sharded")


def test_env_frames_and_lr_schedule(runs):
    _, _, _, _, torch_losses = runs
    assert [m["env_frames"] for m in torch_losses] == [
        FRAMES_PER_UPDATE * (i + 1) for i in range(UPDATES)]
    for i, m in enumerate(torch_losses):
        np.testing.assert_allclose(
            m["learning_rate"],
            0.00048 * (1 - i * FRAMES_PER_UPDATE / 1e3), rtol=1e-6)


def test_parameter_changes_match(runs):
    _check_parameter_changes(runs)


def test_state_dict_round_trip():
    """load_state_dict restores params, nu, frames and counters exactly
    into a differently-initialized learner."""
    make = lambda seed: Learner(
        ImpalaAgent(A, (16, 16, 3), core_size=H,
                    generator=torch.Generator().manual_seed(seed)),
        LearnerHyperparams(), FRAMES_PER_UPDATE)
    source, target = make(1), make(2)
    source.update(_torch_traj(_trajectory(4)))
    target.load_state_dict(source.state_dict())
    want, got = source.state_dict(), target.state_dict()
    for group in ("params", "opt_state"):
        for name, tensor in want[group].items():
            assert torch.equal(got[group][name], tensor), name
    assert got["env_frames"] == want["env_frames"] == FRAMES_PER_UPDATE
    assert float(got["nonfinite_skips"]) == float(want["nonfinite_skips"])


def test_nonfinite_update_is_a_counted_noop():
    """A NaN reward poisons the loss and every gradient: params and nu are
    held bitwise, frames still advance, the skip/streak counters count."""
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H,
                        generator=torch.Generator().manual_seed(1))
    learner = Learner(agent, LearnerHyperparams(), FRAMES_PER_UPDATE)
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    nu_before = {k: v.clone() for k, v in learner.state.opt_state.items()}
    d = _trajectory(9)
    d["reward"][2, 1] = np.nan
    for i in range(2):
        metrics = learner.update(_torch_traj(d))
        assert float(metrics["update_skipped"]) == 1.0
        assert float(metrics["nonfinite_streak"]) == i + 1
    assert float(metrics["nonfinite_skips"]) == 2.0
    assert float(metrics["env_frames"]) == 2 * FRAMES_PER_UPDATE
    for k, v in agent.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in learner.state.opt_state.items():
        assert torch.equal(v, nu_before[k]), k
    metrics = learner.update(_torch_traj(_trajectory(10)))
    assert float(metrics["update_skipped"]) == 0.0
    assert float(metrics["nonfinite_streak"]) == 0.0
    assert float(metrics["nonfinite_skips"]) == 2.0
