"""The port's env copies, actor and driver on the CPU.

- The fake env family is a copy, not an import: the same actions give the
  same StepOutputs as the JAX package's streams, exactly.
- The actor packs [T+1, B] trajectories with the T+1 overlap, and the
  learner's unroll over one reproduces the actor's behaviour outputs.
- ``driver.train`` runs end to end with exact env-frame accounting.
"""

import functools

import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import VectorActor

T, B, A = 4, 3, 9
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")


@pytest.mark.parametrize("level,repeats", [("fake_small", 4),
                                           ("fake_bandit", 1),
                                           ("fake_memory", 2)])
def test_fake_streams_are_exact_copies(level, repeats):
    ours = make_impala_stream(level, seed=7, num_action_repeats=repeats)
    ref = jax_stream(level, seed=7, num_action_repeats=repeats)
    rng = np.random.default_rng(0)
    outputs = [(ours.initial(), ref.initial())]
    n = ours.action_space.n
    for action in rng.integers(0, n, 40):
        outputs.append((ours.step(action), ref.step(action)))
    for got, want in outputs:
        assert float(got.reward) == float(want.reward)
        assert bool(got.done) == bool(want.done)
        assert got.info == want.info
        np.testing.assert_array_equal(got.observation.frame,
                                      want.observation.frame)


def _actor(seed=0):
    fns = [functools.partial(make_impala_stream, "fake_small", seed=i)
           for i in range(B)]
    agent = ImpalaAgent(A, (16, 16, 3), core_size=32,
                        generator=torch.Generator().manual_seed(seed))
    return agent, VectorActor(agent, MultiEnv(fns, FRAME), T, seed=seed)


def test_unrolls_chain_with_the_t_plus_1_overlap():
    _, actor = _actor()
    first, second = actor.run_unroll(), actor.run_unroll()
    assert first.env_outputs.observation.frame.shape == (T + 1, B, 16, 16, 3)
    assert first.agent_outputs.policy_logits.shape == (T + 1, B, A)
    np.testing.assert_array_equal(first.env_outputs.observation.frame[-1],
                                  second.env_outputs.observation.frame[0])
    np.testing.assert_array_equal(first.agent_outputs.action[-1],
                                  second.agent_outputs.action[0])
    # The first-ever entry is the bootstrap: initial() marks every env
    # done.
    assert first.env_outputs.done[0].all()


def test_learner_unroll_reproduces_behaviour_outputs():
    """With the same weights, the learner's unroll over a trajectory gives
    the actor's behaviour logits/baselines one step later (the T+1
    layout and the carried state line up).  Both run the same float32
    ops, T=1 steps vs one T+1 unroll: 1e-5."""
    agent, actor = _actor(1)
    for _ in range(2):
        out = actor.run_unroll()
        traj = driver.to_trajectory(out, torch.device("cpu"))
        with torch.no_grad():
            (logits, baseline), _ = agent(traj.agent_outputs.action,
                                          traj.env_outputs,
                                          traj.agent_state)
        np.testing.assert_allclose(logits[:-1].numpy(),
                                   out.agent_outputs.policy_logits[1:],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(baseline[:-1].numpy(),
                                   out.agent_outputs.baseline[1:],
                                   rtol=1e-5, atol=1e-5)


def test_train_end_to_end_on_cpu():
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=4, batch_size=2, unroll_length=3,
                    num_action_repeats=4, log_interval_s=0.0,
                    total_environment_frames=2 * 2 * 3 * 4)
    metrics = driver.train(config)
    assert metrics["env_frames"] == 2 * config.frames_per_update()
    for key in ("total_loss", "policy_gradient_loss", "baseline_loss",
                "entropy_loss", "grad_norm", "learning_rate"):
        assert np.isfinite(metrics[key]), key
    assert metrics["nonfinite_skips"] == 0.0


def test_main_parses_the_jax_flag_names():
    metrics = driver.main([
        "--mode=train", "--device=cpu", "--level_name=fake_small",
        "--height=16", "--width=16", "--num_actors=2", "--batch_size=2",
        "--unroll_length=2", "--total_environment_frames=8"])
    assert metrics["env_frames"] == 16.0
