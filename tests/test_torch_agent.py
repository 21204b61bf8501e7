"""The port's agent (scalable_agent_tpu_torch/models) held against the JAX
package's ``ImpalaAgent`` with ``core_impl="pallas"`` and
``conv_backend="pallas"`` (the TPU main path's kernels, in interpret mode
here), through ``convert.py``: logits, baseline, new state and every
parameter gradient, on the same numpy inputs and weights.

Tolerances: float32 on both sides through three convs, a Dense and a
done-reset LSTM; sums run in other orders over at most a few thousand
terms, hence rtol 1e-4 / atol 1e-5 on outputs and gradients (~1e3 f32
epsilon).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.types import (
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

A = 5
H = 16
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, T, B, frame_hw):
    rng = np.random.default_rng(seed)
    return dict(
        actions=rng.integers(0, A, (T, B)),
        reward=(rng.standard_normal((T, B)) * 2).astype(np.float32),
        done=rng.random((T, B)) < 0.3,
        frame=rng.integers(0, 256, (T, B) + frame_hw + (3,), dtype=np.uint8),
        c=(rng.standard_normal((B, H)) * 0.5).astype(np.float32),
        h=np.tanh(rng.standard_normal((B, H))).astype(np.float32))


def _jax_args(d):
    zeros = np.zeros(d["reward"].shape, np.float32)
    env = JaxStepOutput(
        reward=jnp.asarray(d["reward"]),
        info=JaxStepOutputInfo(zeros, zeros.astype(np.int32)),
        done=jnp.asarray(d["done"]),
        observation=JaxObservation(frame=jnp.asarray(d["frame"])))
    return (jnp.asarray(d["actions"], jnp.int32), env,
            JaxAgentState(c=jnp.asarray(d["c"]), h=jnp.asarray(d["h"])))


def _torch_args(d):
    zeros = torch.zeros(d["reward"].shape)
    env = StepOutput(
        reward=torch.tensor(d["reward"]),
        info=StepOutputInfo(zeros, zeros),
        done=torch.tensor(d["done"]),
        observation=Observation(frame=torch.tensor(d["frame"])))
    return (torch.tensor(d["actions"]), env,
            AgentState(c=torch.tensor(d["c"]), h=torch.tensor(d["h"])))


def _pair(frame_hw, seed=0):
    jax_agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                         conv_backend="pallas")
    d = _inputs(seed, 2, 1, frame_hw)
    params = jax_agent.init(jax.random.key(seed), *_jax_args(d))
    agent = ImpalaAgent(A, frame_hw + (3,), core_size=H)
    agent.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jax_agent, params, agent


@pytest.mark.parametrize("frame_hw,T,B", [((16, 16), 5, 4),
                                          ((72, 96), 1, 2)])
def test_forward_and_all_grads_match_jax(frame_hw, T, B):
    """(16, 16) at T=5, B=4; and the real 72x96 frame at N=2, where
    conv_2's SAME padding on the 9x12 map is asymmetric (0, 1)."""
    jax_agent, params, agent = _pair(frame_hw)
    d = _inputs(1, T, B, frame_hw)
    jargs = _jax_args(d)

    def loss_j(p):
        (logits, baseline), state = jax_agent.apply(p, *jargs)
        loss = (jnp.sum(logits ** 2) + jnp.sum(baseline)
                + jnp.sum(state.c) + jnp.sum(state.h ** 2))
        return loss, (logits, baseline, state)

    (_, (logits_j, baseline_j, state_j)), grads_j = jax.value_and_grad(
        loss_j, has_aux=True)(params)
    (logits, baseline), state = agent(*_torch_args(d))
    loss = (logits.square().sum() + baseline.sum() + state.c.sum()
            + state.h.square().sum())
    names = [name for name, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       agent.named_parameters()])
    for got, want in ((logits, logits_j), (baseline, baseline_j),
                      (state.c, state_j.c), (state.h, state_j.h)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    want_grads = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(want_grads) == sorted(names)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)


def test_convert_round_trip_is_exact():
    _, params, agent = _pair((16, 16), seed=3)
    host = jax.tree_util.tree_map(np.asarray, params)
    back = convert.state_dict_to_flax(agent.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(host)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    again = convert.flax_to_state_dict(back)
    for name, value in agent.state_dict().items():
        assert torch.equal(again[name], value), name


def test_initializers_follow_flax():
    """lecun_normal (variance 1/fan_in, truncated at 2 std) for convs,
    dense layers and input gates; orthogonal recurrent gates; zero
    biases.  Drawn from the explicit generator: same seed, same weights."""
    make = lambda: ImpalaAgent(
        9, (72, 96, 3), generator=torch.Generator().manual_seed(5))
    agent, twin = make().requires_grad_(False), make()
    for (name, p), (_, q) in zip(agent.named_parameters(),
                                 twin.named_parameters()):
        assert torch.equal(p, q), name
    conv = agent.convnet.conv_1.weight
    fan_in = conv.shape[1] * conv.shape[2] * conv.shape[3]
    assert abs(float(conv.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert float(conv.abs().max()) <= 2.0 * (fan_in ** -0.5) / 0.8796 + 1e-6
    wi = agent.core.wi
    assert abs(float(wi.std()) * wi.shape[0] ** 0.5 - 1.0) < 0.05
    hidden = agent.core.wh.shape[0]
    for gate in range(4):
        block = agent.core.wh[:, gate * hidden:(gate + 1) * hidden]
        np.testing.assert_allclose((block.T @ block).detach().numpy(),
                                   np.eye(hidden), atol=1e-4)
    for name, p in agent.named_parameters():
        if name.endswith(("bias", ".b")):
            assert not p.any(), name
