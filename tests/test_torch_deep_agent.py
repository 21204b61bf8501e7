"""The deep IMPALA agent of the port -- ``ResNetTorso``, the instruction
encoder and ``--torso_type=resnet --use_instruction=true`` end to end --
held against the JAX package on the same numpy inputs and weights.

- ``ResNetTorso`` against the JAX ``ResNetTorso`` (its stem through the
  Pallas grad-W in interpret mode, and through XLA's), forward and every
  parameter gradient, at float32 (rtol/atol 1e-5: sums in other orders)
  and at bf16 (2e-2, ``test_torch_bf16.py``'s band).
- The SAME max-pool against ``flax.linen.max_pool``, exactly, at even and
  odd sizes.
- ``InstructionEncoder`` against the JAX encoder at full, partial and
  all-padding rows: output and gradients within 1e-5; ``hash_instruction``
  equal to the JAX one.
- The whole deep agent against the JAX ``ImpalaAgent`` (``core_impl`` and
  ``conv_backend`` ``pallas``) through ``convert.py``, f32 and bf16, a
  bitwise ``convert`` round trip of the deep tree and a strict load.
- ``FakeEnv(with_instruction=True)`` against the JAX fake; ``MultiEnv``
  carrying the instruction in process and from two workers; the ActorPool
  storing it [T+1, B, 16] int32 and both transports carrying it bitwise.
- ``update_flops`` against ``FlopCounterMode`` on the deep update, and the
  kernel table's costs summing to it at the deep path's shapes.
- A 2-update ``driver.train`` on the CPU and ``--mode=test``, which adopts
  ``use_instruction`` and ``torso_type`` from ``config.json``.
"""

import dataclasses
import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu.envs.fake import FakeEnv as JaxFakeEnv
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.models.instruction import (
    InstructionEncoder as JaxInstructionEncoder,
)
from scalable_agent_tpu.models.networks import PallasStemConv
from scalable_agent_tpu.models.networks import ResNetTorso as JaxResNetTorso
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu.utils.text import hash_instruction as jax_hash
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    FakeEnv,
    MultiEnv,
    TensorSpec,
    make_impala_stream,
)
from scalable_agent_tpu_torch.models import (
    ImpalaAgent,
    InstructionEncoder,
    ResNetTorso,
)
from scalable_agent_tpu_torch.models.networks import (
    conv_shapes,
    max_pool_same,
)
from scalable_agent_tpu_torch.obs import kernels
from scalable_agent_tpu_torch.runtime import (
    ActorPool,
    Learner,
    LearnerHyperparams,
)
from scalable_agent_tpu_torch.runtime.learner import (
    Trajectory,
    update_flops,
)
from scalable_agent_tpu_torch.runtime.transport import (
    PackedTransport,
    PerLeafTransport,
    host_trajectory,
    tree_leaves,
)
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)
from scalable_agent_tpu_torch.utils.text import hash_instruction

A = 5
H = 32
L = 16
TOL = dict(rtol=1e-5, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _instructions(rng, shape):
    """Token ids [..., L]: full rows, partial rows and all-padding rows."""
    ids = rng.integers(1, 1001, shape + (L,))
    lengths = rng.choice([0, 1, 5, L], shape)
    return np.where(np.arange(L) < lengths[..., None], ids, 0).astype(
        np.int32)


# -- the torso ----------------------------------------------------------------


def _jax_grads_as_torch(grads, prefix):
    """A JAX gradient tree under ``prefix`` as the port's names."""
    tree = {prefix: jax.tree_util.tree_map(np.asarray, grads)}
    return {name[len(prefix) + 1:]: value for name, value in
            convert.flax_to_state_dict(tree).items()}


def _bias_sums(module, params, args, loss_of_output, prefix=""):
    """The float64 sum over its pixels of the JAX model's cotangent at
    every conv's output (bias included), as the port's bias names: each
    conv's output goes through a flax perturbation, whose gradient is that
    cotangent.  At bf16 the bias gradients are held to these: the JAX
    package's own is the same sum taken by XLA's CPU reduction, up to 4.5
    bf16 ulps (2.3% of the largest entry) off it at 3 frames of 16x16,
    where the port's float32-accumulated sum is within one."""
    convs = (flax_nn.Conv, PallasStemConv)

    def interceptor(next_fun, call_args, kwargs, context):
        out = next_fun(*call_args, **kwargs)
        if isinstance(context.module, convs) and (
                context.method_name == "__call__"):
            out = context.module.perturb("out", out)
        return out

    with flax_nn.intercept_methods(interceptor):
        perturbations = module.init(jax.random.key(0), *args)[
            "perturbations"]

        def loss(perturbed):
            return loss_of_output(module.apply(
                {"params": params["params"], "perturbations": perturbed},
                *args))

        grads = jax.jit(jax.grad(loss))(perturbations)
    return {prefix + ".".join(str(k.key) for k in path[:-1]) + ".bias":
            torch.tensor(np.asarray(g, np.float64).sum((0, 1, 2)),
                         dtype=torch.float32)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}


def _assert_grads(names, grads, want, tol, bias_tol=None):
    """Each gradient within ``tol`` of its scale (max |want|, at least 1),
    a conv's bias within ``bias_tol`` where given."""
    assert sorted(want) == sorted(names)
    for name, got in zip(names, grads):
        scale = max(1.0, float(want[name].abs().max()))
        conv_bias = name.startswith("convnet.") and name.endswith(".bias")
        np.testing.assert_allclose(
            got.float().numpy() / scale, want[name].numpy() / scale,
            err_msg=name, **(bias_tol if conv_bias and bias_tol else tol))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frame_hw,conv_backend", [
    ((16, 16), "xla"), ((17, 23), "xla"), ((17, 23), "pallas")])
def test_resnet_torso_matches_jax(frame_hw, conv_backend, dtype):
    """Output and every parameter gradient (at bf16 the conv biases'
    against ``_bias_sums``); the Pallas stem (interpret mode) at the odd
    frame, where every pool's SAME pads are (1, 1)."""
    rng = np.random.default_rng(sum(frame_hw))
    frames = rng.integers(0, 256, (3,) + frame_hw + (3,), dtype=np.uint8)
    cotangent = rng.standard_normal((3, 256)).astype(np.float32)
    jax_torso = JaxResNetTorso(dtype=JNP[dtype], conv_backend=conv_backend)
    params = jax_torso.init(jax.random.key(1), jnp.asarray(frames))

    def loss_j(p):
        out = jax_torso.apply(p, jnp.asarray(frames))
        return jnp.sum(jnp.asarray(out, jnp.float32) * cotangent), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    torso = ResNetTorso(frame_hw + (3,), dtype=TORCH[dtype])
    torso.load_state_dict(_jax_grads_as_torch(params["params"], "convnet"))
    out = torso(torch.tensor(frames))
    assert out.dtype == TORCH[dtype] and out.shape == (3, 256)
    grads = torch.autograd.grad((out.float() * torch.tensor(cotangent)).sum(),
                                list(torso.parameters()))
    bf16 = dtype == "bfloat16"
    tol = BAND if bf16 else TOL
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j, np.float32), **tol)
    want = {"convnet." + name: value for name, value in
            _jax_grads_as_torch(grads_j["params"], "convnet").items()}
    if bf16:
        sums = _bias_sums(
            jax_torso, params, (jnp.asarray(frames),),
            lambda out: jnp.sum(jnp.asarray(out, jnp.float32) * cotangent),
            "convnet.")
        assert len(sums) == 15
        want.update(sums)
    # The torso's cotangents are the JAX torso's: one bf16 rounding of
    # the sum apart.
    _assert_grads(["convnet." + name for name, _ in torso.named_parameters()],
                  grads, want, tol, dict(rtol=0, atol=2 ** -7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(16, 16), (17, 23), (9, 12), (72, 96),
                                (1, 2)])
def test_max_pool_same_is_flax_max_pool_exactly(hw, dtype):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    x = rng.standard_normal((2,) + hw + (4,)).astype(np.float32)
    want = flax_nn.max_pool(jnp.asarray(x, JNP[dtype]), (3, 3),
                            strides=(2, 2), padding="SAME")
    got = max_pool_same(torch.tensor(x).to(TORCH[dtype]).permute(0, 3, 1, 2))
    assert got.dtype == TORCH[dtype]
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want, np.float32))


def test_max_pool_same_pads_low_side_by_the_smaller_half():
    """At an even size flax pads (0, 1): the window of output 0 is input
    rows 0..2, not -1..1 as max_pool2d(padding=1) would take."""
    x = torch.zeros(1, 1, 4, 4)
    x[0, 0, 2, 2] = 5.0  # inside output (0, 0)'s window only when unshifted
    assert max_pool_same(x)[0, 0, 0, 0] == 5.0
    shifted = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
    assert shifted.shape == max_pool_same(x).shape
    assert shifted[0, 0, 0, 0] == 0.0


# -- the instruction encoder ------------------------------------------------


def test_hash_instruction_equals_the_jax_hash():
    for text in ("go to the red door", "", "  pick   up\tthe key ",
                 " ".join(f"w{i}" for i in range(20)), "ünïcödé words"):
        np.testing.assert_array_equal(hash_instruction(text),
                                      jax_hash(text))
        np.testing.assert_array_equal(hash_instruction(text, 4, 7),
                                      jax_hash(text, 4, 7))


def test_instruction_encoder_matches_jax():
    rng = np.random.default_rng(7)
    ids = _instructions(rng, (12,))
    ids[0], ids[1] = 0, rng.integers(1, 1001, L)  # all pad, full
    cotangent = rng.standard_normal((12, 64)).astype(np.float32)
    jax_encoder = JaxInstructionEncoder()
    params = jax_encoder.init(jax.random.key(2), jnp.asarray(ids))

    def loss_j(p):
        out = jax_encoder.apply(p, jnp.asarray(ids))
        return jnp.sum(out * cotangent), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    encoder = InstructionEncoder()
    encoder.load_state_dict(_jax_grads_as_torch(params["params"],
                                                "instruction"),
                            strict=True)
    out = encoder(torch.tensor(ids))
    assert out.dtype == torch.float32 and out.shape == (12, 64)
    assert not out[0].any()  # a row of padding only gives zeros
    grads = torch.autograd.grad((out * torch.tensor(cotangent)).sum(),
                                list(encoder.parameters()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    want = _jax_grads_as_torch(grads_j["params"], "instruction")
    names = [name for name, _ in encoder.named_parameters()]
    assert sorted(want) == sorted(names)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_instruction_encoder_initializers_follow_flax():
    encoder = InstructionEncoder(generator=torch.Generator().manual_seed(3))
    embed = encoder.embed.weight
    assert embed.shape == (1001, 20)
    assert abs(float(embed.detach().std()) * 20 ** 0.5 - 1.0) < 0.05
    assert abs(float(encoder.wi.detach().std()) * 20 ** 0.5 - 1.0) < 0.1
    block = encoder.wh.detach()[:, :64]
    np.testing.assert_allclose((block.T @ block).detach().numpy(),
                               np.eye(64), atol=1e-4)
    assert not encoder.b.any()


# -- the whole agent ----------------------------------------------------------


def _agent_inputs(seed, T, B, frame_hw):
    rng = np.random.default_rng(seed)
    return dict(
        actions=rng.integers(0, A, (T, B)),
        reward=(rng.standard_normal((T, B)) * 2).astype(np.float32),
        done=rng.random((T, B)) < 0.3,
        frame=rng.integers(0, 256, (T, B) + frame_hw + (3,), dtype=np.uint8),
        instruction=_instructions(rng, (T, B)),
        c=(rng.standard_normal((B, H)) * 0.5).astype(np.float32),
        h=np.tanh(rng.standard_normal((B, H))).astype(np.float32))


def _jax_args(d):
    zeros = np.zeros(d["reward"].shape, np.float32)
    env = JaxStepOutput(
        reward=jnp.asarray(d["reward"]),
        info=JaxStepOutputInfo(zeros, zeros.astype(np.int32)),
        done=jnp.asarray(d["done"]),
        observation=JaxObservation(frame=jnp.asarray(d["frame"]),
                                   instruction=jnp.asarray(d["instruction"])))
    return (jnp.asarray(d["actions"], jnp.int32), env,
            JaxAgentState(c=jnp.asarray(d["c"]), h=jnp.asarray(d["h"])))


def _torch_args(d):
    zeros = torch.zeros(d["reward"].shape)
    env = StepOutput(
        reward=torch.tensor(d["reward"]),
        info=StepOutputInfo(zeros, zeros),
        done=torch.tensor(d["done"]),
        observation=Observation(frame=torch.tensor(d["frame"]),
                                instruction=torch.tensor(d["instruction"])))
    return (torch.tensor(d["actions"]), env,
            AgentState(c=torch.tensor(d["c"]), h=torch.tensor(d["h"])))


def _jax_agent(dtype):
    return JaxAgent(num_actions=A, core_size=H, torso_type="resnet",
                    use_instruction=True, core_impl="pallas",
                    conv_backend="pallas", compute_dtype=JNP[dtype],
                    core_matmul_dtype=dtype)


def _deep_agent(frame_hw, dtype="float32", seed=0):
    params = _jax_agent(dtype).init(
        jax.random.key(seed), *_jax_args(_agent_inputs(seed, 2, 1, frame_hw)))
    agent = ImpalaAgent(A, frame_hw + (3,), core_size=H, torso_type="resnet",
                        use_instruction=True, compute_dtype=TORCH[dtype],
                        core_matmul_dtype=dtype)
    agent.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, agent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deep_agent_matches_jax(dtype):
    """Logits, baseline, final carry and every parameter gradient of the
    resnet + instruction agent; the core's D is 256 + 1 + A + 64."""
    frame_hw, T, B = (17, 23), 3, 2
    params, agent = _deep_agent(frame_hw, dtype)
    assert agent.core.wi.shape == (256 + 1 + A + 64, 4 * H)
    d = _agent_inputs(1, T, B, frame_hw)
    jax_agent = _jax_agent(dtype)
    jargs = _jax_args(d)

    def loss_j_of(heads, state):
        logits, baseline = heads
        return (jnp.sum(logits ** 2) + jnp.sum(baseline)
                + jnp.sum(state.c) + jnp.sum(state.h ** 2))

    def loss_j(p):
        heads, state = jax_agent.apply(p, *jargs)
        return loss_j_of(heads, state), (*heads, state.c, state.h)

    (_, outs_j), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    (logits, baseline), state = agent(*_torch_args(d))
    loss = (logits.square().sum() + baseline.sum() + state.c.sum()
            + state.h.square().sum())
    names = [name for name, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, list(agent.parameters()))
    bf16 = dtype == "bfloat16"
    tol = BAND if bf16 else TOL
    for got, want in zip((logits, baseline, state.c, state.h), outs_j):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)
    want_grads = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads_j))
    if bf16:
        want_grads.update(_bias_sums(
            jax_agent, params, jargs, lambda out: loss_j_of(*out)))
    _assert_grads(names, grads, want_grads, tol)


def test_deep_convert_round_trip_is_exact():
    params, agent = _deep_agent((16, 16), seed=3)
    host = jax.tree_util.tree_map(np.asarray, params)
    back = convert.state_dict_to_flax(agent.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(host)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    again = convert.flax_to_state_dict(back)
    assert sorted(again) == sorted(agent.state_dict())
    for name, value in agent.state_dict().items():
        assert torch.equal(again[name], value), name
    # Every parameter maps: 15 convs, fc, the instruction and the core.
    assert sum(n.endswith(".weight") and n.startswith("convnet.")
               for n in again) == 16
    assert convert.layer_group("instruction.embed.weight") == "torso"
    assert convert.layer_group("convnet.residual_2_1.conv_1.bias") == "torso"


# -- envs, pool and transports ------------------------------------------------


def test_fake_env_instruction_matches_jax():
    ours = FakeEnv(height=8, width=8, episode_length=3, seed=4,
                   with_instruction=True)
    ref = JaxFakeEnv(height=8, width=8, episode_length=3, seed=4,
                     with_instruction=True)
    assert ours.observation_spec.instruction.shape == (16,)
    assert np.dtype(ours.observation_spec.instruction.dtype) == np.int32
    outs = [(ours.reset(), ref.reset())]
    for step in range(7):
        obs, _, done, _ = ours.step(step % 9)
        robs, _, rdone, _ = ref.step(step % 9)
        assert done == rdone
        outs.append((obs, robs))
        if done:
            outs.append((ours.reset(), ref.reset()))
    for obs, robs in outs:
        np.testing.assert_array_equal(obs.frame, robs.frame)
        np.testing.assert_array_equal(obs.instruction, robs.instruction)
        assert obs.instruction.dtype == np.int32
    last = outs[-1][0].instruction  # episode 2's
    assert last[0] == 1 + 2 and not last[1:].any()
    assert FakeEnv(height=8, width=8).observation_spec.instruction is None


@pytest.mark.parametrize("num_workers", [0, 2])
def test_multienv_carries_the_instruction(num_workers):
    n = 5
    fns = [functools.partial(make_impala_stream, "fake_small", seed=i,
                             num_action_repeats=2, with_instruction=True)
           for i in range(n)]
    jfns = [functools.partial(jax_stream, "fake_small", seed=i,
                              num_action_repeats=2, with_instruction=True)
            for i in range(n)]
    ours = MultiEnv(fns, TensorSpec((16, 16, 3), np.uint8),
                    num_workers=num_workers)
    refs = [fn() for fn in jfns]
    try:
        got = ours.initial()
        want = [ref.initial() for ref in refs]
        for step in range(12):
            assert got.observation.instruction.shape == (n, L)
            assert got.observation.instruction.dtype == np.int32
            np.testing.assert_array_equal(
                got.observation.instruction,
                np.stack([w.observation.instruction for w in want]))
            np.testing.assert_array_equal(got.done,
                                          [bool(w.done) for w in want])
            actions = np.arange(n) % 9
            got = ours.step(actions)
            want = [ref.step(a) for ref, a in zip(refs, actions)]
    finally:
        ours.close()


def test_pool_stores_the_instruction_and_both_transports_carry_it():
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=2, batch_size=2, unroll_length=4,
                    torso_type="resnet", use_instruction=True)
    spec, space, _ = driver.probe_env(config)
    agent = driver.build_agent(config, spec, space, torch.device("cpu"))
    fns = [functools.partial(make_impala_stream, "fake_small", seed=i,
                             **driver.env_kwargs(config)) for i in range(2)]
    pool = ActorPool(agent, [MultiEnv(fns, spec.frame)],
                     config.unroll_length, seed=1)
    pool.set_params(agent)
    pool.start()
    try:
        out = pool.get_trajectory(timeout=60)
    finally:
        pool.stop()
    instruction = out.env_outputs.observation.instruction
    assert instruction.shape == (5, 2, L) and instruction.dtype == np.int32
    assert (instruction[..., 0] >= 1).all() and not instruction[..., 1:].any()
    traj = host_trajectory(out)
    cpu = torch.device("cpu")
    for transport in (PackedTransport(cpu), PerLeafTransport(cpu)):
        placed, _ = transport.put(traj)
        got = placed.env_outputs.observation.instruction
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), instruction)
        for a, b in zip(tree_leaves(placed), tree_leaves(traj)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b)


# -- FLOPs and the kernel table -----------------------------------------------


def test_update_flops_match_the_flop_counter_on_the_deep_update():
    frame, t, b = (16, 16, 3), 3, 2
    agent = ImpalaAgent(A, frame, core_size=H, torso_type="resnet",
                        use_instruction=True,
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(), t * b * 4)
    d = _agent_inputs(2, t + 1, b, frame[:2])
    _, env, _ = _torch_args(d)
    traj = _trajectory(env, d, b)
    with FlopCounterMode(display=False) as counter:
        learner.update(traj)
    want = update_flops(frame, A, t, b, core_size=H, torso_type="resnet",
                        use_instruction=True)
    assert counter.get_total_flops() == want


def _trajectory(env, d, b):
    steps = d["reward"].shape[0]
    return Trajectory(
        agent_state=AgentState(c=torch.zeros(b, H), h=torch.zeros(b, H)),
        env_outputs=env,
        agent_outputs=AgentOutput(
            action=torch.tensor(d["actions"]),
            policy_logits=torch.zeros((steps, b, A)),
            baseline=torch.zeros((steps, b))))


def _deep_library_ops(frame, num_actions, t, b, hidden):
    """(name, args) of the library products and convolutions of one deep
    update, as the profiler records them: every conv but the stem's weight
    gradient (hand-written), fc, the instruction encoder's products and
    the heads, forward and backward."""
    n = (t + 1) * b
    ops = []
    convs, flat = conv_shapes("resnet", frame)
    for i, conv in enumerate(convs):
        x = [n, conv.in_channels, conv.in_height, conv.in_width]
        w = [conv.out_channels, conv.in_channels, 3, 3]
        ops.append(("aten::convolution", {
            "Input Dims": [x, w, [], [], [], [], [], [], []],
            "Concrete Inputs": ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]",
                                "False", "[0, 0]", "1"]}))
        if i:
            ops.append(("aten::convolution_backward", {
                "Input Dims": [[n, conv.out_channels, conv.out_height,
                                conv.out_width], x, w] + [[]] * 8,
                "Concrete Inputs": [""] * 10 + ["[True, True, False]"]}))
    products = [(n, flat, 256), (n * L, 20, 256)] + [(n, 64, 256)] * (L - 1)
    products += [(n, hidden, num_actions), (n, hidden, 1)]
    for rows, inner, cols in products:
        ops.append(("aten::mm", {"Input Dims": [[rows, inner],
                                                [inner, cols]]}))
        ops.append(("aten::mm", {"Input Dims": [[inner, rows],
                                                [rows, cols]]}))
        ops.append(("aten::mm", {"Input Dims": [[rows, cols],
                                                [cols, inner]]}))
    return ops


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_costs_at_the_deep_path_shapes_sum_to_update_flops(compute_dtype):
    frame, t, b = (72, 96, 3), 100, 32
    costs = kernels.handwritten_costs(frame, 9, t, b,
                                      compute_dtype=compute_dtype,
                                      torso_type="resnet",
                                      use_instruction=True)
    assert "resnet_stem_gradw_kernel" in costs
    assert "conv_gradw_band_kernel" not in costs
    handwritten = sum(c["flops_est"] * c["calls"] for c in costs.values())
    library = sum(kernels.op_cost(name, args)[0] for name, args in
                  _deep_library_ops(frame, 9, t, b, 256))
    want = update_flops(frame, 9, t, b, torso_type="resnet",
                        use_instruction=True)
    assert handwritten + library == pytest.approx(want, rel=1e-12)
    # The stem's grad-W reads x [3232, 72, 96, 3] and g [..., 16] once.
    width = 2 if compute_dtype == "bfloat16" else 4
    stem = costs["resnet_stem_gradw_kernel"]
    assert stem["flops_est"] == 2 * 3232 * 72 * 96 * 27 * 16
    assert stem["bytes"] >= width * 3232 * 72 * 96 * 19
    # x.Wi reads x [3232, 330]: the instruction widens the core's input.
    assert costs["sgemm_kernel<true"]["bytes"] == 4 * (
        3232 * 330 + 330 * 1024 + 1024 + 3232 * 1024)


# -- the driver ---------------------------------------------------------------


def test_deep_train_then_test_adopts_the_architecture(tmp_path):
    config = Config(device="cpu", level_name="fake_small", height=16,
                    width=16, num_actors=2, batch_size=2, unroll_length=3,
                    num_action_repeats=4, log_interval_s=0.0,
                    torso_type="resnet", use_instruction=True,
                    total_environment_frames=2 * 2 * 3 * 4,
                    logdir=str(tmp_path), num_env_workers_per_group=1,
                    health=False)
    metrics = driver.train(config)
    assert metrics["env_frames"] == 2 * config.frames_per_update()
    for key in ("total_loss", "grad_norm"):
        assert np.isfinite(metrics[key]), key
    # The eval flags name the default architecture; the checkpoint's wins.
    returns = driver.test(dataclasses.replace(
        config, mode="test", torso_type="shallow", use_instruction=False,
        test_num_episodes=2, test_num_workers=1))
    assert len(returns["fake_small"]) == 2
