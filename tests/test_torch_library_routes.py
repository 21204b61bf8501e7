"""The library routes, ``--core_impl=xla`` and ``--conv_backend=xla``, held
against the live JAX ``xla`` routes on the CPU.

- The whole agent on each route (the ``xla`` core beside the stem's
  grad-W kernel, the ``xla`` stem beside the fused core, and both library
  routes at once) against the JAX ``ImpalaAgent`` on the route a JAX run
  with the same flags takes on the CPU (``JAX_ROUTES``: ``--core_impl=xla``
  leaves ``conv_backend=auto``, which is XLA's stem there; the stem
  kernel's plain version is held to the Pallas stem in
  ``tests/test_torch_conv.py``), under both dtype policies, through
  ``convert.py``: logits, baseline, final carry and every parameter
  gradient.  Then, with both library routes, one learner update against a JAX ``Learner``: its losses and
  the parameter change.  The JAX side is computed once, in a
  module-scoped fixture all cases share (the fused core in interpret
  mode, as the JAX package's own tests run it).
- ``resolve_core_impl``, ``resolve_conv_backend`` and
  ``resolve_core_matmul_dtype`` against the JAX driver's for every flag
  value.  ``auto`` is the kernels in the port on every device (on the CPU
  their plain versions run); the JAX driver's ``auto`` is the kernels on
  its accelerator, so the port's is held against the JAX answer on a
  one-chip TPU (``jax.default_backend`` patched to ``"tpu"``, a mesh of
  one device: the port runs on one card).
- ``build_agent``'s warning for a non-float32 ``core_matmul_dtype`` on the
  ``xla`` core, word for word the JAX driver's.
- On each route the replaced kernel's wrapper is never called.

Tolerances: float32, rtol/atol 1e-5 on outputs, losses and gradients
(the same float32 math in another summation order), parameter changes
1e-3 of each leaf's largest change (differences of nearly equal numbers,
as ``tests/test_torch_learner.py``); bfloat16, ``tests/test_torch_bf16.py``'s
band, rtol/atol 2e-2, and each leaf's parameter change within 2e-2 of its
norm (the norm-relative leaf compare of the JAX package's
``runtime/sentinel.py``: a conv bias's change is the sum of bf16
cotangents each framework rounds its own way: at these inputs conv_0's
32-wide bias is 2.6% off at one element and 1.7% over its norm, every
other leaf within 1.3% and 0.8%).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs.spaces import Discrete as JaxDiscrete
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import (
    SUPPORTED_VALUES,
    Config,
    resolve_conv_backend,
    resolve_core_impl,
    resolve_core_matmul_dtype,
)
from scalable_agent_tpu_torch.envs import TensorSpec
from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import kernels
from scalable_agent_tpu_torch.ops import conv_cuda, lstm_cuda
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
from scalable_agent_tpu_torch.types import Observation

import test_torch_agent as agent_case
import test_torch_learner as learner_case

BF16 = "bfloat16"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)
# (core_impl, conv_backend): each library route alone, and both.
ROUTES = [("xla", "pallas"), ("pallas", "xla"), ("xla", "xla")]
LEARNER_ROUTE = ("xla", "xla")
# The JAX route each port route is held against.
JAX_ROUTES = {("xla", "pallas"): ("xla", "xla"),
              ("pallas", "xla"): ("pallas", "xla"),
              ("xla", "xla"): ("xla", "xla")}
DTYPES = ["float32", BF16]
LOSSES = ("total_loss", "policy_gradient_loss", "baseline_loss",
          "entropy_loss")
FRAME_HW = (16, 16)
T, B = 5, 4
TOTAL_FRAMES = 1e3


def _jax_agent(core_impl, conv_backend, compute_dtype, num_actions,
               core_size):
    return JaxAgent(num_actions=num_actions, core_size=core_size,
                    core_impl=core_impl, conv_backend=conv_backend,
                    compute_dtype=jnp.dtype(compute_dtype),
                    core_matmul_dtype=jax_driver.resolve_core_matmul_dtype(
                        JaxConfig(compute_dtype=compute_dtype), core_impl))


def _port_agent(core_impl, conv_backend, compute_dtype, num_actions,
                core_size, frame_hw, state_dict):
    config = Config(compute_dtype=compute_dtype)
    agent = ImpalaAgent(num_actions, frame_hw + (3,), core_size=core_size,
                        compute_dtype=getattr(torch, compute_dtype),
                        core_matmul_dtype=resolve_core_matmul_dtype(
                            config, core_impl),
                        core_impl=core_impl, conv_backend=conv_backend)
    agent.load_state_dict(state_dict)
    return agent


def _loss(logits, baseline, state, sum_, square):
    return (sum_(square(logits)) + sum_(baseline) + sum_(state.c)
            + sum_(square(state.h)))


def _jax_case(core_impl, conv_backend, compute_dtype):
    """The JAX side of one case: the agent's outputs and gradients, and on
    ``LEARNER_ROUTE`` one learner update (its losses, its start and end
    parameters)."""
    jax_agent = _jax_agent(core_impl, conv_backend, compute_dtype,
                           agent_case.A, agent_case.H)
    d0 = agent_case._inputs(0, 2, 1, FRAME_HW)
    params = jax_agent.init(jax.random.key(0), *agent_case._jax_args(d0))
    jargs = agent_case._jax_args(agent_case._inputs(1, T, B, FRAME_HW))

    def loss_j(p):
        (logits, baseline), state = jax_agent.apply(p, *jargs)
        return (_loss(logits, baseline, state, jnp.sum, jnp.square),
                (logits, baseline, state.c, state.h))

    (_, outs), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    host = lambda tree: convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree))
    case = dict(params=host(params),
                outs=[np.asarray(o, np.float32) for o in outs],
                grads=host(grads))
    if (core_impl, conv_backend) != LEARNER_ROUTE:
        return case

    learner_agent = _jax_agent(core_impl, conv_backend, compute_dtype,
                               learner_case.A, learner_case.H)
    learner = JaxLearner(
        learner_agent, JaxHp(total_environment_frames=TOTAL_FRAMES),
        make_mesh(MeshSpec(data=1), devices=jax.devices()[:1]),
        learner_case.FRAMES_PER_UPDATE, device_telemetry=False,
        learn_telemetry=False)
    traj = learner_case._jax_traj(learner_case._trajectory(0))
    state = learner.init(jax.random.key(0), traj)
    start = host(state.params)
    state, metrics = learner.update(state, traj)
    return dict(case, losses={k: float(metrics[k]) for k in LOSSES},
                start=start, end=host(state.params))


@pytest.fixture(scope="module")
def jax_cases():
    return {(core, conv, dtype): _jax_case(core, conv, dtype)
            for core, conv in set(JAX_ROUTES.values()) for dtype in DTYPES}


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BAND


@pytest.fixture
def no_replaced_kernel(monkeypatch):
    """Make the wrappers of the kernels a route replaces raise; returns
    the function that arms them for (core_impl, conv_backend)."""

    def refuse(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"{name} was called on a library route")
        return fail

    def arm(core_impl, conv_backend):
        if core_impl == "xla":
            monkeypatch.setattr(lstm_cuda, "lstm_unroll",
                                refuse("lstm_unroll"))
            from scalable_agent_tpu_torch.models import agent as agent_mod
            monkeypatch.setattr(agent_mod, "lstm_unroll",
                                refuse("lstm_unroll"))
        if conv_backend == "xla":
            monkeypatch.setattr(conv_cuda, "conv_gradw",
                                refuse("conv_gradw"))

    return arm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("core_impl,conv_backend", ROUTES)
def test_agent_on_library_routes_matches_jax(jax_cases, no_replaced_kernel,
                                             core_impl, conv_backend,
                                             dtype):
    """Logits, baseline, final carry and every parameter gradient."""
    case = jax_cases[JAX_ROUTES[(core_impl, conv_backend)] + (dtype,)]
    no_replaced_kernel(core_impl, conv_backend)
    agent = _port_agent(core_impl, conv_backend, dtype, agent_case.A,
                        agent_case.H, FRAME_HW, case["params"])
    (logits, baseline), state = agent(*agent_case._torch_args(
        agent_case._inputs(1, T, B, FRAME_HW)))
    loss = _loss(logits, baseline, state, torch.sum, torch.square)
    names = [name for name, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, list(agent.parameters()))
    tol = _tol(dtype)
    for got, want in zip((logits, baseline, state.c, state.h),
                         case["outs"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    assert sorted(case["grads"]) == sorted(names)
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), case["grads"][name].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_learner_update_on_library_routes_matches_jax(
        jax_cases, no_replaced_kernel, dtype):
    """One update on both library routes: the losses, and the parameter
    change."""
    core_impl, conv_backend = LEARNER_ROUTE
    case = jax_cases[(core_impl, conv_backend, dtype)]
    no_replaced_kernel(core_impl, conv_backend)
    agent = _port_agent(core_impl, conv_backend, dtype, learner_case.A,
                        learner_case.H, FRAME_HW, case["start"])
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=TOTAL_FRAMES),
        learner_case.FRAMES_PER_UPDATE)
    got = learner.update(learner_case._torch_traj(
        learner_case._trajectory(0)))
    tol = _tol(dtype)
    for key in LOSSES:
        np.testing.assert_allclose(float(got[key]), case["losses"][key],
                                   err_msg=key, **tol)
    for name, param in agent.named_parameters():
        want = (case["end"][name] - case["start"][name]).numpy()
        change = (param.detach() - case["start"][name]).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(
                change, want, rtol=0, atol=1e-3 * float(np.abs(want).max()),
                err_msg=name)
        else:
            assert (np.linalg.norm(change - want)
                    <= BAND["rtol"] * np.linalg.norm(want)), name


# -- the resolutions ----------------------------------------------------------


@pytest.fixture
def jax_on_its_accelerator(monkeypatch):
    """The JAX driver as it resolves ``auto`` on a TPU; the configs below
    give it a mesh of one chip (``mesh_data=1``)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("value", SUPPORTED_VALUES["core_impl"])
def test_core_impl_resolves_as_the_jax_driver(jax_on_its_accelerator,
                                              value):
    ours = resolve_core_impl(Config(core_impl=value))
    assert ours == jax_driver.resolve_core_impl(
        JaxConfig(core_impl=value, mesh_data=1))
    assert ours == ("pallas" if value == "auto" else value)


@pytest.mark.parametrize("value", SUPPORTED_VALUES["conv_backend"])
def test_conv_backend_resolves_as_the_jax_driver(jax_on_its_accelerator,
                                                 value):
    ours = resolve_conv_backend(Config(conv_backend=value))
    assert ours == jax_driver.resolve_conv_backend(
        JaxConfig(conv_backend=value))
    assert ours == ("pallas" if value == "auto" else value)


@pytest.mark.parametrize("core_impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("compute_dtype", [BF16, "float32"])
@pytest.mark.parametrize("core_matmul_dtype", ["auto", "float32", BF16])
def test_core_matmul_dtype_resolves_as_the_jax_driver(
        jax_on_its_accelerator, core_impl, compute_dtype, core_matmul_dtype):
    """``driver.py:234-246`` on each core: ``auto`` is float32 on the xla
    core, ``compute_dtype`` on the fused one."""
    fields = dict(core_impl=core_impl, compute_dtype=compute_dtype,
                  core_matmul_dtype=core_matmul_dtype)
    ours, theirs = Config(**fields), JaxConfig(mesh_data=1, **fields)
    impl = resolve_core_impl(ours)
    assert impl == jax_driver.resolve_core_impl(theirs)
    assert resolve_core_matmul_dtype(ours, impl) == (
        jax_driver.resolve_core_matmul_dtype(theirs, impl))
    assert resolve_core_matmul_dtype(ours) == resolve_core_matmul_dtype(
        ours, impl)


def test_bf16_matmul_on_the_xla_core_warns_as_the_jax_driver():
    """``driver.py:259-270``: the same warning, word for word, and the
    agent trains at float32 on that core; no warning on the fused core."""
    fields = dict(core_impl="xla", core_matmul_dtype=BF16)
    with pytest.warns(UserWarning) as theirs:
        jax_driver.build_agent(JaxConfig(**fields), JaxDiscrete(4))
    spec = TensorSpec((16, 16, 3), np.uint8, "frame")
    obs_spec = Observation(frame=spec)
    with pytest.warns(UserWarning) as ours:
        agent = driver.build_agent(Config(device="cpu", **fields), obs_spec,
                                   Discrete(4), torch.device("cpu"))
    assert [str(w.message) for w in ours] == [
        str(w.message) for w in theirs]
    assert agent.core.core_impl == "xla"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        agent = driver.build_agent(
            Config(device="cpu", core_matmul_dtype=BF16), obs_spec,
            Discrete(4), torch.device("cpu"))
    assert (agent.core.core_impl, agent.core_matmul_dtype) == (
        "pallas", BF16)


@pytest.mark.parametrize("argv", [["--core_impl=xla"],
                                  ["--conv_backend=xla"]])
def test_library_route_flags_parse(argv):
    config = Config.from_argv(argv)
    assert "xla" in (config.core_impl, config.conv_backend)


@pytest.mark.parametrize("core_impl,conv_backend", ROUTES)
def test_kernel_costs_leave_out_the_replaced_kernels(core_impl,
                                                     conv_backend):
    """A library arm's kernel table prices only the hand-written kernels
    that arm launches: the LSTM kernels go with ``core_impl=xla``, the
    grad-W kernels with ``conv_backend=xla``."""
    shape = ((72, 96, 3), 9, 100, 32)
    full = kernels.handwritten_costs(*shape)
    routed = kernels.handwritten_costs(*shape, core_impl=core_impl,
                                       conv_backend=conv_backend)
    lstm = {k for k in full if k.startswith(
        kernels.LIBRARY_ROUTES["core_impl"])}
    gradw = {k for k in full if k.startswith(
        kernels.LIBRARY_ROUTES["conv_backend"])}
    assert lstm and gradw and not lstm & gradw
    gone = ((lstm if core_impl == "xla" else set())
            | (gradw if conv_backend == "xla" else set()))
    assert set(routed) == set(full) - gone
    assert "vtrace_chunked_kernel" in routed
