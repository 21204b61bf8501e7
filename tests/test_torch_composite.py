"""Composite (TupleSpace) policies, ``--rmsprop_momentum`` and
``--benchmark_mode`` in the port, held against the live JAX package on
the CPU from the same numpy-seeded inputs:

- (a) every function of ``ops/distributions.py`` against JAX's on
  ``fake_tuple``'s space and on each space of the JAX
  ``envs/doom/action_space.py`` (built as the port's spaces of the same
  sizes), to 1e-5 at float32; the spaces' own ``sample`` bit for bit;
  composite ``sample`` in range, repeatable from one seeded generator,
  and within 0.015 of the softmax probabilities over 20000 draws (4.2
  standard deviations of a frequency at p = 0.5);
- (b) ``BenchmarkStream`` over ``fake_tuple`` and ``fake_small``: the
  env-side actions equal JAX's bit for bit (both draw from
  ``np.random.default_rng(seed)``), whatever the agent sends;
- (c) ``fake_tuple`` through the port's ``MultiEnv`` against JAX's, [N, K]
  actions, in worker processes and in process; the TupleSpace comes back
  from a worker and from ``driver.probe_env``;
- (d) the composite agent and ``actor_step`` against JAX's
  ``ImpalaAgent(action_space=...)`` through ``convert.py`` unchanged:
  float32 at ``tests/test_torch_agent.py``'s tolerances, bf16 in
  ``tests/test_torch_bf16.py``'s 2e-2 band;
- (e) 10 updates of the port's learner against the live JAX ``Learner``:
  ``fake_tuple``'s policy at momentum 0 and ``fake_small``'s at
  ``rmsprop_momentum=0.9``, under ``scan_impl`` associative and pallas,
  at ``tests/test_torch_learner.py``'s tolerances; a momentum-0 update is
  today's update bit for bit and keeps no trace;
- (f) a composite trajectory through ``per_leaf`` and ``packed``, equal
  leaf for leaf;
- (g) ``driver.train`` on ``fake_tuple`` with momentum, a resume that is
  frame-exact and restores the trace bit for bit, ``--mode=test``, and a
  resume across a momentum mismatch that raises;
- (h) ``update_flops`` and ``handwritten_costs`` count the composite
  policy's logits: ``FlopCounterMode`` agrees with ``update_flops`` at the
  composite shapes.
"""

import contextlib
import copy
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import make_impala_stream as jax_stream
from scalable_agent_tpu.envs import spaces as jax_spaces
from scalable_agent_tpu.envs.doom import action_space as doom_spaces
from scalable_agent_tpu.envs.spec import TensorSpec as JaxTensorSpec
from scalable_agent_tpu.envs.vector import MultiEnv as JaxMultiEnv
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.models import actor_step as jax_actor_step
from scalable_agent_tpu.ops import distributions as jax_dist
from scalable_agent_tpu.ops import vtrace as jax_vtrace
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import (
    MultiEnv,
    TensorSpec,
    make_impala_stream,
    spaces,
)
from scalable_agent_tpu_torch.envs.worker import EnvProcess
from scalable_agent_tpu_torch.models import ImpalaAgent, actor_step
from scalable_agent_tpu_torch.obs import kernels
from scalable_agent_tpu_torch.ops import distributions, vtrace
from scalable_agent_tpu_torch.runtime import (
    CheckpointManager,
    Learner,
    LearnerHyperparams,
)
from scalable_agent_tpu_torch.runtime.learner import update_flops
from scalable_agent_tpu_torch.runtime.transport import (
    PackedTransport,
    PerLeafTransport,
    tree_leaves,
)
from scalable_agent_tpu_torch.types import map_structure

import test_torch_agent as agent_case
import test_torch_learner as learner_case

FAKE_TUPLE = jax_spaces.TupleSpace(
    [jax_spaces.Discrete(3), jax_spaces.Discretized(5, -1.0, 1.0)])
JAX_SPACES = {
    "fake_tuple": FAKE_TUPLE,
    "discrete9": jax_spaces.Discrete(9),
    **{name: getattr(doom_spaces, name)() for name in (
        "doom_action_space_basic", "doom_action_space",
        "doom_action_space_discretized",
        "doom_action_space_discretized_no_weap",
        "doom_action_space_continuous_no_weap",
        "doom_action_space_discrete",
        "doom_action_space_discrete_no_weap",
        "doom_action_space_full_discretized")},
    "doom_action_space_full_discretized_with_use":
        doom_spaces.doom_action_space_full_discretized(with_use=True),
}


def _categorical(space) -> bool:
    """Whether JAX has a categorical policy over ``space`` (a Box
    component has none)."""
    try:
        jax_dist.spec_for_space(space)
    except NotImplementedError:
        return False
    return True


CATEGORICAL = [name for name, space in JAX_SPACES.items()
               if _categorical(space)]
TOL = dict(rtol=1e-5, atol=1e-5)


def port_space(space):
    """A JAX space as the port's space of the same sizes."""
    if isinstance(space, jax_spaces.TupleSpace):
        return spaces.TupleSpace([port_space(s) for s in space.spaces])
    if isinstance(space, jax_spaces.Discretized):
        return spaces.Discretized(space.n, space.min_action,
                                  space.max_action)
    if isinstance(space, jax_spaces.Discrete):
        return spaces.Discrete(space.n)
    if isinstance(space, jax_spaces.Box):
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    raise TypeError(space)


# -- (a) spaces and distributions --------------------------------------------


@pytest.mark.parametrize("name", sorted(JAX_SPACES))
def test_spaces_count_and_sample_as_jax(name):
    want, got = JAX_SPACES[name], port_space(JAX_SPACES[name])
    assert got == port_space(want) and repr(got) == repr(want)
    ours, theirs = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(50):
        a, b = got.sample(ours), want.sample(theirs)
        flat = lambda v: np.concatenate([np.ravel(np.asarray(c)) for c in (
            v if isinstance(v, tuple) else (v,))])
        np.testing.assert_array_equal(flat(a), flat(b))
        assert got.contains(a)
    if name in CATEGORICAL:
        assert spaces.calc_num_logits(got) == jax_spaces.calc_num_logits(
            want)
        assert distributions.spec_for_space(got).num_components == (
            jax_spaces.calc_num_actions(want))
        assert distributions.spec_for_space(got).sizes == (
            jax_dist.spec_for_space(want).sizes)
    else:
        for spec_for_space, space in ((distributions.spec_for_space, got),
                                      (jax_dist.spec_for_space, want)):
            with pytest.raises(NotImplementedError):
                spec_for_space(space)


def _case(name, seed, shape=(4, 3)):
    spec = distributions.spec_for_space(port_space(JAX_SPACES[name]))
    rng = np.random.default_rng(seed)
    logits = lambda: (rng.standard_normal(shape + (spec.num_logits,))
                      * 2).astype(np.float32)
    actions = np.stack([rng.integers(0, n, shape) for n in spec.sizes], -1)
    if spec.num_components == 1:
        actions = actions[..., 0]
    return spec, logits(), logits(), actions


@pytest.mark.parametrize("name", CATEGORICAL)
def test_distribution_functions_match_jax(name):
    spec, p, q, actions = _case(name, 1)
    jspec = jax_dist.spec_for_space(JAX_SPACES[name])
    tp, tq, ta = torch.tensor(p), torch.tensor(q), torch.tensor(actions)
    pairs = [
        (distributions.log_prob(tp, ta, spec),
         jax_dist.log_prob(p, actions, jspec)),
        (distributions.entropy(tp, spec), jax_dist.entropy(p, jspec)),
        (distributions.kl_divergence(tp, tq, spec),
         jax_dist.kl_divergence(p, q, jspec)),
        (distributions.symmetric_kl(tp, tq, spec),
         jax_dist.symmetric_kl(p, q, jspec)),
        (distributions.kl_to_prior(tp, spec),
         jax_dist.kl_to_prior(p, jspec)),
        (distributions.one_hot_actions(ta, spec),
         jax_dist.one_hot_actions(actions, jspec)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == np.asarray(want).shape, i
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=str(i), **TOL)


@pytest.mark.parametrize("name", CATEGORICAL)
def test_composite_sample_range_repeat_and_frequencies(name):
    spec, p, _, _ = _case(name, 2)
    logits = torch.tensor(p)
    gen = torch.Generator().manual_seed(7)
    first = distributions.sample(gen, logits, spec)
    gen.manual_seed(7)
    assert torch.equal(first, distributions.sample(gen, logits, spec))
    k = spec.num_components
    assert first.dtype == torch.int64
    assert tuple(first.shape) == (4, 3) + ((k,) if k > 1 else ())
    draws = 20000
    row = torch.tensor(p[0, 0]).expand(draws, -1)
    got = distributions.sample(gen, row, spec).reshape(draws, k)
    start = 0
    for i, size in enumerate(spec.sizes):
        component = got[:, i]
        assert int(component.min()) >= 0 and int(component.max()) < size
        freq = torch.bincount(component, minlength=size).double() / draws
        probs = torch.softmax(row[0, start:start + size].double(), -1)
        np.testing.assert_allclose(freq.numpy(), probs.numpy(), rtol=0,
                                   atol=0.015, err_msg=f"component {i}")
        start += size


@pytest.mark.parametrize("scan_impl", ["associative", "pallas"])
@pytest.mark.parametrize("name", ["fake_tuple",
                                  "doom_action_space_full_discretized"])
def test_vtrace_from_logits_takes_joint_log_rhos_as_jax(name, scan_impl):
    spec = distributions.spec_for_space(port_space(JAX_SPACES[name]))
    jspec = jax_dist.spec_for_space(JAX_SPACES[name])
    _, behaviour, target, actions = _case(name, 3, shape=(7, 5))
    rng = np.random.default_rng(4)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    rest = dict(discounts=(0.99 * (rng.random((7, 5)) > 0.2)).astype(
        np.float32), rewards=f32(7, 5), values=f32(7, 5),
        bootstrap_value=f32(5))
    got = vtrace.from_logits(
        torch.tensor(behaviour), torch.tensor(target), torch.tensor(actions),
        **{k: torch.tensor(v) for k, v in rest.items()},
        scan_impl=scan_impl, dist_spec=spec)
    want = jax_vtrace.from_logits(behaviour, target, actions, **rest,
                                  dist_spec=jspec)
    for field in ("vs", "pg_advantages", "log_rhos",
                  "behaviour_action_log_probs", "target_action_log_probs"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   err_msg=field, **TOL)
    with pytest.raises(ValueError, match="rank 3"):
        vtrace.from_logits(
            torch.tensor(behaviour), torch.tensor(target),
            torch.tensor(actions[..., 0]),
            **{k: torch.tensor(v) for k, v in rest.items()}, dist_spec=spec)


def test_single_component_layout_stays_component_less():
    spec = distributions.DistributionSpec(sizes=(9,))
    logits = torch.randn(5, 2, 9, generator=torch.Generator().manual_seed(1))
    action = distributions.sample(torch.Generator().manual_seed(2), logits,
                                  spec)
    assert action.shape == (5, 2)
    assert distributions.one_hot_actions(action, spec).shape == (5, 2, 9)
    composite = distributions.DistributionSpec(sizes=(4, 5))
    with pytest.raises(ValueError, match="components"):
        distributions.log_prob(logits, torch.zeros(5, 2, 3, dtype=torch.long),
                               composite)


# -- (b) BenchmarkStream ---------------------------------------------------


def _assert_same(got, want):
    for a, b in ((got.reward, want.reward), (got.done, want.done),
                 (got.info.episode_return, want.info.episode_return),
                 (got.info.episode_step, want.info.episode_step),
                 (got.observation.frame, want.observation.frame)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("level", ["fake_tuple", "fake_small"])
def test_benchmark_stream_draws_the_jax_actions(level):
    """The agent's actions are ignored on both sides; the env steps with
    the stream's own draws, which equal JAX's and a plain
    ``default_rng(seed)`` over the space."""
    ours = make_impala_stream(level, seed=11, benchmark_mode=True,
                              num_action_repeats=2)
    ref = jax_stream(level, seed=11, benchmark_mode=True,
                     num_action_repeats=2)
    _assert_same(ours.initial(), ref.initial())
    space = ours.action_space
    draws = np.random.default_rng(11)
    agent = np.random.default_rng(12)
    for _ in range(60):
        agent_action = np.asarray(space.sample(agent))
        got = ours.step(agent_action)
        _assert_same(got, ref.step(np.zeros_like(agent_action)))
        first = np.asarray(space.sample(draws)).reshape(-1)[0]
        if not got.done:
            assert got.observation.frame[0, 2, 0] == first


def test_benchmark_mode_reaches_the_env_groups():
    config = Config(level_name="fake_tuple", height=16, width=16,
                    num_actors=2, batch_size=2, device="cpu",
                    num_env_workers_per_group=1, benchmark_mode=True)
    frame = driver.probe_env(config)[0].frame
    groups = driver.make_env_groups(config, frame)
    try:
        envs = groups[0]
        envs.initial()
        out = envs.step(np.zeros((2, 2), np.int64))
        for i in range(2):
            rng = np.random.default_rng(config.seed * 100000 + i)
            assert out.observation.frame[i, 0, 2, 0] == int(
                rng.integers(3))
    finally:
        for envs in groups:
            envs.close()


# -- (c) MultiEnv and the probe ----------------------------------------------

N = 5
FRAME = TensorSpec((16, 16, 3), np.uint8, "frame")


def _fns(make):
    return [functools.partial(make, "fake_tuple", seed=i,
                              num_action_repeats=2) for i in range(N)]


@pytest.mark.parametrize("num_workers", [2, 0])
def test_fake_tuple_multienv_matches_jax(num_workers):
    ours = MultiEnv(_fns(make_impala_stream), FRAME,
                    num_workers=num_workers)
    ref = JaxMultiEnv(_fns(jax_stream), JaxTensorSpec(
        FRAME.shape, FRAME.dtype, "frame"), num_workers=2)
    try:
        _assert_same(ours.initial(), ref.initial())
        rng = np.random.default_rng(3)
        for _ in range(40):
            actions = np.stack([rng.integers(0, 3, N),
                                rng.integers(0, 5, N)], -1)
            ours.step_send(actions)
            ref.step_send(actions)
            got = ours.step_recv()
            _assert_same(got, ref.step_recv())
            live = ~got.done
            np.testing.assert_array_equal(
                got.observation.frame[live, 0, 2, 0], actions[live, 0])
        assert list(ours.episode_stats) == list(ref.episode_stats)
    finally:
        ours.close()
        ref.close()


def test_tuple_space_comes_back_from_a_worker_and_the_probe():
    fn = functools.partial(make_impala_stream, "fake_tuple", seed=1)
    with EnvProcess(fn, frame_spec=FRAME) as proc:
        _, space = proc.specs()
    want = port_space(FAKE_TUPLE)
    assert space == want
    config = Config(level_name="fake_tuple", height=16, width=16,
                    device="cpu")
    obs_spec, probed, num_agents = driver.probe_env(config)
    jax_obs, jax_space, _ = jax_driver.probe_env(JaxConfig(
        level_name="fake_tuple", height=16, width=16))
    assert probed == want == port_space(jax_space)
    assert num_agents == 1
    assert tuple(obs_spec.frame.shape) == tuple(jax_obs.frame.shape)


# -- (d) the composite agent -------------------------------------------------

H = 16
BF16 = "bfloat16"
BF16_BAND = dict(rtol=2e-2, atol=2e-2)


def _agent_inputs(seed, T, B, space):
    spec = distributions.spec_for_space(space)
    rng = np.random.default_rng(seed)
    actions = np.stack([rng.integers(0, n, (T, B)) for n in spec.sizes], -1)
    return dict(
        actions=actions if spec.num_components > 1 else actions[..., 0],
        reward=(rng.standard_normal((T, B)) * 2).astype(np.float32),
        done=rng.random((T, B)) < 0.3,
        frame=rng.integers(0, 256, (T, B, 16, 16, 3), dtype=np.uint8),
        c=(rng.standard_normal((B, H)) * 0.5).astype(np.float32),
        h=np.tanh(rng.standard_normal((B, H))).astype(np.float32))


_jax_args, _torch_args = agent_case._jax_args, agent_case._torch_args


def _jax_agent(space, compute_dtype="float32"):
    return JaxAgent(action_space=space, core_size=H, core_impl="pallas",
                    conv_backend="pallas",
                    compute_dtype=jnp.dtype(compute_dtype),
                    core_matmul_dtype=compute_dtype)


def _agent_pair(name, compute_dtype="float32", seed=0):
    """The JAX agent over ``name``'s space and the port's agent over the
    port's space with the JAX weights through ``convert.py``, which needs
    no mapping of its own for a composite policy: its policy head is only
    wider."""
    space = JAX_SPACES[name]
    jax_agent = _jax_agent(space, compute_dtype)
    params = jax.jit(jax_agent.init)(jax.random.key(seed), *_jax_args(
        _agent_inputs(seed, 2, 1, port_space(space))))
    agent = ImpalaAgent(frame_shape=(16, 16, 3), core_size=H,
                        action_space=port_space(space),
                        compute_dtype=getattr(torch, compute_dtype),
                        core_matmul_dtype=compute_dtype)
    host = jax.tree_util.tree_map(np.asarray, params)
    agent.load_state_dict(convert.flax_to_state_dict(host))
    assert agent.num_logits == jax_agent.num_logits
    assert agent.num_action_components == jax_agent.num_action_components
    assert agent.policy_logits.weight.shape == (agent.num_logits, H)
    back = convert.state_dict_to_flax(agent.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(host),
                                 jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    return jax_agent, params, agent


@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
@pytest.mark.parametrize("name", ["fake_tuple",
                                  "doom_action_space_full_discretized"])
def test_composite_agent_matches_jax(name, compute_dtype):
    """Logits, baseline, the final carry and every parameter gradient."""
    jax_agent, params, agent = _agent_pair(name, compute_dtype)
    d = _agent_inputs(1, 5, 4, port_space(JAX_SPACES[name]))
    jargs = _jax_args(d)

    def loss_j(p):
        (logits, baseline), state = jax_agent.apply(p, *jargs)
        loss = (jnp.sum(logits ** 2) + jnp.sum(baseline)
                + jnp.sum(state.c) + jnp.sum(state.h ** 2))
        return loss, (logits, baseline, state.c, state.h)

    # One compile of the whole JAX side instead of one for each primitive.
    (_, want), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    (logits, baseline), state = agent(*_torch_args(d))
    loss = (logits.square().sum() + baseline.sum() + state.c.sum()
            + state.h.square().sum())
    names = [n for n, _ in agent.named_parameters()]
    grads = torch.autograd.grad(loss, list(agent.parameters()))
    tol = BF16_BAND if compute_dtype == BF16 else dict(rtol=1e-4, atol=1e-5)
    for got, ref in zip((logits, baseline, state.c, state.h), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **tol)
    want_grads = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads_j))
    for n, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want_grads[n].numpy(),
                                   err_msg=n, **tol)


@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
def test_composite_actor_step_matches_jax(compute_dtype):
    jax_agent, params, agent = _agent_pair("fake_tuple", compute_dtype, 2)
    space = port_space(FAKE_TUPLE)
    d = _agent_inputs(3, 1, 6, space)
    actions, env, state = _torch_args(d)
    jactions, jenv, jstate = _jax_args(d)
    out, new_state = actor_step(
        agent, torch.Generator().manual_seed(4), actions[0],
        map_structure(lambda t: None if t is None else t[0], env), state)
    jout, jstate_new = jax.jit(functools.partial(jax_actor_step, jax_agent))(
        params, jax.random.key(4), jactions[0],
        jax.tree_util.tree_map(lambda t: t[0], jenv), jstate)
    tol = BF16_BAND if compute_dtype == BF16 else dict(rtol=1e-4, atol=1e-5)
    for got, want in ((out.policy_logits, jout.policy_logits),
                      (out.baseline, jout.baseline),
                      (new_state.c, jstate_new.c),
                      (new_state.h, jstate_new.h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert out.action.shape == (6, 2) == np.asarray(jout.action).shape
    assert out.action.dtype == torch.int64
    for i, n in enumerate((3, 5)):
        assert int(out.action[:, i].min()) >= 0
        assert int(out.action[:, i].max()) < n
    assert agent.zero_actions(6).shape == (6, 2)
    assert agent.zero_actions(6).dtype == torch.int64


# -- (e) the learner ---------------------------------------------------------

# test_torch_learner's batch shape, whose trajectory helpers carry any
# action layout through.
T, B, FRAMES_PER_UPDATE = (learner_case.T, learner_case.B,
                           learner_case.FRAMES_PER_UPDATE)
UPDATES = 10


def _trajectory(seed, spec):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    actions = np.stack([rng.integers(0, n, (T + 1, B)) for n in spec.sizes],
                       -1)
    return dict(
        c=f32(B, H, scale=0.5), h=np.tanh(f32(B, H)),
        reward=f32(T + 1, B, scale=2.0),
        done=rng.random((T + 1, B)) < 0.25,
        frame=rng.integers(0, 256, (T + 1, B, 16, 16, 3), dtype=np.uint8),
        action=actions if spec.num_components > 1 else actions[..., 0],
        logits=f32(T + 1, B, spec.num_logits),
        baseline=f32(T + 1, B))


_jax_traj, _torch_traj = learner_case._jax_traj, learner_case._torch_traj


LEARNER_CASES = {"fake_tuple": (FAKE_TUPLE, 0.0),
                 "fake_small_momentum": (jax_spaces.Discrete(9), 0.9)}


@functools.lru_cache(maxsize=None)
def _jax_learner_run(case):
    """The live JAX ``Learner`` over ``case``'s ten batches, computed once
    for both of the port's ``scan_impl``s: its Pallas V-trace (the kernel
    the port's ``pallas`` path translates, in interpret mode), whose
    agreement with the JAX associative scan the JAX package's own tests
    hold.  Returns the start and end parameters as the port's state dict,
    and each update's losses."""
    space, momentum = LEARNER_CASES[case]
    spec = jax_dist.spec_for_space(space)
    jax_agent = _jax_agent(space)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_learner = JaxLearner(
            jax_agent, JaxHp(total_environment_frames=1e3,
                             rmsprop_momentum=momentum),
            mesh, FRAMES_PER_UPDATE, device_telemetry=False,
            learn_telemetry=False, scan_impl="pallas")
    batches = [_trajectory(seed, spec) for seed in range(UPDATES)]
    state = jax_learner.init(jax.random.key(0), _jax_traj(batches[0]))
    start = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    losses = []
    for d in batches:
        state, metrics = jax_learner.update(state, _jax_traj(d))
        losses.append({k: float(metrics[k]) for k in (
            "total_loss", "policy_gradient_loss", "baseline_loss",
            "entropy_loss", "learning_rate", "env_frames")})
    end = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))
    return start, end, losses


@pytest.mark.parametrize("scan_impl", ["associative", "pallas"])
@pytest.mark.parametrize("case", sorted(LEARNER_CASES))
def test_ten_updates_match_the_jax_learner(case, scan_impl):
    start, jax_end, jax_losses = _jax_learner_run(case)
    space, momentum = LEARNER_CASES[case]
    spec = jax_dist.spec_for_space(space)
    agent = ImpalaAgent(frame_shape=(16, 16, 3), core_size=H,
                        action_space=port_space(space))
    agent.load_state_dict(start)
    with (pytest.warns(UserWarning, match="un-lr-scaled") if momentum
          else contextlib.nullcontext()):
        learner = Learner(agent, LearnerHyperparams(
            total_environment_frames=1e3, rmsprop_momentum=momentum),
            FRAMES_PER_UPDATE, scan_impl=scan_impl)
    losses = [{k: float(v) for k, v in learner.update(_torch_traj(
        _trajectory(seed, spec))).items()} for seed in range(UPDATES)]
    torch_end = agent.state_dict()
    for want, got in zip(jax_losses, losses):
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    for name, begin in start.items():
        want = (jax_end[name] - begin).numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose((torch_end[name] - begin).numpy(), want,
                                   rtol=0, atol=1e-3 * scale, err_msg=name)


def test_momentum_zero_update_is_the_plain_update_bit_for_bit():
    """At rmsprop_momentum 0 the learner keeps no trace and its update is
    ``param - lr * g / sqrt(nu + eps)`` exactly, written out here on a
    twin from the same loss and gradients."""
    spec = distributions.spec_for_space(port_space(FAKE_TUPLE))
    traj = _torch_traj(_trajectory(30, spec))
    agent = ImpalaAgent(frame_shape=(16, 16, 3), core_size=H,
                        action_space=port_space(FAKE_TUPLE),
                        generator=torch.Generator().manual_seed(3))
    twin = copy.deepcopy(agent)
    hp = LearnerHyperparams(total_environment_frames=1e3)
    learner = Learner(agent, hp, FRAMES_PER_UPDATE)
    assert learner.state.momentum is None
    assert "momentum" not in learner.state_dict()
    reference = Learner(twin, hp, FRAMES_PER_UPDATE)
    total, _ = reference._loss_vtrace(traj)
    params = list(twin.parameters())
    grads = torch.autograd.grad(total, params)
    lr = hp.learning_rate
    with torch.no_grad():
        for param, grad, nu in zip(params, grads,
                                   reference.state.opt_state.values()):
            nu.mul_(hp.rmsprop_decay).add_((1.0 - hp.rmsprop_decay)
                                           * grad * grad)
            param.sub_(lr * (grad * torch.rsqrt(nu + hp.rmsprop_epsilon)))
    learner.update(traj)
    for (name, got), want in zip(agent.named_parameters(), params):
        assert torch.equal(got, want), name
    for name, nu in learner.state.opt_state.items():
        assert torch.equal(nu, reference.state.opt_state[name]), name


def test_momentum_trace_is_held_by_the_nonfinite_guard():
    spec = distributions.spec_for_space(spaces.Discrete(9))
    agent = ImpalaAgent(9, (16, 16, 3), core_size=H,
                        generator=torch.Generator().manual_seed(1))
    with pytest.warns(UserWarning, match="un-lr-scaled"):
        learner = Learner(agent, LearnerHyperparams(rmsprop_momentum=0.9),
                          FRAMES_PER_UPDATE)
    learner.update(_torch_traj(_trajectory(1, spec)))
    trace = {k: v.clone() for k, v in learner.state.momentum.items()}
    assert any(bool(v.any()) for v in trace.values())
    d = _trajectory(2, spec)
    d["reward"][1, 1] = np.nan
    metrics = learner.update(_torch_traj(d))
    assert float(metrics["update_skipped"]) == 1.0
    for name, value in learner.state.momentum.items():
        assert torch.equal(value, trace[name]), name


# -- (f) the transports ------------------------------------------------------


def test_composite_trajectory_packed_equals_per_leaf():
    spec = distributions.spec_for_space(port_space(FAKE_TUPLE))
    host = map_structure(lambda t: None if t is None else t.numpy(),
                         _torch_traj(_trajectory(5, spec)))
    cpu = torch.device("cpu")
    per_leaf, _ = PerLeafTransport(cpu).put(host)
    packed, _ = PackedTransport(cpu).put(host)
    assert per_leaf.agent_outputs.action.shape == (T + 1, B, 2)
    for a, b in zip(tree_leaves(packed), tree_leaves(per_leaf)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)



# -- (g) the driver ----------------------------------------------------------


def _cli_config(logdir, frames, momentum=0.9):
    return Config(level_name="fake_tuple", device="cpu", logdir=str(logdir),
                  height=16, width=16, num_actors=4, batch_size=2,
                  unroll_length=5, num_env_workers_per_group=1,
                  total_environment_frames=float(frames),
                  scan_impl="pallas", rmsprop_momentum=momentum,
                  log_interval_s=0.0)


@pytest.mark.filterwarnings("ignore:rmsprop_momentum")
def test_driver_trains_resumes_and_tests_fake_tuple(tmp_path, monkeypatch):
    config = _cli_config(tmp_path, 2 * 40)
    fpu = config.frames_per_update()
    assert fpu == 40
    metrics = driver.train(config)
    assert metrics["env_frames"] == 2 * fpu
    step, saved = CheckpointManager(str(tmp_path)).restore()
    assert step == 2 and sorted(saved["momentum"]) == sorted(
        saved["params"])
    restored = []
    load = Learner.load_state_dict

    def recording(self, state):
        load(self, state)
        restored.append({k: v.clone() for k, v in
                         self.state.momentum.items()})

    monkeypatch.setattr(Learner, "load_state_dict", recording)
    metrics = driver.train(dataclasses.replace(
        config, total_environment_frames=float(4 * fpu)))
    assert metrics["env_frames"] == 4 * fpu
    assert len(restored) == 1
    for name, value in saved["momentum"].items():
        assert torch.equal(restored[0][name], value), name
    step, again = CheckpointManager(str(tmp_path)).restore()
    assert step == 4 and again["env_frames"] == 4 * fpu
    returns = driver.test(dataclasses.replace(
        config, mode="test", test_num_episodes=3))["fake_tuple"]
    assert len(returns) == 3 and all(np.isfinite(returns))


@pytest.mark.filterwarnings("ignore:rmsprop_momentum")
@pytest.mark.parametrize("saved,resumed", [(0.9, 0.0), (0.0, 0.9)])
def test_resume_across_a_momentum_mismatch_raises(tmp_path, saved,
                                                  resumed):
    config = _cli_config(tmp_path, 40, momentum=saved)
    driver.train(config)
    with pytest.raises(ValueError, match="momentum trace"):
        driver.train(dataclasses.replace(
            config, rmsprop_momentum=resumed,
            total_environment_frames=80.0))


# -- (h) the FLOP counts -----------------------------------------------------


@pytest.mark.parametrize("name", ["fake_tuple",
                                  "doom_action_space_full_discretized"])
def test_update_flops_count_the_composite_logits(name):
    space = port_space(JAX_SPACES[name])
    spec = distributions.spec_for_space(space)
    agent = ImpalaAgent(frame_shape=(16, 16, 3), core_size=H,
                        action_space=space,
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(), FRAMES_PER_UPDATE)
    traj = _torch_traj(_trajectory(6, spec))
    with FlopCounterMode(display=False) as counter:
        learner.update(traj)
    want = update_flops((16, 16, 3), spec.num_logits, T, B, core_size=H)
    assert counter.get_total_flops() == pytest.approx(want, rel=0.01)
    assert want > update_flops((16, 16, 3), spec.num_components, T, B,
                               core_size=H)
    costs = kernels.handwritten_costs((16, 16, 3), spec.num_logits, T, B,
                                      core_size=H)
    d = 256 + 1 + spec.num_logits
    g = 4 * H
    assert costs["sgemm_kernel<true"]["flops_est"] == 2 * (T + 1) * B * d * g
