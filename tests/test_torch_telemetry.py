"""The port's device telemetry held against the live JAX package.

- ``DeviceTelemetry``: one spec and one sequence of inc/set/observe
  (masked and non-finite values among them) gives the same fetched dict,
  bucket counts exact, and the publisher the same ``devtel/*`` registry.
- The learner's telemetry: one update of a live JAX ``Learner`` (one-device
  CPU mesh, both specs on) and of the port's, from weights carried across
  by ``convert.py``, on one numpy trajectory made from a seed at a small
  size (16x16 frames, LSTM 32, T=5, B=4): every ``devtel/learner/*`` and
  ``devtel/learn/*`` value within 1e-5 relative (float32), bucket counts
  exact.
- ``convert.layer_group`` puts each parameter in the group of the flax
  module it comes from, by the JAX learner's ``_layer_group``.
- ``update_flops`` equals ``FlopCounterMode``'s count of the plain CPU
  update at two shapes within 1%.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from scalable_agent_tpu import obs as jax_obs
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.obs import device_telemetry as jax_devtel
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime import learner as jax_learner_lib
from scalable_agent_tpu.runtime import Trajectory as JaxTrajectory
from scalable_agent_tpu.types import AgentOutput as JaxAgentOutput
from scalable_agent_tpu.types import AgentState as JaxAgentState
from scalable_agent_tpu.types import Observation as JaxObservation
from scalable_agent_tpu.types import StepOutput as JaxStepOutput
from scalable_agent_tpu.types import StepOutputInfo as JaxStepOutputInfo
from scalable_agent_tpu_torch import convert, obs
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import device_telemetry
from scalable_agent_tpu_torch.runtime import (
    Learner,
    LearnerHyperparams,
    Trajectory,
)
from scalable_agent_tpu_torch.runtime.learner import (
    learner_telemetry_spec,
    learning_telemetry_spec,
    update_flops,
)
from scalable_agent_tpu_torch.types import (
    AgentOutput,
    AgentState,
    Observation,
    StepOutput,
    StepOutputInfo,
)

A, H, T, B = 5, 32, 5, 4
RTOL = 1e-5


def _spec(package):
    return (package.DeviceTelemetry("unit")
            .counter("steps").gauge("last")
            .histogram("norm", (0.1, 1.0, 10.0)))


def _drive_spec(spec, tel, as_array):
    values = as_array([0.05, 0.1, 0.5, 1.0, 3.0, 10.0, 11.0, np.nan])
    mask = as_array([True] * 7 + [False]) > 0
    tel = spec.inc(tel, "steps")
    tel = spec.inc(tel, "steps", as_array(2.5))
    tel = spec.set(tel, "last", as_array(-4.0))
    tel = spec.observe(tel, "norm", values, where=mask)
    tel = spec.observe(tel, "norm", as_array(1e6))
    return tel


def test_device_telemetry_matches_jax():
    ours_spec, jax_spec = _spec(device_telemetry), _spec(jax_devtel)
    ours = ours_spec.fetch(_drive_spec(
        ours_spec, ours_spec.init("cpu"),
        lambda v: torch.tensor(v, dtype=torch.float32)))
    import jax.numpy as jnp

    theirs = jax_spec.fetch(_drive_spec(
        jax_spec, jax_spec.init(), lambda v: jnp.asarray(v, jnp.float32)))
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    norm = ours_spec.value(ours, "norm")
    assert list(norm["buckets"]) == [2.0, 2.0, 2.0, 2.0]
    assert norm["count"] == 8.0 and ours_spec.value(ours, "steps") == 3.5
    registries = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    device_telemetry.TelemetryPublisher(ours_spec,
                                        registries[0]).publish(ours)
    jax_devtel.TelemetryPublisher(jax_spec, registries[1]).publish(theirs)
    assert registries[0].snapshot() == registries[1].snapshot()


def test_merged_specs_fetch_in_one_copy(monkeypatch):
    specs = [_spec(device_telemetry), learner_telemetry_spec()]
    tel = device_telemetry.merge_init(specs, "cpu")
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(1) or real(
                            self, *a, **k))
    fetched = device_telemetry.fetch_merged(specs, tel)
    assert len(copies) == 1 and set(fetched) == set(tel)
    with pytest.raises(ValueError, match="collision"):
        device_telemetry.merge_init([_spec(device_telemetry)] * 2)


def test_specs_declare_the_jax_instruments():
    for ours, theirs in (
            (learner_telemetry_spec(),
             jax_learner_lib.learner_telemetry_spec()),
            (learning_telemetry_spec(),
             jax_learner_lib.learning_telemetry_spec("vtrace"))):
        assert ours.namespace == theirs.namespace
        assert ours.counters() == theirs.counters()
        assert ours.gauges() == theirs.gauges()
        assert ours.histograms() == theirs.histograms()


def test_layer_groups_follow_the_jax_rule():
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    flax = convert.state_dict_to_flax(agent.state_dict())
    jax_groups = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(flax)[0]:
        keys = [str(getattr(p, "key", p)) for p in path][1:]
        jax_groups["/".join(keys)] = jax_learner_lib._layer_group(path)
    for name, _ in agent.named_parameters():
        module = name.rsplit(".", 1)[0].replace(".", "/")
        # The flax leaves each port parameter is made of.
        sources = [p for p in jax_groups
                   if p.startswith(module + "/") or (
                       module == "core" and p.startswith("core/lstm/"))]
        assert sources, name
        assert {jax_groups[p] for p in sources} == {
            convert.layer_group(name)}, name
    assert convert.LAYER_GROUPS == jax_learner_lib.LAYER_GROUPS


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return dict(
        c=f32(B, H, scale=0.5), h=np.tanh(f32(B, H)),
        reward=f32(T + 1, B, scale=2.0),
        done=rng.random((T + 1, B)) < 0.25,
        frame=rng.integers(0, 256, (T + 1, B, 16, 16, 3), dtype=np.uint8),
        action=rng.integers(0, A, (T + 1, B)),
        logits=f32(T + 1, B, A, scale=0.3),
        baseline=f32(T + 1, B))


def _jax_update(d):
    agent = JaxAgent(num_actions=A, core_size=H, core_impl="pallas",
                     conv_backend="pallas")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    learner = JaxLearner(agent, JaxHp(total_environment_frames=1e3), mesh,
                         T * B * 4, scan_impl="pallas")
    zeros = np.zeros((T + 1, B), np.float32)
    traj = JaxTrajectory(
        agent_state=JaxAgentState(c=d["c"], h=d["h"]),
        env_outputs=JaxStepOutput(
            reward=d["reward"],
            info=JaxStepOutputInfo(zeros, zeros.astype(np.int32)),
            done=d["done"], observation=JaxObservation(frame=d["frame"])),
        agent_outputs=JaxAgentOutput(
            action=d["action"].astype(np.int32),
            policy_logits=d["logits"], baseline=d["baseline"]))
    state = learner.init(jax.random.key(0), traj)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    learner.update(state, traj)
    registry = jax_obs.MetricsRegistry()
    fetched = learner.fetch_device_telemetry()
    jax_devtel.TelemetryPublisher(learner.devtel_specs,
                                  registry).publish(fetched)
    return params, fetched, registry.snapshot()


def _torch_update(d, params):
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    agent.load_state_dict(convert.flax_to_state_dict(params))
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=1e3), T * B * 4, scan_impl="pallas")
    t = {k: torch.tensor(v) for k, v in d.items()}
    zeros = torch.zeros((T + 1, B))
    learner.update(Trajectory(
        agent_state=AgentState(c=t["c"], h=t["h"]),
        env_outputs=StepOutput(
            reward=t["reward"], info=StepOutputInfo(zeros, zeros),
            done=t["done"], observation=Observation(frame=t["frame"])),
        agent_outputs=AgentOutput(action=t["action"],
                                  policy_logits=t["logits"],
                                  baseline=t["baseline"])))
    registry = obs.MetricsRegistry()
    fetched = learner.fetch_device_telemetry()
    device_telemetry.TelemetryPublisher(learner.devtel_specs,
                                        registry).publish(fetched)
    return fetched, registry.snapshot()


@pytest.fixture(scope="module")
def updates():
    d = _batch()
    params, jax_fetched, jax_snap = _jax_update(d)
    fetched, snap = _torch_update(d, params)
    return fetched, snap, jax_fetched, jax_snap


def test_learner_telemetry_matches_the_jax_learner(updates):
    fetched, snap, jax_fetched, jax_snap = updates
    assert fetched.keys() == jax_fetched.keys()
    assert snap.keys() == jax_snap.keys()
    assert any(k.startswith("devtel/learn/") for k in snap)
    for key, want in jax_snap.items():
        got = snap[key]
        if "/bucket/" in key or key.endswith(("_total", "/count")):
            assert got == want, key  # counts are exact
        else:
            assert abs(got - want) <= RTOL * max(abs(want), 1e-3), (
                key, got, want)
    assert snap["devtel/learner/updates"] == 1.0
    assert snap["devtel/learner/grad_norm/count"] == 1.0


def test_learning_telemetry_is_not_trivial(updates):
    """The batch is off-policy enough that every diagnostic is live."""
    _, snap, _, _ = updates
    for name in ("kl", "rho_clip_fraction", "log_rho_p95",
                 "grad_norm_torso", "grad_norm_core", "grad_norm_heads",
                 "update_ratio_core", "entropy_frac"):
        assert snap[f"devtel/learn/{name}"] != 0.0, name
    assert 0.0 <= snap["devtel/learn/dead_torso_frac"] <= 1.0


def test_learn_telemetry_off_keeps_only_the_learner_spec():
    agent = ImpalaAgent(A, (16, 16, 3), core_size=H)
    learner = Learner(agent, LearnerHyperparams(), T * B * 4,
                      learn_telemetry=False)
    assert [s.namespace for s in learner.devtel_specs] == ["learner"]
    assert all(k.split("/")[0] in ("c:learner", "g:learner", "h:learner")
               for k in learner.fetch_device_telemetry())


@pytest.mark.parametrize("frame,t,b,hidden", [((16, 16, 3), 4, 3, 16),
                                              ((24, 32, 3), 2, 2, 32)])
def test_update_flops_match_the_flop_counter(frame, t, b, hidden):
    """The counter sees the plain CPU update's products and convolutions;
    the difference is within 1% (there is none at these shapes: the
    plain BPTT computes dx and dh for every step, and the stem's input
    gradient is never taken, as the count assumes)."""
    agent = ImpalaAgent(A, frame, core_size=hidden,
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(), t * b * 4)
    rng = np.random.default_rng(1)
    zeros = torch.zeros((t + 1, b))
    traj = Trajectory(
        agent_state=AgentState(c=torch.zeros(b, hidden),
                               h=torch.zeros(b, hidden)),
        env_outputs=StepOutput(
            reward=torch.tensor(rng.standard_normal((t + 1, b)),
                                dtype=torch.float32),
            info=StepOutputInfo(zeros, zeros),
            done=torch.tensor(rng.random((t + 1, b)) < 0.2),
            observation=Observation(frame=torch.tensor(rng.integers(
                0, 256, (t + 1, b) + frame, dtype=np.uint8)))),
        agent_outputs=AgentOutput(
            action=torch.tensor(rng.integers(0, A, (t + 1, b))),
            policy_logits=torch.zeros((t + 1, b, A)),
            baseline=torch.zeros((t + 1, b))))
    with FlopCounterMode(display=False) as counter:
        learner.update(traj)
    want = update_flops(frame, A, t, b, core_size=hidden)
    assert counter.get_total_flops() == pytest.approx(want, rel=0.01)
