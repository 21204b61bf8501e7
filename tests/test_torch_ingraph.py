"""The port's in-graph backend (``scalable_agent_tpu_torch/runtime/
ingraph.py``, ``driver.train_ingraph``) held against the JAX package's.

- The trainer's twins of ``tests/test_device_env.py``'s
  ``TestInGraphTrainer`` and ``TestMegaloop``: frames counted,
  determinism, the T+1 overlap layout, K=8 bit-exact with 8 dispatches of
  1 (params, optimizer state, the last loss) with the episode stats summed
  over the K unrolls, and the constructor's and ``run``'s refusals.
- Parity with the live JAX ``InGraphTrainer`` on ``fake_small`` and
  ``device_grid_small`` (the JAX agent on its plain reference routes,
  ``core_impl``/``conv_backend`` ``xla``; the port on its kernels' plain
  versions): the samplers differ (threefry against ``torch.Generator``),
  so the draw is made certain, as in ``tests/test_torch_accum_actor.py``:
  the port's sampler hands back the JAX run's sampled actions in order.
  Then every trajectory's env side and actions are bitwise the JAX
  trainer's, its logits, baselines and start carries within rtol 1e-4
  (float32 sums in another order), and the parameters after 3 updates
  within the learner's float32 tolerance (``tests/test_torch_learner.py``:
  each leaf's change within 1e-3 of its largest change, or within 2
  float32 spacings of the leaf's largest parameter where the change is
  that small: a change is a difference of two float32 values).
- The driver under ``--train_backend=ingraph``: a resume, replay and the
  sentinel at K=1, the refusals (K>1 with either, ``--actor=service``:
  the twin of ``tests/test_service.py::test_ingraph_rejects_actor_service``),
  the twins of ``tests/test_sentinel.py``'s in-graph tests, a non-finite
  streak inside a dispatch seen through its peak, and a ``device_`` level
  through the host backend's pool.
- The learning twins of ``tests/test_learning.py`` (``-m slow``, as
  there).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs.device import make_device_env as jax_make
from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
from scalable_agent_tpu.parallel import MeshSpec, make_mesh
from scalable_agent_tpu.runtime import Learner as JaxLearner
from scalable_agent_tpu.runtime import LearnerHyperparams as JaxHp
from scalable_agent_tpu.runtime.ingraph import (
    InGraphTrainer as JaxInGraphTrainer,
)
from scalable_agent_tpu_torch import convert, driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs.device import (
    DeviceFakeEnv,
    make_device_env,
)
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.obs import get_flight_recorder, get_registry
from scalable_agent_tpu_torch.ops import distributions
from scalable_agent_tpu_torch.runtime import Learner, LearnerHyperparams
from scalable_agent_tpu_torch.runtime.faults import configure_faults
from scalable_agent_tpu_torch.runtime.ingraph import InGraphTrainer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU work here is small: one intra-op thread, so that the
    module does not fight the test runner's other workers for the cores
    (restored after the module)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


H = W = 12
NUM_ACTIONS = 4


@pytest.fixture(autouse=True)
def _clean_faults():
    configure_faults("")
    yield
    configure_faults("")


# -- the trainer -------------------------------------------------------------


def _trainer(k=1, emit_trajectory=False, T=5, B=4):
    agent = ImpalaAgent(num_actions=NUM_ACTIONS, frame_shape=(H, W, 3),
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=1e6), frames_per_update=T * B)
    env = DeviceFakeEnv(height=H, width=W, num_actions=NUM_ACTIONS,
                        episode_length=7)
    return learner, InGraphTrainer(agent, learner, env, T, B, seed=5,
                                   updates_per_dispatch=k,
                                   emit_trajectory=emit_trajectory)


class TestInGraphTrainer:
    T, B = 5, 4

    def test_fused_training_runs_and_counts_frames(self):
        _, trainer = _trainer()
        carry, metrics = trainer.run(trainer.init(), 4)
        assert np.isfinite(float(metrics["total_loss"]))
        assert float(metrics["env_frames"]) == 4 * self.T * self.B

    def test_deterministic(self):
        losses = []
        for _ in range(2):
            _, trainer = _trainer()
            _, metrics = trainer.run(trainer.init(), 3)
            losses.append(float(metrics["total_loss"]))
        assert losses[0] == losses[1]

    def test_unroll_overlap_layout(self):
        """Entry 0 of an unroll is the carried last entry of the one
        before."""
        _, trainer = _trainer()
        carry = trainer.init()
        generator = torch.Generator().manual_seed(1)
        traj1, rollout = trainer._rollout(carry.rollout, generator)
        traj2, _ = trainer._rollout(rollout, generator)
        assert torch.equal(traj1.env_outputs.observation.frame[self.T],
                           traj2.env_outputs.observation.frame[0])
        assert torch.equal(traj1.agent_outputs.action[self.T],
                           traj2.agent_outputs.action[0])
        assert torch.equal(traj1.env_outputs.reward[self.T],
                           traj2.env_outputs.reward[0])

    def test_publish_telemetry_publishes_the_fetch(self):
        """``publish_telemetry`` folds ``fetch_telemetry``'s one snapshot
        (the env's ``devtel/env/*`` and the learner's ``devtel/*``) into
        the registry: the env's step counter reads every agent step."""
        _, trainer = _trainer()
        carry, _ = trainer.run(trainer.init(), 2)
        fetched = trainer.fetch_telemetry(carry)
        env_keys = [k for k in fetched
                    if trainer._env_tel_spec.owns_key(k)]
        assert env_keys and len(env_keys) < len(fetched)
        published = trainer.publish_telemetry(carry)
        assert sorted(published) == sorted(fetched)
        for key, value in fetched.items():
            np.testing.assert_array_equal(published[key], value)
        snapshot = get_registry().snapshot()
        assert snapshot["devtel/env/steps"] == 2 * self.T * self.B


@pytest.mark.parametrize("sizes,batch", [((9,), (32,)), ((2,), (1,)),
                                         ((3, 5), (6, 4))])
def test_sample_is_multinomials_draw(sizes, batch):
    """``distributions.sample``'s exponential race is
    ``torch.multinomial(probs, 1)``'s own draw: the same actions from the
    same generator state, bitwise, over consecutive draws."""
    spec = distributions.DistributionSpec(sizes=sizes)
    rng = np.random.default_rng(7)
    generator = torch.Generator().manual_seed(11)
    twin = torch.Generator().manual_seed(11)
    for _ in range(4):
        logits = torch.from_numpy(3.0 * rng.standard_normal(
            batch + (spec.num_logits,)).astype(np.float32))
        got = distributions.sample(generator, logits, spec)
        want = []
        for chunk in torch.split(logits, sizes, dim=-1):
            probs = torch.softmax(chunk, dim=-1)
            want.append(torch.multinomial(
                probs.reshape(-1, probs.shape[-1]), 1,
                generator=twin).reshape(chunk.shape[:-1]))
        want = want[0] if len(sizes) == 1 else torch.stack(want, dim=-1)
        assert got.shape == batch + ((len(sizes),) if len(sizes) > 1
                                     else ())
        assert torch.equal(got, want)
    assert torch.equal(generator.get_state(), twin.get_state())


class TestMegaloop:
    T, B = 5, 4

    def test_k8_bit_exact_with_k1_and_episode_stats_aggregate(self):
        """1 dispatch of K=8 is 8 dispatches of K=1, bitwise, in params
        and optimizer state; its episode stats are the 8 unrolls' summed
        (episode_length 7 < the window's agent steps, so episodes end
        inside it), the return mean weighted across them."""
        learner1, t1 = _trainer(1)
        c1 = t1.init()
        counts, ret_sums = 0.0, 0.0
        for i in range(8):
            c1, m1 = t1.run(c1, 1, counter_start=i)
            n = float(m1["episodes_completed"])
            if n:
                counts += n
                ret_sums += n * float(m1["episode_return"])
        learner8, t8 = _trainer(8)
        c8, m8 = t8.run(t8.init(), 8)
        s1, s8 = learner1.state_dict(), learner8.state_dict()
        for group in ("params", "opt_state"):
            for name in s1[group]:
                assert torch.equal(s1[group][name], s8[group][name]), name
        assert float(m1["env_frames"]) == float(m8["env_frames"]) == (
            8 * self.T * self.B)
        assert torch.equal(m1["total_loss"], m8["total_loss"])
        assert counts > 0
        assert float(m8["episodes_completed"]) == counts
        np.testing.assert_allclose(float(m8["episode_return"]),
                                   ret_sums / counts, rtol=1e-6)
        # The rollout carry too: the same env states and the same carry.
        for a, b in zip(c1.rollout.core_state, c8.rollout.core_state):
            assert torch.equal(a, b)

    def test_run_rejects_misaligned_update_count(self):
        _, trainer = _trainer(4)
        with pytest.raises(ValueError, match="not divisible"):
            trainer.run(trainer.init(), 6)

    def test_constructor_rejects_bad_k_and_emit_with_k(self):
        with pytest.raises(ValueError, match="updates_per_dispatch"):
            _trainer(0)
        with pytest.raises(ValueError, match="emit_trajectory"):
            _trainer(2, emit_trajectory=True)

    def test_run_refuses_to_drop_emitted_trajectories(self):
        _, trainer = _trainer(1, emit_trajectory=True)
        carry = trainer.init()
        with pytest.raises(ValueError, match="on_trajectory"):
            trainer.run(carry, 2)
        collected = []
        carry, metrics = trainer.run(carry, 3,
                                     on_trajectory=collected.append)
        assert len(collected) == 3
        frame = collected[0].env_outputs.observation.frame
        assert frame.shape[:2] == (self.T + 1, self.B)
        assert np.isfinite(float(metrics["total_loss"]))

    def test_streak_peak_outlives_a_reset_inside_the_dispatch(self):
        """nan_grad@1:2 poisons updates 0 and 1 of a K=4 dispatch: the
        streak reads 0 at its end (two finite updates), its peak 2."""
        configure_faults("nan_grad@1:2")
        _, trainer = _trainer(4)
        _, metrics = trainer.run(trainer.init(), 4)
        assert float(metrics["nonfinite_streak"]) == 0.0
        assert float(metrics["nonfinite_streak_peak"]) == 2.0
        assert float(metrics["nonfinite_skips"]) == 2.0


# -- parity with the JAX trainer ---------------------------------------------

PARITY_T, PARITY_B, PARITY_UPDATES, PARITY_H = 5, 4, 3, 32
PARITY_FRAMES = 1e4  # short enough that the lr decay shows


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), tree,
        is_leaf=lambda x: x is None)


def _state_dict(params):
    """A flax parameter tree as the port's state dict, numpy values."""
    return {k: torch.as_tensor(v).numpy().copy()
            for k, v in convert.flax_to_state_dict(_numpy_tree(
                params)).items()}


def _parity_runs(level):
    """The JAX trainer's 3 updates (its trajectories, start and end
    params), then the port's on the same start params with the JAX run's
    actions handed to its sampler."""
    jenv = jax_make(level)
    frame = tuple(jenv.observation_spec.frame.shape)
    jagent = JaxAgent(num_actions=jenv.num_actions, core_size=PARITY_H,
                      core_impl="xla", conv_backend="xla")
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jlearner = JaxLearner(
        jagent, JaxHp(total_environment_frames=PARITY_FRAMES), mesh,
        PARITY_T * PARITY_B, device_telemetry=False, learn_telemetry=False)
    jtrainer = JaxInGraphTrainer(jagent, jlearner, jenv, PARITY_T,
                                 PARITY_B, seed=5, emit_trajectory=True)
    state, carry = jtrainer.init(jax.random.key(0))
    start = _state_dict(state.params)
    want = []
    state, carry, _ = jtrainer.run(
        state, carry, PARITY_UPDATES,
        on_trajectory=lambda t: want.append(_numpy_tree(t)))
    end = _state_dict(state.params)

    agent = ImpalaAgent(num_actions=jenv.num_actions, frame_shape=frame,
                        core_size=PARITY_H)
    agent.load_state_dict({k: torch.as_tensor(v) for k, v in start.items()})
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=PARITY_FRAMES), PARITY_T * PARITY_B)
    trainer = InGraphTrainer(agent, learner, make_device_env(level),
                             PARITY_T, PARITY_B, seed=5,
                             emit_trajectory=True)
    feed = iter([row for t in want for row in t.agent_outputs.action[1:]])
    original = distributions.sample
    distributions.sample = lambda generator, logits, spec: torch.tensor(
        next(feed), dtype=torch.int64)
    try:
        got = []
        trainer.run(trainer.init(), PARITY_UPDATES,
                    on_trajectory=lambda t: got.append(t))
    finally:
        distributions.sample = original
    assert next(feed, None) is None, "the port sampled fewer steps"
    return start, end, want, got, {
        k: v.detach().clone() for k, v in agent.state_dict().items()}


@pytest.fixture(scope="module", params=["fake_small", "device_grid_small"])
def parity(request):
    return _parity_runs(request.param)


def test_trajectories_match_the_jax_trainer(parity):
    _, _, want, got, _ = parity
    assert len(got) == len(want) == PARITY_UPDATES
    for update, (g, w) in enumerate(zip(got, want)):
        msg = f"update {update}"
        env_g, env_w = g.env_outputs, w.env_outputs
        for name, a, b in (
                ("frame", env_g.observation.frame, env_w.observation.frame),
                ("reward", env_g.reward, env_w.reward),
                ("done", env_g.done, env_w.done),
                ("episode_return", env_g.info.episode_return,
                 env_w.info.episode_return),
                ("episode_step", env_g.info.episode_step,
                 env_w.info.episode_step),
                ("action", g.agent_outputs.action,
                 w.agent_outputs.action)):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"{msg} {name}")
        for name, a, b in (
                ("logits", g.agent_outputs.policy_logits,
                 w.agent_outputs.policy_logits),
                ("baseline", g.agent_outputs.baseline,
                 w.agent_outputs.baseline),
                ("c", g.agent_state.c, w.agent_state.c),
                ("h", g.agent_state.h, w.agent_state.h)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{msg} {name}")


def test_params_after_three_updates_match_the_jax_trainer(parity):
    start, end, _, _, got = parity
    for name, want_end in end.items():
        want = want_end - start[name]
        change = got[name].numpy() - start[name]
        # A change is the difference of two float32 parameters: it is
        # known to 2 spacings of the leaf's largest value, beside 1e-3 of
        # its largest change.
        spacing = float(np.spacing(np.abs(start[name]).max()))
        atol = max(1e-3 * float(np.abs(want).max()), 2 * spacing)
        np.testing.assert_allclose(change, want, rtol=0, atol=atol,
                                   err_msg=name)


# -- the driver --------------------------------------------------------------


def _ingraph_config(tmp_path, name="run", **overrides):
    base = dict(
        mode="train", device="cpu", logdir=str(tmp_path / name),
        level_name="fake_small", train_backend="ingraph", num_actors=4,
        batch_size=4, unroll_length=5, num_action_repeats=1, height=16,
        width=16, total_environment_frames=160,  # 8 updates of 20 frames
        compute_dtype="float32", checkpoint_interval_s=1e9,
        log_interval_s=0.0, seed=7)
    base.update(overrides)
    return Config(**base)


def _counter(name):
    return float(get_registry().snapshot().get(name, 0.0))


def test_resume_continues_from_the_checkpoint(tmp_path):
    """A run to 4 updates, then the same logdir to 8: the second run
    restores update 4 and adds 4 (the registry's update counter); the
    rows carry on from step 4."""
    config = _ingraph_config(tmp_path, total_environment_frames=80,
                             updates_per_dispatch=2)
    assert driver.train(config)["env_frames"] == 80
    before = _counter("learner/updates_total")
    metrics = driver.train(_ingraph_config(tmp_path, updates_per_dispatch=2))
    assert metrics["env_frames"] == 160
    assert _counter("learner/updates_total") - before == 4
    steps = [json.loads(line)["step"] for line in
             open(os.path.join(config.logdir, "metrics.jsonl"))
             if "total_loss" in line]
    assert steps[-1] == 8 and 6 in steps


def test_replay_at_k1_runs_replayed_updates(tmp_path):
    before = _counter("learner/replayed_updates_total")
    metrics = driver.train(_ingraph_config(
        tmp_path, total_environment_frames=80, replay_ratio=1,
        replay_capacity=4))
    assert metrics["env_frames"] == 80
    assert _counter("learner/replayed_updates_total") - before == 4
    assert np.isfinite(metrics["total_loss"])


def test_sentinel_at_k1_audits(tmp_path):
    before = _counter("devtel/sentinel/audits_total")
    metrics = driver.train(_ingraph_config(
        tmp_path, total_environment_frames=80, sentinel_interval=2))
    assert metrics["env_frames"] == 80
    assert _counter("devtel/sentinel/audits_total") - before == 2


@pytest.mark.parametrize("overrides,match", [
    (dict(updates_per_dispatch=2, replay_ratio=1), "updates_per_dispatch"),
    (dict(updates_per_dispatch=2, sentinel_interval=2), "sentinel"),
    (dict(actor="service"), "no host actor pipeline"),
    (dict(train_backend="bogus"), "unknown train_backend"),
])
def test_driver_refusals(tmp_path, overrides, match):
    with pytest.raises(ValueError, match=match):
        driver.train(_ingraph_config(tmp_path, **overrides))
    assert not os.path.exists(tmp_path / "run" / "metrics.jsonl")


def test_ingraph_rejects_actor_service(tmp_path):
    """The twin of ``tests/test_service.py``'s test of the same name."""
    config = Config(mode="train", device="cpu", logdir=str(tmp_path / "run"),
                    level_name="fake_small", train_backend="ingraph",
                    actor="service")
    with pytest.raises(ValueError, match="no host actor pipeline"):
        driver.train(config)


def _sentinel_config(tmp_path, **overrides):
    """``tests/test_sentinel.py``'s configuration (6 updates of 8 frames,
    audits after updates 2, 4 and 6) on the port."""
    base = dict(
        mode="train", logdir=str(tmp_path / "run"), device="cpu",
        level_name="fake_small", num_actors=4, batch_size=2,
        unroll_length=4, num_action_repeats=1, total_environment_frames=48,
        height=16, width=16, num_env_workers_per_group=2,
        compute_dtype="float32", checkpoint_interval_s=0.0,
        log_interval_s=0.0, seed=5, sentinel_interval=2)
    base.update(overrides)
    return Config(**base)


def test_ingraph_megaloop_with_sentinel_rejected(tmp_path):
    """The twin of ``tests/test_sentinel.py``'s test of the same name."""
    config = _sentinel_config(tmp_path, train_backend="ingraph",
                              updates_per_dispatch=8)
    with pytest.raises(ValueError, match="sentinel"):
        driver.train(config)


def test_ingraph_kernel_miscompute_detect_demote_finish(tmp_path):
    """The twin of ``tests/test_sentinel.py``'s test of the same name:
    the first audit breaches (a 2x gradient), the ladder demotes one rung,
    the trainer runs the rebuilt pair and the run finishes in-graph."""
    names = ("sentinel/trips_total", "sentinel/demotions_total",
             "devtel/sentinel/audits_total",
             "devtel/sentinel/breaches_total", "faults/injected_total")
    before = {name: _counter(name) for name in names}
    metrics = driver.train(_sentinel_config(
        tmp_path, train_backend="ingraph",
        chaos_spec="kernel_miscompute@1"))
    assert metrics["env_frames"] == 48
    assert np.isfinite(metrics["total_loss"])
    delta = {name: _counter(name) - before[name] for name in names}
    assert delta == {"sentinel/trips_total": 1.0,
                     "sentinel/demotions_total": 1.0,
                     "devtel/sentinel/audits_total": 3.0,
                     "devtel/sentinel/breaches_total": 1.0,
                     "faults/injected_total": 1.0}
    assert _counter("sentinel/rung") == 1.0
    names = {(e["kind"], e["name"])
             for e in get_flight_recorder().snapshot()}
    assert ("sentinel_trip", "demote") in names


def test_nan_grad_is_keyed_on_the_update_index(tmp_path):
    """``nan_grad@2`` skips exactly the second update, whatever the K."""
    for k in (1, 2):
        metrics = driver.train(_ingraph_config(
            tmp_path, name=f"k{k}", total_environment_frames=80,
            updates_per_dispatch=k, chaos_spec="nan_grad@2"))
        assert metrics["nonfinite_skips"] == 1.0
        assert metrics["nonfinite_streak"] == 0.0


def test_device_level_through_the_host_pool(tmp_path):
    """A ``device_`` level on the host backend: the pool's env workers run
    the host twin (the world on the CPU in each worker)."""
    metrics = driver.train(Config(
        mode="train", device="cpu", logdir=str(tmp_path / "run"),
        level_name="device_minatar_breakout", num_actors=4, batch_size=4,
        unroll_length=5, num_action_repeats=1,
        total_environment_frames=60, num_env_workers_per_group=2,
        compute_dtype="float32", log_interval_s=0.0,
        checkpoint_interval_s=1e9))
    assert metrics["env_frames"] == 60
    assert np.isfinite(metrics["total_loss"])


# -- learning (tests/test_learning.py's in-graph twins) ----------------------

BANDIT_RANDOM = 4.0
MEMORY_RANDOM = 2.0


@pytest.mark.slow
def test_ingraph_driver_learns_bandit(tmp_path):
    """fake_bandit learns through ``--train_backend=ingraph``: the JAX
    test's run and curve (early rows near the random floor 4, late rows
    at least 8 and at least 4 above early)."""
    updates, t, b = 250, 16, 16
    driver.train(Config(
        mode="train", device="cpu", level_name="fake_bandit",
        logdir=str(tmp_path), height=16, width=16, num_actors=32,
        batch_size=b, unroll_length=t, num_action_repeats=1,
        total_environment_frames=float(updates * t * b),
        learning_rate=0.002, entropy_cost=0.003, log_interval_s=0.2,
        checkpoint_interval_s=3600.0, train_backend="ingraph",
        compute_dtype="float32"))
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    returns = [row["episode_return"] for row in rows
               if "episode_return" in row]
    assert len(returns) >= 8, returns
    early, late = np.mean(returns[:3]), np.mean(returns[-5:])
    assert early < 1.6 * BANDIT_RANDOM, early
    assert late >= 2.0 * BANDIT_RANDOM, late
    assert late - early >= BANDIT_RANDOM, (early, late)


def _ingraph_harness(episode_length, reward_mode, updates, batch=32):
    """A real in-graph run on a ``DeviceFakeEnv``: the mean of the last 5
    updates' episode returns."""
    t = 16
    env = DeviceFakeEnv(height=16, width=16, num_actions=4,
                        episode_length=episode_length,
                        reward_mode=reward_mode)
    agent = ImpalaAgent(num_actions=4, frame_shape=(16, 16, 3),
                        generator=torch.Generator().manual_seed(0))
    learner = Learner(agent, LearnerHyperparams(
        total_environment_frames=float(updates * t * batch),
        learning_rate=0.002, entropy_cost=0.003), t * batch)
    trainer = InGraphTrainer(agent, learner, env, t, batch, seed=3)
    carry = trainer.init()
    tail = []
    for u in range(updates):
        carry, metrics = trainer.train_step(carry, u)
        if u >= updates - 5:
            tail.append(float(metrics["episode_return"]))
    return float(np.mean(tail))


@pytest.mark.slow
def test_sign_flipped_advantage_unlearns(monkeypatch):
    """Negating the policy-gradient advantage drives the return below the
    random floor: the learning tests catch a sign flip."""
    from scalable_agent_tpu_torch.ops import losses as losses_lib

    original = losses_lib.compute_policy_gradient_loss

    def flipped(logits, actions, advantages, *args, **kwargs):
        return original(logits, actions, -advantages, *args, **kwargs)

    monkeypatch.setattr(losses_lib, "compute_policy_gradient_loss", flipped)
    final = _ingraph_harness(16, "bandit", updates=120)
    assert final < 0.75 * BANDIT_RANDOM, (
        f"sign-flipped advantage still returned {final:.2f}")


@pytest.mark.slow
def test_memory_task_needs_done_reset(monkeypatch):
    """fake_memory (the cue only in an episode's first frame) trains
    through the core's done-reset; with the reset broken (the carry never
    zeroed at a boundary) learning stalls far below the healthy run."""
    import scalable_agent_tpu_torch.models.agent as agent_mod

    updates = 350
    healthy = _ingraph_harness(8, "memory", updates)
    assert healthy >= 3.0 * MEMORY_RANDOM, (
        f"healthy memory run only reached {healthy:.2f}")
    original = agent_mod.lstm_unroll

    def no_reset(x, done, *args, **kwargs):
        return original(x, torch.zeros_like(done), *args, **kwargs)

    monkeypatch.setattr(agent_mod, "lstm_unroll", no_reset)
    broken = _ingraph_harness(8, "memory", updates)
    assert broken <= healthy - MEMORY_RANDOM, (
        f"breaking the done-reset did not hurt the memory task (healthy "
        f"{healthy:.2f}, broken {broken:.2f})")
