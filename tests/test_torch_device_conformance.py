"""The DeviceEnv conformance matrix on the port: every registered level x
every check (``scalable_agent_tpu_torch/envs/device/conformance.py``).

The twin of ``tests/test_device_conformance.py``: the matrix, the
harness's edge cases (the jittered fake at its seed bound, sticky
breakout, action repeats on a real world), and the broken-env controls
that prove the checks can fail: broken episode accounting, tensors shared
between leaves (the storage rule in place of JAX's donation), state that
depends on the call (the determinism check) and a host read in the step
(the CPU spy standing in for the card's sync debug mode).

``CONFORMANCE_LEVELS`` is explicit, not computed: a level registered
without its row, or a row without its level, fails
``test_conformance_levels_cover_the_registry``.  Each level's rollout is
also held against the JAX world's jitted rollout on the same seeds and
actions, bitwise (arrays compared; nothing of the JAX harness's
``jaxlib.xla_extension`` spy is used).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs.device import make_device_env as jax_make
from scalable_agent_tpu_torch.envs.device import (
    DEVICE_LEVELS,
    DeviceFakeEnv,
    conformance,
    make_device_env,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU work here is small: one intra-op thread, so that the
    module does not fight the test runner's other workers for the cores
    (restored after the module)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


CONFORMANCE_LEVELS = (
    "device_grid_large",
    "device_grid_small",
    "device_minatar_asterix",
    "device_minatar_breakout",
    "fake_bandit",
    "fake_benchmark",
    "fake_memory",
    "fake_small",
)


def test_conformance_levels_cover_the_registry():
    assert set(CONFORMANCE_LEVELS) == set(DEVICE_LEVELS), (
        "CONFORMANCE_LEVELS and DEVICE_LEVELS diverged: every registered "
        "device level carries the whole conformance matrix")


@pytest.mark.parametrize("check", sorted(conformance.CHECKS))
@pytest.mark.parametrize("level", CONFORMANCE_LEVELS)
def test_level_conformance(level, check):
    conformance.CHECKS[check](lambda: make_device_env(level))


@pytest.mark.parametrize("level", CONFORMANCE_LEVELS)
def test_level_rollout_matches_jitted_jax_rollout(level):
    """The harness's whole-rollout function against the JAX world's
    ``lax.scan`` rollout under ``jit``: every output leaf bitwise."""
    env = make_device_env(level)
    jenv = jax_make(level)
    seeds = conformance.conformance_seeds(env, 4)
    actions = np.random.default_rng(5).integers(
        0, env.num_actions, size=(24, 4))
    state, _ = env.initial(seeds)
    _, outs = conformance.rollout(env, state, torch.as_tensor(actions))
    jstate, _ = jenv.initial(seeds)
    _, jouts = jax.jit(lambda s, a: jax.lax.scan(jenv.step, s, a))(
        jstate, jnp.asarray(actions, jnp.int32))
    got = conformance.leaves(outs)
    want = jax.tree_util.tree_leaves(jouts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- edge cases of the harness ------------------------------------------------


def test_jittered_fake_runs_the_full_harness_at_the_seed_bound():
    def factory():
        return make_device_env("fake_small", length_jitter=3)

    env = factory()
    assert env.max_seed == (2**31 - 1) // 1000003
    seeds = conformance.conformance_seeds(env, 4)
    assert seeds.max() == env.max_seed
    assert (seeds >= 0).all() and (seeds <= env.max_seed).all()
    conformance.run_conformance(factory)


def test_sticky_action_breakout_passes_conformance():
    conformance.run_conformance(
        lambda: make_device_env("device_minatar_breakout",
                                sticky_prob=0.25))


def test_action_repeats_pass_conformance_on_a_real_world():
    conformance.run_conformance(
        lambda: make_device_env("device_grid_small", num_action_repeats=3))


# -- the controls: the harness can fail ---------------------------------------


class _BrokenAccountingEnv(DeviceFakeEnv):
    """Emits episode_step 0 on done rows: `done & episode_step > 0` then
    misses every episode."""

    def step(self, state, action):
        state, out = super().step(state, action)
        info = out.info._replace(episode_step=torch.where(
            out.done, 0, out.info.episode_step))
        return state, out._replace(info=info)


def test_harness_catches_broken_episode_accounting():
    with pytest.raises(AssertionError, match="episode_step"):
        conformance.check_autoreset(
            lambda: _BrokenAccountingEnv(height=8, width=8,
                                         episode_length=5))


class _AliasedBufferEnv(DeviceFakeEnv):
    """initial() shares one tensor between two state leaves."""

    def initial(self, seeds, device=None):
        state, out = super().initial(seeds, device)
        return state._replace(episode=state.step), out


def test_harness_catches_aliased_initial_buffers():
    with pytest.raises(AssertionError, match="donate"):
        conformance.check_donation(
            lambda: _AliasedBufferEnv(height=8, width=8, episode_length=5))


class _CallCountEnv(DeviceFakeEnv):
    """Bakes a count of its calls into the frames: a per-step loop and a
    rollout from a new instance see other offsets."""

    _calls = [0]

    def step(self, state, action):
        self._calls[0] += 1
        state, out = super().step(state, action)
        frame = out.observation.frame + (self._calls[0] % 7)
        return state, out._replace(
            observation=out.observation._replace(frame=frame))


def test_harness_catches_call_dependent_state():
    _CallCountEnv._calls[0] = 0
    with pytest.raises(AssertionError, match="diverges"):
        conformance.check_determinism(
            lambda: _CallCountEnv(height=8, width=8, episode_length=5))


class _HostReadEnv(DeviceFakeEnv):
    """Branches on a device value in its step: a host sync on the card."""

    def step(self, state, action):
        state, out = super().step(state, action)
        if bool(out.done.any()):
            out = out._replace(reward=out.reward + 0.0)
        return state, out


def test_harness_catches_a_host_read_in_the_step():
    with pytest.raises(AssertionError, match="read device values"):
        conformance.check_zero_host_sync(
            lambda: _HostReadEnv(height=8, width=8, episode_length=5))
