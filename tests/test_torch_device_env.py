"""The port's ``DeviceFakeEnv`` (``scalable_agent_tpu_torch/envs/device/
fake.py``) against the host stack and the JAX package's mirror.

The twins of ``tests/test_device_env.py``'s env tests: the device mirror
is transition-exact against the port's host stack
``ImpalaStream(StreamAdapter(FakeEnv))`` (frames and dones bitwise, rewards
and returns at rtol 1e-6, the JAX file's tolerance: the host sums a
step's rewards in float64, the mirror in float32), across episode
boundaries, action repeats, length jitter and the three reward modes, and
at seeds far past int32's overflow of ``seed * 131``.  Beside them, every
leaf of the mirror's (state, output) equals the JAX ``DeviceFakeEnv``'s,
bitwise, the seed bound's edge included.  The trainer's twins are in
``tests/test_torch_ingraph.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.envs.device import DeviceFakeEnv as JaxDeviceFakeEnv
from scalable_agent_tpu_torch.envs.core import ImpalaStream, StreamAdapter
from scalable_agent_tpu_torch.envs.device import DeviceFakeEnv, conformance
from scalable_agent_tpu_torch.envs.fake import FakeEnv


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


def host_streams(seeds, episode_length, jitter, repeats,
                 reward_mode="schedule"):
    return [ImpalaStream(StreamAdapter(FakeEnv(
        height=H, width=W, num_actions=NUM_ACTIONS,
        episode_length=episode_length, length_jitter=jitter, seed=s,
        num_action_repeats=repeats, reward_mode=reward_mode)))
        for s in seeds]


def _check_against_host(dev, seeds, streams, steps, rng_seed):
    state, out = dev.initial(np.asarray(seeds, np.int32))
    host_outs = [s.initial() for s in streams]
    rng = np.random.default_rng(rng_seed)
    for t in range(steps):
        for i, h in enumerate(host_outs):
            np.testing.assert_array_equal(
                out.observation.frame[i].numpy(),
                np.asarray(h.observation.frame),
                err_msg=f"frame mismatch env {i} step {t}")
            assert bool(out.done[i]) == bool(h.done), (i, t)
            np.testing.assert_allclose(float(out.reward[i]),
                                       float(h.reward), rtol=1e-6)
            np.testing.assert_allclose(
                float(out.info.episode_return[i]),
                float(h.info.episode_return), rtol=1e-6)
            assert int(out.info.episode_step[i]) == int(
                h.info.episode_step), (i, t)
        actions = rng.integers(0, NUM_ACTIONS, size=len(seeds))
        state, out = dev.step(state, torch.as_tensor(actions))
        host_outs = [s.step(int(a)) for s, a in zip(streams, actions)]
    for s in streams:
        s.close()


@pytest.mark.parametrize("repeats,jitter,reward_mode", [
    (1, 0, "schedule"), (4, 0, "schedule"), (4, 3, "schedule"),
    (1, 0, "bandit"), (3, 0, "bandit"),
    (1, 0, "memory"), (3, 0, "memory"),
])
def test_device_env_mirrors_host_stack(repeats, jitter, reward_mode):
    seeds = [0, 3, 11]
    dev = DeviceFakeEnv(height=H, width=W, num_actions=NUM_ACTIONS,
                        episode_length=5, length_jitter=jitter,
                        num_action_repeats=repeats, reward_mode=reward_mode)
    _check_against_host(dev, seeds, host_streams(seeds, 5, jitter, repeats,
                                                 reward_mode), 40, 0)


def test_device_env_rejects_overflow_seeds():
    """Length jitter multiplies the raw seed, so jittered envs keep the
    tight seed bound."""
    dev = DeviceFakeEnv(height=H, width=W, length_jitter=2)
    with pytest.raises(ValueError, match="seeds must stay below"):
        dev.initial(np.asarray([10**7], np.int32))


@pytest.mark.parametrize("reward_mode", ["schedule", "bandit", "memory"])
def test_device_env_mirrors_host_at_large_seed(reward_mode):
    """``(seed * 131) % a`` overflows int32 above seed ~16.4M: the
    mod-before-multiply arithmetic stays exact far past it."""
    seeds = [100_000_000, 2**31 - 1]
    dev = DeviceFakeEnv(height=H, width=W, num_actions=NUM_ACTIONS,
                        episode_length=4, reward_mode=reward_mode)
    _check_against_host(dev, seeds, host_streams(seeds, 4, 0, 1,
                                                 reward_mode), 10, 1)


@pytest.mark.parametrize("jitter", [0, 3])
@pytest.mark.parametrize("repeats", [1, 4])
@pytest.mark.parametrize("reward_mode", ["schedule", "bandit", "memory"])
def test_device_env_matches_jax_mirror_bitwise(reward_mode, repeats,
                                               jitter):
    """Every leaf of (state, output) equals the JAX ``DeviceFakeEnv``'s
    after ``initial`` and each of 50 steps, at the conformance seeds (the
    last one the jitter-bounded ``max_seed``)."""
    kwargs = dict(height=H, width=W, num_actions=NUM_ACTIONS,
                  episode_length=5, length_jitter=jitter,
                  num_action_repeats=repeats, reward_mode=reward_mode)
    ours, theirs = DeviceFakeEnv(**kwargs), JaxDeviceFakeEnv(**kwargs)
    assert ours.max_seed == theirs.max_seed
    seeds = conformance.conformance_seeds(ours, 5)
    assert seeds[-1] == ours.max_seed
    state, out = ours.initial(seeds)
    jstate, jout = theirs.initial(seeds)
    step = jax.jit(theirs.step)
    rng = np.random.default_rng(2)
    for t in range(51):
        got = conformance.leaves((state, out))
        want = jax.tree_util.tree_leaves((jstate, jout))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"t={t}")
        actions = rng.integers(0, NUM_ACTIONS, size=len(seeds))
        state, out = ours.step(state, torch.as_tensor(actions))
        jstate, jout = step(jstate, jnp.asarray(actions, jnp.int32))


def test_composite_actions_use_component_zero():
    """A [B, K] action drives the mirror with its component 0, as in
    JAX."""
    dev = DeviceFakeEnv(height=H, width=W, num_actions=NUM_ACTIONS)
    state, _ = dev.initial([1, 2])
    _, plain = dev.step(state, torch.tensor([3, 1]))
    _, composite = dev.step(state, torch.tensor([[3, 0], [1, 2]]))
    assert torch.equal(plain.observation.frame,
                       composite.observation.frame)
