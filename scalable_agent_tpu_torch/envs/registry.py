"""Env construction by name, for the ``fake_`` family.

The counterpart of ``scalable_agent_tpu/envs/registry.py``.  The fake-level
defaults are copied from the ``fake_*`` rows of
``scalable_agent_tpu/envs/device/protocol.py``, ``fake_tuple``'s from
``scalable_agent_tpu/envs/registry.py``; the simulator families
(``doom_``, ``atari_``, ``dmlab_``, ``gym_``, ``device_``) are not ported
yet (ROADMAP.md, queue 1).
"""

from scalable_agent_tpu_torch.envs.core import Environment
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.envs.spaces import (
    Discrete,
    Discretized,
    TupleSpace,
)

FAKE_LEVELS = {
    # zero-simulator-cost throughput benchmark fake
    "fake_benchmark": dict(height=72, width=96, episode_length=1000,
                           num_actions=9),
    # small deterministic fake for smoke tests
    "fake_small": dict(height=16, width=16, episode_length=10,
                       num_actions=9),
    # learnable contextual bandit (learning-proof level)
    "fake_bandit": dict(height=16, width=16, episode_length=16,
                        num_actions=4, reward_mode="bandit"),
    # learnable only through the LSTM's memory (done-reset red test)
    "fake_memory": dict(height=16, width=16, episode_length=8,
                        num_actions=4, reward_mode="memory"),
    # composite action space Tuple(Discrete, Discretized): the hermetic
    # stand-in for Doom's composite spaces
    # (reference: envs/doom/action_space.py:13-138)
    "fake_tuple": dict(height=16, width=16, episode_length=10,
                       action_space=TupleSpace(
                           [Discrete(3), Discretized(5, -1.0, 1.0)])),
}


def create_env(full_env_name: str, **kwargs) -> Environment:
    """Instantiate an env by name; the level's defaults fill whatever the
    caller did not pass."""
    if not full_env_name.startswith("fake_"):
        raise ValueError(
            f"env {full_env_name!r}: only the fake_ family is ported to "
            f"scalable_agent_tpu_torch so far (see ROADMAP.md, queue 1)")
    for key, value in FAKE_LEVELS.get(full_env_name, {}).items():
        kwargs.setdefault(key, value)
    return FakeEnv(**kwargs)
