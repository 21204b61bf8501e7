"""The host twin of any device level: a gym-like ``Environment`` adapter.

The counterpart of ``scalable_agent_tpu/envs/device/host.py``.  The device
worlds (``device_grid_*``, ``device_minatar_*``) have no host
implementation of their own: their transition function is the tensor
program.  ``HostDeviceEnv`` runs that same function at batch 1 on
``torch.device("cpu")`` behind the standard reset/step surface, so
``probe_env``, the env workers of the host backend and the eval fleets
serve device levels unchanged, and "the host twin matches the device env"
holds by construction.

The adapter is built inside env-worker processes: it imports torch there
(only the ``device_`` family's workers load it), runs on one CPU thread
where the family is what loads torch (``make_host_device_env``: a fleet
of workers must not oversubscribe the host, and the learner's process,
where ``probe_env`` builds an adapter too, keeps its threads) and never
touches CUDA, whose context belongs to the learner's process.

After a done the device protocol has already emitted the next episode's
first observation; ``reset()`` hands that observation back instead of
stepping again, which composes with ``StreamAdapter`` (``envs/core.py``)
into exactly the device stream.
"""

from typing import Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch.envs.core import Environment, make_observation

__all__ = ["HostDeviceEnv", "make_host_device_env"]


class HostDeviceEnv(Environment):
    """See the module docstring.  ``env`` is any device env
    (``envs/device/protocol.py``)."""

    def __init__(self, env, seed: int = 0):
        import torch

        self._torch = torch
        self._env = env
        self._seed = int(seed)
        self.action_space = env.action_space
        self.observation_spec = env.observation_spec
        self.native_action_repeats = env.num_action_repeats
        self._state = None
        self._last_obs = None

    def seed(self, seed: Optional[int]):
        if seed is not None:
            self._seed = int(seed)
            self._state = None  # the next reset() starts the new stream

    @staticmethod
    def _obs(output):
        return make_observation(output.observation.frame[0].numpy())

    def reset(self):
        if self._state is None:
            self._state, output = self._env.initial(
                np.asarray([self._seed], np.int32))
            self._last_obs = self._obs(output)
        # After a done step the device env has already reset and emitted
        # the new episode's first frame: hand it back.
        return self._last_obs

    def step(self, action) -> Tuple[object, float, bool, dict]:
        if self._state is None:
            raise RuntimeError("step() before reset()")
        arr = np.asarray(action)
        if arr.ndim > 0:  # composite: component 0 drives the world
            arr = arr.reshape(-1)[0]
        with self._torch.no_grad():
            self._state, output = self._env.step(
                self._state, self._torch.tensor([int(arr)],
                                                dtype=self._torch.int32))
        self._last_obs = self._obs(output)
        return (self._last_obs, np.float32(output.reward[0]),
                bool(output.done[0]), {})

    def render(self, mode: str = "rgb_array"):
        if self._last_obs is None:
            self.reset()
        return self._last_obs.frame


def make_host_device_env(full_env_name: str, **kwargs) -> HostDeviceEnv:
    """The ``device_`` family's factory (``envs/registry.py``).  The kwargs
    the host pipeline passes other families (height, width,
    with_instruction) go on to ``make_device_env``, which resolves them per
    level (the ``accepts`` filter; a true ``with_instruction`` raises)."""
    import sys

    from scalable_agent_tpu_torch.envs.device.protocol import make_device_env

    # Whether this family is what brings torch into the process (an env
    # worker), before the world's module imports it.
    loads_torch = "torch" not in sys.modules
    num_action_repeats = int(kwargs.pop("num_action_repeats", 1))
    env = HostDeviceEnv(make_device_env(
        full_env_name, num_action_repeats=num_action_repeats, **kwargs))
    if loads_torch:
        import torch

        torch.set_num_threads(1)
    return env
