"""Device environments: worlds whose transition function runs on the card.

The counterpart of ``scalable_agent_tpu/envs/device/``.  A world whose
dynamics are tensor operations runs on the card beside the agent's
inference, so the in-graph backend (``runtime/ingraph.py``,
``--train_backend=ingraph``) puts a whole unroll and the update on the
device with no per-step traffic between host and card.

- ``protocol``: the DeviceEnv contract, the ``DEVICE_LEVELS`` registry and
  ``make_device_env``; the one home of the level defaults that
  ``envs/registry.py``'s host twins read.  It imports no torch: env
  workers read it.
- ``fake``: ``DeviceFakeEnv``, the bit-exact mirror of ``envs/fake.py``.
- ``world``: the chassis of the hand-written worlds (batching, action
  repeats, the reset, accounting, hashed randomness).
- ``gridworld`` and ``minatar``: the real worlds, ``device_grid_*`` and
  ``device_minatar_*``.
- ``host``: ``HostDeviceEnv``, the gym-like adapter that makes any device
  level a host ``Environment`` on the CPU (probe_env, the host backend's
  env workers, eval).
- ``conformance``: the protocol checks every registered level passes.
- ``accounting``: the ``devtel/env/*`` episode telemetry.

Attribute access is lazy (PEP 562): importing this package, as the env
workers' registry does to read the level defaults, loads no torch until a
world class or the telemetry helpers are touched.
"""

import importlib

_EXPORTS = {
    "DEVICE_LEVELS": "protocol",
    "DeviceEnvSpec": "protocol",
    "DeviceLevel": "protocol",
    "device_level_names": "protocol",
    "make_device_env": "protocol",
    "register_device_level": "protocol",
    "DeviceEnvState": "fake",
    "DeviceFakeEnv": "fake",
    "DeviceGridState": "gridworld",
    "DeviceGridWorld": "gridworld",
    "DeviceAsterix": "minatar",
    "DeviceBreakout": "minatar",
    "DeviceWorld": "world",
    "HostDeviceEnv": "host",
    "make_host_device_env": "host",
    "env_telemetry_spec": "accounting",
    "record_episode_telemetry": "accounting",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{module_name}")
    value = getattr(module, name)
    globals()[name] = value  # later accesses skip this hook
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
