"""The DeviceEnv protocol and the ``DEVICE_LEVELS`` registry.

The counterpart of ``scalable_agent_tpu/envs/device/protocol.py``.  A
*device environment* is an environment whose transition function is made
of tensor operations over ``[B]`` batched state: ``initial``/``step`` run
on whatever device their inputs lie on, so a whole unroll of the in-graph
backend (``runtime/ingraph.py``) runs on the card with no per-step traffic
between host and device.  This module is the contract every such world
implements and the one registry every consumer reads: ``make_device_env``,
``envs/registry.py``'s fake and ``device_`` families, the driver's
``--train_backend=ingraph`` and the conformance harness.

The protocol (checked by ``envs/device/conformance.py`` on every
registered level):

- ``spec`` describes shapes, dtypes and the action space; outputs match it
  for any seed (seeds select content, never structure).
- ``initial(seeds) -> (state, StepOutput[B])`` resets every env.  The
  emitted output has ``done=True`` (start of episode), reward 0 and zeroed
  episode info.
- ``step(state, action) -> (state, StepOutput[B])`` advances one agent
  step (``num_action_repeats`` simulator sub-steps, rewards summed, early
  stop on termination) and resets by itself: when ``done``, the emitted
  observation is already the next episode's first frame (the
  ``StreamAdapter`` contract, ``envs/core.py``), so the T+1 overlap layout
  needs no reset step on the host.
- Episode accounting is emitted against carried (``ImpalaStream``): the
  emitted ``info`` includes the final step (``episode_step >= 1`` after
  ``initial``, ``episode_return`` sums the whole episode), while the
  carried state resets to zero on done.  A finished episode is ``done &
  (info.episode_step > 0)``: ``initial``'s done rows carry step 0.
- Determinism: the trajectory is a function of (seeds, actions) alone,
  bit for bit, across a per-step loop, a whole-rollout function and a new
  instance.
- Distinct storage: no two tensors of ``(state, output)`` share memory,
  so a caller may update any of them in place.
- No host syncs: nothing in ``initial``/``step`` reads a device value on
  the host (no ``.item()``, ``bool(tensor)``, ``nonzero``); every
  data-dependent branch is a masked tensor operation.

This module imports no torch: the env workers of the ``fake_`` family read
the level defaults from it, and only the worlds' own modules load torch,
when a world is built.  Its registrations name their world classes as lazy
``"module:attr"`` strings for that reason.
"""

from typing import Callable, Dict, NamedTuple, Tuple, Union

from scalable_agent_tpu_torch.envs.spaces import Discrete
from scalable_agent_tpu_torch.types import Observation

__all__ = [
    "DEVICE_LEVELS",
    "DeviceEnvSpec",
    "DeviceLevel",
    "device_level_names",
    "make_device_env",
    "register_device_level",
]


class DeviceEnvSpec(NamedTuple):
    """Seed-independent structure of a device env's interface."""

    observation_spec: Observation  # of TensorSpec
    action_space: Discrete
    num_actions: int


class DeviceLevel(NamedTuple):
    """One registered device level.

    ``defaults`` are the level's constructor parameters: the one copy that
    ``make_device_env`` and the host twins of ``envs/registry.py`` read, so
    the device env and ``probe_env``'s host spec cannot drift apart.
    ``factory`` is the world class, or a lazy ``"module:attr"`` string
    resolved when the level is first built.  ``accepts`` names the
    configuration's overrides (``height``/``width``/``num_actions``) the
    level honours; others are ignored: a gridworld's frame is fixed by its
    dynamics, not by ``--height``.
    """

    name: str
    factory: Union[str, Callable[..., object]]
    defaults: Dict[str, object]
    accepts: Tuple[str, ...]
    description: str

    def build(self, **params):
        factory = self.factory
        if isinstance(factory, str):
            import importlib

            module, _, attr = factory.partition(":")
            factory = getattr(importlib.import_module(module), attr)
        return factory(**params)


DEVICE_LEVELS: Dict[str, DeviceLevel] = {}


def register_device_level(name: str,
                          factory: Union[str, Callable[..., object]],
                          defaults: Dict[str, object],
                          accepts: Tuple[str, ...] = (),
                          description: str = "") -> None:
    """Register a device level.  A second registration of a name raises:
    a level's defaults have one home."""
    if name in DEVICE_LEVELS:
        raise ValueError(f"device level {name!r} already registered")
    DEVICE_LEVELS[name] = DeviceLevel(
        name=name, factory=factory, defaults=dict(defaults),
        accepts=tuple(accepts), description=description)


def device_level_names() -> Tuple[str, ...]:
    return tuple(sorted(DEVICE_LEVELS))


def make_device_env(level_name: str, height: int = 0, width: int = 0,
                    num_actions: int = 0, num_action_repeats: int = 1,
                    with_instruction: bool = False, **kwargs):
    """The device env of ``level_name`` (the in-graph backend's env).

    Parameters come from the level's ``DEVICE_LEVELS`` entry.  ``height``/
    ``width``/``num_actions`` of 0 mean the level's default; a nonzero
    value is taken only where the entry ``accepts`` it (the driver passes
    its configuration's values for every level).  Explicit ``**kwargs``
    always win: they address the constructor directly.  Levels whose
    simulators live in other processes (``doom_``, ``dmlab_``, ``atari_``)
    have no device env, and asking for one raises.
    """
    if with_instruction:
        raise ValueError(
            "device envs do not emit instruction observations")
    entry = DEVICE_LEVELS.get(level_name)
    if entry is None:
        raise ValueError(
            f"level {level_name!r} has no device (in-graph) "
            f"implementation; device-expressible levels: "
            f"{sorted(DEVICE_LEVELS)}")
    params = dict(entry.defaults)
    for knob, value in (("height", height), ("width", width),
                        ("num_actions", num_actions)):
        if value and knob in entry.accepts:
            params[knob] = value
    params.update(kwargs)
    return entry.build(num_action_repeats=num_action_repeats, **params)


# -- the registry --------------------------------------------------------

# The fake family (envs/device/fake.py, bit-exact mirrors of envs/fake.py;
# their host twins in envs/registry.py read these defaults).
_FAKE = "scalable_agent_tpu_torch.envs.device.fake:DeviceFakeEnv"
register_device_level(
    "fake_benchmark", _FAKE,
    dict(height=72, width=96, episode_length=1000, num_actions=9),
    accepts=("height", "width", "num_actions"),
    description="zero-simulator-cost throughput benchmark fake")
register_device_level(
    "fake_small", _FAKE,
    dict(height=16, width=16, episode_length=10, num_actions=9),
    accepts=("height", "width", "num_actions"),
    description="small deterministic fake for smoke tests")
register_device_level(
    "fake_bandit", _FAKE,
    dict(height=16, width=16, episode_length=16, num_actions=4,
         reward_mode="bandit"),
    accepts=("height", "width", "num_actions"),
    description="learnable contextual bandit (learning-proof level)")
register_device_level(
    "fake_memory", _FAKE,
    dict(height=16, width=16, episode_length=8, num_actions=4,
         reward_mode="memory"),
    accepts=("height", "width", "num_actions"),
    description="first-frame-cue memory task (LSTM done-reset proof)")

# The real worlds (their host twins are envs/device/host.py's adapter
# driving the same transition function).
register_device_level(
    "device_grid_small",
    "scalable_agent_tpu_torch.envs.device.gridworld:DeviceGridWorld",
    dict(grid_size=5, view=5, cell_px=3, episode_length=24),
    description="5x5 key-door gridworld, near-full observability: the "
                "short-run learnability level")
register_device_level(
    "device_grid_large",
    "scalable_agent_tpu_torch.envs.device.gridworld:DeviceGridWorld",
    dict(grid_size=11, view=5, cell_px=3, episode_length=96),
    description="11x11 key-door gridworld, partial observation window")
register_device_level(
    "device_minatar_breakout",
    "scalable_agent_tpu_torch.envs.device.minatar:DeviceBreakout",
    dict(episode_length=128, sticky_prob=0.0),
    description="MinAtar-style breakout: object-channel 10x10 frames")
register_device_level(
    "device_minatar_asterix",
    "scalable_agent_tpu_torch.envs.device.minatar:DeviceAsterix",
    dict(episode_length=128, sticky_prob=0.0),
    description="MinAtar-style asterix: streaming enemies and gold, "
                "hash-spawned")
