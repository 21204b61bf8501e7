"""Env construction by name, with name-prefix family dispatch.

The counterpart of ``scalable_agent_tpu/envs/registry.py`` (reference:
envs/create_env.py:1-19): families register a factory under a name prefix
(``register_family``), and the simulator families import their modules
lazily, so that a missing simulator package fails only when its family is
asked for.  The fake levels with a device twin read their defaults from
``envs/device/protocol.py``'s ``DEVICE_LEVELS`` (one copy, so the host
spec ``probe_env`` reads and the in-graph backend's device env cannot
drift apart; the module imports no torch, so the env workers read it);
``fake_tuple``, host-only, keeps its own here.  Every family of the JAX
package is ported: ``fake_``, ``device_`` (``envs/device/host.py``, the
device worlds on the CPU at batch 1; only its workers load torch),
``doom_`` (``envs/doom/``), ``dmlab_`` (``envs/dmlab/``), ``atari_``
(``envs/atari/``) and ``gym_`` (``envs/gym_adapter.py``).
"""

from typing import Callable, Dict, Tuple

from scalable_agent_tpu_torch.envs.core import Environment
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.envs.spaces import (
    Discrete,
    Discretized,
    TupleSpace,
)

# The host-only fake levels (no device twin): composite action space
# Tuple(Discrete, Discretized), the hermetic stand-in for Doom's composite
# spaces (reference: envs/doom/action_space.py:13-138).
FAKE_LEVELS = {
    "fake_tuple": dict(height=16, width=16, episode_length=10,
                       action_space=TupleSpace(
                           [Discrete(3), Discretized(5, -1.0, 1.0)])),
}

# The JAX package's simulator families this package does not port yet.
UNPORTED_FAMILIES = ()

_FACTORIES: Dict[str, Tuple[Callable[..., Environment], bool]] = {}


def register_family(prefix: str, factory: Callable[..., Environment],
                    consumes_action_repeats: bool = False):
    """Register ``factory(full_name, **kwargs)`` for env names ``prefix*``.

    ``consumes_action_repeats``: the family applies action repeats
    natively and takes a ``num_action_repeats`` kwarg; the others are
    wrapped by ``make_impala_stream`` instead and never see it."""
    _FACTORIES[prefix] = (factory, consumes_action_repeats)


def _lookup(full_env_name: str):
    for prefix, entry in sorted(
            _FACTORIES.items(), key=lambda kv: -len(kv[0])):
        if full_env_name.startswith(prefix):
            return entry
    if full_env_name.startswith(UNPORTED_FAMILIES):
        raise ValueError(
            f"env {full_env_name!r}: its family is not ported to "
            f"scalable_agent_tpu_torch yet (see ROADMAP.md, queue 1)")
    raise ValueError(
        f"unknown env name {full_env_name!r}; registered prefixes: "
        f"{sorted(_FACTORIES)}")


def family_consumes_repeats(full_env_name: str) -> bool:
    return _lookup(full_env_name)[1]


def create_env(full_env_name: str, **kwargs) -> Environment:
    """Instantiate an env by its prefix-dispatched name."""
    return _lookup(full_env_name)[0](full_env_name, **kwargs)


def _make_fake(full_env_name: str, **kwargs) -> Environment:
    """A fake level; the level's defaults (its ``DEVICE_LEVELS`` entry, or
    ``FAKE_LEVELS``) fill whatever the caller did not pass."""
    from scalable_agent_tpu_torch.envs.device.protocol import DEVICE_LEVELS

    entry = DEVICE_LEVELS.get(full_env_name)
    defaults = (entry.defaults if entry is not None
                else FAKE_LEVELS.get(full_env_name, {}))
    for key, value in defaults.items():
        kwargs.setdefault(key, value)
    return FakeEnv(**kwargs)


def _lazy_family(family: str, module: str, attr: str):
    """A factory that imports its simulator module on first use and turns
    a missing module or package into a clear error."""

    def factory(full_env_name: str, **kwargs) -> Environment:
        import importlib

        try:
            mod = importlib.import_module(module)
        except ImportError as exc:
            raise ValueError(
                f"env family {family!r} is not available here: importing "
                f"{module} failed ({exc}).  Its simulator package is an "
                f"optional dependency.") from exc
        return getattr(mod, attr)(full_env_name, **kwargs)

    return factory


# The device worlds' host twin: the same transition function at batch 1
# on the CPU (envs/device/host.py); it imports torch, so it is lazy.
_make_device = _lazy_family(
    "device_", "scalable_agent_tpu_torch.envs.device.host",
    "make_host_device_env")
_make_doom = _lazy_family(
    "doom_", "scalable_agent_tpu_torch.envs.doom.factory", "make_doom_env")
_make_atari = _lazy_family(
    "atari_", "scalable_agent_tpu_torch.envs.atari", "make_atari_env")
_make_dmlab = _lazy_family(
    "dmlab_", "scalable_agent_tpu_torch.envs.dmlab", "make_dmlab_env")
_make_gym = _lazy_family(
    "gym_", "scalable_agent_tpu_torch.envs.gym_adapter", "make_gym_env")

register_family("fake_", _make_fake, consumes_action_repeats=True)
register_family("device_", _make_device, consumes_action_repeats=True)
register_family("doom_", _make_doom, consumes_action_repeats=True)
register_family("atari_", _make_atari, consumes_action_repeats=True)
register_family("dmlab_", _make_dmlab, consumes_action_repeats=True)
register_family("gym_", _make_gym)
