"""Core data structures shared by actor, learner and envs.

Copies of ``scalable_agent_tpu/types.py``'s namedtuples (reference:
experiment.py:98-102, environments.py:143-146), holding numpy arrays on the
host and torch tensors on the device.
"""

from typing import Any, NamedTuple, Optional


class StepOutputInfo(NamedTuple):
    """Episode bookkeeping carried alongside every env step."""

    episode_return: Any  # f32 []
    episode_step: Any  # i32 []


class Observation(NamedTuple):
    """What the env shows the agent each step: ``frame`` is HWC uint8;
    ``instruction`` int32 [L] hashed token ids (0 = padding) or None;
    ``measurements`` f32 [M] game-state scalars on the Doom levels with
    ``DoomAdditionalInput`` (M=23; the agent does not read them), else
    None."""

    frame: Any
    instruction: Optional[Any] = None
    measurements: Optional[Any] = None


class StepOutput(NamedTuple):
    """One env transition."""

    reward: Any  # f32 []
    info: Any  # StepOutputInfo
    done: Any  # bool []
    observation: Any  # Observation


class AgentState(NamedTuple):
    """LSTM core carry."""

    c: Any
    h: Any


class AgentOutput(NamedTuple):
    """Per-step model output."""

    action: Any  # int []
    policy_logits: Any  # f32 [num_actions]
    baseline: Any  # f32 []


class ActorOutput(NamedTuple):
    """One length-T+1 trajectory sent from an actor to the learner."""

    level_name: Any
    agent_state: Any  # AgentState at trajectory start
    env_outputs: Any  # StepOutput, [T+1, ...]
    agent_outputs: Any  # AgentOutput, [T+1, ...]


def map_structure(fn, *trees):
    """Apply ``fn`` leaf-wise over matching nested tuples, lists and dicts
    (namedtuples keep their type).  Anything else, None included, is a
    leaf, as in the JAX package's ``map_structure``."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(map_structure(fn, *parts)
                             for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(map_structure(fn, *parts)
                           for parts in zip(*trees))
    if isinstance(first, dict):
        return {key: map_structure(fn, *(tree[key] for tree in trees))
                for key in first}
    return fn(*trees)
