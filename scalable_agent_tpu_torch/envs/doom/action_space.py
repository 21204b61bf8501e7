"""The eight composite Doom action-space variants (a copy of
``scalable_agent_tpu/envs/doom/action_space.py``).

Faithful re-statements of the reference's spaces (reference:
envs/doom/action_space.py:13-138) over this framework's space algebra
(envs/spaces.py).  Each variant is a ``TupleSpace`` of independent
subspaces; index 0 of every Discrete subspace is a no-op, matching the
one-hot conversion in envs/doom/core.py.  The fully-categorical variants
(every component Discrete/Discretized) feed the tuple-categorical policy
heads directly (ops/distributions.py); the Box-turning variants exist
for env-surface parity — like the reference, the IMPALA policy has no
continuous head, so they are simulator-consumable but not trainable.
"""

from scalable_agent_tpu_torch.envs.spaces import (
    Box,
    Discrete,
    Discretized,
    TupleSpace,
)


def doom_action_space_basic() -> TupleSpace:
    """Turn left/right x move forward/backward.
    (reference: action_space.py:13-27)"""
    return TupleSpace((
        Discrete(3),  # noop, turn left, turn right
        Discrete(3),  # noop, forward, backward
    ))


def doom_action_space() -> TupleSpace:
    """Full deathmatch space with continuous turning.
    (reference: action_space.py:28-54)"""
    return TupleSpace((
        Discrete(3),  # noop, forward, backward
        Discrete(3),  # noop, move right, move left
        Discrete(3),  # noop, prev weapon, next weapon
        Discrete(2),  # noop, attack
        Discrete(2),  # noop, sprint
        Box(-1.0, 1.0, (1,)),  # turn delta
    ))


def doom_action_space_discretized() -> TupleSpace:
    """(reference: action_space.py:57-65)"""
    return TupleSpace((
        Discrete(3),
        Discrete(3),
        Discrete(3),
        Discrete(2),
        Discrete(2),
        Discretized(11, min_action=-10.0, max_action=10.0),
    ))


def doom_action_space_discretized_no_weap() -> TupleSpace:
    """The doom_battle space (used in the SF paper).
    (reference: action_space.py:68-75)"""
    return TupleSpace((
        Discrete(3),
        Discrete(3),
        Discrete(2),
        Discrete(2),
        Discretized(11, min_action=-10.0, max_action=10.0),
    ))


def doom_action_space_continuous_no_weap() -> TupleSpace:
    """(reference: action_space.py:78-85)"""
    return TupleSpace((
        Discrete(3),
        Discrete(3),
        Discrete(2),
        Discrete(2),
        Box(-1.0, 1.0, (1,)),
    ))


def doom_action_space_discrete() -> TupleSpace:
    """(reference: action_space.py:88-96)"""
    return TupleSpace((
        Discrete(3),
        Discrete(3),
        Discrete(3),  # noop, turn right, turn left
        Discrete(3),
        Discrete(2),
        Discrete(2),
    ))


def doom_action_space_discrete_no_weap() -> TupleSpace:
    """(reference: action_space.py:99-106)"""
    return TupleSpace((
        Discrete(3),
        Discrete(3),
        Discrete(3),
        Discrete(2),
        Discrete(2),
    ))


def doom_action_space_full_discretized(with_use: bool = False) -> TupleSpace:
    """Weapon-selection space with discretized turning.
    (reference: action_space.py:109-138)"""
    spaces = [
        Discrete(3),  # noop, forward, backward
        Discrete(3),  # noop, move right, move left
        Discrete(8),  # noop, select weapons 1-7
        Discrete(2),  # noop, attack
        Discrete(2),  # noop, sprint
    ]
    if with_use:
        spaces.append(Discrete(2))  # noop, use
    spaces.append(Discretized(21, min_action=-12.5, max_action=12.5))
    return TupleSpace(spaces)
