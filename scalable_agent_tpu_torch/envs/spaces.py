"""Action and observation spaces without a gym dependency: a copy of
``scalable_agent_tpu/envs/spaces.py``.

Discrete, Box, TupleSpace composites mixing the two, and ``Discretized``,
a Discrete whose indices map onto a uniform grid of a continuous range
(reference: algorithms/spaces/discretized.py:4-14,
envs/doom/action_space.py:13-138).  ``sample(rng)`` draws from a numpy
``Generator`` exactly as the JAX package draws (``--benchmark_mode``'s
random actions).  ``from_gymnasium`` converts a gymnasium space; it
imports gymnasium only when called.
"""

from typing import Sequence

import numpy as np


class Space:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    """{0, ..., n-1}."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"Discrete needs n > 0, got {n}")
        self.n = int(n)

    def sample(self, rng):
        return int(rng.integers(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n

    def __eq__(self, other):
        return type(other) is type(self) and other.n == self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Discretized(Discrete):
    """Discrete(n) whose indices map to a uniform grid on [min, max]."""

    def __init__(self, n: int, min_action: float, max_action: float):
        super().__init__(n)
        if n < 2:
            raise ValueError("Discretized needs n >= 2 for a grid")
        self.min_action = float(min_action)
        self.max_action = float(max_action)

    def __eq__(self, other):
        return (type(other) is type(self) and other.n == self.n
                and other.min_action == self.min_action
                and other.max_action == self.max_action)

    def to_continuous(self, discrete_action):
        step = (self.max_action - self.min_action) / (self.n - 1)
        return self.min_action + int(discrete_action) * step

    def __repr__(self):
        return (f"Discretized({self.n}, "
                f"[{self.min_action}, {self.max_action}])")


class Box(Space):
    """Continuous box with per-element bounds."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)

    def sample(self, rng):
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low)
                and np.all(x <= self.high))

    def __eq__(self, other):
        return (isinstance(other, Box) and other.shape == self.shape
                and np.array_equal(other.low, self.low)
                and np.array_equal(other.high, self.high))

    def __repr__(self):
        return f"Box{self.shape}"


class TupleSpace(Space):
    """Composite of subspaces; actions are tuples, one entry per
    subspace."""

    def __init__(self, spaces: Sequence[Space]):
        self.spaces = tuple(spaces)

    def sample(self, rng):
        return tuple(s.sample(rng) for s in self.spaces)

    def contains(self, x):
        return (len(x) == len(self.spaces)
                and all(s.contains(v) for s, v in zip(self.spaces, x)))

    def __eq__(self, other):
        return isinstance(other, TupleSpace) and other.spaces == self.spaces

    def __repr__(self):
        return f"TupleSpace{self.spaces}"


def calc_num_logits(space: Space) -> int:
    """Logits of a categorical (product) policy over ``space``
    (reference: algorithms/utils/action_distributions.py:10-17)."""
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, TupleSpace):
        return sum(calc_num_logits(s) for s in space.spaces)
    raise NotImplementedError(f"no categorical policy over {space!r}")


def from_gymnasium(space) -> Space:
    """A gymnasium space as one of ours (Discrete, Box, Tuple only)."""
    import gymnasium

    if isinstance(space, gymnasium.spaces.Discrete):
        return Discrete(int(space.n))
    if isinstance(space, gymnasium.spaces.Box):
        return Box(space.low, space.high, space.shape, space.dtype)
    if isinstance(space, gymnasium.spaces.Tuple):
        return TupleSpace([from_gymnasium(s) for s in space.spaces])
    raise NotImplementedError(f"unsupported gymnasium space {space!r}")
