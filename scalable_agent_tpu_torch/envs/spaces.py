"""Action spaces: the Discrete part of ``scalable_agent_tpu/envs/spaces.py``
(no gym dependency).  Composite spaces are not ported yet (ROADMAP.md,
queue 1)."""


class Space:
    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    """{0, ..., n-1}."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"Discrete needs n > 0, got {n}")
        self.n = int(n)

    def contains(self, x):
        return 0 <= int(x) < self.n

    def __eq__(self, other):
        return type(other) is type(self) and other.n == self.n

    def __repr__(self):
        return f"Discrete({self.n})"
