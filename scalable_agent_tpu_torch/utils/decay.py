"""Piecewise-linear schedules: a copy of
``scalable_agent_tpu/utils/decay.py`` (reference: utils/decay.py:4-47)."""

from typing import Sequence, Tuple


class LinearDecay:
    """Value interpolated between (step, value) milestones.

    Before the first milestone: first value.  After the last: last value.
    ``staircase`` > 0 quantizes the interpolated value into that many
    discrete steps per segment.
    """

    def __init__(self, milestones: Sequence[Tuple[int, float]],
                 staircase: int = 0):
        if not milestones:
            raise ValueError("need at least one milestone")
        self._milestones = sorted(milestones)
        self._staircase = staircase

    def at(self, step: int) -> float:
        ms = self._milestones
        if step <= ms[0][0]:
            return ms[0][1]
        if step >= ms[-1][0]:
            return ms[-1][1]
        for (x0, y0), (x1, y1) in zip(ms, ms[1:]):
            if x0 <= step <= x1:
                fraction = (step - x0) / (x1 - x0)
                if self._staircase:
                    fraction = (int(fraction * self._staircase)
                                / self._staircase)
                return y0 + fraction * (y1 - y0)
        raise AssertionError("unreachable")
