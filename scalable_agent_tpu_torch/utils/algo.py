"""Algorithm utilities: running statistics, discounted sums, GAE.

A numpy copy of ``scalable_agent_tpu/utils/algo.py`` (reference: the
vendored Sample-Factory utilities, algorithms/utils/algo_utils.py:6-159).
The IMPALA path does not use them (V-trace takes GAE's place there, as in
the reference, where they feed the absent PPO modules); they are part of
the public algorithm-utility surface.
"""

from typing import Sequence, Tuple

import numpy as np

EPS = 1e-8


class RunningMeanStd:
    """Streaming mean/variance via the parallel-variance update
    (reference: algo_utils.py:6-47, the Chan et al. parallel algorithm)."""

    def __init__(self, shape: Tuple[int, ...] = (), epsilon: float = 1e-4):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = float(epsilon)

    def update(self, batch: np.ndarray) -> None:
        batch = np.asarray(batch, np.float64)
        self.update_from_moments(batch.mean(axis=0), batch.var(axis=0),
                                 batch.shape[0])

    def update_from_moments(self, batch_mean, batch_var,
                            batch_count: float) -> None:
        delta = batch_mean - self.mean
        total = self.count + batch_count
        self.mean = self.mean + delta * batch_count / total
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + delta ** 2 * self.count * batch_count / total
        self.var = m2 / total
        self.count = total

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) - self.mean) / np.sqrt(self.var + EPS)


def discounted_sums(values: Sequence[float], gamma: float) -> np.ndarray:
    """x_t + gamma * X_{t+1}, right to left (reference:
    algo_utils.py:86-99)."""
    values = np.asarray(values, np.float64)
    out = np.zeros_like(values)
    acc = 0.0
    for t in range(len(values) - 1, -1, -1):
        acc = values[t] + gamma * acc
        out[t] = acc
    return out


def calculate_gae(rewards: Sequence[float], dones: Sequence[bool],
                  values: Sequence[float], gamma: float,
                  gae_lambda: float) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized Advantage Estimation.  ``values`` has one more entry
    than ``rewards`` (the bootstrap).  Returns (advantages, returns) with
    returns = advantages + values[:-1] (reference: algo_utils.py:102-127).
    """
    rewards = np.asarray(rewards, np.float64)
    dones = np.asarray(dones, bool)
    values = np.asarray(values, np.float64)
    if len(values) != len(rewards) + 1:
        raise ValueError(
            f"values needs len(rewards)+1 entries, got {len(values)} "
            f"for {len(rewards)} rewards")
    not_done = 1.0 - dones.astype(np.float64)
    advantages = np.zeros_like(rewards)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        delta = (rewards[t] + gamma * values[t + 1] * not_done[t]
                 - values[t])
        acc = delta + gamma * gae_lambda * not_done[t] * acc
        advantages[t] = acc
    return advantages, advantages + values[:-1]


def num_env_steps(infos: Sequence[dict]) -> int:
    """Simulator frames over a batch of info dicts, frameskip-aware
    (reference: algo_utils.py:130-136)."""
    return sum(int(info.get("num_frames", 1)) for info in infos)
