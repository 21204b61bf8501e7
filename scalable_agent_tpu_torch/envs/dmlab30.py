"""DMLab-30 level metadata and human-normalized scoring.

A copy of ``scalable_agent_tpu/envs/dmlab30.py`` (numpy only: the env
workers and the obs CLIs may import it without torch).  It is a parity
port of the reference's scoring module (reference: dmlab30.py:27-218) with
one structural change: instead of three parallel tables
(LEVEL_MAPPING / HUMAN_SCORES / RANDOM_SCORES), each level carries one
record — (test-level alias, human score, random score) — so the tables
cannot drift out of sync.  The numeric constants are the published DMLab-30
calibration values (IMPALA paper, arXiv:1802.01561) and must match the
reference exactly for score parity.
"""

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np


class LevelRecord(NamedTuple):
    test_level: str  # levels with train/test splits score under this name
    human: float
    random: float


# Training-level name -> record.  Order matches the canonical DMLab-30 list.
LEVELS: Dict[str, LevelRecord] = {
    "rooms_collect_good_objects_train": LevelRecord(
        "rooms_collect_good_objects_test", 10.0, 0.073),
    "rooms_exploit_deferred_effects_train": LevelRecord(
        "rooms_exploit_deferred_effects_test", 85.65, 8.501),
    "rooms_select_nonmatching_object": LevelRecord(
        "rooms_select_nonmatching_object", 65.9, 0.312),
    "rooms_watermaze": LevelRecord("rooms_watermaze", 54.0, 4.065),
    "rooms_keys_doors_puzzle": LevelRecord(
        "rooms_keys_doors_puzzle", 53.8, 4.135),
    "language_select_described_object": LevelRecord(
        "language_select_described_object", 389.5, -0.07),
    "language_select_located_object": LevelRecord(
        "language_select_located_object", 280.7, 1.929),
    "language_execute_random_task": LevelRecord(
        "language_execute_random_task", 254.05, -5.913),
    "language_answer_quantitative_question": LevelRecord(
        "language_answer_quantitative_question", 184.5, -0.33),
    "lasertag_one_opponent_small": LevelRecord(
        "lasertag_one_opponent_small", 12.65, -0.224),
    "lasertag_three_opponents_small": LevelRecord(
        "lasertag_three_opponents_small", 18.55, -0.214),
    "lasertag_one_opponent_large": LevelRecord(
        "lasertag_one_opponent_large", 18.6, -0.083),
    "lasertag_three_opponents_large": LevelRecord(
        "lasertag_three_opponents_large", 31.5, -0.102),
    "natlab_fixed_large_map": LevelRecord(
        "natlab_fixed_large_map", 36.9, 2.173),
    "natlab_varying_map_regrowth": LevelRecord(
        "natlab_varying_map_regrowth", 24.45, 2.989),
    "natlab_varying_map_randomized": LevelRecord(
        "natlab_varying_map_randomized", 42.35, 7.346),
    "skymaze_irreversible_path_hard": LevelRecord(
        "skymaze_irreversible_path_hard", 100.0, 0.1),
    "skymaze_irreversible_path_varied": LevelRecord(
        "skymaze_irreversible_path_varied", 100.0, 14.4),
    "psychlab_arbitrary_visuomotor_mapping": LevelRecord(
        "psychlab_arbitrary_visuomotor_mapping", 58.75, 0.163),
    "psychlab_continuous_recognition": LevelRecord(
        "psychlab_continuous_recognition", 58.3, 0.224),
    "psychlab_sequential_comparison": LevelRecord(
        "psychlab_sequential_comparison", 39.5, 0.129),
    "psychlab_visual_search": LevelRecord(
        "psychlab_visual_search", 78.5, 0.085),
    "explore_object_locations_small": LevelRecord(
        "explore_object_locations_small", 74.45, 3.575),
    "explore_object_locations_large": LevelRecord(
        "explore_object_locations_large", 65.65, 4.673),
    "explore_obstructed_goals_small": LevelRecord(
        "explore_obstructed_goals_small", 206.0, 6.76),
    "explore_obstructed_goals_large": LevelRecord(
        "explore_obstructed_goals_large", 119.5, 2.61),
    "explore_goal_locations_small": LevelRecord(
        "explore_goal_locations_small", 267.5, 7.66),
    "explore_goal_locations_large": LevelRecord(
        "explore_goal_locations_large", 194.5, 3.14),
    "explore_object_rewards_few": LevelRecord(
        "explore_object_rewards_few", 77.7, 2.073),
    "explore_object_rewards_many": LevelRecord(
        "explore_object_rewards_many", 106.7, 2.438),
}

TRAIN_LEVELS: Sequence[str] = tuple(LEVELS)
TEST_LEVELS: Sequence[str] = tuple(r.test_level for r in LEVELS.values())
ALL_LEVELS = frozenset(TRAIN_LEVELS) | frozenset(TEST_LEVELS)

_BY_TEST_NAME = {r.test_level: r for r in LEVELS.values()}


def compute_human_normalized_score(
    level_returns: Dict[str, Sequence[float]],
    per_level_cap: Optional[float],
) -> float:
    """Mean human-normalized score (%) over the DMLab-30 suite.

    ``level_returns``: level name (train or test variant) -> list of
    episode returns.  Train-variant returns score under their test-level
    calibration (reference: dmlab30.py:186-218).  Levels outside the suite
    are ignored; every suite level must be present with >= 1 return.
    ``per_level_cap``: per-level percentage cap (e.g. 100.0), or None.
    """
    by_test: Dict[str, Sequence[float]] = {}
    for name, returns in level_returns.items():
        record = LEVELS.get(name)
        test_name = record.test_level if record else name
        if test_name in _BY_TEST_NAME:
            by_test[test_name] = returns

    missing = set(_BY_TEST_NAME) - set(by_test)
    if missing:
        raise ValueError(f"missing levels: {sorted(missing)}")
    empty = [name for name, returns in by_test.items() if len(returns) == 0]
    if empty:
        raise ValueError(f"missing returns for levels: {sorted(empty)}")

    scores = []
    for test_name, returns in by_test.items():
        record = _BY_TEST_NAME[test_name]
        score = (np.mean(returns) - record.random) / (
            record.human - record.random) * 100.0
        if per_level_cap is not None:
            score = min(score, per_level_cap)
        scores.append(score)
    return float(np.mean(scores))
