"""Batch formation shared by the batching front-ends.

The part of ``scalable_agent_tpu/runtime/batcher.py`` the actor service
(``runtime/service.py``) uses: the power-of-two bucket ladder a formed
batch is padded up, so the inference step sees a small, fixed set of
batch sizes, and ``BatcherClosedError``.  The dynamic batcher itself and
the native batcher are not ported yet (ROADMAP.md, queue 1, item 7b).
"""

from typing import List, Optional, Sequence

__all__ = ["BatcherClosedError", "bucket_ladder", "pad_to_bucket"]


class BatcherClosedError(RuntimeError):
    """Raised to callers whose requests were cancelled by close()."""


def bucket_ladder(maximum: int, minimum: int = 1) -> List[int]:
    """Power-of-two pad sizes ``[minimum, 2*minimum, ..., maximum]``.

    Padding formed batches up the ladder bounds the batch sizes the
    inference step sees to ~log2(maximum) (reference:
    dynamic_batching.py:125-128)."""
    if maximum < 1:
        raise ValueError(f"maximum must be >= 1, got {maximum}")
    sizes = [max(1, min(int(minimum), maximum))]
    while sizes[-1] < maximum:
        sizes.append(min(sizes[-1] * 2, maximum))
    return sizes


def pad_to_bucket(n: int, sizes: Optional[Sequence[int]]) -> int:
    """Smallest bucket in ascending ``sizes`` holding ``n`` valid rows
    (``n`` itself when no bucket fits or bucketing is disabled)."""
    if sizes is None:
        return n
    for size in sizes:
        if size >= n:
            return size
    return n
