"""Host-side hashing of language instructions (numpy only).

A copy of ``scalable_agent_tpu/utils/text.py``: the env workers import it
and never load torch.  The device side, the embedding and the language
LSTM, is ``models/instruction.py``.
"""

import zlib

import numpy as np

NUM_HASH_BUCKETS = 1000  # reference: experiment.py:131
MAX_INSTRUCTION_LEN = 16


def hash_instruction(
    instruction: str,
    max_len: int = MAX_INSTRUCTION_LEN,
    num_buckets: int = NUM_HASH_BUCKETS,
) -> np.ndarray:
    """Whitespace-split words hashed to bucket ids 1..num_buckets (crc32,
    stable across Python versions), int32 [max_len], 0 for padding.  Words
    past ``max_len`` are dropped, as in the JAX package."""
    ids = np.zeros([max_len], dtype=np.int32)
    for i, word in enumerate(instruction.split()[:max_len]):
        ids[i] = 1 + zlib.crc32(word.encode("utf-8")) % num_buckets
    return ids
