"""Tensor specifications for pre-declared env output shapes/dtypes (a copy of
``scalable_agent_tpu/envs/spec.py``)."""

from typing import Any, NamedTuple, Tuple

import numpy as np


class TensorSpec(NamedTuple):
    """Shape + dtype (+ debug name) of one array-valued field."""

    shape: Tuple[int, ...]
    dtype: Any
    name: str = ""

    def validate(self, value) -> np.ndarray:
        value = np.asarray(value)
        if tuple(value.shape) != tuple(self.shape):
            raise ValueError(
                f"spec {self.name or '<unnamed>'}: shape {value.shape} != "
                f"declared {self.shape}")
        if np.dtype(value.dtype) != np.dtype(self.dtype):
            raise ValueError(
                f"spec {self.name or '<unnamed>'}: dtype {value.dtype} != "
                f"declared {np.dtype(self.dtype)}")
        return value
