"""The native (C++17) dynamic-batching core and its on-demand build."""

from scalable_agent_tpu_torch.native.build import load_library

__all__ = ["load_library"]
