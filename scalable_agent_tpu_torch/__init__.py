"""PyTorch/CUDA port of ``scalable_agent_tpu`` for one NVIDIA H100.

A package of its own beside the JAX one, which stays the reference every
part of this port is held against (``tests/test_torch_*.py``).  It imports
``torch``, never ``jax``, and nothing of ``scalable_agent_tpu``: what it
needs of the JAX package's jax-free modules it keeps as its own copies.
Every TPU kernel on its path is a hand-written CUDA kernel for ``sm_90a``
(``csrc/``), built at first use (``ops/_build.py``), with a plain PyTorch
version beside it that runs for tensors on the CPU.

ROADMAP.md lists what is ported and what comes next.
"""
