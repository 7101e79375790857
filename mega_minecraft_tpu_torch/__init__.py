"""PyTorch + hand-written CUDA port of mega_minecraft_tpu for one NVIDIA H100.

The JAX package ``mega_minecraft_tpu`` is the reference this port is held against.
This package imports ``torch`` and never ``jax``, and nothing of the reference package:
it keeps its own copies of the numpy-only and host modules it needs (``world/``,
``config``, ``native/``).  Every stage has a plain PyTorch version (used for CPU
tensors) and a CUDA C++ kernel under ``csrc/`` (used for CUDA tensors, built with nvcc
on first use).
"""
