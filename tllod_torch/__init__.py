"""tllod_torch — the PyTorch/CUDA port of ``tllod_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, module for module (``config``,
``ops``, ``models``, ``data``, ``train``, ``eval_engine``, ``zoo``), written
in PyTorch. The JAX package is the reference: the ``tests/test_torch_*.py``
files feed both the same inputs and weights and hold the results together.
Every Pallas kernel of the JAX package, and greedy NMS, is a CUDA C++ kernel
under ``csrc/`` for ``sm_90a``, built with ``nvcc`` on first use
(``ops/_kernels.py``); each has a plain PyTorch version beside it that runs
for CPU tensors.

This module imports nothing, so ``import tllod_torch`` is cheap. The port
never imports ``jax`` or ``tllod_tpu``; what it needs of framework-free JAX
modules is copied.
"""

__version__ = "0.1.0"
