"""PyTorch and CUDA port of the sparsity-aware SpMM roofline system.

The counterpart of the JAX package ``repro``, module for module
(``core``, ``data``, ``sparse``, ``kernels``, ``configs``, ``models``,
``launch``), with the TPU kernels replaced by CUDA C++ kernels for Hopper
(``csrc/``).  It imports ``torch`` and never ``jax`` or ``repro``.  Entry points run on the
card unless they are given ``device="cpu"``.
"""
__version__ = "0.1.0"
