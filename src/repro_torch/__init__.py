"""PyTorch/CUDA port of the VersaQ-3D reproduction.

Mirrors the JAX package ``src/repro/`` file for file; every Pallas TPU
kernel on a ported path becomes a hand-written CUDA kernel for Hopper
(``csrc/``), built at first use by ``kernels/_build.py``.  The package
imports ``torch`` and never JAX.  Entry points run on the CUDA device
unless the caller asks for the CPU, where each kernel wrapper uses its
plain PyTorch version.
"""
__version__ = "0.1.0"
