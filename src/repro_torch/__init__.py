"""PyTorch/CUDA port of the Ember embedding compiler and runtime.

Mirrors the module paths of the JAX package ``repro`` (``core/``,
``kernels/``, ``models/``, ``configs/``, ``data/``), so every module here has
one counterpart there.  The compiler front end is a copy of the reference's
numpy-only modules; the kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
