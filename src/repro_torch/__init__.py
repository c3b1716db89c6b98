"""NeurStore on PyTorch and CUDA: the port of the ``repro`` package.

Module for module it mirrors ``src/repro/`` and shares its on-disk formats
bit for bit, so a store written by either package opens in the other. The
kernels are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use; the
entry points (``core.StorageEngine``, ``core.CompressedModel`` and
``launch.compressed_serve.greedy_decode``) run on the card unless the caller
passes ``device="cpu"``. Nothing here imports ``jax`` or ``repro``.
"""
