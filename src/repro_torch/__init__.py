"""PyTorch port of the CactusDB engine for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` module by module. Entry
points (``Table.from_columns``, the dataset and workload builders,
``core.executor.execute``) run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
Backend names map one to one onto the JAX package's: ``torch`` (ATen ops)
for ``jnp`` and ``kernel`` (hand-written Hopper kernels under
``kernels/csrc``) for ``pallas``.

This package imports ``torch`` and numpy only, never ``jax`` or ``repro``.
"""
