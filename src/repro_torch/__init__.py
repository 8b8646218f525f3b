"""BEBR in PyTorch and CUDA: the port of ``repro`` (JAX on a TPU) to one NVIDIA H100.

The module tree mirrors ``repro``: each ported file names the reference
file it ports. Nothing here imports ``jax`` or ``repro``.
"""
