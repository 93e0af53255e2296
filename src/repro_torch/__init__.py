"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors ``src/repro`` module for module and imports neither JAX nor
``repro``.  The public search API is ``repro_torch.search``.
"""
