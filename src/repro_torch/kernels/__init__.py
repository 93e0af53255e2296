"""Hand-written Hopper kernels of the port and their plain PyTorch
versions (``src/repro/kernels/``).  ``partial_reduce`` holds the front
ends, ``build`` compiles ``csrc/*.cu`` with nvcc at first use."""
