"""Ops of the port; CUDA kernels live in ``csrc/`` and build at first use."""
