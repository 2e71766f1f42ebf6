"""Utilities: building and loading the CUDA kernels of ``csrc/``."""
