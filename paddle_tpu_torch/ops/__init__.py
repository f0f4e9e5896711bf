"""Kernels of the port (``ops/cuda``: CUDA C++ built at first use)."""
