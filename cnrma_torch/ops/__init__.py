"""Tensor ops of the port and their CUDA kernels."""
