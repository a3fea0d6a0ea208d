"""Tensor operations and the CUDA kernel wrappers."""
