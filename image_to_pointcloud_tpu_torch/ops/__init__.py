"""Tensor ops of the depth→point-cloud path, with their CUDA kernels."""
