"""Tensor programs of the predict path; CUDA kernels live in ``ops.kernels``."""
